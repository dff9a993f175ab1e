"""Speculative decoding in the port (``repro_torch.serving.speculative``,
``attn_verify``, ``verify_step`` and the paged engine's draft-then-verify
burst) on reduced minitron-4b (f32), against ``repro.serving`` and
``repro.models``.

Against the reference, within rtol = atol = 2e-4: ``attn_verify`` and
``verify_step`` at per-lane offsets, the acceptance math, the exactness
gate, ``make_self_draft`` (converted), and a partial-acceptance engine run
(equal streams and counters).  Inside the port, as ``tests/test_spec.py``
holds the reference: the committed streams of all-accept, all-reject and
partial bursts equal the plain paged engine's, ``spec_k=0`` is plain
decode, one request can opt out, and preemption rolls speculating lanes
back exactly.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.serving import PagedServingEngine as JPagedServingEngine
from repro.serving import expected_committed_tokens as jexpected_committed_tokens
from repro.serving import make_self_draft as jmake_self_draft
from repro.serving import spec_exact_reason as jspec_exact_reason
from repro.serving import spec_gain as jspec_gain
from repro_torch.configs import ARCH_IDS, get_arch, reduced
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.serving import (
    PagedServingEngine,
    expected_committed_tokens,
    make_self_draft,
    spec_exact_reason,
    spec_gain,
)

TOL = dict(rtol=2e-4, atol=2e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jreduced(jget_arch("minitron-4b")), reduced(get_arch("minitron-4b"))
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    return jmodel, jparams, model, params_from_jax(_np(jparams), cfg)


@pytest.fixture(scope="module")
def drafted(pair):
    """(target model, damped target params, draft model, draft params) with
    damp=0: the damped target computes the draft's function (acceptance 1)."""
    _, _, model, params = pair
    dcfg, dparams, tparams = make_self_draft(model.cfg, params, keep_layers=1, damp=0.0)
    return model, tparams, build_model(dcfg, "cpu"), dparams


def _prompts(vocab, lens=(3, 11, 6)):
    rng = np.random.default_rng(5)
    return [[int(t) for t in rng.integers(1, vocab, size=n)] for n in lens]


def _run(model, params, prompts, *, mnt=8, **kw):
    kw.setdefault("decode_batch", len(prompts))
    kw.setdefault("max_ctx", 32)
    kw.setdefault("page_size", 4)
    kw.setdefault("chunk", 8)
    eng = PagedServingEngine(model, params, **kw)
    reqs = [eng.add_request(p, max_new_tokens=mnt) for p in prompts]
    eng.run_to_completion(max_steps=512)
    assert all(r.done for r in reqs)
    return reqs, eng


# ---------------------------------------------------------------------------
# The copies against the originals
# ---------------------------------------------------------------------------


def test_acceptance_math_matches_reference():
    for k in range(6):
        for alpha in (0.0, 0.3, 0.5, 0.8, 1.0, 1.5):
            assert expected_committed_tokens(k, alpha) == jexpected_committed_tokens(k, alpha)
            kw = dict(draft_cost_s=0.1, verify_cost_s=1.0, decode_cost_s=1.0)
            assert spec_gain(k, alpha, **kw) == jspec_gain(k, alpha, **kw)
    assert spec_gain(3, 0.0, draft_cost_s=0.0, verify_cost_s=1.0, decode_cost_s=1.0) == 1.0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_exact_reason_matches_reference(arch):
    assert spec_exact_reason(get_arch(arch)) == jspec_exact_reason(jget_arch(arch))


@pytest.mark.parametrize("damp", [0.0, 0.05])
def test_make_self_draft_matches_reference(pair, damp):
    """The draft config, the draft's params and the damped target's equal
    the reference's converted; the draft's layers are the target's tensors."""
    jmodel, jparams, model, params = pair
    jdcfg, jdparams, jtparams = jmake_self_draft(jmodel.cfg, jparams, keep_layers=1, damp=damp)
    dcfg, dparams, tparams = make_self_draft(model.cfg, params, keep_layers=1, damp=damp)
    assert dataclasses.asdict(dcfg) == dataclasses.asdict(jdcfg)
    for got, want, cfg in ((dparams, jdparams, dcfg), (tparams, jtparams, model.cfg)):
        want = params_from_jax(_np(want), cfg)
        assert len(got["layers"]) == len(want["layers"])
        for gl, wl in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert torch.equal(gl, wl)
    assert dparams["layers"][0]["attn"]["wq"] is params["layers"][0]["attn"]["wq"]
    with pytest.raises(ValueError):
        make_self_draft(model.cfg, params, keep_layers=0)


def test_attn_verify_matches_reference(pair):
    """Two lanes at offsets 5 and 19 of a 32-row cache with random contents:
    the output and every cache row."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["groups"]["0"])["attn"]
    p = params["layers"][0]["attn"]
    rng = np.random.default_rng(4)
    shape = (2, cfg.n_kv_heads, 32, cfg.head_dim)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    off = np.asarray([5, 19], np.int32)
    jy, jc = jattn.attn_verify(jp, cfg, jnp.asarray(x), "G", off=jnp.asarray(off),
                               cache={"k": jnp.asarray(k0), "v": jnp.asarray(v0)})
    y, c = attn.attn_verify(p, cfg, torch.from_numpy(x), "G", off=torch.from_numpy(off),
                            cache={"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())})
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(jc[key]), **TOL)


def test_verify_attention_is_decode_attention_per_position():
    """The verify attention applies the decode attention once per position:
    each position's output equals a decode call's with that position's mask,
    bit for bit."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((3, 4, 5, 16), generator=g)
    k, v = torch.randn((3, 2, 24, 16), generator=g), torch.randn((3, 2, 24, 16), generator=g)
    pos = torch.tensor([3, 9, 17])[:, None] + torch.arange(5)
    ok = torch.arange(24)[None, None, :] <= pos[:, :, None]
    out = attn._masked_verify_attention(q, k, v, ok)
    for j in range(5):
        want = attn._masked_decode_attention(q[:, :, j:j + 1].contiguous(), k, v, ok[:, j])
        assert torch.equal(out[:, :, j:j + 1], want)


def test_verify_step_matches_reference(pair):
    """Two lanes prefilled to 7 and 12 tokens, then four verify positions at
    those per-lane offsets: logits at every position and the cache."""
    jmodel, jparams, model, params = pair
    prompts = _prompts(model.cfg.vocab_size, lens=(7, 12))
    jcache, cache = jmodel.init_cache(2, 32), model.init_cache(2, 32)
    for lane, p in enumerate(prompts):      # prefill each lane alone, then splice
        j1, jc1 = jmodel.prefill(jparams, {"tokens": jnp.asarray([p], jnp.int32)}, max_len=32)
        jcache = jax.tree_util.tree_map(lambda full, one: full.at[..., lane:lane + 1, :, :, :].set(one)
                                        if full.ndim == 5 else full, jcache, jc1)
    jcache = dict(jcache, t=jnp.asarray([7, 12], jnp.int32))
    cache = cache_from_jax(_np(jcache), model.cfg)
    toks = np.asarray([[3, 9, 27, 81], [5, 25, 125, 1]], np.int32)
    off = np.asarray([7, 12], np.int32)
    jlogits, jnew = jmodel.verify_step(jparams, jcache, jnp.asarray(toks), jnp.asarray(off))
    logits, new = model.verify_step(params, cache, torch.from_numpy(toks).long(),
                                    torch.from_numpy(off))
    assert tuple(logits.shape) == (2, 4, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    want = cache_from_jax(_np(jnew), model.cfg)
    assert torch.equal(new["t"], want["t"])
    for gl, wl in zip(new["layers"], want["layers"]):
        for key in wl:
            np.testing.assert_allclose(gl[key].numpy(), wl[key].numpy(), **TOL)
    with pytest.raises(ValueError, match="recurrent"):
        rcfg = reduced(get_arch("rwkv6-1.6b"))
        rmodel = build_model(rcfg, "cpu")
        rmodel.verify_step(rmodel.init(0), rmodel.init_cache(1, 8), torch.ones((1, 2), dtype=torch.long),
                           torch.zeros(1, dtype=torch.long))


def test_partial_acceptance_engine_matches_reference(pair):
    """damp = 0.05, spec_k = 3: the same committed streams and the same
    burst, proposal and acceptance counts as the reference's engine."""
    jmodel, jparams, model, params = pair
    jdcfg, jdparams, jtparams = jmake_self_draft(jmodel.cfg, jparams, keep_layers=1, damp=0.05)
    dcfg, dparams, tparams = make_self_draft(model.cfg, params, keep_layers=1, damp=0.05)
    prompts = _prompts(model.cfg.vocab_size)
    kw = dict(decode_batch=3, max_ctx=32, page_size=4, chunk=8, spec_k=3)
    jeng = JPagedServingEngine(jmodel, jtparams, draft_model=jbuild_model(jdcfg),
                               draft_params=jdparams, **kw)
    jreqs = [jeng.add_request(p, max_new_tokens=8) for p in prompts]
    jeng.run_to_completion(max_steps=512)
    reqs, eng = _run(model, tparams, prompts, draft_model=build_model(dcfg, "cpu"),
                     draft_params=dparams, spec_k=3)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    for name in ("spec_bursts", "spec_proposed", "spec_accepted", "spec_committed"):
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.drain_spec_events() == jeng.drain_spec_events()


# ---------------------------------------------------------------------------
# Inside the port: bit-exactness in every regime (ports of tests/test_spec.py)
# ---------------------------------------------------------------------------


def test_all_accept_commits_k_plus_one_and_matches_plain(pair, drafted):
    model, tparams, draft, dparams = drafted
    prompts = _prompts(model.cfg.vocab_size)
    plain, _ = _run(model, tparams, prompts)
    spec, eng = _run(model, tparams, prompts, draft_model=draft, draft_params=dparams, spec_k=3)
    assert [r.generated for r in spec] == [r.generated for r in plain]
    assert eng.spec_bursts > 0
    assert eng.spec_accepted == eng.spec_proposed
    events = eng.drain_spec_events()
    assert all(1 <= ev["committed"] <= 4 for ev in events)
    assert sum(ev["committed"] for ev in events) == eng.spec_committed


def test_all_reject_commits_exactly_one_and_matches_plain(pair, drafted):
    """The draft's LM head is the target's with its columns rolled by one,
    so its proposal is never the target's: every burst commits exactly the
    correction token."""
    model, tparams, draft, dparams = drafted
    bad = dict(dparams, lm_head=torch.roll(dparams["lm_head"], 1, dims=1))
    prompts = _prompts(model.cfg.vocab_size)
    plain, _ = _run(model, tparams, prompts)
    spec, eng = _run(model, tparams, prompts, draft_model=draft, draft_params=bad, spec_k=3)
    assert [r.generated for r in spec] == [r.generated for r in plain]
    assert eng.spec_bursts > 0
    assert eng.spec_accepted == 0
    assert eng.spec_committed == eng.spec_bursts


def test_partial_acceptance_is_bit_exact(pair):
    _, _, model, params = pair
    dcfg, dparams, tparams = make_self_draft(model.cfg, params, keep_layers=1, damp=0.05)
    prompts = _prompts(model.cfg.vocab_size)
    plain, _ = _run(model, tparams, prompts)
    spec, eng = _run(model, tparams, prompts, draft_model=build_model(dcfg, "cpu"),
                     draft_params=dparams, spec_k=3)
    assert [r.generated for r in spec] == [r.generated for r in plain]
    assert 0 < eng.spec_accepted < eng.spec_proposed


def test_spec_k0_degrades_to_plain(pair, drafted):
    model, tparams, draft, dparams = drafted
    prompts = _prompts(model.cfg.vocab_size)
    plain, _ = _run(model, tparams, prompts)
    spec, eng = _run(model, tparams, prompts, draft_model=draft, draft_params=dparams, spec_k=0)
    assert not eng._spec and eng.spec_bursts == 0
    assert [r.generated for r in spec] == [r.generated for r in plain]


def test_per_request_opt_out(pair, drafted):
    model, tparams, draft, dparams = drafted
    prompts = _prompts(model.cfg.vocab_size, lens=(4, 9))
    plain, _ = _run(model, tparams, prompts)
    eng = PagedServingEngine(model, tparams, decode_batch=2, max_ctx=32, page_size=4, chunk=8,
                             draft_model=draft, draft_params=dparams, spec_k=3)
    a = eng.add_request(prompts[0], max_new_tokens=8, speculative=False)
    b = eng.add_request(prompts[1], max_new_tokens=8)
    eng.run_to_completion(max_steps=512)
    assert a.generated == plain[0].generated
    assert b.generated == plain[1].generated
    events = eng.drain_spec_events()
    assert events and all(ev["uid"] == b.uid for ev in events)


def test_preemption_rollback_is_bit_exact(pair, drafted):
    model, tparams, draft, dparams = drafted
    prompts = [[i + 1] * 5 for i in range(4)]
    plain, _ = _run(model, tparams, prompts, mnt=6, decode_batch=4)
    spec, eng = _run(model, tparams, prompts, mnt=6, decode_batch=4, page_size=2,
                     pool_pages=15, draft_model=draft, draft_params=dparams, spec_k=3)
    assert eng.preemptions > 0
    assert eng.spec_bursts > 0
    assert [r.generated for r in spec] == [r.generated for r in plain]
    assert eng.table.used_pages == 0


def test_spec_refuses_archs_it_cannot_roll_back():
    cfg = reduced(get_arch("recurrentgemma-2b"))
    model = build_model(cfg, "cpu")
    with pytest.raises(ValueError, match="recurrent"):
        PagedServingEngine(model, {}, decode_batch=2, max_ctx=32, page_size=4,
                           draft_model=model, draft_params={}, spec_k=2)
