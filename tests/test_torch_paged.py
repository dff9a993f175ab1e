"""The port's paged engine (``repro_torch.serving.paged``), its page table,
and the chunked-prefill model path on reduced configs (f32), against
``repro.serving.paged`` and ``repro.models``.

Against the reference (same converted weights, same inputs, the reference
on its ``ref`` path), within rtol = atol = 2e-4: ``attn_chunk`` on full and
ring caches, ``prefill_chunk`` at successive offsets for four archs, and
the engine's token streams, final-chunk logits and ``planned_work()`` at
every step.  The page table's answers are equal.  Inside the port,
bit-exact as ``tests/test_paged.py`` holds the reference: a fragmented pool
against a fresh one, a live defrag, preemption, paged against slot tokens,
and lanes that decode beside a lane whose prefill is still in flight on a
ring cache shorter than the context.
"""
import dataclasses
import random

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
from repro.serving import PagesExhausted as JPagesExhausted
from repro.serving import PageTable as JPageTable
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.serving import (
    PagedServingEngine,
    PagesExhausted,
    PageTable,
    ServingEngine,
    SlotsFull,
)

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["minitron-4b", "rwkv6-1.6b", "recurrentgemma-2b", "mixtral-8x22b", "dbrx-132b"]


_PAIRS = {}


def pair_for(arch):
    """(reference model, its params, port model, converted params): one
    weight set per arch, shared by the tests of this file."""
    if arch not in _PAIRS:
        jcfg, cfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
        jmodel = jbuild_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(1))
        model = build_model(cfg, "cpu")
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
        _PAIRS[arch] = jmodel, jparams, model, params
    return _PAIRS[arch]


def _prompts(vocab, lens=(3, 11, 18, 6), seed=5):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, size=n)] for n in lens]


# ---------------------------------------------------------------------------
# PageTable: the copy against the original
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pagetable_matches_reference_on_seeded_ops(seed):
    """The same seeded sequence of ensure / release / flat_rows / defrag
    gives the same pages, rows, moves, exhaustion and stats."""
    rng = random.Random(seed)
    jt, t = JPageTable(17, 3), PageTable(17, 3)
    for _ in range(200):
        op = rng.choice(["ensure", "ensure", "release", "rows", "defrag"])
        uid = rng.randrange(1, 7)
        if op == "ensure":
            n = rng.randrange(0, 20)
            try:
                want = jt.ensure(uid, n)
            except JPagesExhausted:
                with pytest.raises(PagesExhausted):
                    t.ensure(uid, n)
            else:
                assert t.ensure(uid, n) == want
        elif op == "release":
            assert t.release(uid) == jt.release(uid)
        elif op == "rows":
            n = rng.randrange(1, 24)
            np.testing.assert_array_equal(t.flat_rows(uid, n), jt.flat_rows(uid, n))
        else:
            assert t.defrag() == jt.defrag()
        assert t.pages(uid) == jt.pages(uid)
        assert t.holders() == jt.holders()
        assert t.fragmentation() == jt.fragmentation()
        assert t.stats() == jt.stats()


# ---------------------------------------------------------------------------
# The chunk path against the reference
# ---------------------------------------------------------------------------


def _layer_params(arch):
    """The first attention layer's params of the converted pair, both sides."""
    jmodel, jparams, model, params = pair_for(arch)
    kinds = model.cfg.layer_kinds
    j = kinds.index("G") if "G" in kinds else kinds.index("L")
    pat = model.cfg.layer_pattern
    jp = jax.tree_util.tree_map(lambda a: a[j // len(pat)], jparams["groups"][str(j % len(pat))])
    return model.cfg, kinds[j], jp["attn"], params["layers"][j]["attn"]


@pytest.mark.parametrize("arch", ["minitron-4b", "mixtral-8x22b"])
def test_attn_chunk_matches_reference(arch):
    """Full-length (minitron, K2 at q_offset) and ring (mixtral's window-8
    ring in a 32-long context: masked attention, written after it) caches:
    successive chunks of several lengths, one longer than the ring, from a
    cache that starts with random contents."""
    cfg, kind, jp, p = _layer_params(arch)
    rng = np.random.default_rng(3)
    jcache = jattn.init_attn_cache(cfg, kind, 1, 32)
    shape = jcache["k"].shape
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    cache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    off = 0
    for c in (5, 11, 1):
        x = rng.standard_normal((1, c, cfg.d_model)).astype(np.float32)
        pos = (off + np.arange(c))[None].astype(np.int32)
        jy, jcache = jattn.attn_chunk(jp, cfg, jnp.asarray(x), kind, positions=jnp.asarray(pos),
                                      off=off, cache=jcache)
        y, cache = attn.attn_chunk(p, cfg, torch.from_numpy(x), kind,
                                   positions=torch.from_numpy(pos).long(), off=off, cache=cache)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), **TOL)
        off += c


def test_attn_chunk_with_a_window_past_the_cache_takes_k2(monkeypatch):
    """mixtral's window (64 here) longer than its 32-long cache: the ring
    never wraps, so the chunk takes the flash-attention kernel at q_offset
    with the layer's window, as one-shot prefill does; its output and cache
    agree with the reference's ring branch."""
    from repro_torch.kernels import ops

    jcfg = dataclasses.replace(jreduced(jget_arch("mixtral-8x22b")), window=64)
    cfg = dataclasses.replace(reduced(get_arch("mixtral-8x22b")), window=64)
    jp = jattn.attn_params(jax.random.PRNGKey(2), jcfg)
    p = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    calls = []
    inner = ops.flash_attention

    def recorded(*args, **kw):
        calls.append((kw["q_offset"], kw["window"]))
        return inner(*args, **kw)

    monkeypatch.setattr(ops, "flash_attention", recorded)
    rng = np.random.default_rng(4)
    jcache = jattn.init_attn_cache(jcfg, "L", 1, 32)
    cache = attn.init_attn_cache(cfg, "L", 1, 32, "cpu")
    assert tuple(cache["k"].shape) == tuple(jcache["k"].shape) and cache["k"].shape[2] == 32
    off = 0
    for c in (5, 11, 16):
        x = rng.standard_normal((1, c, cfg.d_model)).astype(np.float32)
        pos = (off + np.arange(c))[None].astype(np.int32)
        jy, jcache = jattn.attn_chunk(jp, jcfg, jnp.asarray(x), "L", positions=jnp.asarray(pos),
                                      off=off, cache=jcache)
        y, cache = attn.attn_chunk(p, cfg, torch.from_numpy(x), "L",
                                   positions=torch.from_numpy(pos).long(), off=off, cache=cache)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), **TOL)
        off += c
    assert calls == [(0, 64), (5, 64), (16, 64)]


def test_engine_with_a_window_past_the_context_matches_reference():
    """The paged engine over mixtral's window-64 layers in a 32-token
    context (the port's chunks on the flash-attention kernel, the
    reference's on its ring branch): equal ``planned_work()``, token streams
    and final-chunk logits within 2e-4."""
    jcfg = dataclasses.replace(jreduced(jget_arch("mixtral-8x22b")), window=64)
    cfg = dataclasses.replace(reduced(get_arch("mixtral-8x22b")), window=64)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    kw = dict(decode_batch=3, max_ctx=32, page_size=4, chunk=6, record_logits=True)
    prompts = _prompts(cfg.vocab_size, lens=(4, 13, 9, 20))
    _step_both(JPagedServingEngine(jmodel, jparams, **kw), PagedServingEngine(model, params, **kw),
               prompts)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_reference(arch):
    """Chunks of 5, 1 and 11 tokens from offset 0 (the last longer than the
    8-slot rings): each chunk's logits and the cache after it (KV rows, ring
    slots, recurrent state, ``t``)."""
    jmodel, jparams, model, params = pair_for(arch)
    toks = np.asarray(_prompts(model.cfg.vocab_size, lens=(17,), seed=7)[0], np.int32)
    jcache = jmodel.init_cache(1, 32)
    cache = model.init_cache(1, 32)
    off = 0
    for c in (5, 1, 11):
        chunk = toks[None, off:off + c]
        jlogits, jcache = jmodel.prefill_chunk(jparams, jcache, jnp.asarray(chunk), off)
        logits, cache = model.prefill_chunk(params, cache, torch.from_numpy(chunk).long(), off)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        want = cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), model.cfg)
        assert torch.equal(cache["t"], want["t"])
        for got_l, want_l in zip(cache["layers"], want["layers"]):
            for key in want_l:
                np.testing.assert_allclose(got_l[key].numpy(), want_l[key].numpy(), **TOL)
        off += c


# ---------------------------------------------------------------------------
# The engine against the reference's
# ---------------------------------------------------------------------------


def _step_both(jeng, eng, prompts, mnt=5):
    jreqs = [jeng.add_request(p, max_new_tokens=mnt) for p in prompts]
    reqs = [eng.add_request(p, max_new_tokens=mnt) for p in prompts]
    steps = 0
    while jeng.in_flight:
        assert eng.planned_work() == jeng.planned_work()
        jfin, fin = jeng.step(), eng.step()
        assert [r.uid for r in fin] == [r.uid for r in jfin]
        steps += 1
        assert steps < 200
    assert not eng.in_flight
    for r, jr in zip(reqs, jreqs):
        assert r.done and r.generated == jr.generated
        np.testing.assert_allclose(eng.chunk_logits[r.uid], jeng.chunk_logits[jr.uid], **TOL)
    return reqs


@pytest.mark.parametrize("arch", ["minitron-4b", "rwkv6-1.6b"])
def test_engine_matches_reference(arch):
    """Three lanes, four prompts (one waits for a lane), chunks of 6 over
    pages of 4: equal ``planned_work()`` before every step, equal finished
    requests after it, equal token streams, final-chunk logits within
    2e-4.  (recurrentgemma-2b and mixtral-8x22b step against the reference
    in ``test_decode_beside_a_prefill_leaves_its_ring_cache_alone``.)"""
    jmodel, jparams, model, params = pair_for(arch)
    kw = dict(decode_batch=3, max_ctx=32, page_size=4, chunk=6, record_logits=True)
    prompts = _prompts(model.cfg.vocab_size, lens=(4, 13, 9, 20))
    _step_both(JPagedServingEngine(jmodel, jparams, **kw), PagedServingEngine(model, params, **kw),
               prompts)


def test_engine_under_preemption_matches_reference():
    """An oversubscribed pool (preemption, recompute-on-resume) steps as the
    reference's does."""
    jmodel, jparams, model, params = pair_for("minitron-4b")
    kw = dict(decode_batch=4, max_ctx=32, page_size=2, pool_pages=13, chunk=8,
              record_logits=True)
    jeng, eng = JPagedServingEngine(jmodel, jparams, **kw), PagedServingEngine(model, params, **kw)
    _step_both(jeng, eng, [[i + 1] * 5 for i in range(4)], mnt=6)
    assert eng.preemptions == jeng.preemptions > 0


@pytest.mark.parametrize("spec", [False, True])
def test_engine_plan_matches_reference(spec):
    """``plan_serving_paged`` through each engine's provider (a static map
    over some of the plan's instances, spec cells included): the same
    instances, tiers and schedules."""
    from repro.core.resolution import plan_serving_paged as jplan_serving_paged
    from repro.core.schedule import default_schedule as jdefault_schedule
    from repro.kernels.ops import ScheduleProvider as JScheduleProvider
    from repro.serving import make_self_draft as jmake_self_draft
    from repro_torch.core.schedule import Schedule
    from repro_torch.kernels.ops import ScheduleProvider
    from repro_torch.serving import make_self_draft

    jmodel, jparams, model, params = pair_for("minitron-4b")
    geo = dict(decode_batch=2, max_ctx=32, page_size=4, chunk=8)
    probe = jplan_serving_paged(jmodel.cfg, JScheduleProvider().pipeline, decode_batch=2,
                                page_size=4, pages_per_seq=8, chunk_lens=range(1, 9),
                                spec_k=3 if spec else 0)
    static = {u.instance.workload_key(): jdefault_schedule(u.instance) for u in probe.uses[::3]}
    jprov = JScheduleProvider(schedule_map=static)
    prov = ScheduleProvider(schedule_map={k: Schedule.from_json(s.to_json())
                                          for k, s in static.items()})
    jkw, kw = {}, {}
    if spec:
        jd, jdp, _ = jmake_self_draft(jmodel.cfg, jparams, keep_layers=1)
        d, dp, _ = make_self_draft(model.cfg, params, keep_layers=1)
        jkw = dict(draft_model=jbuild_model(jd), draft_params=jdp, spec_k=3)
        kw = dict(draft_model=build_model(d, "cpu"), draft_params=dp, spec_k=3)
    jeng = JPagedServingEngine(jmodel, jparams, provider=jprov, **geo, **jkw)
    eng = PagedServingEngine(model, params, provider=prov, **geo, **kw)
    assert [u.instance.workload_key() for u in eng.plan.uses] == \
        [u.instance.workload_key() for u in jeng.plan.uses]
    assert eng.plan.tier_counts() == jeng.plan.tier_counts()
    tiers = eng.plan.tier_counts()
    assert tiers.get("default") and sum(tiers.values()) > tiers["default"]
    assert {k: s.to_json() for k, s in eng.plan.schedules().items()} == \
        {k: s.to_json() for k, s in jeng.plan.schedules().items()}
    assert prov.plan is eng.plan


# ---------------------------------------------------------------------------
# Inside the port: admission, pool pressure (ports of tests/test_paged.py)
# ---------------------------------------------------------------------------


def _engine(model, params, **kw):
    kw.setdefault("decode_batch", 2)
    kw.setdefault("max_ctx", 32)
    kw.setdefault("page_size", 4)
    kw.setdefault("chunk", 8)
    return PagedServingEngine(model, params, **kw)


def test_rejects_oversize_and_admission_cap():
    _, _, model, params = pair_for("minitron-4b")
    eng = _engine(model, params, admit_cap=2)
    with pytest.raises(ValueError, match="max_ctx"):
        eng.add_request(list(range(1, 30)), max_new_tokens=8)
    eng.add_request([1, 2, 3], max_new_tokens=2)
    eng.add_request([4, 5], max_new_tokens=2)
    with pytest.raises(SlotsFull):
        eng.add_request([6], max_new_tokens=1)
    assert not eng.free_slots
    eng.run_to_completion()
    assert not eng.active and eng.table.used_pages == 0
    small = _engine(model, params, pool_pages=3)   # 2 usable pages = 8 tokens
    with pytest.raises(ValueError, match="pages"):
        small.add_request(list(range(1, 10)), max_new_tokens=4)


def test_max_new_tokens_exact_and_chunked_prefill_progress():
    _, _, model, params = pair_for("minitron-4b")
    eng = _engine(model, params, chunk=4)
    long = eng.add_request(list(range(1, 14)), max_new_tokens=3)   # 4 chunks
    short = eng.add_request([7, 8], max_new_tokens=3)
    eng.step()
    assert eng._off[long.uid] == 4
    assert short.generated
    eng.run_to_completion()
    assert long.done and len(long.generated) == 3
    assert short.done and len(short.generated) == 3
    assert eng.prefill_true_tokens == eng.prefill_padded_tokens


def test_admission_gate_and_partial_chunk():
    """The watermark gate keeps FIFO order; a chunk shrinks to the pages
    that are free instead of stalling."""
    _, _, model, params = pair_for("minitron-4b")
    eng = _engine(model, params, decode_batch=3, page_size=2, pool_pages=8, chunk=16)
    a = eng.add_request([1] * 10, max_new_tokens=2)
    b = eng.add_request([2] * 10, max_new_tokens=2)
    c = eng.add_request([3, 4], max_new_tokens=2)
    assert eng.planned_work()["admits"] == 1
    eng.step()
    assert [r.uid for r in eng.lanes if r is not None] == [a.uid]
    assert [r.uid for r in eng.waiting] == [b.uid, c.uid]
    eng.run_to_completion(max_steps=256)
    assert a.done and b.done and c.done

    eng = _engine(model, params, decode_batch=2, page_size=2, pool_pages=10, chunk=8)
    a = eng.add_request([1] * 16, max_new_tokens=2)
    eng.step()
    assert eng._off[a.uid] == 8
    eng.table.ensure(777, 8)
    assert eng.planned_work()["chunk_lens"] == [2]
    eng.step()
    assert eng._off[a.uid] == 10
    eng.table.release(777)
    eng.run_to_completion(max_steps=256)
    assert a.done and len(a.generated) == 2


# ---------------------------------------------------------------------------
# Inside the port: bit-exact invariants (ports of tests/test_paged.py)
# ---------------------------------------------------------------------------


def _run_paged(model, params, prompts, *, fragment=False, mnt=5, **kw):
    kw.setdefault("decode_batch", len(prompts))
    kw.setdefault("max_ctx", 32)
    kw.setdefault("page_size", 4)
    kw.setdefault("chunk", 8)
    eng = PagedServingEngine(model, params, record_logits=True, **kw)
    if fragment:   # shred the free list before any real allocation
        for i in range(12):
            eng.table.ensure(900 + i, kw["page_size"])
        for i in range(0, 12, 2):
            eng.table.release(900 + i)
        assert eng.table.fragmentation() > 0.0
    reqs = [eng.add_request(p, max_new_tokens=mnt) for p in prompts]
    eng.run_to_completion(max_steps=512)
    assert all(r.done for r in reqs)
    return reqs, eng


def _run_slot(model, params, prompts, mnt=5):
    slot = ServingEngine(model, params, slots=len(prompts), max_len=32, prefill_buckets=False)
    reqs = [slot.add_request(p, max_new_tokens=mnt) for p in prompts]
    while slot.active:
        slot.step()
    return reqs


def test_fragmented_pool_is_bit_exact_vs_contiguous():
    _, _, model, params = pair_for("minitron-4b")
    prompts = _prompts(model.cfg.vocab_size)
    contig_reqs, contig = _run_paged(model, params, prompts)
    frag_reqs, frag = _run_paged(model, params, prompts, fragment=True)
    for cr, fr in zip(contig_reqs, frag_reqs):
        assert cr.generated == fr.generated
        assert np.array_equal(contig.chunk_logits[cr.uid], frag.chunk_logits[fr.uid])


def test_live_defrag_is_bit_exact():
    _, _, model, params = pair_for("minitron-4b")
    prompts = _prompts(model.cfg.vocab_size)
    base_reqs, base = _run_paged(model, params, prompts)
    assert base.defrags == 0
    eng = PagedServingEngine(model, params, decode_batch=len(prompts), max_ctx=32, page_size=4,
                             chunk=8, defrag_threshold=0.05, record_logits=True)
    for i in range(12):
        eng.table.ensure(900 + i, 4)
    for i in range(0, 12, 2):
        eng.table.release(900 + i)
    reqs = [eng.add_request(p, max_new_tokens=5) for p in prompts]
    for _ in range(3):
        eng.step()
    for i in range(1, 12, 2):
        eng.table.release(900 + i)
    assert eng.table.fragmentation() > 0.05
    eng.run_to_completion(max_steps=512)
    assert eng.defrags >= 1
    for br, r in zip(base_reqs, reqs):
        assert br.generated == r.generated
        assert np.array_equal(base.chunk_logits[br.uid], eng.chunk_logits[r.uid])


def test_oversubscribed_pool_preempts_and_gives_the_same_tokens():
    _, _, model, params = pair_for("minitron-4b")
    prompts = [[i + 1] * 5 for i in range(4)]
    free, _ = _run_paged(model, params, prompts, mnt=6, decode_batch=4, page_size=2)
    cut, eng = _run_paged(model, params, prompts, mnt=6, decode_batch=4, page_size=2,
                          pool_pages=13)
    assert eng.preemptions > 0 and eng.table.used_pages == 0
    assert [r.generated for r in cut] == [r.generated for r in free]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_matches_slot_tokens(arch):
    """Chunked prefill over pages against the slot engine's exact-length
    prefill on the same weights: equal token streams (ring caches and
    recurrent state stay lane strips)."""
    _, _, model, params = pair_for(arch)
    prompts = _prompts(model.cfg.vocab_size, lens=(4, 13, 9))
    paged, _ = _run_paged(model, params, prompts, chunk=6)
    assert [r.generated for r in paged] == [r.generated for r in _run_slot(model, params, prompts)]


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mixtral-8x22b"])
def test_decode_beside_a_prefill_leaves_its_ring_cache_alone(arch):
    """A ring cache of 8 slots in a 32-token context is a lane leaf, and the
    model writes it in place.  One lane decodes while the other is part-way
    through a long prompt's chunks: the batched decode must leave the
    prefilling lane's strip as it was, as the reference's masked update
    does.  After every step the engine's whole cache (lane strips, and the
    pool outside the trash page) equals the reference engine's, and the
    tokens equal the slot engine's."""
    from repro_torch.serving.paged import _rebuild

    jmodel, jparams, model, params = pair_for(arch)
    assert model.cfg.window == 8
    prompts = _prompts(model.cfg.vocab_size, lens=(3, 22))
    kw = dict(decode_batch=2, max_ctx=32, page_size=4, chunk=4, chunks_per_step=1)
    eng = PagedServingEngine(model, params, **kw)
    jeng = JPagedServingEngine(jmodel, jparams, **kw)
    reqs = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    jreqs = [jeng.add_request(p, max_new_tokens=6) for p in prompts]
    beside = 0
    while eng.in_flight:
        work = eng.planned_work()
        if work["decode"] and work["chunk_lens"] and eng._off.get(reqs[1].uid, 0) > 0:
            beside += 1
        eng.step()
        jeng.step()
        cache = _rebuild(eng._template, iter(eng.leaves))
        jcache = jax.tree_util.tree_unflatten(jeng._treedef, [np.asarray(x) for x in jeng.leaves])
        want = cache_from_jax(jcache, model.cfg)
        assert torch.equal(cache["t"], want["t"])
        for got_l, want_l in zip(cache["layers"], want["layers"]):
            for key in want_l:
                g, w = got_l[key].numpy(), want_l[key].numpy()
                if g.shape[0] != 2:       # a pool leaf (KV, rows, D): skip the trash page
                    g, w = g[:, 4:], w[:, 4:]
                np.testing.assert_allclose(g, w, **TOL)
    assert beside >= 2
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [r.generated for r in reqs] == [r.generated for r in _run_slot(model, params, prompts,
                                                                           mnt=6)]
