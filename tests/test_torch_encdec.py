"""Reduced whisper-medium (encoder-decoder) and internvl2-26b (vision
prefix), f32, in the port against ``repro.models`` and ``repro.serving``.

The reference builds the weights; ``repro_torch.convert`` hands the same
weights to the port (the enc-dec model's stacked ``encoder`` and
``decoder`` unstacked into lists, ``vis_proj`` as it is).  Seeded random
frames and patch embeddings, made with numpy, go through both.  Encoder
output, logits and caches agree within rtol = atol = 2e-4 (the repo's f32
kernel tolerance), decode teacher-forced at per-slot positions; the
slot engine with ``extras`` gives the reference engine's token streams,
slot reuse included; the port raises where the reference raises.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.kernels.ops import use_backend as juse_backend
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.launch import serve
from repro_torch.models import build_model, encdec
from repro_torch.serving import PagedServingEngine, ServingEngine

TOL = dict(rtol=2e-4, atol=2e-4)
MAX_LEN = 24
ARCHS = ["whisper-medium", "internvl2-26b"]


def _build(arch):
    jcfg, cfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if cfg.mlp_bias:  # the reference initialises biases to zero: give them values
        r = np.random.default_rng(2)
        for stack in ("encoder", "decoder"):
            for key in ("b_in", "b_out"):
                b = jparams[stack]["mlp"][key]
                jparams[stack]["mlp"][key] = jnp.asarray(r.normal(size=b.shape), jnp.float32)
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return cfg, jmodel, jparams, model, params


_PAIRS = {}


def pair_for(arch):
    if arch not in _PAIRS:
        _PAIRS[arch] = _build(arch)
    return _PAIRS[arch]


@pytest.fixture(scope="module")
def whisper():
    return pair_for("whisper-medium")


@pytest.fixture(scope="module")
def vlm():
    return pair_for("internvl2-26b")


def _extras(cfg, b, seed=0):
    """Seeded stub inputs of order one: (B, Senc, D) frames or (B, P, D) patches."""
    r = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": r.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    return {"patch_embeds": r.normal(size=(b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)}


def _batches(cfg, toks, seed=0):
    ex = _extras(cfg, toks.shape[0], seed)
    jb = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in ex.items()}}
    tb = {"tokens": torch.from_numpy(toks), **{k: torch.from_numpy(v) for k, v in ex.items()}}
    return jb, tb


def _tokens(b, s, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=(b, s)).astype(np.int32)


def _assert_tree_close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_close(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _assert_cache_close(cache, jcache, cfg):
    _assert_tree_close(cache, cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), cfg))


# ---------------------------------------------------------------------------
# whisper: encoder, decoder, cache
# ---------------------------------------------------------------------------


def test_converted_encdec_params_have_port_layout(whisper):
    cfg, _, jparams, _, params = whisper
    assert len(params["encoder"]) == cfg.encoder_layers == 2
    assert len(params["decoder"]) == cfg.n_layers
    np.testing.assert_array_equal(params["decoder"][1]["cross_attn"]["wk"].numpy(),
                                  np.asarray(jparams["decoder"]["cross_attn"]["wk"][1]))
    np.testing.assert_array_equal(params["encoder"][1]["mlp"]["b_in"].numpy(),
                                  np.asarray(jparams["encoder"]["mlp"]["b_in"][1]))
    assert set(params) == {"embed", "enc_pos", "dec_pos", "encoder", "enc_norm", "decoder",
                           "final_norm", "lm_head"}


def test_encode_matches(whisper):
    cfg, jmodel, jparams, _, params = whisper
    ex = _extras(cfg, 2, seed=1)["frames"]
    want = jencdec.encode(jparams, jmodel.cfg, jnp.asarray(ex), remat=False)
    got = encdec.encode(params, cfg, torch.from_numpy(ex))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encdec_forward_logits_match(whisper):
    cfg, jmodel, jparams, model, params = whisper
    jb, tb = _batches(cfg, _tokens(2, 10, seed=2), seed=2)
    jlogits, _ = jmodel.forward(jparams, jb, remat=False)
    logits, aux = model.forward(params, tb)
    assert logits.shape == (2, 10, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


@pytest.mark.parametrize("true_len", [None, 7])
def test_encdec_prefill_logits_and_cache_match(whisper, true_len):
    """Exact-length and right-padded prefill: logits at the last real
    position, self-KV, the cross K/V (B, Hkv, Senc, hd) and ``t``."""
    cfg, jmodel, jparams, model, params = whisper
    jb, tb = _batches(cfg, _tokens(2, 10, seed=3), seed=3)
    jl, jc = jmodel.prefill(jparams, jb, max_len=MAX_LEN, true_len=true_len)
    logits, cache = model.prefill(params, tb, max_len=MAX_LEN, true_len=true_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert cache["layers"][0]["cross_k"].shape == (2, cfg.n_kv_heads, cfg.encoder_seq,
                                                   cfg.head_dim)
    _assert_cache_close(cache, jc, cfg)
    assert cache["t"].tolist() == [true_len or 10] * 2


def test_encdec_teacher_forced_decode_at_per_slot_positions(whisper):
    """Six decode steps, each slot at its own position (learned positions
    per slot, cross K/V from the prefill), then the whole cache."""
    cfg, jmodel, jparams, model, params = whisper
    jb, tb = _batches(cfg, _tokens(2, 9, seed=4), seed=4)
    jl, jc = jmodel.prefill(jparams, jb, max_len=MAX_LEN)
    logits, cache = model.prefill(params, tb, max_len=MAX_LEN)
    t = np.array([9, 6], np.int32)
    jc["t"] = jnp.asarray(t)
    cache["t"] = torch.from_numpy(t)
    feed = _tokens(6, 2, seed=5)
    for step in range(6):
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(feed[step]))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(feed[step]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(cache, jc, cfg)
    assert cache["t"].tolist() == (t + 6).tolist()


def test_encdec_init_cache_matches_reference_layout(whisper):
    cfg, jmodel, _, model, _ = whisper
    want = jax.tree_util.tree_map(np.asarray, jmodel.init_cache(3, MAX_LEN))
    _assert_tree_close(model.init_cache(3, MAX_LEN), cache_from_jax(want, cfg))


def test_encdec_prefill_matches_reference_pallas_interpret(whisper):
    """The reference's own kernels (Pallas, interpret mode) agree too: the
    bidirectional encoder and the cross-attention included."""
    cfg, jmodel, jparams, model, params = whisper
    jb, tb = _batches(cfg, _tokens(1, 8, seed=6), seed=6)
    with juse_backend("pallas"):
        jl, _ = jmodel.prefill(jparams, jb, max_len=MAX_LEN)
    logits, _ = model.prefill(params, tb, max_len=MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


# ---------------------------------------------------------------------------
# internvl2: the vision prefix
# ---------------------------------------------------------------------------


def test_vlm_converted_params_keep_vis_proj(vlm):
    cfg, _, jparams, _, params = vlm
    np.testing.assert_array_equal(params["vis_proj"].numpy(), np.asarray(jparams["vis_proj"]))
    assert params["vis_proj"].shape == (cfg.d_model, cfg.d_model)


def test_vlm_forward_logits_match(vlm):
    cfg, jmodel, jparams, model, params = vlm
    jb, tb = _batches(cfg, _tokens(2, 10, seed=7), seed=7)
    jlogits, _ = jmodel.forward(jparams, jb, remat=False)
    logits, _ = model.forward(params, tb)
    assert logits.shape == (2, cfg.vision_tokens + 10, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


@pytest.mark.parametrize("true_len", [None, 5])
def test_vlm_prefill_logits_and_cache_match(vlm, true_len):
    """The cache holds the prefix and ``max_len`` text positions; ``t``
    counts the prefix."""
    cfg, jmodel, jparams, model, params = vlm
    jb, tb = _batches(cfg, _tokens(2, 8, seed=8), seed=8)
    jl, jc = jmodel.prefill(jparams, jb, max_len=MAX_LEN, true_len=true_len)
    logits, cache = model.prefill(params, tb, max_len=MAX_LEN, true_len=true_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert cache["layers"][0]["k"].shape[2] == MAX_LEN + cfg.vision_tokens
    _assert_cache_close(cache, jc, cfg)
    assert cache["t"].tolist() == [(true_len or 8) + cfg.vision_tokens] * 2


def test_vlm_teacher_forced_decode_at_per_slot_positions(vlm):
    cfg, jmodel, jparams, model, params = vlm
    jb, tb = _batches(cfg, _tokens(2, 8, seed=9), seed=9)
    jl, jc = jmodel.prefill(jparams, jb, max_len=MAX_LEN, true_len=6)
    logits, cache = model.prefill(params, tb, max_len=MAX_LEN, true_len=6)
    t = np.array([6, 4], np.int32) + cfg.vision_tokens
    jc["t"] = jnp.asarray(t)
    cache["t"] = torch.from_numpy(t)
    feed = _tokens(6, 2, seed=10)
    for step in range(6):
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(feed[step]))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(feed[step]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(cache, jc, cfg)


def test_vlm_prefill_matches_reference_pallas_interpret(vlm):
    cfg, jmodel, jparams, model, params = vlm
    jb, tb = _batches(cfg, _tokens(1, 8, seed=11), seed=11)
    with juse_backend("pallas"):
        jl, _ = jmodel.prefill(jparams, jb, max_len=MAX_LEN)
    logits, _ = model.prefill(params, tb, max_len=MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


# ---------------------------------------------------------------------------
# The slot engine with extras
# ---------------------------------------------------------------------------


def _engine_extras(cfg, seed):
    return {k: v[0] for k, v in _extras(cfg, 1, seed).items()}   # (S, D): one per engine


def _serve_both(jeng, eng, prompts, new_tokens):
    """Admit prompts as slots free up and step both engines together: every
    decode step's logits agree and each engine's own token streams are the
    other's, request by request.  Returns the streams."""
    pending = list(prompts)
    jreqs, reqs = [], []
    for _ in range(64):
        while pending and eng.free_slots:
            p = pending.pop(0)
            jreqs.append(jeng.add_request(p, max_new_tokens=new_tokens))
            reqs.append(eng.add_request(p, max_new_tokens=new_tokens))
            assert reqs[-1].generated[0] == jreqs[-1].generated[0]
        ran = bool(jeng.active)
        assert ran == bool(eng.active)
        jfin, fin = jeng.step(), eng.step()
        assert [r.uid for r in fin] == [r.uid for r in jfin]
        if ran:
            np.testing.assert_allclose(eng.last_logits.numpy(), np.asarray(jeng.last_logits), **TOL)
        for r, jr in zip(reqs, jreqs):
            assert r.generated == jr.generated
        if not pending and not jeng.active:
            break
    assert all(r.done for r in reqs) and all(len(r.generated) == new_tokens for r in reqs)
    return [r.generated for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_engine_with_extras_matches_reference(arch):
    """Three requests through two slots (the third reuses a freed slot):
    whisper prefills at exact lengths, internvl2 in power-of-two buckets
    behind its prefix; the streams are the reference engine's."""
    cfg, jmodel, jparams, model, params = pair_for(arch)
    ex = _engine_extras(cfg, seed=12)
    jeng = JServingEngine(jmodel, jparams, slots=2, max_len=32, extras=ex)
    eng = ServingEngine(model, params, slots=2, max_len=32, extras=ex)
    assert eng.prefill_buckets == jeng.prefill_buckets == (arch == "internvl2-26b")
    prompts = [[5, 6, 7, 8, 9], [9, 10, 11], [3, 1, 4, 1, 5, 9, 2]]
    _serve_both(jeng, eng, prompts, 4)
    assert eng.prefill_trace_count == jeng.prefill_trace_count


def test_slot_reuse_carries_the_new_requests_cross_kv(whisper):
    """A slot freed by one request and reused by a request of other frames
    holds the new request's cross K/V and self-KV, and decodes as a fresh
    engine serving that request alone does: nothing of the first leaks."""
    cfg, jmodel, jparams, model, params = whisper
    ex_a, ex_b = _engine_extras(cfg, seed=13), _engine_extras(cfg, seed=14)
    eng = ServingEngine(model, params, slots=1, max_len=32, extras=ex_a)
    jeng = JServingEngine(jmodel, jparams, slots=1, max_len=32, extras=ex_a)
    eng.add_request([4, 5, 6], max_new_tokens=3)
    jeng.add_request([4, 5, 6], max_new_tokens=3)
    eng.run_to_completion()
    jeng.run_to_completion()
    eng.extras = {"frames": torch.from_numpy(ex_b["frames"])}
    jeng.extras = {"frames": jnp.asarray(ex_b["frames"])}
    prompt = [7, 8, 9, 10]
    _, one = model.prefill(params, {"tokens": torch.tensor([prompt]),
                                    "frames": torch.from_numpy(ex_b["frames"])[None]},
                           max_len=32)
    fresh = ServingEngine(model, params, slots=1, max_len=32, extras=ex_b)
    got = _serve_both(jeng, eng, [prompt], 5)
    for layer, want in zip(eng.cache["layers"], one["layers"]):
        for key in ("cross_k", "cross_v"):
            assert torch.equal(layer[key], want[key])
    alone = fresh.add_request(prompt, max_new_tokens=5)
    fresh.run_to_completion()
    assert got == [alone.generated]


# ---------------------------------------------------------------------------
# Where the reference raises, and the entry point
# ---------------------------------------------------------------------------


def test_paged_engine_refuses_audio_and_vision_like_reference():
    from repro.serving import PagedServingEngine as JPagedServingEngine

    for arch in ARCHS:
        cfg, jmodel, jparams, model, params = pair_for(arch)
        with pytest.raises(ValueError) as want:
            JPagedServingEngine(jmodel, jparams, decode_batch=2, max_ctx=32)
        with pytest.raises(ValueError) as got:
            PagedServingEngine(model, params, decode_batch=2, max_ctx=32)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_serves_the_arch_on_cpu(arch, capsys):
    """``serve.main`` with the reference's zero frames or patch embeddings:
    every request finishes with its token count."""
    res = serve.main(["--device", "cpu", "--preset", "smoke", "--arch", arch, "--requests", "3",
                      "--new-tokens", "3", "--slots", "2", "--max-len", "32"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert res["requests"] == 3 and res["tokens"] == 9 and res["arch"] == get_arch(arch).name
