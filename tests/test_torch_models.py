"""Reduced minitron-4b, rwkv6-1.6b, recurrentgemma-2b, mixtral-8x22b and
dbrx-132b (f32) in the port against ``repro.models``.

The reference builds the weights; ``repro_torch.convert`` hands the same
weights to the port.  Prefill logits (with and without right padding), the
filled cache (KV rows, recurrent states, token-shift and conv carries) and
teacher-forced decode logits at per-slot positions must agree within rtol =
atol = 2e-4 (the repo's f32 kernel tolerance); one prefill of the reference
runs its Pallas kernels in interpret mode.  Plus the configs and their
parameter counts against the reference's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.kernels.ops import use_backend as juse_backend
from repro.models import build_model as jbuild_model
from repro_torch.configs import ARCH_IDS, get_arch, reduced
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import build_model
from repro_torch.models.common import apply_rope, pack_glu, rmsnorm

TOL = dict(rtol=2e-4, atol=2e-4)
MAX_LEN = 24


@pytest.fixture(scope="module")
def pair():
    jcfg = jreduced(jget_arch("minitron-4b"))
    cfg = reduced(get_arch("minitron-4b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return cfg, jmodel, jparams, model, params


def _tokens(b, s, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=(b, s)).astype(np.int32)


def _np_cache(c):
    return jax.tree_util.tree_map(np.asarray, c)


def _assert_cache_equal(cache, jcache, cfg):
    want = cache_from_jax(_np_cache(jcache), cfg)
    np.testing.assert_array_equal(cache["t"].numpy(), want["t"].numpy())
    assert len(cache["layers"]) == cfg.n_layers
    for got_l, want_l in zip(cache["layers"], want["layers"]):
        assert set(got_l) == set(want_l)
        for key in want_l:
            assert got_l[key].dtype == want_l[key].dtype, key
            np.testing.assert_allclose(got_l[key].numpy(), want_l[key].numpy(), **TOL)


def test_full_width_config_matches_reference():
    assert dataclasses.asdict(get_arch("minitron-4b")) == dataclasses.asdict(jget_arch("minitron-4b"))
    assert get_arch("minitron-4b").param_count() == jget_arch("minitron-4b").param_count()


def test_converted_params_have_port_layout(pair):
    cfg, _, jparams, _, params = pair
    assert len(params["layers"]) == cfg.n_layers
    np.testing.assert_array_equal(params["layers"][1]["attn"]["wq"].numpy(),
                                  np.asarray(jparams["groups"]["0"]["attn"]["wq"][1]))
    assert set(params) == {"embed", "layers", "final_norm", "lm_head"}


def test_forward_logits_match(pair):
    cfg, jmodel, jparams, model, params = pair
    toks = _tokens(2, 12, seed=1)
    jlogits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, remat=False)
    logits, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("true_len", [None, 5])
def test_prefill_logits_and_cache_match(pair, true_len):
    cfg, jmodel, jparams, model, params = pair
    toks = _tokens(2, 8, seed=2)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN,
                           true_len=true_len)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN,
                                  true_len=true_len)
    assert logits.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_cache_equal(cache, jc, cfg)


def test_padded_prefill_equals_exact_prefill(pair):
    """Right padding with true_len is inert: same logits as the exact prompt."""
    cfg, _, _, model, params = pair
    toks = _tokens(1, 8, seed=3)
    padded = toks.copy()
    padded[:, 5:] = 0
    lp, _ = model.prefill(params, {"tokens": torch.from_numpy(padded)}, max_len=MAX_LEN, true_len=5)
    le, _ = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :5])}, max_len=MAX_LEN)
    np.testing.assert_allclose(lp.numpy(), le.numpy(), rtol=1e-5, atol=1e-5)


def test_teacher_forced_decode_at_per_slot_positions(pair):
    """Four decode steps with slots at different positions, fed the same
    tokens in both packages: logits and caches agree at every step."""
    cfg, jmodel, jparams, model, params = pair
    toks = _tokens(2, 8, seed=4)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN)
    t = np.array([8, 6], np.int32)           # slot 1 rewinds: per-slot positions
    jc["t"] = jnp.asarray(t)
    cache["t"] = torch.from_numpy(t)
    feed = _tokens(4, 2, seed=5)
    for step in range(4):
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(feed[step]))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(feed[step]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_cache_equal(cache, jc, cfg)
    np.testing.assert_array_equal(cache["t"].numpy(), t + 4)


def test_prefill_matches_reference_pallas_interpret(pair):
    """The reference's own kernels (Pallas, interpret mode) agree too."""
    cfg, jmodel, jparams, model, params = pair
    toks = _tokens(1, 16, seed=6)
    with juse_backend("pallas"):
        jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    logits, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


def test_substrate_helpers_match_reference():
    from repro.models import common as jcommon

    r = np.random.default_rng(7)
    x = r.normal(size=(2, 3, 5, 16)).astype(np.float32)
    pos = r.integers(0, 500, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)), **TOL)
    scale = r.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(scale))), **TOL)
    g, u = r.normal(size=(4, 3)).astype(np.float32), r.normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_array_equal(pack_glu(torch.from_numpy(g), torch.from_numpy(u)).numpy(),
                                  np.asarray(jcommon.pack_glu(jnp.asarray(g), jnp.asarray(u))))


# Variants of reduced minitron built identically in both packages: they drive
# the layer paths minitron itself does not (ring caches with their prefill
# roll and decode wrap, softcaps, tied embeddings with the sqrt(d) scale, GLU
# MLPs, a biased MLP, and a `tail` layer in the reference's pytree).
VARIANTS = {
    "local_global_softcap_tied_geglu": dict(layer_pattern=("L", "G"), n_layers=3, window=8,
                                            attn_softcap=50.0, final_softcap=30.0,
                                            tie_embeddings=True, mlp_kind="geglu"),
    "swa_swiglu": dict(layer_pattern=("L",), window=6, mlp_kind="swiglu"),
    "biased_gelu": dict(mlp_bias=True),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    kw = VARIANTS[request.param]
    jcfg = dataclasses.replace(jreduced(jget_arch("minitron-4b")), **kw)
    cfg = dataclasses.replace(reduced(get_arch("minitron-4b")), **kw)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    if kw.get("mlp_bias"):  # the reference initialises biases to zero: give them values
        r = np.random.default_rng(2)
        for grp in jparams["groups"].values():
            for key in ("b_in", "b_out"):
                grp["mlp"][key] = jnp.asarray(r.normal(size=grp["mlp"][key].shape), jnp.float32)
    model = build_model(cfg, "cpu")
    return cfg, jmodel, jparams, model, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)


def test_variant_prefill_and_ring_decode_match(variant):
    """A prompt longer than the window (ring prefill with its roll), then
    decode steps that wrap the ring, at per-slot positions."""
    cfg, jmodel, jparams, model, params = variant
    toks = _tokens(2, 12, seed=8)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN, true_len=11)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN,
                                  true_len=11)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_cache_equal(cache, jc, cfg)
    t = np.array([11, 9], np.int32)
    jc["t"] = jnp.asarray(t)
    cache["t"] = torch.from_numpy(t)
    feed = _tokens(6, 2, seed=9)
    for step in range(6):
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(feed[step]))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(feed[step]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_cache_equal(cache, jc, cfg)


def test_variant_forward_matches(variant):
    cfg, jmodel, jparams, model, params = variant
    toks = _tokens(1, 10, seed=10)
    jlogits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, remat=False)
    logits, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_unported_layer_kinds_raise():
    """Enc-dec layers are still to port: building such a config raises."""
    base = reduced(get_arch("minitron-4b"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(dataclasses.replace(base, encoder_layers=2, encoder_seq=16), "cpu").init(seed=0)


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(reduced(get_arch("minitron-4b")))


@pytest.mark.parametrize("source", ["init", "converted"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "gemma2-2b"])
def test_tied_head_launches_on_one_held_copy(arch, source, monkeypatch):
    """A tied LM head hands the matmul one transposed, contiguous copy of
    the embedding, built with the params (by ``init`` and by conversion): the
    same tensor at every call, so nothing is copied per call; the logits are
    bit-equal to the old path's, which transposed the embedding per call."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    cfg = reduced(get_arch(arch))
    assert cfg.tie_embeddings
    if source == "init":
        params = build_model(cfg, "cpu").init(seed=0)
    else:
        jparams = jbuild_model(jreduced(jget_arch(arch))).init(jax.random.PRNGKey(0))
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    torch.testing.assert_close(params["embed_t"], params["embed"].T, rtol=0, atol=0)
    h = torch.randn(2, 3, cfg.d_model, generator=torch.Generator().manual_seed(0))
    cls = "matmul_lmhead_softcap" if cfg.final_softcap > 0 else "matmul_lmhead"
    old = ops.matmul(h, params["embed"].T, class_id=cls, softcap=cfg.final_softcap)
    seen, real = [], mm.matmul

    def spy(x, w, cs, **kw):
        seen.append((w.data_ptr(), w.is_contiguous()))
        return real(x, w, cs, **kw)

    monkeypatch.setattr(mm, "matmul", spy)
    first, second = lm._lm_head(params, cfg, h), lm._lm_head(params, cfg, h)
    assert seen == [(params["embed_t"].data_ptr(), True)] * 2
    assert torch.equal(first, old) and torch.equal(second, old)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_and_param_count_match_reference(arch):
    """Every arch the port registers: the config is a copy of the
    reference's, and ``param_count`` / ``active_param_count`` agree at full
    width and reduced (also for MoE and enc-dec variants, which the copy
    counts as the reference does)."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    variants = [(cfg, jcfg), (reduced(cfg), jreduced(jcfg))]
    for kw in (dict(n_experts=8, moe_topk=2), dict(encoder_layers=2, encoder_seq=16)):
        variants.append((dataclasses.replace(cfg, **kw), dataclasses.replace(jcfg, **kw)))
    for c, jc in variants:
        assert c.param_count() == jc.param_count()
        assert c.active_param_count() == jc.active_param_count()


# ---------------------------------------------------------------------------
# Recurrent archs: rwkv6 (attention-free) and recurrentgemma (griffin R, R, L)
# ---------------------------------------------------------------------------

RECURRENT = ("rwkv6-1.6b", "recurrentgemma-2b")

# Leaves the reference initialises to constants (token-shift mixes 0.5, base
# decay -6, gates 0, lambda 2, group-norm scale 1): the tests give them
# values, (mean, sd), so every term of the recurrences is exercised.
_RANDOMISED = {"mu": (0.5, 0.2), "mu_c": (0.5, 0.2), "w0": (-3.0, 0.5), "ln_x": (1.0, 0.1),
               "lambda": (2.0, 0.5), "gate_a": (0.0, 1.0), "gate_i": (0.0, 1.0)}


def _randomise(tree, r):
    if isinstance(tree, dict):
        return {k: (jnp.asarray(_RANDOMISED[k][0] + _RANDOMISED[k][1] * r.normal(size=v.shape),
                                v.dtype)
                    if k in _RANDOMISED and not isinstance(v, (dict, list)) else _randomise(v, r))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomise(v, r) for v in tree]
    return tree


@pytest.fixture(scope="module", params=RECURRENT)
def recurrent(request):
    jcfg = jreduced(jget_arch(request.param))
    cfg = reduced(get_arch(request.param))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild_model(jcfg)
    jparams = _randomise(jmodel.init(jax.random.PRNGKey(0)), np.random.default_rng(11))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return cfg, jmodel, jparams, model, params


def test_recurrent_converted_params_have_port_layout(recurrent):
    """griffin's 5 reduced layers are one (R, R, L) group plus an (R, R)
    tail in the reference; the port keeps them in layer order."""
    cfg, _, jparams, _, params = recurrent
    assert len(params["layers"]) == cfg.n_layers == len(cfg.layer_kinds)
    if cfg.family == "ssm":
        np.testing.assert_array_equal(params["layers"][1]["u"].numpy(),
                                      np.asarray(jparams["groups"]["0"]["u"][1]))
    else:
        assert cfg.layer_kinds == ("R", "R", "L", "R", "R") and len(jparams["tail"]) == 2
        np.testing.assert_array_equal(params["layers"][4]["rnn"]["gate_a"].numpy(),
                                      np.asarray(jparams["tail"][1]["rnn"]["gate_a"]))
        assert set(params["layers"][2]) == {"ln1", "attn", "ln2", "mlp"}


def test_recurrent_forward_logits_match(recurrent):
    cfg, jmodel, jparams, model, params = recurrent
    toks = _tokens(2, 11, seed=21)
    jlogits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, remat=False)
    logits, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert float(aux) == 0.0


def test_recurrent_prefill_logits_and_cache_match(recurrent):
    """A prompt longer than griffin's 8-position attention ring."""
    cfg, jmodel, jparams, model, params = recurrent
    toks = _tokens(2, 13, seed=22)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN)
    assert logits.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_cache_equal(cache, jc, cfg)


def test_recurrent_teacher_forced_decode_at_per_slot_positions(recurrent):
    """Five decode steps with slots at different positions, fed the same
    tokens in both packages: logits, states and carries agree at every step."""
    cfg, jmodel, jparams, model, params = recurrent
    toks = _tokens(2, 9, seed=23)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN)
    t = np.array([9, 6], np.int32)
    jc["t"] = jnp.asarray(t)
    cache["t"] = torch.from_numpy(t)
    feed = _tokens(5, 2, seed=24)
    for step in range(5):
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(feed[step]))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(feed[step]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        _assert_cache_equal(cache, jc, cfg)
    np.testing.assert_array_equal(cache["t"].numpy(), t + 5)


def test_recurrent_prefill_matches_reference_pallas_interpret(recurrent):
    """The reference's own scan kernels (Pallas, interpret mode) agree too."""
    cfg, jmodel, jparams, model, params = recurrent
    toks = _tokens(1, 10, seed=25)
    with juse_backend("pallas"):
        jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    logits, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_bf16_params_keep_f32_leaves(arch):
    """At the archs' own dtype (bf16) the reference keeps u, w0, lambda and
    the gates in f32; conversion and the port's own init keep them so."""
    jcfg = dataclasses.replace(jreduced(jget_arch(arch)), dtype="bfloat16")
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype="bfloat16")
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    converted = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    own = build_model(cfg, "cpu").init(seed=0)
    f32 = {"u", "w0"} if cfg.family == "ssm" else {"lambda", "gate_a", "gate_i"}
    for params in (converted, own):
        layer = params["layers"][0] if cfg.family == "ssm" else params["layers"][0]["rnn"]
        for key, leaf in layer.items():
            assert leaf.dtype == (torch.float32 if key in f32 else torch.bfloat16), key
        assert params["embed"].dtype == torch.bfloat16
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jparams["groups"]["0"])
    jlayer = jlayer if cfg.family == "ssm" else jlayer["rnn"]
    for key, leaf in layer.items():
        assert tuple(leaf.shape) == tuple(jlayer[key].shape), key


# ---------------------------------------------------------------------------
# MoE archs: mixtral-8x22b (all sliding-window) and dbrx-132b (global)
# ---------------------------------------------------------------------------

MOE = ("mixtral-8x22b", "dbrx-132b")


@pytest.fixture(scope="module", params=MOE)
def moe(request):
    jcfg = jreduced(jget_arch(request.param))
    cfg = reduced(get_arch(request.param))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return cfg, jmodel, jparams, model, params


def test_moe_converted_params_have_port_layout(moe):
    """The reference stacks (reps, E, D, 2F) expert weights and a (reps, D, E)
    router per pattern position; conversion gives each layer its own."""
    cfg, _, jparams, _, params = moe
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert len(params["layers"]) == cfg.n_layers
    for j, layer in enumerate(params["layers"]):
        assert set(layer) == {"ln1", "attn", "ln2", "moe"}
        shapes = {key: tuple(v.shape) for key, v in layer["moe"].items()}
        assert shapes == {"router": (d, e), "w_in": (e, d, 2 * f), "w_out": (e, f, d)}
        for key in ("router", "w_in", "w_out"):
            np.testing.assert_array_equal(layer["moe"][key].numpy(),
                                          np.asarray(jparams["groups"]["0"]["moe"][key][j]))


def test_moe_forward_logits_and_aux_match(moe):
    cfg, jmodel, jparams, model, params = moe
    toks = _tokens(2, 12, seed=31)
    jlogits, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, remat=False)
    logits, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("true_len", [None, 7])
def test_moe_prefill_logits_and_cache_match(moe, true_len):
    """A prompt longer than mixtral's 8-position ring, with and without
    right padding."""
    cfg, jmodel, jparams, model, params = moe
    toks = _tokens(2, 11, seed=32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN,
                           true_len=true_len)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN,
                                  true_len=true_len)
    assert logits.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_cache_equal(cache, jc, cfg)


def test_moe_teacher_forced_decode_at_per_slot_positions(moe):
    cfg, jmodel, jparams, model, params = moe
    toks = _tokens(2, 9, seed=33)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN)
    t = np.array([9, 5], np.int32)
    jc["t"] = jnp.asarray(t)
    cache["t"] = torch.from_numpy(t)
    feed = _tokens(5, 2, seed=34)
    for step in range(5):
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(feed[step]))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(feed[step]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_cache_equal(cache, jc, cfg)
    np.testing.assert_array_equal(cache["t"].numpy(), t + 5)


def test_moe_prefill_matches_reference_pallas_interpret(moe):
    """The reference's own kernels, the grouped expert GEMM among them (Pallas,
    interpret mode), agree too."""
    cfg, jmodel, jparams, model, params = moe
    toks = _tokens(1, 10, seed=35)
    with juse_backend("pallas"):
        jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    logits, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_bf16_params_keep_f32_router(arch):
    """At the archs' own dtype the reference keeps the router in f32 and the
    experts in bf16; conversion and the port's own init keep them so."""
    jcfg = dataclasses.replace(jreduced(jget_arch(arch)), dtype="bfloat16")
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype="bfloat16")
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    converted = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    own = build_model(cfg, "cpu").init(seed=0)
    jmoe = jax.tree_util.tree_map(lambda a: a[0], jparams["groups"]["0"]["moe"])
    for params in (converted, own):
        layer = params["layers"][0]["moe"]
        assert layer["router"].dtype == torch.float32
        assert layer["w_in"].dtype == layer["w_out"].dtype == torch.bfloat16
        for key, leaf in layer.items():
            assert tuple(leaf.shape) == tuple(jmoe[key].shape), key


def test_moe_capacity_drops_match_reference():
    """Past the dropless limit (T·k = 1100·4 > 4096) capacity is
    round(T·k/E·1.25) = 688 rows per expert.  Tokens share a direction v and
    the router favours expert 0 along it, so expert 0 is asked for by more
    tokens than it holds: drops occur, and both packages drop the same pairs."""
    from repro.models import mlp as jmlp
    from repro_torch.models import mlp

    kw = dict(n_experts=8, moe_topk=4)
    jcfg = dataclasses.replace(jreduced(jget_arch("mixtral-8x22b")), **kw)
    cfg = dataclasses.replace(reduced(get_arch("mixtral-8x22b")), **kw)
    jp = jmlp.moe_params(jax.random.PRNGKey(7), jcfg)
    r = np.random.default_rng(8)
    v = r.normal(size=(cfg.d_model,)).astype(np.float32)
    v /= np.linalg.norm(v)
    x = (r.normal(size=(1, 1100, cfg.d_model)) + 2.0 * v).astype(np.float32)
    router = np.asarray(jp["router"]).copy()
    router[:, 0] += 1.5 * v
    jp = {**jp, "router": jnp.asarray(router)}
    p = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}

    picks = np.argsort(-(x[0] @ router), axis=-1, kind="stable")[:, :4]
    cap = round(1100 * 4 / 8 * 1.25)
    assert np.bincount(picks.ravel(), minlength=8)[0] > cap   # expert 0 overflows

    jout, jaux = jmlp.moe_apply(jp, jcfg, jnp.asarray(x))
    out, aux = mlp.moe_apply(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    # the drops changed the output: with room for every pair it differs
    roomy, _ = mlp.moe_apply(p, cfg, torch.from_numpy(x), capacity_factor=100.0)
    assert not np.allclose(out.numpy(), roomy.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", ["minitron-4b", "recurrentgemma-2b", "mixtral-8x22b"])
def test_block_halves_compose_to_apply_block(arch):
    """apply_block is apply_mixer, then apply_ffn on the residual stream,
    bit for bit; a MoE block's routing reads what apply_ffn's MoE reads."""
    from repro_torch.models import lm, mlp

    cfg = reduced(get_arch(arch))
    model = build_model(cfg, "cpu")
    params = model.init(seed=0)
    x = np.random.default_rng(9).normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    x = torch.from_numpy(x)
    positions = torch.arange(9).expand(2, 9)
    for j, kind in enumerate(cfg.layer_kinds[:3]):
        p = params["layers"][j]
        kw = dict(positions=positions, pos=None, decode=False)
        cache = lambda: lm.init_block_cache(cfg, kind, 2, 16, "cpu")  # noqa: E731
        out, _, aux = lm.apply_block(p, cfg, kind, x, cache=cache(), **kw)
        a, _ = lm.apply_mixer(p, cfg, kind, x, cache=cache(), **kw)
        y, aux2 = lm.apply_ffn(p, cfg, x + a)
        assert torch.equal(out, x + a + y) and torch.equal(aux, aux2)
        if "moe" in p:
            xn = lm.ffn_input(p, cfg, x + a).reshape(18, -1)
            probs, gates, idx = mlp.moe_route(p["moe"], cfg, xn)
            assert idx.shape == (18, cfg.moe_topk) and bool((aux > 0) & torch.isfinite(probs).all())
            np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
