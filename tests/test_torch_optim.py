"""AdamW and gradient compression in the port against ``repro.optim``.

Given the same grads, one ``apply_updates`` gives the reference's params,
``m``, ``v`` and ``master`` within 1e-6 (the same f32 arithmetic in the
same order; XLA may fuse a multiply-add where torch rounds twice), and the
same learning rate, clip and ``grad_norm``.  Quantization and error
feedback are bit-equal.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.optim import adamw, compression

TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    return {"w": r.normal(size=(4, 8)).astype(dtype), "b": r.normal(size=8).astype(dtype),
            "layers": [{"u": r.normal(size=(3,)).astype(dtype)} for _ in range(2)]}


def _jax(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype=torch.float32):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), dtype=dtype), tree)


def _np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _tleaves(tree):
    return [x.float().numpy() for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_lr_schedule_matches_reference(step):
    cfg = adamw.AdamWConfig(peak_lr=3e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jcfg = jadamw.AdamWConfig(peak_lr=3e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    np.testing.assert_allclose(float(adamw.lr_at(cfg, torch.tensor(step, dtype=torch.int32))),
                               float(jadamw.lr_at(jcfg, jnp.asarray(step, jnp.int32))), **TOL)


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1.0, 1e3], ids=["unclipped", "clipped"])
def test_apply_updates_matches_reference(pdtype, grad_scale):
    jdt, tdt = getattr(jnp, pdtype), getattr(torch, pdtype)
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.1, clip_norm=1.0)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jp, p = _jax(_tree(0), jdt), _torch(_tree(0), tdt)
    jstate, state = jadamw.init_state(jp), adamw.init_state(p)
    for i in range(3):   # three steps on the same grads: moments and bias corrections move
        g = jax.tree_util.tree_map(lambda a: a * grad_scale, _tree(10 + i))
        jp, jstate, jm = jadamw.apply_updates(jp, _jax(g, jdt), jstate, jcfg)
        p, state, m = adamw.apply_updates(p, _torch(g, tdt), state, cfg)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), **TOL)
        for key in ("m", "v", "master"):
            for a, b in zip(_tleaves(state[key]), _np(jstate[key])):
                np.testing.assert_allclose(a, b, **TOL, err_msg=key)
        for a, b in zip(_tleaves(p), _np(jp)):
            np.testing.assert_allclose(a, b, **TOL)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
    assert all(x.dtype == tdt for x in jax.tree_util.tree_leaves(p))


def test_master_is_a_copy_of_an_f32_param():
    p = {"w": torch.zeros(4)}
    state = adamw.init_state(p)
    assert state["master"]["w"].data_ptr() != p["w"].data_ptr()
    assert state["m"]["w"].dtype == state["v"]["w"].dtype == torch.float32
    pb = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    assert adamw.init_state(pb)["master"]["w"].dtype == torch.float32


def test_grad_clipping_bounds_the_update():
    cfg = adamw.AdamWConfig(clip_norm=1.0, weight_decay=0.0, peak_lr=1.0, warmup_steps=0,
                            total_steps=10)
    p = {"w": torch.zeros(4)}
    _, _, m = adamw.apply_updates(p, {"w": torch.full((4,), 1e6)}, adamw.init_state(p), cfg)
    assert float(m["grad_norm"]) > 1e6   # reported raw
    assert float(p["w"].abs().max()) <= 10.0


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(peak_lr=0.1, warmup_steps=5, total_steps=200, weight_decay=0.0)
    p = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = adamw.init_state(p)
    for _ in range(200):
        p, state, _ = adamw.apply_updates(p, {"w": 2 * p["w"]}, state, cfg)
    assert float(p["w"].abs().max()) < 1e-2


@pytest.mark.parametrize("seed", range(4))
def test_quantize_is_bit_equal(seed):
    x = np.random.default_rng(seed).normal(size=257).astype(np.float32) * 10 ** seed
    q, s = compression.quantize(torch.from_numpy(x))
    jq, js = jcomp.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(compression.dequantize(q, s).numpy(),
                                  np.asarray(jcomp.dequantize(jq, js)))


def test_error_feedback_is_bit_equal():
    rng = np.random.default_rng(0)
    r, jr = torch.zeros(32), jnp.zeros(32, jnp.float32)
    for _ in range(20):
        g = rng.normal(size=32).astype(np.float32)
        q, s, r = compression.compress_with_feedback(torch.from_numpy(g), r)
        jq, js, jr = jcomp.compress_with_feedback(jnp.asarray(g), jr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


def test_compressed_gradients_tree_is_bit_equal():
    g = _tree(3)
    deq, res = compression.compressed_gradients(_torch(g), compression.init_residuals(_torch(g)))
    jdeq, jres = jcomp.compressed_gradients(_jax(g), jcomp.init_residuals(_jax(g)))
    for a, b in zip(_tleaves(deq) + _tleaves(res), _np(jdeq) + _np(jres)):
        np.testing.assert_array_equal(a, b)
    assert [k for k, _ in sorted(deq.items())] == sorted(g)
