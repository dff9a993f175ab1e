"""The port's plain recurrent scans and scan ops against the JAX reference.

Same inputs (numpy, seeded) through ``repro_torch.kernels.ref`` and through
both ``repro.kernels.ref`` and the reference's Pallas scan kernels in
interpret mode, under custom T and C tiles.  f32 tolerance rtol = atol =
2e-4, as in ``tests/test_kernels_*.py``; bf16 3e-2 (one bf16 rounding of f32
values computed in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core.schedule import Schedule as JSchedule
from repro.core.schedule import concretize as jconcretize
from repro.core.workload import KernelInstance as JKernelInstance
from repro.kernels import ref as jref
from repro.kernels import rglru_scan as jrg
from repro.kernels import rwkv6_scan as jrw
from repro_torch.core.schedule import Schedule, concretize
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _rw_data(b, h, t, d, seed=0):
    r_ = np.random.default_rng(seed)
    r, k, v = (r_.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(3))
    w = (_sigmoid(r_.normal(size=(b, h, t, d))) * 0.9 + 0.05).astype(np.float32)
    u = r_.normal(size=(h, d)).astype(np.float32)
    s0 = r_.normal(size=(b, h, d, d)).astype(np.float32)
    return r, k, v, w, u, s0


def _rg_data(b, t, c, seed=0):
    r_ = np.random.default_rng(seed)
    x = r_.normal(size=(b, t, c)).astype(np.float32)
    a = _sigmoid(r_.normal(size=(b, t, c))).astype(np.float32)
    h0 = r_.normal(size=(b, c)).astype(np.float32)
    return x, a, h0


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("b,h,t,d,ct", [(2, 1, 8, 16, 2), (1, 3, 12, 16, 4), (2, 2, 16, 8, 16),
                                        (1, 2, 1, 16, 1), (2, 1, 9, 4, 3)])
def test_rwkv6_plain_matches_jax_oracle_and_pallas(b, h, t, d, ct):
    data = _rw_data(b, h, t, d, seed=b * 100 + t)
    y, s = ref.rwkv6_scan(*_t(data))
    assert y.dtype == torch.float32 and y.shape == (b, h, t, d) and s.shape == (b, h, d, d)
    yj, sj = jref.rwkv6_scan(*_j(data))
    _close(y, yj)
    _close(s, sj)
    inst = JKernelInstance.make("rwkv6_scan", T=t, C=h * d, D=d, B=b, dtype="float32")
    cs = jconcretize(JSchedule.make("rwkv6_scan", {"T": ct, "C": h * d}, order=("C", "T")), inst)
    yp, sp = jrw.rwkv6_scan(*_j(data), cs, interpret=True)
    _close(y, yp)
    _close(s, sp)


@pytest.mark.parametrize("b,t,c,ct,bc", [(2, 8, 12, 4, 8), (1, 16, 8, 8, 4), (2, 6, 20, 3, 20),
                                         (3, 1, 16, 1, 16), (1, 12, 40, 12, 16)])
def test_rglru_plain_matches_jax_oracle_and_pallas(b, t, c, ct, bc):
    data = _rg_data(b, t, c, seed=b * 100 + t + c)
    y, h = ref.rglru_scan(*_t(data))
    assert y.dtype == torch.float32 and y.shape == (b, t, c) and h.shape == (b, c)
    yj, hj = jref.rglru_scan(*_j(data))
    _close(y, yj)
    _close(h, hj)
    inst = JKernelInstance.make("rglru_scan", T=t, C=c, B=b, dtype="float32")
    cs = jconcretize(JSchedule.make("rglru_scan", {"T": ct, "C": bc}, order=("C", "T")), inst)
    yp, hp = jrg.rglru_scan(*_j(data), cs, interpret=True)
    _close(y, yp)
    _close(h, hp)


def test_bf16_scans_match_jax_oracles():
    """bf16 inputs: y in bf16 (one cast of the f32 recurrence), state in f32."""
    r, k, v, w, u, s0 = _rw_data(2, 2, 10, 16, seed=5)
    bf = lambda arrays: [torch.from_numpy(a).bfloat16() for a in arrays]
    y, s = ref.rwkv6_scan(*bf((r, k, v, w)), torch.from_numpy(u), torch.from_numpy(s0))
    yj, sj = jref.rwkv6_scan(*_j((r, k, v, w), jnp.bfloat16), jnp.asarray(u), jnp.asarray(s0))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    _close(y.float(), yj, BF16_TOL)
    _close(s, sj)   # same bf16-exact inputs, f32 state on both sides
    x, a, h0 = _rg_data(2, 10, 24, seed=6)
    y, h = ref.rglru_scan(*bf((x, a)), torch.from_numpy(h0))
    yj, hj = jref.rglru_scan(*_j((x, a), jnp.bfloat16), jnp.asarray(h0))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _close(y.float(), yj, BF16_TOL)
    _close(h, hj)


def test_state_continuation():
    """Scanning [0:t1] then [t1:t] from the returned state equals one scan
    (the serving contract: prefill then decode steps)."""
    r, k, v, w, u, s0 = _t(_rw_data(2, 2, 12, 8, seed=7))
    y, s = ref.rwkv6_scan(r, k, v, w, u, s0)
    y1, s1 = ref.rwkv6_scan(*(z[:, :, :5] for z in (r, k, v, w)), u, s0)
    y2, s2 = ref.rwkv6_scan(*(z[:, :, 5:] for z in (r, k, v, w)), u, s1)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=2).numpy(), y.numpy(), rtol=1e-6)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), rtol=1e-6)
    x, a, h0 = _t(_rg_data(2, 12, 8, seed=8))
    y, h = ref.rglru_scan(x, a, h0)
    y1, h1 = ref.rglru_scan(x[:, :5], a[:, :5], h0)
    y2, h2 = ref.rglru_scan(x[:, 5:], a[:, 5:], h1)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(), y.numpy(), rtol=1e-6)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), rtol=1e-6)


def test_scan_ops_on_cpu_take_plain_version():
    """A CPU tensor goes through schedule resolution (non-contiguous inputs,
    as the model passes them) and the plain version; no kernel launch."""
    r, k, v, w, u, s0 = _t(_rw_data(2, 3, 6, 16, seed=9))
    tr = lambda z: z.transpose(1, 2).contiguous().transpose(1, 2)   # strided like the model's
    before = (rw.launches, rg.launches)
    y, s = ops.rwkv6(tr(r), tr(k), tr(v), tr(w), u, s0)
    yr, sr = ops.rwkv6(r, k, v, w, u, s0, backend="ref")
    np.testing.assert_array_equal(y.numpy(), yr.numpy())
    np.testing.assert_array_equal(s.numpy(), sr.numpy())
    x, a, h0 = _t(_rg_data(2, 6, 20, seed=10))
    y, h = ops.rglru(x, a, h0)
    yr, hr = ops.rglru(x, a, h0, backend="ref")
    np.testing.assert_array_equal(y.numpy(), yr.numpy())
    np.testing.assert_array_equal(h.numpy(), hr.numpy())
    assert (rw.launches, rg.launches) == before


def test_scan_instances_and_schedules_match_reference():
    """ops builds the reference's instances (rwkv6: T, C = H·D, D, B; rglru:
    T, C, B), and custom tiles concretize as in the reference."""
    from repro.core.schedule import default_schedule as jdefault_schedule
    from repro_torch.core.schedule import default_schedule

    for cls, params, tiles in (("rwkv6_scan", dict(T=397, C=2048, D=64, B=1), {"T": 8, "C": 100}),
                               ("rwkv6_scan", dict(T=256, C=48, D=16, B=2), {"T": 64, "C": 48}),
                               ("rglru_scan", dict(T=1, C=2560, B=4), {"T": 1, "C": 1024}),
                               ("rglru_scan", dict(T=33, C=12, B=2), {"T": 3, "C": 8})):
        inst = ops.instance(cls, torch.bfloat16, **params)
        jinst = JKernelInstance.make(cls, dtype="bfloat16", **params)
        assert inst.workload_key() == jinst.workload_key()
        assert default_schedule(inst).to_json() == jdefault_schedule(jinst).to_json()
        got = concretize(Schedule.make(cls, tiles, order=("C", "T")), inst, mode="adaptive")
        want = jconcretize(JSchedule.make(cls, tiles, order=("C", "T")), jinst, mode="adaptive")
        assert (got.tiles, got.grid, got.adapted) == (want.tiles, want.grid, want.adapted)


def test_scan_kernels_refuse_cpu_tensors_and_unknown_head_dims():
    """No card here: the launch paths refuse CPU tensors — nothing falls
    back to a plain version — and K3 names the head dims it takes."""
    r, k, v, w, u, s0 = _t(_rw_data(1, 2, 4, 16))
    cs = ops.schedule_for(ops.instance("rwkv6_scan", r.dtype, T=4, C=32, D=16, B=1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rw.launch(r, k, v, w, u, s0, cs)
    x, a, h0 = _t(_rg_data(1, 4, 8))
    gcs = ops.schedule_for(ops.instance("rglru_scan", x.dtype, T=4, C=8, B=1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rg.launch(x, a, h0, gcs)
    assert 64 in rw.HEAD_DIMS and 16 in rw.HEAD_DIMS and 48 not in rw.HEAD_DIMS


def _default_tiles(cls, **params):
    return ops.schedule_for(ops.instance(cls, torch.bfloat16, **params)).t


def test_rwkv6_geometry_fills_the_card_at_the_main_shapes():
    """rwkv6-1.6b (32 heads of 64) under its default schedules: at least
    128 CTAs at a 256-token prefill, 512 at 4-slot decode (one CTA per
    (batch, head) would launch 32 and 128)."""
    tiles = _default_tiles("rwkv6_scan", T=256, C=2048, D=64, B=1)
    cta_cols, split, stage_t, ctas = rw.scan_geometry(1, 32, 256, 64, tiles["T"])
    assert ctas >= 128 and (cta_cols, split, stage_t) == (rw.CTA_COLS, 64 // rw.THREAD_ROWS, rw.STAGE_T)
    tiles = _default_tiles("rwkv6_scan", T=1, C=2048, D=64, B=4)
    assert rw.scan_geometry(4, 32, 1, 64, tiles["T"])[3] == 512


@pytest.mark.parametrize("b,h,d", [(1, 32, 64), (4, 32, 64), (2, 3, 16), (1, 5, 32)])
def test_rwkv6_geometry_does_not_depend_on_t_or_the_t_tile(b, h, d):
    """Every (T, T tile), a prime T under its default tile of 1 included,
    gets one layout: columns of the head split evenly over CTAs, key rows
    evenly over a column's threads."""
    base = rw.scan_geometry(b, h, 256, d, 128)
    cta_cols, split, stage_t, ctas = base
    assert d % cta_cols == 0 and split * rw.THREAD_ROWS == d and ctas == b * h * (d // cta_cols)
    for t in (1, 2, 16, 17, 181, 397):
        for tile in {1, 8, t, _default_tiles("rwkv6_scan", T=t, C=h * d, D=d, B=b)["T"]}:
            assert rw.scan_geometry(b, h, t, d, tile) == base


@pytest.mark.parametrize("args", [(1, 32, 256, 48, 128), (1, 32, 256, 128, 128), (0, 32, 256, 64, 128),
                                  (1, 0, 256, 64, 128), (1, 32, 0, 64, 128), (1, 32, 256, 64, 0)])
def test_rwkv6_geometry_refuses_invalid_arguments(args):
    with pytest.raises(ValueError):
        rw.scan_geometry(*args)


def test_rglru_geometry_fills_the_card_at_the_main_shapes():
    """recurrentgemma-2b (2560 channels) under its default schedules: at
    least 40 CTAs at a 256-token prefill (one CTA per 512-channel C tile
    would launch 5), and 320 at 4-slot decode."""
    tiles = _default_tiles("rglru_scan", T=256, C=2560, B=1)
    cta_c, stage_t, ctas = rg.scan_geometry(1, 256, 2560, tiles["T"], tiles["C"])
    assert ctas >= 40 and (cta_c, stage_t) == (rg.CTA_C, rg.STAGE_T)
    tiles = _default_tiles("rglru_scan", T=1, C=2560, B=4)
    assert rg.scan_geometry(4, 1, 2560, tiles["T"], tiles["C"])[2] == 320


@pytest.mark.parametrize("b,c,tile_c", [(1, 2560, 512), (4, 2560, 512), (2, 12, 8), (1, 100, 100),
                                        (3, 70, 33)])
def test_rglru_geometry_does_not_depend_on_t_or_the_t_tile(b, c, tile_c):
    base = rg.scan_geometry(b, 256, c, 128, tile_c)
    for t in (1, 2, 31, 33, 181, 397):
        for tile_t in {1, 8, t, _default_tiles("rglru_scan", T=t, C=c, B=b)["T"]}:
            assert rg.scan_geometry(b, t, c, tile_t, tile_c) == base


@pytest.mark.parametrize("c,tile_c", [(2560, 512), (2560, 8), (2560, 2560), (12, 8), (100, 100),
                                      (100, 48), (1000, 96), (70, 33), (5, 512), (31, 1)])
def test_rglru_ctas_never_cross_a_c_tile_edge(c, tile_c):
    """Each CTA's channels lie in one logical C tile, at most CTA_C of them;
    together the CTAs cover every channel once; their count is the
    geometry's."""
    ranges = rg.cta_channels(c, tile_c)
    assert len(ranges) * 3 == rg.scan_geometry(3, 7, c, 1, tile_c)[2]
    seen = []
    for rng in ranges:
        assert len(rng) <= rg.CTA_C
        if len(rng):
            assert rng[0] // tile_c == rng[-1] // tile_c
        seen.extend(rng)
    assert seen == list(range(c))


@pytest.mark.parametrize("args", [(0, 4, 8, 1, 8), (65536, 4, 8, 1, 8), (1, 0, 8, 1, 8),
                                  (1, 4, 0, 1, 8), (1, 4, 8, 0, 8), (1, 4, 8, 1, 0)])
def test_rglru_geometry_refuses_invalid_arguments(args):
    with pytest.raises(ValueError):
        rg.scan_geometry(*args)
