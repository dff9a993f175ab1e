"""The plain backward versions of K1g, K3 and K4 against the reference's
gradients, and what the CPU reaches of the backward kernels' wrappers.

``repro_torch.kernels.ref.{grouped_matmul_bwd, rwkv6_scan_bwd,
rglru_scan_bwd}`` are the plain versions the backward kernels are held to
on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).  Here each is
held to ``jax.vjp`` of the reference's function (``jax.vmap(ref.matmul)``,
``ref.rwkv6_scan``, ``ref.rglru_scan`` of ``repro.kernels.ref``) on the same
numpy-seeded f32 inputs: every input's gradient within 2e-4 of that
gradient's largest entry (both sides sum f32 products in other orders).
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as jref
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.models.mlp import _PairRows

GRAD_REL = 2e-4


def _assert_grad_close(name, got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= GRAD_REL * scale + 1e-7, f"{name}: max |err| {err} vs max |grad| {scale}"


def _vjp(fn, inputs, douts):
    """The reference's gradients of fn's outputs at douts (f32, jnp)."""
    _, pull = jax.vjp(fn, *[jnp.asarray(a) for a in inputs])
    return pull(douts if len(douts) > 1 else douts[0])


@pytest.mark.parametrize("class_id", ref.GROUPED_CLASSES)
@pytest.mark.parametrize("e,m,k,n", [(1, 1, 16, 8), (3, 7, 33, 24), (8, 12, 40, 64)])
def test_grouped_matmul_bwd_matches_reference(class_id, e, m, k, n):
    rng = np.random.default_rng(e + m + k + n)
    x = rng.normal(size=(e, m, k)).astype(np.float32)
    w = (rng.normal(size=(e, k, n)) / np.sqrt(k)).astype(np.float32)
    n_out = n // 2 if "glu" in class_id else n
    dy = rng.normal(size=(e, m, n_out)).astype(np.float32)
    want = _vjp(jax.vmap(lambda a, b: jref.matmul(a, b, class_id)), (x, w), (jnp.asarray(dy),))
    got = ref.grouped_matmul_bwd(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dy),
                                 class_id)
    for name, g, wnt in zip(("dx", "dw"), got, want):
        _assert_grad_close(name, g, wnt)


# (b, h, t, d, w_low, w_high, with_state): T = 1; T = 37, not a multiple of
# the backward kernel's 16-token stages (nor of the forward's 32); B = 1 and
# 3; head dims 16, 32 and 64; w near 0 and near 1; an incoming state and a
# gradient on the final state
RW_CASES = [(1, 1, 1, 16, 0.05, 0.95, True), (3, 2, 37, 16, 0.05, 0.95, True),
            (1, 2, 37, 32, 0.0, 0.02, False), (3, 1, 20, 64, 0.98, 1.0, True),
            (1, 1, 37, 64, 0.3, 0.9, False), (3, 2, 1, 32, 0.5, 0.99, True)]


@pytest.mark.parametrize("b,h,t,d,w_low,w_high,with_state", RW_CASES)
def test_rwkv6_scan_bwd_matches_reference(b, h, t, d, w_low, w_high, with_state):
    rng = np.random.default_rng(b * 100 + t + d)
    r, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(3))
    w = rng.uniform(w_low, w_high, size=(b, h, t, d)).astype(np.float32)
    u = rng.normal(size=(h, d)).astype(np.float32)
    s0 = (rng.normal(size=(b, h, d, d)) if with_state else np.zeros((b, h, d, d))).astype(np.float32)
    dy = rng.normal(size=(b, h, t, d)).astype(np.float32)
    ds = rng.normal(size=(b, h, d, d)).astype(np.float32) if with_state else np.zeros_like(s0)
    want = _vjp(jref.rwkv6_scan, (r, k, v, w, u, s0), (jnp.asarray(dy), jnp.asarray(ds)))
    t_ = torch.from_numpy
    got = ref.rwkv6_scan_bwd(t_(r), t_(k), t_(v), t_(w), t_(u), t_(s0), t_(dy),
                             t_(ds) if with_state else None)
    for name, g, wnt in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got, want):
        _assert_grad_close(name, g, wnt)


@pytest.mark.parametrize("b,t,c,a_low,a_high,with_state", [
    (1, 1, 8, 0.1, 0.9, True), (3, 37, 16, 0.1, 0.9, True), (1, 70, 40, 0.9, 0.999, False),
    (3, 5, 24, 0.0, 0.05, True), (1, 37, 2560 // 80, 0.55, 0.65, False)])
def test_rglru_scan_bwd_matches_reference(b, t, c, a_low, a_high, with_state):
    """T = 1, T = 37 and 70 (not multiples of the backward kernel's 32-token
    stages), B = 1 and 3, a near 0 and near 1, a near recurrentgemma's init
    (0.60), an incoming state and a gradient on the final state."""
    rng = np.random.default_rng(b * 100 + t + c)
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    a = rng.uniform(a_low, a_high, size=(b, t, c)).astype(np.float32)
    h0 = (rng.normal(size=(b, c)) if with_state else np.zeros((b, c))).astype(np.float32)
    dy = rng.normal(size=(b, t, c)).astype(np.float32)
    dh = rng.normal(size=(b, c)).astype(np.float32) if with_state else np.zeros_like(h0)
    want = _vjp(jref.rglru_scan, (x, a, h0), (jnp.asarray(dy), jnp.asarray(dh)))
    t_ = torch.from_numpy
    got = ref.rglru_scan_bwd(t_(x), t_(a), t_(h0), t_(dy), t_(dh) if with_state else None)
    for name, g, wnt in zip(("dx", "da", "dstate"), got, want):
        _assert_grad_close(name, g, wnt)


def test_rglru_scan_bwd_at_a_equal_one_is_infinite_as_the_reference():
    """Where a = 1 the square root's derivative at 0 makes da ±inf (the sign
    of -x·g; NaN where x·g is 0) and dx 0, in both packages: the kernel
    computes the same (no clamp the reference lacks)."""
    x = np.array([[[0.5, -0.5, 0.0, 0.5]]], np.float32)
    a = np.array([[[1.0, 1.0, 1.0, 0.5]]], np.float32)
    h0 = np.zeros((1, 4), np.float32)
    dy = np.array([[[1.0, 1.0, 1.0, 1.0]]], np.float32)
    want = _vjp(jref.rglru_scan, (x, a, h0), (jnp.asarray(dy), jnp.zeros((1, 4), jnp.float32)))
    dx, da, _ = ref.rglru_scan_bwd(*(torch.from_numpy(z) for z in (x, a, h0, dy)))
    da, want_da = da.numpy()[0, 0], np.asarray(want[1])[0, 0]
    assert da[0] == -np.inf and da[1] == np.inf and np.isnan(da[2]) and np.isfinite(da[3])
    np.testing.assert_array_equal(np.isinf(da), np.isinf(want_da))
    np.testing.assert_array_equal(np.sign(da[:2]), np.sign(want_da[:2]))
    assert np.isnan(want_da[2])
    assert dx.numpy()[0, 0, :3].tolist() == [0.0, 0.0, 0.0]


def test_bf16_plain_backward_gradients_take_the_input_dtypes():
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    r, k, v, w = (torch.rand((1, 2, 5, 16), generator=g).to(bf) for _ in range(4))
    u, s0 = torch.rand((2, 16), generator=g), torch.zeros((1, 2, 16, 16))
    got = ref.rwkv6_scan_bwd(r, k, v, w, u, s0, torch.rand((1, 2, 5, 16), generator=g).to(bf))
    assert [t.dtype for t in got] == [bf] * 4 + [torch.float32] * 2
    x, a = torch.rand((2, 5, 8), generator=g).to(bf), torch.rand((2, 5, 8), generator=g).to(bf)
    got = ref.rglru_scan_bwd(x, a, torch.zeros((2, 8)), torch.rand((2, 5, 8), generator=g).to(bf))
    assert [t.dtype for t in got] == [bf, bf, torch.float32]
    xg, wg = torch.rand((2, 3, 8), generator=g).to(bf), torch.rand((2, 8, 6), generator=g).to(bf)
    got = ref.grouped_matmul_bwd(xg, wg, torch.rand((2, 3, 3), generator=g).to(bf),
                                 "moe_gemm_silu_glu")
    assert [t.dtype for t in got] == [bf, bf]


@pytest.mark.parametrize("op", ["moe_gemm", "moe_gemm_silu_glu", "rwkv6", "rglru"])
def test_ops_under_autograd_on_the_cpu_give_the_plain_backward(op):
    """On the CPU an op under autograd is the plain version differentiated
    by torch: its gradients are the plain backward's, bit for bit."""
    g = torch.Generator().manual_seed(1)
    if op.startswith("moe"):
        n = 12
        ins = (torch.randn((3, 5, 8), generator=g), torch.randn((3, 8, n), generator=g))
        dy = torch.randn((3, 5, n // 2 if "glu" in op else n), generator=g)
        fn = lambda x, w: ops.moe_gemm(x, w, class_id=op)   # noqa: E731
        want = ref.grouped_matmul_bwd(*ins, dy, op)
    elif op == "rwkv6":
        ins = (*(torch.rand((2, 2, 7, 16), generator=g) for _ in range(4)),
               torch.rand((2, 16), generator=g), torch.randn((2, 2, 16, 16), generator=g))
        dy = torch.randn((2, 2, 7, 16), generator=g)
        fn = lambda *a: ops.rwkv6(*a)[0]   # noqa: E731
        want = ref.rwkv6_scan_bwd(*ins, dy)
    else:
        ins = (torch.randn((2, 7, 8), generator=g), torch.rand((2, 7, 8), generator=g),
               torch.randn((2, 8), generator=g))
        dy = torch.randn((2, 7, 8), generator=g)
        fn = lambda *a: ops.rglru(*a)[0]   # noqa: E731
        want = ref.rglru_scan_bwd(*ins, dy)
    leaves = [t.clone().requires_grad_() for t in ins]
    got = torch.autograd.grad(fn(*leaves), leaves, dy)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _rw_cs(b, h, t, d, dtype=torch.float32):
    return ops.schedule_for(ops.instance("rwkv6_scan", dtype, T=t, C=h * d, D=d, B=b))


def _rg_cs(b, t, c, dtype=torch.float32):
    return ops.schedule_for(ops.instance("rglru_scan", dtype, T=t, C=c, B=b))


def test_backward_launches_refuse_cpu_tensors():
    r = torch.zeros((1, 2, 5, 16))
    u, s0 = torch.zeros((2, 16)), torch.zeros((1, 2, 16, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rw.launch_bwd(r, r, r, r, u, s0, r, None, _rw_cs(1, 2, 5, 16))
    x = torch.zeros((1, 5, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rg.launch_bwd(x, x, torch.zeros((1, 8)), x, None, _rg_cs(1, 5, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mm.grouped_grad_launch(torch.zeros((2, 3, 4)), torch.zeros((2, 4, 5)))


def _rw_layout(cluster, ctas, checkpoints):
    return {"cols": 16, "stage_t": 16, "sub_t": 8, "cluster": cluster, "ctas": ctas,
            "checkpoints": checkpoints}


@pytest.mark.parametrize("b,h,t,d,want", [
    (4, 32, 512, 64, _rw_layout(4, 512, 32)),
    (1, 3, 37, 16, _rw_layout(1, 3, 3)),
    (3, 2, 1, 32, _rw_layout(2, 12, 1)),
    # f32 inputs take the same layout
    (4, 32, 512, 64, _rw_layout(4, 512, 32) | {"dtype": torch.float32})])
def test_rwkv6_bwd_geometry(b, h, t, d, want):
    """A CTA per (b, h, 16 value columns), a head's CTAs one cluster; a
    checkpoint every 16 tokens, 8-token reverse sub-stages (bf16 unless
    stated).  The shared bytes are the library's to report (on the card)."""
    want = dict(want)
    dtype = want.pop("dtype", torch.bfloat16)
    assert rw.bwd_geometry(b, h, t, d, dtype) == want


@pytest.mark.parametrize("args,match", [((1, 1, 5, 48), "head dims"), ((0, 1, 5, 16), ">= 1"),
                                        ((1, 1, 0, 16), ">= 1"),
                                        ((1, 1, 5, 16, torch.float16), "bf16 or f32")])
def test_rwkv6_bwd_geometry_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        rw.bwd_geometry(*args)


def test_scan_argument_checks_reach_the_cpu():
    cs = _rw_cs(1, 2, 5, 16)
    r = torch.zeros((1, 2, 5, 16))
    u, s0 = torch.zeros((2, 16)), torch.zeros((1, 2, 16, 16))
    assert rw.check_args(r, r, r, r, u, s0, cs) == rw.scan_geometry(1, 2, 5, 16, cs.t["T"])
    with pytest.raises(ValueError, match="one dtype"):
        rw.check_args(r, r.to(torch.bfloat16), r, r, u, s0, cs)
    with pytest.raises(ValueError, match="u must be"):
        rw.check_args(r, r, r, r, torch.zeros((2, 8)), s0, cs)
    with pytest.raises(ValueError, match="does not fit"):
        rw.check_args(r, r, r, r, u, s0, _rw_cs(1, 2, 6, 16))
    with pytest.raises(ValueError, match="contiguous"):
        rw.check_args(torch.zeros((1, 5, 2, 16)).transpose(1, 2), r, r, r, u, s0, cs)
    x = torch.zeros((2, 5, 64))
    cs = _rg_cs(2, 5, 64)
    assert rg.check_args(x, x, torch.zeros((2, 64)), cs)[2:] == (
        rg.scan_geometry(2, 5, 64, cs.t["T"], cs.t["C"])[2], cs.t["C"])
    with pytest.raises(ValueError, match="state must be"):
        rg.check_args(x, x, torch.zeros((2, 32)), cs)
    with pytest.raises(ValueError, match="does not fit"):
        rg.check_args(x, x, torch.zeros((2, 64)), _rg_cs(2, 6, 64))
    with pytest.raises(ValueError, match="one shape"):
        rg.check_args(x, x[:, :4], torch.zeros((2, 64)), cs)


@pytest.mark.parametrize("e,m,n,k", [(8, 2048, 32768, 6144), (8, 2048, 6144, 16384),
                                     (8, 2048, 6144, 32768), (8, 6144, 32768, 2048),
                                     (3, 7, 24, 33)])
def test_grouped_grad_schedules_sum_in_f32(e, m, n, k):
    """K1g's gradient launches (mixtral's dX and dW at the training batch,
    and a ragged case) take default schedules that never round per K tile,
    keyed as ``ops.moe_gemm`` keys the class (M = rows per expert × E)."""
    cs = mm.grouped_grad_schedule("moe_gemm", torch.bfloat16, e, m, n, k)
    assert mm.round_k_for(cs) == 0
    assert (cs.instance.class_id, cs.instance.p["M"], cs.instance.p["E"]) == ("moe_gemm", m * e, e)


@pytest.mark.parametrize("t,k", [(1, 1), (5, 2), (9, 4)])
def test_moe_dispatch_rows_and_their_gradient(t, k):
    """The dispatch's rows are ``x[order // k]`` and their gradient adds each
    token's k row gradients in choice order, rounding after each add, as
    the combine adds the forward's contributions."""
    g = torch.Generator().manual_seed(t * 10 + k)
    x = torch.randn((t, 16), generator=g).to(torch.bfloat16)
    order = torch.randperm(t * k, generator=g)
    dy = torch.randn((t * k, 16), generator=g).to(torch.bfloat16)
    xs = x.clone().requires_grad_()
    rows = _PairRows.apply(xs, order, k)
    assert torch.equal(rows, x[order // k])
    (dx,) = torch.autograd.grad(rows, xs, dy)
    per = torch.empty_like(dy)
    per[order] = dy
    want = per[0::k].clone() if k else None
    for j in range(1, k):
        want = want + per[j::k]
    assert torch.equal(dx, want)
    np.testing.assert_allclose(dx.float().numpy(),
                               torch.zeros_like(x).float().index_add_(0, order // k, dy.float()).numpy(),
                               rtol=2e-2, atol=2e-2)
