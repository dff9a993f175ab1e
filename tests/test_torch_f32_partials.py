"""K1's and K1g's f32 output modes and the f32 carrier, on the CPU
(ROADMAP C.13): the plain versions the wrappers take for CPU tensors,
against the reference's own plain matmul.

Tensor parallelism over ``model`` gives each rank partial sums that the
ranks add before rounding, as the reference sums its f32 dot before the
cast.  ``out_f32`` is that f32 sum (after the epilogue, before the cast);
an f32 *carrier* of bf16 values beside a bf16 ``w`` is read at its bf16
values and takes its input gradient in f32.  The kernels' own modes are
held to these plain versions on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.schedule import concretize, default_schedule
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops, ref

#: f32 sums of one product in another order: the repo's f32 tolerance
F32 = dict(rtol=2e-4, atol=2e-4)


def _bf16(seed: int, *shape, scale: float = 1.0) -> torch.Tensor:
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.normal(size=shape).astype(np.float32)) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("class_id", ["matmul", "matmul_bias"])
@pytest.mark.parametrize("m,k,n", [(4, 96, 64), (33, 40, 18)])
def test_f32_output_is_the_reference_sum_before_its_cast(class_id, m, k, n):
    """``ref.matmul(..., out_f32=True)`` is the reference's f32 dot with its
    epilogue, uncast; cast, it is the bf16 plain version bit for bit."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref

    x, w = _bf16(1, m, k), _bf16(2, k, n, scale=k ** -0.5)
    bias = _bf16(3, n) if class_id == "matmul_bias" else None
    got = ref.matmul(x, w, class_id, bias=bias, out_f32=True)
    assert got.dtype == torch.float32
    jx, jw = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, w))
    jb = None if bias is None else jnp.asarray(bias.float().numpy(), jnp.bfloat16)
    want = jref.apply_epilogue(jnp.dot(jx, jw, preferred_element_type=jnp.float32), class_id,
                               bias=jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **F32)
    assert torch.equal(got.to(torch.bfloat16), ref.matmul(x, w, class_id, bias=bias))


def test_partial_sums_added_in_f32_round_once():
    """Two ranks' partial sums over halves of K, added in f32 and cast, are
    the whole product's f32 sum cast (within f32 reordering); adding them
    in bf16 rounds each first."""
    x, w = _bf16(4, 8, 256), _bf16(5, 256, 48, scale=1 / 16)
    halves = [ref.matmul(x[:, i:i + 128], w[i:i + 128], out_f32=True) for i in (0, 128)]
    whole = ref.matmul(x, w, out_f32=True)
    torch.testing.assert_close(halves[0] + halves[1], whole, **F32)
    bf16_sum = halves[0].to(torch.bfloat16).float() + halves[1].to(torch.bfloat16).float()
    assert float((bf16_sum - whole).abs().max()) > float(((halves[0] + halves[1]) - whole).abs().max())


def test_wrappers_take_the_plain_f32_modes_on_the_cpu():
    """K1, K1g and the gradient launch with ``out_f32`` on CPU tensors are
    the plain versions with it."""
    x, w = _bf16(6, 12, 40), _bf16(7, 40, 24)
    inst = ops.instance("matmul", torch.bfloat16, M=12, N=24, K=40)
    cs = concretize(default_schedule(inst), inst)
    assert torch.equal(mm.matmul(x, w, cs, out_f32=True), ref.matmul(x, w, out_f32=True))
    xe, we = _bf16(8, 3, 5, 40), _bf16(9, 3, 40, 24)
    ginst = ops.instance("moe_gemm", torch.bfloat16, M=15, N=24, K=40, E=3)
    gcs = concretize(default_schedule(ginst), ginst)
    assert torch.equal(mm.grouped_matmul(xe, we, gcs, out_f32=True),
                       ref.grouped_matmul(xe, we, out_f32=True))
    assert torch.equal(mm.grad_launch(x, w, out_f32=True), ref.matmul(x, w, out_f32=True))
    assert torch.equal(mm.grouped_grad_launch(xe, we, out_f32=True),
                       ref.grouped_matmul(xe, we, out_f32=True))


@pytest.mark.parametrize("grouped", [False, True])
def test_carrier_reads_bf16_values_and_takes_an_f32_gradient(grouped):
    """An f32 carrier of bf16 values beside a bf16 ``w``: the product is the
    bf16 input's bit for bit, and the input's gradient is dY·wᵀ in f32 (the
    bf16 input's gradient is that, rounded)."""
    if grouped:
        xb, w, dy = _bf16(10, 2, 6, 32), _bf16(11, 2, 32, 16), _bf16(12, 2, 6, 16)
        fn = ops.moe_gemm
        want_dx = ref.grouped_matmul(dy, w.transpose(1, 2).contiguous(), out_f32=True)
    else:
        xb, w, dy = _bf16(10, 6, 32), _bf16(11, 32, 16), _bf16(12, 6, 16)
        fn = ops.matmul
        want_dx = ref.matmul(dy, w.T.contiguous(), out_f32=True)
    carrier = xb.float().requires_grad_()
    plain = xb.clone().requires_grad_()
    y = fn(carrier, w)
    assert torch.equal(y, fn(plain, w))
    y.backward(dy)
    fn(plain, w).backward(dy)
    assert carrier.grad.dtype == torch.float32
    torch.testing.assert_close(carrier.grad, want_dx, **F32)
    assert torch.equal(carrier.grad.to(torch.bfloat16), plain.grad)


def test_f32_output_under_autograd():
    """``out_f32`` under autograd: Y is f32 and the gradients are those of
    the bf16 product."""
    x, w = _bf16(13, 6, 32).requires_grad_(), _bf16(14, 32, 16).requires_grad_()
    y = ops.matmul(x, w, out_f32=True)
    assert y.dtype == torch.float32
    assert torch.equal(y.detach(), ref.matmul(x.detach(), w.detach(), out_f32=True))
    dy = _bf16(15, 6, 16)
    y.backward(dy.float())
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    ops.matmul(x, w).backward(dy)
    assert torch.equal(gx, x.grad) and torch.equal(gw, w.grad)
