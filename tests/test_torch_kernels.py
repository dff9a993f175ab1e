"""The port's plain kernel versions and ops against the JAX reference.

Same inputs (numpy, seeded) through ``repro_torch.kernels.ref`` and through
both ``repro.kernels.ref`` and the Pallas kernels in interpret mode under the
same default schedule.  f32 tolerance rtol = atol = 2e-4, as in
``tests/test_kernels_*.py``; bf16 3e-2 (one bf16 rounding of f32 sums taken
in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core.schedule import concretize as jconcretize
from repro.core.schedule import default_schedule as jdefault_schedule
from repro.core.workload import KernelInstance as JKernelInstance
from repro.kernels import flash_attention as jfa
from repro.kernels import matmul as jmm
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ref

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)

CLASSES = [
    ("matmul", None), ("matmul_bias", "bias"), ("matmul_bias_gelu", "bias"),
    ("matmul_silu_glu", None), ("matmul_gelu_glu", None), ("matmul_residual", "residual"),
    ("matmul_lmhead", None), ("matmul_lmhead_softcap", None), ("moe_router", None),
]


def _mm_data(m, n, k, class_id, needs, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(m, k)).astype(np.float32)
    w = (r.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    out_n = n // 2 if "glu" in class_id else n
    bias = r.normal(size=(n,)).astype(np.float32) if needs == "bias" else None
    residual = r.normal(size=(m, out_n)).astype(np.float32) if needs == "residual" else None
    softcap = 2.0 if "softcap" in class_id else 0.0
    return x, w, bias, residual, softcap


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


@pytest.mark.parametrize("class_id,needs", CLASSES)
@pytest.mark.parametrize("m,n,k", [(32, 64, 48), (5, 40, 24)])
def test_ref_matmul_matches_jax_oracle_and_pallas(class_id, needs, m, n, k):
    x, w, bias, residual, softcap = _mm_data(m, n, k, class_id, needs)
    y = ref.matmul(_t(x), _t(w), class_id, bias=_t(bias), residual=_t(residual),
                   softcap=softcap).numpy()
    yj = jref.matmul(_j(x), _j(w), class_id, bias=_j(bias), residual=_j(residual),
                     softcap=softcap)
    np.testing.assert_allclose(y, np.asarray(yj), **TOL)
    inst = JKernelInstance.make(class_id, M=m, N=n, K=k, dtype="float32")
    cs = jconcretize(jdefault_schedule(inst), inst)
    yp = jmm.matmul(_j(x), _j(w), cs, class_id=class_id, bias=_j(bias),
                    residual=_j(residual), softcap=softcap, interpret=True)
    np.testing.assert_allclose(y, np.asarray(yp), **TOL)


@pytest.mark.parametrize("class_id,needs", CLASSES)
def test_ops_matmul_on_cpu_takes_plain_version(class_id, needs):
    """A CPU tensor goes through schedule resolution and the plain version;
    leading dims fold into M; the kernel's launch count does not move."""
    x, w, bias, residual, softcap = _mm_data(6, 32, 16, class_id, needs, seed=3)
    x3 = _t(x).reshape(2, 3, 16)
    res3 = _t(residual).reshape(2, 3, -1) if residual is not None else None
    before = mm.launches
    y = ops.matmul(x3, _t(w), class_id=class_id, bias=_t(bias), residual=res3, softcap=softcap)
    yr = ops.matmul(x3, _t(w), class_id=class_id, bias=_t(bias), residual=res3,
                    softcap=softcap, backend="ref")
    assert mm.launches == before
    assert y.shape == yr.shape == (2, 3, 16 if "glu" in class_id else 32)
    np.testing.assert_array_equal(y.numpy(), yr.numpy())


def test_ref_matmul_bf16_matches_jax_oracle():
    x, w, _, _, _ = _mm_data(16, 64, 96, "matmul_bias_gelu", None, seed=1)
    y = ref.matmul(_t(x).bfloat16(), _t(w).bfloat16(), "matmul_bias_gelu")
    yj = jref.matmul(_j(x, jnp.bfloat16), _j(w, jnp.bfloat16), "matmul_bias_gelu")
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yj, np.float32), **BF16_TOL)


def _attn_data(b, hq, hkv, sq, skv, d, seed=0):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=s).astype(np.float32)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


# (sq, skv, causal, window, softcap, q_offset, group)
ATTN_CASES = [
    (16, 16, True, 0, 0.0, 0, 1),
    (16, 16, False, 0, 0.0, 0, 2),
    (24, 24, True, 8, 0.0, 0, 2),
    (16, 16, True, 0, 20.0, 0, 3),
    (8, 32, True, 0, 0.0, 24, 1),
    (1, 40, True, 0, 0.0, 39, 3),
    (12, 40, True, 6, 10.0, 28, 2),
]


@pytest.mark.parametrize("sq,skv,causal,window,softcap,q_offset,group", ATTN_CASES)
def test_ref_attention_matches_jax_oracles_and_pallas(sq, skv, causal, window, softcap,
                                                      q_offset, group):
    hkv, d = 2, 16
    q, k, v = _attn_data(2, hkv * group, hkv, sq, skv, d, seed=sq + skv)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    y = ref.attention(_t(q), _t(k), _t(v), **kw).numpy()
    yc = ref.chunked_attention(_t(q), _t(k), _t(v), chunk=8, **kw).numpy()
    np.testing.assert_allclose(y, np.asarray(jref.attention(_j(q), _j(k), _j(v), **kw)), **TOL)
    np.testing.assert_allclose(
        yc, np.asarray(jref.chunked_attention(_j(q), _j(k), _j(v), chunk=8, **kw)), **TOL)
    np.testing.assert_allclose(yc, y, **TOL)
    inst = JKernelInstance.make("flash_attention_causal", Q=sq, KV=skv, H=hkv * group, D=d,
                                B=2, window=window, dtype="float32")
    cs = jconcretize(jdefault_schedule(inst), inst)
    yp = jfa.flash_attention(_j(q), _j(k), _j(v), cs, interpret=True, **kw)
    np.testing.assert_allclose(yc, np.asarray(yp), **TOL)
    # the op on a CPU tensor takes the plain version, never the kernel
    before = fa.launches
    yo = ops.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    assert fa.launches == before
    np.testing.assert_allclose(yo, y, **TOL)


def test_fully_masked_rows_stay_zero_like_the_kernel():
    """Window 2 with q_offset past the keys' reach: the plain version the
    wrapper takes on the CPU leaves such rows at 0, as the Pallas kernel does."""
    q, k, v = _attn_data(1, 2, 2, 8, 8, 16, seed=6)
    inst = JKernelInstance.make("flash_attention_causal", Q=8, KV=8, H=2, D=16, B=1,
                                window=2, dtype="float32")
    cs = jconcretize(jdefault_schedule(inst), inst)
    kw = dict(causal=True, window=2, q_offset=12)
    yp = np.asarray(jfa.flash_attention(_j(q), _j(k), _j(v), cs, interpret=True, **kw))
    yo = ops.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    assert np.isfinite(yo).all()
    np.testing.assert_allclose(yo, yp, **TOL)


def test_asking_for_a_kernel_without_a_gpu_raises():
    """No card here: the library refuses to build or load, and the launch
    paths refuse CPU tensors — nothing falls back to a plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.library()
    x = torch.zeros(4, 8)
    w = torch.zeros(8, 16)
    cs = ops.schedule_for(ops.instance("matmul", x.dtype, M=4, N=16, K=8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mm.launch(x, w, cs)
    q = torch.zeros(1, 2, 4, 32)
    acs = ops.schedule_for(ops.instance("flash_attention_causal", q.dtype, Q=4, KV=4,
                                        H=2, D=32, B=1, window=0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.launch(q, q, q, acs)


def test_build_is_keyed_by_sources_and_lists_every_csrc_file():
    assert sorted(p.name for p in _build._sources()) == ["flash_attention.cu", "matmul.cu",
                                                         "rglru_scan.cu", "rwkv6_scan.cu"]
    assert {"repro_rwkv6_scan", "repro_rglru_scan"} <= set(_build.SIGNATURES)
    assert len(_build._key()) == 16
    assert "arch=compute_90a,code=sm_90a" in _build.COMPILE_FLAGS
    assert _build.BUILD_DIR.name == "build"
