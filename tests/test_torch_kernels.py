"""The port's plain kernel versions and ops against the JAX reference.

Same inputs (numpy, seeded) through ``repro_torch.kernels.ref`` and through
both ``repro.kernels.ref`` and the Pallas kernels in interpret mode under the
same default schedule.  f32 tolerance rtol = atol = 2e-4, as in
``tests/test_kernels_*.py``; bf16 3e-2 (one bf16 rounding of f32 sums taken
in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.schedule import Schedule as JSchedule
from repro.core.schedule import concretize as jconcretize
from repro.core.schedule import default_schedule as jdefault_schedule
from repro.core.workload import KernelInstance as JKernelInstance
from repro.kernels import flash_attention as jfa
from repro.kernels import matmul as jmm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.schedule import GLU_CLASSES, Schedule, concretize
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


def _grouped_data(e, m, n, k, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(e, m, k)).astype(np.float32),
            (r.normal(size=(e, k, n)) / np.sqrt(k)).astype(np.float32))


# (E, rows per expert, N, K, custom M/N tiles): E = 1 and 3, rows that the M
# tile does not divide (ragged inside each expert), the default schedule and
# an N-outer one
GROUPED_CASES = [
    (1, 16, 32, 24, None),
    (3, 20, 48, 32, None),
    (3, 20, 48, 32, (16, 16)),
    (1, 13, 40, 16, (8, 16)),
    (3, 7, 24, 40, (4, 8)),
]


@pytest.mark.parametrize("class_id", ref.GROUPED_CLASSES)
@pytest.mark.parametrize("e,m,n,k,tiles", GROUPED_CASES)
def test_ref_grouped_matmul_matches_jax_oracle_and_pallas(class_id, e, m, n, k, tiles):
    """The plain grouped version against the reference's vmapped oracle and
    the Pallas kernel's grouped path in interpret mode."""
    x, w = _grouped_data(e, m, n, k, seed=e + m + n)
    y = ref.grouped_matmul(_t(x), _t(w), class_id).numpy()
    assert y.shape == (e, m, n // 2 if "glu" in class_id else n)
    yj = jax.vmap(lambda a, b: jref.matmul(a, b, class_id))(_j(x), _j(w))
    np.testing.assert_allclose(y, np.asarray(yj), **TOL)
    inst = JKernelInstance.make(class_id, M=m * e, N=n, K=k, E=e, dtype="float32")
    sched = (jdefault_schedule(inst) if tiles is None else
             JSchedule.make(class_id, {"M": tiles[0], "N": tiles[1], "K": k, "E": 1},
                            order=("N", "M", "E", "K")))
    cs = jconcretize(sched, inst)
    yp = jmm.grouped_matmul(_j(x), _j(w), cs, class_id=class_id, interpret=True)
    np.testing.assert_allclose(y, np.asarray(yp), **TOL)


@pytest.mark.parametrize("class_id", ref.GROUPED_CLASSES)
def test_ops_moe_gemm_builds_reference_instance_and_takes_plain_version_on_cpu(class_id):
    """``ops.moe_gemm`` builds the reference's instance (M = m·E) and resolves
    the same schedule; a CPU tensor takes the plain version, and the grouped
    kernel's launch count does not move."""
    e, m, n, k = 3, 20, 48, 32
    x, w = _grouped_data(e, m, n, k, seed=5)
    inst = ops.instance(class_id, torch.float32, M=m * e, N=n, K=k, E=e)
    jinst = jops._instance(class_id, _j(x).dtype, M=m * e, N=n, K=k, E=e)
    assert inst.workload_key() == jinst.workload_key()
    cs, jcs = ops.schedule_for(inst), jconcretize(jdefault_schedule(jinst), jinst)
    assert (cs.tiles, cs.grid, cs.order) == (jcs.tiles, jcs.grid, jcs.schedule.order)
    before = mm.grouped_launches
    y = ops.moe_gemm(_t(x), _t(w), class_id=class_id)
    yr = ops.moe_gemm(_t(x), _t(w), class_id=class_id, backend="ref")
    assert mm.grouped_launches == before
    np.testing.assert_array_equal(y.numpy(), yr.numpy())
    yj = jops.moe_gemm(_j(x), _j(w), class_id=class_id, backend="ref")
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)


def test_grouped_geometry_clamps_tiles_to_one_expert():
    """The schedule's M counts rows over all experts; the kernel's tiles are
    one expert's: a default tile of 120 for 8 experts of 300 rows leaves a
    ragged 60-row tile inside each expert (masked at the expert's edge), an
    M tile above m shrinks to m, and the E tile is ignored."""
    def geometry(class_id, e, m, n, k, tiles=None, e_tile=1):
        x, w = torch.zeros((e, m, k)), torch.zeros((e, k, n))
        inst = ops.instance(class_id, x.dtype, M=m * e, N=n, K=k, E=e)
        cs = (ops.schedule_for(inst) if tiles is None else
              concretize(Schedule.make(class_id, {"M": tiles[0], "N": tiles[1], "K": k,
                                                  "E": e_tile}), inst))
        return mm.grouped_geometry(x, w, cs, class_id)

    assert geometry("moe_gemm", 8, 300, 64, 32) == (8, 300, 64, 32, 120, 64)
    assert geometry("moe_gemm_silu_glu", 8, 4, 96, 48) == (8, 4, 96, 48, 4, 96)
    assert geometry("moe_gemm", 4, 10, 64, 16, tiles=(40, 32), e_tile=4) == (4, 10, 64, 16, 10, 32)
    x, w = torch.zeros((2, 8, 16)), torch.zeros((2, 16, 64))
    cs = ops.schedule_for(ops.instance("moe_gemm", x.dtype, M=8, N=64, K=16, E=2))
    with pytest.raises(ValueError, match="does not fit"):   # M must be m·E, not m
        mm.grouped_geometry(x, w, cs, "moe_gemm")
    with pytest.raises(ValueError, match="no class"):
        mm.grouped_geometry(x, w, cs, "matmul")
    with pytest.raises(ValueError, match="one dtype"):
        mm.grouped_geometry(x, w.bfloat16(), cs, "moe_gemm")
    with pytest.raises(ValueError, match="CUDA tensor"):
        mm.grouped_launch(x, w, cs)


def _group(n, tile_n, cta_n):
    """Logical N tiles one CTA covers, as csrc/common.cuh n_group states it:
    floor(cta_n / tile_n) where the N tile is narrower than both N and the
    CTA, else 1."""
    return cta_n // tile_n if tile_n < min(n, cta_n) else 1


def _mgroup(m, tile_m, cta_rows=16):
    """Logical M tiles one rows-body CTA covers, as csrc/common.cuh m_group
    states it: floor(cta_rows / tile_m) where the M tile is narrower than
    both M and the CTA's 16 rows, else 1."""
    return cta_rows // tile_m if tile_m < min(m, cta_rows) else 1


def _cta_regions(m, n, k, tile_m, tile_n, m_outer, cta_m, cta_n, split_k, ctas, span_m=None):
    """The output region and K slice of every CTA, as csrc/matmul.cu (and
    csrc/matmul_grad.cu, split_k 1) place them: CTA b runs sub-tile (b %
    per_group) // split_k (along N first; a 64-column strip in the rows
    body) and K slice b % split_k of group b // per_group (in the
    schedule's order): ``span_m`` rows (the rows body: ``_mgroup``
    consecutive logical M tiles; else one tile) by ``_group`` consecutive
    logical N tiles, masked at the group's edges and M's and N's.  Yields
    (b, group (m0, m1, n0, n1), CTA region, slice j, (k0, k1))."""
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    span_m = span_m or tile_m
    span = _group(n, tile_n, cta_n) * tile_n
    spans_m, spans_n = cdiv(m, span_m), cdiv(n, span)
    sub_m, sub_n = cdiv(min(span_m, m), cta_m), cdiv(min(span, n), cta_n)
    per_group = sub_m * sub_n * split_k
    assert spans_m * spans_n * per_group == ctas
    k_slice = mm.rows_k_slice(k, split_k)
    for b in range(ctas):
        t, rem = divmod(b, per_group)
        s, j = divmod(rem, split_k)
        tm, tn = divmod(t, spans_n) if m_outer else (t % spans_m, t // spans_m)
        m0, n0 = tm * span_m, tn * span
        m1, n1 = min(m0 + span_m, m), min(n0 + span, n)
        cm0, cn0 = m0 + (s // sub_n) * cta_m, n0 + (s % sub_n) * cta_n
        if cm0 < m1 and cn0 < n1:   # a ragged group may need fewer CTAs
            yield (b, (m0, m1, n0, n1), (cm0, min(cm0 + cta_m, m1), cn0, min(cn0 + cta_n, n1)),
                   j, (j * k_slice, min((j + 1) * k_slice, k)))


def _check_cover(m, n, k, tile_m, tile_n, m_outer, cta_m, cta_n, split_k, ctas, glu, span_m=None):
    """The placement's invariant: every output is covered by exactly one CTA
    in each K slice, and the K slices partition K, in order, none empty; a
    group is whole logical tiles (``span_m`` rows: whole M tiles too), and
    one logical tile where the tile is at least as wide as the CTA or all of
    N (placed as before); a logical tile narrower than a CTA lies whole
    inside one CTA; no CTA crosses M's or N's edge or its group's (nor, so,
    its expert's); the CTAs of one group are numbered consecutively; a GLU
    CTA starts on an even column and spans whole pairs."""
    cover = np.zeros((split_k, m, n), dtype=np.uint8)
    slices, first = {}, {}
    tn = min(tile_n, n)
    span_m = span_m or tile_m
    per_group = (-(-min(span_m, m) // cta_m) * -(-min(_group(n, tile_n, cta_n) * tile_n, n) // cta_n)
                 * split_k)
    for b, (m0, m1, n0, n1), (cm0, cm1, cn0, cn1), j, (k0, k1) in _cta_regions(
            m, n, k, tile_m, tile_n, m_outer, cta_m, cta_n, split_k, ctas, span_m):
        assert m0 <= cm0 < cm1 <= m1 <= m and n0 <= cn0 < cn1 <= n1 <= n
        assert m0 % tile_m == 0 and n0 % tile_n == 0 and (n1 == n or (n1 - n0) % tile_n == 0)
        assert m1 == m or (m1 - m0) % tile_m == 0
        if tn >= cta_n or tile_n >= n:
            assert n1 - n0 == min(tile_n, n - n0)
        if tn < cta_n:   # whole logical tiles inside the CTA
            assert cn0 % tile_n == 0 and (cn1 == n or cn1 % tile_n == 0)
        first.setdefault((m0, n0), b)
        assert b - first[(m0, n0)] < per_group
        if glu:
            assert cn0 % 2 == 0 and (cn1 - cn0) % 2 == 0
        cover[j, cm0:cm1, cn0:cn1] += 1
        slices[j] = (k0, k1)
    assert (cover == 1).all()
    # the K slices partition K, in order, none empty
    assert sorted(slices) == list(range(split_k))
    bounds = [slices[j] for j in range(split_k)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(k0 < k1 for k0, k1 in bounds)
    assert all(bounds[j][1] == bounds[j + 1][0] for j in range(split_k - 1))


def _launch_case(kind, class_id, dtype, e, m, n, k, tiles):
    """(per-expert m, N, tile_m, tile_n, m_outer, E) of a K1 or K1g launch
    under the default schedule or custom (M, N) tiles (N-outer order)."""
    order = ("N", "M", "K") if kind == "K1" else ("N", "M", "E", "K")
    if kind == "K1":
        inst = ops.instance(class_id, dtype, M=m, N=n, K=k)
        sched = None if tiles is None else Schedule.make(
            class_id, {"M": tiles[0], "N": tiles[1], "K": k}, order=order)
    else:
        inst = ops.instance(class_id, dtype, M=m * e, N=n, K=k, E=e)
        sched = None if tiles is None else Schedule.make(
            class_id, {"M": tiles[0], "N": tiles[1], "K": k, "E": 1}, order=order)
    cs = ops.schedule_for(inst) if sched is None else concretize(sched, inst)
    m_outer = [a for a in cs.order if a in ("M", "N")][0] == "M"
    if kind == "K1":
        return m, n, cs.t["M"], cs.t["N"], m_outer, 1
    x, w = torch.zeros((e, m, k), dtype=dtype), torch.zeros((e, k, n), dtype=dtype)
    _, m, n, _, tile_m, tile_n = mm.grouped_geometry(x, w, cs, class_id)
    return m, n, tile_m, tile_n, m_outer, e


# (kernel, class, E, rows (per expert), N, K, custom (M, N) tiles or None):
# ragged edges, GLU, E = 1/3/8, custom 16x48 and 64x64 schedules, the default
# schedule at 256 x {1024, 3072, 9216} and at 300 rows per expert
GEOMETRY_CASES = [
    ("K1", "matmul", 1, 70, 200, 33, None),
    ("K1", "matmul_silu_glu", 1, 130, 96, 300, None),
    ("K1", "matmul_gelu_glu", 1, 37, 100, 64, (16, 48)),
    ("K1", "matmul", 1, 256, 3072, 64, (64, 64)),
    ("K1", "matmul", 1, 256, 3072, 64, None),
    ("K1", "matmul", 1, 256, 1024, 64, None),
    ("K1", "matmul_bias_gelu", 1, 256, 9216, 64, None),
    ("K1", "matmul", 1, 100, 1000, 64, None),
    ("K1", "matmul_silu_glu", 1, 200, 600, 64, (128, 520)),
    ("K1g", "moe_gemm", 1, 70, 96, 33, None),
    ("K1g", "moe_gemm_silu_glu", 3, 37, 100, 64, (16, 48)),
    ("K1g", "moe_gemm_silu_glu", 3, 100, 100, 64, (64, 48)),
    ("K1g", "moe_gemm", 8, 300, 64, 32, None),
    ("K1g", "moe_gemm_silu_glu", 8, 300, 1000, 32, None),
    ("K1g", "moe_gemm", 8, 256, 6144, 64, None),
    ("K1g", "moe_gemm_silu_glu", 8, 256, 4096, 64, None),
    # the rows body at decode (M = 4 slots) with K split across CTAs, ragged
    # strips and slices, GLU, an N tile of 500 and a custom 8-row tile
    ("K1", "matmul", 1, 4, 3072, 3072, None),
    # the rows body over groups of narrow M tiles at a prime M: 1-row tiles
    # (16 a CTA, the default at 397 rows), 3-row tiles (5 a CTA, a GLU), and
    # K1g's experts on 2-row tiles (8 a CTA)
    ("K1", "matmul", 1, 397, 2048, 2048, None),
    ("K1", "matmul", 1, 37, 640, 200, (1, 64)),
    ("K1", "matmul_silu_glu", 1, 37, 300, 130, (3, 48)),
    ("K1g", "moe_gemm", 3, 37, 100, 64, (2, 48)),
    ("K1", "matmul_silu_glu", 1, 4, 1000, 1000, None),
    ("K1", "matmul", 1, 3, 200, 3000, None),
    ("K1", "matmul_lmhead", 1, 4, 4000, 3072, None),
    ("K1", "matmul_gelu_glu", 1, 13, 200, 777, (8, 96)),
    ("K1g", "moe_gemm_silu_glu", 8, 4, 1024, 2048, None),
    ("K1g", "moe_gemm", 3, 13, 64, 600, (8, 64)),
    ("K1g", "moe_gemm", 2, 4, 200, 1024, None),
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind,class_id,e,m,n,k,tiles", GEOMETRY_CASES)
def test_cta_geometry_covers_every_output_once(dtype, kind, class_id, e, m, n, k, tiles):
    """Every output element of each expert is covered by exactly one CTA in
    each K slice, and the K slices partition K; a logical tile narrower than
    a CTA lies whole inside one; no CTA crosses N's edge or its group's (and
    so its expert's); the CTAs of one group are numbered consecutively; a
    GLU CTA starts on an even column and spans whole pairs
    (:func:`_check_cover`)."""
    dt = getattr(torch, dtype)
    m, n, tile_m, tile_n, m_outer, e = _launch_case(kind, class_id, dt, e, m, n, k, tiles)
    body, cta_m, cta_n, split_k, ctas = mm.launch_geometry(dt, m, n, k, tile_m, tile_n, e)
    assert body == mm.body_for(dt, tile_m, mm.tma_layout(n, k, tile_n))
    span_m = tile_m
    if body in mm.CTA_TILES:
        assert (cta_m, cta_n) in mm.CTA_TILES[body]
    elif body == "rows":
        span_m = _mgroup(m, tile_m) * tile_m
        assert (cta_m, cta_n) == (span_m, mm.ROWS_CTA_N)
        assert (cta_n, split_k, ctas) == mm.rows_geometry(m, n, k, tile_m, tile_n, e)
    else:
        assert (cta_m, cta_n) == (tile_m, tile_n)
    assert split_k >= 1 and (body == "rows" or split_k == 1)
    _check_cover(m, n, k, tile_m, tile_n, m_outer, cta_m, cta_n, split_k, ctas,
                 class_id in GLU_CLASSES, span_m)


#: narrow and wide N tiles over ragged N (457 is prime; GLU cases take the
#: even N 458 and even tiles): 1, 2, 3, 5, 7, 21 and 63 group, 64 and 65 do not
NARROW_N_TILES = (1, 2, 3, 5, 7, 21, 63, 64, 65)


def _narrow_cases():
    """(kind, class, E, rows per expert, N, K, (M tile, N tile), round)
    for every body and tile of :data:`NARROW_N_TILES`: rows (4-row tiles,
    with and without rounding), mma (128- and 64-row tiles), fma (f32), K1g
    on rows and mma, the gradient launch (``mma`` with operand modes: rows
    of 457 values are not 16-byte aligned; ``fma`` in f32), 2-D and per
    expert; GLU at the even tiles."""
    cases = []
    for t in NARROW_N_TILES:
        cases += [("grad", "matmul", 1, 300, 457, 64, (128, t), False),
                  ("grad", "moe_gemm", 3, 130, 457, 64, (64, t), False),
                  ("K1", "matmul", 1, 4, 457, 640, (4, t), False),
                  ("K1", "matmul", 1, 4, 457, 640, (4, t), True),
                  ("K1", "matmul_lmhead", 1, 300, 457, 64, (128, t), False),
                  ("K1", "matmul", 1, 100, 457, 64, (64, t), True),
                  ("K1g", "moe_gemm", 3, 4, 457, 300, (4, t), False),
                  ("K1g", "moe_gemm", 3, 130, 457, 64, (64, t), False)]
        if t % 2 == 0:
            cases += [("K1", "matmul_silu_glu", 1, 4, 458, 300, (4, t), False),
                      ("K1", "matmul_gelu_glu", 1, 70, 458, 64, (64, t), False),
                      ("K1g", "moe_gemm_silu_glu", 2, 70, 458, 64, (64, t), False)]
    return cases


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind,class_id,e,m,n,k,tiles,rounding", _narrow_cases())
def test_narrow_n_tiles_cover_every_output_once(dtype, kind, class_id, e, m, n, k, tiles,
                                                rounding):
    """N tiles from 1 to 65 over ragged N in every body (bf16: rows, rows in
    rounding mode, mma; f32: rows, fma), K1, K1g and the gradient launch
    (its ``mma`` with operand modes, its ``fma``): the placement's
    invariant holds (:func:`_check_cover`), a tile narrower than the CTA
    takes groups of ⌊CTA columns / N tile⌋ tiles, and the grid is
    :func:`~repro_torch.kernels.matmul.cta_count`'s."""
    dt = getattr(torch, dtype)
    order = ("M", "N") if m % 2 else ("N", "M")   # both rasterisations
    tile_k = 32 if rounding else k
    if kind == "grad":   # dW's layout: a = xᵀ, b = dZ (K, N), N-contiguous
        lead = (e,) if e > 1 else ()
        a = torch.empty((*lead, k, m), dtype=dt, device="meta").transpose(-1, -2)
        b = torch.empty((*lead, k, n), dtype=dt, device="meta")
        inst = ops.instance(class_id, dt, M=m * e, N=n, K=k, **({"E": e} if e > 1 else {}))
        cs = concretize(Schedule.make(class_id, {"M": tiles[0], "N": tiles[1], "K": k,
                                                 **({"E": 1} if e > 1 else {})},
                                      order=(*order, *(("E",) if e > 1 else ()), "K")), inst)
        geo = mm.grad_geometry(a, b, cs)
        assert geo["body"] == ("mma" if dt == torch.bfloat16 else "fma")
        assert geo["tile_n"] == tiles[1]
        cta_m, cta_n, ctas = mm.grad_cta(geo["body"], m, n, geo["tile_m"], tiles[1], e)
        assert ctas == mm.cta_count(m, n, geo["tile_m"], tiles[1], cta_m, cta_n)
        _check_cover(m, n, k, geo["tile_m"], tiles[1], geo["m_outer"], cta_m, cta_n, 1, ctas,
                     False)
        return
    if kind == "K1":
        inst = ops.instance(class_id, dt, M=m, N=n, K=k)
        sched = Schedule.make(class_id, {"M": tiles[0], "N": tiles[1], "K": tile_k},
                              order=(*order, "K"), cache_write=not rounding)
    else:
        inst = ops.instance(class_id, dt, M=m * e, N=n, K=k, E=e)
        sched = Schedule.make(class_id, {"M": tiles[0], "N": tiles[1], "K": tile_k, "E": 1},
                              order=(*order, "E", "K"), cache_write=not rounding)
    cs = concretize(sched, inst)
    tile_m, tile_n, m_outer, round_k = mm.schedule_key(cs)
    assert tile_n == tiles[1] and bool(round_k) == (rounding and dt == torch.bfloat16
                                                   and class_id not in GLU_CLASSES)
    body, cta_m, cta_n, split_k, ctas = mm.launch_geometry(dt, m, n, k, tile_m, tile_n, e,
                                                           round_k)
    assert body == mm.body_for(dt, tile_m, mm.tma_layout(n, k, tile_n), round_k)
    assert body != "wgmma"   # N = 457 (458 under a GLU, at N tiles off whole 8s) is off 16 bytes
    assert ctas == mm.cta_count(m, n, tile_m, tile_n, cta_m, cta_n) * split_k
    if body != "fma":
        assert mm.n_group(n, tile_n, cta_n) == (cta_n // tile_n if tile_n < cta_n else 1)
    _check_cover(m, n, k, tile_m, tile_n, m_outer, cta_m, cta_n, split_k, ctas,
                 class_id in GLU_CLASSES)


#: internvl2-26b's LM head (d_model 6144, vocab 92553 = 3 × 30851, N tile 3)
#: at decode (4 slots) and on its training path (4 × (256 + 512) rows):
#: (M, body, CTA tile, split_k, CTAs).  A CTA covers 21 tiles (63 columns)
#: in the rows body and 42 (126 of 128) in a 128-column mma CTA, where one
#: CTA a logical tile would launch 30851 and 1480848 CTAs of 3 live columns
INTERNVL2_HEAD_GEOMETRY = [(4, "rows", (4, 64), 1, 1470), (1, "rows", (1, 64), 1, 1470),
                           (3072, "mma", (128, 128), 1, 17640)]


@pytest.mark.parametrize("m,body,cta,split_k,ctas", INTERNVL2_HEAD_GEOMETRY)
def test_cta_geometry_at_internvl2_head(m, body, cta, split_k, ctas):
    inst = ops.instance("matmul_lmhead", torch.bfloat16, M=m, N=92553, K=6144)
    cs = ops.schedule_for(inst)
    assert cs.t["N"] == 3 and cs.t["M"] == min(m, 128)
    got = mm.launch_geometry(torch.bfloat16, m, 92553, 6144, cs.t["M"], cs.t["N"])
    assert got == (body, *cta, split_k, ctas)
    assert mm.n_group(92553, 3, cta[1]) == cta[1] // 3


def _k1_launches_of(cfg, shape):
    """(tag, class, dtype, E, per-expert M, N, K, key) of every K1 and K1g
    forward launch of ``cfg`` at ``shape`` under the default schedules and,
    for a training shape, each one's gradient launches (dX, dW) under their
    own (``grad_schedule``, ``grouped_grad_schedule``)."""
    from repro_torch.core.extract import extract_kernels

    out = []
    for use in extract_kernels(cfg, shape):
        inst = use.instance
        if inst.class_id not in mm.EPILOGUE and inst.class_id not in mm.GROUPED_EPILOGUE:
            continue
        dt, p = getattr(torch, inst.dtype), inst.p
        e = p.get("E", 1)
        m, n, k = p["M"] // e, p["N"], p["K"]
        out.append((use.tag, inst.class_id, dt, e, m, n, k, mm.schedule_key(ops.schedule_for(inst))))
        if shape.kind != "train":
            continue
        for part, (gm, gn, gk) in (("dx", (m, k, n)), ("dw", (k, n, m))):
            cs = (mm.grad_schedule("matmul", dt, gm, gn, gk) if e == 1
                  else mm.grouped_grad_schedule("moe_gemm", dt, e, gm, gn, gk))
            out.append((f"{use.tag}.{part}", "grad", dt, e, gm, gn, gk, mm.schedule_key(cs)))
    return out


def test_grouped_placement_is_internvl2_head_only():
    """Every arch's default K1 and K1g launches at full width, serving (a
    256-token prefill, a 4-slot decode) and training (4 × 512 tokens, with
    the gradient launches' own schedules): the launches whose N tile is
    narrower than both N and their CTA, and so take the grouped placement,
    are internvl2-26b's LM head (forward, every shape; its dW) and no
    other.  A tile that is all of N (the routers') is placed as before."""
    from repro_torch.configs import ARCH_IDS, ShapeConfig, get_arch

    shapes = (ShapeConfig("prefill", 256, 1, "prefill"), ShapeConfig("decode", 512, 4, "decode"),
              ShapeConfig("train", 512, 4, "train"))
    grouped, routers = set(), 0
    for arch in ARCH_IDS:
        for shape in shapes:
            for tag, class_id, dt, e, m, n, k, key in _k1_launches_of(get_arch(arch), shape):
                tile_m, tile_n, _, round_k = key
                if class_id == "grad":
                    body = mm.grad_geometry(torch.empty((e, m, k) if e > 1 else (m, k), dtype=dt,
                                                        device="meta"),
                                            torch.empty((e, k, n) if e > 1 else (k, n), dtype=dt,
                                                        device="meta"))["body"]
                    cta_n = mm.grad_cta(body, m, n, tile_m, tile_n, e)[1]
                else:
                    cta_n = mm.launch_geometry(dt, m, n, k, tile_m, tile_n, e, round_k)[2]
                if mm.n_group(n, tile_n, cta_n) > 1:
                    grouped.add((arch, shape.name, tag))
                routers += class_id == "moe_router" and tile_n == n
    assert grouped == {("internvl2-26b", "prefill", "lm_head"), ("internvl2-26b", "decode", "lm_head"),
                       ("internvl2-26b", "train", "lm_head"), ("internvl2-26b", "train", "lm_head.dw")}
    assert routers == 6   # mixtral's and dbrx's, one tile of all N at each shape

# CTA tile and count of the tensor-core body (wgmma: every N here is
# aligned) at the main path's 256-row prefill shapes under the default
# 128x512 tile (PERF.md §6): minitron-4b's projections and mixtral-8x22b's
# expert GEMMs (8 experts, 256 rows each)
MAIN_PATH_GEOMETRY = [
    (1, 256, 3072, (64, 64, 192)),     # q, o
    (1, 256, 1024, (64, 64, 64)),      # k, v
    (1, 256, 9216, (128, 128, 144)),   # MLP in
    (1, 256, 256000, (128, 128, 4000)),
    (8, 256, 32768, (128, 128, 512)),  # K1g up, per expert (4096 in all)
    (8, 256, 6144, (128, 128, 96)),    # K1g down, per expert (768 in all)
]


@pytest.mark.parametrize("e,m,n,want", MAIN_PATH_GEOMETRY)
def test_cta_geometry_at_main_path_shapes(e, m, n, want):
    inst = ops.instance("matmul" if e == 1 else "moe_gemm", torch.bfloat16, M=m * e, N=n, K=64,
                        **({} if e == 1 else {"E": e}))
    cs = ops.schedule_for(inst)
    assert (cs.t["M"], cs.t["N"]) == (128, 512)
    assert mm.launch_geometry(torch.bfloat16, m, n, 64, 128, 512, e) == ("wgmma", *want[:2], 1, want[2])
    # one CTA per SM at least, or the smallest CTA tile where M·N is too small for that
    assert e * want[2] >= mm.SMS or want[:2] == mm.WGMMA_CTA_TILES[-1]


def test_body_follows_dtype_and_m_tile():
    """bf16 with an M tile above 16 rows takes a tensor-core body (wgmma
    where TMA can read the operands, else mma), f32 the CUDA-core one, and
    an M tile of at most 16 rows (decode) the rows body; a 64x64 schedule
    keeps 64x64 CTAs."""
    assert mm.body_for(torch.bfloat16, 17, True) == "wgmma"
    assert mm.body_for(torch.bfloat16, 17, False) == "mma"
    assert mm.body_for(torch.float32, 17, True) == mm.body_for(torch.float32, 17, False) == "fma"
    assert (mm.body_for(torch.bfloat16, 16, True) == mm.body_for(torch.float32, 16, True)
            == mm.body_for(torch.bfloat16, 16, False) == "rows")
    for m in (1, 4, 16):   # decode: the default M tile is the slot count
        cs = ops.schedule_for(ops.instance("matmul", torch.bfloat16, M=m, N=3072, K=3072))
        assert mm.launch_geometry(torch.bfloat16, m, 3072, 3072, cs.t["M"], cs.t["N"])[0] == "rows"
    cs = ops.schedule_for(ops.instance("moe_router", torch.float32, M=256, N=8, K=6144))
    assert mm.launch_geometry(torch.float32, 256, 8, 6144, cs.t["M"], cs.t["N"]) == ("fma", 128, 8, 1, 2)
    assert mm.launch_geometry(torch.bfloat16, 256, 3072, 3072, 64, 64) == ("wgmma", 64, 64, 1, 192)
    assert mm.launch_geometry(torch.bfloat16, 256, 3072, 3072, 64, 64, aligned=False) == \
        ("mma", 64, 64, 1, 192)
    assert mm.tiled_geometry(40, 40, 40, 40) == (64, 64, 1)   # smaller than any CTA tile: masked
    assert mm.tiled_geometry(40, 40, 40, 40, tiles=mm.WGMMA_CTA_TILES) == (64, 64, 1)

    saved = (mm.launches, mm.grouped_launches, mm.body_launches.copy())
    mm.body_launches.update({("matmul", "mma", torch.bfloat16): 3,
                             ("grouped_matmul", "mma", torch.bfloat16): 2,
                             ("matmul", "fma", torch.float32): 1})
    assert mm.body_count("mma") == 5 and mm.body_count("mma", kernel="matmul") == 3
    assert mm.body_count("fma", dtype=torch.bfloat16) == 0 and mm.body_count() == 6
    mm.reset_launches()
    assert mm.body_count() == 0 and mm.launches == mm.grouped_launches == 0
    mm.launches, mm.grouped_launches = saved[:2]
    mm.body_launches.update(saved[2])


#: the forward's body rule at an M tile of 64 (kernels/matmul.py body_for,
#: tma_layout; csrc/matmul.cu body_rule): (case, K, N, N tile, rounding K
#: tile, x's offset in elements, dtype, body, the mma body's reason)
BODY_RULE_CASES = [
    ("aligned", 64, 3072, 512, 0, 0, "bfloat16", "wgmma", None),
    ("aligned_all_n", 64, 1024, 2048, 0, 0, "bfloat16", "wgmma", None),   # one tile, all of N
    ("rounding", 256, 3072, 512, 128, 0, "bfloat16", "mma", "round"),
    ("internvl2_head", 64, 92553, 3, 0, 0, "bfloat16", "mma", "w_off16"),
    ("whisper_head", 64, 51865, 451, 0, 0, "bfloat16", "mma", "w_off16"),
    ("n_tile_off8", 64, 3072, 500, 0, 0, "bfloat16", "mma", "w_off16"),
    ("x_base_off16", 64, 3072, 512, 0, 3, "bfloat16", "mma", "x_off16"),
    ("x_rows_off16", 100, 3072, 512, 0, 0, "bfloat16", "mma", "x_off16"),
    ("f32", 64, 3072, 512, 0, 0, "float32", "fma", None),
]


@pytest.mark.parametrize("case,k,n,tile_n,round_k,x_off,dtype,want,reason", BODY_RULE_CASES,
                         ids=[c[0] for c in BODY_RULE_CASES])
def test_forward_body_rule(case, k, n, tile_n, round_k, x_off, dtype, want, reason):
    """Aligned bf16 above 16 rows takes wgmma; rounding mode, rows of w
    off 16 bytes (an odd N: internvl2-26b's and whisper-medium's heads; an
    N tile off whole 8s) and x off 16 bytes (its base, or rows of K values
    off whole 8s) take mma, each for its reason (``mma_reason``); f32
    takes fma.  The rule never reads M: the same weight and schedule give
    the same body at every M whose tile is above 16 rows (a paged 64-row
    chunk and the slot engine's one-shot prefill)."""
    dt = getattr(torch, dtype)
    x = torch.zeros(64 * k + x_off, dtype=dt)[x_off:].view(64, k)
    w = torch.zeros((k, n), dtype=dt)
    for m in (17, 64, 65, 256, 397, 2048):
        body = mm.launch_geometry(dt, m, n, k, 64, tile_n, round_k=round_k,
                                  aligned=mm.bases16(x, w))[0]
        assert body == want == mm.body_for(dt, 64, mm.bases16(x, w) and mm.tma_layout(n, k, tile_n),
                                           round_k), (m, body)
    if reason is None:
        if dt == torch.bfloat16:
            with pytest.raises(AssertionError, match="meets the wgmma rule"):
                mm.mma_reason(x, w, tile_n, round_k)
    else:
        assert mm.mma_reason(x, w, tile_n, round_k) == reason
    # and K1g per expert: the expert strides follow from K and N
    assert mm.launch_geometry(dt, 64, n, k, 64, tile_n, 8, round_k,
                              aligned=mm.bases16(x, w))[0] == want


#: the wgmma body's CTA tile and count, per expert: (E, rows per expert, N,
#: M tile, N tile, (cta_m, cta_n, CTAs))
WGMMA_GEOMETRY = [
    (1, 256, 3072, 128, 512, (64, 64, 192)),     # minitron-4b's q, o at 256 rows
    (1, 256, 1024, 128, 512, (64, 64, 64)),      # k, v: the smallest, launching the most
    (1, 256, 9216, 128, 512, (128, 128, 144)),
    (1, 64, 3072, 64, 512, (64, 64, 48)),        # a paged 64-row chunk: 64-row tiles only
    (1, 1500, 1024, 125, 512, (64, 128, 192)),   # whisper's encoder, M tile 125
    (1, 2048, 18432, 128, 512, (128, 128, 2304)),  # gemma2's GeGLU up in training
    (1, 256, 3072, 64, 64, (64, 64, 192)),       # a tuned 64x64 schedule
    (1, 300, 4096, 128, 24, (64, 128, 210)),     # groups of 5 narrow N tiles a CTA
    (8, 256, 32768, 128, 512, (128, 128, 512)),  # mixtral's K1g up: 4096 CTAs in all
    (8, 256, 6144, 128, 512, (128, 128, 96)),    # mixtral's K1g down: 768
    (16, 256, 21504, 128, 512, (128, 128, 336)),  # dbrx's K1g up: 5376
    (16, 256, 6144, 128, 512, (128, 128, 96)),   # dbrx's K1g down: 1536
    (1, 256, 256000, 128, 512, (128, 128, 4000)),  # a 256-row prefill's LM head
]


@pytest.mark.parametrize("e,m,n,tile_m,tile_n,want", WGMMA_GEOMETRY)
def test_wgmma_cta_tiles_and_counts(e, m, n, tile_m, tile_n, want):
    """The CTA tile is the largest of WGMMA_CTA_TILES that fits the logical
    tile (rounded up to 64; along N the group it would cover) and launches
    at least 132 CTAs over all experts, else the one that launches the
    most; its count is cta_count's, and every output is covered once."""
    got = mm.launch_geometry(torch.bfloat16, m, n, 1024, tile_m, tile_n, e)
    assert got == ("wgmma", want[0], want[1], 1, want[2])
    assert want[2] == mm.cta_count(m, n, tile_m, tile_n, *want[:2])
    fits = [c for c in mm.WGMMA_CTA_TILES
            if c[0] <= 64 * -(-min(tile_m, m) // 64)
            and c[1] <= 64 * -(-min(mm.n_group(n, tile_n, c[1]) * tile_n, n) // 64)]
    counts = {c: e * mm.cta_count(m, n, tile_m, tile_n, *c) for c in fits}
    full = [c for c in fits if counts[c] >= mm.SMS]
    assert want[:2] == (full[0] if full else max(fits, key=counts.get))
    if e == 1 and m * n <= 2048 * 18432:
        _check_cover(m, n, 1024, tile_m, tile_n, True, *want[:2], 1, want[2], False)


#: each main-path shape of PERF.md §6's K1 and K1g table under its default
#: schedule: (class, E, rows per expert, K, N, (body, cta_m, cta_n, CTAs))
MAIN_PATH_BODIES = [
    ("matmul", 1, 256, 3072, 3072, ("wgmma", 64, 64, 192)),
    ("matmul", 1, 64, 3072, 3072, ("wgmma", 64, 64, 48)),          # the paged chunk
    ("matmul", 1, 1500, 1024, 1024, ("wgmma", 64, 128, 192)),      # whisper's encoder
    ("matmul_gelu_glu", 1, 2048, 2304, 18432, ("wgmma", 128, 128, 2304)),
    ("moe_gemm_silu_glu", 8, 256, 6144, 32768, ("wgmma", 128, 128, 512)),
    ("moe_gemm", 8, 256, 16384, 6144, ("wgmma", 128, 128, 96)),
    ("moe_gemm_silu_glu", 16, 256, 6144, 21504, ("wgmma", 128, 128, 336)),
    ("moe_gemm", 16, 256, 10752, 6144, ("wgmma", 128, 128, 96)),
    ("matmul_lmhead", 1, 3072, 6144, 92553, ("mma", 128, 128, 17640)),   # internvl2's head
    ("matmul_lmhead", 1, 1792, 1024, 51865, ("mma", 128, 128, 6440)),    # whisper's head
]


@pytest.mark.parametrize("class_id,e,m,k,n,want", MAIN_PATH_BODIES)
def test_main_path_shapes_take_their_body(class_id, e, m, k, n, want):
    extra = {} if e == 1 else {"E": e}
    cs = ops.schedule_for(ops.instance(class_id, torch.bfloat16, M=m * e, N=n, K=k, **extra))
    tile_m, tile_n, _, round_k = mm.schedule_key(cs)
    body, cta_m, cta_n, split_k, ctas = mm.launch_geometry(torch.bfloat16, m, n, k, tile_m, tile_n,
                                                           e, round_k)
    assert (body, cta_m, cta_n, ctas) == want and split_k == 1


# rows-body launches of the main path at decode (M = 4 slots, default
# schedules: 4 x 512 tiles; mixtral's experts 4 x 512 per expert):
# (E, K, N, split_k, ctas per expert).  minitron-4b's q/o, k/v, MLP in and
# out and LM head, rwkv6-1.6b's 2048^2, recurrentgemma-2b's gelu-GLU MLP in,
# mixtral-8x22b's expert up and down GEMMs
MAIN_PATH_DECODE = [
    (1, 3072, 3072, 6, 288),
    (1, 3072, 1024, 12, 192),
    (1, 3072, 9216, 2, 288),
    (1, 9216, 3072, 6, 288),
    (1, 3072, 256000, 1, 4000),
    (1, 2048, 2048, 8, 256),
    (1, 2560, 15360, 2, 480),
    (8, 6144, 32768, 1, 512),
    (8, 16384, 6144, 1, 96),
]


@pytest.mark.parametrize("e,k,n,split_k,ctas", MAIN_PATH_DECODE)
def test_rows_geometry_at_main_path_decode_shapes(e, k, n, split_k, ctas):
    """Each decode launch fills the card: at least one CTA per SM over all
    experts (two where K allows a split), K split only where the strips
    alone launch fewer than two per SM."""
    inst = ops.instance("matmul" if e == 1 else "moe_gemm", torch.bfloat16, M=4 * e, N=n, K=k,
                        **({} if e == 1 else {"E": e}))
    cs = ops.schedule_for(inst)
    tile_m, tile_n = min(cs.t["M"], 4), cs.t["N"]
    assert (tile_m, tile_n) == (4, 512)
    got = mm.launch_geometry(torch.bfloat16, 4, n, k, tile_m, tile_n, e)
    assert got == ("rows", 4, mm.ROWS_CTA_N, split_k, ctas)
    assert e * ctas >= mm.SMS
    strips = e * ctas // split_k
    assert (split_k == 1) == (strips >= mm.ROWS_MIN_CTAS)


@pytest.mark.parametrize("k,n,tile_n,groups", [(3072, 3072, 512, 1), (3072, 1024, 512, 1),
                                               (2048, 2048, 512, 1), (777, 100, 100, 1),
                                               (16384, 6144, 512, 8), (640, 96, 96, 3),
                                               (3000, 200, 200, 1), (3072, 256000, 512, 1),
                                               (6144, 92553, 3, 1)])
def test_rows_split_k_does_not_change_with_m(k, n, tile_n, groups):
    """split_k (and so each row's summation order) is a function of K, N,
    the N tile and the expert count: the same at M = 1, the 4 decode slots,
    16 rows and a prime 397-row prefill on 1-row tiles; internvl2-26b's
    head (N tile 3, 21 tiles a CTA) among them."""
    geos = {m: mm.rows_geometry(m, n, k, tile_m, tile_n, groups)
            for m, tile_m in ((1, 1), (4, 4), (16, 16), (397, 1), (13, 8))}
    assert len({(cta_n, split_k) for cta_n, split_k, _ in geos.values()}) == 1
    cta_n, split_k, _ = geos[4]
    span = _group(n, tile_n, cta_n) * tile_n
    for m, tile_m in ((1, 1), (4, 4), (16, 16), (397, 1), (13, 8)):
        span_m = _mgroup(m, tile_m) * tile_m   # a CTA's rows: a group of narrow M tiles
        assert geos[m][2] == -(-m // span_m) * -(-n // span) * -(-min(span, n) // cta_n) * split_k
    # a slice is never shorter than ROWS_MIN_SLICE unless K itself is
    assert split_k == 1 or mm.rows_k_slice(k, split_k) >= mm.ROWS_MIN_SLICE


@pytest.mark.parametrize("m,tile_m,want", [(397, 1, 16), (181, 1, 16), (362, 2, 8), (13, 8, 2),
                                            (16, 16, 1), (4, 4, 1), (45, 3, 5), (100, 10, 1),
                                            (397, 17, 1)])
def test_m_group_states_the_kernels_formula(m, tile_m, want):
    """Logical M tiles one rows-body CTA covers (csrc/common.cuh m_group):
    ⌊16 / M tile⌋ where the tile is narrower than both M and 16 rows, else
    1; a CTA's rows (``rows_span``) are at most 16 on the rows body."""
    assert mm.m_group(m, tile_m) == _mgroup(m, tile_m) == want
    assert mm.rows_span(m, tile_m) == want * tile_m
    assert tile_m > 16 or want * tile_m <= mm.ROWS_CTA_M


# the rows body on narrow M tiles (ROADMAP B.1): (class, E, M per expert, K,
# N, custom (M, N) tiles or None, CTAs at one CTA a logical tile, CTAs now).
# The prime 397-row GEMMs and recurrentgemma-2b's 181-token projection on
# their default 1-row tiles (16 a CTA); decode (M = 4) and verify (M = 16)
# on one tile a CTA, as before; K1g's experts on 1-row tiles, per expert
ROWS_GROUP_GEOMETRY = [
    ("matmul", 1, 397, 2048, 2048, None, 101632, 6400),
    ("matmul_gelu_glu", 1, 397, 2560, 15360, None, 190560, 12000),
    ("matmul", 1, 181, 2560, 2560, None, 50680, 3360),
    ("matmul", 1, 4, 3072, 3072, None, 288, 288),
    ("matmul", 1, 16, 3072, 3072, None, 288, 288),
    ("moe_gemm", 3, 37, 640, 1024, (1, 512), 1184, 96),
]


@pytest.mark.parametrize("class_id,e,m,k,n,tiles,tile_ctas,ctas", ROWS_GROUP_GEOMETRY)
def test_rows_geometry_groups_narrow_m_tiles(class_id, e, m, k, n, tiles, tile_ctas, ctas):
    """A rows-body CTA covers a group of ⌊16 / M tile⌋ narrow M tiles: the
    same strips and K slices (split_k as at M = 1), one CTA a group where
    there was one a logical tile; every output covered once, no CTA across
    its group's edge or M (:func:`_check_cover`); decode and verify launch
    as before."""
    kind = "K1" if e == 1 else "K1g"
    m, n, tile_m, tile_n, m_outer, e = _launch_case(kind, class_id, torch.bfloat16, e, m, n, k, tiles)
    body, cta_m, cta_n, split_k, got = mm.launch_geometry(torch.bfloat16, m, n, k, tile_m, tile_n, e)
    span_m = _mgroup(m, tile_m) * tile_m
    assert (body, cta_m, got) == ("rows", span_m, ctas)
    assert tile_ctas == -(-m // tile_m) * (ctas // -(-m // span_m))
    assert split_k == mm.rows_geometry(1, n, k, 1, tile_n, e)[1]
    _check_cover(m, n, k, tile_m, tile_n, m_outer, cta_m, cta_n, split_k, got,
                 class_id in GLU_CLASSES, span_m)


#: the serve phases' prompt lengths (chip_smoke.py serve_prompts, seed 0)
SERVE_PROMPT_LENS = (356, 291, 253, 181, 192, 112, 122, 104)


@pytest.mark.parametrize("arch", ["whisper-medium", "rwkv6-1.6b", "recurrentgemma-2b"])
def test_unbucketed_serve_prompts_group_m_tiles_only_at_181(arch):
    """The archs whose slot engine prefills unbucketed, at full width and
    each serve prompt's length: the K1 and K1g launches whose rows-body CTAs
    cover a group of narrow M tiles are the 181-token prompt's (1-row
    default tiles) and no other prompt's."""
    from repro_torch.configs import ShapeConfig, get_arch

    for tokens in SERVE_PROMPT_LENS:
        grouped = []
        for tag, _, dt, e, m, n, k, key in _k1_launches_of(
                get_arch(arch), ShapeConfig(f"prefill_{tokens}", tokens, 1, "prefill")):
            tile_m, tile_n, _, round_k = key
            body, cta_m, *_ = mm.launch_geometry(dt, m, n, k, tile_m, tile_n, e, round_k)
            if body == "rows" and cta_m > tile_m:
                assert tile_m == 1 and cta_m == mm.ROWS_CTA_M
                grouped.append(tag)
        assert bool(grouped) == (tokens == 181), (tokens, grouped)


def _qgroup(sq, tile_q, cta_q):
    """Logical Q tiles one CTA covers, as csrc/flash_attention.cu q_group
    states it: floor(cta_q / tile_q) where the Q tile is narrower than both
    Sq and the CTA (64 rows: the mma body; 32: the fma body's sub-block),
    else 1."""
    return cta_q // tile_q if tile_q < min(sq, cta_q) else 1


def _attn_cta_rows(body, sq, tile_q, ctas):
    """Query rows of every CTA of one (b, h), as csrc/flash_attention.cu
    places them: a group is ``_qgroup`` consecutive logical tiles; the mma
    body's CTA of rank r (launch order, heaviest first) runs 64-row block
    (ctas - 1 - r) % sub of group (ctas - 1 - r) // sub; the fma body one
    CTA per group.  Yields (rank, group rows, CTA rows)."""
    cta_q = {"mma": 64, "fma": 32}[body]
    span = _qgroup(sq, tile_q, cta_q) * tile_q
    step = cta_q if body == "mma" else span
    sub = -(-min(span, sq) // step)
    for rank in range(ctas):
        idx = ctas - 1 - rank
        g0 = (idx // sub) * span
        g1 = min(g0 + span, sq)
        r0 = g0 + (idx % sub) * step
        if r0 < g1:
            yield rank, (g0, g1), (r0, min(r0 + step, g1))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("sq,tile_q", [(512, 128), (128, 128), (256, 128), (397, 1), (181, 1),
                                       (100, 128), (300, 96), (70, 16), (1, 1), (64, 64),
                                       (200, 200), (253, 23), (362, 2), (96, 48), (64, 32)])
def test_attention_geometry_covers_each_q_tile_once(dtype, sq, tile_q):
    """Every query row is covered by exactly one CTA; a CTA covers whole
    consecutive logical tiles or one part of one, never crossing its
    group's last edge; (mma body) the last row blocks come first."""
    dt = getattr(torch, dtype)
    body, cta_q, ctas = fa.attention_geometry(dt, sq, tile_q)
    assert body == fa.body_for(dt) == ("mma" if dt == torch.bfloat16 else "fma")
    group = _qgroup(sq, tile_q, fa.CTA_Q[body])
    span = group * tile_q
    if body == "mma":
        assert cta_q == fa.MMA_CTA_Q
        assert ctas == -(-sq // span) * -(-min(span, sq) // fa.MMA_CTA_Q)
    else:
        assert (cta_q, ctas) == (span, -(-sq // span))
    if group > 1:   # the fewest CTAs the group allows, one part each
        assert ctas == -(-(-(-sq // tile_q)) // group)
    cover = np.zeros(sq, dtype=np.int64)
    starts = []
    for _, (g0, g1), (r0, r1) in _attn_cta_rows(body, sq, tile_q, ctas):
        assert g0 % span == 0 and g0 <= r0 < r1 <= g1 <= sq
        whole_tiles = r0 % tile_q == 0 and (r1 % tile_q == 0 or r1 == sq)
        assert whole_tiles or r0 // tile_q == (r1 - 1) // tile_q
        cover[r0:r1] += 1
        starts.append(r0)
    assert (cover == 1).all()
    if body == "mma":
        assert starts == sorted(starts, reverse=True)


@pytest.mark.parametrize("sq,tile_q,cta_q,group", [
    (181, 1, 64, 64), (181, 1, 32, 32), (253, 23, 64, 2), (253, 23, 32, 1), (362, 2, 64, 32),
    (96, 48, 64, 1), (64, 32, 64, 2), (64, 32, 32, 1), (64, 64, 64, 1), (100, 128, 64, 1),
    (1, 1, 64, 1), (40, 40, 64, 1), (50, 10, 64, 6), (50, 10, 32, 3), (200, 70, 64, 1),
    (3, 1, 64, 64)])
def test_q_group_case_table(sq, tile_q, cta_q, group):
    """A CTA groups ⌊cta_q / tile_q⌋ Q tiles only where the tile is
    narrower than both Sq and the CTA; a tile that is all of Sq, or at
    least as wide as the CTA, stays one to a group."""
    assert fa.q_group(sq, tile_q, cta_q) == _qgroup(sq, tile_q, cta_q) == group


# (Sq, Q tile, dtype): (cta_q, CTAs per (b, h)) now, and the CTAs one
# logical tile a CTA launched: the prime 181's 1-row tiles 181 -> 3 (mma),
# the 253-token prompt's 23-row tiles 11 -> 6; tiles 64 rows wide or more
# launch as before
GROUPED_GEOMETRY = [(181, 1, "bfloat16", (64, 3), 181), (181, 1, "float32", (32, 6), 181),
                    (253, 23, "bfloat16", (64, 6), 11), (253, 23, "float32", (23, 11), 11),
                    (362, 2, "bfloat16", (64, 6), 181), (64, 32, "bfloat16", (64, 1), 2),
                    (356, 89, "bfloat16", (64, 8), 8), (512, 128, "bfloat16", (64, 8), 8),
                    (192, 96, "bfloat16", (64, 4), 4), (122, 61, "bfloat16", (64, 2), 2)]


@pytest.mark.parametrize("sq,tile_q,dtype,now,before", GROUPED_GEOMETRY)
def test_attention_geometry_groups_narrow_q_tiles(sq, tile_q, dtype, now, before):
    dt = getattr(torch, dtype)
    body, cta_q, ctas = fa.attention_geometry(dt, sq, tile_q)
    assert (cta_q, ctas) == now
    ungrouped = -(-sq // tile_q) * (-(-min(tile_q, sq) // 64) if body == "mma" else 1)
    assert ungrouped == before
    assert (ctas < before) == (fa.q_group(sq, tile_q, fa.CTA_Q[body]) > 1)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-medium", "minitron-4b"])
def test_grouped_q_tiles_at_the_serve_prompts(arch):
    """Of the serve prompts' lengths (356, 291, 253, 181, 192, 112, 122,
    104) prefilled unbucketed, K2's default Q tile groups at 181 (1-row
    tiles, 64 a CTA) and 253 (23-row tiles, 2 a CTA) alone, for each
    attention class of the arch; a power-of-two bucket never groups."""
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    grouped = {}
    for s in (356, 291, 253, 181, 192, 112, 122, 104, 128, 256, 512):
        skvs = {"flash_attention_causal": s}
        if cfg.encoder_layers:
            skvs["flash_attention_cross"] = cfg.encoder_seq
        for class_id, skv in skvs.items():
            cs = ops.schedule_for(ops.instance(class_id, torch.bfloat16, Q=s, KV=skv,
                                               H=cfg.n_heads, D=cfg.head_dim, B=1, window=0))
            group = fa.q_group(s, cs.t["Q"], fa.MMA_CTA_Q)
            if group > 1:
                grouped[s, class_id] = (cs.t["Q"], group)
    classes = ["flash_attention_causal"] + (["flash_attention_cross"] if cfg.encoder_layers else [])
    assert grouped == {**{(181, c): (1, 64) for c in classes}, **{(253, c): (23, 2) for c in classes}}


def test_attention_geometry_at_main_path_prefill_shapes():
    """1·24·512·128 (minitron, bucket 512) runs 8 CTAs per head, 192 in
    all (96 before the CTA was decoupled from the 128-row logical tile)."""
    cs = ops.schedule_for(ops.instance("flash_attention_causal", torch.bfloat16, Q=512, KV=512,
                                       H=24, D=128, B=1, window=0))
    assert cs.t["Q"] == 128
    assert fa.attention_geometry(torch.bfloat16, 512, cs.t["Q"]) == ("mma", 64, 8)
    assert 24 * fa.attention_geometry(torch.bfloat16, 512, cs.t["Q"])[2] == 192
    assert fa.attention_geometry(torch.float32, 512, cs.t["Q"]) == ("fma", 128, 4)

    saved = (fa.launches, fa.body_launches.copy())
    fa.body_launches.update({("mma", torch.bfloat16): 3, ("fma", torch.float32): 1})
    assert fa.body_count("mma") == 3 and fa.body_count() == 4
    assert fa.body_count("mma", dtype=torch.float32) == 0
    fa.reset_launches()
    assert fa.body_count() == 0 and fa.launches == 0
    fa.launches = saved[0]
    fa.body_launches.update(saved[1])


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
    assert sorted(p.name for p in _build._sources()) == ["flash_attention.cu",
                                                         "flash_attention_bwd.cu", "matmul.cu",
                                                         "matmul_grad.cu", "matmul_shift.cu",
                                                         "matmul_wgmma.cu", "rglru_scan.cu",
                                                         "rglru_scan_bwd.cu", "rwkv6_scan.cu",
                                                         "rwkv6_scan_bwd.cu"]
    assert {"repro_rwkv6_scan", "repro_rglru_scan", "repro_grouped_matmul",
            "repro_flash_attention_bwd", "repro_rwkv6_scan_bwd",
            "repro_rglru_scan_bwd", "repro_matmul_grad",
            "repro_grouped_matmul_grad"} <= set(_build.SIGNATURES)
    assert len(_build._key()) == 16
    assert "arch=compute_90a,code=sm_90a" in _build.COMPILE_FLAGS
    assert _build.BUILD_DIR.name == "build"


# ---------------------------------------------------------------------------
# Partial-sum rounding without the f32 scratch (cache_write=False, or K not
# innermost): the reference rounds its sum to bf16 after every K tile
# ---------------------------------------------------------------------------


def _bf16_pair(m, n, k, seed, e=None):
    r = np.random.default_rng(seed)
    lead = () if e is None else (e,)
    x = r.normal(size=(*lead, m, k)).astype(np.float32)
    w = (r.normal(size=(*lead, k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _pallas_bf16(x, w, class_id, tiles, order, cache_write, e=None):
    """The Pallas kernel in interpret mode, bf16, under the given schedule;
    returns (output as an f32 tensor, the port's concrete schedule)."""
    m, k = x.shape[-2:]
    n = w.shape[-1]
    params = dict(M=m * (e or 1), N=n, K=k, **({"E": e} if e else {}))
    jinst = JKernelInstance.make(class_id, dtype="bfloat16", **params)
    jcs = jconcretize(JSchedule.make(class_id, tiles, order=order, cache_write=cache_write), jinst)
    if e is None:
        yp = jmm.matmul(_j(x, jnp.bfloat16), _j(w, jnp.bfloat16), jcs, class_id=class_id,
                        interpret=True)
    else:
        yp = jmm.grouped_matmul(_j(x, jnp.bfloat16), _j(w, jnp.bfloat16), jcs,
                                class_id=class_id, interpret=True)
    inst = ops.instance(class_id, torch.bfloat16, **params)
    cs = concretize(Schedule.make(class_id, tiles, order=order, cache_write=cache_write), inst)
    return torch.from_numpy(np.asarray(yp, np.float32)), cs


def _bf16_ulps(a, b):
    """Per element, how many bf16 values lie between a and b (bf16 tensors)."""
    def ordinal(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordinal(a) - ordinal(b)).abs()


def test_f32_accumulation_differs_from_the_reference_without_its_scratch():
    """The fault the rounding mode repairs: at 8x128x4096 bf16 with a K tile
    of 16 and ``cache_write=False``, the Pallas kernel rounds its sum to bf16
    after every K tile, and the plain version that sums all of K in f32
    differs from it on more than half the elements, by more than 2% of
    max |y| somewhere."""
    x, w = _bf16_pair(8, 128, 4096, seed=0)
    yp, cs = _pallas_bf16(x, w, "matmul", {"M": 8, "N": 128, "K": 16}, ("M", "N", "K"), False)
    y32 = ref.matmul(_t(x).bfloat16(), _t(w).bfloat16(), "matmul").float()
    differ = (y32 != yp).float().mean().item()
    err = (y32 - yp).abs().max().item()
    assert differ > 0.5
    assert err > 0.02 * yp.abs().max().item()
    assert mm.round_k_for(cs) == 16


# (class, (E or None, M, N, K), tiles, order, cache_write, expected round_k)
ROUND_CASES = [
    ("matmul", (None, 8, 128, 4096), {"M": 8, "N": 128, "K": 16}, ("M", "N", "K"), False, 16),
    ("matmul", (None, 16, 256, 2048), {"M": 16, "N": 256, "K": 128}, ("M", "N", "K"), False, 128),
    ("matmul", (None, 16, 64, 512), {"M": 16, "N": 64, "K": 64}, ("K", "M", "N"), True, 64),
    ("matmul_lmhead", (None, 24, 96, 320), {"M": 8, "N": 32, "K": 40}, ("N", "K", "M"), True, 40),
    ("matmul", (None, 8, 64, 96), {"M": 8, "N": 64, "K": 3}, ("M", "N", "K"), False, 3),
    ("matmul_silu_glu", (None, 16, 128, 1024), {"M": 16, "N": 128, "K": 64}, ("M", "N", "K"),
     False, 0),
    ("moe_gemm", (3, 8, 64, 512), {"M": 8, "N": 64, "K": 32, "E": 1}, ("E", "M", "N", "K"),
     False, 32),
]


@pytest.mark.parametrize("class_id,shape,tiles,order,cache_write,want_round_k", ROUND_CASES)
def test_plain_version_rounds_as_the_reference_does(class_id, shape, tiles, order, cache_write,
                                                    want_round_k):
    """With ``round_k_for(cs)`` the plain version repeats the Pallas kernel's
    accumulation (interpret mode): bit for bit on at least 99.9% of the
    elements, within one bf16 value everywhere (the two sum a K tile's f32
    products in other orders).  Covers a K tile of 16 at K = 4096, 128 at
    2048, K outermost with the scratch on, K tiles of 40 and 3 (not
    multiples of 16), a GLU class (always the scratch: no rounding) and the
    grouped class (per expert)."""
    e, m, n, k = shape
    x, w = _bf16_pair(m, n, k, seed=m + n + k, e=e)
    yp, cs = _pallas_bf16(x, w, class_id, tiles, order, cache_write, e=e)
    assert mm.round_k_for(cs) == want_round_k
    xb, wb = _t(x).bfloat16(), _t(w).bfloat16()
    if e is None:
        got = mm.matmul(xb, wb, cs, class_id=class_id)
        plain = ref.matmul(xb, wb, class_id, round_k=want_round_k)
    else:
        got = mm.grouped_matmul(xb, wb, cs, class_id=class_id)
        plain = ref.grouped_matmul(xb, wb, class_id, round_k=want_round_k)
    assert torch.equal(got, plain)   # the wrapper's CPU route passes round_k on
    ulps = _bf16_ulps(plain, yp.bfloat16())
    assert (ulps == 0).float().mean().item() >= 0.999
    assert ulps.max().item() <= 1


def test_schedule_key_carries_the_rounding_k_tile():
    """``cache_write`` changes the launch (the rounding K tile in the key)
    only where the reference would round: bf16, not GLU, more than one K
    tile."""
    def keys(class_id, dtype, k_tile, **params):
        inst = ops.instance(class_id, dtype, **params)
        tiles = {"M": 8, "N": 32, "K": k_tile, **({"E": 1} if "E" in params else {})}
        return [mm.schedule_key(concretize(Schedule.make(class_id, tiles, cache_write=cw), inst))
                for cw in (True, False)]

    on, off = keys("matmul", torch.bfloat16, 16, M=8, N=64, K=64)
    assert on == (8, 32, True, 0) and off == (8, 32, True, 16)
    on, off = keys("moe_gemm", torch.bfloat16, 16, M=16, N=64, K=64, E=2)
    assert on[3] == 0 and off[3] == 16
    for args in (("matmul", torch.float32, 16), ("matmul_silu_glu", torch.bfloat16, 16),
                 ("matmul", torch.bfloat16, 64)):   # f32; GLU; one K tile
        on, off = keys(*args, M=8, N=64, K=64)
        assert on == off and on[3] == 0


def test_rows_body_never_splits_k_in_rounding_mode():
    """The rows body chains the K tiles inside one CTA: no K split (and no
    workspace) in rounding mode, the plain split where the sums stay f32."""
    assert mm.rows_geometry(4, 3072, 3072, 4, 512)[1] > 1
    assert mm.rows_geometry(4, 3072, 3072, 4, 512, round_k=16)[1] == 1
    assert mm.launch_geometry(torch.bfloat16, 4, 3072, 3072, 4, 512, round_k=16)[3] == 1
