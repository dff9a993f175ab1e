"""Schedule-driven matmul with fused epilogues: the CUDA kernel's wrappers.

Replaces the Pallas kernel ``src/repro/kernels/matmul.py`` (``build_call`` →
``_kernel``) on both of its paths.  The CUDA source is ``csrc/matmul.cu``.

* :func:`matmul` (kernel K1, the reference's ``matmul()``):
  ``out = epilogue(x (M,K) @ w (K,N))`` for every non-grouped class of the
  matmul family: ``matmul``, ``matmul_bias``, ``matmul_lmhead``,
  ``moe_router`` (no epilogue), ``matmul_bias_gelu`` (tanh gelu),
  ``matmul_silu_glu`` / ``matmul_gelu_glu`` (interleaved GLU, emits N/2
  columns), ``matmul_residual`` and ``matmul_lmhead_softcap``.
* :func:`grouped_matmul` (kernel K1g, the reference's ``grouped_matmul()``,
  the MoE expert GEMM): ``out[e] = epilogue(x[e] (M,K) @ w[e] (K,N))`` for
  ``moe_gemm`` (no epilogue) and ``moe_gemm_silu_glu`` (interleaved GLU).
  The same kernel bodies under a second grid axis over the experts.

bf16 and f32.

How the :class:`~repro_torch.core.schedule.ConcreteSchedule` maps onto the
kernel:

* ``tiles["M"]``, ``tiles["N"]`` — the logical output tile: the unit of
  rasterisation and of edge masking.  How CTAs cover it depends on the body
  (:func:`launch_geometry`):

  - **rows** (M tile ≤ 16, bf16 or f32: decode, the 1-row prefill LM head):
    a CTA covers one 64-column strip of one logical tile, all its rows, over
    one K slice (:func:`rows_geometry`).  Where the strips of all experts
    launch fewer than two CTAs per SM, K is split across CTAs: each slice
    writes f32 partial sums to a workspace the wrapper allocates, and a
    second pass adds them in slice order and applies the epilogue once (no
    float atomics).  ``split_k`` depends on K, N, the N tile and the expert
    count, never on M, so a row's bits are the same at M = 1 and M = 4.
  - **fma** (f32 with an M tile above 16: the router): one CTA per logical
    tile, walking it in 64x64 blocks on the CUDA cores.
  - **mma** (bf16 with an M tile above 16: every prefill projection and
    expert GEMM): the tensor cores.  Each CTA runs a compiled tile from
    :data:`MMA_CTA_TILES`; a logical tile larger than it is covered by
    several CTAs, numbered consecutively (along N first) so they run
    together and share the tile's rows of ``x`` and columns of ``w`` in L2,
    and a smaller one by one CTA masked at the tile's edge.
    :func:`tiled_geometry` chooses the CTA tile: the largest that fits the
    logical tile and still launches :data:`SMS` CTAs (one per SM), where M
    and N allow.  A tuned 64x64 schedule still gets 64x64 CTAs, and the
    default 128x512 tile no longer caps a 256x3072 GEMM at 12 CTAs.

  f32 stays off the tensor cores: TF32 keeps about three decimal digits and
  the f32 tolerance is 2e-4.  That is the dtype rule, not a fallback.
* ``order`` — tile rasterisation: the logical tile index walks the inner of
  M and N fastest.
* ``tiles["K"]`` and ``cache_write`` — together they say where the
  reference rounds (:func:`round_k_for`).  With ``cache_write`` on and K the
  innermost grid axis (every default schedule), and for the GLU classes
  and f32, the reference sums each output tile in f32 scratch: the kernel
  sums the whole K range in f32 too, in stages of its own choosing (32
  deep on the tensor cores, 16 on the CUDA cores, K slices in the rows
  body), and the K tile reaches no launch.  Otherwise (``cache_write=False``,
  or K not innermost) the reference adds each K tile's f32 product to a
  sum held in the bf16 output block, rounding it to bf16 after every K tile
  but the last, and the kernel launches in **rounding mode** with that K
  tile (``round_k``): the rows body chains the tiles inside one CTA and
  never splits K, the mma body rounds its accumulator where a tile ends.
  Rounding mode is slower and is taken only where a schedule asks for it.
* ``parallel``, ``unroll``, ``vec`` — ignored (TPU compiler hints).
* grouped: the instance's ``M`` is ``m·E`` (rows over all experts, as in
  ``ops.moe_gemm``), but the tiles are clamped to one expert's extent
  (``min(tile, m)``, as the reference's ``bm = min(bm, m)``) and the grid
  covers one expert's ``m`` rows per expert; ``tiles["E"]`` is ignored (the
  reference's expert block is always 1).  A tile that does not divide ``m``
  is masked at the expert's own edge.

What bounds it on the card: the bytes of ``w`` at decode (M = slots) and
up to a few hundred rows (the H100 does ~295 bf16 tensor-core operations per
byte of HBM, so a (K,N) weight read once is the larger cost while M is below
~300); the operations above that.  The rows body streams ``w`` once per
4-row pass, 16 bytes a thread with eight loads in flight, on enough CTAs to
fill the card; the mma body stages ``x`` and ``w`` through a 4-deep
``cp.async`` ring into ``mma.sync`` tensor-core products.

A tensor on the CPU takes the plain version (:func:`repro_torch.kernels.ref.matmul`,
:func:`~repro_torch.kernels.ref.grouped_matmul`); a CUDA tensor launches the
kernel or raises.  ``launches`` and ``grouped_launches`` count launches per
kernel, ``body_launches`` per kernel, body and dtype.

Under autograd a CUDA tensor goes through :class:`MatmulFn`: the forward is
the same launch (the same bits as without a gradient); the backward is K1
again.  For ``y = epilogue(x·w)``: the epilogue's derivative is elementwise
torch in f32 (autograd of :func:`~repro_torch.kernels.ref.apply_epilogue`,
on the pre-activation recomputed by one more launch for the gelu and GLU
classes; the softcap's ``1 - tanh²`` from the output), then ``dX = dZ·wᵀ``
and ``dW = xᵀ·dZ`` are two launches of class ``matmul`` on contiguous
transposed operands (a tied head's ``wᵀ`` is the embedding itself), each
under the default schedule of its own instance, summed in f32 (never in
rounding mode), not through any provider.  ``grad_launches`` counts them.

The grouped kernel (K1g) goes through :class:`GroupedMatmulFn` alike: the
forward is :func:`grouped_launch`, and for ``y[e] = epilogue(x[e]·w[e])``
the GLU's derivative is elementwise torch in f32 on the pre-activation
recomputed by one grouped launch of class ``moe_gemm``; then ``dX[e] =
dZ[e]·w[e]ᵀ`` and ``dW[e] = x[e]ᵀ·dZ[e]`` are two grouped launches of class
``moe_gemm`` on contiguous transposed operands, each under the default
schedule of its own instance (:func:`grouped_grad_schedule`).
``grouped_grad_launches`` counts them.  The plain version of this backward
is :func:`repro_torch.kernels.ref.grouped_matmul_bwd`.
"""
from __future__ import annotations

import collections
import functools

import torch

from repro_torch.core.schedule import GLU_CLASSES, ConcreteSchedule, concretize, default_schedule
from repro_torch.core.workload import KernelInstance
from repro_torch.kernels import _build, ref

#: class_id -> epilogue code of csrc/matmul.cu
EPILOGUE = {"matmul": 0, "matmul_bias": 0, "matmul_lmhead": 0, "moe_router": 0,
            "matmul_bias_gelu": 1, "matmul_silu_glu": 2, "matmul_gelu_glu": 3,
            "matmul_residual": 4, "matmul_lmhead_softcap": 5}
#: grouped class_id -> epilogue code of csrc/matmul.cu
GROUPED_EPILOGUE = {"moe_gemm": 0, "moe_gemm_silu_glu": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the mma body's compiled CTA tiles (M, N), largest first (csrc/matmul.cu)
MMA_CTA_TILES = ((128, 128), (64, 128), (64, 64))
#: streaming multiprocessors of the H100: the CTA count that fills the card once
SMS = 132
#: the rows body's CTA strip: columns of one CTA (csrc/matmul.cu kRowsCtaN)
ROWS_CTA_N = 64
#: the rows body splits K until its CTAs reach this many (two per SM), where
#: the strips alone launch fewer
ROWS_MIN_CTAS = 2 * SMS
#: ... but no K slice shorter than this
ROWS_MIN_SLICE = 256
#: K slices are whole multiples of this (csrc/matmul.cu kRowsSliceAlign)
ROWS_SLICE_ALIGN = 32

#: kernel launches since the last reset (plain counts; see chip_smoke.py):
#: ``launches`` of :func:`launch` (K1), ``grouped_launches`` of
#: :func:`grouped_launch` (K1g), ``body_launches`` of both by
#: (kernel, body, dtype): kernel ``"matmul"`` or ``"grouped_matmul"``, body
#: ``"rows"``, ``"mma"`` or ``"fma"`` (:func:`body_for`),
#: ``round_launches`` of both in rounding mode by (kernel, body), and
#: ``row_tile_launches`` of K1 with 1-row M tiles over M > 1 rows (a prime
#: M's default)
launches = 0
grouped_launches = 0
row_tile_launches = 0
body_launches: collections.Counter = collections.Counter()
round_launches: collections.Counter = collections.Counter()
#: K1 launches of :class:`MatmulFn`'s backward (also counted in ``launches``)
grad_launches = 0
#: K1g launches of :class:`GroupedMatmulFn`'s backward (also counted in
#: ``grouped_launches``)
grouped_grad_launches = 0


def reset_launches() -> None:
    """Set every count to 0."""
    global launches, grouped_launches, row_tile_launches, grad_launches, grouped_grad_launches
    launches = grouped_launches = row_tile_launches = grad_launches = grouped_grad_launches = 0
    body_launches.clear()
    round_launches.clear()


def body_count(body: str | None = None, *, kernel: str | None = None,
               dtype: torch.dtype | None = None) -> int:
    """Launches since the last reset of ``body`` (any if None), of one kernel
    and one dtype where given."""
    return sum(c for (k, b, d), c in body_launches.items()
               if body in (None, b) and kernel in (None, k) and dtype in (None, d))


def body_for(dtype: torch.dtype, tile_m: int) -> str:
    """The kernel body a launch takes: ``rows`` for an M tile of at most 16
    rows, else ``mma`` (tensor cores) for bf16 and ``fma`` (CUDA cores) for
    f32."""
    if tile_m <= 16:
        return "rows"
    return "mma" if dtype == torch.bfloat16 else "fma"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_k_for(cs: ConcreteSchedule) -> int:
    """The K tile after which the reference rounds partial sums to the
    output dtype under ``cs``, or 0 where it sums in f32 throughout.

    The reference (``build_call`` and ``_kernel`` of
    ``src/repro/kernels/matmul.py``) keeps an f32 scratch accumulator when
    ``cache_write`` is on and K is the innermost of its M, N, K grid axes,
    and always for the GLU classes; otherwise, with more than one K trip, it
    accumulates in the output block: ``o = bf16(p_0)``, ``o = bf16(o +
    p_j)``, ``out = epilogue(o + p_last)``, ``p_j`` the f32 product of K tile
    ``j``.  For f32 outputs that rounding is the identity, so only bf16
    rounds.  The grouped classes follow the same rule per expert."""
    inst = cs.instance
    if inst.dtype != "bfloat16" or inst.class_id in GLU_CLASSES:
        return 0
    order = [a for a in cs.order if a in ("M", "N", "K")]
    if cs.schedule.cache_write and order[-1] == "K":
        return 0
    k = inst.p["K"]
    tile_k = min(cs.t["K"], k)
    return tile_k if _cdiv(k, tile_k) > 1 else 0


def schedule_key(cs: ConcreteSchedule) -> tuple[int, int, bool, int]:
    """What a launch reads of a concrete schedule: (M tile, N tile, M outer,
    rounding K tile), the tiles per expert for the grouped classes (clamped
    to one expert's ``M / E`` rows and to N), the rounding K tile from
    :func:`round_k_for` (0 where the sums stay f32).  Schedules with one key
    launch the same kernel in the same layout: the E tile, ``parallel``,
    ``unroll`` and ``vec`` reach no launch, and the K tile and
    ``cache_write`` reach it only where they make it round."""
    tile_m, tile_n = cs.t["M"], cs.t["N"]
    p = cs.instance.p
    if cs.instance.class_id in GROUPED_EPILOGUE:
        tile_m, tile_n = min(tile_m, p["M"] // p["E"]), min(tile_n, p["N"])
    order = [a for a in cs.order if a in ("M", "N")]
    return tile_m, tile_n, order[0] == "M", round_k_for(cs)


def tiled_geometry(m: int, n: int, tile_m: int, tile_n: int,
                   groups: int = 1) -> tuple[int, int, int]:
    """(cta_m, cta_n, ctas) of the mma body for an (m, n) output under
    (tile_m, tile_n) logical tiles; grouped, per expert, with ``groups``
    experts side by side on the card.

    Each logical tile gets ceil(min(tile, extent) / cta) CTAs along each
    axis; a ragged edge tile may leave some of them empty (they return at
    once).  The CTA tile is the largest of :data:`MMA_CTA_TILES` that fits
    the logical tile (rounded up to 64) and launches at least :data:`SMS`
    CTAs over all experts; where none does, the one that launches the most."""
    tm, tn = min(tile_m, m), min(tile_n, n)

    def ctas(cta: tuple[int, int]) -> int:
        return cta_count(m, n, tile_m, tile_n, *cta)

    fits = [c for c in MMA_CTA_TILES if c[0] <= 64 * _cdiv(tm, 64) and c[1] <= 64 * _cdiv(tn, 64)]
    cta = next((c for c in fits if groups * ctas(c) >= SMS), max(fits, key=ctas))
    return (*cta, ctas(cta))


def cta_count(m: int, n: int, tile_m: int, tile_n: int, cta_m: int, cta_n: int) -> int:
    """CTAs that cover an (m, n) output under (tile_m, tile_n) logical tiles
    with (cta_m, cta_n) CTA tiles: per logical tile, ceil(min(tile, extent) /
    cta) along each axis (the kernel's gridDim.x, per expert)."""
    return (_cdiv(m, tile_m) * _cdiv(n, tile_n)
            * _cdiv(min(tile_m, m), cta_m) * _cdiv(min(tile_n, n), cta_n))


def rows_k_slice(k: int, split_k: int) -> int:
    """K rows of one slice when the rows body splits K into ``split_k``
    slices (the last may be shorter): a multiple of :data:`ROWS_SLICE_ALIGN`."""
    return ROWS_SLICE_ALIGN * _cdiv(_cdiv(k, split_k), ROWS_SLICE_ALIGN)


def rows_geometry(m: int, n: int, k: int, tile_m: int, tile_n: int,
                  groups: int = 1, round_k: int = 0) -> tuple[int, int, int]:
    """(cta_n, split_k, ctas) of the rows body for an (m, n) output with
    depth k under (tile_m, tile_n) logical tiles; grouped, per expert, with
    ``groups`` experts side by side on the card.

    A CTA covers one :data:`ROWS_CTA_N`-column strip of one logical tile
    (all of its <= 16 rows) over one K slice, and never crosses the logical
    tile's edge.  Where the strips of all experts launch fewer than
    :data:`ROWS_MIN_CTAS`, K is split into ``split_k`` slices of at least
    :data:`ROWS_MIN_SLICE` rows, summed in slice order by a second pass.
    ``split_k`` depends on k, n, tile_n and groups only, never on m, so a
    row's summation order (and its bits) is the same at M = 1 and M = 4.
    In rounding mode (``round_k`` > 0) K is never split: one CTA chains the
    K tiles in order."""
    strips = _cdiv(n, tile_n) * _cdiv(min(tile_n, n), ROWS_CTA_N)
    split_k = 1
    if groups * strips < ROWS_MIN_CTAS and not round_k:
        split_k = max(1, min(_cdiv(ROWS_MIN_CTAS, groups * strips), k // ROWS_MIN_SLICE))
        split_k = _cdiv(k, rows_k_slice(k, split_k))   # no empty slice
    return ROWS_CTA_N, split_k, _cdiv(m, tile_m) * strips * split_k


def launch_geometry(dtype: torch.dtype, m: int, n: int, k: int, tile_m: int, tile_n: int,
                    groups: int = 1, round_k: int = 0) -> tuple[str, int, int, int, int]:
    """(body, cta_m, cta_n, split_k, ctas) of a launch, CTAs per expert: the
    rows body's strips and K slices from :func:`rows_geometry`, the mma
    body's CTA tiles from :func:`tiled_geometry`, one CTA per logical tile
    in the fma body.  The kernel re-checks it and refuses a mismatch."""
    body = body_for(dtype, tile_m)
    if body == "rows":
        cta_n, split_k, ctas = rows_geometry(m, n, k, tile_m, tile_n, groups, round_k)
        return body, tile_m, cta_n, split_k, ctas
    if body == "mma":
        cta_m, cta_n, ctas = tiled_geometry(m, n, tile_m, tile_n, groups)
        return body, cta_m, cta_n, 1, ctas
    return body, tile_m, tile_n, 1, cta_count(m, n, tile_m, tile_n, tile_m, tile_n)


def _workspace(x: torch.Tensor, groups: int, split_k: int, m: int, n: int) -> torch.Tensor | None:
    """The rows body's f32 partial sums (groups, split_k, m, n) when it splits K."""
    if split_k == 1:
        return None
    return torch.empty((groups, split_k, m, n), dtype=torch.float32, device=x.device)


def matmul(x: torch.Tensor, w: torch.Tensor, cs: ConcreteSchedule, *,
           class_id: str = "matmul", bias: torch.Tensor | None = None,
           residual: torch.Tensor | None = None, softcap: float = 0.0) -> torch.Tensor:
    """x (M,K) @ w (K,N) with the class's fused epilogue -> (M, N or N/2)."""
    if x.device.type == "cpu":
        return ref.matmul(x, w, class_id, bias=bias, residual=residual, softcap=softcap,
                          round_k=round_k_for(cs))
    return launch(x, w, cs, class_id=class_id, bias=bias, residual=residual, softcap=softcap)


def launch(x: torch.Tensor, w: torch.Tensor, cs: ConcreteSchedule, *,
           class_id: str = "matmul", bias: torch.Tensor | None = None,
           residual: torch.Tensor | None = None, softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    global launches, row_tile_launches
    if not x.is_cuda:
        raise ValueError(f"the matmul kernel runs on a CUDA tensor, got {x.device}")
    if class_id not in EPILOGUE:
        raise ValueError(f"matmul kernel has no class {class_id!r}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"matmul kernel takes bf16 or f32 x and w of one dtype, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul kernel takes x (M,K) and w (K,N), got {tuple(x.shape)}, {tuple(w.shape)}")
    if w.device != x.device or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul kernel takes contiguous x and w on one device")
    m, k = x.shape
    n = w.shape[1]
    if (cs.instance.class_id, cs.instance.p["M"], cs.instance.p["N"], cs.instance.p["K"]) != (class_id, m, n, k):
        raise ValueError(f"schedule for {cs.instance} does not fit {class_id} ({m},{k})x({k},{n})")
    glu = class_id in GLU_CLASSES
    tile_m, tile_n, m_outer, round_k = schedule_key(cs)
    if glu and (n % 2 or tile_n % 2):
        raise ValueError(f"GLU epilogue needs even N and N tile, got {n}, {tile_n}")
    n_out = n // 2 if glu else n
    if class_id == "matmul_residual":
        if residual is None or tuple(residual.shape) != (m, n_out):
            raise ValueError(f"matmul_residual needs a residual of shape {(m, n_out)}")
    elif residual is not None:
        raise ValueError(f"{class_id} takes no residual")
    if class_id == "matmul_lmhead_softcap" and softcap <= 0:
        raise ValueError("matmul_lmhead_softcap needs softcap > 0")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must have shape {(n,)}, got {tuple(bias.shape)}")
    # the reference reads bias and residual into f32 before adding them
    bias32 = bias.to(device=x.device, dtype=torch.float32).contiguous() if bias is not None else None
    res32 = residual.to(device=x.device, dtype=torch.float32).contiguous() if residual is not None else None
    out = torch.empty((m, n_out), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    body, cta_m, cta_n, split_k, ctas = launch_geometry(x.dtype, m, n, k, tile_m, tile_n,
                                                        round_k=round_k)
    ws = _workspace(x, 1, split_k, m, n)
    lib = _build.library()
    rc = lib.repro_matmul(
        x.data_ptr(), w.data_ptr(),
        bias32.data_ptr() if bias32 is not None else None,
        res32.data_ptr() if res32 is not None else None,
        out.data_ptr(), m, n, k, DTYPES[x.dtype], EPILOGUE[class_id], float(softcap),
        tile_m, tile_n, int(m_outer), cta_m, cta_n, ctas, split_k, round_k,
        ws.data_ptr() if ws is not None else None, _build.stream_handle(x.device))
    _build.check(rc, "matmul kernel")
    launches += 1
    row_tile_launches += tile_m == 1 < m
    body_launches["matmul", body, x.dtype] += 1
    if round_k:
        round_launches["matmul", body] += 1
    return out


def _grad_cs(class_id: str, dtype: torch.dtype, **params: int) -> ConcreteSchedule:
    """The default schedule of a backward launch's own instance: f32 sums
    throughout (a default schedule never rounds; checked)."""
    inst = KernelInstance(class_id=class_id, dtype=str(dtype).removeprefix("torch."),
                          params=tuple(sorted(params.items())))
    cs = concretize(default_schedule(inst), inst)
    if round_k_for(cs):
        raise AssertionError(f"the default schedule of {inst} rounds partial sums")
    return cs


@functools.lru_cache(maxsize=1024)
def grad_schedule(class_id: str, dtype: torch.dtype, m: int, n: int, k: int) -> ConcreteSchedule:
    """The default schedule of a K1 backward launch's own instance (f32 sums)."""
    return _grad_cs(class_id, dtype, M=m, N=n, K=k)


@functools.lru_cache(maxsize=1024)
def grouped_grad_schedule(class_id: str, dtype: torch.dtype, e: int, m: int, n: int,
                          k: int) -> ConcreteSchedule:
    """The default schedule of a K1g backward launch's own instance, ``m``
    rows per expert (the instance's M is m·E, as ``ops.moe_gemm`` keys it;
    f32 sums)."""
    return _grad_cs(class_id, dtype, M=m * e, N=n, K=k, E=e)


def grad_launch(a: torch.Tensor, b: torch.Tensor, class_id: str = "matmul",
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """a (M,K) @ b (K,N) by K1 for a gradient, under its default schedule."""
    global grad_launches
    cs = grad_schedule(class_id, a.dtype, a.shape[0], b.shape[1], a.shape[1])
    out = launch(a, b, cs, class_id=class_id, bias=bias)
    grad_launches += 1
    return out


def epilogue_grad(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                  class_id: str, bias: torch.Tensor | None, softcap: float) -> torch.Tensor:
    """dL/dZ (f32) of ``y = epilogue(Z)`` (``Z = x·w``, plus ``bias``) at ``dy``."""
    dyf = dy.float()
    if class_id == "matmul_lmhead_softcap":
        t = y.float() / softcap                     # tanh(z / c)
        return dyf * (1.0 - t * t)
    if class_id in ("matmul_bias_gelu", "matmul_silu_glu", "matmul_gelu_glu"):
        z = grad_launch(x, w, "matmul" if bias is None else "matmul_bias", bias=bias)
        with torch.enable_grad():
            zf = z.float().requires_grad_()
            return torch.autograd.grad(ref.apply_epilogue(zf, class_id), zf, dyf)[0]
    return dyf                                      # no activation: bias, residual, head


class MatmulFn(torch.autograd.Function):
    """K1 under autograd on CUDA tensors: ``launch`` forward, K1 backward.

    ``transpose_of`` (or None): the (N, K) tensor that ``w`` is a contiguous
    transposed copy of (a tied LM head's ``embed``).  Its gradient is
    returned in place of ``w``'s, and it is ``dX``'s operand as it is."""

    @staticmethod
    def forward(ctx, x, w, transpose_of, bias, residual, cs, class_id, softcap):
        y = launch(x, w, cs, class_id=class_id, bias=bias, residual=residual, softcap=softcap)
        ctx.class_id, ctx.softcap = class_id, softcap
        ctx.res_dtype = residual.dtype if residual is not None else None
        ctx.save_for_backward(x, w, transpose_of, bias,
                              y if class_id == "matmul_lmhead_softcap" else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, w_src, bias, y = ctx.saved_tensors
        need_x, need_w, need_src, need_bias, need_res = ctx.needs_input_grad[:5]
        dzf = epilogue_grad(x, w, y, dy, ctx.class_id, bias, ctx.softcap)
        dz = dzf.to(x.dtype)
        dx = dw = dsrc = db = dres = None
        if need_x:
            dx = grad_launch(dz, w_src if w_src is not None else w.T.contiguous())
        if need_w:
            dw = grad_launch(x.T.contiguous(), dz)
        if need_src:
            dsrc = grad_launch(dz.T.contiguous(), x)
        if need_bias:
            db = dzf.sum(0).to(bias.dtype)
        if need_res:
            dres = dy.to(ctx.res_dtype)
        return dx, dw, dsrc, db, dres, None, None, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, cs: ConcreteSchedule, *,
                   class_id: str = "moe_gemm") -> torch.Tensor:
    """x (E,M,K) @ w (E,K,N) per expert with the class's epilogue -> (E, M, N or N/2)."""
    if x.device.type == "cpu":
        return ref.grouped_matmul(x, w, class_id, round_k=round_k_for(cs))
    return grouped_launch(x, w, cs, class_id=class_id)


def grouped_geometry(x: torch.Tensor, w: torch.Tensor, cs: ConcreteSchedule,
                     class_id: str) -> tuple[int, int, int, int, int, int]:
    """(E, m, N, K, tile_m, tile_n) of a grouped launch, per expert; raises on
    what the kernel does not take (any device: the CPU tests reach it)."""
    if class_id not in GROUPED_EPILOGUE:
        raise ValueError(f"grouped matmul kernel has no class {class_id!r}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"grouped matmul kernel takes bf16 or f32 x and w of one dtype, "
                         f"got {x.dtype}, {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped matmul kernel takes x (E,M,K) and w (E,K,N), "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    if w.device != x.device or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped matmul kernel takes contiguous x and w on one device")
    e, m, k = x.shape
    n = w.shape[2]
    p = cs.instance.p
    if (cs.instance.class_id, p["M"], p["N"], p["K"], p["E"]) != (class_id, m * e, n, k, e):
        raise ValueError(f"schedule for {cs.instance} does not fit {class_id} "
                         f"{e}x({m},{k})x({k},{n}) (M = m·E)")
    # per-expert tiles: the schedule's M tile divides m·E, not necessarily m
    tile_m, tile_n, *_ = schedule_key(cs)
    if class_id in GLU_CLASSES and (n % 2 or tile_n % 2):
        raise ValueError(f"GLU epilogue needs even N and N tile, got {n}, {tile_n}")
    return e, m, n, k, tile_m, tile_n


def grouped_launch(x: torch.Tensor, w: torch.Tensor, cs: ConcreteSchedule, *,
                   class_id: str = "moe_gemm") -> torch.Tensor:
    """Launch the CUDA kernel over every expert; raises on anything it does not take."""
    global grouped_launches
    if not x.is_cuda:
        raise ValueError(f"the grouped matmul kernel runs on a CUDA tensor, got {x.device}")
    e, m, n, k, tile_m, tile_n = grouped_geometry(x, w, cs, class_id)
    out = torch.empty((e, m, n // 2 if class_id in GLU_CLASSES else n), dtype=x.dtype,
                      device=x.device)
    if m == 0 or e == 0:
        return out
    _, _, m_outer, round_k = schedule_key(cs)
    body, cta_m, cta_n, split_k, ctas = launch_geometry(x.dtype, m, n, k, tile_m, tile_n, e,
                                                        round_k)
    ws = _workspace(x, e, split_k, m, n)
    rc = _build.library().repro_grouped_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, m, n, k, DTYPES[x.dtype],
        GROUPED_EPILOGUE[class_id], tile_m, tile_n, int(m_outer), cta_m, cta_n, ctas,
        split_k, round_k, ws.data_ptr() if ws is not None else None,
        _build.stream_handle(x.device))
    _build.check(rc, "grouped matmul kernel")
    grouped_launches += 1
    body_launches["grouped_matmul", body, x.dtype] += 1
    if round_k:
        round_launches["grouped_matmul", body] += 1
    return out


def grouped_grad_launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (E,M,K) @ b (E,K,N) by K1g (class ``moe_gemm``) for a gradient, under
    its default schedule."""
    global grouped_grad_launches
    e, m, k = a.shape
    cs = grouped_grad_schedule("moe_gemm", a.dtype, e, m, b.shape[2], k)
    out = grouped_launch(a, b, cs, class_id="moe_gemm")
    grouped_grad_launches += 1
    return out


class GroupedMatmulFn(torch.autograd.Function):
    """K1g under autograd on CUDA tensors: :func:`grouped_launch` forward,
    K1g backward."""

    @staticmethod
    def forward(ctx, x, w, cs, class_id):
        ctx.class_id = class_id
        ctx.save_for_backward(x, w)
        return grouped_launch(x, w, cs, class_id=class_id)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        dz = dy.contiguous()
        if ctx.class_id in GLU_CLASSES:
            z = grouped_grad_launch(x, w)              # the pre-activation, recomputed
            with torch.enable_grad():
                zf = z.float().requires_grad_()
                dz = torch.autograd.grad(ref.apply_epilogue(zf, ctx.class_id), zf,
                                         dy.float())[0].to(x.dtype)
        dx = grouped_grad_launch(dz, w.transpose(1, 2).contiguous()) if need_x else None
        dw = grouped_grad_launch(x.transpose(1, 2).contiguous(), dz) if need_w else None
        return dx, dw, None, None
