"""Schedule-driven matmul with fused epilogues: the CUDA kernel's wrappers.

Replaces the Pallas kernel ``src/repro/kernels/matmul.py`` (``build_call`` →
``_kernel``) on both of its paths.  The CUDA sources are ``csrc/matmul.cu``
(with ``csrc/matmul_shift.cu``) and ``csrc/matmul_wgmma.cu``.

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
  (:func:`launch_geometry`).  Where the logical N tile is narrower than both
  N and a CTA's columns (internvl2-26b's LM head: a vocab of 92553 = 3 ×
  30851 gives an N tile of 3), one CTA covers a *group* of ⌊CTA columns /
  N tile⌋ consecutive logical tiles along N (:func:`n_group`), each masked
  at its own edge and the group at N's; groups are rasterised in the
  schedule's order as the tiles are, and a GLU's even N tile keeps each
  gate/up pair in one thread.  A tile at least as wide as the CTA, or all
  of N (the routers'), is its own group, placed as before.  The schedule
  and its key do not change; one formula (:func:`cta_count`) sizes every
  grid and the kernel re-checks it.

  - **rows** (M tile ≤ 16, bf16 or f32: decode, verify, the 1-row prefill
    LM head, a prime prompt length's 1-row tiles): a CTA covers one
    64-column strip of one group of N tiles over the rows of one group of M
    tiles (:func:`m_group`: where the M tile is narrower than both M and
    :data:`ROWS_CTA_M`, ⌊16 / M tile⌋ consecutive tiles, masked at the
    group's edge and M's), over one K slice (:func:`rows_geometry`).  A
    thread carries the sums of all of its CTA's rows in one pass (x in
    registers up to 4 rows, staged in shared memory above), so each vector
    of ``w`` it loads serves all of them.  Where the strips of all
    experts launch fewer than two CTAs per SM, K is split across CTAs: each
    slice writes f32 partial sums to a workspace the wrapper allocates, and
    a second pass adds them in slice order and applies the epilogue once (no
    float atomics).  ``split_k`` depends on K, N, the N tile and the expert
    count, never on M, so a row's bits are the same at M = 1 and M = 4.
  - **fma** (f32 with an M tile above 16: the router): one CTA per logical
    tile, walking it in 64x64 blocks on the CUDA cores (its CTA is the
    logical tile, so no group forms; no f32 launch on any path has an N
    tile narrower than its N).
  - **wgmma** (bf16 with an M tile above 16, no rounding mode, ``x`` and
    ``w`` readable by TMA (:func:`tma_layout`: bases, rows and experts on 16
    bytes, and along ``w``'s N every CTA's first column): every prefill
    projection and expert GEMM, and every forward product of training, at
    an aligned N): Hopper's warpgroup products from a TMA-filled mbarrier
    ring (``csrc/matmul_wgmma.cu``), on the CTA tiles of
    :data:`WGMMA_CTA_TILES`.
  - **mma** (the other bf16 launches with an M tile above 16: rounding
    mode, rows of ``w`` off 16 bytes (whisper-medium's and internvl2-26b's
    LM heads), rows of ``x`` off 16 bytes): ``mma.sync`` on the tensor
    cores, on the CTA tiles of :data:`MMA_CTA_TILES`.

    In both tensor-core bodies a logical tile (or group) larger than the
    CTA tile is covered by several CTAs, numbered consecutively (along N
    first) so they run together and share the tile's rows of ``x`` and
    columns of ``w`` in L2, and a smaller one by one CTA masked at the
    tile's edge.  :func:`tiled_geometry` chooses the CTA tile: the largest
    that fits the logical tile, or the group it would cover, and still
    launches :data:`SMS` CTAs (one per SM), where M and N allow.  The body
    is a rule (:func:`body_for`), not a fallback: it reads the weight, K, N
    and the schedule, never M, so a paged engine's 64-row chunk and the
    slot engine's one-shot prefill reach the same body for one weight.

  Rows of ``w`` that do not start on 16 bytes (an odd N) are read as the
  aligned 16-byte vectors that span a CTA's columns and shifted into place
  (in registers in the rows body; in shared memory, behind the mma body's
  ``cp.async`` ring), never element by element; the wgmma body takes none
  of them.

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
CTA of up to 16 rows, 16 bytes a thread with eight loads in flight, on
enough CTAs to fill the card; the wgmma body keeps a producer warp's TMA
loads of ``x`` and ``w`` in flight in a ring of 64-deep stages under
consumer warpgroups' ``wgmma`` products; the mma body stages them through a
4-deep ``cp.async`` ring into ``mma.sync`` products.

A tensor on the CPU takes the plain version (:func:`repro_torch.kernels.ref.matmul`,
:func:`~repro_torch.kernels.ref.grouped_matmul`); a CUDA tensor launches the
kernel or raises.  ``launches`` and ``grouped_launches`` count launches per
kernel, ``body_launches`` per kernel, body and dtype.

Under autograd a tensor goes through :class:`MatmulFn`: the forward is the
same launch, the same bits as without a gradient (a CPU tensor takes the
plain version).  For ``y = epilogue(x·w)``: the epilogue's derivative is
elementwise torch in f32 (autograd of
:func:`~repro_torch.kernels.ref.apply_epilogue`, on the pre-activation Z
for the gelu and GLU classes; the softcap's ``1 - tanh²`` from the output),
then ``dX = dZ·wᵀ``
and ``dW = xᵀ·dZ`` (a tied head's ``dE = dZᵀ·x``) are two gradient launches
(:func:`grad_launch`, ``csrc/matmul_grad.cu``) that read ``wᵀ``, ``xᵀ`` and
``dZᵀ`` where they lie, as views, each under the default schedule of its
own instance, summed in f32 (never in rounding mode), not through any
provider.  :func:`grad_geometry` reads each operand's layout from its
strides and picks the body: ``wgmma`` (bf16 operands whose base, row stride
and expert stride are multiples of 16 bytes: TMA and Hopper's warpgroup
products), ``mma`` (other bf16: the forward's tensor-core body with operand
modes) or ``fma`` (f32), a rule by dtype and alignment.  ``grad_launches``
counts the launches, ``grad_body_launches`` per body.

Z comes from one of two places.  Under the ``full`` remat policy one more
gradient launch recomputes it in the backward.  Inside a layer that the
``dots`` policy remats (:func:`saving_dots`), K1's forward is one dispatcher
op, ``torch.ops.repro_torch.matmul`` (:func:`matmul_op`), whose outputs the
policy saves (``torch.utils.checkpoint``'s selective checkpointing), so the
recompute takes them from the forward instead of launching it again; and
for the gelu and GLU classes (:data:`Z_CLASSES`) the launch also writes Z
beside Y (``with_z``: the same f32 sums, rounded once; Y's bits unchanged),
which the backward reads in place of the recomputing launch.

The grouped kernel (K1g) goes through :class:`GroupedMatmulFn` alike: the
forward is :func:`grouped_launch`, and for ``y[e] = epilogue(x[e]·w[e])``
the GLU's derivative is elementwise torch in f32 on the pre-activation
recomputed by one grouped gradient launch; then ``dX[e] = dZ[e]·w[e]ᵀ`` and
``dW[e] = x[e]ᵀ·dZ[e]`` are two grouped gradient launches on
``.transpose(1, 2)`` views, the expert on the grid's y axis, each under the
default schedule of its own instance (:func:`grouped_grad_schedule`).
``grouped_grad_launches`` counts them.  The plain version of this backward
is :func:`repro_torch.kernels.ref.grouped_matmul_bwd`; of one gradient
launch, :func:`~repro_torch.kernels.ref.matmul` (or ``grouped_matmul``) on
the same views, which a CPU tensor takes.

f32 partial sums (tensor parallelism over ``model`` in bf16).  A
row-parallel product (``wo``, ``w_out``, ``cv``, an expert's ``w_out`` cut
along d_ff) gives each rank partial sums that the ranks add before any
rounding, as the reference's f32 dot is summed before its cast: with
``out_f32`` K1 and K1g write Y in f32 (the same sums, unrounded; counted in
``f32_launches``).  A column-parallel product's input gradient is likewise
a partial sum: where ``x`` is an f32 *carrier* of bf16 values
(``distributed.context``: the gathered residual stream under autograd)
beside a bf16 ``w``, the forward launches on ``x``'s bf16 values and the
backward's ``dX`` launch writes f32 (``grad_launch(..., out_f32=True)``,
counted in ``f32_grad_launches``), the gradient the carrier takes.  A
weight whose gradient the ranks sum from partial products may be such a
carrier too (``w.bf16_carrier``: ``collectives.widens_grad``), and takes
``dW`` in f32 alike.  A launch without either keeps its bits.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading

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
#: the wgmma body's compiled CTA tiles (M, N), largest first
#: (csrc/matmul_wgmma.cu): the mma body's, 128 rows on two consumer
#: warpgroups, 64 on one, two CTAs an SM (a 128x256 tile, one CTA an SM,
#: was slower on the card at every main-path shape and is not compiled)
WGMMA_CTA_TILES = MMA_CTA_TILES
#: each tensor-core body's compiled CTA tiles
CTA_TILES = {"wgmma": WGMMA_CTA_TILES, "mma": MMA_CTA_TILES}
#: the forward's bodies and their codes in csrc/matmul.cu
BODIES = {"rows": 0, "mma": 1, "fma": 2, "wgmma": 3}
#: streaming multiprocessors of the H100: the CTA count that fills the card once
SMS = 132
#: the rows body's CTA strip: columns of one CTA (csrc/matmul.cu kRowsCtaN)
ROWS_CTA_N = 64
#: rows of one rows-body CTA at most, a group of narrow M tiles
#: (csrc/matmul.cu kRowsCtaM)
ROWS_CTA_M = 16
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
#: ``"rows"``, ``"wgmma"``, ``"mma"`` or ``"fma"`` (:func:`body_for`),
#: ``round_launches`` of both in rounding mode by (kernel, body),
#: ``row_tile_launches`` of K1 with 1-row M tiles over M > 1 rows (a prime
#: M's default); of K1 and K1g rows launches by M tile,
#: ``grouped_tile_launches`` those whose CTAs cover more than one logical M
#: tile (:func:`m_group`) and ``narrow_tile_launches`` those with an M tile
#: of at most 8 rows over more rows than one tile (each must be grouped)
launches = 0
grouped_launches = 0
row_tile_launches = 0
grouped_tile_launches: collections.Counter = collections.Counter()
narrow_tile_launches: collections.Counter = collections.Counter()
body_launches: collections.Counter = collections.Counter()
round_launches: collections.Counter = collections.Counter()
#: gradient launches of :class:`MatmulFn`'s backward (also counted in
#: ``launches`` and, by body, in ``body_launches``)
grad_launches = 0
#: K1 launches that wrote Z beside Y (``with_z``; also counted in ``launches``)
z_launches = 0
#: gradient launches of :class:`GroupedMatmulFn`'s backward (also counted in
#: ``grouped_launches``)
grouped_grad_launches = 0
#: both, by (kernel, body, dtype): body ``"wgmma"``, ``"mma"`` (operand
#: modes) or ``"fma"`` (:func:`grad_geometry`)
grad_body_launches: collections.Counter = collections.Counter()
#: K1 and K1g forward launches on the mma body by (kernel, reason): the rule
#: (:func:`body_for`) sends a bf16 launch with an M tile above 16 there only
#: for ``"round"`` (rounding mode), ``"w_off16"`` (w's rows, or a CTA's first
#: column, off 16 bytes: the shifted read) or ``"x_off16"`` (x's rows or
#: base off 16 bytes); every other such launch runs ``wgmma``
mma_launches: collections.Counter = collections.Counter()
#: K1 and K1g forward launches of bf16 operands that wrote Y in f32
#: (``out_f32``), and gradient launches of bf16 operands that wrote f32
#: (also counted in the counts above)
f32_launches = 0
f32_grad_launches = 0


def reset_launches() -> None:
    """Set every count to 0."""
    global launches, grouped_launches, row_tile_launches, grad_launches, grouped_grad_launches
    global z_launches, f32_launches, f32_grad_launches
    launches = grouped_launches = row_tile_launches = grad_launches = grouped_grad_launches = 0
    z_launches = f32_launches = f32_grad_launches = 0
    body_launches.clear()
    round_launches.clear()
    mma_launches.clear()
    grad_body_launches.clear()
    grouped_tile_launches.clear()
    narrow_tile_launches.clear()


def body_count(body: str | None = None, *, kernel: str | None = None,
               dtype: torch.dtype | None = None) -> int:
    """Launches since the last reset of ``body`` (any if None), of one kernel
    and one dtype where given."""
    return sum(c for (k, b, d), c in body_launches.items()
               if body in (None, b) and kernel in (None, k) and dtype in (None, d))


def tma_layout(n: int, k: int, tile_n: int) -> bool:
    """Whether TMA can read x (M,K) and w (K,N) of a launch whose bases lie
    on 16 bytes: rows of K and N values (and so every expert's slice) start
    on 16 bytes, and along w's N so does every CTA's first column (a logical
    N tile, or all of N, of whole 8s: the groups of narrow tiles and the
    CTAs inside a tile start on multiples of it).  The kernel checks the
    same (csrc/matmul.cu body_rule)."""
    return k % 8 == 0 and n % 8 == 0 and min(tile_n, n) % 8 == 0


def body_for(dtype: torch.dtype, tile_m: int, tma: bool, round_k: int = 0) -> str:
    """The kernel body a launch takes, a rule: ``rows`` for an M tile of at
    most 16 rows, ``fma`` (CUDA cores) for f32; for bf16, ``wgmma`` where
    ``tma`` (:func:`tma_layout`, bases on 16 bytes) and no K tile rounds
    (``round_k``), else ``mma`` (``mma.sync``: rounding mode, rows of w or
    x off 16 bytes)."""
    if tile_m <= 16:
        return "rows"
    if dtype != torch.bfloat16:
        return "fma"
    return "wgmma" if tma and not round_k else "mma"


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


def n_group(n: int, tile_n: int, cta_n: int) -> int:
    """Logical N tiles one CTA of ``cta_n`` columns covers side by side:
    ⌊cta_n / tile_n⌋ where the N tile is narrower than both N and the CTA,
    else 1 (a tile at least as wide as the CTA takes ceil(tile / cta) CTAs;
    a tile that is all of N is placed as before).  The kernels compute the
    same (csrc/common.cuh ``n_group``)."""
    return cta_n // tile_n if tile_n < min(n, cta_n) else 1


def m_group(m: int, tile_m: int, cta_rows: int = ROWS_CTA_M) -> int:
    """Logical M tiles one rows-body CTA of ``cta_rows`` rows covers one
    under the other: ⌊cta_rows / tile_m⌋ where the M tile is narrower than
    both M and the CTA, else 1 (397 rows on 1-row tiles: 16 a CTA; decode's
    4 rows on a 4-row tile and verify's 16 on a 16-row tile: 1).  The
    kernel computes the same (csrc/common.cuh ``m_group``)."""
    return cta_rows // tile_m if tile_m < min(m, cta_rows) else 1


def rows_span(m: int, tile_m: int) -> int:
    """Rows one rows-body CTA covers: :func:`m_group` × the M tile (the
    rows body's ``cta_m``; a ragged last group holds fewer)."""
    return m_group(m, tile_m) * tile_m


def tiled_geometry(m: int, n: int, tile_m: int, tile_n: int, groups: int = 1,
                   tiles: tuple[tuple[int, int], ...] = MMA_CTA_TILES) -> tuple[int, int, int]:
    """(cta_m, cta_n, ctas) of a tensor-core body for an (m, n) output under
    (tile_m, tile_n) logical tiles; grouped, per expert, with ``groups``
    experts side by side on the card.

    CTAs as :func:`cta_count` places them; a ragged edge tile may leave some
    of them empty (they return at once).  The CTA tile is the largest of
    ``tiles`` that fits the logical tile (rounded up to 64; along N, the
    group of :func:`n_group` tiles it would cover) and launches at least
    :data:`SMS` CTAs over all experts; where none does, the one that
    launches the most.  ``tiles``: the compiled CTA tiles to choose from,
    largest first (the body's, :data:`CTA_TILES`)."""
    tm = min(tile_m, m)

    def ctas(cta: tuple[int, int]) -> int:
        return cta_count(m, n, tile_m, tile_n, *cta)

    def span(cta_n: int) -> int:   # the columns a CTA of this width covers
        return min(n_group(n, tile_n, cta_n) * tile_n, n)

    fits = [c for c in tiles if c[0] <= 64 * _cdiv(tm, 64) and c[1] <= 64 * _cdiv(span(c[1]), 64)]
    fits = fits or [tiles[-1]]   # no compiled tile fits: the smallest, masked
    cta = next((c for c in fits if groups * ctas(c) >= SMS), max(fits, key=ctas))
    return (*cta, ctas(cta))


def cta_count(m: int, n: int, tile_m: int, tile_n: int, cta_m: int, cta_n: int) -> int:
    """CTAs that cover an (m, n) output under (tile_m, tile_n) logical tiles
    with (cta_m, cta_n) CTA tiles (the kernel's gridDim.x, per expert):
    along N the groups of :func:`n_group` logical tiles, each of
    ceil(min(group, N) / cta_n) CTAs; along M ceil(min(tile, M) / cta_m)
    CTAs per logical tile."""
    span = n_group(n, tile_n, cta_n) * tile_n
    return (_cdiv(m, tile_m) * _cdiv(min(tile_m, m), cta_m)
            * _cdiv(n, span) * _cdiv(min(span, n), cta_n))


def rows_k_slice(k: int, split_k: int) -> int:
    """K rows of one slice when the rows body splits K into ``split_k``
    slices (the last may be shorter): a multiple of :data:`ROWS_SLICE_ALIGN`."""
    return ROWS_SLICE_ALIGN * _cdiv(_cdiv(k, split_k), ROWS_SLICE_ALIGN)


def rows_geometry(m: int, n: int, k: int, tile_m: int, tile_n: int,
                  groups: int = 1, round_k: int = 0) -> tuple[int, int, int]:
    """(cta_n, split_k, ctas) of the rows body for an (m, n) output with
    depth k under (tile_m, tile_n) logical tiles; grouped, per expert, with
    ``groups`` experts side by side on the card.

    A CTA covers one :data:`ROWS_CTA_N`-column strip of one group of
    :func:`n_group` logical N tiles, over the :func:`rows_span` rows of one
    group of :func:`m_group` logical M tiles and one K slice, and never
    crosses either group's edge: at an N tile of 3, 21 tiles (63 columns) a
    CTA; at an M tile of 1, 16 rows.  Where the strips of all experts launch
    fewer than :data:`ROWS_MIN_CTAS`, K is split into ``split_k`` slices of at least
    :data:`ROWS_MIN_SLICE` rows, summed in slice order by a second pass.
    ``split_k`` depends on k, n, tile_n and groups only, never on m, so a
    row's summation order (and its bits) is the same at M = 1 and M = 4.
    In rounding mode (``round_k`` > 0) K is never split: one CTA chains the
    K tiles in order."""
    strips = cta_count(1, n, 1, tile_n, 1, ROWS_CTA_N)   # of one row of logical tiles
    split_k = 1
    if groups * strips < ROWS_MIN_CTAS and not round_k:
        split_k = max(1, min(_cdiv(ROWS_MIN_CTAS, groups * strips), k // ROWS_MIN_SLICE))
        split_k = _cdiv(k, rows_k_slice(k, split_k))   # no empty slice
    return ROWS_CTA_N, split_k, _cdiv(m, rows_span(m, tile_m)) * strips * split_k


def launch_geometry(dtype: torch.dtype, m: int, n: int, k: int, tile_m: int, tile_n: int,
                    groups: int = 1, round_k: int = 0, *,
                    aligned: bool = True) -> tuple[str, int, int, int, int]:
    """(body, cta_m, cta_n, split_k, ctas) of a launch, CTAs per expert: the
    body from :func:`body_for` (``aligned``: x's and w's bases lie on 16
    bytes, as the allocator's tensors do; a launch reads it from its
    tensors), the rows body's strips and K slices from
    :func:`rows_geometry` (its ``cta_m`` the rows of a group of M tiles,
    :func:`rows_span`), the tensor-core bodies' CTA tiles from
    :func:`tiled_geometry` over their own :data:`CTA_TILES`, one CTA per
    logical tile in the fma body (:func:`cta_count` with the logical tile
    as the CTA's).  The kernel re-checks it and refuses a mismatch."""
    body = body_for(dtype, tile_m, aligned and tma_layout(n, k, tile_n), round_k)
    if body == "rows":
        cta_n, split_k, ctas = rows_geometry(m, n, k, tile_m, tile_n, groups, round_k)
        return body, rows_span(m, tile_m), cta_n, split_k, ctas
    if body in CTA_TILES:
        cta_m, cta_n, ctas = tiled_geometry(m, n, tile_m, tile_n, groups, CTA_TILES[body])
        return body, cta_m, cta_n, 1, ctas
    return body, tile_m, tile_n, 1, cta_count(m, n, tile_m, tile_n, tile_m, tile_n)


def _count_rows(body: str, m: int, tile_m: int, cta_m: int) -> None:
    """Counts a rows launch by its M tile (``grouped_tile_launches``,
    ``narrow_tile_launches``)."""
    if body != "rows":
        return
    if cta_m > tile_m:
        grouped_tile_launches[tile_m] += 1
    if tile_m <= 8 and m > tile_m:
        narrow_tile_launches[tile_m] += 1


def bases16(x: torch.Tensor, w: torch.Tensor) -> bool:
    """x's and w's first elements lie on 16 bytes (:func:`launch_geometry`'s
    ``aligned``)."""
    return x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0


def mma_reason(x: torch.Tensor, w: torch.Tensor, tile_n: int, round_k: int) -> str:
    """Why a bf16 launch of an M tile above 16 takes the mma body
    (:data:`mma_launches`): ``"round"``, ``"w_off16"`` or ``"x_off16"``;
    raises where it would not (the rule sends it to ``wgmma``)."""
    n, k = w.shape[-1], x.shape[-1]
    if round_k:
        return "round"
    if w.data_ptr() % 16 or n % 8 or min(tile_n, n) % 8:
        return "w_off16"
    if x.data_ptr() % 16 or k % 8:
        return "x_off16"
    raise AssertionError(f"a launch of ({k},{n}) under N tile {tile_n} meets the wgmma rule")


def _workspace(x: torch.Tensor, groups: int, split_k: int, m: int, n: int) -> torch.Tensor | None:
    """The rows body's f32 partial sums (groups, split_k, m, n) when it splits K."""
    if split_k == 1:
        return None
    return torch.empty((groups, split_k, m, n), dtype=torch.float32, device=x.device)


def matmul(x: torch.Tensor, w: torch.Tensor, cs: ConcreteSchedule, *,
           class_id: str = "matmul", bias: torch.Tensor | None = None,
           residual: torch.Tensor | None = None, softcap: float = 0.0,
           out_f32: bool = False) -> torch.Tensor:
    """x (M,K) @ w (K,N) with the class's fused epilogue -> (M, N or N/2),
    in x's dtype or, with ``out_f32``, in f32."""
    if x.device.type == "cpu":
        return ref.matmul(x, w, class_id, bias=bias, residual=residual, softcap=softcap,
                          round_k=round_k_for(cs), out_f32=out_f32)
    return launch(x, w, cs, class_id=class_id, bias=bias, residual=residual, softcap=softcap,
                  out_f32=out_f32)


def launch(x: torch.Tensor, w: torch.Tensor, cs: ConcreteSchedule, *,
           class_id: str = "matmul", bias: torch.Tensor | None = None,
           residual: torch.Tensor | None = None, softcap: float = 0.0,
           with_z: bool = False, out_f32: bool = False) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; raises on anything it does not take.  With
    ``with_z``, returns (Y, Z): Z (M, N) in x's dtype is the pre-epilogue
    sum plus the bias, bit for bit the output of a ``matmul`` launch (with a
    bias: ``matmul_bias``) of the same schedule key; Y's bits do not change.
    With ``out_f32`` Y is f32: the epilogue's value before the cast."""
    if not x.is_cuda:
        raise ValueError(f"the matmul kernel runs on a CUDA tensor, got {x.device}")
    key = launch_key(x, w, cs, class_id=class_id, bias=bias, residual=residual, softcap=softcap)
    return launch_as(x, w, key, class_id=class_id, bias=bias, residual=residual,
                     softcap=softcap, with_z=with_z, out_f32=out_f32)


def launch_key(x: torch.Tensor, w: torch.Tensor, cs: ConcreteSchedule, *, class_id: str,
               bias: torch.Tensor | None, residual: torch.Tensor | None,
               softcap: float) -> tuple[int, int, bool, int]:
    """The launch's :func:`schedule_key`; raises on anything the kernel does
    not take (any device)."""
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
    key = schedule_key(cs)
    if glu and (n % 2 or key[1] % 2):
        raise ValueError(f"GLU epilogue needs even N and N tile, got {n}, {key[1]}")
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
    return key


def launch_as(x: torch.Tensor, w: torch.Tensor, key: tuple[int, int, bool, int], *,
              class_id: str, bias: torch.Tensor | None, residual: torch.Tensor | None,
              softcap: float, with_z: bool = False,
              out_f32: bool = False) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """The launch of :func:`launch` under a checked :func:`launch_key`."""
    global launches, row_tile_launches, z_launches, f32_launches
    m, k = x.shape
    n = w.shape[1]
    tile_m, tile_n, m_outer, round_k = key
    # the reference reads bias and residual into f32 before adding them
    bias32 = bias.to(device=x.device, dtype=torch.float32).contiguous() if bias is not None else None
    res32 = residual.to(device=x.device, dtype=torch.float32).contiguous() if residual is not None else None
    out = torch.empty((m, n // 2 if class_id in GLU_CLASSES else n),
                      dtype=torch.float32 if out_f32 else x.dtype, device=x.device)
    z = torch.empty((m, n), dtype=x.dtype, device=x.device) if with_z else None
    if m == 0:
        return (out, z) if with_z else out
    body, cta_m, cta_n, split_k, ctas = launch_geometry(x.dtype, m, n, k, tile_m, tile_n,
                                                        round_k=round_k, aligned=bases16(x, w))
    ws = _workspace(x, 1, split_k, m, n)
    lib = _build.library()
    rc = lib.repro_matmul(
        x.data_ptr(), w.data_ptr(),
        bias32.data_ptr() if bias32 is not None else None,
        res32.data_ptr() if res32 is not None else None,
        out.data_ptr(), z.data_ptr() if with_z else None, m, n, k, DTYPES[x.dtype],
        EPILOGUE[class_id], float(softcap), tile_m, tile_n, int(m_outer), cta_m, cta_n, ctas,
        split_k, round_k, ws.data_ptr() if ws is not None else None, int(out_f32),
        BODIES[body], _build.stream_handle(x.device))
    if rc:   # the message is formatted only for a failed launch
        _build.check(rc, f"matmul kernel ({body}, ({m},{k})x({k},{n}), tiles {tile_m}x{tile_n}, "
                         f"CTA {cta_m}x{cta_n}, {ctas} CTAs)")
    _count_rows(body, m, tile_m, cta_m)
    launches += 1
    z_launches += with_z
    f32_launches += out_f32 and x.dtype != torch.float32
    row_tile_launches += tile_m == 1 < m
    body_launches["matmul", body, x.dtype] += 1
    if body == "mma":
        mma_launches["matmul", mma_reason(x, w, tile_n, round_k)] += 1
    if round_k:
        round_launches["matmul", body] += 1
    return (out, z) if with_z else out


@torch.library.custom_op(
    "repro_torch::matmul", mutates_args=(),
    schema="(Tensor x, Tensor w, Tensor? bias, Tensor? residual, str class_id, float softcap, "
           "int tile_m, int tile_n, bool m_outer, int round_k, bool with_z, "
           "bool out_f32=False) -> Tensor[]")
def matmul_op(x, w, bias, residual, class_id, softcap, tile_m, tile_n, m_outer, round_k,
              with_z, out_f32=False):
    """K1's forward as one dispatcher op, so that a selective-checkpoint
    policy can see and save its outputs: [Y], or [Y, Z] with ``with_z``
    (:func:`launch`).  A CUDA tensor launches the kernel under the checked
    schedule key (tile_m, tile_n, m_outer, round_k); a CPU tensor takes the
    plain version, ``ref.matmul``."""
    if x.is_cuda:
        out = launch_as(x, w, (tile_m, tile_n, m_outer, round_k), class_id=class_id, bias=bias,
                        residual=residual, softcap=softcap, with_z=with_z, out_f32=out_f32)
    else:
        out = ref.matmul(x, w, class_id, bias=bias, residual=residual, softcap=softcap,
                         round_k=round_k, with_z=with_z, out_f32=out_f32)
    return list(out) if with_z else [out]


_tls = threading.local()


@contextlib.contextmanager
def saving_dots(on: bool = True):
    """K1's forward launches in the block (on this thread) are what the
    ``dots`` remat policy saves: :class:`MatmulFn` runs them as
    :func:`matmul_op` and, for :data:`Z_CLASSES`, writes and keeps Z."""
    prev = dots_saved()
    _tls.dots = on
    try:
        yield
    finally:
        _tls.dots = prev


def dots_saved() -> bool:
    """Whether this thread is inside :func:`saving_dots`."""
    return getattr(_tls, "dots", False)


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


#: the gradient launch's bodies (:func:`grad_geometry`) and their codes in
#: csrc/matmul_grad.cu
GRAD_BODIES = {"wgmma": 0, "mma": 1, "fma": 2}
#: the CTA tiles of each gradient body (csrc/matmul_grad.cu), largest first
GRAD_CTA_TILES = {"wgmma": ((128, 256), (128, 128)), "mma": ((128, 128), (64, 128)),
                  "fma": ((64, 64),)}


def operand_layout(t: torch.Tensor) -> tuple[int, int, int]:
    """(transposed, ld, batch) of a gradient operand, a 2-D (R, C) or 3-D
    (E, R, C) view: ``transposed`` 0 where C is contiguous (``ld``: R's
    stride), 1 where R is (``ld``: C's stride); ``batch``: E's stride, 0 for
    a 2-D view.  A stride that is never read (an extent of 1) is taken as
    the packed one.  Raises where neither of R and C is contiguous."""
    if t.dim() not in (2, 3):
        raise ValueError(f"a gradient operand is 2-D or 3-D, got {tuple(t.shape)}")
    r, c = t.shape[-2:]
    sr, sc = t.stride()[-2:]
    if sc == 1 or c == 1:
        mode, ld, extent = 0, sr if r > 1 else c, c
    elif sr == 1 or r == 1:
        mode, ld, extent = 1, sc if c > 1 else r, r
    else:
        raise ValueError(f"a gradient operand needs one contiguous dimension, got strides {t.stride()}")
    if ld < extent:
        raise ValueError(f"a gradient operand's rows overlap: stride {ld} under extent {extent}")
    batch = t.stride(0) if t.dim() == 3 and t.shape[0] > 1 else 0
    return mode, ld, batch


def _aligned16(t: torch.Tensor, layout: tuple[int, int, int]) -> bool:
    """TMA can read the operand: its base, row stride and expert stride are
    multiples of 16 bytes (csrc/matmul_grad.cu aligned_operand)."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and layout[1] * es % 16 == 0 and layout[2] * es % 16 == 0


def grad_cs(a: torch.Tensor, b: torch.Tensor) -> ConcreteSchedule:
    """The default schedule of a gradient launch's own instance (class
    ``matmul``; ``moe_gemm`` per expert for 3-D operands)."""
    if a.dim() == 3:
        return grouped_grad_schedule("moe_gemm", a.dtype, a.shape[0], a.shape[1], b.shape[2],
                                     a.shape[2])
    return grad_schedule("matmul", a.dtype, a.shape[0], b.shape[1], a.shape[1])


def grad_geometry(a: torch.Tensor, b: torch.Tensor, cs: ConcreteSchedule | None = None) -> dict:
    """The gradient launch of ``a (M,K) @ b (K,N)`` (per expert for 3-D
    views) under ``cs`` (default: :func:`grad_cs`): each operand's layout
    (:func:`operand_layout`), the logical tiles and the body, a rule by
    dtype and alignment: ``fma`` for f32; for bf16, ``wgmma`` where both
    operands are 16-byte aligned (:func:`_aligned16`) and, along an
    operand's contiguous M or N, the logical tile is a multiple of 8 (TMA's
    boxes start on 16 bytes): every training shape of gemma2, rwkv6,
    recurrentgemma and mixtral; else ``mma`` with operand modes (the LM
    heads of whisper-medium and internvl2-26b: rows of 51865 and 92553
    values).  Any device: the CPU tests reach it."""
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise ValueError(f"gradient launch takes bf16 or f32 operands of one dtype, "
                         f"got {a.dtype}, {b.dtype}")
    if a.dim() != b.dim() or a.shape[-1] != b.shape[-2] or (a.dim() == 3 and a.shape[0] != b.shape[0]):
        raise ValueError(f"gradient launch takes a (M,K), b (K,N) (per expert), "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}")
    la, lb = operand_layout(a), operand_layout(b)
    tile_m, tile_n, m_outer, _ = schedule_key(cs if cs is not None else grad_cs(a, b))
    if a.dtype == torch.float32:
        body = "fma"
    else:
        tma = (_aligned16(a, la) and _aligned16(b, lb) and (la[0] == 0 or tile_m % 8 == 0)
               and (lb[0] == 1 or tile_n % 8 == 0))
        body = "wgmma" if tma else "mma"
    return {"body": body, "a": la, "b": lb, "tile_m": tile_m, "tile_n": tile_n, "m_outer": m_outer}


def grad_cta(body: str, m: int, n: int, tile_m: int, tile_n: int,
             groups: int = 1) -> tuple[int, int, int]:
    """(cta_m, cta_n, ctas) of a gradient launch, CTAs per expert: the
    body's CTA tile (:data:`GRAD_CTA_TILES`) covering each logical tile, or
    each group of :func:`n_group` tiles narrower than it (:func:`cta_count`:
    internvl2-26b's dW at an N tile of 3 takes 42 a CTA).
    ``wgmma`` takes 128x256 where a logical tile's columns are whole 256s
    (none of its CTAs half idle) and the launch still makes two waves of
    the card (a 2048x2304 output under 384-column tiles keeps 128x128: 288
    CTAs, where 128x256 would leave a second wave of 12); ``mma`` the larger
    tile where it still fills the card, as :func:`tiled_geometry`."""
    if body == "wgmma":
        wide = GRAD_CTA_TILES[body][0]
        wide_ctas = cta_count(m, n, tile_m, tile_n, *wide)
        if min(tile_n, n) % wide[1] == 0 and groups * wide_ctas >= 2 * SMS:
            return (*wide, wide_ctas)
        narrow = GRAD_CTA_TILES[body][1]
        return (*narrow, cta_count(m, n, tile_m, tile_n, *narrow))
    return tiled_geometry(m, n, tile_m, tile_n, groups, GRAD_CTA_TILES[body])


def _grad_run(a: torch.Tensor, b: torch.Tensor, cs: ConcreteSchedule, kernel: str,
              bias: torch.Tensor | None = None, out_f32: bool = False) -> torch.Tensor:
    """Launch csrc/matmul_grad.cu on views ``a``, ``b`` under ``cs`` (K1:
    2-D, ``kernel`` "matmul"; K1g: 3-D, "grouped_matmul"); counts it.
    ``out_f32``: the output in f32, its sums unrounded."""
    global launches, grouped_launches, f32_grad_launches
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(f"the gradient kernel runs on CUDA tensors, got {a.device}, {b.device}")
    geo = grad_geometry(a, b, cs)
    body, tile_m, tile_n, m_outer = geo["body"], geo["tile_m"], geo["tile_n"], geo["m_outer"]
    (a_t, a_ld, a_batch), (b_t, b_ld, b_batch) = geo["a"], geo["b"]
    *lead, m, k = a.shape
    n = b.shape[-1]
    out = torch.empty((*lead, m, n), dtype=torch.float32 if out_f32 else a.dtype, device=a.device)
    groups = lead[0] if lead else 1
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_() if bias is None else out.copy_(bias.to(out.dtype).expand_as(out))
    cta_m, cta_n, ctas = grad_cta(body, m, n, tile_m, tile_n, groups)
    lib = _build.library()
    if kernel == "matmul":
        bias32 = bias.to(device=a.device, dtype=torch.float32).contiguous() if bias is not None else None
        rc = lib.repro_matmul_grad(
            a.data_ptr(), a_t, a_ld, b.data_ptr(), b_t, b_ld,
            bias32.data_ptr() if bias32 is not None else None, out.data_ptr(), m, n, k,
            DTYPES[a.dtype], GRAD_BODIES[body], tile_m, tile_n, int(m_outer), cta_m, cta_n, ctas,
            int(out_f32), _build.stream_handle(a.device))
        launches += 1
    else:
        rc = lib.repro_grouped_matmul_grad(
            a.data_ptr(), a_t, a_ld, a_batch, b.data_ptr(), b_t, b_ld, b_batch, out.data_ptr(),
            groups, m, n, k, DTYPES[a.dtype], GRAD_BODIES[body], tile_m, tile_n, int(m_outer),
            cta_m, cta_n, ctas, int(out_f32), _build.stream_handle(a.device))
        grouped_launches += 1
    _build.check(rc, f"{kernel} gradient kernel ({body}, {groups}x({m},{k})x({k},{n}), "
                     f"a {geo['a']}, b {geo['b']}, tiles {tile_m}x{tile_n}, {ctas} CTAs)")
    body_launches[kernel, body, a.dtype] += 1
    grad_body_launches[kernel, body, a.dtype] += 1
    f32_grad_launches += out_f32 and a.dtype != torch.float32
    return out


def grad_launch(a: torch.Tensor, b: torch.Tensor, class_id: str = "matmul",
                bias: torch.Tensor | None = None, out_f32: bool = False) -> torch.Tensor:
    """a (M,K) @ b (K,N) (+ bias) for a gradient, under the default schedule
    of its own instance; ``a`` and ``b`` may be transposed views, read in
    place.  ``out_f32``: the result in f32.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    global grad_launches
    if class_id not in ("matmul", "matmul_bias"):
        raise ValueError(f"a gradient launch is of class matmul or matmul_bias, got {class_id!r}")
    if not a.is_cuda:
        return ref.matmul(a, b, class_id, bias=bias, out_f32=out_f32)
    out = _grad_run(a, b, grad_cs(a, b), "matmul", bias, out_f32)
    grad_launches += 1
    return out


#: the classes whose epilogue has a derivative: dL/dZ is not dL/dY
ACTIVATION_CLASSES = ("matmul_lmhead_softcap", "matmul_bias_gelu", "matmul_silu_glu",
                      "matmul_gelu_glu")
#: the activation classes whose derivative reads Z (the softcap's reads Y)
Z_CLASSES = ("matmul_bias_gelu", "matmul_silu_glu", "matmul_gelu_glu")


def epilogue_grad(x: torch.Tensor, w: torch.Tensor, saved: torch.Tensor | None,
                  dy: torch.Tensor, class_id: str, bias: torch.Tensor | None,
                  softcap: float) -> torch.Tensor:
    """dL/dZ (f32) of ``y = epilogue(Z)`` (``Z = x·w``, plus ``bias``) at ``dy``
    for the :data:`ACTIVATION_CLASSES`.  ``saved``: Y for the softcap; for
    :data:`Z_CLASSES`, Z as the forward wrote it, or None, and then one
    gradient launch recomputes it."""
    dyf = dy.float()
    if class_id == "matmul_lmhead_softcap":
        t = saved.float() / softcap                 # tanh(z / c)
        return dyf * (1.0 - t * t)
    z = saved
    if z is None:
        z = grad_launch(x, w, "matmul" if bias is None else "matmul_bias", bias=bias)
    with torch.enable_grad():
        zf = z.float().requires_grad_()
        return torch.autograd.grad(ref.apply_epilogue(zf, class_id), zf, dyf)[0]


def in_place(t: torch.Tensor) -> torch.Tensor:
    """``t`` where a gradient launch can read it as it lies
    (:func:`operand_layout`), else a contiguous copy (an expanded gradient,
    say, with stride 0)."""
    try:
        operand_layout(t)
    except ValueError:
        return t.contiguous()
    return t


class MatmulFn(torch.autograd.Function):
    """K1 under autograd: the forward launch (a CPU tensor: the plain
    version), K1 backward.  Inside :func:`saving_dots` the forward is
    :func:`matmul_op`, writing Z for :data:`Z_CLASSES`.

    ``transpose_of`` (or None): the (N, K) tensor that ``w`` is a contiguous
    transposed copy of (a tied LM head's ``embed``).  Its gradient is
    returned in place of ``w``'s, and it is ``dX``'s operand as it is.

    Saved for the backward: x, w, ``transpose_of``, the bias and what the
    epilogue's derivative reads (:func:`epilogue_grad`): Y for the softcap,
    Z where the forward wrote it, else None.

    ``out_f32``: Y in f32 (a row-parallel product's partial sums).  An f32
    ``x`` beside a bf16 ``w`` is a carrier of bf16 values (see the module):
    the launches read those values and ``dX`` comes back in f32.
    ``w_carrier``: ``w`` is one too (f32, its bf16 values read), and ``dW``
    comes back in f32."""

    @staticmethod
    def forward(ctx, x, w, transpose_of, bias, residual, cs, class_id, softcap, out_f32=False,
                w_carrier=False):
        dtype = torch.bfloat16 if w_carrier else w.dtype
        ctx.carrier, ctx.w_carrier = x.dtype != dtype, w_carrier
        if ctx.carrier:
            x = carried(x, dtype)
        if w_carrier:
            w = carried(w, dtype)
        saved = None
        if dots_saved():
            with_z = class_id in Z_CLASSES
            key = launch_key(x, w, cs, class_id=class_id, bias=bias, residual=residual,
                             softcap=softcap)
            y, *z = matmul_op(x, w, bias, residual, class_id, float(softcap), *key, with_z,
                              out_f32)
            saved = z[0] if with_z else None
        else:
            y = matmul(x, w, cs, class_id=class_id, bias=bias, residual=residual, softcap=softcap,
                       out_f32=out_f32)
        ctx.class_id, ctx.softcap = class_id, softcap
        ctx.res_dtype = residual.dtype if residual is not None else None
        ctx.save_for_backward(x, w, transpose_of, bias,
                              y if class_id == "matmul_lmhead_softcap" else saved)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, w_src, bias, saved = ctx.saved_tensors
        need_x, need_w, need_src, need_bias, need_res = ctx.needs_input_grad[:5]
        if ctx.class_id in ACTIVATION_CLASSES:
            dzf = epilogue_grad(x, w, saved, dy, ctx.class_id, bias, ctx.softcap)
            dz = dzf.to(x.dtype)
        else:   # dZ is dY: no f32 round trip (bf16 -> f32 -> bf16 gives the same bits)
            dzf, dz = None, in_place(dy if dy.dtype == x.dtype else dy.to(x.dtype))
        dx = dw = dsrc = db = dres = None
        if need_x:   # a tied head's wᵀ is the embedding itself
            dx = grad_launch(dz, w_src if w_src is not None else w.T,
                             out_f32=getattr(ctx, "carrier", False))
        if need_w:
            dw = grad_launch(x.T, dz, out_f32=getattr(ctx, "w_carrier", False))
        if need_src:
            dsrc = grad_launch(dz.T, x)
        if need_bias:
            db = (dzf if dzf is not None else dy.float()).sum(0).to(bias.dtype)
        if need_res:
            dres = dy.to(ctx.res_dtype)
        return dx, dw, dsrc, db, dres, None, None, None, None, None


def carried(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The values of an f32 carrier as ``dtype`` (they are ``dtype``'s
    values already, so the cast is exact); raises on any other mix."""
    if not (x.dtype == torch.float32 and dtype == torch.bfloat16):
        raise ValueError(f"an f32 carrier of bf16 values goes with a bf16 w, got {x.dtype} "
                         f"beside {dtype}")
    return x.to(dtype)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, cs: ConcreteSchedule, *,
                   class_id: str = "moe_gemm", out_f32: bool = False) -> torch.Tensor:
    """x (E,M,K) @ w (E,K,N) per expert with the class's epilogue -> (E, M, N or N/2),
    in x's dtype or, with ``out_f32``, in f32."""
    if x.device.type == "cpu":
        return ref.grouped_matmul(x, w, class_id, round_k=round_k_for(cs), out_f32=out_f32)
    return grouped_launch(x, w, cs, class_id=class_id, out_f32=out_f32)


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
                   class_id: str = "moe_gemm", out_f32: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel over every expert; raises on anything it does
    not take.  ``out_f32``: the output in f32, unrounded."""
    global grouped_launches, f32_launches
    if not x.is_cuda:
        raise ValueError(f"the grouped matmul kernel runs on a CUDA tensor, got {x.device}")
    e, m, n, k, tile_m, tile_n = grouped_geometry(x, w, cs, class_id)
    out = torch.empty((e, m, n // 2 if class_id in GLU_CLASSES else n),
                      dtype=torch.float32 if out_f32 else x.dtype, device=x.device)
    if m == 0 or e == 0:
        return out
    _, _, m_outer, round_k = schedule_key(cs)
    body, cta_m, cta_n, split_k, ctas = launch_geometry(x.dtype, m, n, k, tile_m, tile_n, e,
                                                        round_k, aligned=bases16(x, w))
    ws = _workspace(x, e, split_k, m, n)
    rc = _build.library().repro_grouped_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, m, n, k, DTYPES[x.dtype],
        GROUPED_EPILOGUE[class_id], tile_m, tile_n, int(m_outer), cta_m, cta_n, ctas,
        split_k, round_k, ws.data_ptr() if ws is not None else None, int(out_f32),
        BODIES[body], _build.stream_handle(x.device))
    if rc:
        _build.check(rc, f"grouped matmul kernel ({body}, {e}x({m},{k})x({k},{n}), tiles "
                         f"{tile_m}x{tile_n}, CTA {cta_m}x{cta_n}, {ctas} CTAs)")
    _count_rows(body, m, tile_m, cta_m)
    grouped_launches += 1
    f32_launches += out_f32 and x.dtype != torch.float32
    body_launches["grouped_matmul", body, x.dtype] += 1
    if body == "mma":
        mma_launches["grouped_matmul", mma_reason(x, w, tile_n, round_k)] += 1
    if round_k:
        round_launches["grouped_matmul", body] += 1
    return out


def grouped_grad_launch(a: torch.Tensor, b: torch.Tensor, out_f32: bool = False) -> torch.Tensor:
    """a (E,M,K) @ b (E,K,N) per expert (class ``moe_gemm``) for a gradient,
    under the default schedule of its own instance; ``a`` and ``b`` may be
    ``.transpose(1, 2)`` views, read in place.  ``out_f32``: the result in
    f32.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    global grouped_grad_launches
    if not a.is_cuda:
        return ref.grouped_matmul(a, b, "moe_gemm", out_f32=out_f32)
    out = _grad_run(a, b, grad_cs(a, b), "grouped_matmul", out_f32=out_f32)
    grouped_grad_launches += 1
    return out


class GroupedMatmulFn(torch.autograd.Function):
    """K1g under autograd: :func:`grouped_matmul` forward (a CUDA tensor
    launches, a CPU tensor takes the plain version), K1g backward.  CUDA
    tensors always take it; CPU tensors where ``x`` is an f32 carrier or Y
    is f32 (``out_f32``), as :class:`MatmulFn` takes both."""

    @staticmethod
    def forward(ctx, x, w, cs, class_id, out_f32=False):
        ctx.class_id = class_id
        ctx.carrier = x.dtype != w.dtype
        if ctx.carrier:
            x = carried(x, w.dtype)
        ctx.save_for_backward(x, w)
        return grouped_matmul(x, w, cs, class_id=class_id, out_f32=out_f32)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        dz = in_place(dy if dy.dtype == x.dtype else dy.to(x.dtype))
        if ctx.class_id in GLU_CLASSES:
            z = grouped_grad_launch(x, w)              # the pre-activation, recomputed
            with torch.enable_grad():
                zf = z.float().requires_grad_()
                dz = torch.autograd.grad(ref.apply_epilogue(zf, ctx.class_id), zf,
                                         dy.float())[0].to(x.dtype)
        dx = (grouped_grad_launch(dz, w.transpose(1, 2), getattr(ctx, "carrier", False))
              if need_x else None)
        dw = grouped_grad_launch(x.transpose(1, 2), dz) if need_w else None
        return dx, dw, None, None, None
