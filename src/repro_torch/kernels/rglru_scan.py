"""RG-LRU recurrence (Griffin / RecurrentGemma): the CUDA kernel's wrapper.

Replaces the Pallas kernel ``src/repro/kernels/rglru_scan.py``
(``rglru_scan()`` → ``_kernel``; kernel K4).  The CUDA source is
``csrc/rglru_scan.cu``.  A diagonal linear recurrence,
``h = a⊙h + sqrt(max(1 − a², 0))⊙x``, with an f32 state, parallel over
channels and sequential over time.  x and a are bf16 or f32 (one dtype); the
state is f32; y comes back in x's dtype.

The launch layout (:func:`scan_geometry`, :func:`cta_channels`) is
decoupled from the schedule's C tile: a CTA covers :data:`CTA_C` channels
of one batch row and never crosses a logical C tile's edge — 80 CTAs per
batch row at recurrentgemma-2b's 2560 channels under the default
512-channel tile.  In a CTA one warp runs the recurrence, a lane per
channel, so its critical path is one FMA per token; eight helper warps
stage x and a :data:`STAGE_T` tokens at a time through a 4-stage
``cp.async`` ring and work out the input factor ``sqrt(max(1 − a², 0))·x``
ahead of the chain.  Every channel runs the same arithmetic whatever the
layout, so y and the state are bit-identical across C tiles, T tiles and
batch sizes, and when a scan is continued from its returned state.  The
kernel re-checks the layout and refuses a mismatch.

How the :class:`~repro_torch.core.schedule.ConcreteSchedule` maps onto the
kernel:

* ``tiles["C"]`` — the logical channel tile: the unit the CTAs are laid
  out in (``ceil(min(tile, C) / CTA_C)`` CTAs per tile, the ragged C edge
  masked).
* ``tiles["T"]`` — not used: the stage is fixed (the TPU chunked time to
  fit VMEM).
* ``order``, ``parallel``, ``unroll``, ``vec`` — ignored (TPU compiler hints).

What bounds it on the card: the bytes of x, a and y, read or written once
(~7 f32 operations per element are far below the CUDA cores' rate).  Loads
and stores are 16-byte chunks across neighbouring channels where C and the
C tile allow it, element by element otherwise.

A tensor on the CPU takes the plain version (:func:`repro_torch.kernels.ref.rglru_scan`);
a CUDA tensor launches the kernel or raises.  ``launches`` counts launches.

Under autograd a CUDA tensor goes through :class:`RglruScanFn`: the forward
is :func:`launch` (the same bits as without a gradient), the backward
:func:`launch_bwd`, a kernel of its own (``csrc/rglru_scan_bwd.cu``, the
same CTA layout): a forward walk saves the f32 state every
:data:`BWD_STAGE_T` tokens, a reverse walk recomputes each stage's states
from it and runs ``g = dy + a·g`` back through time, giving dx, da and the
initial state's gradient.  ``bwd_launches`` counts its launches.  Its plain
version is :func:`repro_torch.kernels.ref.rglru_scan_bwd`.
"""
from __future__ import annotations

import torch

from repro_torch.core.schedule import ConcreteSchedule
from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul import DTYPES

#: channels per CTA (csrc/rglru_scan.cu kLruCtaC)
CTA_C = 32
#: tokens per shared-memory stage (kLruStageT)
STAGE_T = 64
#: batch rows the grid takes (its y dimension)
MAX_BATCH = 65535
#: tokens between the backward kernel's f32 state checkpoints (kLruBwdStageT)
BWD_STAGE_T = 32

#: kernel launches since the last reset (plain counts; see chip_smoke.py):
#: the forward's and the backward's
launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def scan_geometry(b: int, t: int, c: int, tile_t: int, tile_c: int) -> tuple[int, int, int]:
    """(cta_c, stage_t, ctas) of a launch over (B, T, C) under (tile_t,
    tile_c) logical tiles: channels per CTA, tokens per stage and the CTA
    count, ``ceil(min(tile_c, C) / CTA_C)`` per C tile and batch row (a
    ragged last tile may leave some empty).  The layout never depends on T
    or the T tile.  Raises ``ValueError`` on a shape the kernel does not
    take."""
    if min(b, t, c, tile_t, tile_c) < 1 or b > MAX_BATCH:
        raise ValueError(f"RG-LRU scan needs 1 <= B <= {MAX_BATCH} and T, C and both tiles "
                         f">= 1, got {(b, t, c, tile_t, tile_c)}")
    return CTA_C, STAGE_T, b * _cdiv(c, tile_c) * _cdiv(min(tile_c, c), CTA_C)


def cta_channels(c: int, tile_c: int) -> list[range]:
    """The channels each CTA of one batch row covers, in launch order, as
    the kernel maps them: CTA i takes part ``i % per_tile`` of C tile
    ``i // per_tile``, clipped to that tile and to C (empty where a ragged
    last tile leaves it nothing)."""
    per_tile = _cdiv(min(tile_c, c), CTA_C)
    out = []
    for i in range(_cdiv(c, tile_c) * per_tile):
        tile, part = divmod(i, per_tile)
        c0 = tile * tile_c + part * CTA_C
        out.append(range(c0, max(c0, min(c0 + CTA_C, (tile + 1) * tile_c, c))))
    return out


def schedule_key(cs: ConcreteSchedule) -> tuple[int]:
    """What a launch reads of a concrete schedule: the C tile, which lays out
    the CTAs.  The T tile is passed and checked but changes nothing, and the
    TPU hints are ignored."""
    return (cs.t["C"],)


def rglru_scan(x: torch.Tensor, a: torch.Tensor, state: torch.Tensor,
               cs: ConcreteSchedule) -> tuple[torch.Tensor, torch.Tensor]:
    """x, a: (B, T, C); state: (B, C) f32. Returns (y in x's dtype, final h f32)."""
    if x.device.type == "cpu":
        return ref.rglru_scan(x, a, state)
    return launch(x, a, state, cs)


def check_args(x: torch.Tensor, a: torch.Tensor, state: torch.Tensor,
               cs: ConcreteSchedule) -> tuple[int, int, int, int]:
    """(cta_c, stage_t, ctas, tile_c) of a launch over x, a and the state
    under ``cs``; raises on what the kernels (forward and backward) do not
    take.  Any device: the CPU tests reach it."""
    if x.dtype not in DTYPES or a.dtype != x.dtype:
        raise ValueError(f"RG-LRU scan takes bf16 or f32 x and a of one dtype, got {x.dtype}, {a.dtype}")
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"RG-LRU scan takes x and a of one shape (B,T,C), "
                         f"got {tuple(x.shape)}, {tuple(a.shape)}")
    b, t, c = x.shape
    cta_c, stage_t, ctas = scan_geometry(b, t, c, cs.t["T"], cs.t["C"])
    if tuple(state.shape) != (b, c):
        raise ValueError(f"state must be {(b, c)}, got {tuple(state.shape)}")
    if a.device != x.device or state.device != x.device:
        raise ValueError("RG-LRU scan takes x, a and the state on one device")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("RG-LRU scan takes contiguous x and a")
    p = cs.instance.p
    if (cs.instance.class_id, p["T"], p["C"], p["B"]) != ("rglru_scan", t, c, b):
        raise ValueError(f"schedule for {cs.instance} does not fit x {tuple(x.shape)}")
    return cta_c, stage_t, ctas, cs.t["C"]


def launch(x: torch.Tensor, a: torch.Tensor, state: torch.Tensor,
           cs: ConcreteSchedule) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; raises on anything it does not take."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"the RG-LRU scan kernel runs on a CUDA tensor, got {x.device}")
    cta_c, stage_t, ctas, _ = check_args(x, a, state, cs)
    b, t, c = x.shape
    h0 = state.to(torch.float32).contiguous()   # the reference reads the state into f32
    y = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    lib = _build.library()
    rc = lib.repro_rglru_scan(x.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                              h_out.data_ptr(), b, t, c, DTYPES[x.dtype], cs.t["T"], cs.t["C"],
                              cta_c, stage_t, ctas, _build.stream_handle(x.device))
    _build.check(rc, "RG-LRU scan kernel")
    launches += 1
    return y, h_out


class RglruScanFn(torch.autograd.Function):
    """K4 under autograd on CUDA tensors: :func:`launch` forward,
    :func:`launch_bwd` backward on the saved x, a and initial state."""

    @staticmethod
    def forward(ctx, x, a, state, cs):
        y, h = launch(x, a, state, cs)
        ctx.cs, ctx.state_dtype = cs, state.dtype
        ctx.save_for_backward(x, a, state)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, a, state = ctx.saved_tensors
        dx, da, dh0 = launch_bwd(x, a, state, dy.contiguous(), dh, ctx.cs)
        return dx, da, dh0.to(ctx.state_dtype), None


def launch_bwd(x: torch.Tensor, a: torch.Tensor, state: torch.Tensor, dy: torch.Tensor,
               dstate: torch.Tensor | None, cs: ConcreteSchedule) -> tuple[torch.Tensor, ...]:
    """Launch the backward kernel: (dx, da in x's dtype, the initial state's
    gradient f32) at ``dy`` (y's gradient, x's dtype) and ``dstate`` (the
    final state's, or None); raises on anything it does not take."""
    global bwd_launches
    if not x.is_cuda:
        raise ValueError(f"the RG-LRU scan backward kernel runs on a CUDA tensor, got {x.device}")
    cta_c, _, ctas, tile_c = check_args(x, a, state, cs)
    b, t, c = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous, {tuple(x.shape)} {x.dtype}, "
                         f"got {tuple(dy.shape)} {dy.dtype}")
    if dstate is not None:
        if tuple(dstate.shape) != (b, c):
            raise ValueError(f"the final state's gradient must be {(b, c)}, got {tuple(dstate.shape)}")
        dstate = dstate.to(torch.float32).contiguous()
    h0 = state.to(torch.float32).contiguous()
    dx, da, dh0 = torch.empty_like(x), torch.empty_like(x), torch.empty_like(h0)
    ck = torch.empty((b, _cdiv(t, BWD_STAGE_T), c), dtype=torch.float32, device=x.device)
    rc = _build.library().repro_rglru_scan_bwd(
        x.data_ptr(), a.data_ptr(), h0.data_ptr(), dy.data_ptr(),
        dstate.data_ptr() if dstate is not None else None, dx.data_ptr(), da.data_ptr(),
        dh0.data_ptr(), ck.data_ptr(), b, t, c, DTYPES[x.dtype], tile_c, cta_c, BWD_STAGE_T,
        ctas, _build.stream_handle(x.device))
    _build.check(rc, "RG-LRU scan backward kernel")
    bwd_launches += 1
    return dx, da, dh0
