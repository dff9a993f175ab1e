"""wkv6 recurrence (RWKV6 / Finch time-mix): the CUDA kernel's wrapper.

Replaces the Pallas kernel ``src/repro/kernels/rwkv6_scan.py``
(``rwkv6_scan()`` → ``_kernel``; kernel K3).  The CUDA source is
``csrc/rwkv6_scan.cu``.  Per (batch, head) a D×D f32 state is decayed per
key channel by the data-dependent ``w`` and updated with rank-1 products:
``y_t = rᵀ(S + u⊙k vᵀ)``, ``S ← diag(w) S + k vᵀ``.  r, k, v and w are
bf16 or f32 (one dtype); u and the state are f32.  Head dims 16 (the
reduced test configs), 32 and 64 (rwkv6-1.6b) run; any other raises
``ValueError``.

The launch layout (:func:`scan_geometry`) splits each (batch, head) state
over CTAs by value columns, which evolve independently: one CTA per
(batch, head, :data:`CTA_COLS` columns) — 128 CTAs at rwkv6-1.6b's prefill
(1·32·T·64), 512 at its 4-slot decode.  Inside a CTA each thread holds
:data:`THREAD_ROWS` key rows of one column of the state in registers, so D
/ :data:`THREAD_ROWS` threads share a column and each sums its rows' share
of y; the shares are added in row-block order, which depends on D alone.
So y and the state are bit-identical across T tiles, across B (a row at
B = 1 equals the same row at B = 4) and when a scan is split and continued
from its returned state.  The kernel re-checks the layout and refuses a
mismatch.

How the :class:`~repro_torch.core.schedule.ConcreteSchedule` maps onto the
kernel:

* ``tiles["T"]`` — a logical boundary only.  A CTA walks the whole
  sequence in stages of :data:`STAGE_T` tokens, whatever the tile: r, k, w
  and v of a stage are contiguous blocks, staged in shared memory by the
  copy engine (``cp.async.bulk``, a 3-stage ring), so the tensors must be
  16-byte aligned.  That loop takes the place of the TPU's sequential
  time-chunk grid axis, whose state lived in VMEM scratch.  A T tile of 1
  (a prime length under the default schedule) runs as fast as a tile of T.
* ``tiles["C"]`` — ignored, as the reference kernel ignores it (its grid is
  over batch·heads whatever the C tile).
* ``order``, ``parallel``, ``unroll``, ``vec`` — ignored (TPU compiler hints).

What bounds it on the card: the operations (7 f32 operations per state
element per token, on CUDA cores — there is no matrix product for the
tensor cores); the bytes are four D-vectors per token plus the state read
and written once.  Each token's state update is one FMA per element; the
sum for y is off that chain.

A tensor on the CPU takes the plain version (:func:`repro_torch.kernels.ref.rwkv6_scan`);
a CUDA tensor launches the kernel or raises.  ``launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.schedule import ConcreteSchedule
from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul import DTYPES

HEAD_DIMS = (16, 32, 64)
#: value columns of one (batch, head) state per CTA (csrc/rwkv6_scan.cu kWkvCtaCols)
CTA_COLS = 16
#: key rows of the state per thread (kWkvRows)
THREAD_ROWS = 8
#: tokens per shared-memory stage (kWkvStageT)
STAGE_T = 32

#: kernel launches since the last reset (a plain count; see chip_smoke.py)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def scan_geometry(b: int, h: int, t: int, d: int, tile_t: int) -> tuple[int, int, int, int]:
    """(cta_cols, key_split, stage_t, ctas) of a launch over (B, H, T, D)
    under a T tile of ``tile_t``: value columns per CTA, threads sharing a
    column (the key rows split D / :data:`THREAD_ROWS` ways), tokens per
    stage and the CTA count.  The layout depends on (B, H, D) alone, never
    on T or the T tile.  Raises ``ValueError`` on a shape the kernel does
    not take."""
    if d not in HEAD_DIMS:
        raise ValueError(f"rwkv6 scan kernel takes head dims {HEAD_DIMS}, got {d}")
    if min(b, h, t, tile_t) < 1:
        raise ValueError(f"rwkv6 scan needs B, H, T and the T tile >= 1, got {(b, h, t, tile_t)}")
    return CTA_COLS, d // THREAD_ROWS, STAGE_T, b * h * (d // CTA_COLS)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, state: torch.Tensor,
               cs: ConcreteSchedule) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, H, T, D); u: (H, D); state: (B, H, D, D) f32.

    Returns (y (B, H, T, D) in r's dtype, final state (B, H, D, D) f32)."""
    if r.device.type == "cpu":
        return ref.rwkv6_scan(r, k, v, w, u, state)
    return launch(r, k, v, w, u, state, cs)


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
           u: torch.Tensor, state: torch.Tensor,
           cs: ConcreteSchedule) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; raises on anything it does not take."""
    global launches
    if not r.is_cuda:
        raise ValueError(f"the rwkv6 scan kernel runs on a CUDA tensor, got {r.device}")
    if r.dtype not in DTYPES or any(x.dtype != r.dtype for x in (k, v, w)):
        raise ValueError(f"rwkv6 scan takes bf16 or f32 r/k/v/w of one dtype, "
                         f"got {r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}")
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"rwkv6 scan takes r/k/v/w of one shape (B,H,T,D), got "
                         f"{[tuple(x.shape) for x in (r, k, v, w)]}")
    b, h, t, d = r.shape
    cta_cols, split, stage_t, ctas = scan_geometry(b, h, t, d, cs.t["T"])
    if tuple(u.shape) != (h, d) or tuple(state.shape) != (b, h, d, d):
        raise ValueError(f"u must be {(h, d)} and state {(b, h, d, d)}, "
                         f"got {tuple(u.shape)}, {tuple(state.shape)}")
    if any(x.device != r.device for x in (k, v, w, u, state)):
        raise ValueError("rwkv6 scan takes every input on one device")
    if not all(x.is_contiguous() for x in (r, k, v, w)):
        raise ValueError("rwkv6 scan takes contiguous r, k, v and w")
    if any(x.data_ptr() % 16 for x in (r, k, v, w)):
        raise ValueError("rwkv6 scan takes 16-byte-aligned r, k, v and w (the copy engine reads them)")
    p = cs.instance.p
    if (cs.instance.class_id, p["T"], p["C"], p["D"], p["B"]) != ("rwkv6_scan", t, h * d, d, b):
        raise ValueError(f"schedule for {cs.instance} does not fit r {tuple(r.shape)}")
    # the reference reads u and the initial state into f32
    u32 = u.to(torch.float32).contiguous()
    s32 = state.to(torch.float32).contiguous()
    y = torch.empty_like(r)
    s_out = torch.empty_like(s32)
    lib = _build.library()
    rc = lib.repro_rwkv6_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u32.data_ptr(),
        s32.data_ptr(), y.data_ptr(), s_out.data_ptr(), b, h, t, d, DTYPES[r.dtype],
        cs.t["T"], cta_cols, split, stage_t, ctas, _build.stream_handle(r.device))
    _build.check(rc, "rwkv6 scan kernel")
    launches += 1
    return y, s_out
