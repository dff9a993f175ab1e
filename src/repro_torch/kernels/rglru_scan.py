"""RG-LRU recurrence (Griffin / RecurrentGemma): the CUDA kernel's wrapper.

Replaces the Pallas kernel ``src/repro/kernels/rglru_scan.py``
(``rglru_scan()`` → ``_kernel``; kernel K4).  The CUDA source is
``csrc/rglru_scan.cu``.  A diagonal linear recurrence,
``h = a⊙h + sqrt(max(1 − a², 0))⊙x``, with an f32 state, parallel over
channels and sequential over time.  x and a are bf16 or f32 (one dtype); the
state is f32; y comes back in x's dtype.

How the :class:`~repro_torch.core.schedule.ConcreteSchedule` maps onto the
kernel:

* ``tiles["C"]`` — the CTA's logical channel tile.  One CTA per (batch, C
  tile), one thread per channel, walked in blocks of at most 1024 threads;
  the ragged C edge is masked.
* ``tiles["T"]`` — not used: each thread streams its channel's x and a
  straight from device memory over the whole sequence (the TPU chunked time
  to fit VMEM; here there is nothing to share between threads).  y and the
  state are therefore identical across T tiles.
* ``order``, ``parallel``, ``unroll``, ``vec`` — ignored (TPU compiler hints).

What bounds it on the card: the bytes of x, a and y, read or written once
(~6 f32 operations per element are far below the CUDA cores' rate).  Loads
and stores are coalesced across neighbouring channels.  The default
512-channel tile gives 5 CTAs per batch row at recurrentgemma-2b's 2560
channels, which under-fills 132 SMs.

A tensor on the CPU takes the plain version (:func:`repro_torch.kernels.ref.rglru_scan`);
a CUDA tensor launches the kernel or raises.  ``launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.schedule import ConcreteSchedule
from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul import DTYPES

#: kernel launches since the last reset (a plain count; see chip_smoke.py)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def rglru_scan(x: torch.Tensor, a: torch.Tensor, state: torch.Tensor,
               cs: ConcreteSchedule) -> tuple[torch.Tensor, torch.Tensor]:
    """x, a: (B, T, C); state: (B, C) f32. Returns (y in x's dtype, final h f32)."""
    if x.device.type == "cpu":
        return ref.rglru_scan(x, a, state)
    return launch(x, a, state, cs)


def launch(x: torch.Tensor, a: torch.Tensor, state: torch.Tensor,
           cs: ConcreteSchedule) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; raises on anything it does not take."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"the RG-LRU scan kernel runs on a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPES or a.dtype != x.dtype:
        raise ValueError(f"RG-LRU scan takes bf16 or f32 x and a of one dtype, got {x.dtype}, {a.dtype}")
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"RG-LRU scan takes x and a of one shape (B,T,C), "
                         f"got {tuple(x.shape)}, {tuple(a.shape)}")
    b, t, c = x.shape
    if t < 1:
        raise ValueError("RG-LRU scan needs at least one token")
    if tuple(state.shape) != (b, c):
        raise ValueError(f"state must be {(b, c)}, got {tuple(state.shape)}")
    if a.device != x.device or state.device != x.device:
        raise ValueError("RG-LRU scan takes x, a and the state on one device")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("RG-LRU scan takes contiguous x and a")
    p = cs.instance.p
    if (cs.instance.class_id, p["T"], p["C"], p["B"]) != ("rglru_scan", t, c, b):
        raise ValueError(f"schedule for {cs.instance} does not fit x {tuple(x.shape)}")
    h0 = state.to(torch.float32).contiguous()   # the reference reads the state into f32
    y = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    lib = _build.library()
    rc = lib.repro_rglru_scan(x.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                              h_out.data_ptr(), b, t, c, DTYPES[x.dtype], cs.t["C"],
                              _build.stream_handle(x.device))
    _build.check(rc, "RG-LRU scan kernel")
    launches += 1
    return y, h_out
