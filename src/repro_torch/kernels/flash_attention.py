"""GQA flash attention: the CUDA kernel's wrapper.

Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention()`` → ``_kernel``; kernel K2).  The CUDA source is
``csrc/flash_attention.cu``.  Online-softmax attention with causal,
sliding-window, logit-softcap, ``q_offset`` and KV-padding masks, GQA, and
ragged Sq / Skv; bf16 and f32.  Any head dim up to 256 runs — 128 for
minitron, 256 for gemma2, 16 for the reduced test configs (the kernel works
in the next of 32, 64, 128, 256 and zero-pads); a larger one raises
``ValueError``.

How the :class:`~repro_torch.core.schedule.ConcreteSchedule` maps onto the
kernel:

* ``tiles["Q"]`` — the CTA's logical query tile.  One CTA per
  (batch·q_head, Q tile); it walks the tile in sub-blocks of 32 rows.
* ``tiles["KV"]`` — not used as a block size: the CTA loops over the whole
  live KV range itself in chunks of 32 keys.  That loop takes the place of the
  TPU's sequential KV grid axis (CTAs run in no order, so the softmax state
  cannot be carried between them).
* ``order`` — the reference canonicalises to KV-inner; so does the kernel.
* ``parallel``, ``unroll``, ``vec`` — ignored (TPU compiler hints).

What bounds it on the card: at minitron's prefill lengths (S <= 512) the
bytes of q, k, v and the output, read and written once, with the operations
(4·Sq·Skv·D per head, halved by the causal skip) close behind; the
operations grow as S² and set the bound for longer prompts.  The kernel
re-reads k and v from L2 for every 32-row query sub-block and runs the
operations as CUDA-core FMA on f32 copies in shared memory (no tensor cores
yet).

A tensor on the CPU takes the plain version
(:func:`repro_torch.kernels.ref.chunked_attention`, the online-softmax oracle
that, like the kernel, leaves fully masked rows at 0); a CUDA tensor launches
the kernel or raises.  ``launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.schedule import ConcreteSchedule
from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul import DTYPES

MAX_HEAD_DIM = 256

#: kernel launches since the last reset (a plain count; see chip_smoke.py)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cs: ConcreteSchedule, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D). Returns (B, Hq, Sq, D)."""
    if q.device.type == "cpu":
        return ref.chunked_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                                     q_offset=q_offset, chunk=cs.t["KV"], scale=scale)
    return launch(q, k, v, cs, causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset, scale=scale)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cs: ConcreteSchedule, *,
           causal: bool = True, window: int = 0, softcap: float = 0.0, q_offset: int = 0,
           scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    global launches
    if not q.is_cuda:
        raise ValueError(f"the flash-attention kernel runs on a CUDA tensor, got {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes bf16 or f32 q/k/v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention takes q (B,Hq,Sq,D) and k/v (B,Hkv,Skv,D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} (GQA needs Hq % Hkv == 0)")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash-attention kernel takes head dims up to {MAX_HEAD_DIM}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention takes contiguous q, k and v")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash attention takes q, k and v on one device")
    p = cs.instance.p
    if (p["Q"], p["KV"], p["H"], p["D"], p["B"]) != (sq, skv, hq, d, b):
        raise ValueError(f"schedule for {cs.instance} does not fit q {tuple(q.shape)}, k {tuple(k.shape)}")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    lib = _build.library()
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, sq, skv, d, DTYPES[q.dtype], int(causal), int(window), float(softcap),
        int(q_offset), float(scale), cs.t["Q"], _build.stream_handle(q.device))
    _build.check(rc, "flash-attention kernel")
    launches += 1
    return out
