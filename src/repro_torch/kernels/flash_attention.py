"""GQA flash attention: the CUDA kernel's wrapper.

Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention()`` → ``_kernel``; kernel K2).  The CUDA source is
``csrc/flash_attention.cu``.  Online-softmax attention with causal,
sliding-window, logit-softcap, ``q_offset`` and KV-padding masks, GQA, and
ragged Sq / Skv; bf16 and f32.  Any head dim up to 256 runs — 128 for
minitron and mixtral, 256 for gemma2 and recurrentgemma, 16 for the reduced
test configs (the kernel works in the next compiled width and zero-pads); a
larger one raises ``ValueError``.

Two bodies, by a dtype rule (:func:`body_for`), like the matmul's:

* **mma** (bf16): FlashAttention-2 on the tensor cores, ``mma.sync``
  m16n8k16 bf16 → f32 for S = Q·Kᵀ and O += P·V, the online softmax on the
  f32 S fragment in registers.  A CTA holds :data:`MMA_CTA_Q` query rows
  (16 per warp) and streams K and V in chunks of 64 keys (32 at D = 256)
  through a double-buffered ``cp.async`` ring.  It applies ``scale`` to S after the
  product (the reference scales q before it) and feeds P to the second
  product in bf16: both stay inside the bf16 tolerance.
* **fma** (f32): the CUDA-core body, one CTA per logical Q tile walked in
  32-row sub-blocks, chunks of 32 keys.  TF32 would break the f32
  tolerance of 2e-4, so f32 stays off the tensor cores.

How the :class:`~repro_torch.core.schedule.ConcreteSchedule` maps onto the
kernel:

* ``tiles["Q"]`` — the logical query tile, the unit of masking.  The mma
  body covers each logical tile with ceil(min(tile, Sq) / 64) CTAs that
  never cross its edge (:func:`attention_geometry`); the CTAs of the last
  row blocks, the heaviest under a causal mask, are launched first.  The
  fma body runs one CTA per logical tile.
* ``tiles["KV"]`` — not used as a block size: each CTA loops over its whole
  live KV range itself, in chunks that start at global multiples of the
  chunk, skipping chunks its rows all mask.  That loop takes the place of
  the TPU's sequential KV grid axis (CTAs run in no order, so the softmax
  state cannot be carried between them).  A row's result does not depend
  on which CTA holds it, or on how a prompt is split between calls by
  ``q_offset``.
* ``order`` — the reference canonicalises to KV-inner; so does the kernel.
* ``parallel``, ``unroll``, ``vec`` — ignored (TPU compiler hints).

What bounds it on the card: at the served prefill lengths (S ≤ 512) the
bytes of q, k, v and the output, read and written once, with the
operations (4·Sq·Skv·D per head, halved by the causal skip) close behind;
the operations grow as S² and set the bound for longer prompts.

A tensor on the CPU takes the plain version
(:func:`repro_torch.kernels.ref.chunked_attention`, the online-softmax oracle
that, like the kernel, leaves fully masked rows at 0); a CUDA tensor launches
the kernel or raises.  ``launches`` counts launches, ``body_launches`` per
body and dtype.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.core.schedule import ConcreteSchedule
from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul import DTYPES

MAX_HEAD_DIM = 256
#: query rows of one CTA of the mma body (csrc/flash_attention.cu kMmaBQ)
MMA_CTA_Q = 64

#: kernel launches since the last reset (plain counts; see chip_smoke.py):
#: ``launches`` of :func:`launch`, ``body_launches`` by (body, dtype)
launches = 0
body_launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    """Set every count to 0."""
    global launches
    launches = 0
    body_launches.clear()


def body_count(body: str | None = None, *, dtype: torch.dtype | None = None) -> int:
    """Launches since the last reset of ``body`` (any if None), of one dtype where given."""
    return sum(c for (b, d), c in body_launches.items() if body in (None, b) and dtype in (None, d))


def body_for(dtype: torch.dtype) -> str:
    """The kernel body a launch takes: ``mma`` (tensor cores) for bf16,
    ``fma`` (CUDA cores) for f32."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def attention_geometry(dtype: torch.dtype, sq: int, tile_q: int) -> tuple[str, int, int]:
    """(body, cta_q, ctas) of a launch, CTAs per (batch, head): the mma body
    covers each logical Q tile with ceil(min(tile_q, sq) / :data:`MMA_CTA_Q`)
    CTAs of :data:`MMA_CTA_Q` rows, masked at the tile's edge (a ragged last
    tile may leave some empty); the fma body runs one CTA per logical tile.
    The kernel re-checks it and refuses a mismatch."""
    body = body_for(dtype)
    tiles = -(-sq // tile_q)
    if body == "mma":
        return body, MMA_CTA_Q, tiles * -(-min(tile_q, sq) // MMA_CTA_Q)
    return body, tile_q, tiles


def schedule_key(cs: ConcreteSchedule) -> tuple[int]:
    """What a launch reads of a concrete schedule: the Q tile.  The KV tile,
    ``order``, ``parallel``, ``unroll``, ``vec`` and ``cache_write`` reach no
    launch."""
    return (cs.t["Q"],)


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
    body, cta_q, ctas = attention_geometry(q.dtype, sq, cs.t["Q"])
    lib = _build.library()
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, sq, skv, d, DTYPES[q.dtype], int(causal), int(window), float(softcap),
        int(q_offset), float(scale), cs.t["Q"], cta_q, ctas, _build.stream_handle(q.device))
    _build.check(rc, "flash-attention kernel")
    launches += 1
    body_launches[body, q.dtype] += 1
    return out
