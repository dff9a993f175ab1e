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
body and dtype, ``class_launches`` per kernel class (the schedule's instance:
``flash_attention_causal``, ``_bidir``, ``_cross``, ...) and body.

The gradient is :func:`launch_bwd`: dQ, dK and dV from q, k, v, the
forward's output, its row log-sum-exp and the output's gradient, by the
backward kernels of ``csrc/flash_attention_bwd.cu`` (a dq kernel, then a
dkv kernel, then for a split GQA group a kernel adding its parts; one C
call: one launch in ``bwd_launches``, and one in ``bwd_body_launches`` by
body and dtype).  Its bodies follow :func:`body_for` as the forward's do:
``mma`` (bf16, the five products on the tensor cores) and ``fma`` (f32,
CUDA cores); :func:`bwd_geometry` gives a launch's layout and CTAs, and
:func:`bwd_library_geometry` the CTAs and shared bytes the library launches.
It takes what training gives the forward (causal or not, window, softcap,
GQA, Sq ≠ Skv, D up to 256, bf16 and f32) at ``q_offset`` 0, and no
schedule: the reference keys no backward instance, so its tiles are its
own.  :class:`FlashAttentionFn` enters it under autograd: its forward asks
:func:`launch` for the row log-sum-exp (``with_lse``; the output's bits do
not change) and saves it.  The plain version of the gradient is autograd
through :func:`~repro_torch.kernels.ref.chunked_attention`
(:func:`~repro_torch.kernels.ref.chunked_attention_bwd`), which a tensor on
the CPU takes by torch's own autograd; that of the log-sum-exp is
:func:`~repro_torch.kernels.ref.attention_lse`.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.core.schedule import ConcreteSchedule
from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul import DTYPES

MAX_HEAD_DIM = 256
#: query rows of one CTA of the mma body (csrc/flash_attention.cu kMmaBQ)
MMA_CTA_Q = 64

#: kernel launches since the last reset (plain counts; see chip_smoke.py):
#: ``launches`` of :func:`launch`, ``body_launches`` by (body, dtype),
#: ``offset_launches`` with ``q_offset`` > 0 (chunked prefill),
#: ``row_tile_launches`` with 1-row Q tiles over Sq > 1 rows (a prime
#: length's default) and ``class_launches`` by (class id, body)
launches = 0
offset_launches = 0
row_tile_launches = 0
body_launches: collections.Counter = collections.Counter()
class_launches: collections.Counter = collections.Counter()
#: launches of the backward kernels (:func:`launch_bwd`) since the last
#: reset, and by (body, dtype)
bwd_launches = 0
bwd_body_launches: collections.Counter = collections.Counter()

#: the backward's mma body: query rows (dq kernel) and keys (dkv kernel) per
#: CTA (csrc/flash_attention_bwd.cu kBwdMmaRows)
BWD_CTA_ROWS = 64
#: dkv CTAs a launch aims for (two for each of the H100's 132 SMs, rounded):
#: below it a GQA group is split between CTAs
BWD_FILL = 256
#: the backward's fma body: rows (dq) or keys (dkv) per CTA
BWD_FMA_ROWS = 16


def reset_launches() -> None:
    """Set every count to 0."""
    global launches, offset_launches, row_tile_launches, bwd_launches
    launches = offset_launches = row_tile_launches = bwd_launches = 0
    body_launches.clear()
    class_launches.clear()
    bwd_body_launches.clear()


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
           scale: float | None = None,
           with_lse: bool = False) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; raises on anything it does not take.  With
    ``with_lse``, returns (output, each row's log-sum-exp (B, Hq, Sq) f32);
    the output's bits are the same either way."""
    global launches, offset_launches, row_tile_launches
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
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    body, cta_q, ctas = attention_geometry(q.dtype, sq, cs.t["Q"])
    lib = _build.library()
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, b, hq, hkv, sq, skv, d, DTYPES[q.dtype], int(causal), int(window), float(softcap),
        int(q_offset), float(scale), cs.t["Q"], cta_q, ctas, _build.stream_handle(q.device))
    _build.check(rc, "flash-attention kernel")
    launches += 1
    offset_launches += q_offset > 0
    row_tile_launches += cs.t["Q"] == 1 < sq
    body_launches[body, q.dtype] += 1
    class_launches[cs.instance.class_id, body] += 1
    return (out, lse) if with_lse else out


class FlashAttentionFn(torch.autograd.Function):
    """K2 under autograd on CUDA tensors (``q_offset`` 0): :func:`launch`
    forward with the row log-sum-exp (the same output bits as without a
    gradient), :func:`launch_bwd` backward on the saved q, k, v, output and
    log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, cs, causal, window, softcap):
        o, lse = launch(q, k, v, cs, causal=causal, window=window, softcap=softcap, with_lse=True)
        ctx.args = dict(causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*launch_bwd(q, k, v, o, lse, do.contiguous(), **ctx.args), None, None, None, None)


def bwd_geometry(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
                 dtype: torch.dtype) -> dict:
    """The backward's launch over q (B, Hq, Sq, D) and k/v (B, Hkv, Skv, D):
    its body (:func:`body_for`), ``parts`` (CTAs sharing a GQA group's query
    heads, their dK and dV added in part order by a third kernel),
    ``col_blocks`` (CTAs sharing dK's and dV's columns) and the CTAs of the
    dq and dkv kernels.  The mma body takes :data:`BWD_CTA_ROWS` rows (dq)
    or keys (dkv) a CTA, splits D = 256's columns in two, and splits the
    group into the fewest parts (a divisor of the group) that give
    :data:`BWD_FILL` dkv CTAs, or into its heads.  The fma body runs a CTA
    per 16 rows or keys and walks the group in one CTA.  ``parts`` sizes
    the workspace and goes to the kernel, which plans its own launch from
    it (:func:`bwd_library_geometry` reports that plan; chip_smoke.py holds
    these CTAs to it).  Raises ``ValueError`` on a shape the kernels do not
    take."""
    if min(b, hq, hkv, sq, skv, d) < 1:
        raise ValueError(f"the attention backward needs every dim >= 1, got {(b, hq, hkv, sq, skv, d)}")
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq}, {hkv}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the attention backward takes head dims up to {MAX_HEAD_DIM}, got {d}")
    body, group = body_for(dtype), hq // hkv
    if body == "fma":
        if b * hq > 65535:
            raise ValueError(f"the fma backward takes B * Hq up to 65535 (grid.y), got {b * hq}")
        return {"body": body, "parts": 1, "col_blocks": 1,
                "dq_ctas": -(-sq // BWD_FMA_ROWS) * b * hq, "dkv_ctas": -(-skv // BWD_FMA_ROWS) * b * hkv}
    col_blocks = 2 if d > 128 else 1
    base = -(-skv // BWD_CTA_ROWS) * col_blocks * b * hkv
    parts = next(p for p in range(1, group + 1) if group % p == 0 and (base * p >= BWD_FILL or p == group))
    return {"body": body, "parts": parts, "col_blocks": col_blocks,
            "dq_ctas": -(-sq // BWD_CTA_ROWS) * b * hq, "dkv_ctas": base * parts}


def bwd_library_geometry(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
                         dtype: torch.dtype) -> dict:
    """What the backward kernels launch over these shapes, as the built
    library plans it (csrc/flash_attention_bwd.cu ``plan_bwd``) at
    :func:`bwd_geometry`'s ``parts``: each kernel's CTAs (``dq_ctas``,
    ``dkv_ctas``) and dynamic shared bytes (``dq_smem``, ``dkv_smem``).
    Launches nothing; needs the CUDA build."""
    geo = bwd_geometry(b, hq, hkv, sq, skv, d, dtype)
    out = (ctypes.c_int * 4)()
    rc = _build.library().repro_flash_attention_bwd_geometry(
        b, hq, hkv, sq, skv, d, DTYPES[dtype], geo["parts"], out)
    _build.check(rc, "attention backward geometry")
    return dict(zip(("dq_ctas", "dkv_ctas", "dq_smem", "dkv_smem"), out))


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
               lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True, window: int = 0,
               softcap: float = 0.0, q_offset: int = 0,
               scale: float | None = None) -> tuple[torch.Tensor, ...]:
    """Launch the backward kernels at the forward's output ``o`` and row
    log-sum-exp ``lse`` (:func:`launch` ``with_lse``); raises on anything
    they do not take."""
    global bwd_launches
    if not q.is_cuda:
        raise ValueError(f"the attention backward kernel runs on a CUDA tensor, got {q.device}")
    if q_offset != 0:
        raise ValueError(f"the attention backward kernel takes q_offset 0 (training), got {q_offset}")
    ts = (q, k, v, o, do)
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"the attention backward takes bf16 or f32 tensors of one dtype, "
                         f"got {[t.dtype for t in ts]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"the attention backward takes q/o/do (B,Hq,Sq,D) and k/v (B,Hkv,Skv,D), "
                         f"got {[tuple(t.shape) for t in ts]}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} (GQA needs Hq % Hkv == 0)")
    geo = bwd_geometry(b, hq, hkv, sq, skv, d, q.dtype)
    if any(t.device != q.device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("the attention backward takes contiguous tensors on one device")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq) or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be the forward's contiguous (B, Hq, Sq) f32 log-sum-exp, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    scale = scale if scale is not None else d ** -0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # rowsum(dO * O), written by the dq kernel and read by the dkv kernel;
    # a split group's f32 dK and dV per part
    delta = torch.empty_like(lse)
    parts = geo["parts"]
    ws = (torch.empty((2, parts, b * hkv * skv * d), dtype=torch.float32, device=q.device)
          if parts > 1 else None)
    rc = _build.library().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        ws.data_ptr() if ws is not None else None, b, hq, hkv, sq, skv, d,
        DTYPES[q.dtype], int(causal), int(window), float(softcap), float(scale), parts,
        _build.stream_handle(q.device))
    _build.check(rc, "attention backward kernel")
    bwd_launches += 1
    bwd_body_launches[geo["body"], q.dtype] += 1
    return dq, dk, dv
