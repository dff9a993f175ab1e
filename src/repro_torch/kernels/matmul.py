"""Schedule-driven matmul with fused epilogues: the CUDA kernel's wrapper.

Replaces the Pallas kernel ``src/repro/kernels/matmul.py`` (``matmul()`` →
``build_call`` → ``_kernel``; kernel K1).  The CUDA source is
``csrc/matmul.cu``.  ``out = epilogue(x (M,K) @ w (K,N))`` for every
non-grouped class of the matmul family: ``matmul``, ``matmul_bias``,
``matmul_lmhead``, ``moe_router`` (no epilogue), ``matmul_bias_gelu`` (tanh
gelu), ``matmul_silu_glu`` / ``matmul_gelu_glu`` (interleaved GLU, emits N/2
columns), ``matmul_residual`` and ``matmul_lmhead_softcap``.  bf16 and f32.

How the :class:`~repro_torch.core.schedule.ConcreteSchedule` maps onto the
kernel:

* ``tiles["M"]``, ``tiles["N"]`` — the CTA's logical output tile.  One CTA per
  tile; it walks the tile in sub-blocks that fit its registers and shared
  memory (64x64 when the M tile is above 16 rows, 4-row passes of 256 bf16 /
  128 f32 columns below).
* ``order`` — tile rasterisation: the CTA index walks the inner of M and N
  fastest.
* ``tiles["K"]`` — not used: the kernel sums the whole K range of a tile in
  one f32 accumulator (16-deep shared-memory steps, or streamed).
* ``cache_write`` — always on in effect: the accumulator is f32.  With
  ``cache_write=False`` (or K not innermost) the reference rounds partial sums
  to the output dtype at every K step; the kernel does not, so it matches the
  reference under the default schedule, which takes the f32-scratch path.
* ``parallel``, ``unroll``, ``vec`` — ignored (TPU compiler hints).

What bounds it on the card: the bytes of ``w`` at decode (M = slots) and
up to a few hundred rows (the H100 does ~295 bf16 tensor-core operations per
byte of HBM, so a (K,N) weight read once is the larger cost while M is below
~300); the operations above that.  The kernel streams ``w`` once per row pass,
16 bytes a lane, and runs the operations as CUDA-core FMA (no tensor cores
yet, so far below either bound).

A tensor on the CPU takes the plain version (:func:`repro_torch.kernels.ref.matmul`);
a CUDA tensor launches the kernel or raises.  ``launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.schedule import GLU_CLASSES, ConcreteSchedule
from repro_torch.kernels import _build, ref

#: class_id -> epilogue code of csrc/matmul.cu
EPILOGUE = {"matmul": 0, "matmul_bias": 0, "matmul_lmhead": 0, "moe_router": 0,
            "matmul_bias_gelu": 1, "matmul_silu_glu": 2, "matmul_gelu_glu": 3,
            "matmul_residual": 4, "matmul_lmhead_softcap": 5}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (a plain count; see chip_smoke.py)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def matmul(x: torch.Tensor, w: torch.Tensor, cs: ConcreteSchedule, *,
           class_id: str = "matmul", bias: torch.Tensor | None = None,
           residual: torch.Tensor | None = None, softcap: float = 0.0) -> torch.Tensor:
    """x (M,K) @ w (K,N) with the class's fused epilogue -> (M, N or N/2)."""
    if x.device.type == "cpu":
        return ref.matmul(x, w, class_id, bias=bias, residual=residual, softcap=softcap)
    return launch(x, w, cs, class_id=class_id, bias=bias, residual=residual, softcap=softcap)


def launch(x: torch.Tensor, w: torch.Tensor, cs: ConcreteSchedule, *,
           class_id: str = "matmul", bias: torch.Tensor | None = None,
           residual: torch.Tensor | None = None, softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    global launches
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
    tile_m, tile_n = cs.t["M"], cs.t["N"]
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
    order = [a for a in cs.order if a in ("M", "N")]
    lib = _build.library()
    rc = lib.repro_matmul(
        x.data_ptr(), w.data_ptr(),
        bias32.data_ptr() if bias32 is not None else None,
        res32.data_ptr() if res32 is not None else None,
        out.data_ptr(), m, n, k, DTYPES[x.dtype], EPILOGUE[class_id], float(softcap),
        tile_m, tile_n, int(order[0] == "M"), _build.stream_handle(x.device))
    _build.check(rc, "matmul kernel")
    launches += 1
    return out
