"""Public kernel ops: schedule-resolving, backend-dispatching wrappers.

The models call these, with the reference's signatures and class ids
(``repro.kernels.ops``):

* ``backend="cuda"`` (the default) — resolve the :class:`ConcreteSchedule`
  for the kernel instance and call the kernel wrapper, which launches the
  CUDA kernel for a CUDA tensor (or raises) and takes the plain version only
  for a tensor that lies on the CPU;
* ``backend="ref"`` — the plain PyTorch versions, asked for explicitly (by
  ``chip_smoke.py``, to hold the kernels against them on the card).

Kernel instances are built exactly as in ``repro.kernels.ops`` (matmul:
``M`` = product of the leading dims, ``N``, ``K``; attention: ``Q``, ``KV``,
``H``, ``D``, ``B``, ``window``; rwkv6: ``T``, ``C`` = H·D, ``D``, ``B``;
rglru: ``T``, ``C``, ``B``), so workload keys match the reference.  This
slice resolves default schedules only; the resolution pipeline, registry and
tuning service come with a later slice.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading

import torch

from repro_torch.core.schedule import ConcreteSchedule, concretize, default_schedule
from repro_torch.core.workload import KernelInstance
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import rwkv6_scan as _rw

BACKENDS = ("cuda", "ref")
_state = threading.local()


def _default_backend() -> str:
    return getattr(_state, "backend", "cuda")


def set_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    _state.backend = backend


@contextlib.contextmanager
def use_backend(backend: str):
    prev = _default_backend()
    set_backend(backend)
    try:
        yield
    finally:
        set_backend(prev)


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's dtype string (``str`` of a jnp dtype): "bfloat16"..."""
    return str(dtype).removeprefix("torch.")


@functools.lru_cache(maxsize=8192)
def _interned(class_id: str, dtype: str,
              params: tuple[tuple[str, int], ...]) -> KernelInstance:
    return KernelInstance(class_id=class_id, params=params, dtype=dtype)


def instance(class_id: str, dtype: torch.dtype, **params: int) -> KernelInstance:
    return _interned(class_id, dtype_name(dtype),
                     tuple(sorted((k, int(v)) for k, v in params.items())))


@functools.lru_cache(maxsize=8192)
def schedule_for(inst: KernelInstance) -> ConcreteSchedule:
    """The schedule a kernel instance runs under (default schedules only)."""
    return concretize(default_schedule(inst), inst)


def matmul(x: torch.Tensor, w: torch.Tensor, *, class_id: str = "matmul",
           bias: torch.Tensor | None = None, residual: torch.Tensor | None = None,
           softcap: float = 0.0, backend: str | None = None) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) with fused epilogue. GLU classes emit N//2."""
    backend = backend or _default_backend()
    if backend == "ref":
        return ref.matmul(x, w, class_id, bias=bias, residual=residual, softcap=softcap)
    *lead, k = x.shape
    n = w.shape[1]
    m = math.prod(lead)
    x2 = x.reshape(m, k).contiguous()
    res2 = residual.reshape(m, -1).contiguous() if residual is not None else None
    cs = schedule_for(instance(class_id, x.dtype, M=m, N=n, K=k))
    y = _mm.matmul(x2, w.contiguous(), cs, class_id=class_id, bias=bias, residual=res2,
                   softcap=softcap)
    return y.reshape(*lead, y.shape[-1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    class_id: str = "flash_attention_causal",
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0, backend: str | None = None,
                    chunk: int = 1024) -> torch.Tensor:
    """q: (B,Hq,Sq,D); k/v: (B,Hkv,Skv,D) — GQA-aware flash attention."""
    backend = backend or _default_backend()
    if backend == "ref":
        return ref.chunked_attention(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_offset=q_offset, chunk=chunk)
    b, hq, sq, d = q.shape
    cs = schedule_for(instance(class_id, q.dtype, Q=sq, KV=k.shape[2], H=hq, D=d, B=b,
                               window=window))
    return _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), cs,
                               causal=causal, window=window, softcap=softcap,
                               q_offset=q_offset)


# ---------------------------------------------------------------------------
# recurrent scans
# ---------------------------------------------------------------------------


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, state: torch.Tensor, *,
          backend: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B,H,T,D); u: (H,D); state: (B,H,D,D) f32 -> (y, state)."""
    backend = backend or _default_backend()
    if backend == "ref":
        return ref.rwkv6_scan(r, k, v, w, u, state)
    b, h, t, d = r.shape
    cs = schedule_for(instance("rwkv6_scan", r.dtype, T=t, C=h * d, D=d, B=b))
    return _rw.rwkv6_scan(r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(),
                          u, state, cs)


def rglru(x: torch.Tensor, a: torch.Tensor, state: torch.Tensor, *,
          backend: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x, a: (B,T,C); state: (B,C) f32 -> (y, state)."""
    backend = backend or _default_backend()
    if backend == "ref":
        return ref.rglru_scan(x, a, state)
    b, t, c = x.shape
    cs = schedule_for(instance("rglru_scan", x.dtype, T=t, C=c, B=b))
    return _rg.rglru_scan(x.contiguous(), a.contiguous(), state, cs)
