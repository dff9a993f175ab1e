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
``M`` = product of the leading dims, ``N``, ``K``; grouped matmul: ``M`` =
rows per expert × ``E``, ``N``, ``K``, ``E``; attention: ``Q``, ``KV``,
``H``, ``D``, ``B``, ``window``; rwkv6: ``T``, ``C`` = H·D, ``D``, ``B``;
rglru: ``T``, ``C``, ``B``), so workload keys match the reference.

Under autograd (grad enabled and an input that requires it) a CUDA tensor
goes through the kernels' autograd Functions (:class:`~repro_torch.kernels.
matmul.MatmulFn` and ``GroupedMatmulFn``, :class:`~repro_torch.kernels.
flash_attention.FlashAttentionFn`, :class:`~repro_torch.kernels.rwkv6_scan.
Rwkv6ScanFn`, :class:`~repro_torch.kernels.rglru_scan.RglruScanFn`): the
forward is the launch an op makes without a gradient, bit for bit, and the
backward is kernels too, never a plain version.  A CPU tensor takes the
plain version, which torch's autograd differentiates; but K1 goes through
``MatmulFn`` on the CPU too (its launches there take the plain version), so
that the ``dots`` remat policy saves the same op on both devices.

Schedule resolution is the reference's: a :class:`ScheduleProvider` (a copy
of ``repro.kernels.ops.ScheduleProvider``) over a
:class:`~repro_torch.core.resolution.ResolutionPipeline` (service → static
map → default), consulting the active
:class:`~repro_torch.core.resolution.ExecutionPlan` first.  An op resolves
with the provider it is given, else the process default
(:func:`set_default_provider`; an all-defaults provider until one is
installed).  A plan hit is one dict lookup; an unplanned instance walks the
pipeline once and is then a memo hit.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Mapping

import torch

from repro_torch.core import resolution
from repro_torch.core.resolution import ExecutionPlan, ResolutionPipeline
from repro_torch.core.schedule import ConcreteSchedule, Schedule, concretize, default_schedule
from repro_torch.core.workload import KernelInstance
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import rwkv6_scan as _rw

BACKENDS = ("cuda", "ref")
_state = threading.local()


def current_backend() -> str:
    """This thread's backend: ``"cuda"`` unless set otherwise."""
    return getattr(_state, "backend", "cuda")


def set_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    _state.backend = backend


@contextlib.contextmanager
def use_backend(backend: str):
    prev = current_backend()
    set_backend(backend)
    try:
        yield
    finally:
        set_backend(prev)


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's dtype string (``str`` of a jnp dtype): "bfloat16"..."""
    return str(dtype).removeprefix("torch.")


class ScheduleProvider:
    """Resolves the schedule for each kernel instance the model emits.

    A thin facade over a :class:`ResolutionPipeline` plus an optional active
    :class:`ExecutionPlan`:

    * ``plan`` (when set) answers first — pre-resolved dict hit;
    * the pipeline walks service → static map → default on plan misses and
      memoizes per ``(workload, mode, target, generation)``.

    Construct either from the legacy pieces (``schedule_map`` and/or
    ``service``) or from an explicit ``pipeline``.  Invalid entries (e.g. a
    transferred schedule that does not concretize strictly) fall through to
    the next stage — execution never fails on a bad DB.

    Per-tier lookup counts (``exact``/``transfer``/``static``/``default``)
    live in the pipeline and are thread-safe; a service answer of the
    untuned-default tier is *not* a hit.  ``hits``/``misses`` remain as
    derived compatibility properties.
    """

    def __init__(self, schedule_map: Mapping[str, Schedule] | None = None,
                 mode: str = "strict", service=None, *,
                 pipeline: ResolutionPipeline | None = None,
                 plan: ExecutionPlan | None = None, target=None):
        if pipeline is None:
            pipeline = ResolutionPipeline.build(
                schedule_map=schedule_map, service=service, mode=mode,
                target=target)
        self.pipeline = pipeline
        self.plan = plan
        self._lock = threading.Lock()
        # Plan answers bucketed by tier (a default-tier plan entry is still
        # an untuned kernel — it must not masquerade as a hit), plus misses
        # (instances the plan does not cover, served by the pipeline) so
        # coverage gaps are observable.
        self._plan_served = {t: 0 for t in resolution.TIERS}
        self._plan_misses = 0

    @property
    def mode(self) -> str:
        return self.pipeline.mode

    @property
    def service(self):
        return self.pipeline.service

    @property
    def schedule_map(self) -> dict[str, Schedule]:
        return self.pipeline.schedule_map

    def get(self, instance: KernelInstance) -> ConcreteSchedule:
        plan = self.plan
        if plan is not None:
            r = plan.lookup(instance)
            if r is not None:
                with self._lock:
                    self._plan_served[r.tier] += 1
                return r.concrete
            with self._lock:
                self._plan_misses += 1
        return self.pipeline.resolve(instance).concrete

    # -- telemetry ------------------------------------------------------------
    @property
    def plan_hits(self) -> int:
        """Total resolutions the active plan answered (any tier)."""
        with self._lock:
            return sum(self._plan_served.values())

    def stats(self) -> dict:
        out = self.pipeline.stats()
        with self._lock:
            out["plan_served"] = dict(self._plan_served)
            out["plan_misses"] = self._plan_misses
        out["plan_hits"] = sum(out["plan_served"].values())
        out["plan_entries"] = len(self.plan) if self.plan is not None else 0
        out["plan_generation"] = (self.plan.generation
                                  if self.plan is not None else None)
        return out

    # Legacy counters: tuned-tier resolutions count as hits, untuned as
    # misses (regardless of whether the plan or the pipeline served them).
    @property
    def hits(self) -> int:
        s = self.stats()
        return sum(s["plan_served"][t] + s[f"served_{t}"]
                   for t in ("exact", "transfer", "static"))

    @property
    def misses(self) -> int:
        s = self.stats()
        return s["plan_served"]["default"] + s["served_default"]


_DEFAULT_PROVIDER = ScheduleProvider()


def set_default_provider(provider: ScheduleProvider | None) -> ScheduleProvider:
    """Install the provider kernels use when no explicit one is passed.

    Returns the previous default so callers can restore it.  ``None``
    reinstalls an empty (all-defaults) provider."""
    global _DEFAULT_PROVIDER
    prev = _DEFAULT_PROVIDER
    _DEFAULT_PROVIDER = provider if provider is not None else ScheduleProvider()
    return prev


def _resolve(provider: ScheduleProvider | None) -> ScheduleProvider:
    return provider if provider is not None else _DEFAULT_PROVIDER


@functools.lru_cache(maxsize=8192)
def _interned(class_id: str, dtype: str,
              params: tuple[tuple[str, int], ...]) -> KernelInstance:
    return KernelInstance(class_id=class_id, params=params, dtype=dtype)


def instance(class_id: str, dtype: torch.dtype, **params: int) -> KernelInstance:
    return _interned(class_id, dtype_name(dtype),
                     tuple(sorted((k, int(v)) for k, v in params.items())))


def schedule_for(inst: KernelInstance) -> ConcreteSchedule:
    """The default schedule of a kernel instance, concretized: what an op
    runs where no plan, service or static map answers."""
    return concretize(default_schedule(inst), inst)


def _needs_grad(*tensors: torch.Tensor | None) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def matmul(x: torch.Tensor, w: torch.Tensor, *, class_id: str = "matmul",
           bias: torch.Tensor | None = None, residual: torch.Tensor | None = None,
           softcap: float = 0.0, provider: ScheduleProvider | None = None,
           backend: str | None = None,
           transpose_of: torch.Tensor | None = None, out_f32: bool = False) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) with fused epilogue. GLU classes emit N//2.

    ``transpose_of``: the (N, K) tensor ``w`` is a contiguous transposed
    copy of (a tied LM head: ``w`` is ``embed_t``, this is ``embed``).
    Without a gradient it is not read.  Under autograd the gradient of
    ``w`` goes to it, as ``jax.grad`` of ``embed.T`` gives it.

    ``out_f32``: the result in f32, unrounded (a row-parallel product's
    partial sums).  An f32 ``x`` beside a bf16 ``w`` is a carrier of bf16
    values (``distributed.context``): the product reads those values and,
    under autograd, ``x``'s gradient comes back in f32
    (:class:`~repro_torch.kernels.matmul.MatmulFn`); a ``w`` marked
    ``bf16_carrier`` likewise."""
    backend = backend or current_backend()
    grad = _needs_grad(x, w, bias, residual, transpose_of)
    w_carrier = getattr(w, "bf16_carrier", False)
    if w_carrier and not grad:
        w, w_carrier = _mm.carried(w, torch.bfloat16), False
    if x.dtype != w.dtype and not grad and not w_carrier:
        x = _mm.carried(x, w.dtype)
    tied = grad and transpose_of is not None
    if tied and (backend == "ref" or not x.is_cuda):
        w, tied = transpose_of.T, False     # plain autograd carries it to transpose_of
    if backend == "ref":
        if w_carrier:
            w = _mm.carried(w, torch.bfloat16)
        if x.dtype != w.dtype:
            x = _mm.carried(x, w.dtype)
        return ref.matmul(x, w, class_id, bias=bias, residual=residual, softcap=softcap,
                          **({"out_f32": True} if out_f32 else {}))
    *lead, k = x.shape
    n = w.shape[1]
    m = math.prod(lead)
    x2 = x.reshape(m, k).contiguous()
    res2 = residual.reshape(m, -1).contiguous() if residual is not None else None
    dtype = torch.bfloat16 if w_carrier else w.dtype
    cs = _resolve(provider).get(instance(class_id, dtype, M=m, N=n, K=k))
    if grad:
        y = _mm.MatmulFn.apply(x2, w.contiguous(), transpose_of if tied else None, bias, res2,
                               cs, class_id, softcap, out_f32, w_carrier)
    else:
        y = _mm.matmul(x2, w.contiguous(), cs, class_id=class_id, bias=bias, residual=res2,
                       softcap=softcap, out_f32=out_f32)
    return y.reshape(*lead, y.shape[-1])


def moe_gemm(x: torch.Tensor, w: torch.Tensor, *, class_id: str = "moe_gemm",
             provider: ScheduleProvider | None = None,
             backend: str | None = None, out_f32: bool = False) -> torch.Tensor:
    """Grouped expert GEMM: x (E, M, K) @ w (E, K, N).  ``out_f32`` and an
    f32 carrier ``x``: as :func:`matmul`'s."""
    backend = backend or current_backend()
    grad = _needs_grad(x, w)
    if x.dtype != w.dtype and (backend == "ref" or not grad):
        x = _mm.carried(x, w.dtype)
    if backend == "ref":
        return ref.grouped_matmul(x, w, class_id, **({"out_f32": True} if out_f32 else {}))
    e, m, k = x.shape
    n = w.shape[2]
    cs = _resolve(provider).get(instance(class_id, w.dtype, M=m * e, N=n, K=k, E=e))
    if grad and (x.is_cuda or x.dtype != w.dtype or out_f32):
        return _mm.GroupedMatmulFn.apply(x.contiguous(), w.contiguous(), cs, class_id, out_f32)
    return _mm.grouped_matmul(x.contiguous(), w.contiguous(), cs, class_id=class_id,
                              out_f32=out_f32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    class_id: str = "flash_attention_causal",
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0, provider: ScheduleProvider | None = None,
                    backend: str | None = None, chunk: int = 1024,
                    with_lse: bool = False):
    """q: (B,Hq,Sq,D); k/v: (B,Hkv,Skv,D) — GQA-aware flash attention.
    ``with_lse`` (no gradient): (output, each row's log-sum-exp (B,Hq,Sq)
    f32), for a softmax merged over blocks of the keys."""
    backend = backend or current_backend()
    if backend == "ref":
        out = ref.chunked_attention(q, k, v, causal=causal, window=window,
                                    softcap=softcap, q_offset=q_offset, chunk=chunk)
        if not with_lse:
            return out
        return out, ref.attention_lse(q, k, causal=causal, window=window, softcap=softcap,
                                      q_offset=q_offset)
    b, hq, sq, d = q.shape
    cs = _resolve(provider).get(instance(class_id, q.dtype, Q=sq, KV=k.shape[2], H=hq, D=d,
                                         B=b, window=window))
    if q.is_cuda and _needs_grad(q, k, v):
        if q_offset:
            raise ValueError(f"attention under autograd takes q_offset 0 (training), got {q_offset}")
        return _fa.FlashAttentionFn.apply(q.contiguous(), k.contiguous(), v.contiguous(), cs,
                                          causal, window, softcap)
    return _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), cs,
                               causal=causal, window=window, softcap=softcap,
                               q_offset=q_offset, with_lse=with_lse)


# ---------------------------------------------------------------------------
# recurrent scans
# ---------------------------------------------------------------------------


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, state: torch.Tensor, *, provider: ScheduleProvider | None = None,
          backend: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B,H,T,D); u: (H,D); state: (B,H,D,D) f32 -> (y, state)."""
    backend = backend or current_backend()
    if backend == "ref":
        return ref.rwkv6_scan(r, k, v, w, u, state)
    b, h, t, d = r.shape
    cs = _resolve(provider).get(instance("rwkv6_scan", r.dtype, T=t, C=h * d, D=d, B=b))
    r, k, v, w = (a.contiguous() for a in (r, k, v, w))
    if r.is_cuda and _needs_grad(r, k, v, w, u, state):
        return _rw.Rwkv6ScanFn.apply(r, k, v, w, u, state, cs)
    return _rw.rwkv6_scan(r, k, v, w, u, state, cs)


def rglru(x: torch.Tensor, a: torch.Tensor, state: torch.Tensor, *,
          provider: ScheduleProvider | None = None,
          backend: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x, a: (B,T,C); state: (B,C) f32 -> (y, state)."""
    backend = backend or current_backend()
    if backend == "ref":
        return ref.rglru_scan(x, a, state)
    b, t, c = x.shape
    cs = _resolve(provider).get(instance("rglru_scan", x.dtype, T=t, C=c, B=b))
    if x.is_cuda and _needs_grad(x, a, state):
        return _rg.RglruScanFn.apply(x.contiguous(), a.contiguous(), state, cs)
    return _rg.rglru_scan(x.contiguous(), a.contiguous(), state, cs)
