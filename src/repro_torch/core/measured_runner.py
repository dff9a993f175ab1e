"""A runner that times schedules with the port's CUDA kernels on the card.

The reference measures nothing: its runners wrap the analytical TPU cost
model (:class:`~repro_torch.core.runner.AnalyticalRunner`), because the JAX
package never had its chip.  :class:`MeasuredRunner` answers the same
question, ``measure(instance, schedule)``, by launching the port's kernel at
the instance's shape under the concretized schedule and timing it on the
card, so the tuning stack (``tune_kernel``, ``tune_model``,
``transfer_tune``, ``select_donor``) runs unchanged on measured seconds.
Compose it as ``CachedRunner(MeasuredRunner())``.

Validity is the schedule IR's alone: :func:`~repro_torch.core.schedule.concretize`
(tile divisibility, the paper's −1 bars) and the one structural rule of the
cost model (a reduction axis marked parallel).  There is no capacity rule:
every CUDA kernel takes every schedule ``concretize`` accepts, because its
CTA tile is decoupled from the logical tile.

Timings are memoized by what the launch reads (the workload key and the
kernel wrapper's ``schedule_key``: tiles, order and, for the matmul, the
rounding K tile), not by the whole schedule.  So ``measure`` and
``seconds`` give one number for one launch, schedules that differ only in
fields no launch reads (``parallel``, ``unroll``, ``vec``; the K tile and
``cache_write`` wherever they do not make the matmul round its partial
sums, see :func:`repro_torch.kernels.matmul.round_k_for`) tie exactly, and
``stats.measurements`` counts real timings; ``ties`` counts the
``measure`` calls answered from that memo.

How an instance becomes a launch, at its dtype, on inputs drawn from a
generator seeded with its workload key (one instance's inputs are held at a
time):

* matmul classes: :func:`repro_torch.kernels.matmul.matmul`, with a bias or
  residual for the classes that take one; ``moe_*``:
  :func:`~repro_torch.kernels.matmul.grouped_matmul` with x of shape
  (E, M / E, K);
* attention classes: :func:`repro_torch.kernels.flash_attention.flash_attention`
  with Hkv = H (the instance carries no KV-head count), causal for the
  causal, sliding-window, local and softcap classes (the queries the last Q
  of KV positions), the instance's window, and gemma2's softcap of 50 for
  the softcap class;
* except a causal class at Q = 1, the decode instance: decode runs no K2
  launch there but the masked decode attention of
  :func:`repro_torch.models.attention._masked_decode_attention` (its f32
  upcast of the cache included), so that is what is timed, on cache-shaped
  K/V (the instance's B and KV, every row live), behind a longer stream
  hold (:data:`DECODE_SLEEP_CYCLES`).  No schedule reaches it: its launch
  key holds none, so it is timed once per instance.  The
  non-causal classes at Q = 1 (cross-attention at decode) launch K2, as
  decode does;
* scans: :func:`repro_torch.kernels.rwkv6_scan.rwkv6_scan` (H = C / D) and
  :func:`repro_torch.kernels.rglru_scan.rglru_scan`, from a zero state;
* the CNN classes have no kernel in the port: they raise ``ValueError``.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from repro_torch.core.cost_model import Measurement
from repro_torch.core.runner import MEASURED_TARGETS, AnalyticalRunner, CachedRunner, MeasureRunner
from repro_torch.core.schedule import (
    REDUCTION_AXIS,
    ConcreteSchedule,
    Schedule,
    ScheduleInvalid,
    concretize,
    default_schedule,
)
from repro_torch.core.workload import KernelInstance
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.models import attention
from repro_torch.targets import resolve_target, target_name

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: timed runs per launch, after one warm-up run: their median is the time
REPEATS = 5
#: bytes zeroed before each timed run to flush the card's 50 MB L2 (the
#: serving path reads its weights cold)
FLUSH_BYTES = 128 * 2 ** 20
#: clock cycles the stream is held before the start event, about 200 µs at
#: the H100's 1.98 GHz: the wrapper's host work is enqueued behind it, so
#: the events time the device alone, even for a decode-sized launch
SLEEP_CYCLES = 400_000
#: the hold for the plain decode attention, about 1 ms: it enqueues about
#: ten kernels (casts, products, mask, softmax), whose host work outlasts
#: the single launch's hold on a busy host
DECODE_SLEEP_CYCLES = 2_000_000
#: gemma2's attention logit softcap (``attn_softcap``): the softcap class's
SOFTCAP = 50.0
CAUSAL = ("flash_attention_causal", "flash_attention_swa", "flash_attention_local",
          "flash_attention_softcap")
#: the launch key's schedule part for the decode attention, which reads no schedule
DECODE_ATTENTION_KEY = ("masked_decode_attention",)


def is_decode_attention(instance: KernelInstance) -> bool:
    """A causal attention instance at Q = 1: decode's, which the models run
    as the masked decode attention, not as a K2 launch."""
    return instance.class_id in CAUSAL and instance.p["Q"] == 1


def _module(class_id: str):
    """The wrapper module whose kernel computes ``class_id``; a class with
    no kernel in the port (the CNN classes) raises ``ValueError``."""
    if class_id in mm.EPILOGUE or class_id in mm.GROUPED_EPILOGUE:
        return mm
    if class_id.startswith("flash_attention_"):
        return fa
    if class_id == "rwkv6_scan":
        return rw
    if class_id == "rglru_scan":
        return rg
    raise ValueError(f"{class_id!r} has no kernel in the port (the JAX package has no "
                     "Pallas kernel for it), so it cannot be measured on the card")


class MeasuredRunner(MeasureRunner):
    """Times schedules with the port's kernels: on the card by CUDA events,
    or, where ``device="cpu"`` is asked for explicitly, the plain versions
    by the host clock.

    ``target`` names the namespace the records land in: ``h100`` by default
    on the card.  On the CPU a target must be given and may not be a
    measured one (``h100``): a CPU time never wears the card's name.
    Without a card, ``device="cuda"`` raises; there is no fallback.

    ``measure_cost_s`` is the host wall time of the call, input building
    included, so a search's ``search_time_s`` is real seconds.  The kernel
    library builds at its first launch: build it before the first trial
    (``repro_torch.kernels._build.library()``) to charge it to none.
    """

    def __init__(self, target=None, device: str | torch.device = "cuda"):
        super().__init__()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("MeasuredRunner times kernels on a CUDA card and none is "
                                   "available; pass device='cpu' and a target of your own "
                                   "to time the plain versions on the CPU")
            self._target_name = resolve_target("h100" if target is None else target).name
            self._flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=self.device)
        elif self.device.type == "cpu":
            if target is None:
                raise ValueError("on the CPU, name the target the plain versions' times "
                                 "are recorded under")
            self._target_name = resolve_target(target).name
            if self._target_name in MEASURED_TARGETS:
                raise ValueError(f"a CPU time cannot be recorded under {self._target_name!r}")
        else:
            raise ValueError(f"MeasuredRunner runs on 'cuda' or 'cpu', not {self.device}")
        self.ties = 0
        self._times: dict[tuple, float] = {}
        self._inputs_key: str | None = None
        self._inputs: tuple | None = None

    @property
    def target(self) -> str:
        return self._target_name

    # -- validity and memo key ------------------------------------------------
    @staticmethod
    def concrete(instance: KernelInstance, schedule: Schedule, mode: str = "strict"
                 ) -> ConcreteSchedule:
        """Bind ``schedule`` to ``instance``; raises ScheduleInvalid where
        ``concretize`` does, or where the reduction axis is marked parallel."""
        cs = concretize(schedule, instance, mode=mode)
        reduction = REDUCTION_AXIS[instance.family]
        if reduction in schedule.order[: schedule.parallel]:
            raise ScheduleInvalid(f"reduction axis {reduction} marked parallel")
        return cs

    @staticmethod
    def launch_key(cs: ConcreteSchedule) -> tuple:
        """What the launch reads: the workload key and the wrapper's
        ``schedule_key`` (its tiles, order and rounding K tile); for the
        decode attention, which reads no schedule, a fixed key."""
        if is_decode_attention(cs.instance):
            return cs.instance.workload_key(), DECODE_ATTENTION_KEY
        return cs.instance.workload_key(), _module(cs.instance.class_id).schedule_key(cs)

    # -- protocol -------------------------------------------------------------
    def measure(self, instance: KernelInstance, schedule: Schedule, *,
                mode: str = "strict", seed: int = 0,
                noise_sigma: float = 0.05) -> Measurement:
        """Time ``schedule`` on ``instance``; ``seed`` and ``noise_sigma``
        (the cost model's simulated noise) are not used: the card has its own."""
        t0 = time.perf_counter()
        _module(instance.class_id)
        self.stats.requests += 1
        try:
            cs = self.concrete(instance, schedule, mode)
        except ScheduleInvalid:
            cost = time.perf_counter() - t0
            self.stats.measure_cost_s += cost
            return Measurement(seconds=None, measure_cost_s=cost)
        if self.launch_key(cs) in self._times:
            self.ties += 1
        secs = self._seconds(cs)
        cost = time.perf_counter() - t0
        self.stats.measure_cost_s += cost
        return Measurement(seconds=secs, measure_cost_s=cost, adapted=cs.adapted)

    def seconds(self, instance: KernelInstance, schedule: Schedule | None = None,
                mode: str = "strict") -> float:
        """The launch's timed seconds (the same number ``measure`` gives it);
        raises ScheduleInvalid if the schedule cannot bind to the instance."""
        _module(instance.class_id)
        return self._seconds(self.concrete(instance, schedule or default_schedule(instance), mode))

    def telemetry(self) -> dict[str, float]:
        return {**super().telemetry(), "ties": self.ties}

    def run(self, cs: ConcreteSchedule, *, plain: bool = False):
        """One call under ``cs`` on this runner's inputs for its instance:
        the kernel's wrapper, what is timed (on the CPU it takes the plain
        version), or with ``plain`` the plain version (``kernels/ref.py``)
        on the same inputs, to hold the kernel against it."""
        return self._launcher(cs, plain)()

    # -- timing ---------------------------------------------------------------
    def _seconds(self, cs: ConcreteSchedule) -> float:
        key = self.launch_key(cs)
        if key not in self._times:
            self._times[key] = self._time(self._launcher(cs), DECODE_SLEEP_CYCLES
                                          if is_decode_attention(cs.instance) else SLEEP_CYCLES)
            self.stats.measurements += 1
        return self._times[key]

    def _time(self, fn, sleep_cycles: int = SLEEP_CYCLES) -> float:
        fn()   # warm-up
        times = []
        if self.device.type == "cpu":
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            return statistics.median(times)
        for _ in range(REPEATS):
            self._flush.zero_()
            torch.cuda._sleep(sleep_cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        return statistics.median(times)

    def _launcher(self, cs: ConcreteSchedule, plain: bool = False):
        inst = cs.instance
        x = self._inputs_for(inst)
        c = inst.class_id
        if c in mm.EPILOGUE:
            xm, w, kw = x
            if plain:
                return lambda: ref.matmul(xm, w, c, round_k=mm.round_k_for(cs), **kw)
            return lambda: mm.matmul(xm, w, cs, class_id=c, **kw)
        if c in mm.GROUPED_EPILOGUE:
            if plain:
                return lambda: ref.grouped_matmul(*x, c, round_k=mm.round_k_for(cs))
            return lambda: mm.grouped_matmul(*x, cs, class_id=c)
        if is_decode_attention(inst):   # the plain decode attention, on either path
            q, k, v = x
            valid = torch.ones((k.shape[0], k.shape[2]), dtype=torch.bool, device=k.device)
            softcap = SOFTCAP if c == "flash_attention_softcap" else 0.0
            return lambda: attention._masked_decode_attention(q, k, v, valid, softcap=softcap)
        if inst.family == "attention":
            p = inst.p
            kw = dict(causal=c in CAUSAL, window=p.get("window", 0),
                      softcap=SOFTCAP if c == "flash_attention_softcap" else 0.0,
                      q_offset=max(p["KV"] - p["Q"], 0) if c in CAUSAL else 0)
            if plain:
                return lambda: ref.chunked_attention(*x, chunk=cs.t["KV"], **kw)
            return lambda: fa.flash_attention(*x, cs, **kw)
        if c == "rwkv6_scan":
            return (lambda: ref.rwkv6_scan(*x)) if plain else (lambda: rw.rwkv6_scan(*x, cs))
        return (lambda: ref.rglru_scan(*x)) if plain else (lambda: rg.rglru_scan(*x, cs))

    def _inputs_for(self, inst: KernelInstance) -> tuple:
        """The inputs of one instance, built once on this runner's device
        from a generator seeded with the workload key, scaled so outputs are
        of order one; the previous instance's are freed first."""
        wk = inst.workload_key()
        if self._inputs_key != wk:
            self._inputs = self._inputs_key = None
            self._inputs = self._build_inputs(inst)
            self._inputs_key = wk
        return self._inputs

    def _build_inputs(self, inst: KernelInstance) -> tuple:
        dev, dt, p, c = self.device, DTYPES[inst.dtype], inst.p, inst.class_id
        g = torch.Generator(device=dev).manual_seed(int(inst.workload_key(), 16) & (2 ** 63 - 1))

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev)

        if inst.family == "matmul":
            m, n, k = p["M"], p["N"], p["K"]
            if c in mm.GROUPED_EPILOGUE:   # x (E, M/E, K), w (E, K, N), one expert at a time
                e = p["E"]
                w = torch.empty((e, k, n), dtype=dt, device=dev)
                for i in range(e):
                    w[i] = randn(k, n) / math.sqrt(k)
                return randn(e, m // e, k).to(dt), w
            out_n = n // 2 if c in ("matmul_silu_glu", "matmul_gelu_glu") else n
            kw = dict(bias=randn(n).to(dt) if c in ("matmul_bias", "matmul_bias_gelu") else None,
                      residual=randn(m, out_n).to(dt) if c == "matmul_residual" else None,
                      softcap=2.0 if c == "matmul_lmhead_softcap" else 0.0)
            return randn(m, k).to(dt), (randn(k, n) / math.sqrt(k)).to(dt), kw
        if inst.family == "attention":   # Hkv = H: the instance carries no KV-head count
            b, h, d = p.get("B", 1), p.get("H", 1), p.get("D", 128)
            return (randn(b, h, p["Q"], d).to(dt), randn(b, h, p["KV"], d).to(dt),
                    randn(b, h, p["KV"], d).to(dt))
        b, t = p.get("B", 1), p["T"]
        if c == "rwkv6_scan":   # H = C / D heads; decays near one, as the model's
            d = p.get("D", 64)
            h = p["C"] // d
            r, k, v = (randn(b, h, t, d).to(dt) for _ in range(3))
            w = torch.exp(-torch.exp(-6.0 + 0.5 * randn(b, h, t, d))).to(dt)
            return r, k, v, w, 0.5 * randn(h, d), torch.zeros((b, h, d, d), device=dev)
        ch = p["C"]
        return (randn(b, t, ch).to(dt), torch.sigmoid(randn(b, t, ch)).to(dt),
                torch.zeros((b, ch), device=dev))


def target_runner(target, device: str | torch.device = "cuda") -> CachedRunner:
    """The runner that prices ``target``'s kernels for serving:
    ``CachedRunner(AnalyticalRunner(target))`` for a modelled target, as the
    reference prices every target, and ``CachedRunner(MeasuredRunner(target=
    target))`` for a measured one (``h100``), which times the port's kernels
    on the card.  A measured target served from ``device`` other than the
    card raises: a CPU time never wears the card's name."""
    name = target_name(target)
    if name not in MEASURED_TARGETS:
        return CachedRunner(AnalyticalRunner(name))
    if torch.device(device).type != "cuda":
        raise ValueError(f"target {name!r} is timed on the card: serve it on the card, or "
                         "name a modelled target (e.g. tpu-v5e) on the CPU")
    return CachedRunner(MeasuredRunner(target=name))
