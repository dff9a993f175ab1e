"""Analytical TPU-v5e kernel cost model + measurement simulator: a copy of
``repro.core.cost_model`` (the port imports nothing of ``repro``).  It models
the TPU targets only; the port's card, the ``h100`` target, is measured
(:class:`repro_torch.core.measured_runner.MeasuredRunner`), never modelled.

This plays the role of Ansor's *measurement* step (build + run on hardware).
The container is a single CPU core and the target is TPU v5e, so wall-clock
measurement of interpreted Pallas kernels would rank schedules by Python
overhead rather than TPU behaviour.  Instead we model, per kernel family:

* a compute term — FLOPs over MXU/VPU peak, derated by tile alignment
  against the native (8, 128) VREG / 128×128 MXU geometry;
* a memory term — HBM traffic **derived from the tiling and grid order**,
  using Pallas' consecutive-revisit semantics (a block is re-fetched unless
  its index map is unchanged between consecutive grid steps);
* VMEM capacity validity (double-buffered operand blocks + accumulators);
* pipeline fill/launch overheads and an unroll instruction-overhead knob.

Time = max(compute, memory) + overheads, then a seeded log-normal noise
factor emulates Ansor's stochastic measurements.  Every second produced here
is a *cost-model second* (documented in DESIGN.md / EXPERIMENTS.md).

The model is intentionally sensitive to the same schedule features the paper
manipulates (Split/Reorder/Unroll/Vectorize/cache staging), so the transfer-
tuning phenomena (invalid transfers, near-native transferred performance,
mixed-pool regressions) emerge rather than being hard-coded.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import struct
from typing import Mapping, Sequence

from repro_torch.core.schedule import ConcreteSchedule, Schedule, ScheduleInvalid, concretize, default_schedule
from repro_torch.core.workload import KernelInstance, KernelUse, class_family
from repro_torch.hw.specs import TPU_V5E, ChipSpec, dim_efficiency

DTYPE_BYTES = {"bfloat16": 2, "float32": 4, "float16": 2, "int8": 1}

# Virtual measurement-harness costs (Ansor's search time is dominated by
# candidate build+run; these mirror its scale: ~seconds per candidate).
COMPILE_S = 1.2          # per-candidate build time
FAILED_COMPILE_S = 0.7   # invalid candidates are caught at build time
RUN_REPEATS = 3
RUN_OVERHEAD_S = 0.05
MIN_RUN_S = 1e-3


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    compute_s: float
    memory_s: float
    overhead_s: float
    flops: float
    hbm_bytes: float
    vmem_bytes: int

    @property
    def seconds(self) -> float:
        return max(self.compute_s, self.memory_s) + self.overhead_s

    @property
    def bottleneck(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"


@dataclasses.dataclass(frozen=True)
class Measurement:
    """Result of one simulated hardware measurement of (instance, schedule)."""

    seconds: float | None        # None => invalid schedule for this instance
    measure_cost_s: float        # virtual harness time spent (compile + runs)
    breakdown: CostBreakdown | None = None
    adapted: bool = False
    cached: bool = False         # served from a CachedRunner without re-measuring
    pruned: bool = False         # dropped by a PruningRunner draft, never built

    @property
    def valid(self) -> bool:
        return self.seconds is not None


def _esize(dtype: str) -> int:
    return DTYPE_BYTES[dtype]


def _operand_fetches(order: Sequence[str], trips: Mapping[str, int], dep: set[str]) -> int:
    """Number of HBM fetch events for an operand whose block index depends on
    axes `dep`, under Pallas consecutive-revisit caching.

    The block stays VMEM-resident across the innermost contiguous run of grid
    axes it does NOT depend on; every other step boundary re-fetches it.
    """
    run = 1
    for axis in reversed(order):
        if axis in dep:
            break
        run *= trips[axis]
    total = math.prod(trips[a] for a in order)
    return max(1, total // run)


# ---------------------------------------------------------------------------
# Matmul family
# ---------------------------------------------------------------------------


def _epilogue_flops_per_elem(class_id: str) -> float:
    return {
        "matmul": 0.0,
        "matmul_bias": 1.0,
        "matmul_bias_gelu": 9.0,
        "matmul_silu_glu": 4.0,      # silu(x1)*x2 over N/2 outputs ≈ 4/elem of N
        "matmul_gelu_glu": 5.5,
        "matmul_residual": 1.0,
        "matmul_lmhead": 0.0,
        "matmul_lmhead_softcap": 12.0,  # tanh softcap
        "moe_gemm_silu_glu": 4.0,
        "moe_router": 6.0,           # softmax over experts
    }.get(class_id, 1.0)


def _matmul_cost(cs: ConcreteSchedule, spec: ChipSpec) -> CostBreakdown:
    inst, sched = cs.instance, cs.schedule
    p = inst.p
    M, N, K = p["M"], p["N"], p["K"]
    E = p.get("E", 1)
    bm, bn, bk = cs.t["M"], cs.t["N"], cs.t["K"]
    es = _esize(inst.dtype)

    # MoE grouped GEMM: E independent (M/E, N, K) problems (average routing),
    # plus dispatch/combine gather-scatter traffic over the token dim.
    m_eff = max(1, M // E)
    order = [a for a in cs.order if a != "E"]
    trips = {"M": max(1, math.ceil(m_eff / bm)), "N": math.ceil(N / bn), "K": math.ceil(K / bk)}

    # --- compute term ---
    flops = 2.0 * m_eff * N * K * E
    epi = _epilogue_flops_per_elem(inst.class_id) * m_eff * N * E
    mxu_eff = (
        dim_efficiency(bk, spec.mxu_dim)
        * dim_efficiency(bn, spec.mxu_dim)
        * dim_efficiency(min(bm, m_eff), spec.vreg_sublanes)
    )
    if bn % sched.vec != 0:
        mxu_eff *= 0.85  # vectorized innermost tile misaligned with lane tile
    vpu_flops = spec.peak_flops_bf16 / 16.0
    compute_s = flops / (spec.peak_flops_bf16 * max(mxu_eff, 1e-3)) + epi / vpu_flops

    # --- memory term (order-dependent HBM traffic) ---
    fetches_a = _operand_fetches(order, trips, {"M", "K"})
    fetches_b = _operand_fetches(order, trips, {"K", "N"})
    bytes_a = fetches_a * bm * bk * es
    bytes_b = fetches_b * bk * bn * es
    out_tiles = trips["M"] * trips["N"]
    if _acc_resident(order):
        bytes_c = out_tiles * bm * bn * es  # written once
    else:
        # accumulator revisited non-consecutively: spill+reload per K segment
        fetches_c = _operand_fetches(order, trips, {"M", "N"})
        bytes_c = 2 * fetches_c * bm * bn * es
    hbm = (bytes_a + bytes_b + bytes_c) * E
    if E > 1:
        hbm += 2.0 * M * K * es  # token dispatch + combine
    memory_s = hbm / spec.hbm_bandwidth

    # --- VMEM validity ---
    acc_bytes = bm * bn * (4 if sched.cache_write else es)
    vmem = 2 * (bm * bk + bk * bn) * es + acc_bytes + bm * bn * es
    if vmem > spec.vmem_capacity:
        raise ScheduleInvalid(f"VMEM overflow: {vmem} > {spec.vmem_capacity}")

    # --- overheads ---
    steps = math.prod(trips.values()) * E
    step_overhead = 60e-9 / (1.0 + sched.unroll / 8.0)
    icache_penalty = 1.05 if (sched.unroll >= 256 and bm * bn >= 128 * 128) else 1.0
    fill = 2.0 / max(steps, 2)
    overhead = spec.kernel_launch_overhead_s + steps * step_overhead
    base = max(compute_s * icache_penalty, memory_s) * (1.0 + fill)
    return CostBreakdown(
        compute_s=compute_s * icache_penalty,
        memory_s=memory_s,
        overhead_s=overhead + (base - max(compute_s * icache_penalty, memory_s)),
        flops=flops + epi,
        hbm_bytes=hbm,
        vmem_bytes=vmem,
    )


def _acc_resident(order: Sequence[str]) -> bool:
    """Output accumulator stays VMEM-resident iff K is the innermost axis."""
    return order[-1] == "K"


# ---------------------------------------------------------------------------
# Attention family (flash attention with q/kv tiling)
# ---------------------------------------------------------------------------


def _attention_cost(cs: ConcreteSchedule, spec: ChipSpec) -> CostBreakdown:
    inst, sched = cs.instance, cs.schedule
    p = inst.p
    Q, KV = p["Q"], p["KV"]
    H = p.get("H", 1)
    D = p.get("D", 128)
    B = p.get("B", 1)
    window = p.get("window", 0)
    bq, bkv = cs.t["Q"], cs.t["KV"]
    es = _esize(inst.dtype)

    causal = inst.class_id in ("flash_attention_causal", "flash_attention_swa",
                               "flash_attention_local", "flash_attention_softcap")
    if window > 0:
        frac = min(1.0, (window + bq) / KV)
    elif causal and Q == KV:
        frac = 0.5 + bkv / (2.0 * KV)
    else:
        frac = 1.0

    flops = 4.0 * B * H * Q * KV * D * frac            # QK^T + PV
    vpu = 10.0 * B * H * Q * KV * frac                 # softmax, scaling, softcap
    if "softcap" in inst.class_id:
        vpu *= 1.6
    mxu_eff = (
        dim_efficiency(bkv, spec.mxu_dim)
        * dim_efficiency(D, spec.mxu_dim)
        * dim_efficiency(min(bq, Q), spec.vreg_sublanes)
    )
    compute_s = flops / (spec.peak_flops_bf16 * max(mxu_eff, 1e-3)) + vpu / (spec.peak_flops_bf16 / 16.0)

    trips_q = max(1, math.ceil(Q / bq))
    trips_kv = max(1, math.ceil(KV / bkv))
    q_outer = cs.order[0] == "Q"
    if q_outer:
        # stream K/V per q block (classic flash): K/V re-read per q tile
        bytes_ = B * H * (Q * D * es + 2 * KV * D * es * trips_q * frac + Q * D * es)
    else:
        # kv outer: q re-read per kv tile + softmax stats/acc spill per kv tile
        bytes_ = B * H * (Q * D * es * trips_kv + 2 * KV * D * es * frac
                          + 2 * Q * D * 4 * trips_kv + Q * D * es)
    memory_s = bytes_ / spec.hbm_bandwidth

    acc_bytes = bq * D * (4 if sched.cache_write else es) + bq * 8  # acc + m/l stats
    vmem = 2 * (bq * D + 2 * bkv * D) * es + bq * bkv * es + acc_bytes
    if vmem > spec.vmem_capacity:
        raise ScheduleInvalid(f"VMEM overflow: {vmem} > {spec.vmem_capacity}")

    steps = B * H * trips_q * trips_kv
    step_overhead = 80e-9 / (1.0 + sched.unroll / 8.0)
    fill = 2.0 / max(steps, 2)
    overhead = spec.kernel_launch_overhead_s + steps * step_overhead
    base = max(compute_s, memory_s)
    return CostBreakdown(
        compute_s=compute_s,
        memory_s=memory_s,
        overhead_s=overhead + base * fill,
        flops=flops + vpu,
        hbm_bytes=bytes_,
        vmem_bytes=vmem,
    )


# ---------------------------------------------------------------------------
# Recurrent-scan family (rwkv6 wkv, RG-LRU)
# ---------------------------------------------------------------------------


def _scan_cost(cs: ConcreteSchedule, spec: ChipSpec) -> CostBreakdown:
    inst, sched = cs.instance, cs.schedule
    p = inst.p
    T, C = p["T"], p["C"]
    B = p.get("B", 1)
    D = p.get("D", 64)  # head dim (state is DxD per head for rwkv6)
    ct, bc = cs.t["T"], cs.t["C"]
    es = _esize(inst.dtype)

    if inst.class_id == "rwkv6_scan":
        flops = 4.0 * B * T * C * D     # decay/update/readout of DxD states
        state_bytes = B * C * D * 4
        intensity_unit = spec.peak_flops_bf16 / 8.0   # outer products: VPU+MXU mix
    else:  # rglru_scan
        flops = 10.0 * B * T * C
        state_bytes = B * C * 4
        intensity_unit = spec.peak_flops_bf16 / 16.0  # pure VPU elementwise

    lane_eff = dim_efficiency(bc, spec.vreg_lanes) * dim_efficiency(min(ct, T), spec.vreg_sublanes)
    compute_s = flops / (intensity_unit * max(lane_eff, 1e-3))

    io_streams = 4 if inst.class_id == "rwkv6_scan" else 3  # x,(r,k,v,w..) approximated
    bytes_ = B * T * C * es * io_streams + B * T * C * es + 2 * state_bytes
    memory_s = bytes_ / spec.hbm_bandwidth

    vmem = 2 * ct * bc * es * io_streams + bc * D * 4 + ct * bc * es
    if vmem > spec.vmem_capacity:
        raise ScheduleInvalid(f"VMEM overflow: {vmem} > {spec.vmem_capacity}")

    chunks = max(1, math.ceil(T / ct)) * max(1, math.ceil(C / bc)) * B
    step_overhead = 120e-9 / (1.0 + sched.unroll / 8.0)
    fill = 2.0 / max(chunks, 2)
    overhead = spec.kernel_launch_overhead_s + chunks * step_overhead
    base = max(compute_s, memory_s)
    return CostBreakdown(
        compute_s=compute_s,
        memory_s=memory_s,
        overhead_s=overhead + base * fill,
        flops=flops,
        hbm_bytes=bytes_,
        vmem_bytes=vmem,
    )


_FAMILY_COST = {"matmul": _matmul_cost, "attention": _attention_cost, "scan": _scan_cost}


def evaluate(cs: ConcreteSchedule, spec: ChipSpec = TPU_V5E) -> CostBreakdown:
    """Deterministic cost of a concrete (instance, schedule) binding.

    Raises ScheduleInvalid on structural violations (VMEM overflow,
    parallelized reduction axis).
    """
    sched = cs.schedule
    reduction = {"matmul": "K", "attention": "KV", "scan": "T"}[cs.instance.family]
    if reduction in sched.order[: sched.parallel]:
        raise ScheduleInvalid(f"reduction axis {reduction} marked parallel")
    return _FAMILY_COST[cs.instance.family](cs, spec)


# ---------------------------------------------------------------------------
# Measurement simulator (the "hardware" the auto-scheduler talks to)
# ---------------------------------------------------------------------------


def _noise_factor(instance: KernelInstance, schedule: Schedule, seed: int, sigma: float) -> float:
    blob = f"{instance.workload_key()}|{schedule.to_json()}|{seed}".encode()
    h = hashlib.sha256(blob).digest()
    u1 = struct.unpack("<I", h[:4])[0] / 2**32
    u2 = struct.unpack("<I", h[4:8])[0] / 2**32
    u1 = min(max(u1, 1e-12), 1 - 1e-12)
    z = math.sqrt(-2.0 * math.log(u1)) * math.cos(2 * math.pi * u2)
    return math.exp(sigma * z)


def measure(
    instance: KernelInstance,
    schedule: Schedule,
    *,
    mode: str = "strict",
    seed: int = 0,
    noise_sigma: float = 0.05,
    spec: ChipSpec = TPU_V5E,
) -> Measurement:
    """Simulate one build+measure of `schedule` applied to `instance`."""
    try:
        cs = concretize(schedule, instance, mode=mode)
        bd = evaluate(cs, spec)
    except ScheduleInvalid:
        return Measurement(seconds=None, measure_cost_s=FAILED_COMPILE_S)
    secs = bd.seconds * _noise_factor(instance, schedule, seed, noise_sigma)
    cost = COMPILE_S + RUN_REPEATS * max(secs, MIN_RUN_S) + RUN_OVERHEAD_S
    return Measurement(seconds=secs, measure_cost_s=cost, breakdown=bd, adapted=cs.adapted)


def kernel_seconds(instance: KernelInstance, schedule: Schedule | None = None,
                   mode: str = "strict", spec: ChipSpec = TPU_V5E) -> float:
    """Noise-free cost (used for ground-truth model totals and P_c shares)."""
    schedule = schedule or default_schedule(instance)
    cs = concretize(schedule, instance, mode=mode)
    return evaluate(cs, spec).seconds


def model_seconds(uses: Sequence[KernelUse], schedule_map: Mapping[str, Schedule] | None = None,
                  mode: str = "strict", spec: ChipSpec = TPU_V5E) -> float:
    """End-to-end model cost = Σ use_count × kernel cost under chosen schedules.

    ``schedule_map`` maps workload_key -> Schedule; missing entries fall back
    to the untuned default (exactly the paper's partially-tuned setting).
    """
    total = 0.0
    for u in uses:
        sched = None
        if schedule_map is not None:
            sched = schedule_map.get(u.instance.workload_key())
        total += u.use_count * kernel_seconds(u.instance, sched, mode=mode, spec=spec)
    return total


def contextual_model_seconds(uses: Sequence[KernelUse],
                             schedule_map: Mapping[str, Schedule] | None = None,
                             mode: str = "strict", coupling: float = 0.08,
                             spec: ChipSpec = TPU_V5E) -> float:
    """Model cost including inter-kernel cache-residency coupling (§5.5).

    Standalone kernel latency ignores that kernel A's output tiling dictates
    the VMEM/cache residency kernel B reads it back with.  We model the
    coupling as a memory-term penalty proportional to the (log) mismatch
    between the producer's output tile width (bn) and the consumer's
    reduction streaming tile (bk): perfectly matched tiles re-use resident
    blocks; mismatched tiles re-fetch.  This is what makes "fastest
    standalone" an imperfect proxy — the paper's mixed-pool regression.
    """
    total = 0.0
    prev_cs = None
    for u in uses:
        sched = None
        if schedule_map is not None:
            sched = schedule_map.get(u.instance.workload_key())
        sched = sched or default_schedule(u.instance)
        cs = concretize(sched, u.instance, mode=mode)
        bd = evaluate(cs, spec)
        sec = bd.seconds
        if (prev_cs is not None and u.instance.family == "matmul"
                and prev_cs.instance.family == "matmul"):
            bn_p = prev_cs.t.get("N")
            bk_c = cs.t.get("K")
            if bn_p and bk_c:
                mismatch = min(abs(math.log2(bn_p / bk_c)) / 4.0, 1.0)
                mem_frac = bd.memory_s / max(bd.seconds, 1e-30)
                sec *= 1.0 + coupling * mismatch * mem_frac
        total += u.use_count * sec
        prev_cs = cs
    return total


def class_proportions(uses: Sequence[KernelUse], spec: ChipSpec = TPU_V5E,
                      seconds_fn=None) -> dict[str, float]:
    """P_c: share of *untuned* model time per kernel class (paper Table 2).

    ``seconds_fn(instance) -> float`` overrides the untuned-seconds source
    (e.g. a memoizing MeasureRunner's ``seconds`` query).
    """
    fn = seconds_fn or (lambda inst: kernel_seconds(inst, None, spec=spec))
    per_class: dict[str, float] = {}
    for u in uses:
        sec = u.use_count * fn(u.instance)
        per_class[u.instance.class_id] = per_class.get(u.instance.class_id, 0.0) + sec
    total = sum(per_class.values()) or 1.0
    return {c: s / total for c, s in per_class.items()}
