"""Serving-fleet subsystem.

The exports of ``repro.fleet``: the policy modules are copies, ``fleet.py``
is ported onto the port's engines and runners (the port imports nothing of
``repro``).

A request front-end over N :class:`~repro_torch.serving.ServingEngine` replicas:

    traffic.py ..... seeded request streams (Poisson, bursty, diurnal, replay)
    router.py ...... bounded admission queue + pluggable dispatch policies
    demand.py ...... decayed per-bucket arrival counts driving tuning order
    acceptance.py .. decayed per-class speculative acceptance estimates
    metrics.py ..... latency percentiles, windowed telemetry, shed accounting
    autoscale.py ... hysteresis autoscaler over the windowed telemetry
    advisor.py ..... telemetry-driven tuning priority (critical-path seconds
                     x speedup headroom), replacing demand-count ordering
    fleet.py ....... replicas + shared-registry propagation + the serve loop
                     + elastic lifecycle (warm-join / drain-retire)
"""
from repro_torch.fleet.acceptance import AcceptanceTracker
from repro_torch.fleet.advisor import RankedWorkload, TuningAdvisor
from repro_torch.fleet.autoscale import Autoscaler, ScaleDecision
from repro_torch.fleet.demand import DemandTracker
from repro_torch.fleet.fleet import PagedReplica, Replica, ServingFleet
from repro_torch.fleet.metrics import FleetMetrics, percentile
from repro_torch.fleet.router import (
    POLICIES,
    DispatchPolicy,
    LeastLoaded,
    PlanAware,
    QueueFull,
    RequestRouter,
    RoundRobin,
    make_policy,
    register_policy,
)
from repro_torch.fleet.traffic import (
    BurstyTraffic,
    DiurnalTraffic,
    FleetRequest,
    TrafficGenerator,
    VariableRateTraffic,
    load_trace,
    sample_prompts,
    save_trace,
)

__all__ = [
    "AcceptanceTracker",
    "Autoscaler",
    "BurstyTraffic",
    "DemandTracker",
    "DispatchPolicy",
    "DiurnalTraffic",
    "FleetMetrics",
    "FleetRequest",
    "LeastLoaded",
    "POLICIES",
    "PagedReplica",
    "PlanAware",
    "QueueFull",
    "RankedWorkload",
    "Replica",
    "RequestRouter",
    "RoundRobin",
    "ScaleDecision",
    "ServingFleet",
    "TrafficGenerator",
    "TuningAdvisor",
    "VariableRateTraffic",
    "load_trace",
    "make_policy",
    "percentile",
    "register_policy",
    "sample_prompts",
    "save_trace",
]
