"""The port's copy of ``repro.core.resolution`` and its schedule provider
against the originals.

A pipeline of each package (service → static map → default) over registries
holding the same records, under the analytical ``tpu-v5e`` runner with
deferred jobs: every kernel instance of a serving plan resolves to the same
tier and the same schedule in both, and the plans' tiers and schedules are
equal.  Plus ports of the reference's provider and plan-refresh tests.
"""
import random

import pytest

pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core.autoscheduler import random_schedule as jrandom_schedule
from repro.core.autoscheduler import tune_kernel as jtune_kernel
from repro.core.database import Record as JRecord
from repro.core.extract import extract_kernels as jextract
from repro.core.resolution import ResolutionPipeline as JResolutionPipeline
from repro.core.resolution import plan_serving as jplan_serving
from repro.core.runner import AnalyticalRunner as JAnalyticalRunner
from repro.core.runner import CachedRunner as JCachedRunner
from repro.configs import ShapeConfig as JShapeConfig
from repro.service import ScheduleRegistry as JScheduleRegistry
from repro.service import TuningService as JTuningService
from repro_torch.configs import get_arch, reduced
from repro_torch.core import resolution
from repro_torch.core.database import Record
from repro_torch.core.resolution import ResolutionPipeline, plan_serving, plan_uses
from repro_torch.core.runner import AnalyticalRunner, CachedRunner
from repro_torch.core.schedule import Schedule
from repro_torch.core.workload import KernelInstance, KernelUse
from repro_torch.kernels.ops import ScheduleProvider
from repro_torch.service import ScheduleRegistry, TuningService

SLOTS, MAX_LEN = 2, 32


def _records_for(jcfg):
    """Records for an arch's reduced serving plan: tuned donors at another
    prompt length (transfer candidates), exact records for a few of the
    plan's own instances, and a static map for a few more (reference types)."""
    donors = jextract(jcfg, JShapeConfig("donor_prefill_24", 24, 1, "prefill"))
    records = []
    for i, u in enumerate(donors[:6]):
        res = jtune_kernel(u.instance, trials=16, seed=i)
        records.append(JRecord(u.instance, res.best, res.best_seconds, "donor"))
    plan_uses_ = jextract(jcfg, JShapeConfig("serve_decode", MAX_LEN, SLOTS, "decode"))
    runner = JAnalyticalRunner()
    exact, static = {}, {}
    for i, u in enumerate(plan_uses_[:6]):
        sched = jrandom_schedule(u.instance, random.Random(i))
        try:
            secs = runner.seconds(u.instance, sched)
        except Exception:
            continue
        if i % 2:
            static[u.instance.workload_key()] = sched
        else:
            exact[u.instance.workload_key()] = JRecord(u.instance, sched, secs, "published")
    return records + list(exact.values()), static


def _port_schedule(s):
    return Schedule.from_json(s.to_json())


@pytest.fixture(params=["minitron-4b", "recurrentgemma-2b"])
def pipelines(request, tmp_path):
    jcfg, cfg = jreduced(jget_arch(request.param)), reduced(get_arch(request.param))
    records, static = _records_for(jcfg)
    jreg = JScheduleRegistry(str(tmp_path / "ref"))
    reg = ScheduleRegistry(str(tmp_path / "port"))
    jreg.publish(records)
    reg.publish([Record.from_json(r.to_json()) for r in records])
    kw = dict(model_id="serving", max_workers=0, seed=0)
    jsvc = JTuningService(jreg, runner=JCachedRunner(JAnalyticalRunner()), **kw)
    svc = TuningService(reg, runner=CachedRunner(AnalyticalRunner()), **kw)
    jpipe = JResolutionPipeline.build(schedule_map=static, service=jsvc)
    pipe = ResolutionPipeline.build(
        schedule_map={k: _port_schedule(s) for k, s in static.items()}, service=svc)
    yield jcfg, cfg, jpipe, pipe
    jsvc.close()
    svc.close()


def _resolved(res):
    return res.tier, res.stage, res.source_model, res.generation, res.schedule.to_json()


def test_pipeline_resolves_every_serving_instance_alike(pipelines):
    """Each instance of ``plan_serving``'s kernel set (2 slots, max_len 32,
    prefill buckets 8 and 16) resolves to the same tier, stage, provenance,
    generation and schedule in both packages, before and after the
    background jobs the misses queued are drained."""
    jcfg, cfg, jpipe, pipe = pipelines
    jplan = jplan_serving(jcfg, jpipe, slots=SLOTS, max_len=MAX_LEN, prefill_lengths=(8, 16))
    plan = plan_serving(cfg, pipe, slots=SLOTS, max_len=MAX_LEN, prefill_lengths=(8, 16))
    assert [u.instance.workload_key() for u in plan.uses] == \
        [u.instance.workload_key() for u in jplan.uses]
    tiers = set()
    for ju, u in zip(jplan.uses, plan.uses):
        jr, r = jpipe.resolve(ju.instance), pipe.resolve(u.instance)
        assert _resolved(jr) == _resolved(r)
        tiers.add(r.tier)
    assert tiers == set(resolution.TIERS)
    assert jplan.tier_counts() == plan.tier_counts()
    assert {k: s.to_json() for k, s in jplan.schedules().items()} == \
        {k: s.to_json() for k, s in plan.schedules().items()}
    assert jplan.generation == plan.generation
    # the jobs the misses queued publish the same upgrades; re-planning then
    # gives equal plans again, at the same later generation
    assert jpipe.service.drain() == pipe.service.drain()
    jplan2, plan2 = jplan.refresh(jpipe), plan.refresh(pipe)
    assert jplan2.generation == plan2.generation
    assert jplan2.tier_counts() == plan2.tier_counts()
    assert {k: s.to_json() for k, s in jplan2.schedules().items()} == \
        {k: s.to_json() for k, s in plan2.schedules().items()}
    js, ps = jpipe.stats(), pipe.stats()
    assert js == ps


# ---------------------------------------------------------------------------
# Ports of tests/test_resolution.py
# ---------------------------------------------------------------------------


def make_instance(m=64, n=64, k=64, dtype="float32"):
    return KernelInstance.make("matmul", M=m, N=n, K=k, dtype=dtype)


def make_schedule(tm=32, tn=32, tk=32, **kw):
    return Schedule.make("matmul", tiles={"M": tm, "N": tn, "K": tk}, **kw)


def make_service(tmp_path, name="svc", **kw):
    registry = ScheduleRegistry(str(tmp_path / name))
    kw.setdefault("runner", CachedRunner(AnalyticalRunner()))
    kw.setdefault("max_workers", 0)
    kw.setdefault("probe_candidates", 0)
    return registry, TuningService(registry, model_id="serving", **kw)


def publish(registry, inst, sched, seconds=1e-6, model_id="donor",
            target="tpu-v5e", mode="strict"):
    registry.publish([Record(instance=inst, schedule=sched, seconds=seconds,
                             model_id=model_id, target=target)], mode=mode)


def test_plan_refresh_picks_up_upgrade_and_keeps_old_plan_frozen(tmp_path):
    registry, service = make_service(tmp_path)
    pipe = ResolutionPipeline.build(service=service)
    uses = [KernelUse(make_instance())]
    plan = plan_uses(uses, pipe)
    inst = uses[0].instance
    assert plan.lookup(inst).tier == "default"

    better = make_schedule()
    publish(registry, inst, better)
    plan2 = plan.refresh(pipe)
    assert plan.lookup(inst).tier == "default"      # old plan untouched
    assert plan2.lookup(inst).tier == "exact"
    assert plan2.lookup(inst).schedule == better
    assert plan2.generation > plan.generation


def test_provider_consults_plan_before_pipeline(tmp_path):
    registry, service = make_service(tmp_path)
    pipe = ResolutionPipeline.build(service=service)
    inst = make_instance()
    plan = plan_uses([KernelUse(inst)], pipe)
    provider = ScheduleProvider(pipeline=pipe, plan=plan)
    lookups = service.stats()["lookups"]
    cs = provider.get(inst)
    assert provider.plan_hits == 1
    assert service.stats()["lookups"] == lookups    # plan hit: no service call
    assert cs.schedule == plan.lookup(inst).schedule
    # a default-tier plan answer is an untuned kernel, not a hit (misses
    # count the planning-time pipeline resolve plus the plan-served call)
    assert provider.hits == 0 and provider.misses == 2
    # unplanned instance falls back to the pipeline (and the gap is counted)
    other = make_instance(256)
    provider.get(other)
    assert provider.plan_hits == 1
    assert provider.stats()["plan_misses"] == 1
    assert provider.stats()["served_default"] >= 1

    # after an upgrade, an exact-tier plan answer does count as a hit
    publish(registry, inst, make_schedule())
    provider.plan = plan.refresh(pipe)
    provider.get(inst)
    assert provider.stats()["plan_served"]["exact"] == 1
    assert provider.hits == 2  # the re-planning resolve + the plan-served call


def test_tiers_and_exports_match_the_reference():
    from repro.core import resolution as jresolution
    from repro_torch import core

    assert resolution.TIERS == jresolution.TIERS
    for name in ("ResolutionPipeline", "ExecutionPlan", "plan_uses", "plan_model",
                 "plan_serving", "ServiceStage", "StaticMapStage", "DefaultStage"):
        assert name in core.__all__ and getattr(core, name) is getattr(resolution, name)
