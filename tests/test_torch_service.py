"""The port's copies of ``repro.service`` (the schedule registry and the
tuning service) against the originals.

Both packages get the same records and the same calls, under the analytical
``tpu-v5e`` runner, deferred jobs (``max_workers=0``) and registries in
``tmp_path``, so no thread outlives a test.  The registries' bytes on disk,
generations, snapshots and compactions must be equal, and the services'
lookups, background jobs, published upgrades and counters.
"""
import json
import random

import pytest

pytest.importorskip("torch")

from repro.core.autoscheduler import random_schedule as jrandom_schedule
from repro.core.autoscheduler import tune_kernel as jtune_kernel
from repro.core.database import Record as JRecord
from repro.core.runner import AnalyticalRunner as JAnalyticalRunner
from repro.core.runner import CachedRunner as JCachedRunner
from repro.core.workload import KernelInstance as JKernelInstance
from repro.service import ScheduleRegistry as JScheduleRegistry
from repro.service import TuningService as JTuningService
from repro_torch.core.database import Record
from repro_torch.core.runner import AnalyticalRunner, CachedRunner
from repro_torch.core.workload import KernelInstance
from repro_torch.service import ScheduleRegistry, TuningService

#: donor workloads (model, class, params) and the workloads the service is asked for
DONORS = [("donor_a", "matmul", dict(M=512, N=512, K=512)),
          ("donor_a", "matmul", dict(M=256, N=1024, K=256)),
          ("donor_b", "matmul", dict(M=768, N=768, K=768)),
          ("donor_b", "matmul_silu_glu", dict(M=128, N=2048, K=512)),
          ("donor_b", "flash_attention_causal", dict(Q=256, KV=256, H=8, D=64, B=1, window=0))]
ASKED = [("matmul", dict(M=256, N=1024, K=512)), ("matmul", dict(M=512, N=512, K=512)),
         ("matmul_silu_glu", dict(M=64, N=1024, K=256)), ("matmul", dict(M=8, N=96, K=40)),
         ("flash_attention_causal", dict(Q=128, KV=128, H=8, D=64, B=1, window=0)),
         ("matmul", dict(M=256, N=1024, K=512))]


def _donor_records(per_workload=3):
    """Per donor workload, the reference's tuned best (32 trials) and random
    schedules, timed by its analytical runner (the port's copies tune, draw
    and time alike)."""
    runner, out = JAnalyticalRunner(), []
    for i, (model, cls, params) in enumerate(DONORS):
        inst = JKernelInstance.make(cls, **params)
        best = jtune_kernel(inst, trials=32, seed=i)
        out.append(JRecord(inst, best.best, best.best_seconds, model))
        rng = random.Random(i)
        while sum(r.instance == inst for r in out) < per_workload:
            sched = jrandom_schedule(inst, rng)
            m = runner.measure(inst, sched, seed=0, noise_sigma=0.0)
            if m.seconds is not None:
                out.append(JRecord(inst, sched, m.seconds, model))
    return out


def _port(records):
    """The same records in the port's types."""
    return [Record.from_json(r.to_json()) for r in records]


def _files(root):
    """Every file of a registry directory: relative path -> text."""
    return {str(p.relative_to(root)): p.read_text() for p in sorted(root.rglob("*")) if p.is_file()}


def _snapshot(reg):
    return [rr.to_json() for rr in reg.snapshot().records]


def test_registry_bytes_generations_snapshots_and_compaction_match(tmp_path):
    recs = _donor_records()
    jreg = JScheduleRegistry(str(tmp_path / "ref"))
    reg = ScheduleRegistry(str(tmp_path / "port"))
    assert _files(tmp_path / "ref") == _files(tmp_path / "port")
    batches = [recs[:4], recs[4:9], recs[9:]]
    modes = ["strict", "adaptive", "strict"]
    for batch, mode in zip(batches, modes):
        g_ref = jreg.publish(batch, mode=mode)
        g_port = reg.publish(_port(batch), mode=mode)
        assert g_ref == g_port == jreg.generation == reg.generation
        assert _files(tmp_path / "ref") == _files(tmp_path / "port")
        assert _snapshot(jreg) == _snapshot(reg)
    assert jreg.compact() == reg.compact()
    assert _files(tmp_path / "ref") == _files(tmp_path / "port")
    assert _snapshot(jreg) == _snapshot(reg)
    assert jreg.stats() == reg.stats()
    # each package reads the other's registry
    assert _snapshot(ScheduleRegistry(str(tmp_path / "ref"))) == _snapshot(jreg)
    assert _snapshot(JScheduleRegistry(str(tmp_path / "port"))) == _snapshot(reg)


def test_auto_compaction_matches(tmp_path):
    recs = _donor_records(per_workload=2)
    jreg = JScheduleRegistry(str(tmp_path / "ref"), auto_compact_segments=2)
    reg = ScheduleRegistry(str(tmp_path / "port"), auto_compact_segments=2)
    for r in recs:
        assert jreg.publish([r]) == reg.publish(_port([r]))
    assert jreg.compactions == reg.compactions > 0
    assert _files(tmp_path / "ref") == _files(tmp_path / "port")


def _services(tmp_path, **kw):
    recs = _donor_records()
    jreg = JScheduleRegistry(str(tmp_path / "ref"))
    reg = ScheduleRegistry(str(tmp_path / "port"))
    jreg.publish(recs)
    reg.publish(_port(recs))
    common = dict(model_id="serving", max_workers=0, seed=0, **kw)
    jsvc = JTuningService(jreg, runner=JCachedRunner(JAnalyticalRunner()), **common)
    svc = TuningService(reg, runner=CachedRunner(AnalyticalRunner()), **common)
    return jsvc, svc


def _lookup(svc, kinst_cls, cls, params):
    lr = svc.lookup(kinst_cls.make(cls, **params))
    return (lr.tier, lr.schedule.to_json() if lr.schedule else None, lr.seconds,
            lr.untuned_seconds, lr.source_model, lr.generation)


@pytest.mark.parametrize("probe_candidates", [4, 0])
def test_tuning_service_lookups_jobs_and_counters_match(tmp_path, probe_candidates):
    """The same lookups, then ``drain()``, then the same lookups again:
    equal answers (tier, schedule, seconds, provenance, generation), job
    order, published upgrades and counters."""
    jsvc, svc = _services(tmp_path, probe_candidates=probe_candidates)
    for cls, params in ASKED:
        assert _lookup(jsvc, JKernelInstance, cls, params) == _lookup(svc, KernelInstance, cls, params)
    assert jsvc.pending_jobs() == svc.pending_jobs()
    assert jsvc.drain() == svc.drain() > 0
    assert jsvc.completed_order == svc.completed_order
    assert _snapshot(jsvc.registry) == _snapshot(svc.registry)
    for cls, params in ASKED:
        assert _lookup(jsvc, JKernelInstance, cls, params) == _lookup(svc, KernelInstance, cls, params)
    js, ps = jsvc.stats(), svc.stats()
    assert json.dumps(js, sort_keys=True) == json.dumps(ps, sort_keys=True)
    assert ps["jobs_completed"] > 0 and ps["upgrades"] > 0
    g = svc.generation()
    assert jsvc.changed_since(0) == svc.changed_since(0)
    assert svc.changed_since(g) == set()
    jsvc.close()
    svc.close()


def test_tuning_service_budget_and_dedup_match(tmp_path):
    """A tiny search budget: the same jobs run, are rejected or deduped."""
    jsvc, svc = _services(tmp_path, budget_s=1e-9)
    for cls, params in ASKED + ASKED:
        _lookup(jsvc, JKernelInstance, cls, params)
        _lookup(svc, KernelInstance, cls, params)
    jsvc.drain()
    svc.drain()
    for cls, params in ASKED:
        _lookup(jsvc, JKernelInstance, cls, params)
        _lookup(svc, KernelInstance, cls, params)
    assert jsvc.completed_order == svc.completed_order
    assert json.dumps(jsvc.stats(), sort_keys=True) == json.dumps(svc.stats(), sort_keys=True)
    assert svc.stats()["jobs_rejected_budget"] > 0 and svc.stats()["jobs_deduped"] > 0


@pytest.mark.parametrize("workers", [0, 2], ids=["deferred", "pool"])
def test_concurrent_misses_queue_one_job_and_late_lookups_hit(tmp_path, workers):
    """Seven threads miss one workload at once (a barrier): one job is
    queued and six lookups dedupe onto it, with the jobs deferred to the
    drain or run by a pool of two.  An eighth lookup made after the job
    published is an exact hit and queues nothing: it is no dedupe.  (The
    reference's ``tests/test_tuning_service.py::test_concurrent_misses_one_job``
    counts all eight lookups as misses while its pool of two may publish
    first, so a thread that reaches the registry late is an exact hit and
    its count of dedupes falls short; the port's service behaves alike.)"""
    import threading

    reg = ScheduleRegistry(str(tmp_path / "reg"))
    reg.publish(_port(_donor_records(1)))
    svc = TuningService(reg, model_id="target", runner=CachedRunner(AnalyticalRunner()),
                        max_workers=workers, seed=0)
    target = KernelInstance.make("matmul", M=256, N=1024, K=512)
    barrier = threading.Barrier(7)
    tiers = []

    def miss():
        barrier.wait()
        tiers.append(svc.lookup(target).tier)

    if workers:                # hold the pool until every thread has missed
        gate = threading.Event()
        inner = svc._run_job
        svc._run_job = lambda: (gate.wait(), inner())[1]
    threads = [threading.Thread(target=miss) for _ in range(7)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if workers:
        gate.set()
    stats = svc.stats()
    assert (stats["jobs_enqueued"], stats["jobs_deduped"]) == (1, 6)
    assert "exact" not in tiers
    svc.drain()
    assert svc.stats()["jobs_completed"] == 1
    assert svc.lookup(target).tier == "exact"
    stats = svc.stats()
    assert (stats["jobs_enqueued"], stats["jobs_deduped"], stats["jobs_completed"]) == (1, 6, 1)
    svc.close()
