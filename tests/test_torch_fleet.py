"""The port's serving fleet (``repro_torch.fleet``, ``launch/serve_fleet.py``)
against ``repro.fleet`` on the CPU.

The policy modules are copies: the router and its policies, the traffic
generators (Poisson, bursty, diurnal, replayed), the demand and acceptance
trackers, the windowed metrics, the autoscaler and the advisor give the
reference's answers on the same inputs.  The fleet itself is a port: on a
reduced minitron-4b with the reference's params converted
(``repro_torch.convert``), at ``tpu-v5e``, the same seeded trace gives the
reference's summary — every field, equal — and its per-request tokens, with
0 schedule mismatches, for slot replicas, paged replicas, a speculative
``auto`` fleet and an autoscaled one.  The reference serves on the CPU on
its ``ref`` path, where an op resolves no schedule; the port is held there
on its ``ref`` path too, and on its default path, where the ops also
resolve their own instances (the global attention's ``window=0`` key,
ROADMAP C.5), the tokens and every field outside the service's lookup
counters are still the reference's.
"""
import dataclasses
import json
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

import repro.fleet as jfleet
import repro.fleet.advisor as jadvisor
import repro.core.autoscheduler as jautosched
import repro.core.database as jdatabase
import repro.core.runner as jrunner
import repro.core.workload as jworkload
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core.tuner import tune_arch_registry as jtune_arch_registry
from repro.models import build_model as jbuild_model
from repro.obs import Tracer as JTracer
from repro.obs.export import chrome_trace as jchrome_trace
from repro.service import ScheduleRegistry as JScheduleRegistry
from repro.serving import make_self_draft as jmake_self_draft
import repro_torch.fleet as tfleet
import repro_torch.fleet.advisor as tadvisor
import repro_torch.core.autoscheduler as tautosched
import repro_torch.core.database as tdatabase
import repro_torch.core.runner as trunner
import repro_torch.core.workload as tworkload
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ops import use_backend
from repro_torch.launch import serve_fleet, trace_report
from repro_torch.launch.serve import stub_extras as serve_stub_extras
from repro_torch.models import build_model
from repro_torch.obs import Tracer
from repro_torch.obs.export import chrome_trace, load_records
from repro_torch.service import ScheduleRegistry
from repro_torch.serving import make_self_draft

PKGS = {"repro": jfleet, "repro_torch": tfleet}


def both(fn):
    """``fn(fleet_package)`` on each package: (reference's, port's)."""
    return fn(jfleet), fn(tfleet)


def test_every_reference_export_is_in_the_port():
    assert set(jfleet.__all__) == set(tfleet.__all__)
    assert sorted(jfleet.POLICIES) == sorted(tfleet.POLICIES)


# ---------------------------------------------------------------------------
# Router and policies (the reference's fake replicas)
# ---------------------------------------------------------------------------


class FakeReplica:
    def __init__(self, free=1, score=0.0, step_s=None):
        self.free_slots = free
        self.score = score
        self.admitted = []
        if step_s is not None:
            self.expected_step_s = lambda: step_s

    def prefill_tier_score(self, prompt_len):
        return self.score

    def admit(self, req, now):
        self.free_slots -= 1
        self.admitted.append(req.uid)


def _req(f, uid, arrival=0.0, deadline=None, plen=3):
    return f.FleetRequest(uid=uid, prompt=[1] * plen, max_new_tokens=2, arrival_s=arrival,
                          deadline_s=deadline)


ROUTING = {
    "backpressure": (dict(free=[0]), "round_robin", 2, [(0, None)] * 3, [0.0]),
    "deadline_shed": (dict(free=[2]), "round_robin", 64, [(0.0, 1.0), (0.0, 100.0)], [5.0]),
    "round_robin": (dict(free=[4, 0, 4]), "round_robin", 16, [(0.0, None)] * 4, [0.0]),
    "least_loaded": (dict(free=[1, 3, 2]), "least_loaded", 16, [(0.0, None)] * 3, [0.0]),
    "plan_aware": (dict(free=[2, 2, 2], score=[0.0, 3.0, 2.0]), "plan_aware", 16,
                   [(0.0, None)] * 3, [0.0]),
    "deadline_fit": (dict(free=[2, 2], score=[5.0, 0.0], step_s=[100.0, 1.0]), "plan_aware", 4,
                     [(0.0, 50.0), (0.0, None)], [0.0, 0.0]),
}


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_router_dispatch_matches_reference(case):
    reps, policy, cap, reqs, dispatch_at = ROUTING[case]

    def run(f):
        n = len(reps["free"])
        fakes = [FakeReplica(reps["free"][i], reps.get("score", [0.0] * n)[i],
                             reps.get("step_s", [None] * n)[i]) for i in range(n)]
        router = f.RequestRouter(fakes, policy=policy, queue_cap=cap)
        out, shed = [], []
        for uid, (arr, ddl) in enumerate(reqs):
            req = _req(f, uid, arrival=arr, deadline=ddl)
            try:
                router.submit(req)
            except f.QueueFull:
                shed.append((uid, req.shed))
        for now in dispatch_at:
            out.append([(r.uid, idx) for r, idx in router.dispatch(now)])
            shed += [(r.uid, r.shed) for r in router.last_shed_deadline]
        return out, shed, router.stats(), [x.admitted for x in fakes]

    ref, port = both(run)
    assert port == ref


def test_unknown_policy_rejected_like_reference():
    def run(f):
        with pytest.raises(KeyError) as e:
            f.make_policy("best_effort")
        return str(e.value)

    ref, port = both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# Traffic: the same seed gives the same requests in both packages
# ---------------------------------------------------------------------------

TRAFFIC = {
    "poisson": ("TrafficGenerator", dict(seed=7, vocab_size=64, arrival_rate=0.5, tick_s=2.0,
                                         prompt_cap=10, deadline_ticks=8.0)),
    "poisson_long": ("TrafficGenerator", dict(seed=0, vocab_size=256000, arrival_rate=0.5,
                                              short_lens=(32, 128), long_lens=(181, 356),
                                              long_frac=0.25, new_tokens=(8, 16),
                                              long_new_tokens=(12, 20), prompt_cap=356)),
    "classes": ("TrafficGenerator", dict(seed=11, class_mix={"chat": 0.7, "bulk": 0.3})),
    "bursty": ("BurstyTraffic", dict(seed=1, vocab_size=64, arrival_rate=0.2, burst_rate=2.0,
                                     burst_every_ticks=50.0, burst_len_ticks=10.0,
                                     offset_ticks=4.0, tick_s=1.0)),
    "diurnal": ("DiurnalTraffic", dict(seed=0, arrival_rate=1.0, amplitude=0.8,
                                       period_ticks=100.0, tick_s=1.0)),
}


def _fields(r):
    return dataclasses.asdict(r)


@pytest.mark.parametrize("kind", sorted(TRAFFIC))
def test_traffic_matches_reference(kind, tmp_path):
    cls, kw = TRAFFIC[kind]

    def run(f):
        gen = getattr(f, cls)(**kw)
        trace = gen.trace(40) + gen.trace(10)     # repeated calls continue the stream
        path = tmp_path / f"{f.__name__}.jsonl"
        f.save_trace(str(path), trace)
        phases = [gen.phase_at(r.arrival_s) for r in trace] if cls == "BurstyTraffic" else None
        rates = [gen.rate_at(t) for t in (0.0, 25.0, 75.0)] if cls != "TrafficGenerator" else None
        return ([_fields(r) for r in trace], path.read_bytes(),
                [_fields(r) for r in f.load_trace(str(path))], phases, rates)

    ref, port = both(run)
    assert port == ref


@pytest.mark.parametrize("bad", [dict(arrival_rate=0.0), dict(class_mix={}),
                                 dict(class_mix={"a": -1.0})])
def test_traffic_validation_matches_reference(bad):
    def run(f):
        with pytest.raises(ValueError) as e:
            f.TrafficGenerator(**bad)
        return str(e.value)

    ref, port = both(run)
    assert port == ref


def test_sample_prompts_matches_reference():
    ref, port = both(lambda f: f.sample_prompts(np.random.default_rng(3), 12, 512, lo=2, hi=40))
    assert port == ref


# ---------------------------------------------------------------------------
# Demand, acceptance, windowed metrics, autoscaler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("half_life", [None, 1.0, 10.0])
def test_demand_tracker_matches_reference(half_life):
    def run(f):
        d = f.DemandTracker(bucket_for=lambda n: 1 << (n - 1).bit_length(),
                            half_life_s=half_life)
        out = []
        for i, (plen, t) in enumerate([(3, 0.0)] * 5 + [(9, 2.0)] * 2 + [(30, 50.0), (3, 200.0),
                                                                          (9, 201.0)]):
            d.record(_req(f, i, arrival=t, plen=plen))
            out.append((d.hottest(), d.total, d.weighted(lambda b: 1.0 if b == 4 else 0.0)))
        return out, d.stats()

    ref, port = both(run)
    assert port == ref


def test_acceptance_tracker_matches_reference():
    def run(f):
        a = f.AcceptanceTracker()
        out = []
        for i in range(30):
            cls = ("chat", "bulk", "")[i % 3]
            a.record(cls, 4, (i * 7) % 5, float(i))
            out.append((a.alpha("chat"), a.alpha("bulk"), a.alpha(""), a.alpha("new")))
        return out, a.stats()

    ref, port = both(run)
    assert port == ref


def test_fleet_metrics_windows_match_reference():
    def run(f):
        m = f.FleetMetrics()
        for uid, (arr, fin) in enumerate(((0.0, 1.0), (0.5, 1.5), (2.2, 3.0), (2.5, 3.9))):
            r = _req(f, uid, arrival=arr)
            r.tokens, r.prefill_done_s, r.admitted_s = 2, arr + 0.1, arr
            m.record_completion(r, fin)
        shed = _req(f, 9, arrival=1.4)
        shed.shed = "queue_full"
        m.record_shed(shed, 1.4)
        for depth, t in ((4, 0.5), (2, 1.5), (0, 2.5)):
            m.sample_queue(depth, t)
        m.sample_utilization(1.0, 0.5)
        m.sample_utilization(0.0, 2.5)
        m.sample_capacity(10, 40)
        return (m.window(0.0, 2.0), m.window(2.0, 4.0), m.window_summaries(2.0),
                m.summary(tick_s=0.25), f.percentile([6.0, 8.0, 1.0], 95))

    ref, port = both(run)
    assert port == ref


def _win(**kw):
    w = {"t0": 0.0, "t1": 10.0, "completed": 5, "shed": 0, "shed_rate": 0.0, "tokens": 20,
         "latency_s": {"p50": 1.0, "p95": 2.0, "p99": 2.0}, "queue_depth_mean": 0.0,
         "queue_depth_max": 0, "utilization_mean": 0.5}
    w.update(kw)
    return w


SCALING = {
    "hot_streak": (dict(up_windows=2, queue_high=2.0, cooldown_s=0.0),
                   [(_win(queue_depth_mean=5.0), 1), (_win(), 1),
                    (_win(queue_depth_mean=5.0), 1), (_win(queue_depth_mean=5.0), 1)]),
    "cooldown": (dict(up_windows=1, down_windows=1, cooldown_s=30.0, queue_high=2.0,
                      util_low=0.4, queue_low=0.5),
                 [(_win(queue_depth_mean=5.0), 2), (_win(utilization_mean=0.1), 3),
                  (_win(queue_depth_mean=5.0), 3), (_win(utilization_mean=0.1), 3),
                  (_win(queue_depth_mean=5.0), 3)]),
    "bounds": (dict(up_windows=1, down_windows=2, cooldown_s=0.0, max_replicas=2),
               [(_win(shed=3, shed_rate=0.4), 2)] + [(_win(utilization_mean=0.1), 2)] * 2
               + [(_win(utilization_mean=0.1), 1)] * 2),
    "p95_trend": (dict(up_windows=1, cooldown_s=0.0, p95_rise=0.5),
                  [(_win(), 1), (_win(latency_s={"p50": 1.5, "p95": 4.0, "p99": 5.0}), 1)]),
    "slo_alerts": (dict(up_windows=1, cooldown_s=0.0),
                   [(_win(slo_alerts=1), 1), (_win(slo_alerts=0), 2)]),
}


@pytest.mark.parametrize("case", sorted(SCALING))
def test_autoscaler_decisions_match_reference(case):
    kw, windows = SCALING[case]
    kw = {"min_replicas": 1, "max_replicas": 4, "window_s": 10.0, "cooldown_s": 30.0, **kw}

    def run(f):
        a = f.Autoscaler(**kw)
        out = [dataclasses.asdict(a.observe(dict(w), now=10.0 * (i + 1), replicas=n))
               for i, (w, n) in enumerate(windows)]
        return out, a.stats()

    ref, port = both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# Advisor (the reference's fakes)
# ---------------------------------------------------------------------------

ADV = {"repro": (jadvisor, jworkload, jdatabase, jrunner, jautosched),
       "repro_torch": (tadvisor, tworkload, tdatabase, trunner, tautosched)}


class _Res:
    def __init__(self, tier):
        self.schedule, self.tier, self.source_model = object(), tier, "donor_a"


class _AdvReplica:
    target = "tpu-v5e"

    def __init__(self, counts, uses, served, untuned):
        self.cell_counts, self._uses, self._served, self._untuned = counts, uses, served, untuned

    def cell_uses(self, cell):
        return self._uses.get(cell, [])

    def cell_workload_seconds(self, cell):
        return [(u, u.use_count * self._served[u.instance.workload_key()])
                for u in self.cell_uses(cell)]

    def use_resolution(self, instance):
        return _Res("transfer")

    def use_seconds(self, instance, schedule):
        key = instance.workload_key()
        return self._untuned[key] if schedule is None else self._served[key]


class _AdvService:
    target = donor_target = "tpu-v5e"

    def __init__(self, db, runner, attempted=()):
        self.registry = type("R", (), {"snapshot": lambda s: type(
            "S", (), {"db": lambda s2, mode=None: db})()})()
        self.runner = runner
        self._attempted = set(attempted)

    def donor_models(self, db):
        return ["donor_a"]

    def attempted(self, key):
        return key in self._attempted


class _AdvFleet:
    def __init__(self, replicas, services):
        self.replicas, self.services = replicas, services

    def live_replicas(self):
        return self.replicas


@pytest.mark.parametrize("case", ["donor_prior", "exhausted", "ties"])
def test_advisor_ranking_matches_reference(case):
    def run(pkg):
        adv, wl, db_mod, rn, auto = ADV[pkg]
        a = wl.KernelInstance.make("matmul", M=128, N=128, K=128)
        b = wl.KernelInstance.make("matmul", M=160, N=160, K=160)
        c = wl.KernelInstance.make("matmul", M=96, N=96, K=96)
        runner = rn.AnalyticalRunner()
        donor = wl.KernelInstance.make("matmul", M=192, N=192, K=192)
        sched = auto.tune_kernel(a, trials=16, seed=0).best
        db = db_mod.ScheduleDB()
        if case != "ties":
            db.add(db_mod.Record(donor, sched, 0.25 * runner.seconds(donor, None), "donor_a"))
        if case == "exhausted":
            db.add(db_mod.Record(a, sched, 0.5, "target_model"))
        served = {a.workload_key(): 1.0, b.workload_key(): 0.25 if case != "ties" else 1.0,
                  c.workload_key(): 6.0}
        rep = _AdvReplica({"verify": 3, "draft_decode": 10, "prefill:8": 1},
                          {"verify": [wl.KernelUse(a, use_count=2)],
                           "draft_decode": [wl.KernelUse(b)],
                           "prefill:8": [wl.KernelUse(c)]},
                          served, {k: 2.0 * v for k, v in served.items()})
        svc = _AdvService(db, runner, attempted=[c.workload_key()] if case != "ties" else ())
        advisor = adv.TuningAdvisor(default_headroom=0.5, min_headroom=0.1)
        ranked = advisor.rank(_AdvFleet([rep], {"tpu-v5e": svc}))
        return [(r.instance.workload_key(), r.target, r.priority, r.critical_s, r.headroom)
                for r in ranked], advisor.class_headroom(a, svc, db)

    ref, port = run("repro"), run("repro_torch")
    assert port == ref


# ---------------------------------------------------------------------------
# The fleet on reduced minitron-4b, converted params
# ---------------------------------------------------------------------------

_LM = {}


def small_lm():
    """(reference cfg, model, params, port cfg, model, converted params)."""
    if not _LM:
        jcfg, cfg = jreduced(jget_arch("minitron-4b")), reduced(get_arch("minitron-4b"))
        jmodel = jbuild_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        model = build_model(cfg, "cpu")
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
        _LM.update(ref=(jcfg, jmodel, jparams), port=(cfg, model, params))
    return _LM["ref"], _LM["port"]


@pytest.fixture(scope="module")
def donor_registry(tmp_path_factory):
    """A registry of donor records tuned by the reference (the port reads
    the same bytes), so transfers and upgrades happen while serving."""
    root = tmp_path_factory.mktemp("donors")
    jtune_arch_registry(JScheduleRegistry(str(root)), "starcoder2-7b", "decode_32k", dp=16,
                        tp=16, total_trials=64, seed=0)
    return root


FLEETS = {
    "slot": dict(replicas=2, slots=2, max_len=32, policy="plan_aware", prefetch=True,
                 queue_cap=8, slos="default"),
    "paged": dict(replicas=2, slots=2, max_len=32, engine="paged", decode_batch=4, page_size=4,
                  pool_pages=2 * 32 // 4 + 1, chunk=8, policy="plan_aware", queue_cap=8,
                  prefetch="advisor"),
    "spec_auto": dict(replicas=1, max_len=32, engine="paged", decode_batch=2, page_size=4,
                      chunk=8, speculative="auto", spec_k=3, prefetch=True),
    "autoscaled": dict(replicas=1, slots=2, max_len=32, policy="least_loaded", queue_cap=8),
}


def _traffic(f, kind, vocab, tick_s):
    if kind == "autoscaled":
        return f.BurstyTraffic(seed=2, vocab_size=vocab, arrival_rate=0.3, burst_rate=3.0,
                               burst_every_ticks=40.0, burst_len_ticks=10.0, offset_ticks=4.0,
                               tick_s=tick_s, short_lens=(3, 6), long_lens=(8, 12),
                               new_tokens=(2, 4), prompt_cap=12).trace(24)
    mix = {"chat": 0.7, "bulk": 0.3} if kind == "spec_auto" else None
    return f.TrafficGenerator(seed=3, vocab_size=vocab, arrival_rate=1.2, tick_s=tick_s,
                              short_lens=(3, 6), long_lens=(8, 12), new_tokens=(2, 6),
                              prompt_cap=12, class_mix=mix).trace(12)


def _serve(pkg, kind, root, tracer=None):
    """Serve ``kind``'s trace on one package's fleet: (summary, fleet,
    tokens by uid).  Each fleet reads its own copy of the donor store."""
    (jcfg, jmodel, jparams), (cfg, model, params) = small_lm()
    f = PKGS[pkg]
    c, m, p = (jcfg, jmodel, jparams) if pkg == "repro" else (cfg, model, params)
    kw = dict(FLEETS[kind])
    if kw.get("speculative"):
        sd = jmake_self_draft if pkg == "repro" else make_self_draft
        dcfg, dparams, p = sd(c, p, keep_layers=1, damp=0.0)
        # a confident prior: at this size a burst pays only near alpha = 1
        kw.update(draft_model=jbuild_model(dcfg) if pkg == "repro" else build_model(dcfg, "cpu"),
                  draft_params=dparams, acceptance=f.AcceptanceTracker(prior_alpha=0.95))
    registry = (JScheduleRegistry if pkg == "repro" else ScheduleRegistry)(str(root))
    fleet = f.ServingFleet(c, m, p, registry=registry, tracer=tracer, **kw)
    if kind == "autoscaled":
        fleet.attach_autoscaler(f.Autoscaler(
            min_replicas=1, max_replicas=2, window_s=8.0 * fleet.tick_s,
            cooldown_s=8.0 * fleet.tick_s, up_windows=1, down_windows=2,
            queue_high=1.0, util_low=0.6, queue_low=0.75))
    try:
        summary = fleet.serve(_traffic(f, kind, c.vocab_size, fleet.tick_s))
    finally:
        fleet.close()
    tokens = {r.uid: r.generated for r in fleet.metrics.completed}
    return summary, fleet, tokens


_REF_RUNS = {}


def _reference_run(kind, donor_registry, tmp_path):
    """The reference fleet's (summary, tokens, Chrome trace JSON) for
    ``kind``, served once per session."""
    if kind not in _REF_RUNS:
        from repro.service import TuningService as JTuningService

        keys, real = set(), JTuningService.lookup

        def lookup(self, instance):
            keys.add(instance.workload_key())
            return real(self, instance)

        tr = JTracer()
        JTuningService.lookup = lookup
        try:
            summary, _, tokens = _serve("repro", kind, _copy_store(donor_registry, tmp_path, "a"),
                                        tr)
        finally:
            JTuningService.lookup = real
        _REF_RUNS[kind] = summary, tokens, json.dumps(jchrome_trace(tr))
        _REF_RUNS[f"{kind}_keys"] = keys
    return _REF_RUNS[kind]


def _copy_store(donor_registry, tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(donor_registry, dst)
    return dst


@pytest.mark.parametrize("kind", sorted(FLEETS))
def test_fleet_summary_and_tokens_match_reference(kind, donor_registry, tmp_path):
    """The same seeded trace, the same donor store and converted params give
    the reference's whole summary and per-request tokens; 0 mismatches;
    the Chrome traces of the two runs are byte-equal."""
    want, want_tokens, want_trace = _reference_run(kind, donor_registry, tmp_path)
    tr = Tracer()
    with use_backend("ref"):
        got, f, got_tokens = _serve("repro_torch", kind,
                                    _copy_store(donor_registry, tmp_path, "b"), tr)
    assert got == want
    assert got_tokens == want_tokens and len(got_tokens) == got["completed"] > 0
    assert got["schedule_mismatches"] == 0
    assert got["completed"] + got["shed"] == (24 if kind == "autoscaled" else 12)
    assert json.dumps(chrome_trace(tr)) == want_trace
    if kind == "autoscaled":
        assert any(e["action"] == "join" for e in got["scale_events"])
    if kind == "spec_auto":
        assert got["speculative"]["counters"]["bursts"] > 0
    if kind == "slot":
        assert got["tuning"]["tpu-v5e"]["upgrades"] > 0 and "speedup_ledger" in got


def test_default_path_keeps_tokens_and_looks_up_only_its_op_keys_besides(donor_registry,
                                                                        tmp_path, monkeypatch):
    """On its default path the port's ops resolve their own instances while
    the plain versions run on the CPU tensors: the tokens are the
    reference's, and the only workloads its service looks up beyond the
    reference's are the global attention's op-side keys (``window=0``,
    which ``extract_kernels`` lists without a window: ROADMAP C.5)."""
    from repro_torch.service import TuningService

    seen = {}
    real = TuningService.lookup

    def lookup(self, instance):
        seen[instance.workload_key()] = instance
        return real(self, instance)

    _, want_tokens, _ = _reference_run("slot", donor_registry, tmp_path)
    want_keys = _REF_RUNS["slot_keys"]
    monkeypatch.setattr(TuningService, "lookup", lookup)
    got, fleet, got_tokens = _serve("repro_torch", "slot",
                                    _copy_store(donor_registry, tmp_path, "b"))
    assert got_tokens == want_tokens
    assert got["schedule_mismatches"] == 0 and got["completed"] > 0
    assert want_keys <= set(seen)
    extra = [seen[k] for k in set(seen) - want_keys]
    assert extra and all(i.class_id == "flash_attention_causal" and i.p["window"] == 0
                         for i in extra)


def test_measured_target_on_the_cpu_is_refused(tmp_path):
    _, (cfg, model, params) = small_lm()
    with pytest.raises(ValueError, match="timed on the card"):
        tfleet.ServingFleet(cfg, model, params, replicas=1, slots=2, max_len=32,
                            targets="h100", registry=ScheduleRegistry(str(tmp_path)))
    with pytest.raises(ValueError, match="timed on the card"):
        tfleet.ServingFleet(cfg, model, params, replicas=1, slots=2, max_len=32,
                            targets="h100")
    # a modelled target never wears the measured runner
    fleet = tfleet.ServingFleet(cfg, model, params, replicas=2, slots=2, max_len=32,
                                registry=ScheduleRegistry(str(tmp_path / "reg")))
    runner = fleet.runner_for("tpu-v5e")
    assert type(runner.inner).__name__ == "AnalyticalRunner"
    assert fleet.services["tpu-v5e"].runner is runner
    assert all(r._runner is runner for r in fleet.replicas)
    fleet.close()


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_audio_and_vision_archs_are_refused(arch, tmp_path):
    """The audio and vision archs are served, no longer refused: on reduced
    configs with the reference's params converted and its stub inputs (zero
    frames, zero patch embeddings) as ``extras``, slot replicas give the
    reference fleet's whole summary and per-request tokens."""
    jcfg, cfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    extras = serve_stub_extras(cfg)

    def run(f, c, m, p, registry):
        fleet = f.ServingFleet(c, m, p, registry=registry, extras=extras,
                               **FLEETS["slot"] | {"slos": None})
        try:
            summary = fleet.serve(_traffic(f, "slot", c.vocab_size, fleet.tick_s)[:8])
        finally:
            fleet.close()
        return summary, {r.uid: r.generated for r in fleet.metrics.completed}

    want = run(jfleet, jcfg, jmodel, jparams, JScheduleRegistry(str(tmp_path / "a")))
    with use_backend("ref"):
        got = run(tfleet, cfg, model, params, ScheduleRegistry(str(tmp_path / "b")))
    assert got == want
    assert got[0]["completed"] > 0 and got[0]["schedule_mismatches"] == 0


def test_serve_fleet_main_prints_summary_and_trace_report_attributes_all(tmp_path, capsys):
    path = str(tmp_path / "trace.json")
    summary = serve_fleet.main(["--device", "cpu", "--preset", "smoke", "--requests", "10",
                                "--prefetch", "--slo", "--trace-out", path])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(summary))
    assert summary["completed"] + summary["shed"] == 10 and summary["completed"] > 0
    assert summary["schedule_mismatches"] == 0
    assert {"slo", "speedup_ledger", "tuning"} <= set(summary)
    assert list(summary["tuning"]) == ["tpu-v5e"]
    report = trace_report.main([path, "--json"])
    assert report["critical_path"]["attributed_frac"] == 1.0
    assert report["latency"]["requests"] == summary["completed"]
    assert any(r["kind"] == "span" for r in load_records(path))
