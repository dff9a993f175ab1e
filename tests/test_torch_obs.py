"""The port's copies of ``repro.obs`` (``export``, ``slo``, ``ledger``,
``report``, ``profiler``) and ``repro.launch.trace_report``, held against
the originals on the same inputs.

The cases are the reference's own (``tests/test_obs.py``,
``tests/test_slo.py``): each builds its inputs once per package with that
package's classes and the answers must be equal — SLO badness, burn rates,
statuses, alert events and summaries; speedup-ledger entries and
aggregates; report tables and the CLI's text; critical-path rows; and the
exporters' files, byte for byte.
"""
import dataclasses
import json
import types

import pytest

pytest.importorskip("torch")

import repro.core.workload as jworkload
import repro.launch.trace_report as jtrace_report
import repro.obs as jobs
import repro.obs.export as jexport
import repro.obs.ledger as jledger
import repro.obs.profiler as jprofiler
import repro_torch.core.workload as tworkload
import repro_torch.launch.trace_report as ttrace_report
import repro_torch.obs as tobs
import repro_torch.obs.export as texport
import repro_torch.obs.ledger as tledger
import repro_torch.obs.profiler as tprofiler

PKGS = {
    "repro": types.SimpleNamespace(obs=jobs, export=jexport, ledger=jledger,
                                   profiler=jprofiler, workload=jworkload,
                                   trace_report=jtrace_report),
    "repro_torch": types.SimpleNamespace(obs=tobs, export=texport, ledger=tledger,
                                         profiler=tprofiler, workload=tworkload,
                                         trace_report=ttrace_report),
}


def both(fn):
    """``fn(pkg)`` on each package: (reference's answer, port's answer)."""
    return fn(PKGS["repro"]), fn(PKGS["repro_torch"])


def test_every_reference_export_is_in_the_port():
    assert set(jobs.__all__) == set(tobs.__all__)
    for name in jobs.__all__:
        assert hasattr(tobs, name), name


# ---------------------------------------------------------------------------
# SLOs: the reference's fakes and outcome streams
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FakeRequest:
    arrival_s: float = 0.0
    finished_s: float = None
    latency_s: float = None
    prefill_done_s: float = None
    deadline_s: float = None
    shed: bool = False
    shed_s: float = None


def done(fin, lat, **kw):
    return FakeRequest(arrival_s=fin - lat, finished_s=fin, latency_s=lat, **kw)


class FakeFleetMetrics:
    def __init__(self, completed=(), shed=()):
        self.completed = list(completed)
        self.shed = list(shed)


BADNESS = [
    (("l", "latency"), dict(threshold_s=5.0), done(10.0, 6.0)),
    (("l", "latency"), dict(threshold_s=5.0), done(10.0, 5.0)),
    (("t", "ttft"), dict(threshold_s=2.0), done(10.0, 4.0, prefill_done_s=9.0)),
    (("t", "ttft"), dict(threshold_s=2.0), done(10.0, 4.0, prefill_done_s=7.5)),
    (("t", "ttft"), dict(threshold_s=2.0), done(10.0, 3.0)),
    (("t", "ttft"), dict(threshold_s=2.0), done(10.0, 1.5)),
    (("s", "shed"), dict(objective=0.98), done(10.0, 100.0)),
    (("d", "deadline"), {}, done(10.0, 1.0, deadline_s=9.0)),
    (("d", "deadline"), {}, done(10.0, 1.0, deadline_s=11.0)),
    (("d", "deadline"), {}, done(10.0, 1.0)),
    (("l", "latency"), dict(threshold_s=5.0), FakeRequest(shed=True, shed_s=3.0)),
    (("d", "deadline"), {}, FakeRequest(shed=True, shed_s=3.0)),
]


@pytest.mark.parametrize("case", range(len(BADNESS)))
def test_slo_is_bad_matches_reference(case):
    (name, kind), kw, req = BADNESS[case]
    ref, port = both(lambda p: (p.obs.SLO(name, kind, **kw).is_bad(req),
                                p.obs.SLO(name, kind, **kw).budget))
    assert port == ref


@pytest.mark.parametrize("bad", [dict(kind="throughput"), dict(kind="shed", objective=0.0),
                                 dict(kind="shed", objective=1.5), dict(kind="latency"),
                                 dict(kind="shed", fast_windows=0),
                                 dict(kind="shed", fast_windows=3, slow_windows=2)])
def test_slo_validation_matches_reference(bad):
    def build(p):
        with pytest.raises(ValueError) as e:
            p.obs.SLO("x", **bad)
        return str(e.value)

    ref, port = both(build)
    assert port == ref


def _stream_latency():
    slos = [("p95", "latency", dict(objective=0.8, threshold_s=5.0))]
    return slos, [done(2.0, 3.0), done(4.0, 7.0), done(6.0, 7.0), done(8.0, 7.0)], [], \
        [10.0, 20.0, 30.0]


def _stream_sheds():
    return [("shed", "shed", dict(objective=0.9))], [done(5.0, 1.0)], \
        [FakeRequest(shed=True, shed_s=6.0)], [10.0, 20.0]


def _stream_blip():
    slos = [("p", "latency", dict(objective=0.5, threshold_s=5.0, fast_windows=1,
                                  slow_windows=2))]
    comp = [done(t, 1.0) for t in (1.0, 3.0, 5.0, 7.0)] + [done(12.0, 9.0), done(14.0, 9.0)]
    return slos, comp, [], [20.0]


def _stream_lifecycle():
    slos = [("p95", "latency", dict(objective=0.8, threshold_s=5.0, fast_windows=1,
                                    slow_windows=2)),
            ("d", "deadline", {}), ("t", "ttft", dict(threshold_s=2.0))]
    comp = [done(t, 9.0, deadline_s=t - 1.0) for t in (2.0, 4.0, 6.0)] + [done(25.0, 1.0)]
    return slos, comp, [FakeRequest(shed=True, shed_s=22.0)], [10.0, 20.0, 30.0, 40.0]


def _stream_defaults():
    tick = 0.01
    comp = [done(0.02 * i, 0.003 * (i % 7), prefill_done_s=0.02 * i - 0.001,
                 deadline_s=0.02 * i + (0.01 if i % 3 else -0.01)) for i in range(1, 40)]
    shed = [FakeRequest(shed=True, shed_s=0.05 * i) for i in range(1, 6)]
    return tick, comp, shed, [0.04 * i for i in range(1, 21)]


STREAMS = {"latency": _stream_latency, "sheds": _stream_sheds, "blip": _stream_blip,
           "lifecycle": _stream_lifecycle, "defaults": _stream_defaults}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_slo_monitor_statuses_and_burn_rates_match_reference(stream):
    """The same outcome stream through each package's SLOMonitor: every
    window's statuses, burn rates, alert events, gauges and the summary."""
    spec, comp, shed, evals = STREAMS[stream]()

    def run(p):
        tr = p.obs.Tracer(clock=lambda: 0.0)
        if isinstance(spec, float):
            slos = p.obs.default_slos(spec)
        else:
            slos = [p.obs.SLO(n, k, **kw) for n, k, kw in spec]
        mon = p.obs.SLOMonitor(slos, FakeFleetMetrics(comp, shed), window_s=evals[0],
                               tracer=tr)
        burns = [mon.burn_rate(s, 0.0, t) for s in slos for t in evals]
        statuses = [[dataclasses.asdict(st) for st in mon.evaluate(t)] for t in evals]
        gauges = {name: list(getattr(mon.metrics.get(name), "samples", [])) or
                  mon.metrics.get(name).value for name in sorted(mon.metrics.to_json())}
        return (burns, statuses, mon.summary(), mon.alerting(), mon.last_alert_end(),
                [(e.name, e.track, e.t, e.attrs) for e in tr.events], gauges)

    ref, port = both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# Critical-path profiler
# ---------------------------------------------------------------------------

SPAN_CELLS = [("prefill", None, dict(bucket=16)), ("chunk", None, dict(len=8)),
              ("decode_step", None, {}), ("decode", None, {}), ("verify", None, {}),
              ("draft_burst", None, dict(steps=4)), ("draft_sync", None, dict(len=16)),
              ("step", None, {}), ("prefill", "request", {})]


@pytest.mark.parametrize("name,cat,attrs", SPAN_CELLS)
def test_span_cell_matches_reference(name, cat, attrs):
    rec = {"name": name, "cat": cat, "attrs": attrs}
    ref, port = both(lambda p: p.profiler.span_cell(rec))
    assert port == ref


def _profiled_tracer(p):
    """The reference's profiler fixture: two finished requests, cell spans,
    workload maps, a plan-generation flip."""
    tr = p.obs.Tracer(clock=lambda: 0.0)
    for uid, (arr, adm, pd, fin) in {"1": (0.0, 1.0, 2.0, 6.0),
                                     "2": (1.0, 1.5, 3.0, 9.0)}.items():
        tr.add_async_span("request", "replica-0", arr, fin, "request", uid, uid=int(uid))
        tr.add_async_span("queue", "replica-0", arr, adm, "request", uid)
        tr.add_async_span("prefill", "replica-0", adm, pd, "request", uid)
        tr.add_async_span("decode", "replica-0", pd, fin, "request", uid)
    tr.event("cell_workloads", "replica-0", t=0.0, cell="prefill:8",
             workloads=[["wkA", 0.2], ["wkC", 0.3]])
    tr.event("cell_workloads", "replica-0", t=0.0, cell="verify", workloads=[["wkA", 0.1]])
    tr.event("cell_workloads", "replica-0", t=0.0, cell="draft_decode",
             workloads=[["wkB", 0.05]])
    tr.event("cell_workloads", "replica-0", t=2.2, cell="verify", workloads=[["wkA", 0.4]])
    tr.add_span("chunk", "replica-0", 1.0, 2.0, len=8)
    tr.add_span("verify", "replica-0", 2.0, 2.5)
    tr.add_span("draft_burst", "replica-0", 2.5, 3.0, steps=4)
    tr.add_span("verify", "replica-0", 3.0, 3.2)
    return tr


def _unmapped_tracer(p):
    tr = p.obs.Tracer(clock=lambda: 0.0)
    tr.add_span("verify", "replica-0", 0.0, 1.0)
    return tr


@pytest.mark.parametrize("fixture", [_profiled_tracer, _unmapped_tracer],
                         ids=["profiled", "unmapped"])
def test_critical_path_rows_match_reference(fixture):
    def run(p):
        recs = p.export._records(fixture(p))
        return p.profiler.critical_path(recs), p.profiler.request_breakdown(recs)

    ref, port = both(run)
    assert port == ref
    if fixture is _profiled_tracer:
        assert port[0]["attributed_frac"] == 1.0


# ---------------------------------------------------------------------------
# Speedup ledger and the live profiler over a fake replica
# ---------------------------------------------------------------------------


class FakeResolution:
    def __init__(self, schedule, tier, source_model):
        self.schedule, self.tier, self.source_model = schedule, tier, source_model


class FakeReplica:
    target = "tpu-v5e"
    service = None

    def __init__(self, counts, uses, served_s, untuned_s, tier="transfer"):
        self.cell_counts = dict(counts)
        self._uses, self._served, self._untuned, self._tier = uses, served_s, untuned_s, tier

    def cell_uses(self, cell):
        return self._uses.get(cell, [])

    def cell_workload_seconds(self, cell):
        return [(u, u.use_count * self._served[u.instance.workload_key()])
                for u in self.cell_uses(cell)]

    def use_resolution(self, instance):
        return FakeResolution(object(), self._tier, "donor_a")

    def use_seconds(self, instance, schedule):
        key = instance.workload_key()
        return self._untuned[key] if schedule is None else self._served[key]


def _fake_replica(p, tier="transfer"):
    a = p.workload.KernelInstance.make("matmul", M=128, N=128, K=128)
    b = p.workload.KernelInstance.make("matmul", M=160, N=160, K=160)
    return FakeReplica(
        counts={"verify": 3, "draft_decode": 10},
        uses={"verify": [p.workload.KernelUse(a, use_count=2)],
              "draft_decode": [p.workload.KernelUse(b, use_count=1)]},
        served_s={a.workload_key(): 1.0, b.workload_key(): 0.25},
        untuned_s={a.workload_key(): 2.0, b.workload_key(): 0.25}, tier=tier)


def _plain(live):
    return {k: {f: (v.workload_key() if f == "instance" else v) for f, v in row.items()}
            for k, row in live.items()}


@pytest.mark.parametrize("tier", ["transfer", "exact", "default"])
def test_live_workload_seconds_and_ledger_update_match_reference(tier):
    def run(p):
        rep = _fake_replica(p, tier)
        led = p.obs.SpeedupLedger()
        agg1 = led.update([rep], now=7.0)
        rep.cell_counts["verify"] += 2
        agg2 = led.update([rep], now=9.0)
        entries = {k: dataclasses.asdict(e) for k, e in sorted(led.entries.items())}
        return (_plain(p.profiler.live_workload_seconds([rep])), agg1, agg2, entries,
                led.summary(), led.metrics.get("ledger.realized_speedup").samples)

    ref, port = both(run)
    assert port == ref


def test_ledger_entries_aggregates_and_speedup_for_match_reference():
    def run(p):
        E = p.ledger.LedgerEntry
        e = E(key="k", target="t", class_id="c", tier="transfer", source_model="d",
              untuned_s=2.0, served_s=1.0, best_s=0.8, weight=4.0)
        props = [(x.realized_speedup, x.attainable_speedup, x.headroom_s)
                 for x in (e, dataclasses.replace(e, best_s=None))]
        led = p.obs.SpeedupLedger()
        led.entries = {("a", "t"): E("a", "t", "c", "exact", "d", 2.0, 1.0, 1.0),
                       ("b", "t"): E("b", "t", "c", "default", "", 1.0, 1.0, 0.5)}
        agg = led.aggregates()
        a = p.workload.KernelInstance.make("matmul", M=128, N=128, K=128)
        b = p.workload.KernelInstance.make("matmul", M=160, N=160, K=160)
        led.entries = {(a.workload_key(), "t"): E(a.workload_key(), "t", "c", "transfer",
                                                  "d", 2.0, 1.0, 0.5),
                       ("small", "t"): E("small", "t", "c", "transfer", "d", 2.0, 1.0, 0.5,
                                         weight=1.0),
                       ("big", "t"): E("big", "t", "c", "transfer", "d", 2.0, 1.0, 0.9,
                                       weight=100.0)}
        return (props, agg, led.speedup_for([p.workload.KernelUse(a, use_count=3)], "t"),
                led.speedup_for([p.workload.KernelUse(b)], "t"),
                [x.key for x in led.top_headroom(3)], led.summary())

    ref, port = both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# Exporters, byte for byte; report tables and the CLI's text
# ---------------------------------------------------------------------------


def _sample_tracer(p):
    tr = p.obs.Tracer(clock=lambda: 0.0)
    s = tr.add_span("step", "replica-0", 0.0, 3.0, n=2)
    tr.add_span("chunk", "replica-0", 0.0, 2.0, parent=s, len=8)
    tr.add_async_span("request", "replica-0", 0.5, 2.5, "request", "7", uid=7, latency_s=2.0)
    tr.event("shed", "router", t=1.0, uid=9, reason="queue_full")
    return tr


def _awkward_tracer(p):
    tr = p.obs.Tracer(clock=lambda: 0.0)
    t0, t1 = 1.0 / 3.0, 0.1 + 0.2
    s = tr.add_span("step", "replica-0", t0, 7 * t1, n=2)
    tr.add_span("verify", "replica-0", 2 * t0, 5 * t1, parent=s)
    tr.add_async_span("request", "replica-0", t0, 6 * t1, "request", "1", uid=1,
                      latency_s=6 * t1 - t0)
    tr.event("cell_workloads", "replica-0", t=t0, cell="verify", workloads=[["wk", 0.1]])
    return tr


def _golden_tracer(p):
    """Two served requests and one shed, two tuning jobs, a scale decision,
    SLO, ledger and acceptance events."""
    tr = p.obs.Tracer(clock=lambda: 0.0)
    for uid, (arr, adm, pd, fin) in {"1": (0.0, 1.0, 2.0, 6.0),
                                     "2": (1.0, 1.5, 3.0, 9.0)}.items():
        tr.add_async_span("request", "replica-0", arr, fin, "request", uid, uid=int(uid))
        tr.add_async_span("queue", "replica-0", arr, adm, "request", uid)
        tr.add_async_span("prefill", "replica-0", adm, pd, "request", uid)
        tr.add_async_span("decode", "replica-0", pd, fin, "request", uid)
    tr.event("shed", "router", t=2.0, uid=3, reason="queue_full")
    for t, tier in ((0.5, "default"), (4.0, "default"), (8.0, "exact")):
        tr.event("lookup", "tuning/tpu-v5e", t=t, key="k", tier=tier, generation=0)
    tr.add_async_span("tune", "tuning/tpu-v5e", 2.0, 5.0, "tune", "k", key="k", search_s=3.0)
    tr.event("scale_decision", "autoscaler", t=4.0, action="up", reason="queue", replicas=1)
    tr.event("join", "autoscaler", t=4.0, replica=1, target="tpu-v5e")
    tr.event("slo_alert", "slo", t=5.0, slo="p95", burn_fast=3.0, burn_slow=2.5)
    tr.event("slo_clear", "slo", t=8.0, slo="p95", burn_fast=0.0, burn_slow=0.5)
    tr.event("ledger", "ledger", t=6.0, realized_speedup=1.5, attainable_speedup=2.0,
             realized_fraction=0.75, tuned_workloads=1, workloads=4)
    tr.event("spec_route", "router", t=3.0, uid=1, request_class="chat", speculative=True)
    return tr


TRACERS = {"sample": _sample_tracer, "awkward": _awkward_tracer, "golden": _golden_tracer,
           "profiled": _profiled_tracer}


@pytest.mark.parametrize("name", sorted(TRACERS))
def test_exports_are_byte_equal_to_reference(name, tmp_path):
    """chrome_trace JSON, the written Chrome file and the JSON-lines file
    are byte for byte the reference's, and both fold back to its records."""
    def run(p):
        d = tmp_path / p.obs.__name__
        d.mkdir()
        tr = TRACERS[name](p)
        p.export.write_chrome_trace(str(d / "t.json"), tr)
        p.export.write_jsonl(str(d / "t.jsonl"), tr)
        return (json.dumps(p.export.chrome_trace(tr), sort_keys=False),
                (d / "t.json").read_bytes(), (d / "t.jsonl").read_bytes(),
                p.export.load_records(str(d / "t.json")), p.export.read_jsonl(str(d / "t.jsonl")))

    ref, port = both(run)
    assert port == ref


@pytest.mark.parametrize("windows", [1, 2, 8])
def test_report_tables_and_text_match_reference(windows, tmp_path):
    path = str(tmp_path / "golden.jsonl")
    jexport.write_jsonl(path, _golden_tracer(PKGS["repro"]))

    def run(p):
        recs = p.export.load_records(path)
        s = p.obs.report.summarize(recs, windows=windows)
        return (s, p.obs.report.request_table(recs), p.trace_report.format_report(s))

    ref, port = both(run)
    assert port == ref
    assert "latency breakdown" in port[2]


@pytest.mark.parametrize("json_out", [False, True])
def test_trace_report_cli_matches_reference(json_out, tmp_path, capsys):
    path = str(tmp_path / "profiled.json")
    jexport.write_chrome_trace(path, _profiled_tracer(PKGS["repro"]))
    argv = [path] + (["--json"] if json_out else [])
    want = jtrace_report.main(argv)
    want_text = capsys.readouterr().out
    got = ttrace_report.main(argv)
    assert capsys.readouterr().out == want_text
    assert got == want
