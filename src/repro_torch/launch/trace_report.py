"""Offline trace analysis CLI: latency breakdown, tier shares, tuning jobs.

A copy of ``repro.launch.trace_report`` (the port imports nothing of ``repro``).

Reads a trace written by ``--trace-out`` (Chrome trace JSON or the flat
JSONL form — :func:`repro_torch.obs.export.load_records` detects which) and
prints the run's story:

* **latency breakdown** — p50/p95/p99 (and means) of end-to-end latency,
  queue wait, TTFT (queue + prefill), and decode time, over exactly the
  arrival→finish intervals the fleet's own metrics aggregate — the printed
  p95 reproduces ``FleetMetrics.summary()``'s;
* **tier shares over time** — the resolution-tier mix (exact / transfer /
  static / default) per time slice, extracted from the tuning-service
  lookup events: the "exact share climbs as background tuning publishes"
  curve of the paper, recovered from any saved trace;
* **tuning jobs** — per-job claim time and virtual search cost;
* **scale timeline** — autoscaler decisions and replica join/retire
  transitions, in order;
* **speculative acceptance** — draft-token acceptance rate per time slice
  (overall and per request class) with committed-token totals, from the
  engines' ``spec_burst`` events — the panel that shows whether
  draft-then-verify is paying off and for which traffic;
* **critical path** — request latency attributed segment by segment
  (queue / prefill / decode) and cell by cell down to the kernel
  workloads that ran, from the replicas' ``cell_workloads`` events;
* **SLO timeline** — burn-rate alert/clear transitions per objective;
* **speedup ledger** — realized vs attainable speedup over time: how much
  of the registry's best-known schedules the fleet actually served.

    PYTHONPATH=src python -m repro_torch.launch.trace_report trace.json
    PYTHONPATH=src python -m repro_torch.launch.trace_report trace.json --json

``--json`` emits the full :func:`repro_torch.obs.report.summarize` object for
machine consumption; the default output is a compact human-readable text
report.  See DESIGN.md §10.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.obs import report
from repro_torch.obs.export import load_records


def _fmt_quantiles(name: str, q: dict) -> str:
    return (f"  {name:<10} mean {q['mean']:.6f}  p50 {q['p50']:.6f}  "
            f"p95 {q['p95']:.6f}  p99 {q['p99']:.6f}")


def format_report(summary: dict) -> str:
    """Render :func:`repro_torch.obs.report.summarize` output as text."""
    lines = []
    lat = summary["latency"]
    lines.append(f"requests: {lat['requests']} completed, {lat['shed']} shed")
    lines.append("latency breakdown (virtual seconds):")
    for name in ("latency_s", "queue_s", "ttft_s", "decode_s"):
        lines.append(_fmt_quantiles(name, lat[name]))
    shares = summary["tier_shares"]
    if shares:
        lines.append("resolution tier shares over time:")
        for w in shares:
            mix = "  ".join(f"{t}={s:.2f}" for t, s in w["shares"].items())
            lines.append(f"  [{w['t0']:.4f}, {w['t1']:.4f})  "
                         f"{w['lookups']:>4} lookups  {mix}")
    jobs = summary["tuning_jobs"]
    if jobs:
        total = sum(j["duration_s"] for j in jobs)
        lines.append(f"tuning jobs: {len(jobs)}  "
                     f"(total search {total:.3f}s)")
        for j in jobs:
            lines.append(f"  t={j['t0']:.4f}  {j['duration_s']:.4f}s  "
                         f"{j['key']}")
    timeline = summary["scale_timeline"]
    if timeline:
        lines.append("scale timeline:")
        for e in timeline:
            detail = "  ".join(f"{k}={v}" for k, v in sorted(e.items())
                               if k not in ("t", "name"))
            lines.append(f"  t={e['t']:.4f}  {e['name']:<14} {detail}")
    acceptance = summary.get("acceptance", [])
    if acceptance:
        lines.append("speculative acceptance over time:")
        for w in acceptance:
            cls = "  ".join(f"{c or '(none)'}={a:.2f}"
                            for c, a in w["by_class"].items())
            lines.append(f"  [{w['t0']:.4f}, {w['t1']:.4f})  "
                         f"{w['bursts']:>4} bursts  "
                         f"accept={w['acceptance']:.2f}  "
                         f"committed={w['committed']}  {cls}")
    cp = summary.get("critical_path")
    if cp and cp.get("requests"):
        seg = cp["segments"]
        lines.append("critical path (latency attribution):")
        lines.append(f"  segments: queue={seg['queue']:.6f}s  "
                     f"prefill={seg['prefill']:.6f}s  "
                     f"decode={seg['decode']:.6f}s  "
                     f"(workload-attributed {cp['attributed_frac']:.0%})")
        cells = sorted(cp["by_cell"].items(),
                       key=lambda kv: -kv[1]["seconds"])
        for cell, row in cells[:8]:
            lines.append(f"  {cell:<16} {row['seconds']:.6f}s  "
                         f"({row['executions']:.0f} execs)")
        hot = sorted(cp["by_workload"].items(), key=lambda kv: -kv[1])
        if hot:
            lines.append("  hottest workloads:")
            for key, s in hot[:5]:
                lines.append(f"    {key}  {s:.6f}s")
    slo = summary.get("slo", [])
    if slo:
        lines.append("slo timeline:")
        for e in slo:
            lines.append(f"  t={e['t']:.4f}  {e['name']:<10} "
                         f"{e.get('slo', '?')}  "
                         f"burn fast={e.get('burn_fast', 0.0):.2f} "
                         f"slow={e.get('burn_slow', 0.0):.2f}")
    ledger = summary.get("speedup_ledger", [])
    if ledger:
        last = ledger[-1]
        lines.append("speedup ledger:")
        for e in ledger:
            lines.append(
                f"  t={e['t']:.4f}  realized {e['realized_speedup']:.3f}x  "
                f"attainable {e['attainable_speedup']:.3f}x  "
                f"fraction {e['realized_fraction']:.2f}  "
                f"tuned {e['tuned_workloads']}/{e['workloads']}")
        lines.append(
            f"  final: serving {last['realized_fraction']:.0%} of "
            f"best-known speedup "
            f"({last['realized_speedup']:.3f}x of "
            f"{last['attainable_speedup']:.3f}x attainable)")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="summarize a --trace-out trace: latency breakdown, "
                    "tier shares over time, tuning jobs, scale timeline")
    ap.add_argument("trace", help="Chrome trace JSON or JSONL record file")
    ap.add_argument("--windows", type=int, default=8,
                    help="time slices for the tier-share series")
    ap.add_argument("--json", action="store_true",
                    help="emit the full summary object as JSON")
    args = ap.parse_args(argv)

    records = load_records(args.trace)
    summary = report.summarize(records, windows=args.windows)
    if args.json:
        print(json.dumps(summary, indent=1, sort_keys=True))
    else:
        print(format_report(summary))
    return summary


if __name__ == "__main__":
    main()
