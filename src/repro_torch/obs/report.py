"""Offline trace analysis: request breakdowns, tier shares, tuning jobs.

A copy of ``repro.obs.report`` (the port imports nothing of ``repro``).

Consumes the flat record form produced by :func:`repro_torch.obs.export
.load_records` (either saved format) and answers the questions the paper
cares about — where does a request's latency go, which resolution tier
served the fleet over time, and what did each tuning job cost.  The
``launch/trace_report.py`` CLI is a thin formatter over these functions;
tests run them on a golden fixture.
"""
from __future__ import annotations

from .metrics import percentile


def request_table(records: "list[dict]") -> list[dict]:
    """Per-request lifecycle rows from the ``cat="request"`` async spans.

    Each served request contributes a ``request`` span (arrival→finish)
    with ``queue``/``prefill``/``decode`` phase spans under the same id;
    shed requests appear with ``shed`` set and no phases.
    """
    by_uid: dict[str, dict] = {}
    for r in records:
        if r["kind"] != "span" or r.get("cat") != "request":
            continue
        row = by_uid.setdefault(r["id"], {"uid": r["id"]})
        if r["name"] == "request":
            row.update(r["attrs"])  # span timestamps are authoritative
            row.update(arrival_s=r["t0"], finished_s=r["t1"],
                       latency_s=r["t1"] - r["t0"])
        else:
            row[f"{r['name']}_s"] = r["t1"] - r["t0"]
    for r in records:
        if r["kind"] == "event" and r["name"] == "shed":
            uid = str(r["attrs"].get("uid"))
            row = by_uid.setdefault(uid, {"uid": uid})
            row.update(shed=r["attrs"].get("reason"), shed_at_s=r["t"])
    out = list(by_uid.values())
    out.sort(key=lambda r: r.get("arrival_s", r.get("shed_at_s", 0.0)))
    return out


def latency_breakdown(records: "list[dict]") -> dict:
    """Fleet-level latency quantiles per phase (queue / TTFT / decode).

    TTFT here is time-to-first-token measured from arrival: queue wait
    plus prefill.  ``latency_s`` percentiles over the same arrival→finish
    intervals ``FleetMetrics`` records, via the same :func:`percentile`,
    so the two agree exactly.
    """
    rows = [r for r in request_table(records) if "finished_s" in r]
    shed = [r for r in request_table(records) if r.get("shed")]
    series = {
        "latency_s": [r["latency_s"] for r in rows],
        "queue_s": [r.get("queue_s", 0.0) for r in rows],
        "ttft_s": [r.get("queue_s", 0.0) + r.get("prefill_s", 0.0)
                   for r in rows],
        "decode_s": [r.get("decode_s", 0.0) for r in rows],
    }
    out = {"requests": len(rows), "shed": len(shed)}
    for name, xs in series.items():
        out[name] = {"mean": sum(xs) / len(xs) if xs else 0.0,
                     "p50": percentile(xs, 50), "p95": percentile(xs, 95),
                     "p99": percentile(xs, 99)}
    return out


def tier_shares(records: "list[dict]", windows: int = 8) -> list[dict]:
    """Resolution-tier mix over time, from the ``lookup`` events.

    Splits the trace's lookup activity into ``windows`` equal time slices
    and reports each tier's share per slice — the "exact share climbs as
    background tuning publishes" curve, extracted from any saved trace.
    """
    hits = [(r["t"], r["attrs"].get("tier", "?")) for r in records
            if r["kind"] == "event" and r["name"] == "lookup"]
    if not hits:
        return []
    t0 = min(t for t, _ in hits)
    t1 = max(t for t, _ in hits)
    width = (t1 - t0) / windows or 1.0
    out = []
    for w in range(windows):
        lo = t0 + w * width
        hi = t0 + (w + 1) * width
        sel = [tier for t, tier in hits
               if lo <= t < hi or (w == windows - 1 and t == t1)]
        counts: dict[str, int] = {}
        for tier in sel:
            counts[tier] = counts.get(tier, 0) + 1
        n = len(sel)
        out.append({"t0": lo, "t1": hi, "lookups": n,
                    "shares": {tier: c / n for tier, c in
                               sorted(counts.items())} if n else {}})
    return out


def tuning_jobs(records: "list[dict]") -> list[dict]:
    """Per-job rows from the ``cat="tune"`` async spans (claim→publish)."""
    out = []
    for r in records:
        if r["kind"] == "span" and r.get("cat") == "tune":
            out.append({"key": r["attrs"].get("key", r["id"]),
                        "t0": r["t0"], "duration_s": r["t1"] - r["t0"],
                        **{k: v for k, v in r["attrs"].items()
                           if k != "key"}})
    out.sort(key=lambda r: r["t0"])
    return out


def scale_timeline(records: "list[dict]") -> list[dict]:
    """Autoscaler decisions and replica lifecycle transitions, in order."""
    out = [{"t": r["t"], "name": r["name"], **r["attrs"]}
           for r in records if r["kind"] == "event"
           and r["track"] == "autoscaler"]
    out.sort(key=lambda r: r["t"])
    return out


def acceptance_timeline(records: "list[dict]", windows: int = 8) -> list[dict]:
    """Speculative acceptance rate over time, from ``spec_burst`` events.

    Splits the trace's burst activity into ``windows`` equal time slices;
    each row reports the slice's acceptance rate (accepted / proposed draft
    tokens), committed-token total, and per-class acceptance — the panel
    that shows a class's draftability drifting and the auto router reacting.
    """
    bursts = [(r["t"], r["attrs"]) for r in records
              if r["kind"] == "event" and r["name"] == "spec_burst"]
    if not bursts:
        return []
    t0 = min(t for t, _ in bursts)
    t1 = max(t for t, _ in bursts)
    width = (t1 - t0) / windows or 1.0
    out = []
    for w in range(windows):
        lo = t0 + w * width
        hi = t0 + (w + 1) * width
        sel = [a for t, a in bursts
               if lo <= t < hi or (w == windows - 1 and t == t1)]
        prop = sum(a.get("proposed", 0) for a in sel)
        acc = sum(a.get("accepted", 0) for a in sel)
        by_cls: dict[str, list[int]] = {}
        for a in sel:
            pa = by_cls.setdefault(str(a.get("request_class", "")), [0, 0])
            pa[0] += a.get("proposed", 0)
            pa[1] += a.get("accepted", 0)
        out.append({
            "t0": lo, "t1": hi, "bursts": len(sel),
            "proposed": prop, "accepted": acc,
            "committed": sum(a.get("committed", 0) for a in sel),
            "acceptance": acc / prop if prop else 0.0,
            "by_class": {cls: (pa[1] / pa[0] if pa[0] else 0.0)
                         for cls, pa in sorted(by_cls.items())}})
    return out


def slo_timeline(records: "list[dict]") -> list[dict]:
    """SLO alert transitions from the ``slo`` track, in order.

    Each row is an ``slo_alert`` or ``slo_clear`` event with the window's
    fast/slow burn rates — the audit trail of when each objective's error
    budget started and stopped burning.
    """
    out = [{"t": r["t"], "name": r["name"], **r["attrs"]}
           for r in records if r["kind"] == "event"
           and r["track"] == "slo"
           and r["name"] in ("slo_alert", "slo_clear")]
    out.sort(key=lambda r: (r["t"], r.get("slo", "")))
    return out


def ledger_timeline(records: "list[dict]") -> list[dict]:
    """Speedup-ledger snapshots (``ledger`` events) over time.

    The realized-vs-attainable speedup curve: each row shows how much of
    the registry's best-known speedup the fleet was actually serving at
    that instant — the live form of the paper's headline metric.
    """
    out = [{"t": r["t"], **r["attrs"]}
           for r in records if r["kind"] == "event"
           and r["name"] == "ledger"]
    out.sort(key=lambda r: r["t"])
    return out


def summarize(records: "list[dict]", windows: int = 8) -> dict:
    """Everything the CLI prints, as one JSON-ready object."""
    # Imported lazily: profiler builds on request_table above, so a
    # module-level import would be circular.
    from . import profiler
    return {"latency": latency_breakdown(records),
            "tier_shares": tier_shares(records, windows),
            "tuning_jobs": tuning_jobs(records),
            "scale_timeline": scale_timeline(records),
            "acceptance": acceptance_timeline(records, windows),
            "slo": slo_timeline(records),
            "speedup_ledger": ledger_timeline(records),
            "critical_path": profiler.critical_path(records)}
