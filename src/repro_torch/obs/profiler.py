"""Critical-path profiler: request latency -> segments -> kernel workloads.

A copy of ``repro.obs.profiler`` (the port imports nothing of ``repro``).

Two consumers, one attribution model:

* **Offline** (:func:`critical_path`, :func:`request_breakdown`) — walk a
  folded trace (:func:`repro_torch.obs.export.load_records`): each request's
  ``cat="request"`` async spans slice its arrival→finish latency into
  queue / prefill / decode segments, and the replica tracks' sync cell
  spans (slot ``prefill`` / ``decode_step``; paged step children ``chunk``
  / ``decode`` / ``verify`` / ``draft_burst`` / ``draft_sync``) carry the
  busy time each cell spent.  ``cell_workloads`` events — emitted by each
  replica once per (cell, plan generation) — map a cell to its kernel
  workloads with per-execution seconds under that plan, so cell busy time
  attributes down to individual workload keys.  The per-request latency
  totals are the *same floats* ``FleetMetrics`` aggregated (the async spans
  carry its exact intervals, and the exporters round-trip seconds
  losslessly), so :func:`critical_path`'s p50/p95 reproduce
  ``FleetMetrics.summary()`` exactly — pinned by ``bench_slo``.

* **Live** (:func:`live_workload_seconds`) — the same per-workload
  critical-path seconds computed directly from the replicas' cell
  execution counters and plan-derived costs, without a tracer.  This is
  the signal the :class:`~repro_torch.fleet.advisor.TuningAdvisor` multiplies by
  remaining speedup headroom to rank tuning work; with tracing enabled the
  two paths agree because the spans are laid out from the very same costs.
"""
from __future__ import annotations

from .metrics import percentile
from .report import request_table

#: Sync span names that are cell executions (everything else on a replica
#: track — e.g. the paged ``step`` parent — is a container, not a cell).
_CELL_SPANS = ("prefill", "decode_step", "chunk", "decode", "verify",
               "draft_burst", "draft_sync")


def span_cell(rec: dict) -> tuple[str, float] | None:
    """Map one sync span record to ``(cell id, executions)``.

    Cell ids match the replicas' counters: ``prefill:<bucket>`` (slot
    prefill and paged chunk both — a chunk *is* the paged prefill cell for
    that length), ``decode``, ``verify``, ``draft_decode``,
    ``draft_sync:<len>``.  Returns None for non-cell spans.
    """
    name = rec["name"]
    if rec.get("cat") is not None or name not in _CELL_SPANS:
        return None
    attrs = rec.get("attrs", {})
    if name == "prefill":
        return f"prefill:{attrs.get('bucket')}", 1.0
    if name == "chunk":
        return f"prefill:{attrs.get('len')}", 1.0
    if name in ("decode_step", "decode"):
        return "decode", 1.0
    if name == "verify":
        return "verify", 1.0
    if name == "draft_burst":
        return "draft_decode", float(attrs.get("steps", 1))
    return f"draft_sync:{attrs.get('len')}", 1.0


def request_breakdown(records: "list[dict]") -> list[dict]:
    """Per-request segment rows for every *finished* request.

    Each row carries the request's ``latency_s`` (the request span's
    ``t1 - t0`` — bit-identical to ``FleetRequest.latency_s``) and its
    ``queue_s`` / ``prefill_s`` / ``decode_s`` segments, which partition
    the latency by construction (the phase spans share endpoints).
    """
    return [r for r in request_table(records) if "finished_s" in r]


def critical_path(records: "list[dict]") -> dict:
    """Fleet-wide critical-path breakdown of a folded trace.

    Returns::

        {"requests", "latency_s": {p50, p95, p99},   # == FleetMetrics'
         "segments": {queue, prefill, decode},       # summed request-seconds
         "by_cell": {cell: {"seconds", "executions"}},
         "by_workload": {workload_key: seconds},     # via cell_workloads
         "attributed_frac"}                          # covered cell seconds

    ``segments`` answers "where do requests wait"; ``by_cell`` /
    ``by_workload`` answer "which compute is that time spent in" — the
    quantity tuning priority should follow.
    """
    rows = request_breakdown(records)
    lats = [r["latency_s"] for r in rows]
    segments = {"queue": 0.0, "prefill": 0.0, "decode": 0.0}
    for r in rows:
        for seg in segments:
            segments[seg] += r.get(f"{seg}_s", 0.0)

    # cell_workloads events: (track, cell) -> [(t, [[key, s], ...])], sorted.
    maps: dict[tuple, list] = {}
    for r in records:
        if r["kind"] == "event" and r["name"] == "cell_workloads":
            a = r["attrs"]
            maps.setdefault((r["track"], a.get("cell")), []).append(
                (r["t"], a.get("workloads", [])))
    for v in maps.values():
        v.sort(key=lambda p: p[0])

    by_cell: dict[str, dict] = {}
    by_workload: dict[str, float] = {}
    attributed = total_cell_s = 0.0
    for r in records:
        if r["kind"] != "span":
            continue
        cell = span_cell(r)
        if cell is None:
            continue
        cell_id, execs = cell
        dur = r["t1"] - r["t0"]
        c = by_cell.setdefault(cell_id, {"seconds": 0.0, "executions": 0.0})
        c["seconds"] += dur
        c["executions"] += execs
        total_cell_s += dur
        # The mapping active when the span ran: latest event at or before
        # its start (plans only change at step boundaries, so the emission
        # preceding a span is the generation that priced it).
        series = maps.get((r["track"], cell_id))
        if not series:
            continue
        active = series[0][1]
        for t, wl in series:
            if t > r["t0"] + 1e-12:
                break
            active = wl
        for key, sec in active:
            by_workload[key] = by_workload.get(key, 0.0) + execs * sec
        attributed += dur
    return {
        "requests": len(rows),
        "latency_s": {"p50": percentile(lats, 50),
                      "p95": percentile(lats, 95),
                      "p99": percentile(lats, 99)},
        "segments": segments,
        "by_cell": dict(sorted(by_cell.items())),
        "by_workload": dict(sorted(by_workload.items(),
                                   key=lambda kv: -kv[1])),
        "attributed_frac": attributed / total_cell_s if total_cell_s else 0.0,
    }


def live_workload_seconds(replicas) -> dict:
    """Per-workload critical-path seconds from live replica state.

    ``{(workload_key, target): {"seconds", "instance"}}`` — each replica's
    cell execution counters times the cell's per-execution workload seconds
    under its *current* plan.  No tracer required: this is the advisor's
    input on a production fleet where tracing may be off.
    """
    out: dict = {}
    for r in replicas:
        for cell, n in getattr(r, "cell_counts", {}).items():
            for use, sec in r.cell_workload_seconds(cell):
                k = (use.instance.workload_key(), r.target)
                row = out.get(k)
                if row is None:
                    row = out[k] = {"seconds": 0.0, "instance": use.instance}
                row["seconds"] += n * sec
    return out
