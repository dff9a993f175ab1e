"""Trace exporters: Chrome trace-event JSON (Perfetto) and JSON-lines.

A copy of ``repro.obs.export`` (the port imports nothing of ``repro``).

The Chrome format (``chrome_trace`` / ``write_chrome_trace``) is the
interactive path — load the file in https://ui.perfetto.dev or
``chrome://tracing``.  Tracks map to threads of one process: each track
becomes a ``tid`` (named via ``M``/``thread_name`` metadata) in tracer
registration order, sync spans become complete ``X`` events, async spans
become ``b``/``e`` pairs keyed by ``(cat, id)`` so overlapping request
lifetimes render as parallel slices, and point events become instants
(``i``).  Timestamps are microseconds (the virtual clock's seconds x 1e6).

The JSONL format (``write_jsonl`` / ``read_jsonl``) is the offline path —
one self-describing record per line (``{"kind": "span"|"event", ...}``
with seconds-unit times and verbatim attrs), which is what
``launch/trace_report.py`` and the golden-fixture tests consume.
``load_records`` reads either file shape back into that record form.
"""
from __future__ import annotations

import json

from .tracer import Event, Span, Tracer

_US = 1e6  # seconds -> Chrome trace microseconds


def _records(tracer: Tracer) -> list[dict]:
    out = []
    for s in tracer.spans:
        out.append({"kind": "span", "name": s.name, "track": s.track,
                    "t0": s.t0, "t1": s.t1, "cat": s.cat, "id": s.id,
                    "attrs": s.attrs})
    for e in tracer.events:
        out.append({"kind": "event", "name": e.name, "track": e.track,
                    "t": e.t, "attrs": e.attrs})
    return out


def chrome_trace(tracer: Tracer) -> dict:
    """Tracer contents as a Chrome trace-event object (Perfetto-loadable)."""
    tids = {name: i + 1 for i, name in enumerate(tracer.tracks())}
    ev: list[dict] = []
    ev.append({"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
               "args": {"name": "repro-fleet"}})
    for name, tid in tids.items():
        ev.append({"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                   "args": {"name": name}})
        # sort_index pins the display order to track registration order.
        ev.append({"ph": "M", "pid": 1, "tid": tid,
                   "name": "thread_sort_index", "args": {"sort_index": tid}})
    # Alongside the standard microsecond ``ts``/``dur``, every record
    # carries exact-seconds sidecar keys (``ts_s``, and ``t1_s`` for
    # complete events).  Perfetto ignores unknown keys; ``load_records``
    # prefers them so a Chrome round-trip folds back to the *same floats*
    # the JSONL path preserves — the profiler's exact-percentile guarantee
    # rides on this (seconds x 1e6 / 1e6 is lossy in float64).
    for s in tracer.spans:
        tid = tids.get(s.track, 0)
        if s.cat is not None:
            common = {"pid": 1, "tid": tid, "name": s.name, "cat": s.cat,
                      "id": s.id}
            ev.append({"ph": "b", "ts": s.t0 * _US, "ts_s": s.t0,
                       "args": s.attrs, **common})
            ev.append({"ph": "e", "ts": s.t1 * _US, "ts_s": s.t1, **common})
        else:
            ev.append({"ph": "X", "pid": 1, "tid": tid, "name": s.name,
                       "ts": s.t0 * _US, "dur": (s.t1 - s.t0) * _US,
                       "ts_s": s.t0, "t1_s": s.t1, "args": s.attrs})
    for e in tracer.events:
        ev.append({"ph": "i", "pid": 1, "tid": tids.get(e.track, 0),
                   "name": e.name, "ts": e.t * _US, "ts_s": e.t, "s": "t",
                   "args": e.attrs})
    # Stable sort: metadata (no ts) first, then by timestamp, preserving
    # record order at equal instants so nesting survives zero-width steps.
    ev.sort(key=lambda r: r.get("ts", -1.0))
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer: Tracer) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f)


def write_jsonl(path: str, tracer: Tracer) -> None:
    with open(path, "w") as f:
        for rec in _records(tracer):
            f.write(json.dumps(rec) + "\n")


def read_jsonl(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def load_records(path: str) -> list[dict]:
    """Read a saved trace (either format) back as flat JSONL-shape records.

    Chrome files are folded back: ``X`` -> span, ``b``/``e`` pairs matched
    by ``(cat, id, name)`` -> async span, ``i`` -> event, metadata dropped.
    Files written by :func:`chrome_trace` carry exact-seconds sidecar keys
    (``ts_s``/``t1_s``) which are preferred over dividing the microsecond
    ``ts`` back down, so both formats fold to identical records; foreign
    Chrome traces without the sidecars still load (lossily) fine.
    """
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        # many one-object lines -> "Extra data": the JSONL shape
        return read_jsonl(path)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return read_jsonl(path)  # including a single-record JSONL file
    tracks: dict[int, str] = {}
    for r in doc.get("traceEvents", []):
        if r.get("ph") == "M" and r.get("name") == "thread_name":
            tracks[r["tid"]] = r["args"]["name"]
    out: list[dict] = []
    open_async: dict[tuple, dict] = {}
    for r in doc.get("traceEvents", []):
        ph = r.get("ph")
        track = tracks.get(r.get("tid"), "")
        if ph == "X":
            t0 = r.get("ts_s", r["ts"] / _US)
            t1 = r.get("t1_s", t0 + r.get("dur", 0.0) / _US)
            out.append({"kind": "span", "name": r["name"], "track": track,
                        "t0": t0, "t1": t1, "cat": None, "id": None,
                        "attrs": r.get("args", {})})
        elif ph == "b":
            key = (r.get("cat"), r.get("id"), r["name"])
            t0 = r.get("ts_s", r["ts"] / _US)
            open_async[key] = {"kind": "span", "name": r["name"],
                               "track": track, "t0": t0,
                               "t1": t0, "cat": r.get("cat"),
                               "id": r.get("id"),
                               "attrs": r.get("args", {})}
            out.append(open_async[key])
        elif ph == "e":
            key = (r.get("cat"), r.get("id"), r["name"])
            rec = open_async.pop(key, None)
            if rec is not None:
                rec["t1"] = r.get("ts_s", r["ts"] / _US)
        elif ph == "i":
            out.append({"kind": "event", "name": r["name"], "track": track,
                        "t": r.get("ts_s", r["ts"] / _US),
                        "attrs": r.get("args", {})})
    return out
