"""Schedule database: persistent store of tuned auto-schedules, a copy of
``repro.core.database`` with the same JSON schema, so a DB saved by one
package loads in the other.

Mirrors Ansor's log-file records: each record binds a workload (instance) to
a measured schedule plus provenance (which model it was tuned for).  The DB
answers the two reuse queries:

* exact workload match (Ansor's native reuse);
* all schedules of a kernel class, optionally filtered by donor model
  (transfer-tuning's candidate pool, paper §4.2/§5.5).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Iterable, Mapping, Sequence

from repro_torch.core.schedule import Schedule
from repro_torch.core.workload import KernelInstance
from repro_torch.targets import DEFAULT_TARGET, target_name

#: On-disk schema version shared by every schedule store (the monolithic
#: ScheduleDB JSON payload and the registry's manifest / segment headers).
SCHEMA_VERSION = 1


class UnknownSchemaVersion(ValueError):
    """A persisted schedule payload declares a version this code can't read."""


def check_schema_version(payload: Mapping, *, source: str) -> None:
    """Validate the ``version`` field of a persisted payload.

    Raises :class:`UnknownSchemaVersion` with a readable message naming the
    offending file/segment; a missing field is treated as unknown too (the
    pre-versioned era never shipped, so absence means corruption).
    """
    v = payload.get("version")
    if v != SCHEMA_VERSION:
        raise UnknownSchemaVersion(
            f"{source}: unsupported schema version {v!r} "
            f"(this build reads version {SCHEMA_VERSION}); "
            "regenerate the store or upgrade the reader"
        )


@dataclasses.dataclass(frozen=True)
class Record:
    instance: KernelInstance
    schedule: Schedule
    seconds: float           # measured (cost-model) seconds on the source instance
    model_id: str            # donor model the kernel belongs to
    trials: int = 0          # search trials spent producing this record
    target: str = DEFAULT_TARGET  # hardware target the measurement ran on

    def to_json(self) -> dict:
        return {
            "instance": self.instance.to_json(),
            "schedule": self.schedule.to_json(),
            "seconds": self.seconds,
            "model_id": self.model_id,
            "trials": self.trials,
            "target": self.target,
        }

    @staticmethod
    def from_json(d: Mapping) -> "Record":
        return Record(
            instance=KernelInstance.from_json(d["instance"]),
            schedule=Schedule.from_json(d["schedule"]),
            seconds=float(d["seconds"]),
            model_id=d["model_id"],
            trials=int(d.get("trials", 0)),
            # Pre-target-subsystem stores only ever measured the seed chip,
            # so a missing field is unambiguous (same schema version).
            target=d.get("target", DEFAULT_TARGET),
        )


class ScheduleDB:
    """In-memory schedule store with JSON persistence (atomic writes).

    Holds up to MAX_PER_WORKLOAD distinct schedules per (target, workload,
    model) — Ansor's tuning logs retain every measured schedule, and
    transfer-tuning draws its candidate pool from them; keeping the top-k per
    donor kernel preserves pool sizes comparable to the paper's
    many-kernels-per-class CNNs even though LM stacks dedup to few unique
    workloads per class.

    Every record is **namespaced by hardware target**: queries take a
    ``target`` (name / Target / None = the default ``tpu-v5e``) and only ever
    return records measured on that chip, so a schedule tuned for one target
    cannot silently serve another.  Cross-target reuse is explicit — pass the
    donor chip's name as the query target (what
    :func:`repro_torch.core.transfer.cross_target_transfer` does) and re-measure
    under the serving chip's spec.
    """

    MAX_PER_WORKLOAD = 5

    def __init__(self, records: Iterable[Record] = ()):
        # (target, workload, model) -> top-k records, sorted by seconds
        self._by_workload: dict[tuple[str, str, str], list[Record]] = {}
        # (target, workload) -> best record (any model)
        self._best: dict[tuple[str, str], Record] = {}
        self._frozen = False
        for r in records:
            self.add(r)

    def freeze(self) -> "ScheduleDB":
        """Make the DB read-only (adds raise) — shared snapshot views."""
        self._frozen = True
        return self

    # -- mutation -----------------------------------------------------------
    def add(self, record: Record) -> None:
        if self._frozen:
            raise RuntimeError(
                "ScheduleDB is frozen (a registry snapshot view is shared and "
                "immutable) — copy it with ScheduleDB(db.records()) to mutate")
        wk = record.instance.workload_key()
        cur = self._best.get((record.target, wk))
        if cur is None or record.seconds < cur.seconds:
            self._best[(record.target, wk)] = record
        key = (record.target, wk, record.model_id)
        bucket = self._by_workload.setdefault(key, [])
        for i, r in enumerate(bucket):
            if r.schedule == record.schedule:
                if record.seconds < r.seconds:
                    bucket[i] = record
                    bucket.sort(key=lambda x: x.seconds)
                return
        bucket.append(record)
        bucket.sort(key=lambda r: r.seconds)
        del bucket[self.MAX_PER_WORKLOAD:]

    @property
    def _records(self) -> dict:
        # flattened view keyed by (target, workload, model, rank)
        return {
            (*k, i): r
            for k, rs in self._by_workload.items()
            for i, r in enumerate(rs)
        }

    def merge(self, other: "ScheduleDB") -> None:
        for r in other.records():
            self.add(r)

    # -- queries -------------------------------------------------------------
    def records(self) -> list[Record]:
        return [r for rs in self._by_workload.values() for r in rs]

    def models(self, target=None) -> list[str]:
        """Donor model ids; ``target`` restricts to models with records for
        that chip (``None`` lists models across every target)."""
        if target is None:
            return sorted({m for (_t, _w, m) in self._by_workload})
        t = target_name(target)
        return sorted({m for (rt, _w, m) in self._by_workload if rt == t})

    def targets(self) -> list[str]:
        """Every hardware target this DB holds records for."""
        return sorted({t for (t, _w, _m) in self._by_workload})

    def exact(self, instance: KernelInstance, target=None) -> Record | None:
        """Best ``target`` record for this exact workload (any model) —
        Ansor reuse, namespaced by chip.

        O(1): the best-per-(target, workload) index is maintained by ``add``
        (bucket truncation only ever drops non-best records, so it stays
        exact), keeping the serving path's per-kernel resolution
        constant-time.
        """
        return self._best.get((target_name(target), instance.workload_key()))

    def by_class(self, class_id: str, models: Sequence[str] | None = None,
                 target=None) -> list[Record]:
        """All ``target`` schedules of a class — the transfer candidate pool."""
        t = target_name(target)
        out = [
            r
            for r in self.records()
            if r.instance.class_id == class_id and r.target == t
            and (models is None or r.model_id in models)
        ]
        return sorted(out, key=lambda r: (r.model_id, r.seconds))

    def class_counts(self, model_id: str, target=None) -> dict[str, int]:
        """|W_Tc| per class for one donor on one target (Eq. 1): distinct
        tuned *kernels* per class, matching the paper's per-kernel counting."""
        t = target_name(target)
        counts: dict[str, int] = {}
        for (rt, _w, m), rs in self._by_workload.items():
            if m == model_id and rt == t and rs:
                c = rs[0].instance.class_id
                counts[c] = counts.get(c, 0) + 1
        return counts

    def __len__(self) -> int:
        return len(self.records())

    # -- persistence ----------------------------------------------------------
    def save(self, path: str) -> None:
        payload = {"version": SCHEMA_VERSION,
                   "records": [r.to_json() for r in self.records()]}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @staticmethod
    def load(path: str) -> "ScheduleDB":
        with open(path) as f:
            payload = json.load(f)
        check_schema_version(payload, source=path)
        return ScheduleDB(Record.from_json(d) for d in payload["records"])

    @staticmethod
    def load_or_empty(path: str) -> "ScheduleDB":
        return ScheduleDB.load(path) if os.path.exists(path) else ScheduleDB()
