"""Segmented persistent schedule registry: the online scale path of ScheduleDB.

A copy of ``repro.service.registry`` (the port imports nothing of
``repro``), with the same on-disk layout: a registry one package writes
the other reads.

`ScheduleDB.save()` rewrites the whole store on every change — fine for an
offline batch run, unusable when background tuning jobs publish records while
a serving path reads them.  :class:`ScheduleRegistry` replaces the monolithic
file with an append-only *segmented* store:

* every ``publish()`` writes one new JSONL **segment** (tmp file + fsync +
  ``os.replace``) and then atomically swaps ``MANIFEST.json`` to reference
  it — readers observe either the old or the new generation, never a torn
  store;
* a **generation counter** in the manifest increments on every publish and
  compaction, so cheap staleness checks (``refresh()``) and telemetry work
  across processes;
* **lock-free snapshot reads**: the in-process view is an immutable
  :class:`RegistrySnapshot` swapped wholesale under the writer lock; readers
  (the serving path) just dereference an attribute — no lock, no torn state;
* **compaction** folds all segments into one, keeping the best record per
  ``(workload, mode, target)`` — the serving registry's steady-state
  footprint is one record per workload it has ever answered per chip; with
  ``auto_compact_segments=N`` it fires automatically once a publish pushes
  the segment count past N;
* **merge** of concurrently produced :class:`~repro_torch.core.database.ScheduleDB`
  instances is just ``merge_db()``: each producer lands as its own segment
  and compaction resolves duplicates later.

Crash recovery: segments are only ever appended; a crash mid-write can leave
a partial trailing line, which the reader drops (counted in
``recovered_partial_lines``).  Corruption *before* the tail is a real error.
Segment and manifest headers carry the same schema ``version`` field as
``ScheduleDB.save`` payloads and are validated by the shared
:func:`repro_torch.core.database.check_schema_version`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
from typing import Iterable, Mapping, Sequence

from repro_torch.core.database import (
    Record,
    SCHEMA_VERSION,
    ScheduleDB,
    check_schema_version,
)

MANIFEST_NAME = "MANIFEST.json"
SEGMENT_DIR = "segments"


class RegistryError(RuntimeError):
    """The registry's on-disk state is unreadable (beyond crash recovery)."""


@dataclasses.dataclass(frozen=True)
class RegistryRecord:
    """One published schedule record plus the transfer mode it is valid under.

    ``mode`` matters because an ``adaptive``-mode transfer may bind a schedule
    that is invalid under ``strict`` concretization — a strict serving path
    must not pick it up.
    """

    record: Record
    mode: str = "strict"

    def to_json(self) -> dict:
        return {"record": self.record.to_json(), "mode": self.mode}

    @staticmethod
    def from_json(d: Mapping) -> "RegistryRecord":
        return RegistryRecord(record=Record.from_json(d["record"]),
                              mode=d.get("mode", "strict"))

    def key(self) -> tuple[str, str, str]:
        # Target is part of the dedup key: compaction must never fold a
        # record tuned for one chip into another chip's namespace.
        return (self.record.instance.workload_key(), self.mode,
                self.record.target)


class RegistrySnapshot:
    """Immutable point-in-time view of the registry.

    Built once per publish/compaction/refresh and swapped atomically into the
    registry, so readers never lock: ``registry.snapshot()`` is a plain
    attribute read and everything reachable from the result is frozen.
    Per-mode :class:`ScheduleDB` views are prebuilt here (not lazily) to keep
    the read path allocation- and lock-free.
    """

    def __init__(self, generation: int, records: Iterable[RegistryRecord]):
        self.generation = generation
        self.records: tuple[RegistryRecord, ...] = tuple(records)
        dbs: dict[str | None, ScheduleDB] = {None: ScheduleDB()}
        for rr in self.records:
            dbs[None].add(rr.record)
            dbs.setdefault(rr.mode, ScheduleDB()).add(rr.record)
        self._dbs = {k: db.freeze() for k, db in dbs.items()}

    def db(self, mode: str | None = None) -> ScheduleDB:
        """Records published under ``mode`` as a ScheduleDB (None = all).

        The returned view is shared between every reader of this snapshot and
        frozen — copy via ``ScheduleDB(view.records())`` to mutate.
        """
        return self._dbs.get(mode) or ScheduleDB().freeze()

    def __len__(self) -> int:
        return len(self.records)


def _atomic_write(path: str, data: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class ScheduleRegistry:
    """Directory-backed segmented schedule store with atomic publish.

    Layout::

        root/MANIFEST.json            {"version", "generation", "next_segment",
                                       "segments": [...]}
        root/segments/seg-000001.jsonl   header line + one record per line

    Writers (publish / compact) serialize on an in-process lock; readers are
    lock-free (see :class:`RegistrySnapshot`).  Multi-process publishing is
    last-writer-wins on the manifest — concurrent *producers* should each
    write their own registry (or ScheduleDB) and be folded in with
    :meth:`merge_db`, the pattern the tuning service uses.
    """

    def __init__(self, root: str, *, auto_compact_segments: int | None = None):
        """``auto_compact_segments=N`` makes ``publish()`` fold the store the
        moment the segment count crosses N — a long-lived service otherwise
        accumulates one segment per publish, unboundedly."""
        if auto_compact_segments is not None and auto_compact_segments < 1:
            raise ValueError("auto_compact_segments must be >= 1")
        self.root = os.path.abspath(root)
        os.makedirs(os.path.join(self.root, SEGMENT_DIR), exist_ok=True)
        self._write_lock = threading.Lock()
        self.auto_compact_segments = auto_compact_segments
        self.compactions = 0
        self.recovered_partial_lines = 0
        if not os.path.exists(self._manifest_path()):
            self._write_manifest({"version": SCHEMA_VERSION, "generation": 0,
                                  "next_segment": 1, "segments": []})
        self._snapshot = self._load()

    # -- paths / manifest -----------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST_NAME)

    def _segment_path(self, name: str) -> str:
        return os.path.join(self.root, SEGMENT_DIR, name)

    def _read_manifest(self) -> dict:
        with open(self._manifest_path()) as f:
            manifest = json.load(f)
        check_schema_version(manifest, source=self._manifest_path())
        return manifest

    def _write_manifest(self, manifest: dict) -> None:
        _atomic_write(self._manifest_path(), json.dumps(manifest, indent=1))

    # -- segment IO -----------------------------------------------------------
    def _read_segment(self, name: str) -> list[RegistryRecord]:
        path = self._segment_path(name)
        with open(path) as f:
            raw = f.read()
        lines = raw.split("\n")
        while lines and lines[-1] == "":
            lines.pop()
        if not lines:
            return []
        try:
            header = json.loads(lines[0])
        except json.JSONDecodeError as e:
            raise RegistryError(f"{path}: unreadable segment header: {e}") from e
        check_schema_version(header, source=path)
        out: list[RegistryRecord] = []
        for i, line in enumerate(lines[1:], start=1):
            try:
                out.append(RegistryRecord.from_json(json.loads(line)))
            except json.JSONDecodeError as e:
                if i == len(lines) - 1:
                    # Crash mid-append: the partial tail never became visible
                    # as a record; drop it and keep the complete prefix.
                    self.recovered_partial_lines += 1
                    break
                raise RegistryError(
                    f"{path}:{i + 1}: corrupt record mid-segment: {e}") from e
        return out

    def _write_segment(self, name: str, records: Sequence[RegistryRecord]) -> None:
        lines = [json.dumps({"version": SCHEMA_VERSION, "kind": "segment"})]
        lines += [json.dumps(rr.to_json()) for rr in records]
        _atomic_write(self._segment_path(name), "\n".join(lines) + "\n")

    def _load(self) -> RegistrySnapshot:
        # A concurrent compaction can swap the manifest and delete a segment
        # between our manifest read and segment read — re-read and retry (the
        # new manifest no longer references the deleted file).
        for _ in range(8):
            manifest = self._read_manifest()
            records: list[RegistryRecord] = []
            try:
                for name in manifest["segments"]:
                    records.extend(self._read_segment(name))
            except FileNotFoundError:
                continue
            return RegistrySnapshot(manifest["generation"], records)
        raise RegistryError(
            f"{self.root}: manifest kept referencing vanished segments across "
            "retries — concurrent writer misbehaving?")

    # -- reads ----------------------------------------------------------------
    @property
    def generation(self) -> int:
        return self._snapshot.generation

    def snapshot(self) -> RegistrySnapshot:
        """Current immutable view — lock-free, safe to hold across publishes."""
        return self._snapshot

    def refresh(self) -> RegistrySnapshot:
        """Re-read the manifest, picking up publishes from other processes."""
        with self._write_lock:
            manifest = self._read_manifest()
            if manifest["generation"] != self._snapshot.generation:
                self._snapshot = self._load()
            return self._snapshot

    def stats(self) -> dict:
        manifest = self._read_manifest()
        return {
            "generation": self._snapshot.generation,
            "records": len(self._snapshot),
            "segments": len(manifest["segments"]),
            "targets": sorted({rr.record.target for rr in self._snapshot.records}),
            "compactions": self.compactions,
            "auto_compact_segments": self.auto_compact_segments,
            "recovered_partial_lines": self.recovered_partial_lines,
        }

    # -- writes ---------------------------------------------------------------
    def publish(self, records: Iterable[Record | RegistryRecord],
                mode: str = "strict") -> int:
        """Atomically publish a batch of records as one new segment.

        Bare :class:`Record` inputs are tagged with ``mode``.  Returns the new
        generation; an empty batch is a no-op returning the current one.
        """
        rrs = [r if isinstance(r, RegistryRecord) else RegistryRecord(r, mode)
               for r in records]
        if not rrs:
            return self.generation
        with self._write_lock:
            manifest = self._read_manifest()
            # Another process may have published since our snapshot was built;
            # appending to the stale in-memory records would hide its segments
            # forever (refresh() no-ops once generations match again).
            stale = manifest["generation"] != self._snapshot.generation
            name = f"seg-{manifest['next_segment']:06d}.jsonl"
            self._write_segment(name, rrs)
            manifest["segments"].append(name)
            manifest["next_segment"] += 1
            manifest["generation"] += 1
            self._write_manifest(manifest)
            if stale:
                self._snapshot = self._load()
            else:
                self._snapshot = RegistrySnapshot(
                    manifest["generation"], self._snapshot.records + tuple(rrs))
            if (self.auto_compact_segments is not None
                    and len(manifest["segments"]) > self.auto_compact_segments):
                self._compact_locked()
            return self._snapshot.generation

    def merge_db(self, db: ScheduleDB, mode: str = "strict") -> int:
        """Fold a concurrently produced ScheduleDB in as one segment."""
        return self.publish(db.records(), mode=mode)

    def compact(self) -> int:
        """Fold all segments into one, keeping the best record per
        (workload, mode, target).  Readers holding the old snapshot are
        unaffected; the manifest swap is atomic and old segment files are
        removed only after it lands."""
        with self._write_lock:
            return self._compact_locked()

    def _compact_locked(self) -> int:
        # Caller holds self._write_lock (publish() auto-compaction re-enters
        # here without re-acquiring the non-reentrant lock).
        manifest = self._read_manifest()
        records: list[RegistryRecord] = []
        for name in manifest["segments"]:
            records.extend(self._read_segment(name))
        best: dict[tuple[str, str, str], RegistryRecord] = {}
        for rr in records:
            cur = best.get(rr.key())
            if cur is None or rr.record.seconds < cur.record.seconds:
                best[rr.key()] = rr
        kept = sorted(
            best.values(),
            key=lambda rr: (rr.record.target, rr.record.instance.class_id,
                            rr.mode, rr.record.instance.workload_key()))
        old_segments = list(manifest["segments"])
        name = f"seg-{manifest['next_segment']:06d}.jsonl"
        self._write_segment(name, kept)
        manifest["segments"] = [name]
        manifest["next_segment"] += 1
        manifest["generation"] += 1
        self._write_manifest(manifest)
        self._snapshot = RegistrySnapshot(manifest["generation"], kept)
        self.compactions += 1
        for old in old_segments:
            if old != name and os.path.exists(self._segment_path(old)):
                os.unlink(self._segment_path(old))
        return self._snapshot.generation
