"""Fault-tolerant checkpointing: leaf files + manifest, async save, atomic
commit and retention (the counterpart of ``repro.checkpoint.manager``).

Layout:  <dir>/step_000123/
            manifest.json       {step, leaves: [{path, shape, dtype, file}]}
            leaf_00000.npy ...
as the reference writes it.  Each leaf file holds the tensor's raw bytes as
a flat ``uint8`` array; its true shape and dtype live in the manifest, the
dtype under the reference's name (``bfloat16``, ``float32``, ``int32``...).
A bf16 leaf is stored as its 16-bit patterns and restored from them bit for
bit: numpy has no bfloat16, and the port reads and writes the bytes through
torch alone (no ``ml_dtypes``).  A checkpoint directory is written under a
``.tmp`` name and atomically renamed on completion, so a preemption
mid-save never corrupts the latest checkpoint.  ``restore`` puts each leaf
on its template leaf's device.

Sharded trees (:mod:`repro_torch.distributed`): ``save(..., sharded=)``
gathers each leaf in turn (a collective on every rank) and rank 0 writes
the reference's layout, full leaves, so its host holds one full leaf at a
time; ``restore(..., shardings=)`` reads each leaf through
``np.load(mmap_mode="r")`` and materialises only this rank's slice, so a
checkpoint restores onto any mesh whatever mesh wrote it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten_up_to, leaves_with_paths, unflatten

#: the manifest's dtype names (the reference's, numpy's) <-> torch dtypes
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
          "float64": torch.float64, "int8": torch.int8, "uint8": torch.uint8,
          "int16": torch.int16, "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}
_UINTS = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as a flat uint8 array."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _from_raw(raw: np.ndarray, dtype: str, shape: list[int]) -> torch.Tensor:
    flat = torch.from_numpy(np.ascontiguousarray(raw, dtype=np.uint8).copy())
    return flat.view(DTYPES[dtype]).reshape(shape)


def _slice_raw(raw: np.ndarray, dtype: str, shape: list[int], index: tuple) -> torch.Tensor:
    """``index`` of a leaf stored as raw bytes, reading only what it covers
    (``raw`` memory-mapped): the bytes are viewed as unsigned ints of the
    dtype's width, sliced, then viewed as the dtype."""
    width = torch.empty((), dtype=DTYPES[dtype]).element_size()
    part = np.array(raw.view(_UINTS[width]).reshape(shape)[index], order="C")
    flat = torch.from_numpy(part.reshape(-1).view(np.uint8).copy())
    return flat.view(DTYPES[dtype]).reshape(part.shape)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True, sharded=None) -> None:
        """Snapshot to host then write. blocking=False writes in background
        (async checkpointing): training resumes right after the snapshot.

        ``sharded``: ``tree`` holds this rank's shards, placed by this
        :class:`~repro_torch.distributed.collectives.ShardedTree`.  Every
        rank calls; each leaf is gathered in turn and rank 0 writes it
        (blocking; rank 0's host holds one full leaf at a time), then all
        ranks meet at a barrier."""
        self.wait()
        if sharded is not None:
            self._save_sharded(step, tree, sharded)
            return
        host = [(path, leaf.detach().to("cpu", copy=True)) for path, leaf in leaves_with_paths(tree)]
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(target=self._write_guard, args=(step, host))
            self._thread.start()

    def _write_guard(self, step: int, host: list) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # surfaced on the next wait()/save()
            self._error = e

    def _save_sharded(self, step: int, tree: Any, sharded) -> None:
        import torch.distributed as dist

        paths = [path for path, _ in leaves_with_paths(sharded.like)]   # full_leaves' order
        fulls = sharded.full_leaves(tree)
        if sharded.groups.rank == 0:
            self._write(step, ((path, full.to("cpu")) for path, full in zip(paths, fulls)))
        else:
            for _ in fulls:
                pass
        dist.barrier()

    def _write(self, step: int, host) -> None:
        """Write (path, host tensor) pairs, one after another."""
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        entries = []
        for i, (path, leaf) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), _raw_bytes(leaf), allow_pickle=False)
            entries.append({"path": path, "file": fname,
                            "shape": list(leaf.shape), "dtype": _NAMES[leaf.dtype]})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": entries}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None,
                shardings: Any = None) -> tuple[int, Any]:
        """Restore into the structure of ``template`` (tensors, or anything
        with ``shape``, ``dtype`` and ``device``: a ``meta`` tensor, say).
        Each leaf comes back with its template's dtype on its device.

        ``shardings``: a tree of the template's structure whose leaves are
        this rank's index into the full leaf (a tuple of slices, as
        ``ShardedTree.slices`` gives) or None (the whole leaf); the template
        has the full shapes.  Only the slice is read into memory."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        flat = leaves_with_paths(template)
        index = ([None] * len(flat) if shardings is None
                 else flatten_up_to(shardings, template))
        out = []
        for (path, tmpl), idx in zip(flat, index):
            if path not in by_path:
                raise KeyError(f"checkpoint missing leaf {path}")
            entry = by_path[path]
            if tuple(entry["shape"]) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch for {path}: ckpt {tuple(entry['shape'])} "
                                 f"vs {tuple(tmpl.shape)}")
            if idx is None:
                arr = _from_raw(np.load(os.path.join(d, entry["file"])), entry["dtype"],
                                entry["shape"])
            else:
                arr = _slice_raw(np.load(os.path.join(d, entry["file"]), mmap_mode="r"),
                                 entry["dtype"], entry["shape"], idx)
            device = tmpl.device if tmpl.device.type != "meta" else "cpu"
            out.append(arr.to(device=device, dtype=tmpl.dtype))
        return manifest["step"], unflatten(template, out)
