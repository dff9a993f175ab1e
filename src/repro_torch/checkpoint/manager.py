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
on its template leaf's device; restoring onto another mesh waits for the
port's distributed training (ROADMAP A.9).
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

from repro_torch.tree import leaves_with_paths, unflatten

#: the manifest's dtype names (the reference's, numpy's) <-> torch dtypes
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
          "float64": torch.float64, "int8": torch.int8, "uint8": torch.uint8,
          "int16": torch.int16, "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as a flat uint8 array."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _from_raw(raw: np.ndarray, dtype: str, shape: list[int]) -> torch.Tensor:
    flat = torch.from_numpy(np.ascontiguousarray(raw, dtype=np.uint8).copy())
    return flat.view(DTYPES[dtype]).reshape(shape)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Snapshot to host then write. blocking=False writes in background
        (async checkpointing): training resumes right after the snapshot."""
        self.wait()
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

    def _write(self, step: int, host: list) -> None:
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

    def restore(self, template: Any, step: int | None = None) -> tuple[int, Any]:
        """Restore into the structure of ``template`` (tensors, or anything
        with ``shape``, ``dtype`` and ``device``: a ``meta`` tensor, say).
        Each leaf comes back with its template's dtype on its device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        out = []
        for path, tmpl in leaves_with_paths(template):
            if path not in by_path:
                raise KeyError(f"checkpoint missing leaf {path}")
            entry = by_path[path]
            arr = _from_raw(np.load(os.path.join(d, entry["file"])), entry["dtype"], entry["shape"])
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch for {path}: ckpt {tuple(arr.shape)} "
                                 f"vs {tuple(tmpl.shape)}")
            device = tmpl.device if tmpl.device.type != "meta" else "cpu"
            out.append(arr.to(device=device, dtype=tmpl.dtype))
        return manifest["step"], unflatten(template, out)
