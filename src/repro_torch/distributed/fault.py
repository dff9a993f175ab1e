"""Fault tolerance: straggler detection, preemption handling, elastic
re-mesh (the counterpart of ``repro.distributed.fault``).

* :class:`StragglerMonitor` — EWMA of per-step wall times; steps slower than
  ``threshold×`` the EWMA are flagged (copied).
* :class:`PreemptionHandler` — converts SIGTERM (and a programmatic
  ``request()``) into a "checkpoint now, then exit cleanly" flag the train
  loop polls each step (copied).
* :func:`elastic_restore` — restore a checkpoint onto the current process
  group's mesh, whatever mesh (or single process) wrote it: the specs are
  rebuilt for the new mesh from the same rules, and each rank reads only
  its slices (checkpoints store full leaves, so this is total).
"""
from __future__ import annotations

import signal
import threading

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import MeshGroups, ShardedTree
from repro_torch.tree import tree_map


class StragglerMonitor:
    def __init__(self, alpha: float = 0.2, threshold: float = 2.0, warmup: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: float | None = None
        self.count = 0
        self.flagged: list[tuple[int, float, float]] = []  # (step, dt, ewma)

    def record(self, step: int, dt: float) -> bool:
        """Record one step duration; returns True if flagged as straggler."""
        self.count += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = self.count > self.warmup and dt > self.threshold * self.ewma
        if is_straggler:
            self.flagged.append((step, dt, self.ewma))
        else:
            # stragglers don't poison the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


class PreemptionHandler:
    """SIGTERM → graceful 'checkpoint and exit' request."""

    def __init__(self, install_signal: bool = True):
        self._event = threading.Event()
        if install_signal:
            try:
                signal.signal(signal.SIGTERM, lambda *_: self._event.set())
            except ValueError:
                pass  # non-main thread (tests)

    def request(self) -> None:
        self._event.set()

    @property
    def requested(self) -> bool:
        return self._event.is_set()


def elastic_restore(manager: CheckpointManager, template: dict, cfg: ArchConfig,
                    groups: MeshGroups, step: int | None = None,
                    dp_only: bool = False) -> tuple[int, dict]:
    """Restore a {"params": …, "opt": …} bundle as this rank's shards on
    ``groups.mesh``.

    ``template`` is the bundle with full shapes (``meta`` tensors will do);
    the specs are rebuilt for the new mesh from the same logical rules
    (``dp_only``: the ``dp`` strategy's), so any divisibility fallbacks
    re-evaluate for the new axis sizes.  Other keys restore whole."""
    p_specs = shd.param_shardings(template["params"], cfg, groups.mesh, dp_only)
    specs = {"params": p_specs}
    if "opt" in template:
        specs["opt"] = shd.opt_state_shardings(p_specs, template["opt"])
    shardings = {k: (ShardedTree(groups, v, specs[k]).slices() if k in specs
                     else tree_map(lambda _: None, v))
                 for k, v in template.items()}
    return manager.restore(template, step=step, shardings=shardings)
