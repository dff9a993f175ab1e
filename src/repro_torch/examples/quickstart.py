"""Quickstart: the paper's workflow in five steps (the counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # step 5 on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

1. auto-schedule a donor architecture (the expensive step you do ONCE);
2. persist its schedule database (``--db``);
3. pick a donor for a new target with the Eq. 1 heuristic;
4. transfer-tune the target in seconds of (virtual) search;
5. run one of the target's kernels, K1, under the schedule the transferred
   map resolves to, and compare it with its plain version (``kernels/ref``).

Steps 1-4 are analytical: speedups and search seconds come from the cost
model of the default target.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core.database import ScheduleDB
from repro_torch.core.tuner import donor_ranking, transfer_arch, tune_arch
from repro_torch.kernels import ops
from repro_torch.kernels.ops import ScheduleProvider
from repro_torch.models.build import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="the paper's workflow in five steps")
    ap.add_argument("--db", default=os.path.join(tempfile.gettempdir(), "repro_torch_quickstart_db.json"),
                    help="where step 2 persists the schedule database")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    db = ScheduleDB()

    print("== 1. auto-schedule donors (Ansor analogue; done once, offline) ==")
    for donor in ("dbrx-132b", "minitron-4b"):
        res = tune_arch(db, donor, "train_4k", dp=16, tp=16, total_trials=384)
        print(f"  {donor}: {res.untuned_seconds / res.tuned_seconds:.1f}x model speedup "
              f"after {res.total_trials} trials ({res.search_time_s:.0f}s virtual search)")

    print("== 2. persist the schedule database ==")
    db.save(args.db)
    print(f"  {len(db)} records -> {args.db}")

    target = "mixtral-8x22b"
    print(f"== 3. donor selection for {target} (Eq. 1) ==")
    for ds in donor_ranking(db, target, "train_4k", dp=16, tp=16):
        print(f"  score {ds.score:.4f}  {ds.model_id}")

    print("== 4. transfer-tune the target ==")
    tt = transfer_arch(ScheduleDB.load(args.db), target, "train_4k", dp=16, tp=16, donors="auto")
    print(f"  model speedup {tt.speedup:.2f}x  coverage {tt.coverage():.0%}  "
          f"search {tt.search_time_s:.0f}s virtual (vs thousands for full tuning)")

    print("== 5. execute a kernel with its transferred schedule ==")
    provider = ScheduleProvider(tt.schedule_map())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64, 48)).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.normal(size=(48, 64)).astype(np.float32)).to(device)
    y = ops.matmul(x, w, provider=provider)   # the card: K1; the CPU: its plain version
    err = float((y - ops.matmul(x, w, backend="ref")).abs().max())
    print(f"  kernel-vs-plain max err: {err:.2e} ({device.type})")
    print("done.")
    return {"db": args.db, "records": len(db), "speedup": tt.speedup, "max_err": err,
            "device": device.type}


if __name__ == "__main__":
    main()
