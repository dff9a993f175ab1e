"""Transfer-tuning deep dive: the paper's §4.1 GEMM example and its Fig. 4
matrix (the counterpart of ``examples/transfer_tuning_demo.py``).

    PYTHONPATH=src python -m repro_torch.examples.transfer_tuning_demo

Shows schedule anatomy (tiles / order / staging), cross-shape application,
invalid transfers, adaptive reformulation (beyond-paper), and the
per-kernel transfer matrix for a same-family arch pair.  Analytical: every
time is the cost model's, of the default target (model microseconds); no
device is touched.
"""
from __future__ import annotations

import argparse

from repro_torch.core.autoscheduler import tune_kernel
from repro_torch.core.cost_model import kernel_seconds, measure
from repro_torch.core.database import ScheduleDB
from repro_torch.core.schedule import default_schedule
from repro_torch.core.transfer import transfer_matrix
from repro_torch.core.tuner import arch_uses, tune_arch
from repro_torch.core.workload import KernelInstance


def show_schedule(tag, sched):
    print(f"  {tag}: tiles={sched.t} order={sched.order} "
          f"unroll={sched.unroll} vec={sched.vec} cache_write={sched.cache_write}")


def main(argv=None) -> dict:
    argparse.ArgumentParser(description="transfer-tuning deep dive (analytical)").parse_args(argv)
    print("== GEMM 512^3 vs 1024^3 (paper §4.1) ==")
    g = {s: KernelInstance.make("matmul", M=s, N=s, K=s) for s in (512, 1024)}
    tuned = {s: tune_kernel(g[s], trials=256) for s in (512, 1024)}
    for s in (512, 1024):
        u = kernel_seconds(g[s], default_schedule(g[s]))
        print(f"  {s}^3: untuned {u * 1e6:.1f} model-us -> tuned "
              f"{tuned[s].best_seconds * 1e6:.1f} model-us ({u / tuned[s].best_seconds:.1f}x)")
        show_schedule(f"{s}^3 schedule", tuned[s].best)
    for src, dst in ((512, 1024), (1024, 512)):
        m = measure(g[dst], tuned[src].best, noise_sigma=0.0)
        if m.valid:
            print(f"  {src}->{dst} strict: {m.seconds * 1e6:.1f} model-us "
                  f"({m.seconds / tuned[dst].best_seconds:.2f}x of native)")
        else:
            print(f"  {src}->{dst} strict: INVALID (paper Fig. 4's -1)")
            ma = measure(g[dst], tuned[src].best, mode="adaptive", noise_sigma=0.0)
            print(f"  {src}->{dst} adaptive reformulation (beyond-paper): "
                  f"{ma.seconds * 1e6:.1f} model-us "
                  f"({ma.seconds / tuned[dst].best_seconds:.2f}x of native)")

    print("\n== Fig. 4 analogue: mixtral-8x22b kernels x dbrx-132b schedules ==")
    db = ScheduleDB()
    tune_arch(db, "dbrx-132b", "train_4k", dp=16, tp=16, total_trials=384)
    uses = arch_uses("mixtral-8x22b", "train_4k", dp=16, tp=16)
    mat = transfer_matrix(uses, db, donors=["dbrx-132b"])
    rows = {}
    for u in uses:
        row = mat[u.instance.workload_key()]
        untuned = kernel_seconds(u.instance)
        cells = " ".join(
            "-1" if s is None else f"{untuned / s:.2f}x" for s in row.values())
        print(f"  {u.tag:12s} [{u.instance.class_id:22s}] -> {cells or '(no donors)'}")
        rows[u.tag] = cells
    return {"matrix": rows}


if __name__ == "__main__":
    main()
