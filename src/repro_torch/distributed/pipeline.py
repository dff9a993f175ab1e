"""Pipeline parallelism over the ranks of a process group (GPipe; the
counterpart of ``repro.distributed.pipeline``, which runs it under
``shard_map`` over the ``pod`` axis).

Each rank holds one stage.  The batch splits into microbatches, and the
classic schedule runs ``n_micro + n_stages - 1`` ticks: at tick ``t``, stage
``s`` applies its ``stage_fn`` to microbatch ``t - s`` (when that is one)
and sends the activation to stage ``s + 1`` (``isend``/``irecv``).  The last
stage's outputs reach every rank (a broadcast), as the reference's final
``psum`` replicates them.  A stage's output has its input's shape and
dtype, as in the reference.  Bubble fraction = (S-1)/(M+S-1), reported by
:func:`bubble_fraction` so launch configs can size microbatch counts.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                   x: torch.Tensor, *, group=None, n_microbatches: int | None = None,
                   counter=None) -> torch.Tensor:
    """Run ``x`` (the global batch, the same on every rank) through one
    stage per rank of ``group``: this rank's stage is ``stage_fn`` with
    ``stage_params``.  Returns the last stage's output on every rank.
    ``counter``: a :class:`~repro_torch.distributed.collectives.
    CollectiveCounter` (sends counted as ``send``, the final broadcast as
    ``broadcast``)."""
    n_stages = dist.get_world_size(group)
    s = dist.get_rank(group)
    n_micro = n_microbatches or n_stages
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    outs = torch.zeros_like(micro)
    rank_of = (lambda r: r) if group is None else (lambda r: dist.get_global_rank(group, r))
    prev, nxt = s - 1, s + 1
    sends = []
    for t in range(n_micro + n_stages - 1):
        m = t - s
        if not 0 <= m < n_micro:
            continue
        if s == 0:
            buf = micro[m]
        else:
            buf = torch.empty_like(micro[0])
            dist.irecv(buf, src=rank_of(prev), group=group).wait()
        y = stage_fn(stage_params, buf)
        if nxt < n_stages:
            y = y.contiguous()
            sends.append(dist.isend(y, dst=rank_of(nxt), group=group))
            if counter is not None:
                counter.add("send", y, y)
        else:
            outs[m] = y
    for req in sends:
        req.wait()
    dist.broadcast(outs, src=rank_of(n_stages - 1), group=group)
    if counter is not None:
        counter.add("broadcast", outs, outs)
    return outs.reshape(b, *x.shape[1:])
