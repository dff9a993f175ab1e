"""Fleet serving driver: a request stream across N engine replicas.

The port of ``repro.launch.serve_fleet``: the same flags, plus ``--device``
(``cuda``, the default, or ``cpu``); weights drawn on the device from a
``torch.Generator`` seeded with 0 (the reference's ``PRNGKey(0)``);
``--targets`` defaulting to ``h100`` on the card, whose virtual clock is the
port's kernels timed there (``CachedRunner(MeasuredRunner())``, one per
target, timing between steps only), and to ``tpu-v5e`` on the CPU, where a
measured target is refused.  The audio and vision archs are refused (the
slot engine takes no ``extras`` yet, ROADMAP A.7).

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet --device cpu --preset smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_fleet --preset full --max-len 512 \
        --slots 4 --trace-out trace.json          # on the card, minitron-4b at full size
    PYTHONPATH=src python -m repro_torch.launch.trace_report trace.json

Stands a :class:`~repro_torch.fleet.ServingFleet` — router, admission queue,
demand-driven background tuning — in front of ``--replicas`` engine
replicas, drives a seeded synthetic trace through it, and prints the fleet
summary JSON (throughput, p50/p95/p99 latency, queue depth, shed rate,
per-replica tier composition, cross-replica schedule-mismatch count).

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet --device cpu \
        --arch minitron-4b --replicas 3 --policy plan_aware --prefetch \
        --arrival-rate 0.8 --queue-cap 16 --requests 24 --seed 7

``--tuning-registry DIR`` shares one schedule registry across every replica
(omitted: a temporary registry, discarded at exit — still exercises the
full background-tuning path, just from a cold, donor-less store).
``--targets`` assigns per-replica hardware targets (comma-separated, cycled
over replicas) for heterogeneous fleets; ``--donor-target`` draws transfer
donors from another chip's namespace.

``--engine paged`` swaps every replica to the paged-KV continuous-batching
engine (``--decode-batch`` lanes over a ``--pool-pages`` x ``--page-size``
KV pool, ``--chunk``-token prefill slices); ``--engine slot`` (default)
keeps the fixed-slot engine.  See DESIGN.md §8.

``--autoscale`` makes the fleet elastic: a hysteresis controller over the
windowed telemetry warm-joins replicas (up to ``--max-replicas``) under
pressure and drain-retires them (down to ``--min-replicas``) when quiet;
``--scale-window`` / ``--cooldown`` are in ticks.  ``--traffic bursty``
(square-wave: ``--burst-rate`` / ``--burst-every`` / ``--burst-len``) and
``--traffic diurnal`` (sinusoid: ``--period`` / ``--amplitude``) produce
the load shapes the controller is built for; ``--save-trace`` records the
generated stream and ``--replay-trace`` replays a recorded one verbatim.
See DESIGN.md §9.

``--speculative all|auto`` turns on draft-then-verify decoding on paged
replicas (DESIGN.md §11): ``--draft-model self:K`` builds a truncated
self-draft from the target's first K layers (``--spec-damp`` scales the
deeper layers' residual contributions down, controlling the acceptance
rate), ``--spec-k`` sets the draft tokens per burst, and ``auto`` decides
spec-vs-plain per request from the measured per-class acceptance rate
(``--class-mix chat=0.7,bulk=0.3`` stamps seeded workload classes on the
generated traffic).

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet --device cpu \
        --engine paged --speculative auto --draft-model self:1 --spec-k 4 \
        --class-mix chat=0.7,bulk=0.3 --requests 24

``--slo`` attaches burn-rate SLO monitors (bare flag: default objectives —
p95 latency, TTFT, shed rate, deadline hits; or a
``name:kind:objective[:threshold_ticks]`` spec list): each objective's
error-budget burn is evaluated every ``--slo-window`` ticks over fast and
slow windows, alert transitions land in the trace, and active alerts feed
the autoscaler as scale-up pressure.  ``--prefetch advisor`` replaces
demand-count prefetch ordering with the closed-loop ranking
(critical-path seconds x remaining speedup headroom); the summary then
carries ``slo`` and ``speedup_ledger`` blocks (realized vs attainable
speedup — the paper's metric, live).  See DESIGN.md §12.

``--trace-out trace.json`` records every span/event of the run — request
queue→prefill→decode lifecycles per replica track, engine iterations,
tuning jobs, router and autoscaler decisions — as a Chrome trace on the
fleet's virtual clock (open it at https://ui.perfetto.dev, or feed it to
``python -m repro_torch.launch.trace_report``); ``--metrics-out`` dumps the
fleet-wide metrics registry.  See DESIGN.md §10.
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile

from repro_torch.configs.base import get_arch, reduced
from repro_torch.fleet import (
    POLICIES,
    Autoscaler,
    BurstyTraffic,
    DiurnalTraffic,
    ServingFleet,
    TrafficGenerator,
    load_trace,
    save_trace,
)
from repro_torch.models.build import build_model
from repro_torch.launch.serve import DEFAULT_TARGETS
from repro_torch.targets import list_targets


def _parse_slos(spec: str, tick_s: float):
    """``--slo`` value -> ``ServingFleet(slos=...)`` argument.

    ``"default"`` passes through; otherwise each comma-separated item is
    ``name:kind:objective[:threshold_ticks]`` (threshold in ticks, scaled
    by the fleet's ``tick_s`` so specs are portable across arch sizes).
    """
    from repro_torch.obs import SLO
    if spec == "default":
        return "default"
    slos = []
    for item in spec.split(","):
        parts = item.strip().split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"bad --slo item {item!r}: name:kind:objective[:ticks]")
        name, kind, objective = parts[0], parts[1], float(parts[2])
        threshold = float(parts[3]) * tick_s if len(parts) == 4 else None
        slos.append(SLO(name=name, kind=kind, objective=objective,
                        threshold_s=threshold))
    return slos


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="serve a request stream across "
                                             "a fleet of engine replicas")
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--policy", choices=sorted(POLICIES), default="plan_aware")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="expected requests per tick (one tick = one untuned "
                         "decode step)")
    ap.add_argument("--queue-cap", type=int, default=16,
                    help="admission-queue bound; overflow sheds")
    ap.add_argument("--prefetch", nargs="?", const="hot", default="off",
                    choices=["off", "hot", "advisor"],
                    help="background tuning prefetch: 'hot' (bare flag) "
                         "orders by bucket demand, 'advisor' by "
                         "critical-path seconds x speedup headroom")
    ap.add_argument("--engine", choices=["slot", "paged"], default="slot",
                    help="replica engine: fixed decode slots, or paged-KV "
                         "continuous batching with chunked prefill")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--decode-batch", type=int, default=None,
                    help="paged: decode lanes per replica (default: --slots)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="paged: tokens per KV page")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="paged: total KV pages per replica (default: every "
                         "lane at full context)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="paged: prefill chunk length (tokens per step)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="traffic seed (same seed -> same trace)")
    ap.add_argument("--deadline-ticks", type=float, default=None,
                    help="shed queued requests older than this many ticks")
    ap.add_argument("--long-frac", type=float, default=0.25,
                    help="fraction of long-prompt requests in the mix")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines run (cuda: the card, which must "
                         "be there)")
    ap.add_argument("--targets", default=None,
                    help="comma-separated per-replica hardware targets "
                         f"(cycled; registered: {','.join(list_targets())}; "
                         "default: h100 on --device cuda, tpu-v5e on the CPU)")
    ap.add_argument("--donor-target", choices=list_targets(), default=None,
                    help="draw transfer donors from another chip's namespace")
    ap.add_argument("--tuning-registry", default="",
                    help="shared schedule-registry dir (default: temporary)")
    ap.add_argument("--tuning-budget-s", type=float, default=float("inf"))
    ap.add_argument("--drain-jobs", type=int, default=2,
                    help="background tuning jobs drained per burst")
    ap.add_argument("--defrag-threshold", type=float, default=None,
                    help="paged: defragment a replica's KV pool when its "
                         "fragmentation exceeds this (0, 1) ratio")
    ap.add_argument("--autoscale", action="store_true",
                    help="elastic fleet: warm-join/drain-retire replicas "
                         "between --min-replicas and --max-replicas")
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--scale-window", type=float, default=4.0,
                    help="autoscaler telemetry window, in ticks")
    ap.add_argument("--cooldown", type=float, default=8.0,
                    help="refractory period after a scale action, in ticks")
    ap.add_argument("--traffic", choices=["poisson", "bursty", "diurnal"],
                    default="poisson", help="arrival-rate shape")
    ap.add_argument("--burst-rate", type=float, default=2.0,
                    help="bursty: requests per tick during a burst")
    ap.add_argument("--burst-every", type=float, default=48.0,
                    help="bursty: ticks between burst starts")
    ap.add_argument("--burst-len", type=float, default=10.0,
                    help="bursty: burst duration in ticks")
    ap.add_argument("--period", type=float, default=96.0,
                    help="diurnal: rate-curve period in ticks")
    ap.add_argument("--amplitude", type=float, default=None,
                    help="diurnal: rate swing (default 0.8x --arrival-rate)")
    ap.add_argument("--speculative", choices=["off", "all", "auto"],
                    default="off",
                    help="paged: draft-then-verify decoding — 'all' "
                         "speculates every request, 'auto' decides per "
                         "request from measured per-class acceptance")
    ap.add_argument("--draft-model", default="self:1",
                    help="draft spec: 'self:K' truncates the target to its "
                         "first K layers (shared embeddings/head)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculative burst")
    ap.add_argument("--spec-damp", type=float, default=0.02,
                    help="self-draft: residual damping of the target's "
                         "deeper layers (0 -> draft == target, alpha = 1)")
    ap.add_argument("--class-mix", default="",
                    help="workload-class mixture, e.g. chat=0.7,bulk=0.3 "
                         "(empty: unclassified traffic)")
    ap.add_argument("--save-trace", default="",
                    help="record the generated request trace to this file")
    ap.add_argument("--replay-trace", default="",
                    help="replay a recorded trace instead of generating one")
    ap.add_argument("--slo", nargs="?", const="default", default="",
                    help="attach SLO burn-rate monitors: bare flag uses the "
                         "default objectives (p95 latency, TTFT, shed, "
                         "deadline); or a spec like "
                         "'p95:latency:0.95:40,ttft:ttft:0.9:20' — "
                         "name:kind:objective[:threshold_ticks]")
    ap.add_argument("--slo-window", type=float, default=4.0,
                    help="SLO evaluation window, in ticks")
    ap.add_argument("--trace-out", default="",
                    help="write a Perfetto-loadable Chrome trace of the run "
                         "(virtual-clock spans; open at ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default="",
                    help="write the fleet-wide metrics registry as JSON")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.preset == "smoke":
        cfg = reduced(cfg)
    if args.targets is None:
        args.targets = DEFAULT_TARGETS[args.device]
    model = build_model(cfg, args.device)
    params = model.init(seed=0)

    from repro_torch.service import ScheduleRegistry

    tmp_root = None
    root = args.tuning_registry
    if not root:
        tmp_root = tempfile.mkdtemp(prefix="fleet-registry-")
        root = tmp_root
    registry = ScheduleRegistry(root)

    names = [t.strip() for t in args.targets.split(",") if t.strip()]
    targets = [names[i % len(names)] for i in range(args.replicas)]

    engine_kw = {}
    if args.engine == "paged":
        engine_kw = {"decode_batch": args.decode_batch,
                     "page_size": args.page_size,
                     "pool_pages": args.pool_pages, "chunk": args.chunk,
                     "defrag_threshold": args.defrag_threshold}
    if args.speculative != "off":
        if args.engine != "paged":
            ap.error("--speculative requires --engine paged")
        from repro_torch.serving import make_self_draft
        if not args.draft_model.startswith("self:"):
            ap.error("--draft-model must be 'self:K' (truncated self-draft)")
        keep = int(args.draft_model.split(":", 1)[1])
        dcfg, dparams, params = make_self_draft(
            cfg, params, keep_layers=keep, damp=args.spec_damp)
        engine_kw.update(
            speculative=("auto" if args.speculative == "auto" else True),
            draft_model=build_model(dcfg, args.device), draft_params=dparams,
            spec_k=args.spec_k)
    from repro_torch.obs import Tracer
    from repro_torch.obs.export import write_chrome_trace

    tracer = Tracer() if args.trace_out else None
    prefetch = {"off": False, "hot": True, "advisor": "advisor"}[args.prefetch]
    slos = None
    if args.slo:
        slos = ("default" if args.slo == "default"
                else (lambda tick_s: _parse_slos(args.slo, tick_s)))
    try:
        fleet = ServingFleet(
            cfg, model, params, replicas=args.replicas, slots=args.slots,
            max_len=args.max_len, engine=args.engine, registry=registry,
            policy=args.policy, queue_cap=args.queue_cap,
            prefetch=prefetch, targets=targets,
            donor_target=args.donor_target, tuning_budget_s=args.tuning_budget_s,
            drain_jobs=args.drain_jobs, seed=args.seed,
            tracer=tracer, slos=slos, **engine_kw)
    except BaseException:  # a refused target leaves no temporary registry behind
        if tmp_root is not None:
            shutil.rmtree(tmp_root, ignore_errors=True)
        raise
    if slos is not None:
        fleet.set_slo_window(args.slo_window * fleet.tick_s)
    if args.autoscale:
        fleet.attach_autoscaler(Autoscaler(
            min_replicas=args.min_replicas, max_replicas=args.max_replicas,
            window_s=args.scale_window * fleet.tick_s,
            cooldown_s=args.cooldown * fleet.tick_s))

    class_mix = None
    if args.class_mix:
        class_mix = {}
        for part in args.class_mix.split(","):
            name, _, w = part.partition("=")
            class_mix[name.strip()] = float(w)
    gen_kw = dict(seed=args.seed, vocab_size=cfg.vocab_size,
                  arrival_rate=args.arrival_rate, tick_s=fleet.tick_s,
                  long_frac=args.long_frac,
                  deadline_ticks=args.deadline_ticks,
                  prompt_cap=max(args.max_len // 2, 1),
                  class_mix=class_mix)
    if args.replay_trace:
        trace = load_trace(args.replay_trace)
    else:
        if args.traffic == "bursty":
            gen = BurstyTraffic(burst_rate=args.burst_rate,
                                burst_every_ticks=args.burst_every,
                                burst_len_ticks=args.burst_len, **gen_kw)
        elif args.traffic == "diurnal":
            gen = DiurnalTraffic(period_ticks=args.period,
                                 amplitude=args.amplitude, **gen_kw)
        else:
            gen = TrafficGenerator(**gen_kw)
        trace = gen.trace(args.requests)
    if args.save_trace:
        save_trace(args.save_trace, trace)
    try:
        summary = fleet.serve(trace)
    finally:
        fleet.close()  # close first: pending-job cancel events land in trace
        if tracer is not None:
            write_chrome_trace(args.trace_out, tracer)
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump(fleet.obs.to_json(), f, indent=1, sort_keys=True)
        if tmp_root is not None:
            shutil.rmtree(tmp_root, ignore_errors=True)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
