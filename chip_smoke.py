#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit.  Phases, one result line each:

1. device — the card's name and power limit (nvidia-smi);
2. build  — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``;
   registers and spills (ptxas) of the tensor-core matmul body per CTA
   tile, of the tensor-core attention body per head dim, and of the rows
   (decode) matmul body per dtype;
3. matmul — the matmul kernel against its plain version: every epilogue class
   at small ragged shapes (bf16 and f32), then minitron-4b's main-path shapes,
   timed beside the plain version and ``torch.matmul``, and under both the
   default schedule and 64x64 output tiles, each shape with its body, CTA
   tile, K split, CTA count and time over ``torch.matmul``'s in the same
   call; the 256-row shapes checked and timed on each compiled CTA tile of
   the tensor-core body; the 4-row (decode) shapes on the rows body also
   timed on the device alone (profiler), and a row's bits checked equal at
   M = 1 and M = 4 and across two runs; then rounding mode
   (``cache_write=False``: partial sums rounded to bf16 after every K tile,
   as the reference does) on the rows body at 4 rows and the tensor-core
   body at 256, K tiles of 16, 128 and 24, and the served path's rounding
   launch (recurrentgemma-2b's decode LM head, K tile 256), each against
   the plain version with the same rounding K tile (the share of elements
   that differ, the largest distance in bf16 values) and timed beside the
   same tiles with f32 sums;
4. attention — the flash-attention kernel against its plain version, bf16
   (tensor-core body) and f32 (CUDA-core body), each launch's body checked:
   causal, window, softcap, q_offset, GQA groups 1 and 3, ragged lengths,
   head dims 16 to 256; a prompt's rows bit-equal in one call and in two
   calls split by q_offset; then each served arch's prefill shape, timed
   beside the plain version and ``F.scaled_dot_product_attention`` (event
   time and device time), with its CTA count;
5. scans — the rwkv6 (wkv6) and RG-LRU scan kernels against their plain
   versions, bf16 and f32, from a non-zero initial state: decode (T = 1), a
   prime T (default T tile 1), head dims 16, 32 and 64, 1 to 3 heads, 2560
   channels, a ragged 12 under a tile of 8 and 100 (element-wise staging);
   bit for bit: T = 256 under T tiles 1, 2, 8, 64, 256 and the default,
   (RG-LRU) C tiles 8, 512 and 2560, state continuation (two scans from the
   returned state equal one), a batch row at B = 1 and at B = 4, and two
   runs; then the main-path shapes, each with its CTA count from the
   kernel's geometry function, timed by events and on the device beside
   the plain versions;
6. grouped — the grouped (MoE expert) matmul kernel against its plain
   version in both classes (``moe_gemm_silu_glu``, ``moe_gemm``), bf16 and
   f32: 1, 3 and 8 experts, decode-shaped 4 rows per expert, a ragged row
   count under a tile that does not divide it (rows and tiled bodies), N
   not a multiple of 8, N-outer schedules; then mixtral-8x22b's main-path
   shapes (4 and 256 rows per expert) timed beside the plain version and
   ``torch.bmm`` (for ``moe_gemm``; no one call computes the GLU class),
   with body, CTA tile, K split and count, and at 256 rows on each compiled
   CTA tile; rounding mode on both bodies as in the matmul phase;
7. tuning — the paper's workflow on the card, every second timed by
   ``repro_torch.core.measured_runner.MeasuredRunner`` (the port's kernels
   launched under each schedule, L2 flushed, the stream held behind a sleep
   so CUDA events time the device), on the kernel lists of one 256-token
   prompt at each arch's full width: the runner checked (397x2048x2048's
   default 1-row M tiles at least 5x slower than 64x64 tiles; its times
   beside the profiler's device times on four shapes); one search of 32
   trials each for K2 (minitron-4b), K3 (rwkv6-1.6b) and K4
   (recurrentgemma-2b); then three pairs: starcoder2-7b and stablelm-12b
   fully tuned as donors (their records no slower than the default
   published to a ``ScheduleDB``), minitron-4b's donor picked by Eq. 1 and
   transfer-tuned from it, and minitron-4b fully tuned (a runner of its own)
   until it matches the transfer; dbrx-132b fully tuned and mixtral-8x22b
   transferred from it and fully tuned alike; recurrentgemma-2b at its
   prime 181-token prompt (default M and Q tiles of 1) from the first
   pair's donors alike.  It fails unless every
   transferred kernel is no slower than its default, every kernel (K1,
   K1g, K2, K3, K4) launched in the phase, and every schedule the searches
   chose that launches otherwise than the default, and four random ones per
   searched kernel, agree with the plain version.  Its results go on a
   line of their own, ``{"tuning": ...}``;
8. serve — minitron-4b, rwkv6-1.6b and recurrentgemma-2b at full width and
   full depth, and mixtral-8x22b at full width with 8 of its 56 layers (at
   full depth its bf16 weights, ~280 GB, fit no one card); bf16, random
   weights from a seeded generator on the card, one arch after the other,
   each freed before the next loads: through
   ``repro_torch.launch.serve.main`` (``--preset full``; ``smoke`` for
   mixtral) and then the slot engine directly with 100-400-token prompts.
   Every request must finish with its token count, the launch counts of
   the arch's kernels must be above 0 (serve.main's as it counts them; the
   engine's set to 0 just before its run and read just after), the
   engine's bf16 prefill GEMMs must all take the matmul's tensor-core body
   (its launches above 0, the CUDA-core body's bf16 launches 0), every
   rows-body launch must take its layout from ``rows_geometry`` (the M = 4
   decode layouts are reported), every bf16 attention launch must take the
   tensor-core body, and the kernel path's prefill logits must agree with
   the plain path's on the same weights, end to end and layer by layer (a
   MoE layer's tokens that the two paths route to different experts
   counted and left out).  For minitron-4b, one torch.profiler capture of
   three decode steps gives the device's busy share and its five ops with
   the most device time.  Peak memory is read over weight init alone and
   then over serving (``init_peak_gib``, ``serve_peak_gib``).  The prime
   181-token prompt's matmul launches per body are kept (the recurrent
   archs prefill it unpadded: every default M tile is 1, all rows body);
9. serve_tuned — recurrentgemma-2b at full width served through a schedule
   registry (``launch.serve.make_provider``, ``--target h100``): the tuning
   phase's donor records plus one record in rounding mode (the decode LM
   head), a plan for the decode step, a warm pass (prefill lookups timed on
   the card), the deferred jobs drained, then a timed pass during which a
   record published for a decode instance makes the engine re-plan once.
   It prints the plan's tiers, lookups by tier, plan misses and the
   instances that missed, prefill seconds for the 8 prompts and for the
   181-token one against the serve phase's default run (same-call ratios),
   ms per decode step and the provider's share of a step's host time; it
   fails if the measured runner timed anything in the timed pass, if the
   prime prompt's K1 launches on the tensor cores are not exactly those the
   registry gave an M tile above 16, if a non-default launch served
   disagrees with its plain version, if the prefill logits leave the serve
   bound, or if the engine did not re-plan once;
10. paged — the paged engine (``serving/paged.py``: pages of 16 tokens,
   chunked prefill of 64 tokens, two chunks a step, 4 lanes, 512-token
   contexts) serving the 8 prompts, 16 new tokens each, for minitron-4b
   (K1, K2 at q_offset > 0), rwkv6-1.6b (K1, K3 continued from its state
   chunk by chunk) and recurrentgemma-2b (K1, K4), at full width and depth,
   beside the slot engine with exact-length prefill on the same weights in
   the same call (``phase_paged``: its checks are listed there).  It prints
   per arch the prefill seconds (the chunk calls), ms per decode step and
   decode tok/s beside the slot engine's, the pool's bytes beside the slot
   cache's, the serve peak, launches per kernel and body, and the 1-row-tile
   launches;
11. spec — speculative decoding on the paged engine, minitron-4b at full
   width, a self-draft of its first two layers, 3 proposals a burst, in
   three regimes (all-accept, all-reject, partial), each against plain
   paged decode on the same target (``phase_spec``).  It prints committed
   tokens per burst, ms per burst beside plain ms per step, and the K1
   bodies the verify launches took;
12. fleet — the serving fleet (``repro_torch.fleet``) at minitron-4b's full
   width and depth on its virtual clock, read from the port's kernels timed
   on the card (the ``h100`` target: ``CachedRunner(MeasuredRunner())``),
   through a registry of the tuning phase's donor records, on the seeded
   trace of 16 requests (32-356-token prompts, 8-16 new tokens): run A, two
   slot replicas of 4 slots, plan-aware routing, prefetch, default SLOs, a
   tracer; run B, one paged replica, speculative ``auto`` over a 2-layer
   self-draft (``phase_fleet``: its checks are listed there).  It prints
   per run the virtual latencies, TTFT and throughput beside the wall
   seconds and their ratio, the measured runner's timings and their wall
   seconds, the service's jobs, each replica's tiers before and after, the
   speedup ledger (A) or the acceptance per class (B), the critical path
   ``trace_report`` attributes, the launches per kernel and body, and the
   phase's peak memory.
The chunk shapes of the paged path (K2: a 64-row chunk at q_offset 256 of a
512-row cache; K1: 64x3072x3072 on the tensor cores) are timed after the
grouped phase beside their plain versions, SDPA given the same boolean mask
and ``torch.matmul`` (``phase_chunk_kernels``).

Then the tuning line, the script's wall time, one JSON line with every
kernel's numbers, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --scans-ab PARENT

times the scan kernels of another tree (``PARENT``, a checkout with its
own ``src/``; say, the parent commit unpacked with ``git archive``) against
this tree's at the main-path shapes, in turns (parent, this, this, parent),
each turn in its own process, and prints the same-call ratios.  Any failure raises: the script
exits non-zero and prints no result.  Times come from CUDA events, each
launch after an L2 flush (the serving path reads weights cold); they
include the host's time to enqueue the call, which is most of a decode-sized
launch, so those shapes also report device time from a profiler trace.  Bounds use
the H100 SXM's published peaks: 3.35 TB/s, 989 TFLOP/s dense bf16 on the
tensor cores, and 67 TFLOP/s f32 on the CUDA cores for the scans, which run
no matrix product.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_CUDA_CORE_FLOPS = 67e12

# Tolerances (|kernel - plain| <= atol + rtol * |plain|, elementwise).
# bf16: the repo's bf16 tolerance (tests/test_kernels_matmul.py::
# test_bfloat16_tolerance), on inputs scaled so outputs are of order one: both
# sides sum exact bf16 products in f32, in different orders, then round once
# to bf16, so they differ by at most about one bf16 ulp of the output.
# f32: the repo's f32 kernel tolerance (tests/test_kernels_*.py).
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
F32_TOL = dict(rtol=2e-4, atol=2e-4)
# Prefill logits of the full-depth bf16 model, kernel path vs plain path:
# each of ~200 ops rounds its bf16 output in the same places on both paths,
# but f32 sums taken in other orders can round to neighbouring bf16 values,
# and those one-ulp differences (2^-8 relative) carry through the residual
# stream.  How far they grow depends on the arch: minitron-4b and
# recurrentgemma-2b keep them near 1%, but rwkv6-1.6b at random init
# amplifies any difference from layer to layer, so two plain versions that
# differ only in how they accumulate drift as far apart as the kernel path
# does.
# The bound is therefore the larger of 5% of max |plain logit| and twice
# the control: the distance from the plain path to the plain path with its
# matmuls accumulated in f64 instead of f32 (same bf16 roundings, another
# sum order and precision: what the kernels change, with no kernel in it).
LOGITS_REL_BOUND = 0.05
CONTROL_FACTOR = 2.0
# The same comparison without the drift: each layer, run by both paths on
# the plain path's input to that layer, must give a block output (the
# layer's output minus its input) within 2% relative L2 of the plain
# path's.  One layer rounds a handful of ops to bf16 in the same places on
# both paths, a few tenths of a percent apart.
LAYER_REL_BOUND = 0.02
# Scan states, kernel vs plain.  The state is f32 on both sides, computed
# from the same f32 (or bf16-exact) inputs, in the same order over tokens;
# the two differ only where the kernel fuses a multiply and an add into
# one rounding (about one f32 ulp per step), and each step's error is
# damped by the decay (w, a < 1).  So the state is held at the f32
# tolerance whatever the input dtype; y at its dtype's tolerance.
STATE_TOL = F32_TOL

MAIN_KN = [(3072, 3072), (3072, 1024), (3072, 9216), (9216, 3072), (3072, 256000)]
# mixtral-8x22b's expert GEMMs, (class, E, K, N): the up-GEMM (GLU, 2·d_ff
# columns in, d_ff out) and the down-GEMM
MOE_SHAPES = [("moe_gemm_silu_glu", 8, 6144, 32768), ("moe_gemm", 8, 16384, 6144)]
# rows per expert on the main path: decode (4 slots, dropless cap = tokens)
# and a 256-token prefill bucket
MOE_ROWS = (4, 256)


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def import_port(src: Path = ROOT / "src"):
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke.py: the port is not beside this script ({src}/repro_torch)")
    sys.path.insert(0, str(src))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """Median of per-launch CUDA-event times, each launch after an L2 flush."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def device_ms(self, fn, iters: int = 10, captures: int = 3) -> float:
        """Mean device time per call: the summed durations of the kernels one
        call launches, each call after an L2 flush, from a torch.profiler
        trace (the flush's own kernel left out).  Unlike :meth:`ms`, it leaves
        out the host's time to enqueue the call.  A capture now and then
        delivers no device events at all; it is taken again, up to
        ``captures`` times."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        for _ in range(captures):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            spans = [e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "FillFunctor" not in e.name and "Memset" not in e.name]
            if spans:
                return sum(spans) / iters / 1e3
        raise AssertionError(f"the profiler recorded no device time in {captures} captures")


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_close(torch, got, want, tol: dict, what: str) -> float:
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got.float() - want.float()).abs()
    lim = tol["atol"] + tol["rtol"] * want.float().abs()
    if bool((err > lim).any()):
        raise AssertionError(f"{what}: max |err| {float(err.max())} exceeds atol {tol['atol']} "
                             f"+ rtol {tol['rtol']}·|plain|")
    return float(err.max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


#: kernels whose registers and spills the build phase reports (each
#: instantiation: CTA tiles, head dims, dtypes, rounding mode)
BUILD_BODIES = ("matmul_mma_kernel", "attention_mma_kernel", "matmul_rows_kernel",
                "matmul_rows_round_kernel")


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    path = _build.build()
    _build.library()
    usage = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=time.monotonic() - t0, library=path.name, ptxas=usage)
    # registers and spills of the tensor-core bodies (per compiled CTA tile
    # or head dim) and of the rows body, per dtype
    bodies, name = {}, None
    for ln in _build.build_log.splitlines():
        for marker in ("Compiling entry function '", "Function properties for "):
            if marker in ln:
                name = ln.split(marker, 1)[1].strip().strip("'")
        if name and ("registers" in ln or "spill" in ln):
            for kernel in BUILD_BODIES:
                if kernel in name:
                    bodies.setdefault(kernel, {}).setdefault(name, []).append(ln.strip())
    for kernel in BUILD_BODIES:
        if kernel not in bodies:
            raise AssertionError(f"the build log shows no {kernel}")
        log(f"build_{kernel}", ptxas=bodies[kernel])


def _mm_inputs(torch, g, m, n, k, class_id, dtype):
    x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    w = (torch.randn((k, n), generator=g, device="cuda") / k ** 0.5).to(dtype)
    out_n = n // 2 if "glu" in class_id else n
    bias = torch.randn((n,), generator=g, device="cuda").to(dtype) if class_id in (
        "matmul_bias", "matmul_bias_gelu") else None
    residual = torch.randn((m, out_n), generator=g, device="cuda").to(dtype) \
        if class_id == "matmul_residual" else None
    softcap = 2.0 if class_id == "matmul_lmhead_softcap" else 0.0
    return x, w, dict(bias=bias, residual=residual, softcap=softcap)


@contextlib.contextmanager
def forced_cta_tile(cta):
    """The matmul's tensor-core body on one compiled CTA tile, whatever
    ``tiled_geometry`` would choose (to time the choice against the others)."""
    from repro_torch.kernels import matmul as mm

    chosen = mm.tiled_geometry

    def forced(m, n, tile_m, tile_n, groups=1):
        return (*cta, mm.cta_count(m, n, tile_m, tile_n, *cta))

    mm.tiled_geometry = forced
    try:
        yield
    finally:
        mm.tiled_geometry = chosen


def time_cta_tiles(torch, timer, launch, want, what, iters=10) -> dict:
    """Each compiled CTA tile of the tensor-core body: checked against the
    plain version, then timed; {"MxN": ms}."""
    from repro_torch.kernels import matmul as mm

    out = {}
    for cta in mm.MMA_CTA_TILES:
        with forced_cta_tile(cta):
            assert_close(torch, launch(), want, BF16_TOL, f"{what} on {cta} CTA tiles")
            out["x".join(map(str, cta))] = timer.ms(launch, iters=iters)
    return out


#: rounding mode (``cache_write=False``), per kernel: (class, body, E,
#: rows per expert, K, N, M tile, K tiles).  Each bf16 body at K tiles of 16
#: and 128, and 24, not a multiple of 16 (an MMA step that a tile boundary
#: crosses is split): K1 at minitron's q/o projection, K1g at 8 experts of
#: 3072x1024; and the launch the registry-served path makes in rounding
#: mode, recurrentgemma-2b's decode LM head at its default K tile of 256
ROUND_CASES = {
    "matmul": (("matmul", "rows", None, 4, 3072, 3072, 4, (16, 128, 24)),
               ("matmul", "mma", None, 256, 3072, 3072, 128, (16, 128, 24)),
               ("matmul_lmhead", "rows", None, 4, 2560, 256000, 4, (256,))),
    "moe_gemm": (("moe_gemm", "rows", 8, 4, 3072, 1024, 4, (16, 128, 24)),
                 ("moe_gemm", "mma", 8, 256, 3072, 1024, 128, (16, 128, 24)))}
#: the served path's rounding-mode launch among ROUND_CASES (class, M, K, N, K tile)
ROUND_SERVED = ("matmul_lmhead", 4, 2560, 256000, 256)
#: ulps are counted where |plain| is at least this (outputs are of order
#: one; near zero a sign flip spans thousands of bf16 values for a tiny |err|)
ULP_FLOOR = 2 ** -4


def bf16_ulps(torch, a, b):
    """Per element, how many bf16 values lie between bf16 tensors a and b."""
    def ordinal(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordinal(a) - ordinal(b)).abs()


def rounding_cases(torch, timer, family: str) -> list:
    """The kernel in rounding mode on each bf16 body: against the plain
    version with the same ``round_k`` (bf16 tolerance; the share of
    elements that differ and the largest distance in bf16 values), the
    plain version's own distance from f32 sums (what the rounding changes),
    and its time beside the same tiles with f32 sums (``scratch_ms``)."""
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for class_id, body, e, m, k, n, tile_m, k_tiles in ROUND_CASES[family]:
        kernel = "matmul" if e is None else "grouped_matmul"
        if e is None:
            x, w, _ = _mm_inputs(torch, g, m, n, k, class_id, torch.bfloat16)
            inst = ops.instance(class_id, torch.bfloat16, M=m, N=n, K=k)
        else:
            x, w = _grouped_inputs(torch, g, e, m, n, k, torch.bfloat16)
            inst = ops.instance(class_id, torch.bfloat16, M=m * e, N=n, K=k, E=e)
        for tile_k in k_tiles:
            tiles = {"M": tile_m, "N": 512, "K": tile_k, **({} if e is None else {"E": 1})}
            cs = concretize(Schedule.make(class_id, tiles, cache_write=False), inst)
            scratch = concretize(Schedule.make(class_id, tiles), inst)
            if mm.round_k_for(cs) != tile_k or mm.round_k_for(scratch) != 0:
                raise AssertionError(f"{class_id} {tiles}: round_k {mm.round_k_for(cs)}")
            if mm.launch_geometry(torch.bfloat16, m, n, k, tile_m, 512, e or 1, tile_k)[0] != body:
                raise AssertionError(f"{class_id} {tiles}: not the {body} body")

            def launch(c, cid=class_id):
                return (mm.launch(x, w, c, class_id=cid) if e is None
                        else mm.grouped_launch(x, w, c, class_id=cid))

            def plain(rk=tile_k, cid=class_id):
                return (ref.matmul(x, w, cid, round_k=rk) if e is None
                        else ref.grouped_matmul(x, w, cid, round_k=rk))
            name = f"{class_id} rounding {body} M{m} K{k} tile {tile_k}"
            before = mm.round_launches[kernel, body]
            got, want, f32 = launch(cs), plain(), plain(0)
            if mm.round_launches[kernel, body] != before + 1:
                raise AssertionError(f"{name}: no rounding-mode launch of the {body} body")
            err = assert_close(torch, got, want, BF16_TOL, name)
            ulps = bf16_ulps(torch, got, want)[want.float().abs() >= ULP_FLOOR]
            b_ms, b_by = bound_ms(2 * (e or 1) * (m * k + k * n + m * n), 2 * (e or 1) * m * n * k)
            row = {"class": class_id, "E": e, "M": m, "K": k, "N": n, "tiles": cs.t, "body": body,
                   "round_k": tile_k, "max_abs_err": err,
                   "differ_share": float((got != want).float().mean()),
                   "max_ulps": int(ulps.max()) if ulps.numel() else 0,
                   "plain_vs_f32_differ_share": float((want != f32).float().mean()),
                   "plain_vs_f32_max_abs": max_err(torch, want, f32),
                   "ms": timer.ms(lambda: launch(cs)),
                   "scratch_ms": timer.ms(lambda: launch(scratch)),
                   "plain_ms": timer.ms(plain, iters=3, warmup=1),
                   "bound_ms": b_ms, "bound_by": b_by,
                   # no one library call rounds partial sums per K tile
                   "library_ms": None}
            row["round_over_scratch"] = row["ms"] / row["scratch_ms"]
            rows.append(row)
            log("matmul_rounding", **row)
            del got, want, f32
        del x, w
    torch.cuda.empty_cache()
    return rows


def phase_matmul(torch, timer) -> dict:
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    # every epilogue class, ragged shapes (rows body: M tile <= 16; tiled: above;
    # N not a multiple of 8, or an N tile of 500, takes the scalar-load path),
    # bf16 and f32
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for class_id in ref.MATMUL_CLASSES:
            for m, n, k in ((5, 40, 24), (3, 50, 17), (4, 1000, 64), (70, 200, 33), (130, 96, 300)):
                x, w, kw = _mm_inputs(torch, g, m, n, k, class_id, dtype)
                cs = ops.schedule_for(ops.instance(class_id, dtype, M=m, N=n, K=k))
                got = mm.launch(x, w, cs, class_id=class_id, **kw)
                want = ref.matmul(x, w, class_id, **kw)
                name = f"{class_id}/{ops.dtype_name(dtype)}/{m}x{n}x{k}"
                errs[name] = assert_close(torch, got, want, tol, name)
        # a non-default schedule: N-outer rasterisation, ragged M and N tiles
        inst = ops.instance("matmul_silu_glu", dtype, M=37, N=100, K=64)
        cs = concretize(Schedule.make("matmul_silu_glu", {"M": 16, "N": 48, "K": 32},
                                      order=("N", "M", "K")), inst)
        x, w, kw = _mm_inputs(torch, g, 37, 100, 64, "matmul_silu_glu", dtype)
        errs[f"custom_schedule/{ops.dtype_name(dtype)}"] = assert_close(
            torch, mm.launch(x, w, cs, class_id="matmul_silu_glu", **kw),
            ref.matmul(x, w, "matmul_silu_glu", **kw), tol, "custom schedule")
    log("matmul_classes", checks=len(errs), max_abs_err=max(errs.values()), tol=BF16_TOL,
        f32_tol=F32_TOL)

    # main-path shapes: M = slots (decode) and a prefill bucket, bf16
    shapes = []
    for m in (4, 256):
        for k, n in MAIN_KN:
            class_id = ("matmul_lmhead" if n == 256000 else
                        "matmul_bias_gelu" if n == 9216 else "matmul")
            x, w, kw = _mm_inputs(torch, g, m, n, k, class_id, torch.bfloat16)
            cs = ops.schedule_for(ops.instance(class_id, torch.bfloat16, M=m, N=n, K=k))
            got = mm.launch(x, w, cs, class_id=class_id, **kw)
            want = ref.matmul(x, w, class_id, **kw)
            err = assert_close(torch, got, want, BF16_TOL, f"{class_id} {m}x{k}x{n}")
            body = mm.launch_geometry(x.dtype, m, n, k, cs.t["M"], cs.t["N"])[0]
            if body == "rows":   # a row's bits do not depend on M (nor on the run)
                cs1 = ops.schedule_for(ops.instance(class_id, torch.bfloat16, M=1, N=n, K=k))
                one = mm.launch(x[:1].contiguous(), w, cs1, class_id=class_id, **kw)
                again = mm.launch(x, w, cs, class_id=class_id, **kw)
                torch.cuda.synchronize()
                if not (torch.equal(one, got[:1]) and torch.equal(again, got)):
                    raise AssertionError(f"{class_id} {m}x{k}x{n}: rows-body bits depend on M or the run")
                del one, again
            cta_ms = (time_cta_tiles(torch, timer, lambda: mm.launch(x, w, cs, class_id=class_id, **kw),
                                     want, f"{class_id} {m}x{k}x{n}") if body == "mma" else None)
            del got, want
            # the same kernel under 64x64 output tiles, sized to fill the card's SMs
            cs64 = concretize(Schedule.make(class_id, {"M": 64, "N": 64, "K": cs.t["K"]}), cs.instance)
            err = max(err, assert_close(torch, mm.launch(x, w, cs64, class_id=class_id, **kw),
                                        ref.matmul(x, w, class_id, **kw), BF16_TOL, "64x64 tiles"))
            b_ms, b_by = bound_ms(2 * (m * k + k * n + m * n), 2 * m * n * k)
            body, cta_m, cta_n, split_k, ctas = mm.launch_geometry(x.dtype, m, n, k, cs.t["M"],
                                                                   cs.t["N"])
            row = {"class": class_id, "M": m, "K": k, "N": n, "tiles": cs.t,
                   "logical_tiles": cs.g["M"] * cs.g["N"], "body": body,
                   "cta_tile": [cta_m, cta_n], "split_k": split_k, "ctas": ctas, "max_abs_err": err,
                   "ms": timer.ms(lambda: mm.launch(x, w, cs, class_id=class_id, **kw)),
                   "cta_tile_ms": cta_ms,
                   "tile64_ctas": mm.launch_geometry(x.dtype, m, n, k, cs64.t["M"], cs64.t["N"])[4],
                   "tile64_ms": timer.ms(lambda: mm.launch(x, w, cs64, class_id=class_id, **kw)),
                   "plain_ms": timer.ms(lambda: ref.matmul(x, w, class_id, **kw)),
                   # one library call computes the same function only without an epilogue
                   "library_ms": (timer.ms(lambda: torch.matmul(x, w))
                                  if class_id != "matmul_bias_gelu" else None),
                   "bound_ms": b_ms, "bound_by": b_by}
            row["library_ratio"] = row["ms"] / row["library_ms"] if row["library_ms"] else None
            if body == "rows":   # decode: the host's time to enqueue a call is most of ms
                row["device_ms"] = timer.device_ms(lambda: mm.launch(x, w, cs, class_id=class_id, **kw))
                row["library_device_ms"] = (timer.device_ms(lambda: torch.matmul(x, w))
                                            if row["library_ms"] else None)
                row["device_ratio"] = (row["device_ms"] / row["library_device_ms"]
                                       if row["library_device_ms"] else None)
            shapes.append(row)
            log("matmul_shape", **row)
            del x, w
    torch.cuda.empty_cache()
    rounding = rounding_cases(torch, timer, "matmul")
    return {"shapes": shapes, "rounding": rounding,
            "max_abs_err": max([errs[n] for n in errs] + [r["max_abs_err"] for r in shapes])}


def _attn_inputs(torch, g, b, hq, hkv, sq, skv, d, dtype):
    return tuple(torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


def phase_attention(torch, timer) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(2)
    errs = {}
    # (b, hkv, group, sq, skv, d, causal, window, softcap, q_offset)
    cases = [
        (2, 2, 1, 64, 64, 128, True, 0, 0.0, 0),
        (2, 2, 3, 100, 100, 128, True, 0, 0.0, 0),      # GQA 3, ragged
        (1, 2, 3, 77, 77, 128, False, 0, 0.0, 0),       # bidirectional
        (1, 2, 1, 90, 90, 128, True, 16, 0.0, 0),       # sliding window
        (1, 2, 3, 64, 64, 128, True, 0, 20.0, 0),       # softcap
        (1, 2, 1, 33, 200, 128, True, 0, 0.0, 167),     # q_offset (chunk vs cache)
        (1, 2, 3, 1, 300, 128, True, 0, 0.0, 299),      # decode-shaped
        (1, 2, 3, 45, 130, 128, True, 24, 30.0, 85),    # all masks together
        (1, 2, 2, 70, 70, 256, True, 0, 50.0, 0),       # gemma2 head dim
        (1, 2, 1, 40, 40, 256, True, 8, 0.0, 0),
        (1, 2, 2, 50, 50, 16, True, 0, 0.0, 0),         # reduced-config head dim
        (1, 1, 3, 37, 60, 80, True, 8, 0.0, 10),        # head dim padded to 128
    ]
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for b, hkv, group, sq, skv, d, causal, window, softcap, q_offset in cases:
            q, k, v = _attn_inputs(torch, g, b, hkv * group, hkv, sq, skv, d, dtype)
            kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
            cs = ops.schedule_for(ops.instance("flash_attention_causal", dtype, Q=sq, KV=skv,
                                               H=hkv * group, D=d, B=b, window=window))
            body = fa.body_for(dtype)
            before = fa.body_count(body, dtype=dtype)
            got = fa.launch(q, k, v, cs, **kw)
            if fa.body_count(body, dtype=dtype) != before + 1:
                raise AssertionError(f"attention {dtype}: the launch did not take the {body} body")
            want = ref.chunked_attention(q, k, v, chunk=cs.t["KV"], **kw)
            name = f"{ops.dtype_name(dtype)}/g{group}/{sq}x{skv}/d{d}/{kw}"
            errs[name] = assert_close(torch, got, want, tol, name)
    log("attention_masks", checks=len(errs), max_abs_err=max(errs.values()), tol=BF16_TOL,
        f32_tol=F32_TOL, bodies={f"{b}/{ops.dtype_name(d)}": c
                                 for (b, d), c in sorted(fa.body_launches.items(), key=str)})

    # a prompt attended in one call and in two calls split by q_offset: the
    # same bits row for row, in both bodies
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _attn_inputs(torch, g, 1, 24, 8, 512, 512, 128, dtype)
        whole = ops.flash_attention(q, k, v)
        first = ops.flash_attention(q[:, :, :200].contiguous(), k[:, :, :200].contiguous(),
                                    v[:, :, :200].contiguous())
        second = ops.flash_attention(q[:, :, 200:].contiguous(), k, v, q_offset=200)
        torch.cuda.synchronize()
        if not torch.equal(torch.cat([first, second], dim=2), whole):
            raise AssertionError(f"attention {dtype}: rows differ when the prompt is split by q_offset")
    log("attention_q_offset_split", bit_equal=True, split=[200, 312])

    # each served arch's prefill shape (bf16, the tensor-core body): minitron
    # at buckets 128 and 512, mixtral at bucket 512 (window 4096 > S), and
    # recurrentgemma at the engine's longest prompt (356: 89-row Q tiles) and
    # its prime one (181: 1-row Q tiles), window 2048 > S
    shapes = []
    for arch, b, hq, hkv, s, d, window in (("minitron-4b", 1, 24, 8, 128, 128, 0),
                                            ("minitron-4b", 1, 24, 8, 512, 128, 0),
                                            ("mixtral-8x22b", 1, 48, 8, 512, 128, 4096),
                                            ("recurrentgemma-2b", 1, 10, 1, 356, 256, 2048),
                                            ("recurrentgemma-2b", 1, 10, 1, 181, 256, 2048)):
        q, k, v = _attn_inputs(torch, g, b, hq, hkv, s, s, d, torch.bfloat16)
        cs = ops.schedule_for(ops.instance("flash_attention_causal", torch.bfloat16, Q=s, KV=s,
                                           H=hq, D=d, B=b, window=window))
        got = fa.launch(q, k, v, cs, window=window)
        want = ref.chunked_attention(q, k, v, chunk=cs.t["KV"], window=window)
        err = assert_close(torch, got, want, BF16_TOL, f"attention {arch} S={s}")
        # the yardstick takes GQA expanded to Hq heads (expansion outside the
        # timing); S < window, so the causal mask alone is the same function
        ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
        live = s * (s + 1) / 2            # causal (q, k) pairs this input needs
        flops = 4 * b * hq * live * d
        nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
        b_ms, b_by = bound_ms(nbytes, flops)
        body, cta_q, ctas = fa.attention_geometry(torch.bfloat16, s, cs.t["Q"])
        row = {"arch": arch, "B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "window": window,
               "tiles": cs.t, "body": body, "cta_q": cta_q, "ctas": b * hq * ctas,
               "max_abs_err": err,
               "ms": timer.ms(lambda: fa.launch(q, k, v, cs, window=window), iters=20),
               "plain_ms": timer.ms(lambda: ref.chunked_attention(q, k, v, chunk=cs.t["KV"],
                                                                  window=window)),
               "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                   q, ke, ve, is_causal=True), iters=20),
               "bound_ms": b_ms, "bound_by": b_by}
        row["library_ratio"] = row["ms"] / row["library_ms"]
        row["device_ms"] = timer.device_ms(lambda: fa.launch(q, k, v, cs, window=window))
        row["library_device_ms"] = timer.device_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True))
        row["device_ratio"] = row["device_ms"] / row["library_device_ms"]
        # the f32 body at the same shape, for the record (not the served dtype)
        if (arch, s) == ("minitron-4b", 512):
            q32, k32, v32 = q.float(), k.float(), v.float()
            cs32 = ops.schedule_for(ops.instance("flash_attention_causal", torch.float32, Q=s, KV=s,
                                                 H=hq, D=d, B=b, window=0))
            row["fma_f32_ms"] = timer.ms(lambda: fa.launch(q32, k32, v32, cs32), iters=5)
            del q32, k32, v32
        shapes.append(row)
        log("attention_shape", **row)
        del q, k, v, ke, ve, got, want
    return {"shapes": shapes, "max_abs_err": max([errs[n] for n in errs] + [r["max_abs_err"] for r in shapes])}


def _rw_inputs(torch, g, b, h, t, d, dtype, near_one=False):
    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = (n(b, h, t, d).to(dtype) for _ in range(3))
    if near_one:   # the model's decay exp(-exp(w0 + dw)) with w0 = -6: ~0.998
        w = torch.exp(-torch.exp(-6.0 + 0.5 * n(b, h, t, d))).to(dtype)
    else:
        w = (0.05 + 0.9 * torch.sigmoid(n(b, h, t, d))).to(dtype)
    return r, k, v, w, 0.5 * n(h, d), n(b, h, d, d)


def _rg_inputs(torch, g, b, t, c, dtype):
    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    return n(b, t, c).to(dtype), torch.sigmoid(n(b, t, c)).to(dtype), n(b, c)


def _rw_cs(torch, dtype, b, h, t, d, tile_t=None):
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import ops

    inst = ops.instance("rwkv6_scan", dtype, T=t, C=h * d, D=d, B=b)
    if tile_t is None:
        return ops.schedule_for(inst)
    return concretize(Schedule.make("rwkv6_scan", {"T": tile_t, "C": h * d}, order=("C", "T")), inst)


def _rg_cs(torch, dtype, b, t, c, tile_t=None, tile_c=None):
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import ops

    inst = ops.instance("rglru_scan", dtype, T=t, C=c, B=b)
    if tile_t is None and tile_c is None:
        return ops.schedule_for(inst)
    dflt = ops.schedule_for(inst).t
    return concretize(Schedule.make("rglru_scan", {"T": tile_t or dflt["T"], "C": tile_c or dflt["C"]},
                                    order=("C", "T")), inst)


# main-path shapes, bf16: rwkv6-1.6b (B, H, T, D, T tile; None: the default
# schedule's) and recurrentgemma-2b (B, T, C): a bucket-sized prefill,
# 4-slot decode and a prime-length prefill (default T tile 1)
RW_MAIN = ((1, 32, 256, 64, None), (4, 32, 1, 64, None), (1, 32, 397, 64, None),
           (1, 32, 397, 64, 397))
RG_MAIN = ((1, 256, 2560), (4, 1, 2560), (1, 397, 2560))


def scan_bounds(kind: str, shape: tuple) -> tuple[float, str]:
    """The least time for one scan: every input and output once over HBM,
    or 7 f32 operations per state element per token on the CUDA cores."""
    if kind == "rwkv6":
        b, h, t, d = shape[:4]
        nbytes = 5 * b * h * t * d * 2 + h * d * 4 + 2 * b * h * d * d * 4
        return bound_ms(nbytes, 7 * b * h * t * d * d, F32_CUDA_CORE_FLOPS)
    b, t, c = shape
    return bound_ms(3 * b * t * c * 2 + 2 * b * c * 4, 7 * b * t * c, F32_CUDA_CORE_FLOPS)


def time_scans(torch, timer, plain: bool = True) -> list:
    """The scan kernels of the ``repro_torch`` on ``sys.path`` at the main-path
    shapes: each checked against its plain version, then timed by events
    and on the device (and the plain version by events, if ``plain``).
    Takes only the wrappers' ``launch``, so it times an older tree's
    kernels alike."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    cases = [("rwkv6", s, _rw_inputs(torch, g, *s[:4], torch.bfloat16, near_one=True),
              _rw_cs(torch, torch.bfloat16, *s), rw.launch, ref.rwkv6_scan) for s in RW_MAIN]
    cases += [("rglru", s, _rg_inputs(torch, g, *s, torch.bfloat16), _rg_cs(torch, torch.bfloat16, *s),
               rg.launch, ref.rglru_scan) for s in RG_MAIN]
    for kind, shape, x, cs, kernel, ref_fn in cases:
        y, s = kernel(*x, cs)
        yr, sr = ref_fn(*x)
        err = max(assert_close(torch, y, yr, BF16_TOL, f"{kind} main shape"),
                  assert_close(torch, s, sr, STATE_TOL, f"{kind} main shape state"))
        b_ms, b_by = scan_bounds(kind, shape)
        dims = ("B", "H", "T", "D") if kind == "rwkv6" else ("B", "T", "C")
        row = {"kind": kind, **dict(zip(dims, shape)), "tiles": cs.t, "max_abs_err": err,
               "ms": timer.ms(lambda: kernel(*x, cs)),
               "device_ms": timer.device_ms(lambda: kernel(*x, cs)),
               "plain_ms": timer.ms(lambda: ref_fn(*x), iters=5) if plain else None,
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
    return rows


def phase_scans(torch, timer) -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    g = torch.Generator(device="cuda").manual_seed(3)
    rw_cs = lambda *a, **k: _rw_cs(torch, *a, **k)
    rg_cs = lambda *a, **k: _rg_cs(torch, *a, **k)
    errs = {"rwkv6": {}, "rglru": {}}

    def check(kind, name, x, cs, tol):
        kernel, plain = (rw.launch, ref.rwkv6_scan) if kind == "rwkv6" else (rg.launch, ref.rglru_scan)
        y, s = kernel(*x, cs)
        yr, sr = plain(*x)
        errs[kind][name] = max(assert_close(torch, y, yr, tol, name),
                               assert_close(torch, s, sr, STATE_TOL, name + " state"))
        return y, s

    def same(a, b, what):
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(a, b)):
            raise AssertionError(f"{what}: y or the state is not bit-identical")

    bits = collections.Counter()   # bit-exact checks passed, by contract
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        dn = ops.dtype_name(dtype)
        # K3: decode, prime T (default T tile 1), head dims 16/64, 1 and 3 heads
        for b, h, t, d, near in ((2, 1, 1, 16, False), (4, 3, 1, 64, True),
                                 (1, 3, 97, 64, False), (2, 1, 97, 16, True),
                                 (1, 3, 256, 16, True), (2, 2, 50, 32, False)):
            check("rwkv6", f"rwkv6/{dn}/{b}x{h}x{t}x{d}",
                  _rw_inputs(torch, g, b, h, t, d, dtype, near), rw_cs(dtype, b, h, t, d), tol)
        b, h, t, d = 1, 3, 256, 64
        x = _rw_inputs(torch, g, b, h, t, d, dtype)
        full = check("rwkv6", f"rwkv6/{dn}/T{t}/default", x, rw_cs(dtype, b, h, t, d), tol)
        same(rw.launch(*x, rw_cs(dtype, b, h, t, d)), full, f"rwkv6 {dn} second run")
        bits["rwkv6 runs"] += 1
        for ct in (1, 2, 8, 64, t):
            same(check("rwkv6", f"rwkv6/{dn}/T{t}/tile{ct}", x, rw_cs(dtype, b, h, t, d, ct), tol),
                 full, f"rwkv6 {dn} T tile {ct}")
            bits["rwkv6 T tiles"] += 1
        t1 = 100   # continuation: [0:t1], then [t1:T] from the returned state
        r, k, v, w, u, s0 = x
        part = [z[:, :, :t1].contiguous() for z in (r, k, v, w)]
        rest = [z[:, :, t1:].contiguous() for z in (r, k, v, w)]
        ya, sa = check("rwkv6", f"rwkv6/{dn}/cont1", (*part, u, s0), rw_cs(dtype, b, h, t1, d), tol)
        yb, sb = check("rwkv6", f"rwkv6/{dn}/cont2", (*rest, u, sa), rw_cs(dtype, b, h, t - t1, d), tol)
        same((torch.cat([ya, yb], dim=2), sb), full, f"rwkv6 {dn} state continuation")
        bits["rwkv6 continuation"] += 1
        # a batch row's bits do not depend on B: row 2 of B = 4 against B = 1
        for t in (1, 97):
            r, k, v, w, u, s0 = x4 = _rw_inputs(torch, g, 4, 2, t, 64, dtype, True)
            y4, s4 = check("rwkv6", f"rwkv6/{dn}/B4xT{t}", x4, rw_cs(dtype, 4, 2, t, 64), tol)
            one = [z[2:3].contiguous() for z in (r, k, v, w)]
            same(rw.launch(*one, u, s0[2:3].contiguous(), rw_cs(dtype, 1, 2, t, 64)),
                 (y4[2:3], s4[2:3]), f"rwkv6 {dn} T={t} row at B = 1 and B = 4")
            bits["rwkv6 B=1 vs B=4"] += 1

        # K4: decode, prime T, full width under the default C tile, a C tile
        # above 1024 channels, a ragged C under a tile of 8
        for b, t, c, tile_c in ((2, 1, 2560, None), (4, 1, 2560, None), (1, 97, 2560, None),
                                (1, 64, 2560, 2560), (2, 33, 12, None), (2, 33, 12, 8),
                                (1, 40, 100, None)):
            check("rglru", f"rglru/{dn}/{b}x{t}x{c}/c{tile_c}", _rg_inputs(torch, g, b, t, c, dtype),
                  rg_cs(dtype, b, t, c, tile_c=tile_c), tol)
        b, t, c = 1, 256, 2560
        x = _rg_inputs(torch, g, b, t, c, dtype)
        full = check("rglru", f"rglru/{dn}/T{t}/default", x, rg_cs(dtype, b, t, c), tol)
        same(rg.launch(*x, rg_cs(dtype, b, t, c)), full, f"rglru {dn} second run")
        bits["rglru runs"] += 1
        for ct in (1, 2, 8, 64, t):
            same(check("rglru", f"rglru/{dn}/T{t}/tile{ct}", x, rg_cs(dtype, b, t, c, tile_t=ct), tol),
                 full, f"rglru {dn} T tile {ct}")
            bits["rglru T tiles"] += 1
        for cc in (8, 512, c):
            same(check("rglru", f"rglru/{dn}/T{t}/ctile{cc}", x, rg_cs(dtype, b, t, c, tile_c=cc), tol),
                 full, f"rglru {dn} C tile {cc}")
            bits["rglru C tiles"] += 1
        xs, a, h0 = x
        ya, ha = check("rglru", f"rglru/{dn}/cont1", (xs[:, :t1].contiguous(), a[:, :t1].contiguous(), h0),
                       rg_cs(dtype, b, t1, c), tol)
        yb, hb = check("rglru", f"rglru/{dn}/cont2", (xs[:, t1:].contiguous(), a[:, t1:].contiguous(), ha),
                       rg_cs(dtype, b, t - t1, c), tol)
        same((torch.cat([ya, yb], dim=1), hb), full, f"rglru {dn} state continuation")
        bits["rglru continuation"] += 1
        for t in (1, 97):
            xs, a, h0 = x4 = _rg_inputs(torch, g, 4, t, c, dtype)
            y4, h4 = check("rglru", f"rglru/{dn}/B4xT{t}", x4, rg_cs(dtype, 4, t, c), tol)
            same(rg.launch(*(z[2:3].contiguous() for z in x4), rg_cs(dtype, 1, t, c)),
                 (y4[2:3], h4[2:3]), f"rglru {dn} T={t} row at B = 1 and B = 4")
            bits["rglru B=1 vs B=4"] += 1
    for kind in errs:
        log(f"{kind}_checks", checks=len(errs[kind]), max_abs_err=max(errs[kind].values()),
            tol=BF16_TOL, f32_tol=F32_TOL, state_tol=STATE_TOL,
            bit_exact={k: n for k, n in bits.items() if k.startswith(kind)})

    out = {"rwkv6": [], "rglru": []}
    for row in time_scans(torch, timer):
        kind = row.pop("kind")
        if kind == "rwkv6":
            geo = rw.scan_geometry(row["B"], row["H"], row["T"], row["D"], row["tiles"]["T"])
            row.update(cta_cols=geo[0], key_split=geo[1], stage_t=geo[2], ctas=geo[3])
        else:
            geo = rg.scan_geometry(row["B"], row["T"], row["C"], row["tiles"]["T"], row["tiles"]["C"])
            row.update(cta_c=geo[0], stage_t=geo[1], ctas=geo[2])
        out[kind].append(row)
        log(f"{kind}_shape", **row)
    for kind in out:
        out[kind] = {"shapes": out[kind],
                     "max_abs_err": max([*errs[kind].values(), *(r["max_abs_err"] for r in out[kind])])}
    return out


def scans_ab(parent: Path) -> int:
    """The scan kernels of the tree at ``parent`` (say, an unpacked parent
    commit) and of this tree, timed at the main-path shapes in turns —
    parent, this, this, parent — each turn in its own process with that
    tree's ``src`` first on the path.  Prints each turn's rows, then per
    shape the mean device and event times and their ratios (parent / this)."""
    turns = [("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)]
    got = collections.defaultdict(list)
    for who, tree in turns:
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--time-scans",
                              str(tree / "src")], capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-4000:])
            raise AssertionError(f"timing the scans of {tree} failed ({out.returncode})")
        for line in out.stdout.splitlines():
            row = json.loads(line)
            log("scan_turn", who=who, **row)
            got[(row["kind"], str(row["B"]), str(row["T"]), str(row["tiles"]["T"]), who)].append(row)
    for key in sorted({k[:4] for k in got}):
        mean = {who: {m: statistics.mean(r[m] for r in got[(*key, who)]) for m in ("ms", "device_ms")}
                for who in ("parent", "this")}
        log("scan_ab", kind=key[0], B=int(key[1]), T=int(key[2]), tile_t=int(key[3]),
            parent_device_ms=mean["parent"]["device_ms"], device_ms=mean["this"]["device_ms"],
            device_ratio=mean["parent"]["device_ms"] / mean["this"]["device_ms"],
            parent_ms=mean["parent"]["ms"], ms=mean["this"]["ms"],
            ratio=mean["parent"]["ms"] / mean["this"]["ms"])
    print(nvidia_smi())
    return 0


def phase_prime_matmul(torch, timer) -> list:
    """The matmul kernel at an unbucketed prime prefill length (M tile 1
    under the default schedule), beside 64x64 output tiles."""
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for m, k, n, class_id in ((397, 2048, 2048, "matmul"), (397, 2560, 15360, "matmul_gelu_glu")):
        x, w, kw = _mm_inputs(torch, g, m, n, k, class_id, torch.bfloat16)
        cs = ops.schedule_for(ops.instance(class_id, torch.bfloat16, M=m, N=n, K=k))
        cs64 = concretize(Schedule.make(class_id, {"M": 64, "N": 64, "K": cs.t["K"]}), cs.instance)
        want = ref.matmul(x, w, class_id, **kw)
        err = max(assert_close(torch, mm.launch(x, w, cs, class_id=class_id, **kw), want, BF16_TOL,
                               f"{class_id} M={m}"),
                  assert_close(torch, mm.launch(x, w, cs64, class_id=class_id, **kw), want, BF16_TOL,
                               f"{class_id} M={m} 64x64"))
        b_ms, b_by = bound_ms(2 * (m * k + k * n + m * (n // 2 if "glu" in class_id else n)),
                              2 * m * n * k)
        body, _, cta_n, split_k, ctas = mm.launch_geometry(x.dtype, m, n, k, cs.t["M"], cs.t["N"])
        row = {"class": class_id, "M": m, "K": k, "N": n, "tiles": cs.t, "body": body,
               "cta_n": cta_n, "split_k": split_k, "ctas": ctas, "max_abs_err": err,
               "ms": timer.ms(lambda: mm.launch(x, w, cs, class_id=class_id, **kw), iters=5),
               "tile64_ctas": mm.launch_geometry(x.dtype, m, n, k, 64, 64)[4],
               "tile64_ms": timer.ms(lambda: mm.launch(x, w, cs64, class_id=class_id, **kw), iters=5),
               "plain_ms": timer.ms(lambda: ref.matmul(x, w, class_id, **kw), iters=5),
               # one library call computes the same function only without an epilogue
               "library_ms": (timer.ms(lambda: torch.matmul(x, w), iters=5)
                              if class_id == "matmul" else None),
               "bound_ms": b_ms, "bound_by": b_by}
        # the same-call yardstick: the rows body's time over the tensor-core body's
        row["tile64_ratio"] = row["ms"] / row["tile64_ms"]
        row["device_ms"] = timer.device_ms(lambda: mm.launch(x, w, cs, class_id=class_id, **kw), iters=5)
        row["tile64_device_ms"] = timer.device_ms(lambda: mm.launch(x, w, cs64, class_id=class_id, **kw),
                                                  iters=5)
        rows.append(row)
        log("matmul_prime_shape", **row)
        del x, w, want
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def f64_accumulation():
    """The plain matmul accumulating in f64 instead of f32: an equally
    valid plain version that rounds to bf16 in the same places."""
    import torch

    from repro_torch.kernels import ref

    plain = ref.matmul

    def matmul64(x, w, class_id="matmul", round_k=0, **kw):
        # the plain path (backend "ref") never rounds partial sums
        if round_k:
            raise ValueError("the f64 control takes no rounding K tile")
        y = torch.matmul(x.double(), w.double()).float()
        return ref.apply_epilogue(y, class_id, **kw).to(x.dtype)

    ref.matmul = matmul64
    try:
        yield
    finally:
        ref.matmul = plain


def _grouped_inputs(torch, g, e, m, n, k, dtype):
    x = torch.randn((e, m, k), generator=g, device="cuda").to(dtype)
    w = torch.empty((e, k, n), dtype=dtype, device="cuda")
    for i in range(e):   # one expert at a time: mixtral's f32 stack would take 6.4 GB
        w[i] = torch.randn((k, n), generator=g, device="cuda") / k ** 0.5
    return x, w


def phase_grouped(torch, timer) -> dict:
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(5)

    def cs_for(class_id, dtype, e, m, n, k, tiles=None):
        inst = ops.instance(class_id, dtype, M=m * e, N=n, K=k, E=e)
        if tiles is None:
            return ops.schedule_for(inst)
        return concretize(Schedule.make(class_id, {**tiles, "K": k, "E": 1},
                                        order=("N", "M", "E", "K")), inst)

    errs = {}
    # (E, rows per expert, N, K, tiles): E = 1/3/8; decode-shaped 4 rows; a
    # ragged 300 rows under the default tile of 120 (M = 2400) and 13 under a
    # rows-body tile of 8; N not a multiple of 8 (scalar loads); N-outer
    # schedules with ragged M and N tiles in both bodies
    cases = [(1, 5, 40, 24, None), (1, 70, 96, 33, None), (3, 37, 100, 64, None),
             (8, 4, 96, 48, None), (8, 300, 64, 32, None), (3, 13, 64, 40, {"M": 8, "N": 64}),
             (3, 4, 50, 17, None), (3, 70, 50, 33, None),
             (3, 37, 100, 64, {"M": 16, "N": 48}), (3, 100, 100, 64, {"M": 64, "N": 48})]
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for class_id in ref.GROUPED_CLASSES:
            for e, m, n, k, tiles in cases:
                x, w = _grouped_inputs(torch, g, e, m, n, k, dtype)
                cs = cs_for(class_id, dtype, e, m, n, k, tiles)
                name = f"{class_id}/{ops.dtype_name(dtype)}/{e}x{m}x{n}x{k}/{tiles or 'default'}"
                errs[name] = assert_close(torch, mm.grouped_launch(x, w, cs, class_id=class_id),
                                          ref.grouped_matmul(x, w, class_id), tol, name)
    log("grouped_checks", checks=len(errs), max_abs_err=max(errs.values()), tol=BF16_TOL,
        f32_tol=F32_TOL)

    shapes = []
    for m in MOE_ROWS:
        for class_id, e, k, n in MOE_SHAPES:
            x, w = _grouped_inputs(torch, g, e, m, n, k, torch.bfloat16)
            cs = cs_for(class_id, torch.bfloat16, e, m, n, k)
            want = ref.grouped_matmul(x, w, class_id)
            err = assert_close(torch, mm.grouped_launch(x, w, cs, class_id=class_id), want,
                               BF16_TOL, f"{class_id} {e}x{m}x{k}x{n}")
            n_out = n // 2 if class_id == "moe_gemm_silu_glu" else n
            b_ms, b_by = bound_ms(2 * e * (m * k + k * n + m * n_out), 2 * e * m * n * k)
            *_, tile_m, tile_n = mm.grouped_geometry(x, w, cs, class_id)
            body, cta_m, cta_n, split_k, ctas = mm.launch_geometry(x.dtype, m, n, k, tile_m, tile_n, e)
            iters = 10 if m <= 16 else 5
            cta_ms = (time_cta_tiles(torch, timer, lambda: mm.grouped_launch(x, w, cs, class_id=class_id),
                                     want, f"{class_id} {e}x{m}x{k}x{n}", iters) if body == "mma" else None)
            del want
            row = {"class": class_id, "E": e, "M": m, "K": k, "N": n,
                   "tiles": {"M": tile_m, "N": tile_n},
                   "logical_tiles": e * -(-m // tile_m) * -(-n // tile_n), "body": body,
                   "cta_tile": [cta_m, cta_n], "split_k": split_k, "ctas": e * ctas,
                   "max_abs_err": err,
                   "cta_tile_ms": cta_ms,
                   "ms": timer.ms(lambda: mm.grouped_launch(x, w, cs, class_id=class_id), iters=iters),
                   "plain_ms": timer.ms(lambda: ref.grouped_matmul(x, w, class_id), iters=iters),
                   # one library call computes the same function only without the GLU
                   "library_ms": (timer.ms(lambda: torch.bmm(x, w), iters=iters)
                                  if class_id == "moe_gemm" else None),
                   "bound_ms": b_ms, "bound_by": b_by}
            row["library_ratio"] = row["ms"] / row["library_ms"] if row["library_ms"] else None
            row["device_ms"] = timer.device_ms(lambda: mm.grouped_launch(x, w, cs, class_id=class_id),
                                               iters=iters)
            row["library_device_ms"] = (timer.device_ms(lambda: torch.bmm(x, w), iters=iters)
                                        if row["library_ms"] else None)
            row["device_ratio"] = (row["device_ms"] / row["library_device_ms"]
                                   if row["library_device_ms"] else None)
            shapes.append(row)
            log("grouped_shape", **row)
            del x, w
            torch.cuda.empty_cache()
    rounding = rounding_cases(torch, timer, "moe_gemm")
    return {"shapes": shapes, "rounding": rounding,
            "max_abs_err": max([*errs.values(), *(r["max_abs_err"] for r in shapes)])}


#: the tuning phase's kernel lists: one 256-token prompt (minitron-4b's first
#: power-of-two prefill bucket) at each arch's full width and kernel shapes
TUNE_SHAPE = ("serve_prefill_256", 256, 1, "prefill")
#: trial budgets: each search of one kernel beyond the GEMMs, each donor's
#: full tuning, and the cap on the full tuning that must match a transfer
KERNEL_TRIALS = 32
DONOR_TRIALS = 256
MATCH_TRIALS = 1024
#: the kernels searched alone (arch, tag): K2, K3 and K4; no donor has the
#: two scan classes, so these are the searches that move the scans' schedules
KERNEL_SEARCHES = (("minitron-4b", "attn.global"), ("rwkv6-1.6b", "rwkv.scan"),
                   ("recurrentgemma-2b", "griffin.scan"))
#: (pair, donors, target, the target's prompt tokens, pick the donor by
#: Eq. 1): the main path's dense arch, the repo's MoE transfer
#: (examples/transfer_tuning_demo.py), and recurrentgemma-2b at the prime
#: 181-token prompt its engine serves unpadded (the default schedule's M
#: and Q tiles are 1 there), from the dense donors.  Donors are tuned at
#: TUNE_SHAPE, each once.
TUNE_PAIRS = (("dense", ("starcoder2-7b", "stablelm-12b"), "minitron-4b", 256, True),
              ("moe", ("dbrx-132b",), "mixtral-8x22b", 256, False),
              ("prime", ("starcoder2-7b", "stablelm-12b"), "recurrentgemma-2b", 181, True))
#: random valid schedules per searched kernel held against the plain version
RANDOM_CHECKS = 4
#: the runner's check: the prime prefill GEMM (M, N, K), whose default
#: schedule (M tile 1) must time at least this many times its 64x64 tiles
PRIME_MNK = (397, 2048, 2048)
PRIME_MIN_RATIO = 5.0
#: the runner's event time (stream held behind a sleep) beside the
#: profiler's device time: (class, params) of decode and prefill GEMMs, K2, K3
TIMER_CHECKS = (("matmul", dict(M=4, N=3072, K=3072)), ("matmul", dict(M=256, N=3072, K=3072)),
                ("flash_attention_causal", dict(Q=256, KV=256, H=24, D=128, B=1)),
                ("rwkv6_scan", dict(T=256, C=32 * 64, D=64, B=1)))


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def tuning_pair(torch, cached, runner, db, donor_runs, donor_uses, name, donors, target, tokens,
                pick) -> tuple[dict, list]:
    """Full tuning of the donors (each once per phase), the donor pick,
    transfer-tuning of the target, all measured on the card through
    ``cached``; then full tuning of the target until it matches the
    transfer (or its trial cap).

    The match run gets a runner of its own, as a separate tuning run would:
    through ``cached`` it would replay, free, every launch the donors'
    searches timed (dbrx-132b and mixtral-8x22b share two projections).  The
    transferred plan and the defaults are timed on that runner first (by
    ``seconds``, which charges no search), so its stop rule compares model
    seconds of one runner, and neither side's search pays for the defaults."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import (AnalyticalRunner, CachedRunner, select_donor, top_donors,
                                  transfer_tune, tune_model)
    from repro_torch.core.extract import extract_kernels
    from repro_torch.core.measured_runner import MeasuredRunner
    from repro_torch.core.runner import telemetry_delta

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    before = runner.telemetry()
    uses = extract_kernels(get_arch(target), ShapeConfig(f"serve_prefill_{tokens}", tokens, 1,
                                                         "prefill"))
    out = {"pair": name, "target": target, "tokens": tokens, "donors": {}}
    for d in donors:
        if d not in donor_runs:
            res = tune_model(donor_uses[d], d, total_trials=DONOR_TRIALS, runner=cached)
            # publish only records no slower than the default on this card:
            # tune_model emits its pool's best five even where none beat the
            # default, and an exact-workload hit would serve such a record as
            # it is (mixtral-8x22b takes dbrx-132b's attention projections so)
            published = [r for r in res.records if r.seconds <= cached.seconds(r.instance)]
            for r in published:
                db.add(r)
            donor_runs[d] = res, len(published)
        res, published = donor_runs[d]
        out["donors"][d] = {"trials": res.total_trials, "search_s": res.search_time_s,
                            "records": len(res.records), "published": published,
                            "wall_s": res.wall_time_s, "untuned_ms": res.untuned_seconds * 1e3,
                            "tuned_ms": res.tuned_seconds * 1e3, "speedup": res.speedup,
                            "measurements": res.runner_telemetry["measurements"],
                            "ties": res.runner_telemetry["ties"]}
    others = [m for m in db.models() if m not in donors]   # the pair's donors alone
    donor = select_donor(uses, db, exclude=others, runner=cached) if pick else donors[0]
    out["eq1"] = [(s.model_id, s.score)
                  for s in top_donors(uses, db, k=len(donors), exclude=others, runner=cached)]
    out["donor"] = donor
    tt = transfer_tune(uses, db, model_id=target, donors=[donor], runner=cached)
    # the same donor schedules under the TPU cost model: what the TPU rules reject
    tpu = transfer_tune(uses, db, model_id=target, donors=[donor],
                        runner=CachedRunner(AnalyticalRunner("tpu-v5e")), donor_target=runner.target)
    tele = telemetry_delta(runner.telemetry(), before)
    own = MeasuredRunner()
    plan = tt.schedule_map()
    own_untuned = sum(u.use_count * own.seconds(u.instance) for u in uses)
    own_transfer = sum(u.use_count * own.seconds(u.instance, plan.get(u.instance.workload_key()))
                       for u in uses)
    full = tune_model(uses, target, total_trials=MATCH_TRIALS, runner=CachedRunner(own),
                      stop_when=lambda search_s, model_s: model_s <= own_transfer)
    matched = full.tuned_seconds <= own_transfer
    out.update({
        "untuned_ms": tt.untuned_seconds * 1e3, "transfer_ms": tt.tuned_seconds * 1e3,
        "speedup": tt.speedup, "coverage": tt.coverage(),
        "transfer_search_s": tt.search_time_s, "transfer_wall_s": tt.wall_time_s,
        "transfer_measurements": tt.measurements,
        "candidates": sum(k.candidates for k in tt.kernels),
        "invalid_card": tt.invalid_transfers, "invalid_tpu_model": tpu.invalid_transfers,
        "kernels": [{"tag": u.tag, "class": u.instance.class_id, "uses": u.use_count,
                     "params": dict(u.instance.params),
                     "untuned_ms": k.untuned_seconds * 1e3, "ms": k.seconds * 1e3,
                     "chosen": k.chosen.t if k.chosen else None,
                     "order": list(k.chosen.order) if k.chosen else None,
                     "exact_hit": k.exact_hit, "candidates": k.candidates, "invalid": k.invalid,
                     "tpu_candidates": kt.candidates, "tpu_invalid": kt.invalid}
                    for u, k, kt in zip(uses, tt.kernels, tpu.kernels)],
        # the match run's own runner: the untuned and transferred models timed there
        "own_untuned_ms": own_untuned * 1e3, "own_transfer_ms": own_transfer * 1e3,
        "full_trials": full.total_trials, "full_search_s": full.search_time_s,
        "full_wall_s": full.wall_time_s, "full_ms": full.tuned_seconds * 1e3,
        "full_speedup": own_untuned / full.tuned_seconds, "matched": matched,
        # with no match, both ratios are lower bounds
        "search_ratio": (full.search_time_s / tt.search_time_s if tt.search_time_s > 0
                         else None),
        "wall_ratio": full.wall_time_s / tt.wall_time_s,
        "runner": tele, "tie_share": tele["ties"] / max(tele["requests"], 1),
        "full_runner": own.telemetry(),
        "full_tie_share": own.ties / max(own.stats.requests, 1),
        "wall_s": time.monotonic() - t0,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    if not matched:
        out["match"] = f"not matched in {full.total_trials} trials"
    for k in tt.kernels:
        if not k.seconds <= k.untuned_seconds:
            raise AssertionError(f"{target} {k.instance.class_id}: transferred {k.seconds} s "
                                 f"> untuned {k.untuned_seconds} s")
    chosen = [(k.instance, k.chosen) for k in tt.kernels if k.chosen is not None]
    for res in (*(donor_runs[d][0] for d in donors), full):
        best = {}
        for r in res.records:
            wk = r.instance.workload_key()
            if wk not in best or r.seconds < best[wk].seconds:
                best[wk] = r
        chosen += [(r.instance, r.schedule) for r in best.values()]
    del own
    log("tuning_pair", **out)
    return out, chosen


def phase_tuning(torch, timer):
    """The paper's workflow on the card at full width: the measured runner
    checked against the profiler, one search per kernel beyond the GEMMs,
    then per pair the donors' full tuning, the Eq. 1 pick, transfer-tuning
    and the full tuning needed to match it; every non-default schedule the
    searches chose (and a few random ones) held against the plain version
    (with the rounding K tile where the schedule rounds).  Returns (the
    summary, the donors' ScheduleDB: their records no slower than the
    default, under ``h100``)."""
    import random

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import (CachedRunner, KernelInstance, Schedule, ScheduleDB,
                                  default_schedule, tune_kernel)
    from repro_torch.core.autoscheduler import random_schedule
    from repro_torch.core.extract import extract_kernels
    from repro_torch.core.measured_runner import MeasuredRunner
    from repro_torch.core.schedule import ScheduleInvalid
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    t0 = time.monotonic()
    torch.cuda.empty_cache()
    for kmod in (mm, fa, rw, rg):
        kmod.reset_launches()
    runner = MeasuredRunner()
    cached = CachedRunner(runner)
    shape = ShapeConfig(*TUNE_SHAPE)
    archs = {a for a, _ in KERNEL_SEARCHES} | {a for _, d, t, _, _ in TUNE_PAIRS for a in (*d, t)}
    uses = {a: extract_kernels(get_arch(a), shape) for a in sorted(archs)}

    # 1. the runner: the prime shape's ranking, and its event times (the
    # stream held behind a sleep) beside the profiler's device times
    prime = KernelInstance.make("matmul", **dict(zip("MNK", PRIME_MNK)))
    dflt = default_schedule(prime)
    s64 = Schedule.make("matmul", {"M": 64, "N": 64, "K": dflt.t["K"]})
    check = {"shape": list(PRIME_MNK), "default_tiles": dflt.t,
             "default_ms": cached.seconds(prime, dflt) * 1e3,
             "tile64_ms": cached.seconds(prime, s64) * 1e3}
    check["ratio"] = check["default_ms"] / check["tile64_ms"]
    if check["ratio"] < PRIME_MIN_RATIO:
        raise AssertionError(f"the measured runner ranks {PRIME_MNK}'s default (tiles {dflt.t}) "
                             f"only {check['ratio']:.2f}x slower than 64x64 tiles "
                             f"({PRIME_MIN_RATIO}x asked)")
    check["timer"] = []
    for class_id, params in TIMER_CHECKS:
        inst = KernelInstance.make(class_id, **params)
        cs = runner.concrete(inst, default_schedule(inst))
        check["timer"].append({"class": inst.class_id, "params": dict(inst.params),
                               "runner_ms": runner.seconds(inst) * 1e3,
                               "device_ms": timer.device_ms(lambda: runner.run(cs))})
    log("tuning_runner_check", **check)

    # 2. one search per kernel beyond the GEMMs
    searched, chosen, drawn = [], [], []
    for arch, tag in KERNEL_SEARCHES:
        inst = next(u.instance for u in uses[arch] if u.tag == tag)
        res = tune_kernel(inst, trials=KERNEL_TRIALS, runner=cached)
        row = {"arch": arch, "tag": tag, "class": inst.class_id, "params": dict(inst.params),
               "trials": res.trials, "search_s": res.search_time_s,
               "default_ms": cached.seconds(inst) * 1e3, "best_ms": res.best_seconds * 1e3,
               "best": res.best.t, "order": list(res.best.order),
               "measurements": res.runner_telemetry["measurements"],
               "ties": res.runner_telemetry["ties"]}
        searched.append(row)
        log("tuning_kernel", **row)
        chosen.append((inst, res.best))
        rng = random.Random(0)
        while sum(i is inst for i, _ in drawn) < RANDOM_CHECKS:
            sched = random_schedule(inst, rng)
            try:
                runner.concrete(inst, sched)
            except ScheduleInvalid:
                continue
            drawn.append((inst, sched))

    # 3-4. the pairs
    db, donor_runs, pairs = ScheduleDB(), {}, []
    for name, donors, target, tokens, pick in TUNE_PAIRS:
        row, pair_chosen = tuning_pair(torch, cached, runner, db, donor_runs, uses, name, donors,
                                       target, tokens, pick)
        pairs.append(row)
        chosen += pair_chosen
    launches = {"matmul": mm.launches, "grouped_matmul": mm.grouped_launches,
                "flash_attention": fa.launches, "rwkv6_scan": rw.launches,
                "rglru_scan": rg.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched in the tuning phase: {launches}")

    # 5. every schedule the searches chose that launches otherwise than the
    # default, and the random draws (K3 launches alike under every schedule),
    # against the plain version
    done, errs = {runner.launch_key(runner.concrete(i, default_schedule(i))) for i, _ in chosen}, {}
    for inst, sched in chosen + drawn:
        cs = runner.concrete(inst, sched)
        key = runner.launch_key(cs)
        if key in done and (inst, sched) not in drawn:
            continue
        done.add(key)
        got, want = _outputs(runner.run(cs)), _outputs(runner.run(cs, plain=True))
        name = f"{inst.class_id} {dict(inst.params)} {cs.t} {key[1]}"
        errs[name] = max(assert_close(torch, g, w, BF16_TOL if i == 0 else STATE_TOL, name)
                         for i, (g, w) in enumerate(zip(got, want)))
        del got, want
    log("tuning_checks", checks=len(errs), max_abs_err=max(errs.values()),
        worst=max(errs, key=errs.get), tol=BF16_TOL, state_tol=STATE_TOL, launches=launches)
    summary = {"shape": TUNE_SHAPE, "budgets": {"kernel": KERNEL_TRIALS, "donor": DONOR_TRIALS,
                                                "match_cap": MATCH_TRIALS},
               "runner_check": check, "kernels": searched, "pairs": pairs,
               "checks": len(errs), "max_abs_err": max(errs.values()), "launches": launches,
               "runner": runner.telemetry(), "wall_s": time.monotonic() - t0}
    del runner, cached
    torch.cuda.empty_cache()
    return summary, db


def layerwise_rel_err(torch, model, params, toks) -> dict:
    """Each layer run by both paths on the plain path's input to that layer:
    per layer, |kernel - plain| / |plain| of the block output (output minus
    input), in L2.  Returns {"checked", "block", "routed_alike", "route_flips"}
    lists (the last two hold None for a layer without MoE).

    A MoE layer's block output changes by a whole expert's output for a
    token whose top-k expert set differs between the paths: a one-ulp
    difference that the attention sub-block leaves in the router's input
    swaps the k-th expert of a token whose k-th and (k+1)-th probabilities
    nearly tie.  So such a layer counts those tokens (route_flips), and its
    checked error is the largest of: the whole-block error over the tokens
    both paths route alike (routed_alike); its attention sub-block's error on
    the layer's input; its MoE sub-block's error on the plain path's
    residual stream after attention, the same on both paths.  The
    whole-block error over every token (block) is reported, not checked."""
    from repro_torch.kernels.ops import use_backend
    from repro_torch.models import lm, mlp

    def rel(got, want, base, rows=None):
        diff, ref_ = got.float() - want.float(), want.float() - base
        if rows is not None:
            diff, ref_ = diff[rows], ref_[rows]
        return float(diff.norm() / ref_.norm())

    cfg = model.cfg
    h = lm._embed(params, cfg, toks)
    b, s, _ = h.shape
    kw = dict(positions=lm._positions(b, s, h.device), pos=None, decode=False)
    out = {"checked": [], "block": [], "routed_alike": [], "route_flips": []}
    for j, kind in enumerate(cfg.layer_kinds):
        p = params["layers"][j]
        fresh = lambda: lm.init_block_cache(cfg, kind, b, 512, h.device)  # noqa: E731
        out_k, _, _ = lm.apply_block(p, cfg, kind, h, cache=fresh(), **kw)
        with use_backend("ref"):
            out_r, _, _ = lm.apply_block(p, cfg, kind, h, cache=fresh(), **kw)
        out["block"].append(rel(out_k, out_r, h.float()))
        if "moe" not in p:
            out["checked"].append(out["block"][-1])
            out["routed_alike"].append(None)
            out["route_flips"].append(None)
            h = out_r
            continue

        def experts(x):   # the sorted top-k expert set of each token, (B, S, k)
            xn = lm.ffn_input(p, cfg, x).reshape(b * s, -1)
            return mlp.moe_route(p["moe"], cfg, xn)[2].sort(-1).values.reshape(b, s, -1)

        a_k, _ = lm.apply_mixer(p, cfg, kind, h, cache=fresh(), **kw)
        e_k = experts(h + a_k)
        with use_backend("ref"):
            a_r, _ = lm.apply_mixer(p, cfg, kind, h, cache=fresh(), **kw)
            e_r = experts(h + a_r)
            y_r, _ = lm.apply_ffn(p, cfg, h + a_r)
        y_k, _ = lm.apply_ffn(p, cfg, h + a_r)
        alike = (e_k == e_r).all(-1)
        out["route_flips"].append(int((~alike).sum()))
        if not bool(alike.any()):
            raise AssertionError(f"layer {j}: the two paths route no token alike")
        out["routed_alike"].append(rel(out_k, out_r, h.float(), alike))
        out["checked"].append(max(out["routed_alike"][-1], rel(a_k, a_r, 0.0), rel(y_k, y_r, 0.0)))
        h = out_r
    return out


@contextlib.contextmanager
def traced_rows_geometry():
    """Every call of the matmul's ``rows_geometry`` (one per rows-body
    launch) while the context is open: [((m, n, k, tile_m, tile_n, groups),
    (cta_n, split_k, ctas)), ...]."""
    from repro_torch.kernels import matmul as mm

    plain, calls = mm.rows_geometry, []

    def traced(m, n, k, tile_m, tile_n, groups=1, round_k=0):
        out = plain(m, n, k, tile_m, tile_n, groups, round_k)
        calls.append(((m, n, k, tile_m, tile_n, groups), out))
        return out

    mm.rows_geometry = traced
    try:
        yield calls
    finally:
        mm.rows_geometry = plain


#: the profiler label of a schedule provider's ``get`` (profile_decode)
PROVIDER_LABEL = "ScheduleProvider.get"


def profile_decode(torch, engine, prompts, steps: int = 3, provider=None) -> dict:
    """One torch.profiler capture of ``steps`` decode steps of a busy slot
    engine: the device's busy share of the window (the union of its kernel
    intervals over the host-clock window, which ends in a sync) and its five
    ops with the most device time.  With ``provider``, each of its ``get``
    calls inside the window is a labelled range, and the host time of those
    ranges over the window is the share of a step the provider takes (the
    label's own cost included)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for p in prompts:
        engine.add_request(p, max_new_tokens=steps + 2)
    engine.step()                 # one step outside the window
    torch.cuda.synchronize()
    if provider is not None:
        real_get = provider.get

        def labelled(inst):
            with record_function(PROVIDER_LABEL):
                return real_get(inst)

        provider.get = labelled
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
    finally:
        if provider is not None:
            del provider.get      # back to the class's method
    while engine.active:
        engine.step()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:            # the union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    ops_ = []
    for avg in prof.key_averages():
        dev = getattr(avg, "self_device_time_total", None)
        if dev is None:
            dev = getattr(avg, "self_cuda_time_total", 0.0)
        if dev > 0:
            ops_.append({"name": avg.key[:120], "calls": avg.count, "device_ms": dev / 1e3})
    ops_.sort(key=lambda o: -o["device_ms"])
    out = {"steps": steps, "window_ms": wall_us / 1e3, "device_events": len(spans),
           "device_busy_ms": busy / 1e3 if spans else None,
           "device_busy_share": busy / wall_us if spans else None,
           "top_device_ops": ops_[:5]}
    if provider is not None:
        label = next((a for a in prof.key_averages() if a.key == PROVIDER_LABEL), None)
        if label is None:
            raise AssertionError("the profiler recorded no schedule provider range")
        out["provider_calls"] = label.count
        out["provider_host_ms"] = label.cpu_time_total / 1e3
        out["provider_host_share"] = label.cpu_time_total / wall_us
    return out


#: the kernels each served arch must launch
SERVE_KERNELS = {"minitron-4b": ("matmul", "flash_attention"),
                 "rwkv6-1.6b": ("matmul", "rwkv6_scan"),
                 "recurrentgemma-2b": ("matmul", "flash_attention", "rglru_scan"),
                 "mixtral-8x22b": ("matmul", "flash_attention", "grouped_matmul")}
#: archs served at full width with their depth cut, and the depth: mixtral's
#: 56 layers hold ~140 B bf16 parameters (280 GB); 8 layers hold 20.4 B
#: (40.9 GB) and leave room for the plain path's f32 and f64 copies of one
#: expert's weights in the logits check
SERVE_DEPTH = {"mixtral-8x22b": 8}


def prefill_logits_check(torch, model, params, toks, what: str, provider=None) -> dict:
    """The kernel path's prefill logits (under ``provider``'s schedules)
    against the plain path's on the same weights, within the larger of
    LOGITS_REL_BOUND of max |logit| and CONTROL_FACTOR times the f64
    control; raises beyond it."""
    from repro_torch.kernels.ops import use_backend

    logits_k, _ = model.prefill(params, {"tokens": toks}, max_len=512, provider=provider)
    with use_backend("ref"):
        logits_r, _ = model.prefill(params, {"tokens": toks}, max_len=512)
        with f64_accumulation():
            logits_c, _ = model.prefill(params, {"tokens": toks}, max_len=512)
    torch.cuda.synchronize()
    if tuple(logits_k.shape) != (1, model.cfg.vocab_size) or not bool(torch.isfinite(logits_k).all()):
        raise AssertionError(f"prefill logits: shape {tuple(logits_k.shape)} or non-finite")
    diff = max_err(torch, logits_k, logits_r)
    control = max_err(torch, logits_c, logits_r)
    scale = float(logits_r.float().abs().max())
    bound = max(LOGITS_REL_BOUND * scale, CONTROL_FACTOR * control)
    if diff > bound:
        raise AssertionError(f"{what}: prefill logits differ by {diff} > {bound} "
                             f"(max |logit| {scale}, control {control})")
    return {"logits_max_abs_diff": diff, "logits_max_abs": scale,
            "logits_control": control, "logits_bound": bound,
            "argmax_equal": int(logits_k.argmax()) == int(logits_r.argmax())}


#: the prime prompt length among the serve phases' prompts (seed 0): the
#: recurrent archs prefill it unpadded, at default M and Q tiles of 1
PRIME_PROMPT = 181


#: new tokens per request in the engine runs of the serve phases
SERVE_NEW_TOKENS = 16


def serve_prompts(cfg) -> list:
    """The serve phases' 8 prompts: 100-400 random tokens each, seed 0
    (lengths 356, 291, 253, 181, 192, 112, 122, 104)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, size=int(n))]
            for n in rng.integers(100, 401, size=8)]


def body_counts(mm) -> dict:
    """The matmul's launches per (kernel, body, dtype) so far, as text keys."""
    from repro_torch.kernels import ops

    return {f"{kernel}/{body}/{ops.dtype_name(dtype)}": count
            for (kernel, body, dtype), count in sorted(mm.body_launches.items(), key=str)}


def phase_serve(torch, arch: str) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    cfg = get_arch(arch)
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
    torch.cuda.empty_cache()

    # the user's entry point: at full width, or at the reduced size for an
    # arch whose full depth fits no one card; it counts its own launches
    preset = "smoke" if arch in SERVE_DEPTH else "full"
    res = serve.main(["--arch", arch, "--preset", preset, "--device", "cuda"])
    if res["requests"] != 8 or res["tokens"] != 8 * 8:
        raise AssertionError(f"serve.main finished {res['requests']} requests / {res['tokens']} tokens")
    if min(res["kernel_launches"][k] for k in SERVE_KERNELS[arch]) <= 0:
        raise AssertionError(f"{arch}: serve.main never launched a kernel of its path: "
                             f"{res['kernel_launches']}")

    # the main path, at full width: the slot engine with long prompts of
    # unbucketed lengths for the recurrent archs, power-of-two buckets for
    # minitron; the launch counts are set to 0 just before it, read just
    # after.  Peak memory is read twice: over weight init alone (init draws
    # each weight in f32 before the cast), then from the end of init over
    # serving (weights, caches and the passes' activations)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, "cuda")
    params = model.init(seed=0)
    init_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, params, slots=4, max_len=512)
    prompts = serve_prompts(cfg)
    for kmod in (mm, fa, rw, rg):
        kmod.reset_launches()
    with traced_rows_geometry() as rows_calls:
        run = serve_stream(torch, engine, prompts, SERVE_NEW_TOKENS)
    launches = serve.kernel_launches()
    bodies = body_counts(mm)
    prime_bodies = run["prime_bodies"]
    # an unbucketed prime prompt: every default M tile is 1, so its K1
    # launches all take the rows body
    if not engine.prefill_buckets and (prime_bodies.get("matmul/mma/bfloat16", 0)
                                       or not prime_bodies.get("matmul/rows/bfloat16", 0)):
        raise AssertionError(f"{arch}: the {PRIME_PROMPT}-token prefill's K1 bodies {prime_bodies}")
    # every bf16 prefill GEMM above 16 rows ran on the tensor cores: none
    # took the CUDA-core body, which is for f32 alone
    if mm.body_count("mma") <= 0 or mm.body_count("fma", dtype=torch.bfloat16) != 0:
        raise AssertionError(f"{arch}: launches per matmul body {bodies}")
    # every rows-body launch (decode, 1-row prefill tiles) took its layout
    # from rows_geometry: one call per launch
    if len(rows_calls) != mm.body_count("rows"):
        raise AssertionError(f"{arch}: {mm.body_count('rows')} rows-body launches, "
                             f"{len(rows_calls)} rows_geometry layouts")
    decode_geometry = collections.Counter(
        f"{n}x{k}/E{e}: split_k {split_k}, {e * ctas} CTAs"
        for (m, n, k, tile_m, tile_n, e), (_, split_k, ctas) in rows_calls if m == 4)
    if not decode_geometry:
        raise AssertionError(f"{arch}: no M = 4 decode launch took the rows body")
    # every bf16 attention launch took the tensor-core body
    attn_bodies = {f"{body}/{ops.dtype_name(dtype)}": count
                   for (body, dtype), count in sorted(fa.body_launches.items(), key=str)}
    if "flash_attention" in SERVE_KERNELS[arch] and (
            fa.body_count("mma", dtype=torch.bfloat16) != launches["flash_attention"]
            or fa.body_count("fma", dtype=torch.bfloat16) != 0):
        raise AssertionError(f"{arch}: launches per attention body {attn_bodies}")
    if min(launches[k] for k in SERVE_KERNELS[arch]) <= 0:
        raise AssertionError(f"{arch}: a kernel of the main path was never launched: {launches}")
    # where the decode step's time goes on the device: a profiler capture of
    # three minitron decode steps at 4 busy slots (after the counts are read)
    profile = (profile_decode(torch, engine, prompts[:4]) if arch == "minitron-4b" else None)
    if profile is not None:
        log("decode_profile", arch=arch, **profile)
    serve_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # kernel path vs plain path on the same weights: the first prompt's
    # prefill, end to end and layer by layer
    toks = torch.tensor([prompts[0]], dtype=torch.long, device="cuda")
    logits = prefill_logits_check(torch, model, params, toks, arch)
    layers = layerwise_rel_err(torch, model, params, toks)
    layer_err = layers["checked"]
    if max(layer_err) > LAYER_REL_BOUND:
        raise AssertionError(f"{arch}: a layer's output differs by {max(layer_err)} "
                             f"> {LAYER_REL_BOUND} (per layer: {layers})")
    row = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": cfg.param_count(),
           "serve_main": {k: res[k] for k in ("preset", "requests", "tokens", "decode_steps",
                                               "tok_per_s", "kernel_launches")},
           "requests": run["requests"], "tokens": run["tokens"],
           "prompt_lens": [len(p) for p in prompts], "decode_steps": run["steps"],
           "prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
           "prompt_prefill_s": run["prompt_prefill_s"], "prime_prefill_body_launches": prime_bodies,
           "decode_ms_per_step": run["decode_ms_per_step"],
           "tok_per_s": run["tokens"] / (run["prefill_s"] + run["decode_s"]),
           "decode_tok_per_s": (run["tokens"] - run["requests"]) / run["decode_s"],
           "launches": launches, "body_launches": bodies, "attention_body_launches": attn_bodies,
           "decode_rows_geometry": dict(decode_geometry), "decode_profile": profile,
           "init_peak_gib": init_peak_gib, "serve_peak_gib": serve_peak_gib,
           **logits,
           "layer_rel_err_max": max(layer_err), "layer_rel_err": layer_err,
           "layer_block_rel_err": layers["block"],
           "layer_routed_alike_rel_err": layers["routed_alike"],
           "layer_route_flips": layers["route_flips"]}
    log("serve", **row)
    del model, params, engine
    torch.cuda.empty_cache()
    return row


#: the arch served through a registry: K1, K2 and K4 on its path, exact
#: prompt lengths (none of its prefill instances is planned), the prime prompt
TUNED_ARCH = "recurrentgemma-2b"


class ResolutionRecorder:
    """Every schedule a provider hands out while installed: (instance, tier,
    concrete schedule, whether the active plan answered)."""

    def __init__(self, provider):
        self.provider, self.calls = provider, []
        real_get, real_resolve = provider.get, provider.pipeline.resolve
        last = {}

        def resolve(inst, mode=None):
            last["r"] = real_resolve(inst, mode)
            return last["r"]

        def get(inst):
            plan = provider.plan
            r = plan.lookup(inst) if plan is not None else None
            cs = real_get(inst)
            self.calls.append((inst, (r or last["r"]).tier, cs, r is not None))
            return cs

        provider.get, provider.pipeline.resolve = get, resolve

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls

    def close(self) -> None:
        del self.provider.get, self.provider.pipeline.resolve


def serve_stream(torch, engine, prompts, new_tokens: int, rec=None, after_admissions=None) -> dict:
    """The serve phases' stream through ``engine``: prefill seconds per
    prompt (add_request syncs on its argmax), decode seconds, steps; the
    prime prompt's matmul launches per body and (with ``rec``) its
    resolutions.  ``after_admissions`` runs once, after the last prompt is
    admitted, between two decode steps."""
    from repro_torch.kernels import matmul as mm

    pending, done = list(prompts), []
    out = {"prompt_prefill_s": [], "decode_s": 0.0, "steps": 0}
    while pending or engine.active:
        while pending and engine.free_slots:
            prompt = pending.pop(0)
            bodies0 = collections.Counter(body_counts(mm))
            n0 = len(rec.calls) if rec is not None else 0
            t0 = time.monotonic()
            req = engine.add_request(prompt, max_new_tokens=new_tokens)
            out["prompt_prefill_s"].append(time.monotonic() - t0)
            if len(prompt) == PRIME_PROMPT:
                out["prime_bodies"] = dict(collections.Counter(body_counts(mm)) - bodies0)
                out["prime_calls"] = rec.calls[n0:] if rec is not None else []
            if req.done:
                done.append(req)
            if not pending and after_admissions is not None:
                after_admissions()
        t0 = time.monotonic()
        done.extend(engine.step())
        out["decode_s"] += time.monotonic() - t0
        out["steps"] += 1
        if out["steps"] > 1000:
            raise AssertionError("the slot engine did not converge")
    torch.cuda.synchronize()
    if len(done) != len(prompts) or any(len(r.generated) != new_tokens for r in done):
        raise AssertionError(f"engine finished {len(done)} requests with token counts "
                             f"{[len(r.generated) for r in done]}")
    if "prime_bodies" not in out:
        raise AssertionError(f"no {PRIME_PROMPT}-token prompt among {[len(p) for p in prompts]}")
    out["requests"], out["tokens"] = len(done), sum(len(r.generated) for r in done)
    out["generated"] = [r.generated for r in sorted(done, key=lambda r: r.uid)]
    out["prefill_s"] = sum(out["prompt_prefill_s"])
    out["decode_ms_per_step"] = 1e3 * out["decode_s"] / out["steps"]
    return out


def _desc(inst) -> str:
    return f"{inst.class_id} {dict(inst.params)}"


def phase_serve_tuned(torch, db, default_row: dict) -> dict:
    """recurrentgemma-2b at full width served through a schedule registry on
    the card, as a user would (``launch.serve.make_provider`` with
    ``--tuning-registry`` and ``--target h100``): the registry holds the
    tuning phase's donor records; the engine plans its decode step at init.
    Beside them the registry holds one record in rounding mode: the decode
    LM head's default tiles with ``cache_write=False`` (as the autoscheduler
    draws for 30% of its schedules); no other record has its workload, so
    the exact tier serves it and the kernel's rounding mode runs on the main
    path.  A warm pass resolves every prefill instance (exact prompt
    lengths, none planned: service lookups time the default and probe
    donors on the card inside the forward pass), then the deferred jobs are
    drained and the plan refreshed.  Then the timed pass, in which a record
    for a decode instance is published once every prompt is admitted (the
    engine re-plans at the next step boundary), and the measured runner
    must time nothing new.

    Checks: no new timing in the timed pass; at the prime prompt's prefill,
    K1 launches on the tensor-core body exactly where an exact or transfer
    resolution gives an M tile above 16 (the default run: none); every
    distinct non-default launch served agrees with its plain version (the
    same rounding K tile); the first prompt's prefill logits under the
    registry's schedules within the serve bound; one re-plan, two monotone
    plan generations in the timed pass."""
    import tempfile

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core.database import Record
    from repro_torch.core.extract import extract_kernels
    from repro_torch.core.schedule import (GLU_CLASSES, Schedule, concretize, default_schedule,
                                           nearest_divisor)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    t_phase = time.monotonic()
    cfg = get_arch(TUNED_ARCH)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="registry-") as root:
        args = serve.parse_args(["--arch", TUNED_ARCH, "--preset", "full", "--device", "cuda",
                                 "--target", "h100", "--tuning-registry", root])
        provider, service = serve.make_provider(args)
        measured = service.runner.inner          # the MeasuredRunner behind the cache
        registry = service.registry              # publishes through it are seen at once
        registry.merge_db(db)
        model = build_model(cfg, "cuda")
        params = model.init(seed=0)
        prompts = serve_prompts(cfg)
        new_tokens = SERVE_NEW_TOKENS

        # the rounding-mode record: the decode step's least-used non-GLU
        # GEMM (the LM head), its default tiles without the f32 scratch
        decode = extract_kernels(cfg, ShapeConfig("serve_decode", 512, 4, "decode"))
        round_use = min((u for u in decode if u.instance.class_id in mm.EPILOGUE
                         and u.instance.class_id not in GLU_CLASSES),
                        key=lambda u: (u.use_count, -u.instance.p["N"]))
        round_inst = round_use.instance
        dflt = default_schedule(round_inst)
        k = round_inst.p["K"]
        tile_k = dflt.t["K"] if dflt.t["K"] < k else nearest_divisor(k, k // 2)
        round_sched = Schedule.make(round_inst.class_id, {**dflt.t, "K": tile_k}, order=dflt.order,
                                    cache_write=False, source="rounding-mode check")
        if mm.round_k_for(concretize(round_sched, round_inst)) != tile_k:
            raise AssertionError(f"{_desc(round_inst)}: {round_sched} does not round")
        round_rec = Record(instance=round_inst, schedule=round_sched,
                           seconds=service.runner.seconds(round_inst, round_sched),
                           model_id="serve/rounding-check", target=service.target)
        registry.publish([round_rec])

        t0 = time.monotonic()
        engine = ServingEngine(model, params, slots=4, max_len=512, provider=provider)
        plan_s = time.monotonic() - t0
        plan_init = {"entries": len(engine.plan), "tiers": engine.plan.tier_counts()}
        rec = ResolutionRecorder(provider)

        # warm pass: the prefill lookups, then the deferred jobs
        t0 = time.monotonic()
        warm = serve_stream(torch, engine, prompts, new_tokens, rec)
        warm_s = time.monotonic() - t0
        warm_calls = rec.take()
        t0 = time.monotonic()
        drained = service.drain()
        drain_s = time.monotonic() - t0
        engine.refresh_plan()
        for inst in {c[0].workload_key(): c[0] for c in warm_calls}.values():
            provider.pipeline.resolve(inst)   # at the new generation, before the timed pass
        if engine.plan.lookup(round_inst).schedule != round_sched:
            raise AssertionError(f"the plan does not serve the rounding-mode record: "
                                 f"{engine.plan.lookup(round_inst)}")

        # the mid-run record: a decode plan entry's schedule under another
        # unroll (the same launch, timed already), default tier first so
        # that it is served
        entries = sorted(engine.plan.items(), key=lambda ur: ur[1].tier != "default")
        mid_use, mid_res = entries[0]
        mid_sched = dataclasses.replace(mid_res.schedule, unroll=4 if mid_res.schedule.unroll != 4 else 16,
                                        source="mid-run publish")
        mid_rec = Record(instance=mid_use.instance, schedule=mid_sched,
                         seconds=service.runner.seconds(mid_use.instance, mid_sched),
                         model_id="serve/mid-run", target=service.target)

        # the timed pass
        for kmod in (mm, fa, rw, rg):
            kmod.reset_launches()
        timings0 = measured.stats.measurements
        stats0, svc0 = provider.stats(), service.stats()
        replans0, history0 = engine.replans, len(engine.plan_history)
        timed = serve_stream(torch, engine, prompts, new_tokens, rec,
                             after_admissions=lambda: registry.publish([mid_rec]))
        new_timings = measured.stats.measurements - timings0
        calls = rec.take()
        launches = serve.kernel_launches()
        bodies = body_counts(mm)
        rounding = {f"{k}/{b}": c for (k, b), c in sorted(mm.round_launches.items())}
        stats1, svc1 = provider.stats(), service.stats()
        history = engine.plan_history[history0:]
        replans = engine.replans - replans0
        if new_timings:
            raise AssertionError(f"the measured runner timed {new_timings} launches in the timed pass")
        if min(launches[k] for k in SERVE_KERNELS[TUNED_ARCH]) <= 0:
            raise AssertionError(f"a kernel of the path was never launched: {launches}")
        if sum(mm.round_launches.values()) <= 0:
            raise AssertionError(f"the rounding-mode record never reached the kernel: {round_rec}")
        if replans != 1 or len(history) != 2 or not history[0][1] < history[1][1]:
            raise AssertionError(f"re-plans {replans}, plan history {history}")
        if engine.plan.lookup(mid_use.instance).schedule != mid_sched and mid_res.tier == "default":
            raise AssertionError("the mid-run record did not become the plan's entry")

        # the prime prompt: K1 on the tensor cores exactly where the registry
        # gave an M tile above 16; under the default schedules, never
        bf16 = torch.bfloat16
        want_mma = sum(1 for inst, tier, cs, _ in timed["prime_calls"]
                       if inst.class_id in mm.EPILOGUE and tier in ("exact", "transfer")
                       and mm.body_for(bf16, mm.schedule_key(cs)[0]) == "mma")
        default_mma = sum(1 for inst, tier, cs, _ in timed["prime_calls"]
                          if inst.class_id in mm.EPILOGUE and tier == "default"
                          and mm.body_for(bf16, mm.schedule_key(cs)[0]) == "mma")
        got_mma = timed["prime_bodies"].get("matmul/mma/bfloat16", 0)
        if got_mma != want_mma or default_mma or want_mma <= 0:
            raise AssertionError(f"prime prefill: {got_mma} K1 mma launches, {want_mma} planned "
                                 f"(default-tier mma {default_mma})")
        if default_row["prime_prefill_body_launches"].get("matmul/mma/bfloat16", 0):
            raise AssertionError("the default run's prime prefill took the tensor-core body")

        # every distinct non-default launch served, against its plain version
        checked, errs, rounding_checked = set(), {}, 0
        slower = []
        for inst, tier, cs, _ in warm_calls + calls:
            if tier == "default":
                continue
            key = measured.launch_key(cs)
            if key in checked:
                continue
            checked.add(key)
            got, want = _outputs(measured.run(cs)), _outputs(measured.run(cs, plain=True))
            name = f"{_desc(inst)} {cs.t} {key[1]}"
            errs[name] = max(assert_close(torch, g, w, BF16_TOL if i == 0 else STATE_TOL, name)
                             for i, (g, w) in enumerate(zip(got, want)))
            rounding_checked += bool(inst.class_id in mm.EPILOGUE and mm.round_k_for(cs))
            del got, want
            ms, dflt = (service.runner.seconds(inst, cs.schedule) * 1e3,
                        service.runner.seconds(inst) * 1e3)
            if ms > dflt:
                slower.append({"instance": _desc(inst), "tier": tier, "tiles": cs.t,
                               "ms": ms, "default_ms": dflt})
        if not rounding_checked:
            raise AssertionError("no rounding-mode launch among those checked")

        toks = torch.tensor([prompts[0]], dtype=torch.long, device="cuda")
        logits = prefill_logits_check(torch, model, params, toks, f"{TUNED_ARCH} (registry)",
                                      provider=provider)
        rec.close()
        profile = profile_decode(torch, engine, prompts[:4], provider=provider)
        misses = collections.Counter(_desc(inst) for inst, _, _, planned in calls if not planned)
        prime_i = [len(p) for p in prompts].index(PRIME_PROMPT)
        row = {
            "arch": TUNED_ARCH, "registry_records": len(db.records()),
            "plan_s": plan_s, "plan_init": plan_init,
            "plan": {"entries": len(engine.plan), "generation": engine.plan.generation,
                     "tiers": engine.plan.tier_counts()},
            "warm_s": warm_s, "warm_prefill_s": warm["prefill_s"], "drained_jobs": drained,
            "drain_s": drain_s,
            "lookups": {"exact": svc1["exact_hits"], "transfer": svc1["transfer_hits"],
                        "default": svc1["default_misses"]},
            "timed_lookups": {t: svc1[k] - svc0[k] for t, k in (("exact", "exact_hits"),
                                                                ("transfer", "transfer_hits"),
                                                                ("default", "default_misses"))},
            "timed_plan_served": {t: stats1["plan_served"][t] - stats0["plan_served"][t]
                                  for t in stats1["plan_served"]},
            "timed_plan_misses": stats1["plan_misses"] - stats0["plan_misses"],
            "timed_missed_instances": dict(misses),
            "timed_new_timings": new_timings,
            "prefill_s": timed["prefill_s"], "default_prefill_s": default_row["prefill_s"],
            "prefill_ratio": timed["prefill_s"] / default_row["prefill_s"],
            "prime_prefill_s": timed["prompt_prefill_s"][prime_i],
            "default_prime_prefill_s": default_row["prompt_prefill_s"][prime_i],
            "prime_prefill_ratio": (timed["prompt_prefill_s"][prime_i]
                                    / default_row["prompt_prefill_s"][prime_i]),
            "prompt_prefill_s": timed["prompt_prefill_s"],
            "decode_steps": timed["steps"], "decode_ms_per_step": timed["decode_ms_per_step"],
            "default_decode_ms_per_step": default_row["decode_ms_per_step"],
            "decode_ratio": timed["decode_ms_per_step"] / default_row["decode_ms_per_step"],
            "launches": launches, "body_launches": bodies, "round_launches": rounding,
            "prime_prefill_body_launches": timed["prime_bodies"],
            "default_prime_prefill_body_launches": default_row["prime_prefill_body_launches"],
            "prime_k1_mma_planned": want_mma,
            "rounding_record": {"instance": _desc(round_rec.instance),
                                "tiles": round_rec.schedule.t,
                                "shape": [round_inst.class_id, *(round_inst.p[a] for a in "MKN"),
                                          tile_k],
                                "ms": round_rec.seconds * 1e3,
                                "default_ms": service.runner.seconds(round_rec.instance) * 1e3},
            "mid_run_record": {"instance": _desc(mid_use.instance), "tier_before": mid_res.tier,
                               "tier_after": engine.plan.lookup(mid_use.instance).tier},
            "replans": replans, "plan_history": history,
            "checks": len(errs), "rounding_checks": rounding_checked,
            "max_abs_err": max(errs.values()), "slower_than_default": slower,
            **logits, "decode_profile": profile,
            "tuning_service": {k: svc1[k] for k in ("lookups", "jobs_enqueued", "jobs_completed",
                                                    "upgrades", "search_seconds_spent",
                                                    "probe_search_s", "generation")},
            "runner": measured.telemetry(), "wall_s": time.monotonic() - t_phase}
        log("serve_tuned", **row)
        service.close()
        del model, params, engine, provider, service, measured
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# the paged engine: chunked prefill and speculative decoding
# ---------------------------------------------------------------------------

#: the paged and spec phases' geometry: 4 lanes, 512-token contexts, pages
#: of 16, chunks of 64, two chunks a step
PAGED = dict(decode_batch=4, max_ctx=512, page_size=16, chunk=64, chunks_per_step=2)
#: the preemption run's pool: 69 usable pages (1104 tokens) where the four
#: longest requests hold 1145 tokens at once (one preemption at seed 0)
PAGED_CUT_POOL = 70
#: extra pages of the fragmented run, held every other one by dummies
PAGED_SHRED = 24
#: the archs of the paged phase, the kernels each must launch, and the scan
#: each of its chunks must launch once per recurrent layer.  recurrentgemma's
#: local layers hold a 2048-slot window in a 512-token context: a paged leaf
#: whose chunks take attn_chunk's ring branch (masked plain attention, as the
#: reference's), so its paged path runs no K2
PAGED_ARCHS = {"minitron-4b": (("matmul", "flash_attention"), None),
               "rwkv6-1.6b": (("matmul", "rwkv6_scan"), "rwkv6_scan"),
               "recurrentgemma-2b": (("matmul", "rglru_scan"), "rglru_scan")}
#: the spec phase: a draft of minitron-4b's first two layers, 3 proposals a
#: burst (verify M = 4 lanes x 4 positions = 16 rows: K1's rows body, whose
#: bits do not depend on M), the serve prompts' first four
SPEC_K = 3
SPEC_KEEP = 2
SPEC_PROMPTS = 4
SPEC_PARTIAL_DAMP = 0.05


def phase_chunk_kernels(torch, timer) -> dict:
    """The paged path's new launch shapes, timed: K2 at minitron-4b's chunk
    shape (a 64-row chunk at q_offset 256 against the 512-row cache, GQA
    24/8, D = 128) beside its plain version and SDPA given the same boolean
    mask, and K1 at 64x3072x3072 (the chunk's q/o projection, tensor-core
    body) beside its plain version and ``torch.matmul``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(19)
    b, hq, hkv, c, skv, d, off = 1, 24, 8, 64, 512, 128, 256
    q, k, v = _attn_inputs(torch, g, b, hq, hkv, c, skv, d, torch.bfloat16)
    cs = ops.schedule_for(ops.instance("flash_attention_causal", torch.bfloat16, Q=c, KV=skv, H=hq,
                                       D=d, B=b, window=0))
    got = fa.launch(q, k, v, cs, q_offset=off)
    want = ref.chunked_attention(q, k, v, chunk=cs.t["KV"], q_offset=off)
    err_fa = assert_close(torch, got, want, BF16_TOL, "attention at the chunk shape")
    ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
    mask = torch.arange(skv, device="cuda")[None, :] <= off + torch.arange(c, device="cuda")[:, None]
    sdpa = F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)
    err_sdpa = assert_close(torch, sdpa, want, BF16_TOL, "SDPA at the chunk shape")
    # the rows the causal mask needs: keys 0 .. off + c - 1
    live = c * off + c * (c + 1) / 2
    b_ms, b_by = bound_ms(2 * (2 * b * hq * c * d + 2 * b * hkv * (off + c) * d),
                          4 * b * hq * live * d)
    body, cta_q, ctas = fa.attention_geometry(torch.bfloat16, c, cs.t["Q"])
    attn_row = {"B": b, "Hq": hq, "Hkv": hkv, "C": c, "KV": skv, "D": d, "q_offset": off,
                "tiles": cs.t, "body": body, "ctas": b * hq * ctas, "max_abs_err": err_fa,
                "sdpa_max_abs_err": err_sdpa,
                "ms": timer.ms(lambda: fa.launch(q, k, v, cs, q_offset=off), iters=20),
                "plain_ms": timer.ms(lambda: ref.chunked_attention(q, k, v, chunk=cs.t["KV"],
                                                                   q_offset=off)),
                "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                    q, ke, ve, attn_mask=mask), iters=20),
                "bound_ms": b_ms, "bound_by": b_by}
    attn_row["device_ms"] = timer.device_ms(lambda: fa.launch(q, k, v, cs, q_offset=off))
    attn_row["library_device_ms"] = timer.device_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask))
    log("chunk_attention", **attn_row)

    m, n, kk = 64, 3072, 3072
    x, w, _ = _mm_inputs(torch, g, m, n, kk, "matmul", torch.bfloat16)
    cs = ops.schedule_for(ops.instance("matmul", torch.bfloat16, M=m, N=n, K=kk))
    body, cta_m, cta_n, split_k, ctas = mm.launch_geometry(torch.bfloat16, m, n, kk, cs.t["M"],
                                                           cs.t["N"])
    if body != "mma":
        raise AssertionError(f"K1 at {m}x{kk}x{n} takes the {body} body")
    got = mm.launch(x, w, cs)
    err_mm = assert_close(torch, got, ref.matmul(x, w), BF16_TOL, f"matmul {m}x{kk}x{n}")
    b_ms, b_by = bound_ms(2 * (m * kk + kk * n + m * n), 2 * m * n * kk)
    mm_row = {"class": "matmul", "M": m, "K": kk, "N": n, "tiles": cs.t, "body": body,
              "cta_tile": [cta_m, cta_n], "ctas": ctas, "max_abs_err": err_mm,
              "ms": timer.ms(lambda: mm.launch(x, w, cs), iters=20),
              "plain_ms": timer.ms(lambda: ref.matmul(x, w)),
              "library_ms": timer.ms(lambda: torch.matmul(x, w), iters=20),
              "bound_ms": b_ms, "bound_by": b_by,
              "device_ms": timer.device_ms(lambda: mm.launch(x, w, cs)),
              "library_device_ms": timer.device_ms(lambda: torch.matmul(x, w))}
    log("chunk_matmul", **mm_row)
    return {"attention": attn_row, "matmul": mm_row}


class EngineClock:
    """Host-clock seconds (each call between two syncs), calls and K1
    launches per body of a paged engine's model calls: ``_chunk``,
    ``_decode``, ``_spec_step`` and ``_verify``.  With ``scan`` (a scan
    kernel's module) it fails unless every chunk launched the scan
    ``per_chunk`` times (once per recurrent layer)."""

    CALLS = ("_chunk", "_decode", "_spec_step", "_verify")

    def __init__(self, torch, engine, scan=None, per_chunk: int = 0):
        from repro_torch.kernels import matmul as mm

        self.seconds = collections.Counter()
        self.calls = collections.Counter()
        self.bodies = {name: collections.Counter() for name in self.CALLS}
        for name in self.CALLS:
            real = getattr(engine, name)

            def timed(*args, _real=real, _name=name):
                torch.cuda.synchronize()
                scans0, bodies0 = (scan.launches if scan else 0), collections.Counter(body_counts(mm))
                t0 = time.monotonic()
                out = _real(*args)
                torch.cuda.synchronize()
                self.seconds[_name] += time.monotonic() - t0
                self.calls[_name] += 1
                self.bodies[_name] += collections.Counter(body_counts(mm)) - bodies0
                if scan is not None and _name == "_chunk" and scan.launches - scans0 != per_chunk:
                    raise AssertionError(f"a chunk launched the scan {scan.launches - scans0} "
                                         f"times, not {per_chunk}")
                return out

            setattr(engine, name, timed)

    def ms(self, name: str) -> float | None:
        return 1e3 * self.seconds[name] / self.calls[name] if self.calls[name] else None


def free_engines(torch) -> None:
    """Free the engines dropped so far: ``EngineClock``'s wrappers and
    ``paged_run``'s preemption hook hold their engine in a reference cycle,
    which only the collector breaks, and an engine holds its params and its
    pool; peak memory is read after this."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def paged_run(torch, model, params, prompts, *, fragment: bool = False, scan=None,
              per_chunk: int = 0, **kw):
    """One stream of ``prompts`` (SERVE_NEW_TOKENS each) through a paged
    engine at the PAGED geometry: (engine, requests, clock, wall s, steps).
    ``fragment`` shreds the free list first (PAGED_SHRED extra pages,
    every other one held by a dummy for the whole run)."""
    from repro_torch.serving import PagedServingEngine

    geo = dict(PAGED, **kw)
    if fragment:
        geo["pool_pages"] = (geo["decode_batch"] * geo["max_ctx"] // geo["page_size"] + 1
                             + PAGED_SHRED)
    eng = PagedServingEngine(model, params, record_logits=True, **geo)
    eng.preempted_uids = set()
    real_preempt = eng._preempt

    def preempt(uid):
        eng.preempted_uids.add(uid)
        real_preempt(uid)

    eng._preempt = preempt
    if fragment:
        for i in range(PAGED_SHRED):
            eng.table.ensure(10 ** 6 + i, geo["page_size"])
        for i in range(0, PAGED_SHRED, 2):
            eng.table.release(10 ** 6 + i)
        if eng.table.fragmentation() <= 0.0:
            raise AssertionError("the shredded pool is not fragmented")
    clock = EngineClock(torch, eng, scan, per_chunk)
    t0 = time.monotonic()
    reqs = [eng.add_request(p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
    steps = 0
    while eng.in_flight:
        eng.step()
        steps += 1
        if steps > 1000:
            raise AssertionError("the paged engine did not converge")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if not all(r.done and len(r.generated) == SERVE_NEW_TOKENS for r in reqs):
        raise AssertionError(f"paged engine finished with token counts "
                             f"{[len(r.generated) for r in reqs]}")
    return eng, reqs, clock, wall, steps


def first_divergence(torch, model, params, prompt, want, got) -> dict | None:
    """Where a stream ``got`` first leaves ``want`` (the slot engine's):
    the step and the top-2 margin of the logits there, from one prefill of
    the prompt and ``want``'s tokens before that step (None: no divergence)."""
    step = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if step is None:
        return None
    toks = torch.tensor([prompt + want[:step]], dtype=torch.long, device="cuda")
    logits, _ = model.prefill(params, {"tokens": toks}, max_len=512)
    top = torch.topk(logits[0].float(), 2).values
    return {"step": step, "want": want[step], "got": got[step], "margin": float(top[0] - top[1])}


def _cache_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_paged(torch, srv: list) -> list:
    """The paged engine at full width and depth: minitron-4b (K1, K2),
    rwkv6-1.6b (K1, K3) and recurrentgemma-2b (K1, K4), at the PAGED
    geometry, the serve phases' 8 prompts and 16 new tokens each, beside
    the slot engine (exact-length prefill) on the same weights.

    Checks per arch: every request finishes; no prefill padding; each
    stream equals the slot engine's, where a divergence fails unless the
    top-2 margin at the first divergent step is below the logits bound and
    the arch is recurrent or the slot engine prefilled that prompt on K1's
    rows body (minitron-4b's prime 181-token prompt: 1-row tiles, where the
    paged engine's chunks run on the tensor cores and sum otherwise); each
    final chunk's logits within the logits bound of the slot engine's
    one-shot prefill logits (the larger of LOGITS_REL_BOUND of max |logit|
    and the serve phase's bound); the bf16 matmul never on the CUDA-core
    body, the attention only on the tensor-core body.  minitron-4b: K2
    launched at q_offset > 0, K1 on both the tensor-core and the rows
    bodies; a fragmented pool gives the same tokens and final-chunk logits,
    bit for bit; a pool cut to PAGED_CUT_POOL pages preempts and gives the
    same streams (a victim's, recomputed on resume, may leave at a near-tie
    only).  rwkv6-1.6b, recurrentgemma-2b: every chunk launches the
    scan once per recurrent layer."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.paged import _leaves

    rows = []
    scans = {"rwkv6_scan": rw, "rglru_scan": rg}
    for arch, (kernels, scan_name) in PAGED_ARCHS.items():
        t_arch = time.monotonic()
        cfg = get_arch(arch)
        srv_row = next(r for r in srv if r["arch"] == cfg.name)
        free_engines(torch)
        model = build_model(cfg, "cuda")
        params = model.init(seed=0)
        prompts = serve_prompts(cfg)

        # the slot engine, exact-length prefill, same weights, same call
        slot = ServingEngine(model, params, slots=PAGED["decode_batch"],
                             max_len=PAGED["max_ctx"], prefill_buckets=False)
        t0 = time.monotonic()
        slot_run = serve_stream(torch, slot, prompts, SERVE_NEW_TOKENS)
        slot_wall = time.monotonic() - t0
        slot_bytes = _cache_bytes(_leaves(slot.cache))
        del slot
        free_engines(torch)

        # the main path: counts set to 0 just before, read just after
        for kmod in (mm, fa, rw, rg):
            kmod.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        scan = scans.get(scan_name)
        per_chunk = sum(k == "R" for k in cfg.layer_kinds) if scan else 0
        eng, reqs, clock, wall, steps = paged_run(torch, model, params, prompts, scan=scan,
                                                  per_chunk=per_chunk)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = serve.kernel_launches()
        bodies = body_counts(mm)
        attn_bodies = {f"{b}/{ops.dtype_name(d)}": n for (b, d), n in fa.body_launches.items()}
        offset_launches, fa_row_tiles = fa.offset_launches, fa.row_tile_launches
        mm_row_tiles = mm.row_tile_launches
        if eng.prefill_padded_tokens != eng.prefill_true_tokens:
            raise AssertionError(f"{arch}: paged prefill padded {eng.prefill_padded_tokens} "
                                 f"for {eng.prefill_true_tokens} tokens")
        if mm.body_count("fma", dtype=torch.bfloat16) or fa.body_count("fma", dtype=torch.bfloat16):
            raise AssertionError(f"{arch}: a bf16 launch took a CUDA-core body: {bodies}, "
                                 f"{attn_bodies}")
        if min(launches[k] for k in kernels) <= 0:
            raise AssertionError(f"{arch}: a kernel of the paged path was never launched: "
                                 f"{launches}")
        pool_bytes = _cache_bytes(eng.leaves)

        # streams against the slot engine's; final-chunk logits against its
        # one-shot prefill logits, within the serve phases' bound: the larger
        # of LOGITS_REL_BOUND of max |logit| and CONTROL_FACTOR times the f64
        # control, the control taken on this prompt where the serve phase's
        # (taken on the first prompt) is not enough
        divergences, logits_err, bounds = [], [], []
        for prompt, want, req in zip(prompts, slot_run["generated"], reqs):
            div = first_divergence(torch, model, params, prompt, want, req.generated)
            toks = torch.tensor([prompt], dtype=torch.long, device="cuda")
            one, _ = model.prefill(params, {"tokens": toks}, max_len=512)
            one = one[0].float().cpu()
            chunk = torch.from_numpy(eng.chunk_logits[req.uid])
            err = float((chunk - one).abs().max())
            bound = max(LOGITS_REL_BOUND * float(one.abs().max()), srv_row["logits_bound"])
            if err > bound:
                bound = max(bound, CONTROL_FACTOR * f64_control(torch, model, params, toks))
            logits_err.append(err)
            bounds.append(bound)
            if err > bound:
                raise AssertionError(f"{arch}: the {len(prompt)}-token prompt's final-chunk logits "
                                     f"differ from one-shot prefill's by {err} > {bound}")
            if div is not None:
                # minitron-4b: a prompt the slot engine prefills on K1's rows
                # body (a prime length's 1-row tiles, ROADMAP B.1) sums
                # otherwise than the paged engine's tensor-core chunks, so its
                # stream may leave at a near-tie; any other must be exact
                rows_prefill = mm.body_for(torch.bfloat16, ops.schedule_for(ops.instance(
                    "matmul", torch.bfloat16, M=len(prompt), N=cfg.d_model, K=cfg.d_model)
                ).t["M"]) == "rows"
                div.update(prompt_len=len(prompt), logits_bound=bound,
                           near_tie_allowed=scan is not None or rows_prefill)
                divergences.append(div)
        log("paged_streams", arch=arch, divergences=divergences, logits_bounds=bounds,
            chunk_logits_max_abs_diff=logits_err)
        for div in divergences:
            if not div["near_tie_allowed"] or div["margin"] >= div["logits_bound"]:
                raise AssertionError(f"{arch}: a paged stream leaves the slot engine's: {div}")

        row = {"arch": cfg.name, "layers": cfg.n_layers, "geometry": PAGED,
               "requests": len(reqs), "tokens": sum(len(r.generated) for r in reqs),
               "steps": steps, "chunk_lens": sorted(eng._chunk_lens_run),
               "prefill_s": clock.seconds["_chunk"], "chunks": clock.calls["_chunk"],
               "decode_s": clock.seconds["_decode"], "decode_steps": clock.calls["_decode"],
               "decode_ms_per_step": clock.ms("_decode"),
               "decode_tok_per_s": (sum(len(r.generated) for r in reqs) - len(reqs))
               / clock.seconds["_decode"],
               "wall_s": wall,
               "slot": {"prefill_s": slot_run["prefill_s"],
                        "decode_ms_per_step": slot_run["decode_ms_per_step"],
                        "decode_tok_per_s": (slot_run["tokens"] - slot_run["requests"])
                        / slot_run["decode_s"],
                        "decode_steps": slot_run["steps"], "wall_s": slot_wall},
               "pool_bytes": pool_bytes, "slot_cache_bytes": slot_bytes,
               "serve_peak_gib": peak_gib,
               "launches": launches, "body_launches": bodies, "attention_body_launches": attn_bodies,
               "attention_offset_launches": offset_launches,
               "row_tile_launches": {"matmul": mm_row_tiles, "flash_attention": fa_row_tiles},
               "chunk_body_launches": dict(clock.bodies["_chunk"]),
               "decode_body_launches": dict(clock.bodies["_decode"]),
               "divergences": divergences, "chunk_logits_max_abs_diff": logits_err,
               "logits_bounds": bounds}

        if arch == "minitron-4b":
            if offset_launches <= 0 or mm.body_count("mma") <= 0 or mm.body_count("rows") <= 0:
                raise AssertionError(f"{arch}: K2 at q_offset > 0 {offset_launches}, K1 bodies "
                                     f"{bodies}")
            fr_eng, fr_reqs, _, _, fr_steps = paged_run(torch, model, params, prompts,
                                                        fragment=True)
            if [r.generated for r in fr_reqs] != [r.generated for r in reqs] or any(
                    not np_equal(fr_eng.chunk_logits[a.uid], eng.chunk_logits[b.uid])
                    for a, b in zip(fr_reqs, reqs)):
                raise AssertionError(f"{arch}: a fragmented pool changed the tokens or logits")
            del fr_eng
            free_engines(torch)
            cut_eng, cut_reqs, _, _, cut_steps = paged_run(torch, model, params, prompts,
                                                           pool_pages=PAGED_CUT_POOL)
            # a victim's generated tokens are prefilled again on resume, in
            # tensor-core chunks where decode ran them on the rows body: its
            # stream may leave at a near-tie; any other stream must be exact
            cut_div = []
            for p, a, b in zip(prompts, reqs, cut_reqs):
                div = first_divergence(torch, model, params, p, a.generated, b.generated)
                if div is not None:
                    div.update(prompt_len=len(p), victim=b.uid in cut_eng.preempted_uids)
                    cut_div.append(div)
            row.update(fragmented={"steps": fr_steps, "bit_equal": True},
                       preempted={"pool_pages": PAGED_CUT_POOL, "steps": cut_steps,
                                  "preemptions": cut_eng.preemptions,
                                  "victims": sorted(cut_eng.preempted_uids),
                                  "divergences": cut_div})
            if cut_eng.preemptions <= 0 or any(not d["victim"] or d["margin"] >= max(bounds)
                                               for d in cut_div):
                raise AssertionError(f"{arch}: the cut pool preempted {cut_eng.preemptions} "
                                     f"times; streams leave the full pool's: {cut_div}")
            del cut_eng
        row["phase_s"] = time.monotonic() - t_arch
        log("paged", **row)
        rows.append(row)
        del model, params, eng, clock
        free_engines(torch)
    return rows


def f64_control(torch, model, params, toks) -> float:
    """The distance between the plain path's prefill logits and the same
    path's with its matmuls accumulated in f64 (see ``f64_accumulation``)."""
    from repro_torch.kernels.ops import use_backend

    with use_backend("ref"):
        plain, _ = model.prefill(params, {"tokens": toks}, max_len=512)
        with f64_accumulation():
            control, _ = model.prefill(params, {"tokens": toks}, max_len=512)
    return max_err(torch, control, plain)


def np_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def phase_spec(torch) -> dict:
    """Speculative decoding on the paged engine, minitron-4b at full width
    and depth: a self-draft of its first SPEC_KEEP layers, SPEC_K proposals
    a burst, the PAGED geometry, SPEC_PROMPTS of the serve prompts, 16 new
    tokens.  Three regimes: all-accept (damp 0: the damped target computes
    the draft's function), all-reject (the draft's LM head rolled by one
    column), partial (damp SPEC_PARTIAL_DAMP).  Checks in each: the
    committed streams equal the plain paged engine's on the same target,
    bit for bit; bursts ran; accepted == proposed, 0, or strictly between
    them; every verify projection took the rows body."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import make_self_draft

    t_phase = time.monotonic()
    cfg = get_arch("minitron-4b")
    torch.cuda.empty_cache()
    model = build_model(cfg, "cuda")
    params = model.init(seed=0)
    prompts = serve_prompts(cfg)[:SPEC_PROMPTS]
    out = {"arch": cfg.name, "spec_k": SPEC_K, "keep_layers": SPEC_KEEP, "geometry": PAGED,
           "prompt_lens": [len(p) for p in prompts], "regimes": {}}
    totals = collections.Counter()
    body_totals = collections.Counter()
    plain = {}
    for regime, damp in (("all_accept", 0.0), ("all_reject", 0.0), ("partial", SPEC_PARTIAL_DAMP)):
        dcfg, dparams, tparams = make_self_draft(cfg, params, keep_layers=SPEC_KEEP, damp=damp)
        if regime == "all_reject":
            dparams = dict(dparams, lm_head=torch.roll(dparams["lm_head"], 1, dims=1))
        if damp not in plain:
            _, p_reqs, p_clock, _, _ = paged_run(torch, model, tparams, prompts)
            plain[damp] = ([r.generated for r in p_reqs], p_clock.ms("_decode"))
            del p_clock
            free_engines(torch)
        for kmod in (mm, fa, rw, rg):
            kmod.reset_launches()
        eng, reqs, clock, wall, steps = paged_run(
            torch, model, tparams, prompts, draft_model=build_model(dcfg, "cuda"),
            draft_params=dparams, spec_k=SPEC_K)
        totals.update(serve.kernel_launches())
        body_totals.update(body_counts(mm))
        streams, plain_ms = plain[damp]
        equal = [r.generated for r in reqs] == streams
        verify_bodies = dict(clock.bodies["_verify"])
        row = {"damp": damp, "bit_equal_to_plain": equal, "steps": steps, "wall_s": wall,
               "bursts": eng.spec_bursts, "proposed": eng.spec_proposed,
               "accepted": eng.spec_accepted, "committed": eng.spec_committed,
               "committed_per_burst": eng.spec_committed / max(eng.spec_bursts, 1),
               "burst_calls": clock.calls["_spec_step"], "ms_per_burst": clock.ms("_spec_step"),
               "verify_ms": clock.ms("_verify"), "plain_ms_per_step": plain_ms,
               "decode_ms_per_step": clock.ms("_decode"), "verify_body_launches": verify_bodies}
        log("spec", regime=regime, **row)
        out["regimes"][regime] = row
        want_accept = {"all_accept": eng.spec_accepted == eng.spec_proposed,
                       "all_reject": eng.spec_accepted == 0,
                       "partial": 0 < eng.spec_accepted < eng.spec_proposed}[regime]
        if not equal:
            raise AssertionError(f"spec {regime}: the committed streams differ from plain decode's")
        if eng.spec_bursts <= 0 or not want_accept:
            raise AssertionError(f"spec {regime}: {eng.spec_bursts} bursts, accepted "
                                 f"{eng.spec_accepted} of {eng.spec_proposed}")
        if not verify_bodies or any("/rows/" not in key for key in verify_bodies):
            raise AssertionError(f"spec {regime}: verify's K1 bodies {verify_bodies}")
        del eng, clock, dparams, tparams
        free_engines(torch)
    out["launches"], out["body_launches"] = dict(totals), dict(body_totals)
    out["phase_s"] = time.monotonic() - t_phase
    del model, params
    free_engines(torch)
    return out


#: the fleet phase: the seeded trace (the reference's TrafficGenerator
#: parameters) at full-size prompts, run A's slot fleet and run B's paged
#: speculative one, and the self-draft's residual damping in run B (the
#: launcher's default, ``serve_fleet --spec-damp``)
FLEET_TRAFFIC = dict(seed=0, arrival_rate=0.5, short_lens=(32, 128), long_lens=(181, 356),
                     long_frac=0.25, new_tokens=(8, 16), prompt_cap=356)
FLEET_REQUESTS = 16
FLEET_MAX_LEN = 512
FLEET_A = dict(replicas=2, slots=4, policy="plan_aware", prefetch=True, slos="default")
FLEET_B = dict(replicas=1, engine="paged", speculative="auto", spec_k=SPEC_K,
               **{k: v for k, v in PAGED.items() if k != "max_ctx"})
FLEET_CLASS_MIX = {"chat": 0.7, "bulk": 0.3}
FLEET_DAMP = 0.02


class RunnerProbe:
    """A fleet's measured runner, watched: how many timings it made and
    their wall seconds, the kernel launches they made (kept out of the
    serving path's counts), and the launch keys of any timing made while an
    engine call ran (``in_steps``: the fleet must time between steps only)."""

    def __init__(self, torch, measured):
        from repro_torch.kernels import matmul as mm
        from repro_torch.launch import serve

        self.timings, self.wall_s, self.in_steps, self.depth = 0, 0.0, [], 0
        self.launches, self.bodies = collections.Counter(), collections.Counter()
        real = measured._seconds

        def seconds(cs):
            n0 = measured.stats.measurements
            l0, b0 = collections.Counter(serve.kernel_launches()), collections.Counter(body_counts(mm))
            t0 = time.monotonic()
            out = real(cs)
            if measured.stats.measurements != n0:
                self.timings += 1
                self.wall_s += time.monotonic() - t0
                self.launches += collections.Counter(serve.kernel_launches()) - l0
                self.bodies += collections.Counter(body_counts(mm)) - b0
                if self.depth:
                    self.in_steps.append(list(measured.launch_key(cs)))
            return out

        measured._seconds = seconds

    def watch(self, engine) -> None:
        for name in ("add_request", "step"):
            real = getattr(engine, name)

            def call(*args, _real=real, **kw):
                self.depth += 1
                try:
                    return _real(*args, **kw)
                finally:
                    self.depth -= 1

            setattr(engine, name, call)

    def snapshot(self) -> tuple:
        return self.timings, self.wall_s, collections.Counter(self.launches), \
            collections.Counter(self.bodies)


def fleet_run(torch, name: str, model, params, db, bound: float, srv_alone, **kw) -> dict:
    """One fleet run at the h100 target through a registry seeded with the
    tuning phase's donor records: the seeded trace served, its checks, and
    the row printed.  ``srv_alone(prompt, n)`` serves one prompt alone on an
    engine of the same kind and weights (default schedules) and returns its
    tokens.  The launch counts are the serve's, set to 0 just before it and
    read just after, the measured runner's own launches taken out."""
    import contextlib
    import io
    import tempfile

    from repro_torch.fleet import ServingFleet, TrafficGenerator, percentile
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import serve, trace_report
    from repro_torch.obs import Tracer
    from repro_torch.obs.export import write_chrome_trace
    from repro_torch.service import ScheduleRegistry

    t_run = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="fleet-") as root:
        registry = ScheduleRegistry(f"{root}/registry")
        registry.merge_db(db)
        tracer = Tracer()
        t0 = time.monotonic()
        fleet = ServingFleet(model.cfg, model, params, max_len=FLEET_MAX_LEN, registry=registry,
                             targets="h100", tracer=tracer, **kw)
        build_s = time.monotonic() - t0
        runner = fleet.runner_for("h100")
        measured = runner.inner
        if type(measured).__name__ != "MeasuredRunner" or fleet.services["h100"].runner is not \
                runner or any(r._runner is not runner for r in fleet.replicas):
            raise AssertionError(f"fleet {name}: the h100 target is not priced by one shared "
                                 f"MeasuredRunner: {type(measured).__name__}")
        probe = RunnerProbe(torch, measured)
        for r in fleet.replicas:
            probe.watch(r.engine)
        build_timings = measured.stats.measurements
        tiers_before = [r.engine.plan.tier_counts() for r in fleet.replicas]
        gen = TrafficGenerator(vocab_size=model.cfg.vocab_size, tick_s=fleet.tick_s,
                               class_mix=FLEET_CLASS_MIX if kw.get("speculative") else None,
                               **FLEET_TRAFFIC)
        trace = gen.trace(FLEET_REQUESTS)
        prompts = {r.uid: (r.prompt, r.max_new_tokens) for r in trace}

        for kmod in (mm, fa, rw, rg):
            kmod.reset_launches()
        before = probe.snapshot()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        try:
            summary = fleet.serve(trace)
        finally:
            fleet.close()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        after = probe.snapshot()
        runner_launches = after[2] - before[2]
        launches = {k: v - runner_launches[k] for k, v in serve.kernel_launches().items()}
        bodies = dict(collections.Counter(body_counts(mm)) - (after[3] - before[3]))
        trace_path = f"{root}/trace.json"
        write_chrome_trace(trace_path, tracer)
        with contextlib.redirect_stdout(io.StringIO()):
            report = trace_report.main([trace_path, "--json"])

    # every request completed, or shed for a reason the summary gives
    shed = {fr.uid: fr.shed for fr in fleet.metrics.shed}
    if summary["completed"] + summary["shed"] != FLEET_REQUESTS or any(
            not why for why in shed.values()) or sum(summary["shed_by_reason"].values()) != \
            summary["shed"]:
        raise AssertionError(f"fleet {name}: {summary['completed']} completed, shed {shed}, "
                             f"by reason {summary['shed_by_reason']}")
    if summary["schedule_mismatches"]:
        raise AssertionError(f"fleet {name}: {summary['schedule_mismatches']} schedule mismatches")
    if probe.in_steps:
        raise AssertionError(f"fleet {name}: the measured runner timed {probe.in_steps} while an "
                             "engine call ran")
    if min(launches.get(k, 0) for k in ("matmul", "flash_attention")) <= 0:
        raise AssertionError(f"fleet {name}: the served path did not launch K1 and K2: {launches}")
    if mm.body_count("fma", dtype=torch.bfloat16) or fa.body_count("fma", dtype=torch.bfloat16):
        raise AssertionError(f"fleet {name}: a bf16 launch took a CUDA-core body: {bodies}")
    cp = report["critical_path"]
    if report["latency"]["requests"] != summary["completed"] or cp["attributed_frac"] != 1.0:
        raise AssertionError(f"fleet {name}: trace_report attributes {cp['attributed_frac']} of "
                             f"the critical path over {report['latency']['requests']} requests")

    # each completed request's tokens against the same engine serving its
    # prompt alone; a parting is allowed only at a near-tie (top-2 margin
    # below the serve phase's logits bound): a replica that re-planned
    # mid-stream may sum a projection on another K1 body than the defaults
    t0 = time.monotonic()
    divergences = []
    for fr in sorted(fleet.metrics.completed, key=lambda r: r.uid):
        prompt, n = prompts[fr.uid]
        want = srv_alone(prompt, n)
        if len(fr.generated) != n:
            raise AssertionError(f"fleet {name}: request {fr.uid} made {len(fr.generated)} of "
                                 f"{n} tokens")
        div = first_divergence(torch, model, params, prompt, want, fr.generated)
        if div is not None:
            div.update(uid=fr.uid, prompt_len=len(prompt), bound=bound)
            divergences.append(div)
    alone_s = time.monotonic() - t0
    log(f"fleet_{name}_streams", compared=summary["completed"], divergences=divergences,
        rule=f"a parting allowed only where the top-2 margin is below {bound}", alone_s=alone_s)
    if any(d["margin"] >= bound for d in divergences):
        raise AssertionError(f"fleet {name}: a stream leaves the alone run's: {divergences}")

    done = fleet.metrics.completed
    ttft = [fr.prefill_done_s - fr.arrival_s for fr in done]
    virtual = summary["makespan_s"]
    row = {"run": name, "engine": summary["engine"], "replicas": len(fleet.replicas),
           "requests": FLEET_REQUESTS, "completed": summary["completed"],
           "shed_by_reason": summary["shed_by_reason"], "tokens": summary["tokens"],
           "tick_s": summary["tick_s"], "virtual_s": virtual, "wall_s": wall,
           "wall_over_virtual": wall / virtual,
           "latency_s": summary["latency_s"],
           "ttft_s": {"p50": percentile(ttft, 50), "p95": percentile(ttft, 95)},
           "throughput_tok_per_s_virtual": summary["throughput_tok_per_s"],
           "throughput_tok_per_s_wall": summary["tokens"] / wall,
           "runner": {"build_timings": build_timings, "timings": after[0],
                      "serve_timings": after[0] - before[0], "timing_wall_s": after[1],
                      "serve_timing_wall_s": after[1] - before[1], "in_steps": 0,
                      "launches": dict(after[2])},
           "tuning": {k: summary["tuning"]["h100"][k]
                      for k in ("lookups", "exact_hits", "transfer_hits", "default_misses",
                                "jobs_enqueued", "jobs_completed", "upgrades", "in_flight",
                                "search_seconds_spent")},
           "tiers_before": tiers_before,
           "tiers_after": [r["plan_tiers"] for r in summary["replicas"]],
           "replans": [r["replans"] for r in summary["replicas"]],
           "schedule_mismatches": summary["schedule_mismatches"],
           "critical_path": {"segments": cp["segments"], "attributed_frac": cp["attributed_frac"]},
           "launches": launches, "body_launches": bodies, "divergences": divergences,
           "build_s": build_s, "alone_s": alone_s, "run_s": time.monotonic() - t_run}
    if "speedup_ledger" in summary:
        row["speedup_ledger"] = {k: summary["speedup_ledger"][k]
                                 for k in ("workloads", "tuned_workloads", "realized_speedup",
                                           "attainable_speedup", "realized_fraction", "tiers")}
    if "speculative" in summary:
        # the admit-time decision's inputs: the cells' measured kernel ms and
        # the projected gain at the acceptance prior (auto speculates above 1)
        prior = summary["speculative"]["acceptance"]["prior_alpha"]
        row["speculative"] = {
            "counters": summary["speculative"]["counters"],
            "acceptance": summary["speculative"]["acceptance"],
            "cells_ms": [{"decode": 1e3 * r.decode_cost(), "verify": 1e3 * r.verify_cost(),
                          "draft_decode": 1e3 * r.draft_decode_cost(),
                          "gain_at_prior": r.spec_gain(prior),
                          "verify_top": [[u.instance.class_id, dict(u.instance.params),
                                          u.use_count, 1e3 * s] for u, s in sorted(
                              r.cell_workload_seconds("verify"), key=lambda us: -us[1])[:4]]}
                         for r in fleet.replicas if r.spec_capable]}
    if "slo" in summary:
        row["slo"] = {k: {f: v[f] for f in ("alerting_windows", "evaluations", "alerting_now")}
                      for k, v in summary["slo"].items()}
    log(f"fleet_{name}", **row)
    del fleet, tracer, probe
    free_engines(torch)
    return row


def phase_fleet(torch, db, srv: list) -> list:
    """The serving fleet (``repro_torch.fleet``) at minitron-4b's full width
    and depth, bf16, random weights from seed 0, on its virtual clock read
    from the port's kernels timed on the card (the ``h100`` target:
    ``CachedRunner(MeasuredRunner())``, one per target), through a registry
    of the tuning phase's donor records: FLEET_REQUESTS requests of the
    seeded trace (FLEET_TRAFFIC: 32-356-token prompts, 8-16 new tokens).
    Run A: two slot replicas of 4 slots sharing one copy of the weights,
    plan-aware routing, demand-driven prefetch, default SLOs, a tracer.
    Run B: one paged replica (4 lanes, pages of 16, chunks of 64, two a
    step), speculative ``auto`` over a 2-layer self-draft, spec_k 3,
    chat/bulk traffic.  Checks in each (``fleet_run``): every request
    completed or shed for a reason given; 0 schedule mismatches; the
    measured runner never timed while an engine call ran; K1 and K2
    launched, no bf16 launch on a CUDA-core body; ``trace_report`` over the
    run's Chrome trace attributes 100% of the critical path; each request's
    tokens equal its prompt served alone, or part at a near-tie."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serving import PagedServingEngine, ServingEngine, make_self_draft

    t_phase = time.monotonic()
    cfg = get_arch("minitron-4b")
    bound = next(r for r in srv if r["arch"] == cfg.name)["logits_bound"]
    free_engines(torch)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, "cuda")
    params = model.init(seed=0)

    slot = ServingEngine(model, params, slots=FLEET_A["slots"], max_len=FLEET_MAX_LEN)

    def slot_alone(prompt, n):
        req = slot.add_request(prompt, max_new_tokens=n)
        slot.run_to_completion()
        return req.generated

    rows = [fleet_run(torch, "A", model, params, db, bound, slot_alone, **FLEET_A)]
    del slot
    free_engines(torch)

    dcfg, dparams, tparams = make_self_draft(cfg, params, keep_layers=SPEC_KEEP,
                                             damp=FLEET_DAMP)
    paged = PagedServingEngine(model, tparams, max_ctx=FLEET_MAX_LEN,
                               **{k: v for k, v in PAGED.items() if k != "max_ctx"})

    def paged_alone(prompt, n):
        req = paged.add_request(prompt, max_new_tokens=n)
        paged.run_to_completion()
        return req.generated

    rows.append(fleet_run(torch, "B", model, tparams, db, bound, paged_alone,
                          draft_model=build_model(dcfg, "cuda"), draft_params=dparams,
                          **FLEET_B))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for row in rows:
        row["phase_peak_gib"] = peak
    log("fleet", runs=[r["run"] for r in rows], peak_gib=peak,
        phase_s=time.monotonic() - t_phase)
    del paged, model, params, tparams, dparams
    free_engines(torch)
    return rows


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    if argv[:1] == ["--scans-ab"] and len(argv) == 2:
        return scans_ab(Path(argv[1]).resolve())
    if argv[:1] == ["--time-scans"] and len(argv) == 2:   # one turn of --scans-ab
        import_port(Path(argv[1]))
        torch.backends.cuda.matmul.allow_tf32 = False
        for row in time_scans(torch, Timer(torch), plain=False):
            print(json.dumps(row), flush=True)
        return 0
    if argv:
        print(f"chip_smoke.py: unknown arguments {argv}", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    import_port()
    smi = nvidia_smi()
    log("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0))
    # the plain versions run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    timer = Timer(torch)
    mmr = phase_matmul(torch, timer)
    far = phase_attention(torch, timer)
    scr = phase_scans(torch, timer)
    phase_prime_matmul(torch, timer)
    grr = phase_grouped(torch, timer)
    chunk = phase_chunk_kernels(torch, timer)
    tuning, tuned_db = phase_tuning(torch, timer)
    del timer
    torch.cuda.empty_cache()
    srv = [phase_serve(torch, arch) for arch in SERVE_KERNELS]
    tuned = phase_serve_tuned(torch, tuned_db, next(r for r in srv if r["arch"] == TUNED_ARCH))
    paged = phase_paged(torch, srv)
    spec = phase_spec(torch)
    fleet = phase_fleet(torch, tuned_db, srv)
    # main-path runs, counts read apart
    paths = {"slot": srv, "paged": paged, "spec": [spec], "fleet": fleet}

    def count(r, name, body=None):   # one run's launches of a kernel (of one body)
        if body is None:
            return r["launches"][name]
        return sum(c for key, c in r["body_launches"].items() if key.startswith(f"{name}/{body}/"))

    def by_path(name, body=None):
        return {path: sum(count(r, name, body) for r in rs) for path, rs in paths.items()}

    def served(name, body=None):   # launches summed over the main-path runs
        return sum(by_path(name, body).values())

    def timed(row, keys):
        return {"shape": {k: row[k] for k in keys},
                **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}

    rep_mm = next(r for r in mmr["shapes"] if r["M"] == 4 and r["N"] == 256000)
    rep_fa = next(r for r in far["shapes"] if (r["arch"], r["S"]) == ("minitron-4b", 512))
    # the rows body at decode: K1's q/o projection at 4 slots
    dec_mm = next(r for r in mmr["shapes"] if (r["M"], r["K"], r["N"]) == (4, 3072, 3072))
    rep_rw = scr["rwkv6"]["shapes"][0]
    rep_rg = scr["rglru"]["shapes"][0]
    rep_gr = next(r for r in grr["shapes"] if r["M"] == MOE_ROWS[0] and r["class"] == "moe_gemm")
    # the tensor-core body at prefill: K1's q/o projection, K1g's down-GEMM
    pre_mm = next(r for r in mmr["shapes"] if (r["M"], r["K"], r["N"]) == (256, 3072, 3072))
    pre_gr = next(r for r in grr["shapes"] if r["M"] == MOE_ROWS[1] and r["class"] == "moe_gemm")
    # rounding mode, at the launch the registry-served path makes
    if tuned["rounding_record"]["shape"] != list(ROUND_SERVED):
        raise AssertionError(f"the served rounding launch {tuned['rounding_record']} is not "
                             f"among the timed cases {ROUND_SERVED}")
    rep_round = next(r for r in mmr["rounding"]
                     if (r["class"], r["M"], r["K"], r["N"], r["round_k"]) == ROUND_SERVED)
    kernels = [
        {"name": "matmul", "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "launches": served("matmul"),
         "max_abs_err": mmr["max_abs_err"], **timed(rep_mm, ("class", "M", "K", "N", "split_k", "ctas"))},
        {"name": "matmul_decode", "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "body": "rows",
         "launches": served("matmul", "rows"), "max_abs_err": mmr["max_abs_err"],
         **timed(dec_mm, ("class", "M", "K", "N", "split_k", "ctas"))},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:126",
         "body": "mma", "launches": served("flash_attention"), "max_abs_err": far["max_abs_err"],
         **timed(rep_fa, ("B", "Hq", "Hkv", "S", "D", "ctas"))},
        {"name": "rwkv6_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
         "replaces": "src/repro/kernels/rwkv6_scan.py:86", "launches": served("rwkv6_scan"),
         "max_abs_err": scr["rwkv6"]["max_abs_err"], "device_ms": rep_rw["device_ms"],
         **timed(rep_rw, ("B", "H", "T", "D", "ctas"))},
        {"name": "rglru_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:65", "launches": served("rglru_scan"),
         "max_abs_err": scr["rglru"]["max_abs_err"], "device_ms": rep_rg["device_ms"],
         **timed(rep_rg, ("B", "T", "C", "ctas"))},
        {"name": "grouped_matmul", "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:236", "launches": served("grouped_matmul"),
         "body": "rows", "max_abs_err": grr["max_abs_err"],
         **timed(rep_gr, ("class", "E", "M", "K", "N", "split_k", "ctas"))},
        {"name": "matmul_prefill", "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "body": "mma",
         "launches": served("matmul", "mma"), "max_abs_err": mmr["max_abs_err"],
         **timed(pre_mm, ("class", "M", "K", "N", "cta_tile", "ctas"))},
        {"name": "grouped_matmul_prefill", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:236", "body": "mma",
         "launches": served("grouped_matmul", "mma"), "max_abs_err": grr["max_abs_err"],
         **timed(pre_gr, ("class", "E", "M", "K", "N", "cta_tile", "ctas"))},
        {"name": "matmul_kstep_round", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "body": rep_round["body"],
         "launches": sum(tuned["round_launches"].values()),
         "max_abs_err": max(r["max_abs_err"] for r in mmr["rounding"] + grr["rounding"]),
         **timed(rep_round, ("class", "M", "K", "N", "round_k"))},
        {"name": "flash_attention_chunk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:126", "body": "mma",
         "launches": sum(r["attention_offset_launches"] for r in paged),
         "max_abs_err": chunk["attention"]["max_abs_err"],
         **{k: chunk["attention"][k] for k in ("device_ms", "library_device_ms")},
         **timed(chunk["attention"], ("B", "Hq", "Hkv", "C", "KV", "D", "q_offset", "ctas"))},
        {"name": "matmul_chunk", "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "body": "mma",
         "launches": sum(c for r in paged for key, c in r["chunk_body_launches"].items()
                         if key.startswith("matmul/mma/")),
         "max_abs_err": chunk["matmul"]["max_abs_err"],
         **{k: chunk["matmul"][k] for k in ("device_ms", "library_device_ms")},
         **timed(chunk["matmul"], ("class", "M", "K", "N", "cta_tile", "ctas"))},
    ]
    # each kernel's launches per path (slot engine, paged, spec)
    for row in kernels:
        if row["name"] in ("matmul", "flash_attention", "rwkv6_scan", "rglru_scan",
                           "grouped_matmul"):
            row["launches_by_path"] = by_path(row["name"])
        elif row["name"] in ("matmul_decode", "matmul_prefill", "grouped_matmul_prefill"):
            row["launches_by_path"] = by_path(row["name"].removesuffix("_decode")
                                              .removesuffix("_prefill"), row["body"])
    print(json.dumps({"tuning": tuning}))
    log("done", seconds=time.monotonic() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
