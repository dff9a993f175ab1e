#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit.  Phases, one result line each:

1. device — the card's name and power limit (nvidia-smi);
2. build  — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``;
3. matmul — the matmul kernel against its plain version: every epilogue class
   at small ragged shapes (bf16 and f32), then minitron-4b's main-path shapes,
   timed beside the plain version and ``torch.matmul``, and under both the
   default schedule and 64x64 output tiles;
4. attention — the flash-attention kernel against its plain version: causal,
   window, softcap, q_offset, GQA groups 1 and 3, ragged lengths, head dims
   16 to 256, then the main-path prefill shapes, timed beside the plain
   version and ``F.scaled_dot_product_attention``;
5. scans — the rwkv6 (wkv6) and RG-LRU scan kernels against their plain
   versions, bf16 and f32, from a non-zero initial state: decode (T = 1), a
   prime T (default T tile 1), T = 256 under T tiles 2, 8, 64 and the
   default (y and state bit-identical across tiles), head dims 16 and 64,
   1 and 3 heads, 2560 channels and a ragged 12 under a tile of 8, and
   state continuation (two scans from the returned state equal one, bit for
   bit); then the main-path shapes timed beside the plain versions;
6. grouped — the grouped (MoE expert) matmul kernel against its plain
   version in both classes (``moe_gemm_silu_glu``, ``moe_gemm``), bf16 and
   f32: 1, 3 and 8 experts, decode-shaped 4 rows per expert, a ragged row
   count under a tile that does not divide it (rows and tiled bodies), N
   not a multiple of 8, N-outer schedules; then mixtral-8x22b's main-path
   shapes (4 and 256 rows per expert) timed beside the plain version and
   ``torch.bmm`` (for ``moe_gemm``; no one call computes the GLU class);
7. serve — minitron-4b, rwkv6-1.6b and recurrentgemma-2b at full width and
   full depth, and mixtral-8x22b at full width with 8 of its 56 layers (at
   full depth its bf16 weights, ~280 GB, fit no one card); bf16, random
   weights from a seeded generator on the card, one arch after the other,
   each freed before the next loads: through
   ``repro_torch.launch.serve.main`` (``--preset full``; ``smoke`` for
   mixtral) and then the slot engine directly with 100-400-token prompts.
   Every request must finish with its token count, the launch counts of
   the arch's kernels must be above 0 (serve.main's as it counts them; the
   engine's set to 0 just before its run and read just after), and the
   kernel path's prefill logits must agree with the plain path's on the
   same weights, end to end and layer by layer (a MoE layer's tokens that
   the two paths route to different experts counted and left out).

Then one JSON line with every kernel's numbers, the nvidia-smi line, and the
last line ``{"ok": true, "device": {...}}``.  Any failure raises: the script
exits non-zero and prints no result.  Times come from CUDA events, each
launch after an L2 flush (the serving path reads weights cold).  Bounds use
the H100 SXM's published peaks: 3.35 TB/s, 989 TFLOP/s dense bf16 on the
tensor cores, and 67 TFLOP/s f32 on the CUDA cores for the scans, which run
no matrix product.
"""
from __future__ import annotations

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


def import_port():
    src = ROOT / "src"
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


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    path = _build.build()
    _build.library()
    usage = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=time.monotonic() - t0, library=path.name, ptxas=usage)


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
            del got, want
            # the same kernel under 64x64 output tiles, sized to fill the card's SMs
            cs64 = concretize(Schedule.make(class_id, {"M": 64, "N": 64, "K": cs.t["K"]}), cs.instance)
            err = max(err, assert_close(torch, mm.launch(x, w, cs64, class_id=class_id, **kw),
                                        ref.matmul(x, w, class_id, **kw), BF16_TOL, "64x64 tiles"))
            b_ms, b_by = bound_ms(2 * (m * k + k * n + m * n), 2 * m * n * k)
            row = {"class": class_id, "M": m, "K": k, "N": n,
                   "tiles": cs.t, "ctas": cs.g["M"] * cs.g["N"], "max_abs_err": err,
                   "ms": timer.ms(lambda: mm.launch(x, w, cs, class_id=class_id, **kw)),
                   "tile64_ctas": cs64.g["M"] * cs64.g["N"],
                   "tile64_ms": timer.ms(lambda: mm.launch(x, w, cs64, class_id=class_id, **kw)),
                   "plain_ms": timer.ms(lambda: ref.matmul(x, w, class_id, **kw)),
                   # one library call computes the same function only without an epilogue
                   "library_ms": (timer.ms(lambda: torch.matmul(x, w))
                                  if class_id != "matmul_bias_gelu" else None),
                   "bound_ms": b_ms, "bound_by": b_by}
            shapes.append(row)
            log("matmul_shape", **row)
            del x, w
    torch.cuda.empty_cache()
    return {"shapes": shapes, "max_abs_err": max([errs[n] for n in errs] + [r["max_abs_err"] for r in shapes])}


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
            got = fa.launch(q, k, v, cs, **kw)
            want = ref.chunked_attention(q, k, v, chunk=cs.t["KV"], **kw)
            name = f"{ops.dtype_name(dtype)}/g{group}/{sq}x{skv}/d{d}/{kw}"
            errs[name] = assert_close(torch, got, want, tol, name)
    log("attention_masks", checks=len(errs), max_abs_err=max(errs.values()), tol=BF16_TOL,
        f32_tol=F32_TOL)

    shapes = []
    b, hq, hkv, d = 1, 24, 8, 128
    for s in (128, 512):
        q, k, v = _attn_inputs(torch, g, b, hq, hkv, s, s, d, torch.bfloat16)
        cs = ops.schedule_for(ops.instance("flash_attention_causal", torch.bfloat16, Q=s, KV=s,
                                           H=hq, D=d, B=b, window=0))
        got = fa.launch(q, k, v, cs)
        want = ref.chunked_attention(q, k, v, chunk=cs.t["KV"])
        err = assert_close(torch, got, want, BF16_TOL, f"attention S={s}")
        # the yardstick takes GQA expanded to Hq heads (expansion outside the timing)
        ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
        live = s * (s + 1) / 2            # causal (q, k) pairs this input needs
        flops = 4 * b * hq * live * d
        nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
        b_ms, b_by = bound_ms(nbytes, flops)
        row = {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "tiles": cs.t,
               "ctas": b * hq * cs.g["Q"], "max_abs_err": err,
               "ms": timer.ms(lambda: fa.launch(q, k, v, cs), iters=20),
               "plain_ms": timer.ms(lambda: ref.chunked_attention(q, k, v, chunk=cs.t["KV"])),
               "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                   q, ke, ve, is_causal=True), iters=20),
               "bound_ms": b_ms, "bound_by": b_by}
        shapes.append(row)
        log("attention_shape", **row)
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


def phase_scans(torch, timer) -> dict:
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    g = torch.Generator(device="cuda").manual_seed(3)

    def rw_cs(dtype, b, h, t, d, tile_t=None):
        inst = ops.instance("rwkv6_scan", dtype, T=t, C=h * d, D=d, B=b)
        if tile_t is None:
            return ops.schedule_for(inst)
        return concretize(Schedule.make("rwkv6_scan", {"T": tile_t, "C": h * d},
                                        order=("C", "T")), inst)

    def rg_cs(dtype, b, t, c, tile_t=None, tile_c=None):
        inst = ops.instance("rglru_scan", dtype, T=t, C=c, B=b)
        if tile_t is None and tile_c is None:
            return ops.schedule_for(inst)
        dflt = ops.schedule_for(inst).t
        return concretize(Schedule.make("rglru_scan", {"T": tile_t or dflt["T"],
                                                       "C": tile_c or dflt["C"]},
                                        order=("C", "T")), inst)

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

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        dn = ops.dtype_name(dtype)
        # K3: decode, prime T (default T tile 1), head dims 16/64, 1 and 3 heads
        for b, h, t, d, near in ((2, 1, 1, 16, False), (4, 3, 1, 64, True),
                                 (1, 3, 97, 64, False), (2, 1, 97, 16, True),
                                 (1, 3, 256, 16, True)):
            check("rwkv6", f"rwkv6/{dn}/{b}x{h}x{t}x{d}",
                  _rw_inputs(torch, g, b, h, t, d, dtype, near), rw_cs(dtype, b, h, t, d), tol)
        b, h, t, d = 1, 3, 256, 64
        x = _rw_inputs(torch, g, b, h, t, d, dtype)
        full = check("rwkv6", f"rwkv6/{dn}/T{t}/default", x, rw_cs(dtype, b, h, t, d), tol)
        for ct in (2, 8, 64):
            same(check("rwkv6", f"rwkv6/{dn}/T{t}/tile{ct}", x, rw_cs(dtype, b, h, t, d, ct), tol),
                 full, f"rwkv6 {dn} T tile {ct}")
        t1 = 100   # continuation: [0:t1], then [t1:T] from the returned state
        r, k, v, w, u, s0 = x
        part = [z[:, :, :t1].contiguous() for z in (r, k, v, w)]
        rest = [z[:, :, t1:].contiguous() for z in (r, k, v, w)]
        ya, sa = check("rwkv6", f"rwkv6/{dn}/cont1", (*part, u, s0), rw_cs(dtype, b, h, t1, d), tol)
        yb, sb = check("rwkv6", f"rwkv6/{dn}/cont2", (*rest, u, sa), rw_cs(dtype, b, h, t - t1, d), tol)
        same((torch.cat([ya, yb], dim=2), sb), full, f"rwkv6 {dn} state continuation")

        # K4: decode, prime T, full width under the default C tile, a C tile
        # above 1024 threads, a ragged C under a tile of 8
        for b, t, c, tile_c in ((2, 1, 2560, None), (4, 1, 2560, None), (1, 97, 2560, None),
                                (1, 64, 2560, 2560), (2, 33, 12, None), (2, 33, 12, 8)):
            check("rglru", f"rglru/{dn}/{b}x{t}x{c}/c{tile_c}", _rg_inputs(torch, g, b, t, c, dtype),
                  rg_cs(dtype, b, t, c, tile_c=tile_c), tol)
        b, t, c = 1, 256, 2560
        x = _rg_inputs(torch, g, b, t, c, dtype)
        full = check("rglru", f"rglru/{dn}/T{t}/default", x, rg_cs(dtype, b, t, c), tol)
        for ct in (2, 8, 64):
            same(check("rglru", f"rglru/{dn}/T{t}/tile{ct}", x, rg_cs(dtype, b, t, c, tile_t=ct), tol),
                 full, f"rglru {dn} T tile {ct}")
        xs, a, h0 = x
        ya, ha = check("rglru", f"rglru/{dn}/cont1", (xs[:, :t1].contiguous(), a[:, :t1].contiguous(), h0),
                       rg_cs(dtype, b, t1, c), tol)
        yb, hb = check("rglru", f"rglru/{dn}/cont2", (xs[:, t1:].contiguous(), a[:, t1:].contiguous(), ha),
                       rg_cs(dtype, b, t - t1, c), tol)
        same((torch.cat([ya, yb], dim=1), hb), full, f"rglru {dn} state continuation")
    for kind in errs:
        log(f"{kind}_checks", checks=len(errs[kind]), max_abs_err=max(errs[kind].values()),
            tol=BF16_TOL, f32_tol=F32_TOL, state_tol=STATE_TOL)

    # main-path shapes, bf16: prefill (a bucket-sized and a prime T) and 4-slot decode
    out = {"rwkv6": [], "rglru": []}
    for b, h, t, d, tile_t in ((1, 32, 256, 64, None), (4, 32, 1, 64, None),
                               (1, 32, 397, 64, None), (1, 32, 397, 64, 397)):
        x = _rw_inputs(torch, g, b, h, t, d, torch.bfloat16, near_one=True)
        cs = rw_cs(torch.bfloat16, b, h, t, d, tile_t)
        y, s = rw.launch(*x, cs)
        yr, sr = ref.rwkv6_scan(*x)
        err = max(assert_close(torch, y, yr, BF16_TOL, "rwkv6 main shape"),
                  assert_close(torch, s, sr, STATE_TOL, "rwkv6 main shape state"))
        nbytes = 5 * b * h * t * d * 2 + h * d * 4 + 2 * b * h * d * d * 4
        b_ms, b_by = bound_ms(nbytes, 7 * b * h * t * d * d, F32_CUDA_CORE_FLOPS)
        row = {"B": b, "H": h, "T": t, "D": d, "tiles": cs.t, "ctas": b * h, "max_abs_err": err,
               "ms": timer.ms(lambda: rw.launch(*x, cs)),
               "plain_ms": timer.ms(lambda: ref.rwkv6_scan(*x), iters=5),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        out["rwkv6"].append(row)
        log("rwkv6_shape", **row)
    for b, t, c in ((1, 256, 2560), (4, 1, 2560), (1, 397, 2560)):
        x = _rg_inputs(torch, g, b, t, c, torch.bfloat16)
        cs = rg_cs(torch.bfloat16, b, t, c)
        y, s = rg.launch(*x, cs)
        yr, sr = ref.rglru_scan(*x)
        err = max(assert_close(torch, y, yr, BF16_TOL, "rglru main shape"),
                  assert_close(torch, s, sr, STATE_TOL, "rglru main shape state"))
        b_ms, b_by = bound_ms(3 * b * t * c * 2 + 2 * b * c * 4, 7 * b * t * c, F32_CUDA_CORE_FLOPS)
        row = {"B": b, "T": t, "C": c, "tiles": cs.t, "ctas": b * cs.g["C"], "max_abs_err": err,
               "ms": timer.ms(lambda: rg.launch(*x, cs)),
               "plain_ms": timer.ms(lambda: ref.rglru_scan(*x), iters=5),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        out["rglru"].append(row)
        log("rglru_shape", **row)
    for kind in out:
        out[kind] = {"shapes": out[kind],
                     "max_abs_err": max([*errs[kind].values(), *(r["max_abs_err"] for r in out[kind])])}
    return out


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
        row = {"class": class_id, "M": m, "K": k, "N": n, "tiles": cs.t,
               "ctas": cs.g["M"] * cs.g["N"], "max_abs_err": err,
               "ms": timer.ms(lambda: mm.launch(x, w, cs, class_id=class_id, **kw), iters=5),
               "tile64_ctas": cs64.g["M"] * cs64.g["N"],
               "tile64_ms": timer.ms(lambda: mm.launch(x, w, cs64, class_id=class_id, **kw), iters=5),
               "plain_ms": timer.ms(lambda: ref.matmul(x, w, class_id, **kw), iters=5),
               "bound_ms": b_ms, "bound_by": b_by}
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

    def matmul64(x, w, class_id="matmul", **kw):
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
            err = assert_close(torch, mm.grouped_launch(x, w, cs, class_id=class_id),
                               ref.grouped_matmul(x, w, class_id), BF16_TOL,
                               f"{class_id} {e}x{m}x{k}x{n}")
            n_out = n // 2 if class_id == "moe_gemm_silu_glu" else n
            b_ms, b_by = bound_ms(2 * e * (m * k + k * n + m * n_out), 2 * e * m * n * k)
            *_, tile_m, tile_n = mm.grouped_geometry(x, w, cs, class_id)
            iters = 10 if m <= 16 else 5
            row = {"class": class_id, "E": e, "M": m, "K": k, "N": n,
                   "tiles": {"M": tile_m, "N": tile_n},
                   "ctas": e * -(-m // tile_m) * -(-n // tile_n), "max_abs_err": err,
                   "ms": timer.ms(lambda: mm.grouped_launch(x, w, cs, class_id=class_id), iters=iters),
                   "plain_ms": timer.ms(lambda: ref.grouped_matmul(x, w, class_id), iters=iters),
                   # one library call computes the same function only without the GLU
                   "library_ms": (timer.ms(lambda: torch.bmm(x, w), iters=iters)
                                  if class_id == "moe_gemm" else None),
                   "bound_ms": b_ms, "bound_by": b_by}
            shapes.append(row)
            log("grouped_shape", **row)
            del x, w
            torch.cuda.empty_cache()
    return {"shapes": shapes, "max_abs_err": max([*errs.values(), *(r["max_abs_err"] for r in shapes)])}


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


def phase_serve(torch, arch: str) -> dict:
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.kernels.ops import use_backend
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    cfg = get_arch(arch)
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

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
    # minitron; the launch counts are set to 0 just before it, read just after
    model = build_model(cfg, "cuda")
    params = model.init(seed=0)
    engine = ServingEngine(model, params, slots=4, max_len=512)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, size=int(n))]
               for n in rng.integers(100, 401, size=8)]
    new_tokens = 16
    pending, done = list(prompts), []
    for kmod in (mm, fa, rw, rg):
        kmod.reset_launches()
    prefill_s = decode_s = 0.0
    steps = 0
    while pending or engine.active:
        while pending and engine.free_slots:
            t0 = time.monotonic()
            req = engine.add_request(pending.pop(0), max_new_tokens=new_tokens)
            prefill_s += time.monotonic() - t0     # add_request syncs on its argmax
            if req.done:
                done.append(req)
        t0 = time.monotonic()
        done.extend(engine.step())                 # step syncs on its argmax
        decode_s += time.monotonic() - t0
        steps += 1
        if steps > 1000:
            raise AssertionError("the slot engine did not converge")
    torch.cuda.synchronize()
    launches = serve.kernel_launches()
    if len(done) != len(prompts) or any(len(r.generated) != new_tokens for r in done):
        raise AssertionError(f"engine finished {len(done)} requests with token counts "
                             f"{[len(r.generated) for r in done]}")
    if min(launches[k] for k in SERVE_KERNELS[arch]) <= 0:
        raise AssertionError(f"{arch}: a kernel of the main path was never launched: {launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = sum(len(r.generated) for r in done)

    # kernel path vs plain path on the same weights: the first prompt's
    # prefill, end to end and layer by layer
    toks = torch.tensor([prompts[0]], dtype=torch.long, device="cuda")
    logits_k, _ = model.prefill(params, {"tokens": toks}, max_len=512)
    with use_backend("ref"):
        logits_r, _ = model.prefill(params, {"tokens": toks}, max_len=512)
        with f64_accumulation():
            logits_c, _ = model.prefill(params, {"tokens": toks}, max_len=512)
    torch.cuda.synchronize()
    if tuple(logits_k.shape) != (1, cfg.vocab_size) or not bool(torch.isfinite(logits_k).all()):
        raise AssertionError(f"prefill logits: shape {tuple(logits_k.shape)} or non-finite")
    diff = max_err(torch, logits_k, logits_r)
    control = max_err(torch, logits_c, logits_r)
    scale = float(logits_r.float().abs().max())
    bound = max(LOGITS_REL_BOUND * scale, CONTROL_FACTOR * control)
    if diff > bound:
        raise AssertionError(f"{arch}: prefill logits differ by {diff} > {bound} "
                             f"(max |logit| {scale}, control {control})")
    layers = layerwise_rel_err(torch, model, params, toks)
    layer_err = layers["checked"]
    if max(layer_err) > LAYER_REL_BOUND:
        raise AssertionError(f"{arch}: a layer's output differs by {max(layer_err)} "
                             f"> {LAYER_REL_BOUND} (per layer: {layers})")
    row = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": cfg.param_count(),
           "serve_main": {k: res[k] for k in ("preset", "requests", "tokens", "decode_steps",
                                               "tok_per_s", "kernel_launches")},
           "requests": len(done), "tokens": tokens, "prompt_lens": [len(p) for p in prompts],
           "decode_steps": steps, "prefill_s": prefill_s, "decode_s": decode_s,
           "decode_ms_per_step": 1e3 * decode_s / steps,
           "tok_per_s": tokens / (prefill_s + decode_s),
           "decode_tok_per_s": (tokens - len(done)) / decode_s,
           "launches": launches, "peak_mem_gib": peak_gib,
           "logits_max_abs_diff": diff, "logits_max_abs": scale,
           "logits_control": control, "logits_bound": bound,
           "argmax_equal": int(logits_k.argmax()) == int(logits_r.argmax()),
           "layer_rel_err_max": max(layer_err), "layer_rel_err": layer_err,
           "layer_block_rel_err": layers["block"],
           "layer_routed_alike_rel_err": layers["routed_alike"],
           "layer_route_flips": layers["route_flips"]}
    log("serve", **row)
    del model, params, engine, logits_k, logits_r, logits_c
    torch.cuda.empty_cache()
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
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
    del timer
    torch.cuda.empty_cache()
    srv = [phase_serve(torch, arch) for arch in SERVE_KERNELS]

    def served(name):   # launches summed over the serve phases
        return sum(r["launches"][name] for r in srv)

    def timed(row, keys):
        return {"shape": {k: row[k] for k in keys},
                **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}

    rep_mm = next(r for r in mmr["shapes"] if r["M"] == 4 and r["N"] == 256000)
    rep_fa = next(r for r in far["shapes"] if r["S"] == 512)
    rep_rw = scr["rwkv6"]["shapes"][0]
    rep_rg = scr["rglru"]["shapes"][0]
    rep_gr = next(r for r in grr["shapes"] if r["M"] == MOE_ROWS[0] and r["class"] == "moe_gemm")
    kernels = [
        {"name": "matmul", "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "launches": served("matmul"),
         "max_abs_err": mmr["max_abs_err"], **timed(rep_mm, ("class", "M", "K", "N"))},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:126",
         "launches": served("flash_attention"), "max_abs_err": far["max_abs_err"],
         **timed(rep_fa, ("B", "Hq", "Hkv", "S", "D"))},
        {"name": "rwkv6_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
         "replaces": "src/repro/kernels/rwkv6_scan.py:86", "launches": served("rwkv6_scan"),
         "max_abs_err": scr["rwkv6"]["max_abs_err"], **timed(rep_rw, ("B", "H", "T", "D"))},
        {"name": "rglru_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:65", "launches": served("rglru_scan"),
         "max_abs_err": scr["rglru"]["max_abs_err"], **timed(rep_rg, ("B", "T", "C"))},
        {"name": "grouped_matmul", "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:236", "launches": served("grouped_matmul"),
         "max_abs_err": grr["max_abs_err"], **timed(rep_gr, ("class", "E", "M", "K", "N"))},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
