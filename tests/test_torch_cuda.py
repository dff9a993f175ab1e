"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need a CUDA card and nvcc, and skip where there is
none.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

f32 at rtol = atol = 2e-4 (the repo's f32 kernel tolerance), bf16 outputs
at 3e-2 (one bf16 rounding of f32 values computed in another order; the
scans' f32 states stay at 2e-4); the plain versions run in full
f32 (TF32 off).  This file imports no JAX: the card's machine need not have
it.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.kernels.ops import use_backend
from repro_torch.launch.serve import kernel_launches
from repro_torch.models import build_model
from repro_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda
TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    try:
        _build.nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    return torch.device("cuda")


def _close(got, want, tol=TOL):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("class_id", ref.MATMUL_CLASSES)
@pytest.mark.parametrize("m,n,k", [(4, 64, 96), (3, 50, 17), (4, 1000, 64), (96, 80, 40),
                                   (70, 200, 33), (130, 96, 300)])
def test_matmul_kernel_matches_plain(card, dtype, class_id, m, n, k):
    """Rows body (M <= 16) and, above 16 rows, the tensor-core body (bf16) or
    the CUDA-core body (f32), at ragged M, N and K, with K or N not a
    multiple of 8 (rows of x or w not on 16 bytes)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(m + n + k)
    x = torch.randn((m, k), generator=g, device=card).to(dt)
    w = (torch.randn((k, n), generator=g, device=card) / k ** 0.5).to(dt)
    bias = torch.randn((n,), generator=g, device=card).to(dt) if "bias" in class_id else None
    out_n = n // 2 if "glu" in class_id else n
    residual = torch.randn((m, out_n), generator=g, device=card).to(dt) \
        if class_id == "matmul_residual" else None
    softcap = 2.0 if "softcap" in class_id else 0.0
    kw = dict(class_id=class_id, bias=bias, residual=residual, softcap=softcap)
    body = mm.body_for(dt, ops.schedule_for(ops.instance(class_id, dt, M=m, N=n, K=k)).t["M"])
    before, total, ours = mm.launches, mm.body_count(), mm.body_count(body, kernel="matmul", dtype=dt)
    got = ops.matmul(x, w, **kw)
    assert mm.launches == before + 1
    assert mm.body_count() == total + 1
    assert mm.body_count(body, kernel="matmul", dtype=dt) == ours + 1
    _close(got, ops.matmul(x, w, backend="ref", **kw), TOL if dt == torch.float32 else BF16_TOL)


# (b, hkv, group, sq, skv, d, causal, window, softcap, q_offset): ragged
# lengths, head dims 16 / 64 / 80 / 128 / 256 (padded to the compiled
# widths), every mask; then the main path's heads: minitron 24/8 x 128,
# mixtral 48/8 x 128 (window 4096), recurrentgemma 10/1 x 256 (window 2048)
ATTN_CASES = [
    (2, 2, 2, 40, 40, 16, True, 0, 0.0, 0),
    (2, 2, 3, 33, 70, 64, True, 0, 0.0, 37),
    (2, 2, 1, 64, 64, 128, True, 16, 0.0, 0),
    (2, 2, 3, 50, 50, 128, False, 0, 0.0, 0),
    (2, 2, 2, 20, 20, 256, True, 0, 30.0, 0),
    (2, 2, 3, 1, 90, 80, True, 0, 0.0, 89),
    (1, 8, 3, 256, 256, 128, True, 0, 0.0, 0),
    (1, 8, 6, 200, 200, 128, True, 4096, 0.0, 0),
    (1, 1, 10, 181, 181, 256, True, 2048, 0.0, 0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hkv,group,sq,skv,d,causal,window,softcap,q_offset", ATTN_CASES)
def test_attention_kernel_matches_plain(card, dtype, b, hkv, group, sq, skv, d, causal, window,
                                        softcap, q_offset):
    """bf16 takes the tensor-core body, f32 the CUDA-core one; each against
    the plain version at its dtype's tolerance."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(sq + skv + d)
    q = torch.randn((b, hkv * group, sq, d), generator=g, device=card).to(dt)
    k = torch.randn((b, hkv, skv, d), generator=g, device=card).to(dt)
    v = torch.randn((b, hkv, skv, d), generator=g, device=card).to(dt)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    body = fa.body_for(dt)
    assert body == ("mma" if dt == torch.bfloat16 else "fma")
    before, ours = fa.launches, fa.body_count(body, dtype=dt)
    got = ops.flash_attention(q, k, v, **kw)
    assert fa.launches == before + 1
    assert fa.body_count(body, dtype=dt) == ours + 1
    _close(got, ref.attention(q, k, v, **kw), TOL if dt == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hkv,group,s,split,d,window", [(2, 3, 300, 100, 128, 0),
                                                         (2, 2, 260, 128, 64, 0),
                                                         (1, 4, 333, 190, 256, 70),
                                                         (2, 1, 150, 37, 80, 0)])
def test_attention_rows_do_not_depend_on_the_split(card, dtype, hkv, group, s, split, d, window):
    """A prompt attended in one call, and in two calls split at ``split``
    (the second with q_offset = split against all keys so far), gives the
    same bits row for row: chunks start at global multiples, rows are
    computed independently, and two runs agree."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(s + split + d)
    q = torch.randn((1, hkv * group, s, d), generator=g, device=card).to(dt)
    k = torch.randn((1, hkv, s, d), generator=g, device=card).to(dt)
    v = torch.randn((1, hkv, s, d), generator=g, device=card).to(dt)
    whole = ops.flash_attention(q, k, v, window=window)
    first = ops.flash_attention(q[:, :, :split], k[:, :, :split], v[:, :, :split], window=window)
    second = ops.flash_attention(q[:, :, split:], k, v, window=window, q_offset=split)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([first, second], dim=2), whole)
    assert torch.equal(ops.flash_attention(q, k, v, window=window), whole)
    _close(whole, ref.attention(q, k, v, window=window), TOL if dt == torch.float32 else BF16_TOL)


# (class, Hkv, GQA group, Sq, Skv, D, causal, window, softcap, q_offset):
# a prime Sq above 128 (default Q tile 1) or 253 (tile 23): recurrentgemma-2b's
# local attention, a window shorter than a 64-row CTA, softcap with GQA,
# q_offset > 0, and whisper-medium's cross-attention over 1500 frames
NARROW_Q_CASES = [
    ("flash_attention_local", 1, 10, 181, 181, 256, True, 2048, 0.0, 0),
    ("flash_attention_local", 1, 10, 253, 253, 256, True, 2048, 0.0, 0),
    ("flash_attention_causal", 2, 3, 181, 181, 128, True, 16, 0.0, 0),
    ("flash_attention_causal", 2, 2, 173, 173, 64, True, 0, 30.0, 0),
    ("flash_attention_causal", 2, 3, 139, 200, 80, True, 24, 0.0, 61),
    ("flash_attention_cross", 4, 1, 181, 1500, 64, False, 0, 0.0, 0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("class_id,hkv,group,sq,skv,d,causal,window,softcap,q_offset", NARROW_Q_CASES)
def test_grouped_q_tiles_keep_the_bits(card, dtype, class_id, hkv, group, sq, skv, d, causal,
                                       window, softcap, q_offset):
    """The default Q tile (1 at a prime Sq, 23 at 253) puts a group of
    narrow tiles in one CTA; its output and row log-sum-exp equal, bit for
    bit, those at a Q tile of Sq and of 64, where a CTA holds one tile:
    chunks start at global multiples and a chunk that masks all of a row
    leaves that row's state unchanged, so no row's bits depend on its CTA."""
    from repro_torch.core.schedule import Schedule, concretize

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(sq + skv + d)
    q = torch.randn((1, hkv * group, sq, d), generator=g, device=card).to(dt)
    k = torch.randn((1, hkv, skv, d), generator=g, device=card).to(dt)
    v = torch.randn((1, hkv, skv, d), generator=g, device=card).to(dt)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    inst = ops.instance(class_id, dt, Q=sq, KV=skv, H=hkv * group, D=d, B=1, window=window)
    dflt = ops.schedule_for(inst)
    tile = dflt.t["Q"]
    assert tile == (23 if sq == 253 else 1)
    outs = []
    for tile_q in (tile, sq, 64):
        cs = concretize(Schedule.make(class_id, {**dflt.t, "Q": tile_q}, order=dflt.order), inst)
        before = fa.grouped_tile_launches[tile_q]
        outs.append(fa.launch(q, k, v, cs, with_lse=True, **kw))
        grouped = fa.q_group(sq, tile_q, fa.CTA_Q[fa.body_for(dt)]) > 1
        assert fa.grouped_tile_launches[tile_q] == before + grouped
    assert fa.q_group(sq, tile, fa.MMA_CTA_Q) > 1
    for got in outs[1:]:
        _equal_bits(outs[0], got)
    _close(outs[0][0], ref.attention(q, k, v, **kw), TOL if dt == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,t,d", [(2, 1, 1, 16), (3, 2, 1, 64), (1, 3, 37, 64),
                                     (2, 2, 40, 16), (1, 1, 70, 32)])
def test_rwkv6_kernel_matches_plain(card, dtype, b, h, t, d):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(b + h + t + d)
    r, k, v = (torch.randn((b, h, t, d), generator=g, device=card).to(dt) for _ in range(3))
    w = (0.05 + 0.9 * torch.sigmoid(torch.randn((b, h, t, d), generator=g, device=card))).to(dt)
    u = torch.randn((h, d), generator=g, device=card)
    s0 = torch.randn((b, h, d, d), generator=g, device=card)
    before = rw.launches
    y, s = ops.rwkv6(r, k, v, w, u, s0)
    assert rw.launches == before + 1 and y.dtype == dt and s.dtype == torch.float32
    yr, sr = ref.rwkv6_scan(r, k, v, w, u, s0)
    _close(y, yr, TOL if dt == torch.float32 else BF16_TOL)
    _close(s, sr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,c,tile_c", [(2, 1, 64, None), (4, 1, 2560, None), (1, 23, 100, None),
                                          (2, 17, 12, 8), (1, 9, 1500, 1500)])
def test_rglru_kernel_matches_plain(card, dtype, b, t, c, tile_c):
    """Decode (T = 1), a ragged C under a tile of 8, a tile above 1024 threads."""
    from repro_torch.core.schedule import Schedule, concretize

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(b + t + c)
    x = torch.randn((b, t, c), generator=g, device=card).to(dt)
    a = torch.sigmoid(torch.randn((b, t, c), generator=g, device=card)).to(dt)
    h0 = torch.randn((b, c), generator=g, device=card)
    cs = ops.schedule_for(ops.instance("rglru_scan", dt, T=t, C=c, B=b))
    if tile_c is not None:
        cs = concretize(Schedule.make("rglru_scan", {"T": cs.t["T"], "C": tile_c}), cs.instance)
    before = rg.launches
    y, h = rg.rglru_scan(x, a, h0, cs)
    assert rg.launches == before + 1 and y.dtype == dt and h.dtype == torch.float32
    yr, hr = ref.rglru_scan(x, a, h0)
    _close(y, yr, TOL if dt == torch.float32 else BF16_TOL)
    _close(h, hr)


def _scan_cs(class_id, dt, tiles=None, **dims):
    from repro_torch.core.schedule import Schedule, concretize

    inst = ops.instance(class_id, dt, **dims)
    if tiles is None:
        return ops.schedule_for(inst)
    return concretize(Schedule.make(class_id, {**ops.schedule_for(inst).t, **tiles},
                                    order=("C", "T")), inst)


def _equal_bits(got, want):
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(got, want))


SCAN_CONTRACTS = ("t_tiles", "continuation", "decode_steps", "batch_row", "two_runs")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("contract", SCAN_CONTRACTS)
def test_rwkv6_kernel_bit_contracts(card, dtype, contract):
    """y and the state bit for bit: under T tiles 1, 8 and T; split at t1
    (mid-stage) and continued from the returned state; the last 3 tokens
    as one-token (decode) steps after the rest; a batch row at B = 1
    against B = 4; two runs."""
    dt = getattr(torch, dtype)
    b, h, t, d, t1 = 4, 2, 72, 64, 20
    g = torch.Generator(device=card).manual_seed(11)
    r, k, v = (torch.randn((b, h, t, d), generator=g, device=card).to(dt) for _ in range(3))
    w = (0.05 + 0.9 * torch.sigmoid(torch.randn((b, h, t, d), generator=g, device=card))).to(dt)
    u = torch.randn((h, d), generator=g, device=card)
    s0 = torch.randn((b, h, d, d), generator=g, device=card)
    cs = lambda b=b, t=t, tiles=None: _scan_cs("rwkv6_scan", dt, tiles, T=t, C=h * d, D=d, B=b)
    whole = rw.launch(r, k, v, w, u, s0, cs())
    if contract == "t_tiles":
        for tile in (1, 8, t):
            _equal_bits(rw.launch(r, k, v, w, u, s0, cs(tiles={"T": tile})), whole)
    elif contract == "continuation":
        ya, sa = rw.launch(*(z[:, :, :t1].contiguous() for z in (r, k, v, w)), u, s0, cs(t=t1))
        yb, sb = rw.launch(*(z[:, :, t1:].contiguous() for z in (r, k, v, w)), u, sa, cs(t=t - t1))
        _equal_bits((torch.cat([ya, yb], dim=2), sb), whole)
    elif contract == "decode_steps":
        ys, st = [], s0
        for lo, hi in ((0, t - 3), (t - 3, t - 2), (t - 2, t - 1), (t - 1, t)):
            yi, st = rw.launch(*(z[:, :, lo:hi].contiguous() for z in (r, k, v, w)), u, st, cs(t=hi - lo))
            ys.append(yi)
        _equal_bits((torch.cat(ys, dim=2), st), whole)
    elif contract == "batch_row":
        one = rw.launch(*(z[1:2].contiguous() for z in (r, k, v, w)), u, s0[1:2].contiguous(), cs(b=1))
        _equal_bits(one, (whole[0][1:2], whole[1][1:2]))
    else:
        _equal_bits(rw.launch(r, k, v, w, u, s0, cs()), whole)
    yr, sr = ref.rwkv6_scan(r, k, v, w, u, s0)
    _close(whole[0], yr, TOL if dt == torch.float32 else BF16_TOL)
    _close(whole[1], sr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("contract", SCAN_CONTRACTS + ("c_tiles",))
@pytest.mark.parametrize("c", [2560, 100])
def test_rglru_kernel_bit_contracts(card, dtype, contract, c):
    """y and the state bit for bit: under T tiles 1, 8 and T; under C tiles
    8, 512 and C; split at t1 and continued from the returned state; the
    last 3 tokens as one-token (decode) steps after the rest; a batch row at
    B = 1 against B = 4; two runs.  C = 100 takes the element-wise staging
    (rows not in whole 16-byte chunks)."""
    dt = getattr(torch, dtype)
    b, t, t1 = 4, 72, 40
    g = torch.Generator(device=card).manual_seed(12)
    x = torch.randn((b, t, c), generator=g, device=card).to(dt)
    a = torch.sigmoid(torch.randn((b, t, c), generator=g, device=card)).to(dt)
    h0 = torch.randn((b, c), generator=g, device=card)
    cs = lambda b=b, t=t, tiles=None: _scan_cs("rglru_scan", dt, tiles, T=t, C=c, B=b)
    whole = rg.launch(x, a, h0, cs())
    if contract == "t_tiles":
        for tile in (1, 8, t):
            _equal_bits(rg.launch(x, a, h0, cs(tiles={"T": tile})), whole)
    elif contract == "c_tiles":
        for tile in (8, 512, c):
            _equal_bits(rg.launch(x, a, h0, cs(tiles={"C": tile})), whole)
    elif contract == "continuation":
        ya, ha = rg.launch(x[:, :t1].contiguous(), a[:, :t1].contiguous(), h0, cs(t=t1))
        yb, hb = rg.launch(x[:, t1:].contiguous(), a[:, t1:].contiguous(), ha, cs(t=t - t1))
        _equal_bits((torch.cat([ya, yb], dim=1), hb), whole)
    elif contract == "decode_steps":
        ys, hs = [], h0
        for lo, hi in ((0, t - 3), (t - 3, t - 2), (t - 2, t - 1), (t - 1, t)):
            yi, hs = rg.launch(x[:, lo:hi].contiguous(), a[:, lo:hi].contiguous(), hs, cs(t=hi - lo))
            ys.append(yi)
        _equal_bits((torch.cat(ys, dim=1), hs), whole)
    elif contract == "batch_row":
        one = rg.launch(x[2:3].contiguous(), a[2:3].contiguous(), h0[2:3].contiguous(), cs(b=1))
        _equal_bits(one, (whole[0][2:3], whole[1][2:3]))
    else:
        _equal_bits(rg.launch(x, a, h0, cs()), whole)
    yr, hr = ref.rglru_scan(x, a, h0)
    _close(whole[0], yr, TOL if dt == torch.float32 else BF16_TOL)
    _close(whole[1], hr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("class_id", ref.GROUPED_CLASSES)
@pytest.mark.parametrize("e,m,n,k,tile_m", [(1, 6, 64, 40, None), (3, 20, 48, 33, None),
                                            (8, 4, 96, 64, None), (8, 300, 64, 32, None),
                                            (3, 13, 50, 24, 8), (8, 256, 1024, 512, None)])
def test_grouped_kernel_matches_plain(card, dtype, class_id, e, m, n, k, tile_m):
    """E = 1/3/8, decode-shaped m = 4, m = 300 under the default tile of 120
    (ragged inside each expert, tensor-core or CUDA-core body), 13 under a
    rows-body tile of 8, a prefill's 256 rows per expert under the default
    schedule."""
    from repro_torch.core.schedule import Schedule, concretize

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(e + m + n + k)
    x = torch.randn((e, m, k), generator=g, device=card).to(dt)
    w = (torch.randn((e, k, n), generator=g, device=card) / k ** 0.5).to(dt)
    cs = ops.schedule_for(ops.instance(class_id, dt, M=m * e, N=n, K=k, E=e))
    if tile_m is not None:
        cs = concretize(Schedule.make(class_id, {"M": tile_m, "N": cs.t["N"], "K": k, "E": 1}),
                        cs.instance)
    body = mm.body_for(dt, mm.grouped_geometry(x, w, cs, class_id)[4])
    before, total = mm.grouped_launches, mm.body_count()
    ours = mm.body_count(body, kernel="grouped_matmul", dtype=dt)
    got = mm.grouped_matmul(x, w, cs, class_id=class_id)
    assert mm.grouped_launches == before + 1 and got.dtype == dt
    assert mm.body_count() == total + 1
    assert mm.body_count(body, kernel="grouped_matmul", dtype=dt) == ours + 1
    _close(got, ref.grouped_matmul(x, w, class_id), TOL if dt == torch.float32 else BF16_TOL)


# decode-shaped rows-body launches whose strips alone launch few CTAs, so K
# is split (kernel, class, E, K, N)
ROWS_SPLIT_CASES = [("K1", c, 1, 1024, 256) for c in ref.MATMUL_CLASSES] + [
    ("K1", "matmul", 1, 3000, 200),            # ragged last slice, N not a multiple of 64
    ("K1", "matmul_silu_glu", 1, 777, 100),    # K, N not multiples of 8: scalar loads
    ("K1g", "moe_gemm", 2, 1024, 256), ("K1g", "moe_gemm_silu_glu", 3, 640, 96)]


def _rows_launch(kind, class_id, dt, e, m, k, n, seed):
    """Inputs of a rows-body launch at m rows (per expert): returns (run,
    plain, geometry), where run(rows) launches the kernel on those rows of
    x (and of the residual) under their own default schedule."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "K1":
        x = torch.randn((m, k), generator=g, device="cuda").to(dt)
        w = (torch.randn((k, n), generator=g, device="cuda") / k ** 0.5).to(dt)
        bias = torch.randn((n,), generator=g, device="cuda").to(dt) if "bias" in class_id else None
        residual = (torch.randn((m, n // 2 if "glu" in class_id else n), generator=g,
                                device="cuda").to(dt) if class_id == "matmul_residual" else None)
        kw = dict(class_id=class_id, bias=bias, softcap=2.0 if "softcap" in class_id else 0.0)
        cs = ops.schedule_for(ops.instance(class_id, dt, M=m, N=n, K=k))

        def run(rows=slice(None)):
            xs = x[rows].contiguous()
            return mm.launch(xs, w, ops.schedule_for(ops.instance(class_id, dt, M=xs.shape[0],
                                                                  N=n, K=k)),
                             residual=None if residual is None else residual[rows].contiguous(), **kw)

        return (run, lambda: ref.matmul(x, w, residual=residual, **kw),
                mm.launch_geometry(dt, m, n, k, cs.t["M"], cs.t["N"]))
    x = torch.randn((e, m, k), generator=g, device="cuda").to(dt)
    w = (torch.randn((e, k, n), generator=g, device="cuda") / k ** 0.5).to(dt)
    cs = ops.schedule_for(ops.instance(class_id, dt, M=m * e, N=n, K=k, E=e))
    tile_m, tile_n = mm.grouped_geometry(x, w, cs, class_id)[4:]

    def run(rows=slice(None)):
        xs = x[:, rows].contiguous()
        return mm.grouped_launch(xs, w, ops.schedule_for(
            ops.instance(class_id, dt, M=xs.shape[1] * e, N=n, K=k, E=e)), class_id=class_id)

    return (run, lambda: ref.grouped_matmul(x, w, class_id),
            mm.launch_geometry(dt, m, n, k, tile_m, tile_n, e))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,class_id,e,k,n", ROWS_SPLIT_CASES)
def test_rows_body_with_split_k_matches_plain(card, dtype, kind, class_id, e, k, n):
    """M = 4 (decode slots) on the rows body with K split across CTAs, every
    epilogue class, K1 and K1g, against the plain version."""
    dt = getattr(torch, dtype)
    run, plain, geo = _rows_launch(kind, class_id, dt, e, 4, k, n, seed=k + n + e)
    assert geo[0] == "rows" and geo[3] > 1
    before = mm.body_count("rows", dtype=dt)
    got = run()
    assert mm.body_count("rows", dtype=dt) == before + 1
    _close(got, plain(), TOL if dt == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,class_id,e,k,n",
                         ROWS_SPLIT_CASES + [("K1", "matmul_lmhead", 1, 3072, 4000)])
def test_rows_body_bits_do_not_depend_on_m(card, dtype, kind, class_id, e, k, n):
    """A row's output bits at M = 1 equal its bits at M = 4, and two runs
    give the same bits: split_k and each row's summation order do not
    depend on M."""
    dt = getattr(torch, dtype)
    run, _, _ = _rows_launch(kind, class_id, dt, e, 4, k, n, seed=7 * k + n)
    four = run()
    assert torch.equal(run(), four)
    for i in range(4):
        one = run(slice(i, i + 1))
        torch.cuda.synchronize()
        assert torch.equal(one, four[i:i + 1] if kind == "K1" else four[:, i:i + 1])


# narrow N tiles at an odd row pitch (N = 457, prime: every row of w starts
# at another byte offset mod 16), every body: (kernel, class, E, rows per
# expert, K, M tile, rounding).  The rows body (4-row tiles, K split and in
# rounding mode), mma (plain and rounding, 128- and 64-row tiles), fma (f32),
# K1g on both bodies, a GLU at even tiles (N = 458)
NARROW_CASES = [("K1", "matmul", 1, 4, 640, 4, False), ("K1", "matmul", 1, 4, 640, 4, True),
                ("K1", "matmul_lmhead", 1, 300, 192, 128, False),
                ("K1", "matmul_bias", 1, 100, 96, 64, True),
                ("K1g", "moe_gemm", 3, 4, 320, 4, False), ("K1g", "moe_gemm", 3, 130, 96, 64, False),
                ("K1", "matmul_silu_glu", 1, 70, 96, 64, False),
                ("K1", "matmul_silu_glu", 1, 4, 640, 4, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_n", [1, 2, 3, 7, 21, 63, 64, 65])
@pytest.mark.parametrize("kind,class_id,e,m,k,tile_m,rounding", NARROW_CASES)
def test_narrow_n_tiles_at_an_odd_pitch_match_plain(card, dtype, tile_n, kind, class_id, e, m, k,
                                                    tile_m, rounding):
    """A CTA covering a group of N tiles narrower than itself, each masked
    at its own edge, with rows of w read as shifted aligned vectors, against
    the plain version (with the same rounding K tile)."""
    from repro_torch.core.schedule import Schedule, concretize

    glu = "glu" in class_id
    if glu and tile_n % 2:
        pytest.skip("a GLU's N tile is even")
    dt = getattr(torch, dtype)
    n = 458 if glu else 457
    g = torch.Generator(device="cuda").manual_seed(tile_n + m + k)
    lead = (e,) if kind == "K1g" else ()
    x = torch.randn((*lead, m, k), generator=g, device="cuda").to(dt)
    w = (torch.randn((*lead, k, n), generator=g, device="cuda") / k ** 0.5).to(dt)
    tiles = {"M": tile_m, "N": tile_n, "K": 32 if rounding else k, **({"E": 1} if lead else {})}
    inst = (ops.instance(class_id, dt, M=m, N=n, K=k) if not lead
            else ops.instance(class_id, dt, M=m * e, N=n, K=k, E=e))
    cs = concretize(Schedule.make(class_id, tiles, cache_write=not rounding), inst)
    rk = mm.round_k_for(cs)
    assert bool(rk) == (rounding and dt == torch.bfloat16)
    if lead:
        got, want = mm.grouped_matmul(x, w, cs, class_id=class_id), ref.grouped_matmul(
            x, w, class_id, round_k=rk)
    else:
        bias = torch.randn((n,), generator=g, device="cuda").to(dt) if "bias" in class_id else None
        got = mm.matmul(x, w, cs, class_id=class_id, bias=bias)
        want = ref.matmul(x, w, class_id, bias=bias, round_k=rk)
    _close(got, want, TOL if dt == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("m,tile_m,n", [(4, 4, 30851), (128, 128, 4099)])
def test_n_tile_3_and_63_are_bit_equal(card, m, tile_m, n):
    """The same launch at N tile 3 (21 tiles a 64-column CTA) and at N tile
    63 (one tile a CTA): both place 63 columns a CTA, one K slice each and
    the same CTA tile (rows: 490 strips, no K split; mma: 64x64, 132 CTAs),
    so every output's bits are the same (no output's summation order
    depends on which columns share its CTA).  N is odd: rows off 16 bytes."""
    from repro_torch.core.schedule import Schedule, concretize

    k = 3072
    g = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
    w = (torch.randn((k, n), generator=g, device="cuda") / k ** 0.5).bfloat16()
    inst = ops.instance("matmul_lmhead", torch.bfloat16, M=m, N=n, K=k)
    outs, geos = [], []
    for tile_n in (3, 63):
        cs = concretize(Schedule.make("matmul_lmhead", {"M": tile_m, "N": tile_n, "K": k}), inst)
        geos.append(mm.launch_geometry(torch.bfloat16, m, n, k, tile_m, tile_n)[:4])
        outs.append(mm.launch(x, w, cs, class_id="matmul_lmhead"))
    assert geos[0] == geos[1] and geos[0][3] == 1
    _equal_bits(outs[0], outs[1])
    _close(outs[0], ref.matmul(x, w, "matmul_lmhead"), BF16_TOL)


# rounding mode (cache_write=False): (rows per expert, M tile), (K, K tile):
# the rows body at 4 rows and the tensor-core body at 256, K tiles of 16
# and 128 at K = 2048, 40 (not a multiple of 16) at 2560, 8 at 1024, and 3
# at 192 (odd: x rows off 16 bytes, MMA steps split in up to 6 segments)
ROUND_ROWS = [(4, 4), (256, 128)]
ROUND_K = [(2048, 16), (2048, 128), (2560, 40), (1024, 8), (192, 3)]


@pytest.mark.parametrize("m,tile_m", ROUND_ROWS)
@pytest.mark.parametrize("k,k_tile", ROUND_K)
@pytest.mark.parametrize("class_id,e", [("matmul", None), ("matmul_residual", None),
                                        ("moe_gemm", 3)])
def test_rounding_mode_matches_plain(card, m, tile_m, k, k_tile, class_id, e):
    """bf16 with ``cache_write=False``: the kernel rounds its sums to bf16
    after every K tile, as the plain version with the same ``round_k`` does,
    on the rows body and on the tensor-core body, K1 and K1g."""
    from repro_torch.core.schedule import Schedule, concretize

    dt, n = torch.bfloat16, 320
    g = torch.Generator(device=card).manual_seed(m + k + k_tile)
    lead = () if e is None else (e,)
    x = torch.randn((*lead, m, k), generator=g, device=card).to(dt)
    w = (torch.randn((*lead, k, n), generator=g, device=card) / k ** 0.5).to(dt)
    params = dict(M=m * (e or 1), N=n, K=k, **({"E": e} if e else {}))
    tiles = {"M": tile_m, "N": 128, "K": k_tile, **({"E": 1} if e else {})}
    cs = concretize(Schedule.make(class_id, tiles, cache_write=False),
                    ops.instance(class_id, dt, **params))
    assert mm.round_k_for(cs) == k_tile
    kernel = "matmul" if e is None else "grouped_matmul"
    body = "rows" if tile_m <= 16 else "mma"
    before = mm.round_launches[kernel, body]
    if e is None:
        res = (torch.randn((m, n), generator=g, device=card).to(dt)
               if class_id == "matmul_residual" else None)
        got = mm.matmul(x, w, cs, class_id=class_id, residual=res)
        want = ref.matmul(x, w, class_id, residual=res, round_k=k_tile)
    else:
        got = mm.grouped_matmul(x, w, cs, class_id=class_id)
        want = ref.grouped_matmul(x, w, class_id, round_k=k_tile)
    assert mm.round_launches[kernel, body] == before + 1
    _close(got, want, BF16_TOL)


def test_kernel_rejects_what_it_does_not_take(card):
    x = torch.zeros((4, 8), device=card)
    w = torch.zeros((8, 16), device=card, dtype=torch.bfloat16)
    cs = ops.schedule_for(ops.instance("matmul", x.dtype, M=4, N=16, K=8))
    with pytest.raises(ValueError, match="one dtype"):
        mm.launch(x, w, cs)
    with pytest.raises(ValueError, match="does not fit"):
        mm.launch(x, w.float()[:, :8].contiguous(), cs)
    q = torch.zeros((1, 2, 4, 320), device=card)
    acs = ops.schedule_for(ops.instance("flash_attention_causal", q.dtype, Q=4, KV=4,
                                        H=2, D=320, B=1, window=0))
    with pytest.raises(ValueError, match="head dims"):
        fa.launch(q, q, q, acs)
    r = torch.zeros((1, 2, 4, 48), device=card)
    rcs = ops.schedule_for(ops.instance("rwkv6_scan", r.dtype, T=4, C=96, D=48, B=1))
    with pytest.raises(ValueError, match="head dims"):
        rw.launch(r, r, r, r, torch.zeros((2, 48), device=card),
                  torch.zeros((1, 2, 48, 48), device=card), rcs)
    x = torch.zeros((1, 4, 8), device=card)
    gcs = ops.schedule_for(ops.instance("rglru_scan", x.dtype, T=4, C=8, B=1))
    with pytest.raises(ValueError, match="one dtype"):
        rg.launch(x, x.bfloat16(), torch.zeros((1, 8), device=card), gcs)


# reduced minitron, a variant whose layers drive the window, softcap, GLU
# and softcapped-head paths of K1 and K2, the two recurrent archs (K3, K4
# and griffin's local attention) and mixtral (K1g): arch, config overrides,
# kernels run (names of serve.kernel_launches)
CONFIGS = {"minitron": ("minitron-4b", {}, ("matmul", "flash_attention")),
           "local_global_softcap_geglu": ("minitron-4b",
                                          dict(layer_pattern=("L", "G"), window=8,
                                               attn_softcap=50.0, final_softcap=30.0,
                                               tie_embeddings=True, mlp_kind="geglu"),
                                          ("matmul", "flash_attention")),
           "rwkv6": ("rwkv6-1.6b", {}, ("matmul", "rwkv6_scan")),
           "recurrentgemma": ("recurrentgemma-2b", {}, ("matmul", "flash_attention", "rglru_scan")),
           "mixtral": ("mixtral-8x22b", {}, ("matmul", "flash_attention", "grouped_matmul"))}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def reduced_model(card, request):
    arch, kw, kernels = CONFIGS[request.param]
    cfg = dataclasses.replace(reduced(get_arch(arch)), **kw)
    model = build_model(cfg, card)
    return model, model.init(seed=0), kernels


def test_reduced_model_kernel_path_matches_plain_path(reduced_model):
    model, params, kernels = reduced_model
    toks = torch.randint(1, 512, (2, 12), generator=torch.Generator().manual_seed(0)).to(model.device)
    before = kernel_launches()
    lk, ck = model.prefill(params, {"tokens": toks}, max_len=32, true_len=9)
    with use_backend("ref"):
        lr, cr = model.prefill(params, {"tokens": toks}, max_len=32, true_len=9)
    _close(lk, lr)
    after = kernel_launches()
    assert all(after[name] > before[name] for name in kernels)
    for step in range(3):
        feed = toks[:, step]
        lk, ck = model.decode_step(params, ck, feed)
        with use_backend("ref"):
            lr, cr = model.decode_step(params, cr, feed)
        _close(lk, lr)


def test_engine_on_the_card_finishes_requests(reduced_model):
    model, params, _ = reduced_model
    eng = ServingEngine(model, params, slots=2, max_len=32)
    before = mm.launches
    reqs = [eng.add_request([1, 2, 3], max_new_tokens=4),
            eng.add_request([4, 5, 6, 7, 8], max_new_tokens=3)]
    eng.run_to_completion()
    assert [len(r.generated) for r in reqs] == [4, 3]
    assert mm.launches > before
    assert all(r.done for r in reqs)


# ---------------------------------------------------------------------------
# MeasuredRunner: schedules timed on the card
# ---------------------------------------------------------------------------


def _device_ms(fn, iters: int = 5) -> float:
    """Mean device time of one call: the summed durations of its kernels in
    a torch.profiler capture of ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    assert us > 0, "the capture holds no device time"
    return us / iters / 1e3


def test_measured_runner_ranks_the_prime_shape(card):
    """397×2048² bf16, the default schedule's 1-row M tiles (the rows body,
    16 tiles a CTA) and 64×64 tiles (the tensor-core body): the runner
    orders the two as the profiler's device times of the same launches do
    wherever those differ by more than 20%; one launch, one timing."""
    from repro_torch.core import KernelInstance, Schedule, default_schedule
    from repro_torch.core.measured_runner import MeasuredRunner

    runner = MeasuredRunner()
    inst = KernelInstance.make("matmul", M=397, N=2048, K=2048)
    dflt = default_schedule(inst)
    assert dflt.t["M"] == 1
    tile64 = Schedule.make("matmul", {"M": 64, "N": 64, "K": dflt.t["K"]})
    runner_ratio = runner.seconds(inst) / runner.seconds(inst, tile64)
    assert runner.stats.measurements == 2
    device_ratio = (_device_ms(lambda: runner.run(runner.concrete(inst, dflt)))
                    / _device_ms(lambda: runner.run(runner.concrete(inst, tile64))))
    print(f"397x2048x2048 default over 64x64: runner {runner_ratio:.3f}, device {device_ratio:.3f}")
    if max(device_ratio, 1 / device_ratio) > 1.2:
        assert (runner_ratio > 1) == (device_ratio > 1), (runner_ratio, device_ratio)
    assert runner.measure(inst, dflt).seconds == runner.seconds(inst)
    assert runner.stats.measurements == 2 and runner.target == "h100"


TUNED_CLASSES = {
    "matmul_bias_gelu": dict(M=200, N=384, K=256),
    "matmul_silu_glu": dict(M=96, N=512, K=128),
    "moe_gemm_silu_glu": dict(M=4 * 48, N=256, K=128, E=4),
    "flash_attention_swa": dict(Q=150, KV=150, H=4, D=128, B=1, window=64),
    "flash_attention_softcap": dict(Q=97, KV=97, H=2, D=256, B=2),
    "rwkv6_scan": dict(T=70, C=2 * 64, D=64, B=2),
    "rglru_scan": dict(T=70, C=640, B=2),
}


@pytest.mark.parametrize("class_id", sorted(TUNED_CLASSES))
def test_measured_runner_random_schedules_match_plain(card, class_id):
    """Eight random valid schedules per class, as the autoscheduler draws
    them (odd and 1-row tiles, N-outer orders): the runner's launch agrees
    with the plain version on the same inputs (bf16 3e-2; scan states f32
    2e-4)."""
    import random

    from repro_torch.core import KernelInstance, ScheduleInvalid
    from repro_torch.core.autoscheduler import random_schedule
    from repro_torch.core.measured_runner import MeasuredRunner

    runner = MeasuredRunner()
    inst = KernelInstance.make(class_id, **TUNED_CLASSES[class_id])
    rng, checked = random.Random(1), 0
    while checked < 8:
        sched = random_schedule(inst, rng)
        try:
            cs = runner.concrete(inst, sched)
        except ScheduleInvalid:
            continue
        got, want = runner.run(cs), runner.run(cs, plain=True)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        _close(got[0], want[0], BF16_TOL)
        for g, w in zip(got[1:], want[1:]):
            _close(g, w, TOL)
        assert runner.measure(inst, sched).seconds > 0
        checked += 1


# ---------------------------------------------------------------------------
# The paged engine, chunked prefill and speculative verify on the card
# ---------------------------------------------------------------------------


def _paged_run(model, params, prompts, fragment):
    from repro_torch.serving import PagedServingEngine

    eng = PagedServingEngine(model, params, decode_batch=len(prompts), max_ctx=64, page_size=4,
                             chunk=8, record_logits=True)
    if fragment:   # shred the free list before any real allocation
        for i in range(20):
            eng.table.ensure(900 + i, 4)
        for i in range(0, 20, 2):
            eng.table.release(900 + i)
    reqs = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    eng.run_to_completion(max_steps=512)
    assert all(r.done and len(r.generated) == 6 for r in reqs)
    return [r.generated for r in reqs], [eng.chunk_logits[r.uid] for r in reqs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_engine_fragmented_pool_is_bit_exact(card, dtype):
    """Reduced minitron-4b on the card: a shredded pool against a fresh one
    gives the same tokens and the same final-chunk logits, bit for bit, and
    the chunks reach the flash-attention kernel at q_offset > 0."""
    import numpy as np

    cfg = dataclasses.replace(reduced(get_arch("minitron-4b")), dtype=dtype)
    model = build_model(cfg, card)
    params = model.init(seed=0)
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, size=n)] for n in (3, 19, 30, 11)]
    fa.reset_launches()
    toks, logits = _paged_run(model, params, prompts, fragment=False)
    assert fa.offset_launches > 0
    ftoks, flogits = _paged_run(model, params, prompts, fragment=True)
    assert ftoks == toks
    assert all(np.array_equal(a, b) for a, b in zip(logits, flogits))


@pytest.mark.parametrize("c,q_offset", [(64, 0), (64, 64), (64, 256), (64, 448), (53, 128),
                                        (16, 300), (1, 511)])
def test_flash_attention_at_chunk_shapes_matches_plain(card, c, q_offset):
    """K2 at the paged engine's chunk shapes (minitron-4b: 24 query heads
    over 8, D = 128, the chunk against a 512-row cache) at run-time
    q_offsets, bf16, against the plain version; the prime 53-row chunk
    takes 1-row Q tiles."""
    g = torch.Generator(device="cuda").manual_seed(c + q_offset)
    q = torch.randn((1, 24, c, 128), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((1, 8, 512, 128), generator=g, device="cuda").bfloat16() for _ in range(2))
    got = ops.flash_attention(q, k, v, q_offset=q_offset)
    want = ref.chunked_attention(q, k, v, q_offset=q_offset)
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("class_id,b,sq,skv", [("flash_attention_bidir", 1, 1500, 1500),
                                               ("flash_attention_cross", 4, 1, 1500),
                                               ("flash_attention_cross", 1, 181, 1500)])
def test_noncausal_attention_at_whisper_shapes_matches_plain(card, dtype, class_id, b, sq, skv):
    """K2 with ``causal=False`` at whisper-medium's shapes (16 heads, D =
    64): the encoder's 1500 frames, cross-attention over them at 4-slot
    decode (Q = 1: one live row per 64-row CTA, the last key chunk ragged)
    and at the prime 181-row prefill (default Q tile 1), each launch counted
    under its class and body."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(sq + b)
    q = torch.randn((b, 16, sq, 64), generator=g, device=card).to(dt)
    k, v = (torch.randn((b, 16, skv, 64), generator=g, device=card).to(dt) for _ in range(2))
    body = fa.body_for(dt)
    before = fa.class_launches[class_id, body]
    got = ops.flash_attention(q, k, v, class_id=class_id, causal=False)
    assert fa.class_launches[class_id, body] == before + 1
    _close(got, ref.chunked_attention(q, k, v, causal=False),
           TOL if dt == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_encdec_and_vision_prefix_kernel_path_matches_plain_path(card, arch):
    """Reduced whisper (encoder, cross-attention) and internvl2 (vision
    projection) with seeded frames or patch embeddings: prefill and three
    decode steps, kernel path against plain path, f32."""
    cfg = reduced(get_arch(arch))
    model = build_model(cfg, card)
    params = model.init(seed=0)
    g = torch.Generator(device=card).manual_seed(1)
    toks = torch.randint(1, 512, (2, 12), generator=g, device=card)
    extra = (("frames", cfg.encoder_seq) if cfg.family == "audio"
             else ("patch_embeds", cfg.vision_tokens))
    batch = {"tokens": toks,
             extra[0]: torch.randn((2, extra[1], cfg.d_model), generator=g, device=card)}
    before = dict(fa.class_launches)
    lk, ck = model.prefill(params, batch, max_len=32, true_len=9)
    with use_backend("ref"):
        lr, cr = model.prefill(params, batch, max_len=32, true_len=9)
    _close(lk, lr)
    classes = (("flash_attention_bidir", "flash_attention_cross") if cfg.family == "audio"
               else ("flash_attention_causal",))
    assert all(fa.class_launches[c, "fma"] > before.get((c, "fma"), 0) for c in classes)
    for step in range(3):
        lk, ck = model.decode_step(params, ck, toks[:, step])
        with use_backend("ref"):
            lr, cr = model.decode_step(params, cr, toks[:, step])
        _close(lk, lr)


def test_measured_runner_times_decode_attention_without_k2(card):
    """A causal attention instance at Q = 1 is timed as the decode attention
    the model runs: no K2 launch; cross-attention at Q = 1 launches K2."""
    from repro_torch.core.measured_runner import MeasuredRunner
    from repro_torch.core.workload import KernelInstance

    runner = MeasuredRunner()
    dec = KernelInstance.make("flash_attention_causal", Q=1, KV=512, H=24, D=128, B=4,
                              dtype="bfloat16")
    cross = KernelInstance.make("flash_attention_cross", Q=1, KV=1500, H=16, D=64, B=4,
                                dtype="bfloat16")
    before = fa.launches
    assert runner.seconds(dec) > 0 and fa.launches == before
    assert runner.seconds(cross) > 0 and fa.launches > before


# narrow M tiles at a prime M (kernel, class, E, M per expert, K, N,
# rounding K tile (0: f32 sums), f32 Y, Z): K split (2048 x 2048: 8 slices)
# and unsplit (N = 17000: 266 strips), GLU, residual, softcap, bias + gelu
# with Z, an odd N (457: rows of w off 16 bytes), f32 Y, rounding mode at a
# wide (256) and a narrow (32) K tile, K1g.  M = 7 and M = 37 take the
# staged 16-row pass (M = 7 in one ragged pass), each row alone the 4-row one
NARROW_M_CASES = [
    ("K1", "matmul", 1, 37, 2048, 2048, 0, False, False),
    ("K1", "matmul_lmhead", 1, 37, 256, 17000, 0, False, False),
    ("K1", "matmul_gelu_glu", 1, 37, 512, 1024, 0, False, False),
    ("K1", "matmul_residual", 1, 7, 640, 457, 0, False, False),
    ("K1", "matmul_lmhead_softcap", 1, 37, 384, 457, 0, False, False),
    ("K1", "matmul_bias_gelu", 1, 37, 512, 384, 0, False, True),
    ("K1", "matmul", 1, 37, 1024, 768, 0, True, False),
    ("K1", "matmul", 1, 37, 1024, 512, 256, False, False),
    ("K1", "matmul", 1, 7, 1024, 457, 32, False, False),
    ("K1g", "moe_gemm_silu_glu", 3, 37, 256, 512, 0, False, False),
    ("K1g", "moe_gemm", 3, 7, 640, 457, 0, False, False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,class_id,e,m,k,n,round_k,out_f32,with_z", NARROW_M_CASES)
def test_grouped_m_tiles_keep_the_bits(card, dtype, kind, class_id, e, m, k, n, round_k, out_f32,
                                       with_z):
    """A rows-body CTA over a group of narrow M tiles at a prime M: the
    outputs (and Z) at M tiles 1, 2 and 3 (16, 8 and 5 tiles a CTA) equal,
    bit for bit, those at an M tile of 16 (one tile a CTA) and each row's
    launch alone at M = 1 (the 4-row register pass), and agree with the
    plain version (with the same rounding K tile)."""
    from repro_torch.core.schedule import Schedule, concretize

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    lead = (e,) if kind == "K1g" else ()
    x = torch.randn((*lead, m, k), generator=g, device="cuda").to(dt)
    w = (torch.randn((*lead, k, n), generator=g, device="cuda") / k ** 0.5).to(dt)
    n_out = n // 2 if "glu" in class_id else n
    kw = {}
    if kind == "K1":
        kw = dict(bias=torch.randn((n,), generator=g, device="cuda").to(dt) if "bias" in class_id else None,
                  residual=(torch.randn((m, n_out), generator=g, device="cuda").to(dt)
                            if class_id == "matmul_residual" else None),
                  softcap=2.0 if "softcap" in class_id else 0.0)

    def launch(rows, tile_m):
        xs = x[..., rows, :].contiguous()
        mr = xs.shape[-2]
        inst = (ops.instance(class_id, dt, M=mr, N=n, K=k) if not lead
                else ops.instance(class_id, dt, M=mr * e, N=n, K=k, E=e))
        dflt = ops.schedule_for(inst)
        tiles = {**dflt.t, "M": tile_m, "K": round_k or dflt.t["K"]}
        cs = concretize(Schedule.make(class_id, tiles, order=dflt.order, cache_write=not round_k),
                        inst)
        if lead:
            return (mm.grouped_matmul(xs, w, cs, class_id=class_id, out_f32=out_f32),)
        res = kw["residual"][rows].contiguous() if kw["residual"] is not None else None
        out = mm.launch(xs, w, cs, class_id=class_id, bias=kw["bias"], residual=res,
                        softcap=kw["softcap"], with_z=with_z, out_f32=out_f32)
        return out if with_z else (out,)

    whole = slice(None)
    wide = launch(whole, 16)
    for tile_m in (1, 2, 3):
        before = mm.grouped_tile_launches[tile_m]
        got = launch(whole, tile_m)
        assert mm.grouped_tile_launches[tile_m] == before + 1
        for a, b in zip(got, wide):
            _equal_bits(a, b)
    for i in range(m):
        for a, b in zip(launch(slice(i, i + 1), 1), wide):
            _equal_bits(a, b[..., i:i + 1, :])
    rk = round_k if dt == torch.bfloat16 and "glu" not in class_id else 0
    want = (ref.grouped_matmul(x, w, class_id, round_k=rk, out_f32=out_f32) if lead
            else ref.matmul(x, w, class_id, round_k=rk, out_f32=out_f32, **kw))
    _close(wide[0], want, TOL if dt == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("k,n", [(3072, 3072), (3072, 1024), (3072, 9216), (9216, 3072)])
def test_k1_rows_at_verify_m_take_decode_bits(card, k, n):
    """The batched verify's projections (M = 4 lanes x 4 positions = 16
    rows) and decode's (M = 4): each row's bits are the same."""
    g = torch.Generator(device="cuda").manual_seed(k + n)
    x = torch.randn((16, k), generator=g, device="cuda").bfloat16()
    w = (torch.randn((k, n), generator=g, device="cuda") / k ** 0.5).bfloat16()
    sixteen = ops.matmul(x, w)
    for i in range(0, 16, 4):
        assert torch.equal(ops.matmul(x[i:i + 4].contiguous(), w), sixteen[i:i + 4])


def test_verify_attention_takes_decode_bits(card):
    """The plain verify attention on the card: every position's output is
    the decode attention's with that position's mask, bit for bit."""
    from repro_torch.models import attention as attn

    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((4, 24, 4, 128), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((4, 8, 512, 128), generator=g, device="cuda").bfloat16() for _ in range(2))
    pos = torch.tensor([100, 231, 356, 507], device="cuda")[:, None] + torch.arange(4, device="cuda")
    pos = pos.clamp(max=511)
    ok = torch.arange(512, device="cuda")[None, None, :] <= pos[:, :, None]
    out = attn._masked_verify_attention(q, k, v, ok)
    for j in range(4):
        want = attn._masked_decode_attention(q[:, :, j:j + 1].contiguous(), k, v, ok[:, j])
        assert torch.equal(out[:, :, j:j + 1], want)


def test_verify_step_logits_are_decode_logits(card):
    """Reduced minitron-4b in bf16 on the card: four lanes at different
    offsets, four verify positions in one ``verify_step``, against four
    ``decode_step`` calls feeding the same tokens: the logits at every
    position are equal, bit for bit."""
    cfg = dataclasses.replace(reduced(get_arch("minitron-4b")), dtype="bfloat16")
    model = build_model(cfg, card)
    params = model.init(seed=1)
    g = torch.Generator().manual_seed(2)
    lens = (5, 9, 14, 20)
    cache = model.init_cache(4, 64)
    for lane, n in enumerate(lens):
        toks = torch.randint(1, cfg.vocab_size, (1, n), generator=g).to(card)
        _, one = model.prefill(params, {"tokens": toks}, max_len=64)
        for full, part in zip(cache["layers"], one["layers"]):
            for key in full:
                full[key][lane:lane + 1] = part[key]
    cache["t"] = torch.tensor(lens, dtype=torch.int32, device=card)
    feed = torch.randint(1, cfg.vocab_size, (4, 4), generator=g).to(card)
    dec = {"layers": [{k: v.clone() for k, v in layer.items()} for layer in cache["layers"]],
           "t": cache["t"].clone()}
    logits, _ = model.verify_step(params, cache, feed, cache["t"].long())
    for j in range(4):
        step, dec = model.decode_step(params, dec, feed[:, j])
        torch.cuda.synchronize()
        assert torch.equal(logits[:, j], step), j


# ---------------------------------------------------------------------------
# The fleet on the card: the virtual clock read from measured kernel times
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["slot", "paged_spec"])
def test_fleet_on_h100_serves_on_measured_seconds(card, tmp_path, engine):
    """Two replicas of reduced minitron-4b (bf16) at the ``h100`` target,
    slot engines or paged engines speculating over a 1-layer self-draft: the
    runner shared by the service and both replicas is the measured one,
    ``tick_s`` is measured device time above 0, every request completes, no
    replica diverges, and the runner timed nothing while an engine call
    ran."""
    from repro_torch.core.measured_runner import MeasuredRunner
    from repro_torch.fleet import ServingFleet, TrafficGenerator
    from repro_torch.service import ScheduleRegistry
    from repro_torch.serving import make_self_draft

    cfg = dataclasses.replace(reduced(get_arch("minitron-4b")), dtype="bfloat16")
    model = build_model(cfg, card)
    params = model.init(seed=0)
    kw = {}
    if engine == "paged_spec":
        dcfg, dparams, params = make_self_draft(cfg, params, keep_layers=1, damp=0.02)
        kw = dict(engine="paged", decode_batch=2, page_size=4, chunk=8, speculative=True,
                  draft_model=build_model(dcfg, card), draft_params=dparams, spec_k=3)
    fleet = ServingFleet(cfg, model, params, replicas=2, slots=2, max_len=32,
                         targets="h100", registry=ScheduleRegistry(str(tmp_path)),
                         policy="plan_aware", prefetch=True, **kw)
    runner = fleet.runner_for("h100")
    measured = runner.inner
    assert isinstance(measured, MeasuredRunner)
    assert fleet.services["h100"].runner is runner
    assert all(r._runner is runner for r in fleet.replicas)
    assert fleet.tick_s > 0.0
    in_steps = []
    for r in fleet.replicas:
        for name in ("add_request", "step"):
            real = getattr(r.engine, name)

            def call(*a, _real=real, **kw):
                before = measured.stats.measurements
                out = _real(*a, **kw)
                in_steps.append(measured.stats.measurements - before)
                return out

            setattr(r.engine, name, call)
    gen = TrafficGenerator(seed=0, vocab_size=cfg.vocab_size, arrival_rate=0.5,
                           tick_s=fleet.tick_s, short_lens=(3, 8), long_lens=(9, 16),
                           new_tokens=(2, 4), prompt_cap=16)
    try:
        summary = fleet.serve(gen.trace(8))
    finally:
        fleet.close()
    assert summary["completed"] + summary["shed"] == 8 and summary["completed"] > 0
    assert summary["schedule_mismatches"] == 0
    assert measured.stats.measurements > 0 and in_steps and sum(in_steps) == 0
    assert summary["tuning"]["h100"]["jobs_completed"] > 0
    if engine == "paged_spec":
        assert summary["speculative"]["counters"]["bursts"] > 0


# ---------------------------------------------------------------------------
# training: the kernels' backward
# ---------------------------------------------------------------------------

# (b, hq, hkv, sq, skv, d, causal, window, softcap): gemma2's local and
# global layers (window 128 bites at S = 256), minitron's GQA, a non-causal
# head, a prime length; then the families' cases: whisper's 1500 frames (not
# a multiple of the 64-key tile) and its cross-attention (448 x 1500),
# mixtral's group of 6 under a window, recurrentgemma's group of 10 at
# D = 256 (split between CTAs), softcap at D = 256 in a group of 6, and a
# prime 181 under a window
BWD_SHAPES = [(1, 8, 4, 256, 256, 256, True, 128, 50.0), (1, 8, 4, 256, 256, 256, True, 0, 50.0),
              (1, 6, 2, 200, 200, 128, True, 0, 0.0), (2, 4, 4, 150, 150, 64, False, 0, 0.0),
              (1, 4, 2, 181, 181, 16, True, 0, 0.0), (1, 4, 2, 96, 96, 100, False, 24, 0.0),
              (1, 4, 4, 1500, 1500, 64, False, 0, 0.0), (1, 4, 4, 448, 1500, 64, False, 0, 0.0),
              (1, 12, 2, 200, 200, 128, True, 64, 0.0), (1, 10, 1, 256, 256, 256, True, 100, 0.0),
              (2, 6, 1, 130, 130, 256, True, 0, 50.0), (1, 6, 3, 181, 181, 64, True, 50, 0.0)]


def _tol(dtype):
    return BF16_TOL if dtype == torch.bfloat16 else TOL


def _close_to_scale(got, want, tol):
    """A gradient of order well under one held to its own scale:
    |got - want| <= 1e-2·max|want| + rtol·|want| in bf16 (tol's atol as a
    share of max|want| in f32), so an absolute atol cannot pass a wrong
    gradient whose entries are all smaller than it."""
    scale = float(want.abs().max())
    share = 1e-2 if tol is BF16_TOL else tol["atol"]
    _close(got, want, dict(rtol=tol["rtol"], atol=share * scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,softcap", BWD_SHAPES)
def test_attention_backward_matches_plain(card, dtype, b, hq, hkv, sq, skv, d, causal, window,
                                          softcap):
    """bf16 on the tensor-core body (P and dS rounded to bf16 for the second
    products), f32 on the CUDA-core body; each launch's body counted."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(sq + skv + d)
    q = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((b, hkv, skv, d), generator=g, device="cuda").to(dt) for _ in range(2))
    do = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(dt)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = (fa.bwd_launches, fa.bwd_body_launches[fa.body_for(dt), dt])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(o, leaves, do)
    assert (fa.bwd_launches, fa.bwd_body_launches[fa.body_for(dt), dt]) == (before[0] + 1, before[1] + 1)
    want = ref.chunked_attention_bwd(q, k, v, do, **kw)
    for a, w in zip(got, want):
        assert a.dtype == dt
        _close(a, w, _tol(dt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("class_id", ["matmul", "matmul_bias", "matmul_bias_gelu", "matmul_silu_glu",
                                      "matmul_gelu_glu", "matmul_residual",
                                      "matmul_lmhead_softcap"])
def test_matmul_backward_matches_plain(card, dtype, class_id):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    m, k, n = 70, 96, 200
    n_out = n // 2 if "glu" in class_id else n
    x = torch.randn((2, m // 2, k), generator=g, device="cuda").to(dt)
    w = (torch.randn((k, n), generator=g, device="cuda") / k ** 0.5).to(dt)
    kw = {}
    if "bias" in class_id:
        kw["bias"] = (0.1 * torch.randn(n, generator=g, device="cuda")).to(dt)
    if class_id == "matmul_residual":
        kw["residual"] = torch.randn((2, m // 2, n_out), generator=g, device="cuda").to(dt)
    if class_id == "matmul_lmhead_softcap":
        kw["softcap"] = 3.0
    dy = (torch.randn((2, m // 2, n_out), generator=g, device="cuda") / n_out ** 0.5).to(dt)
    names = ["x", "w"] + [key for key in ("bias", "residual") if key in kw]

    def grads(backend):
        ins = {"x": x.clone().requires_grad_(), "w": w.clone().requires_grad_()}
        call = dict(kw)
        for key in names[2:]:
            ins[key] = call[key] = kw[key].clone().requires_grad_()
        y = ops.matmul(ins["x"], ins["w"], class_id=class_id, backend=backend, **call)
        return y, torch.autograd.grad(y, [ins[key] for key in names], dy)

    before = mm.grad_launches
    y, got = grads("cuda")
    assert mm.grad_launches > before
    with torch.no_grad():
        assert torch.equal(y, ops.matmul(x, w, class_id=class_id, **kw))   # same bits as serving
    _, want = grads("ref")
    for name, a, b_ in zip(names, got, want):
        assert a.dtype == b_.dtype, name
        _close_to_scale(a.float(), b_.float(), _tol(dt))


def test_tied_head_gradient_reaches_the_embedding(card):
    g = torch.Generator(device="cuda").manual_seed(2)
    emb = (torch.randn((1000, 64), generator=g, device="cuda") / 8).to(torch.bfloat16)
    h = torch.randn((2, 9, 64), generator=g, device="cuda").to(torch.bfloat16)
    dy = (torch.randn((2, 9, 1000), generator=g, device="cuda") / 30).to(torch.bfloat16)
    e1, h1 = emb.clone().requires_grad_(), h.clone().requires_grad_()
    emb_t = emb.T.contiguous()
    y = ops.matmul(h1, emb_t, class_id="matmul_lmhead_softcap", softcap=30.0, transpose_of=e1)
    got = torch.autograd.grad(y, (e1, h1), dy)
    with torch.no_grad():
        assert torch.equal(y, ops.matmul(h, emb_t, class_id="matmul_lmhead_softcap", softcap=30.0))
    e2, h2 = emb.clone().requires_grad_(), h.clone().requires_grad_()
    y2 = ops.matmul(h2, e2.T, class_id="matmul_lmhead_softcap", softcap=30.0, backend="ref")
    want = torch.autograd.grad(y2, (e2, h2), dy)
    for a, b_ in zip(got, want):
        _close_to_scale(a.float(), b_.float(), BF16_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_forward_bits_equal_under_grad(card, dtype):
    """The forward's output bits are the same with and without the row
    log-sum-exp it writes for the backward (under autograd and asked for
    directly), and that log-sum-exp is the plain one's."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((1, h, 200, 128), generator=g, device="cuda").to(dt)
               for h in (8, 2, 2))
    with torch.no_grad():
        o0 = ops.flash_attention(q, k, v, softcap=50.0)
    o1 = ops.flash_attention(q.clone().requires_grad_(), k, v, softcap=50.0)
    assert o1.requires_grad and torch.equal(o0, o1)
    for kw in (dict(softcap=50.0), dict(window=37), dict(causal=False)):
        cs = ops.schedule_for(ops.instance("flash_attention_causal", dt, Q=200, KV=200, H=8, D=128,
                                           B=1, window=kw.get("window", 0)))
        plain = fa.launch(q, k, v, cs, **kw)
        out, lse = fa.launch(q, k, v, cs, with_lse=True, **kw)
        assert torch.equal(plain, out)
        _close(lse, ref.attention_lse(q, k, **kw), TOL)


def test_attention_under_grad_refuses_q_offset(card):
    x = torch.randn((2, 1, 4, 16), device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(x, x.detach(), x.detach(), q_offset=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("class_id", ref.GROUPED_CLASSES)
@pytest.mark.parametrize("e,m,k,n", [(1, 6, 40, 64), (3, 20, 33, 48), (8, 70, 96, 130)])
def test_grouped_matmul_backward_matches_plain(card, dtype, class_id, e, m, k, n):
    """K1g's backward (GroupedMatmulFn: dX, dW and the GLU's pre-activation
    as K1g launches) against autograd of the plain version: the rows body
    (6 rows per expert) and the tiled bodies, ragged K and N."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(e + m + k + n)
    x = torch.randn((e, m, k), generator=g, device="cuda").to(dt)
    w = (torch.randn((e, k, n), generator=g, device="cuda") / k ** 0.5).to(dt)
    n_out = n // 2 if "glu" in class_id else n
    dy = (torch.randn((e, m, n_out), generator=g, device="cuda") / n_out ** 0.5).to(dt)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = (mm.grouped_launches, mm.grouped_grad_launches)
    y = ops.moe_gemm(xs, ws, class_id=class_id)
    got = torch.autograd.grad(y, (xs, ws), dy)
    launched = 3 if "glu" in class_id else 2
    assert mm.grouped_grad_launches == before[1] + launched
    assert mm.grouped_launches == before[0] + 1 + launched
    with torch.no_grad():
        assert torch.equal(y, ops.moe_gemm(x, w, class_id=class_id))   # same bits as serving
    ref.reset_calls()
    want = ref.grouped_matmul_bwd(x, w, dy, class_id)
    for a, b_ in zip(got, want):
        assert a.dtype == dt
        _close_to_scale(a.float(), b_.float(), _tol(dt))


# ---------------------------------------------------------------------------
# the gradient launch (csrc/matmul_grad.cu): transposed operands read in place
# ---------------------------------------------------------------------------

def _operand(g, e, rows, cols, transposed, dt, scale=1.0):
    """A (rows, cols) operand (per expert when ``e``), stored as (rows, cols)
    or, ``transposed``, as (cols, rows) and viewed back."""
    lead = (e,) if e else ()
    shape = (*lead, cols, rows) if transposed else (*lead, rows, cols)
    t = (torch.randn(shape, generator=g, device="cuda") * scale).to(dt)
    return t.transpose(-1, -2) if transposed else t


def _grad_body(a, b):
    return mm.grad_geometry(a, b)["body"]


# (m, k, n): whole 128 tiles; ragged M, N and K whose rows still start on 16
# bytes (the wgmma body in bf16: TMA fills the ragged boxes with zeros); a
# K of 1000 (16 stages); an output wide enough for wgmma's 128x256 CTAs
# (288 of them); rows that do not start on 16 bytes (K or M odd: the mma
# body with operand modes)
GRAD_SHAPES = [(256, 192, 384), (200, 136, 264), (72, 1000, 40), (2048, 72, 4608), (130, 33, 70),
               (77, 129, 45)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("a_t,b_t", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("m,k,n", GRAD_SHAPES)
@pytest.mark.parametrize("e", [0, 3])
def test_grad_launch_matches_plain(card, dtype, a_t, b_t, m, k, n, e):
    """The gradient launch on A stored (M,K) or (K,M) and B stored (K,N) or
    (N,K) (per expert: 3 experts), against the plain version on the same
    views: bf16 on ``wgmma`` where every TMA box starts on 16 bytes, else on
    ``mma`` with operand modes; f32 on ``fma``; each launch's body counted,
    and two runs bit-equal."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(m + k + n + 10 * a_t + 20 * b_t + e)
    a = _operand(g, e, m, k, a_t, dt)
    b = _operand(g, e, k, n, b_t, dt, k ** -0.5)
    geo = mm.grad_geometry(a, b)
    body = geo["body"]
    # TMA's boxes start on 16 bytes: the rows, and along a contiguous M or N the logical tiles
    aligned = (m % 8 == 0 and k % 8 == 0 and n % 8 == 0 and (not a_t or geo["tile_m"] % 8 == 0)
               and (b_t or geo["tile_n"] % 8 == 0))
    assert body == ("fma" if dt == torch.float32 else "wgmma" if aligned else "mma")
    kernel = "grouped_matmul" if e else "matmul"
    launch = mm.grouped_grad_launch if e else mm.grad_launch
    before = mm.grad_body_launches[kernel, body, dt]
    got = launch(a, b)
    assert mm.grad_body_launches[kernel, body, dt] == before + 1
    want = ref.grouped_matmul(a, b) if e else ref.matmul(a, b)
    assert got.dtype == dt and got.shape == want.shape
    _close(got, want, _tol(dt))
    assert torch.equal(got, launch(a, b))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("a_t,b_t", [(0, 1), (1, 0)])
@pytest.mark.parametrize("m,k,n", [(256, 192, 384), (130, 33, 70)])
def test_grad_launch_with_bias_matches_plain(card, dtype, a_t, b_t, m, k, n):
    """Class ``matmul_bias`` (the gelu class's recomputed pre-activation) on
    each body."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(m + 7 * a_t)
    a, b = _operand(g, 0, m, k, a_t, dt), _operand(g, 0, k, n, b_t, dt, k ** -0.5)
    bias = torch.randn((n,), generator=g, device="cuda").to(dt)
    got = mm.grad_launch(a, b, "matmul_bias", bias=bias)
    _close(got, ref.matmul(a, b, "matmul_bias", bias=bias), _tol(dt))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("tiles,order", [({"M": 64, "N": 96, "K": 64}, ("N", "M", "K")),
                                         ({"M": 128, "N": 384, "K": 192}, ("M", "N", "K")),
                                         ({"M": 32, "N": 128, "K": 64}, ("M", "N", "K"))])
def test_grad_launch_masks_at_the_logical_tile(card, dtype, tiles, order):
    """A logical tile smaller than the CTA tile, N outer, and one that takes
    several CTAs: the tile stays the unit of rasterisation and masking."""
    from repro_torch.core.schedule import Schedule, concretize

    dt = getattr(torch, dtype)
    m, k, n = 256, 192, 384
    g = torch.Generator(device="cuda").manual_seed(5)
    a, b = _operand(g, 0, m, k, 1, dt), _operand(g, 0, k, n, 0, dt, k ** -0.5)
    cs = concretize(Schedule.make("matmul", tiles=tiles, order=order),
                    ops.instance("matmul", dt, M=m, N=n, K=k))
    got = mm._grad_run(a, b, cs, "matmul")
    _close(got, ref.matmul(a, b), _tol(dt))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("tile_n", [1, 2, 3, 7, 21, 63, 64, 65])
@pytest.mark.parametrize("e", [0, 3])
def test_grad_launch_at_narrow_n_tiles(card, dtype, tile_n, e):
    """dW's layout (A = xᵀ, B = dZ stored (K, N)) at an odd N (457) under N
    tiles from 1 to 65: groups of tiles narrower than the CTA, B's rows
    read as shifted aligned vectors (``mma`` with operand modes; ``fma`` in
    f32), against the plain version on the same views."""
    from repro_torch.core.schedule import Schedule, concretize

    dt = getattr(torch, dtype)
    m, k, n = 200, 96, 457
    g = torch.Generator(device="cuda").manual_seed(tile_n + e)
    a, b = _operand(g, e, m, k, 1, dt), _operand(g, e, k, n, 0, dt, k ** -0.5)
    inst = (ops.instance("moe_gemm", dt, M=m * e, N=n, K=k, E=e) if e
            else ops.instance("matmul", dt, M=m, N=n, K=k))
    cs = concretize(Schedule.make(inst.class_id, {"M": 64, "N": tile_n, "K": k,
                                                  **({"E": 1} if e else {})}), inst)
    assert mm.grad_geometry(a, b, cs)["body"] == ("mma" if dt == torch.bfloat16 else "fma")
    got = mm._grad_run(a, b, cs, "grouped_matmul" if e else "matmul")
    want = ref.grouped_matmul(a, b) if e else ref.matmul(a, b)
    _close(got, want, _tol(dt))


@pytest.mark.parametrize("vocab", [51865, 92553])
def test_grad_launch_at_an_unaligned_head(card, vocab):
    """whisper-medium's and internvl2-26b's LM heads at a few rows: rows of
    51865 and 92553 values are not 16-byte aligned, so dX = dZ·wᵀ and dW =
    xᵀ·dZ (and a tied head's dE = dZᵀ·x) take ``mma`` with operand modes,
    against the plain version; internvl2's dW at its N tile of 3, 42 tiles
    a CTA, dZ read as shifted aligned vectors."""
    g = torch.Generator(device="cuda").manual_seed(6)
    bf = torch.bfloat16
    dz = (torch.randn((96, vocab), generator=g, device="cuda") / 200).to(bf)
    w = torch.randn((64, vocab), generator=g, device="cuda").to(bf)
    x = torch.randn((96, 64), generator=g, device="cuda").to(bf)
    if vocab == 92553:
        geo = mm.grad_geometry(x.T, dz)
        assert geo["tile_n"] == 3
        assert mm.n_group(vocab, 3, mm.grad_cta("mma", 64, vocab, geo["tile_m"], 3)[1]) == 42
    for a, b in ((dz, w.T), (x.T, dz), (dz.T, x)):
        assert _grad_body(a, b) == "mma"
        before = mm.grad_body_launches["matmul", "mma", bf]
        got = mm.grad_launch(a, b)
        assert mm.grad_body_launches["matmul", "mma", bf] == before + 1
        _close_to_scale(got.float(), ref.matmul(a, b).float(), BF16_TOL)


def test_gradient_backward_makes_no_transposed_copy(card):
    """Under a TorchDispatchMode, MatmulFn's backward (plain, GLU, a tied
    head) and GroupedMatmulFn's issue no copy of a non-contiguous tensor:
    every transposed operand is read where it lies."""
    from torch.utils._python_dispatch import TorchDispatchMode

    copies = (torch.ops.aten.copy_.default, torch.ops.aten.clone.default,
              torch.ops.aten._to_copy.default)

    class Copies(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.strided = 0, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            if func in copies:
                src = args[1] if func is torch.ops.aten.copy_.default else args[0]
                if isinstance(src, torch.Tensor) and not src.is_contiguous():
                    self.strided.append((str(func), tuple(src.shape), src.stride()))
            return func(*args, **(kwargs or {}))

    g = torch.Generator(device="cuda").manual_seed(8)
    bf = torch.bfloat16
    x = torch.randn((2, 64, 128), generator=g, device="cuda").to(bf)
    w = (torch.randn((128, 256), generator=g, device="cuda") / 12).to(bf)
    emb = (torch.randn((512, 128), generator=g, device="cuda") / 12).to(bf)
    xe = torch.randn((4, 64, 128), generator=g, device="cuda").to(bf)
    we = (torch.randn((4, 128, 192), generator=g, device="cuda") / 12).to(bf)
    cases = [(lambda a, b: ops.matmul(a, b), (x, w)),
             (lambda a, b: ops.matmul(a, b, class_id="matmul_silu_glu"), (x, w)),
             (lambda a, e: ops.matmul(a, e.detach().T.contiguous(), class_id="matmul_lmhead_softcap",
                                      softcap=30.0, transpose_of=e), (x, emb)),
             (lambda a, b: ops.moe_gemm(a, b), (xe, we)),
             (lambda a, b: ops.moe_gemm(a, b, class_id="moe_gemm_silu_glu"), (xe, we))]
    for fn, ins in cases:
        leaves = [t.clone().requires_grad_() for t in ins]
        y = fn(*leaves)
        dy = torch.randn_like(y)
        before = (mm.grad_launches, mm.grouped_grad_launches)
        mode = Copies()
        with mode:
            torch.autograd.grad(y, leaves, dy)
        assert (mm.grad_launches, mm.grouped_grad_launches) != before
        assert mode.ops > 0 and not mode.strided, mode.strided


# (b, h, t, d, w_low, w_high, with_state): T = 1, T = 37 (not a multiple of
# the backward's 16-token stages), B = 1 and 3, head dims 16, 32 and 64, w
# near 0 and near 1, an incoming state and the final state's gradient
RW_BWD_CASES = [(2, 1, 1, 16, 0.05, 0.95, True), (1, 3, 37, 64, 0.05, 0.95, True),
                (3, 2, 40, 32, 0.0, 0.02, False), (1, 2, 64, 64, 0.98, 1.0, True),
                (2, 1, 23, 16, 0.3, 0.9, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,t,d,w_low,w_high,with_state", RW_BWD_CASES)
def test_rwkv6_backward_matches_plain(card, dtype, b, h, t, d, w_low, w_high, with_state):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(b + h + t + d)
    r, k, v = (torch.randn((b, h, t, d), generator=g, device="cuda").to(dt) for _ in range(3))
    w = (w_low + (w_high - w_low) * torch.rand((b, h, t, d), generator=g, device="cuda")).to(dt)
    u = torch.randn((h, d), generator=g, device="cuda")
    s0 = torch.randn((b, h, d, d), generator=g, device="cuda") if with_state else \
        torch.zeros((b, h, d, d), device="cuda")
    dy = torch.randn((b, h, t, d), generator=g, device="cuda").to(dt)
    ds = torch.randn((b, h, d, d), generator=g, device="cuda") if with_state else None
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    before = rw.bwd_launches
    y, s = ops.rwkv6(*leaves)
    outs, grads_in = ((y, s), (dy, ds)) if with_state else ((y,), (dy,))
    got = torch.autograd.grad(outs, leaves, grads_in)
    assert rw.bwd_launches == before + 1
    want = ref.rwkv6_scan_bwd(r, k, v, w, u, s0, dy, ds)
    for name, a, b_ in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got, want):
        assert a.dtype == b_.dtype, name
        _close_to_scale(a.float(), b_.float(), _tol(dt) if name not in ("du", "dstate") else TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,c,tile_c,with_state", [(2, 1, 64, None, True), (1, 37, 100, None, True),
                                                     (3, 70, 2560, None, False),
                                                     (2, 17, 12, 8, True), (2, 600, 2560, None, True),
                                                     (3, 37, 100, 48, True)])
def test_rglru_backward_matches_plain(card, dtype, b, t, c, tile_c, with_state):
    """T = 1, T = 37 and 70 (not multiples of the 32-token stages), T = 600
    (37 stages through the ring, the last ragged), a ragged C under a tile
    of 8 and C = 100 under a tile of 48 (rows not in 16-byte chunks: the
    element path), an incoming state and the final state's gradient."""
    from repro_torch.core.schedule import Schedule, concretize

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(b + t + c)
    x = torch.randn((b, t, c), generator=g, device="cuda").to(dt)
    a = torch.sigmoid(torch.randn((b, t, c), generator=g, device="cuda")).to(dt)
    h0 = torch.randn((b, c), generator=g, device="cuda")
    dy = torch.randn((b, t, c), generator=g, device="cuda").to(dt)
    dh = torch.randn((b, c), generator=g, device="cuda") if with_state else None
    cs = ops.schedule_for(ops.instance("rglru_scan", dt, T=t, C=c, B=b))
    if tile_c is not None:
        cs = concretize(Schedule.make("rglru_scan", {"T": cs.t["T"], "C": tile_c}), cs.instance)
    leaves = [z.clone().requires_grad_() for z in (x, a, h0)]
    before = rg.bwd_launches
    y, h = rg.RglruScanFn.apply(*leaves, cs)
    outs, grads_in = ((y, h), (dy, dh)) if with_state else ((y,), (dy,))
    got = torch.autograd.grad(outs, leaves, grads_in)
    assert rg.bwd_launches == before + 1
    want = ref.rglru_scan_bwd(x, a, h0, dy, dh)
    for name, p, q in zip(("dx", "da", "dstate"), got, want):
        assert p.dtype == q.dtype, name
        _close_to_scale(p.float(), q.float(), _tol(dt) if name != "dstate" else TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rglru_backward_bit_contracts(card, dtype):
    """K4's backward from a state with the final state's gradient: two runs,
    a batch row at B = 1 against B = 4, and C tiles 8, 512 and 2560 give
    the same dx, da and initial state's gradient, bit for bit (channels
    are independent and every element takes the same operations)."""
    from repro_torch.core.schedule import Schedule, concretize

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(19)
    b, t, c = 4, 70, 2560
    x, dy = (torch.randn((b, t, c), generator=g, device="cuda").to(dt) for _ in range(2))
    a = torch.sigmoid(torch.randn((b, t, c), generator=g, device="cuda")).to(dt)
    h0, dh = (torch.randn((b, c), generator=g, device="cuda") for _ in range(2))

    def cs(bb, tile_c=None):
        out = ops.schedule_for(ops.instance("rglru_scan", dt, T=t, C=c, B=bb))
        if tile_c is not None:
            out = concretize(Schedule.make("rglru_scan", {"T": out.t["T"], "C": tile_c}), out.instance)
        return out

    four = rg.launch_bwd(x, a, h0, dy, dh, cs(b))
    _equal_bits(four, rg.launch_bwd(x, a, h0, dy, dh, cs(b)))
    one = rg.launch_bwd(*(z[2:3].contiguous() for z in (x, a, h0, dy, dh)), cs(1))
    _equal_bits([z[2:3] for z in four], one)
    for tile_c in (8, 512, c):
        _equal_bits(four, rg.launch_bwd(x, a, h0, dy, dh, cs(b, tile_c)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,t,c,tile_c", [(4, 512, 2560, 512), (1, 37, 100, 48), (2, 1, 12, 8),
                                          (3, 600, 2560, 2560)])
def test_rglru_bwd_library_geometry_is_the_layout(card, dtype, b, t, c, tile_c):
    """The launch the library plans (CTAs, threads, stage, ring, shared
    bytes, CTAs an SM by the runtime's occupancy calculator, checkpoints)
    is ``bwd_geometry``'s: 3 CTAs an SM in bf16."""
    dt = getattr(torch, dtype)
    geo = rg.bwd_geometry(b, t, c, tile_c, dt)
    assert rg.bwd_library_geometry(b, t, c, tile_c, dt) == geo
    assert geo["resident"] == (3 if dt == torch.bfloat16 else 2)


def test_backward_kernels_bits_equal_run_to_run(card):
    """K1's (wgmma and fma bodies), K1g's, K2's (the tensor-core body, a GQA group of 10 split between
    CTAs, and the CUDA-core body), K3's and K4's backward give the same bits
    twice (no atomics)."""
    g = torch.Generator(device="cuda").manual_seed(9)
    bf = torch.bfloat16
    x = torch.randn((4, 64, 96), generator=g, device="cuda").to(bf)
    w = (torch.randn((4, 96, 130), generator=g, device="cuda") / 10).to(bf)
    dy = torch.randn((4, 64, 65), generator=g, device="cuda").to(bf)
    r, k, v = (torch.randn((2, 4, 50, 64), generator=g, device="cuda").to(bf) for _ in range(3))
    wd = torch.rand((2, 4, 50, 64), generator=g, device="cuda").to(bf)
    u, s0 = torch.randn((4, 64), device="cuda"), torch.randn((2, 4, 64, 64), device="cuda")
    dyr = torch.randn((2, 4, 50, 64), generator=g, device="cuda").to(bf)
    xr = torch.randn((2, 50, 2560), generator=g, device="cuda").to(bf)
    ar = torch.rand((2, 50, 2560), generator=g, device="cuda").to(bf)
    dyg = torch.randn((2, 50, 2560), generator=g, device="cuda").to(bf)
    qa = torch.randn((1, 10, 300, 256), generator=g, device="cuda")
    ka, va = (torch.randn((1, 1, 300, 256), generator=g, device="cuda") for _ in range(2))
    doa = torch.randn((1, 10, 300, 256), generator=g, device="cuda")
    assert fa.bwd_geometry(1, 10, 1, 300, 300, 256, bf)["parts"] == 10

    xk = torch.randn((2, 100, 96), generator=g, device="cuda").to(bf)
    wk = (torch.randn((96, 264), generator=g, device="cuda") / 10).to(bf)
    dyk = torch.randn((2, 100, 132), generator=g, device="cuda").to(bf)

    def run():
        leaves = [t.clone().requires_grad_() for t in (x, w)]
        out = list(torch.autograd.grad(ops.moe_gemm(*leaves, class_id="moe_gemm_silu_glu"),
                                       leaves, dy))
        for dt in (bf, torch.float32):
            leaves = [t.to(dt).clone().requires_grad_() for t in (xk, wk)]
            out += torch.autograd.grad(ops.matmul(*leaves, class_id="matmul_gelu_glu"), leaves,
                                       dyk.to(dt))
        leaves = [t.clone().requires_grad_() for t in (r, k, v, wd, u, s0)]
        out += torch.autograd.grad(ops.rwkv6(*leaves)[0], leaves, dyr)
        leaves = [t.clone().requires_grad_() for t in (xr, ar)]
        out += torch.autograd.grad(ops.rglru(*leaves, torch.zeros((2, 2560), device="cuda"))[0],
                                   leaves, dyg)
        for dt in (bf, torch.float32):
            leaves = [t.to(dt).clone().requires_grad_() for t in (qa, ka, va)]
            out += torch.autograd.grad(ops.flash_attention(*leaves, window=100, softcap=50.0),
                                       leaves, doa.to(dt))
        return out

    _equal_bits(run(), run())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rwkv6_backward_rows_do_not_depend_on_b(card, dtype):
    """K3's backward of a batch row at B = 4 and alone (B = 1), from a state
    passed in with the final state's gradient: dr, dk, dv, dw and the
    initial state's gradient bit-equal (every per-row sum in a fixed order
    that B does not change)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(13)
    b, h, t, d = 4, 2, 70, 64
    r, k, v, dy = (torch.randn((b, h, t, d), generator=g, device="cuda").to(dt) for _ in range(4))
    w = (0.05 + 0.9 * torch.rand((b, h, t, d), generator=g, device="cuda")).to(dt)
    u = torch.randn((h, d), generator=g, device="cuda")
    s0, ds = (torch.randn((b, h, d, d), generator=g, device="cuda") for _ in range(2))
    four = rw.launch_bwd(r, k, v, w, u, s0, dy, ds,
                         ops.schedule_for(ops.instance("rwkv6_scan", dt, T=t, C=h * d, D=d, B=b)))
    one = rw.launch_bwd(*(x[2:3].contiguous() for x in (r, k, v, w)), u, s0[2:3].contiguous(),
                        dy[2:3].contiguous(), ds[2:3].contiguous(),
                        ops.schedule_for(ops.instance("rwkv6_scan", dt, T=t, C=h * d, D=d, B=1)))
    torch.cuda.synchronize()
    for name, x4, x1 in zip(("dr", "dk", "dv", "dw", "du", "dstate"), four, one):
        if name != "du":   # du sums over the batch
            assert torch.equal(x4[2:3], x1), name


#: dynamic shared memory one CTA may have on the H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024
# K2's backward at the families' training shapes (B, Hq, Hkv, Sq, Skv, D):
# gemma2-2b, recurrentgemma-2b, mixtral-8x22b, minitron-4b, whisper-medium's
# encoder and cross-attention; then a prime length at an odd head dim
ATTN_BWD_GEOMETRY = [(4, 8, 4, 512, 512, 256), (4, 10, 1, 512, 512, 256), (4, 48, 8, 512, 512, 128),
                     (1, 24, 8, 512, 512, 128), (4, 16, 16, 1500, 1500, 64),
                     (4, 16, 16, 448, 1500, 64), (1, 6, 2, 181, 181, 100)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", ATTN_BWD_GEOMETRY)
def test_attention_bwd_library_geometry_is_the_layout(card, dtype, b, hq, hkv, sq, skv, d):
    """The CTAs the library launches are those of ``bwd_geometry``, and its
    shared bytes fit a CTA."""
    dt = getattr(torch, dtype)
    geo = fa.bwd_geometry(b, hq, hkv, sq, skv, d, dt)
    lib = fa.bwd_library_geometry(b, hq, hkv, sq, skv, d, dt)
    assert (lib["dq_ctas"], lib["dkv_ctas"]) == (geo["dq_ctas"], geo["dkv_ctas"])
    assert 0 < lib["dq_smem"] <= SMEM_LIMIT and 0 < lib["dkv_smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,h,t,d", [(4, 32, 512, 64), (1, 3, 37, 16), (3, 2, 1, 32)])
def test_rwkv6_bwd_library_geometry_is_the_layout(card, dtype, b, h, t, d):
    """The CTAs and clusters the library launches are those of
    ``bwd_geometry``; the reverse kernel leaves room for four CTAs an SM
    at rwkv6-1.6b's head dim in bf16 and fits one in f32."""
    dt = getattr(torch, dtype)
    geo = rw.bwd_geometry(b, h, t, d, dt)
    lib = rw.bwd_library_geometry(b, h, t, d, dt)
    assert (lib["ctas"], lib["cluster"]) == (geo["ctas"], geo["cluster"])
    assert 0 < lib["walk_smem"] <= lib["smem"] <= (SMEM_LIMIT // 4 if dt == torch.bfloat16 else SMEM_LIMIT)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rwkv6_backward_takes_an_unaligned_dy(card, dtype):
    """y's gradient as a contiguous view that starts off a 16-byte boundary:
    the autograd path copies it and the kernel gives the bits of an aligned
    copy; launch_bwd itself refuses it."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(17)
    b, h, t, d = 2, 2, 37, 64
    r, k, v = (torch.randn((b, h, t, d), generator=g, device="cuda").to(dt) for _ in range(3))
    w = (0.05 + 0.9 * torch.rand((b, h, t, d), generator=g, device="cuda")).to(dt)
    u = torch.randn((h, d), generator=g, device="cuda")
    s0 = torch.randn((b, h, d, d), generator=g, device="cuda")
    dy = torch.randn((b, h, t, d), generator=g, device="cuda").to(dt)
    odd = torch.empty(dy.numel() + 1, dtype=dt, device="cuda")[1:].view(dy.shape)
    odd.copy_(dy)
    assert odd.is_contiguous() and odd.data_ptr() % 16

    def grads(gy):
        leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
        return torch.autograd.grad(ops.rwkv6(*leaves)[0], leaves, gy)

    _equal_bits(grads(odd), grads(dy))
    cs = ops.schedule_for(ops.instance("rwkv6_scan", dt, T=t, C=h * d, D=d, B=b))
    with pytest.raises(ValueError, match="16-byte aligned"):
        rw.launch_bwd(r, k, v, w, u, s0, odd, None, cs)


def test_reduced_mixtral_steps_on_the_card_are_bit_equal(card):
    """Two train steps of mixtral (reduced, bf16) on the kernel path, run
    twice from the same weights: the losses, params and optimizer state
    bit-equal (the MoE dispatch's and combine's gradients add in a fixed
    order), through K1g's backward and no plain version."""
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(reduced(get_arch("mixtral-8x22b")), dtype="bfloat16")
    model = build_model(cfg, "cuda")
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (4, 24), generator=g).cuda()}
    runs = []
    ref.reset_calls()
    before = mm.grouped_grad_launches
    for _ in range(2):
        params = model.init(0)
        opt = steps.init_opt_state(params)
        step = steps.make_train_step(model, AdamWConfig(warmup_steps=1, total_steps=4))
        losses = [float(step(params, opt, batch)[2]["loss"]) for _ in range(2)]
        runs.append((losses, leaves({"params": params, "opt": opt})))
    assert mm.grouped_grad_launches > before and not ref.cuda_calls
    assert runs[0][0] == runs[1][0]
    for a, b_ in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a.reshape(-1).view(torch.uint8), b_.reshape(-1).view(torch.uint8))


def test_reduced_gemma2_trains_on_the_card_through_the_kernels(card):
    from repro_torch.launch import train as train_mod

    ref.reset_calls()
    before = (mm.grad_launches, fa.bwd_launches)
    res = train_mod.main(["--arch", "gemma2-2b", "--steps", "8", "--batch", "4", "--seq", "24",
                          "--log-every", "0"])
    assert res["steps"] == 8 and res["last_loss"] < res["first_loss"]
    assert mm.grad_launches > before[0] and fa.bwd_launches > before[1]
    assert not ref.cuda_calls


@pytest.mark.parametrize("kw", [{}, {"grad_accum": 2}, {"compress_grads": True}],
                         ids=["plain", "grad_accum", "compress"])
def test_sharded_step_at_world_1_under_nccl_is_bit_equal(card, tmp_path, kw):
    """One NCCL rank on the card (a FileStore, no network): two sharded
    steps (``dp``, a 1x1 mesh) give the unsharded steps' losses, params and
    optimizer state bit for bit, through the same kernel launches."""
    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.lm import trainable
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves, leaves_with_paths

    cfg = dataclasses.replace(reduced(get_arch("gemma2-2b")), dtype="bfloat16")
    model = build_model(cfg, "cuda")
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (4, 24), generator=g).cuda()}
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=4)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        step = steps.make_sharded_train_step(model, opt_cfg, make_test_mesh(model=1), **kw)
        full = model.init(0)
        params = step.shard_params(full)
        opt = step.init_opt_state(params)
        full_opt = steps.init_opt_state(full, compress_grads=kw.get("compress_grads", False))
        plain = steps.make_train_step(model, opt_cfg, **kw)
        launches, losses = [], []
        for fn, p, o in ((plain, full, full_opt), (step, params, opt)):
            before = (mm.launches, mm.grad_launches, fa.launches, fa.bwd_launches)
            losses.append([float(fn(p, o, batch)[2]["loss"]) for _ in range(2)])
            launches.append(tuple(a - b for a, b in zip(
                (mm.launches, mm.grad_launches, fa.launches, fa.bwd_launches), before)))
    finally:
        dist.destroy_process_group()
    assert losses[0] == losses[1] and launches[0] == launches[1]
    got, want = {"params": params, "opt": opt}, {"params": trainable(full), "opt": full_opt}
    for (path, a), b in zip(leaves_with_paths(got), leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                                  b.reshape(-1).view(torch.uint8)), path


#: K1's Z output per body (``launch(..., with_z=True)``, the dots remat
#: policy's): (class, dtype, M, K, N, schedule tiles or None, cache_write):
#: rows unsplit, rows split over K, rows in f32 and in rounding mode; the
#: tensor-core body, with a bias, ragged, in rounding mode (a K tile of 24
#: splits an MMA step); the CUDA-core body (f32)
Z_CASES = [("matmul_gelu_glu", "bfloat16", 4, 256, 1024, None, True),
           ("matmul_silu_glu", "bfloat16", 4, 3072, 256, None, True),
           ("matmul_bias_gelu", "float32", 4, 64, 200, None, True),
           ("matmul_bias_gelu", "bfloat16", 4, 1024, 512, {"M": 4, "N": 512, "K": 128}, False),
           ("matmul_gelu_glu", "bfloat16", 256, 512, 1024, None, True),
           ("matmul_bias_gelu", "bfloat16", 300, 256, 512, None, True),
           ("matmul_silu_glu", "bfloat16", 70, 33, 200, None, True),
           ("matmul_bias_gelu", "bfloat16", 256, 768, 512, {"M": 128, "N": 512, "K": 24}, False),
           ("matmul_bias_gelu", "float32", 130, 300, 96, None, True),
           ("matmul_silu_glu", "float32", 70, 33, 200, None, True)]


@pytest.mark.parametrize("class_id,dtype,m,k,n,tiles,cache_write", Z_CASES)
def test_k1_z_output_is_the_matmul_launch(card, class_id, dtype, m, k, n, tiles, cache_write):
    """Z is bit-equal to the ``matmul`` (with a bias, ``matmul_bias``)
    launch of the same schedule key, and Y's bits are the same with and
    without Z, in every body; Z within its dtype's tolerance of the plain
    version."""
    from repro_torch.core.schedule import Schedule, concretize

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(m + n + k)
    x = torch.randn((m, k), generator=g, device=card).to(dt)
    w = (torch.randn((k, n), generator=g, device=card) / k ** 0.5).to(dt)
    bias = torch.randn((n,), generator=g, device=card).to(dt) if "bias" in class_id else None
    kw = dict(class_id=class_id, bias=bias, residual=None, softcap=0.0)
    inst = ops.instance(class_id, dt, M=m, N=n, K=k)
    cs = (ops.schedule_for(inst) if tiles is None
          else concretize(Schedule.make(class_id, tiles, cache_write=cache_write), inst))
    key = mm.launch_key(x, w, cs, **kw)
    assert bool(key[3]) == (not cache_write)
    y0 = mm.launch_as(x, w, key, **kw)
    before = mm.z_launches
    y1, z = mm.launch_as(x, w, key, with_z=True, **kw)
    assert mm.z_launches == before + 1
    z_class = "matmul" if bias is None else "matmul_bias"
    zk = mm.launch_as(x, w, key, class_id=z_class, bias=bias, residual=None, softcap=0.0)
    torch.cuda.synchronize()
    assert torch.equal(y0.view(torch.uint8), y1.view(torch.uint8))
    assert torch.equal(z.view(torch.uint8), zk.view(torch.uint8))
    _close(z, ref.matmul(x, w, z_class, bias=bias, round_k=key[3]),
           TOL if dt == torch.float32 else BF16_TOL)


def test_dots_training_saves_k1_outputs_on_the_card(card):
    """gemma2 at reduced width in bf16: under ``dots`` the loss equals
    ``full``'s bit for bit, one gradient launch fewer per GeGLU layer, the
    layers' K1 forward launches once, and every GeGLU launch wrote Z."""
    from repro_torch.distributed.context import using_remat_policy
    from repro_torch.launch import steps

    cfg = dataclasses.replace(reduced(get_arch("gemma2-2b")), dtype="bfloat16")
    model = build_model(cfg, card)
    params = model.init(0)
    g = torch.Generator(device=card).manual_seed(0)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (2, 16), generator=g, device=card)}
    runs = {}
    for policy in ("full", "dots"):
        mm.reset_launches()
        with using_remat_policy(policy):
            loss, _, _ = steps.value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        runs[policy] = (float(loss), mm.launches - mm.grad_launches, mm.grad_launches,
                        mm.z_launches)
    (l_full, f_full, g_full, z_full), (l_dots, f_dots, g_dots, z_dots) = runs["full"], runs["dots"]
    assert l_full == l_dots
    assert g_full - g_dots == cfg.n_layers == z_dots and z_full == 0
    assert f_full == 2 * f_dots - 1    # the LM head runs once under both


def _fwd_bwd(fn, args, backend):
    """``fn(*args)``'s output and the gradients of its inputs under a fixed
    output gradient, on one backend."""
    with use_backend(backend):
        out = fn(*args)
        y = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(y, args, torch.full_like(y, 0.01))
    return y, grads


def _bf16(g, *shape, scale=1.0, low=None):
    x = torch.randn(shape, generator=g, device="cuda") * scale
    if low is not None:                          # a decay in (low, low + 0.5)
        x = torch.rand(shape, generator=g, device="cuda") * 0.5 + low
    return x.to(torch.bfloat16).requires_grad_(True)


#: the kernels at the local shapes tensor-parallel compute gives them: K2
#: with 2 q heads and 1 KV head a rank (gemma2-2b's local layer at model 4),
#: K1g with 2 experts a rank (mixtral-8x22b's up-GEMM at model 4), K4 over
#: 640 channels (recurrentgemma-2b's 2560 at model 4)
TP_LOCAL_CASES = {
    "attention_1kv": (lambda q, k, v: ops.flash_attention(
        q, k, v, class_id="flash_attention_local", causal=True, window=4096, softcap=0.0),
        lambda g: (_bf16(g, 2, 2, 256, 256), _bf16(g, 2, 1, 256, 256), _bf16(g, 2, 1, 256, 256))),
    "grouped_2_experts": (lambda x, w: ops.moe_gemm(x, w, class_id="moe_gemm_silu_glu"),
                          lambda g: (_bf16(g, 2, 64, 6144, scale=0.1),
                                     _bf16(g, 2, 6144, 32768, scale=0.02))),
    "rglru_640": (lambda x, a: ops.rglru(x, a, torch.zeros((2, 640), device="cuda")),
                  lambda g: (_bf16(g, 2, 256, 640), _bf16(g, 2, 256, 640, low=0.4))),
}


@pytest.mark.parametrize("name", sorted(TP_LOCAL_CASES))
def test_kernels_at_tensor_parallel_local_shapes(card, name):
    """Forward at the bf16 tolerance, each input's gradient within 1e-2 of
    its largest entry plus 3e-2 relative (K1's backward bound in
    ``chip_smoke.py``)."""
    fn, make = TP_LOCAL_CASES[name]
    args = make(torch.Generator(device="cuda").manual_seed(3))
    y, grads = _fwd_bwd(fn, args, "cuda")
    y_ref, grads_ref = _fwd_bwd(fn, args, "ref")
    _close(y, y_ref, BF16_TOL)
    for a, b in zip(grads, grads_ref):
        scale = float(b.float().abs().max())
        _close(a.float(), b.float(), dict(atol=1e-2 * scale, rtol=3e-2))


#: K1's f32 output mode (ROADMAP C.13) at row-parallel shapes: minitron-4b's
#: ``wo`` at model 4 (decode, the rows body; a 512-token prefill, mma), an
#: f32 launch (fma), a split-K rows launch and K1g's TP fallback (an
#: expert's ``w_out`` cut along d_ff)
F32_OUT_CASES = [("matmul", 4, 768, 3072, "bfloat16"), ("matmul", 512, 768, 3072, "bfloat16"),
                 ("matmul_bias", 70, 200, 33, "bfloat16"), ("matmul", 96, 80, 40, "float32"),
                 ("matmul", 2, 4096, 256, "bfloat16")]


@pytest.mark.parametrize("class_id,m,k,n,dtype", F32_OUT_CASES)
def test_f32_output_mode_matches_plain(card, class_id, m, k, n, dtype):
    """Y in f32 against the plain version's f32 sum (``ref.matmul(...,
    out_f32=True)``) at f32's tolerance; the launch without the mode is the
    f32 launch's Y rounded, bit for bit (the same sums, their bits kept)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(m + n)
    x = torch.randn((m, k), generator=g, device="cuda").to(dt)
    w = (torch.randn((k, n), generator=g, device="cuda") * k ** -0.5).to(dt)
    bias = torch.randn((n,), generator=g, device="cuda").to(dt) if class_id == "matmul_bias" else None
    cs = ops.schedule_for(ops.instance(class_id, dt, M=m, N=n, K=k))
    got = mm.launch(x, w, cs, class_id=class_id, bias=bias, out_f32=True)
    assert got.dtype == torch.float32
    _close(got, ref.matmul(x, w, class_id, bias=bias, out_f32=True), TOL)
    assert torch.equal(got.to(dt), mm.launch(x, w, cs, class_id=class_id, bias=bias))


def test_grouped_f32_output_mode_matches_plain(card):
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((2, 64, 1024), generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((2, 1024, 768), generator=g, device="cuda") / 32).to(torch.bfloat16)
    cs = ops.schedule_for(ops.instance("moe_gemm", torch.bfloat16, M=128, N=768, K=1024, E=2))
    got = mm.grouped_launch(x, w, cs, out_f32=True)
    assert got.dtype == torch.float32
    _close(got, ref.grouped_matmul(x, w, out_f32=True), TOL)
    assert torch.equal(got.to(torch.bfloat16), mm.grouped_launch(x, w, cs))


#: the gradient launch's f32 mode: gemma2-2b's GeGLU ``w_in`` dX at model 4
#: (dY 2048 x 4608 against wᵀ, wgmma), the same through mma's operand
#: modes (an unaligned N), and K1g's dX per expert
F32_GRAD_CASES = [(2048, 4608, 2304, 0), (130, 70, 33, 0), (64, 256, 192, 3)]


@pytest.mark.parametrize("m,k,n,e", F32_GRAD_CASES)
def test_f32_gradient_mode_matches_plain(card, m, k, n, e):
    """dX = dZ·wᵀ (wᵀ a view) in f32 against the plain version's f32 sum;
    without the mode, the f32 result rounded, bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(m + k)
    dz = _operand(g, e, m, k, 0, torch.bfloat16)
    wt = _operand(g, e, k, n, 1, torch.bfloat16, k ** -0.5)
    if e:
        got, plain = mm.grouped_grad_launch(dz, wt, out_f32=True), mm.grouped_grad_launch(dz, wt)
        want = ref.grouped_matmul(dz, wt, out_f32=True)
    else:
        got, plain = mm.grad_launch(dz, wt, out_f32=True), mm.grad_launch(dz, wt)
        want = ref.matmul(dz, wt, out_f32=True)
    assert got.dtype == torch.float32
    _close(got, want, TOL)
    assert torch.equal(got.to(torch.bfloat16), plain)


# ---------------------------------------------------------------------------
# dbrx-132b's expert GEMMs and mixtral-8x22b's paged engine at full width
# ---------------------------------------------------------------------------

#: dbrx-132b's expert GEMMs, (class, E, K, N): the up-GEMM's w stack holds
#: 16 · 6144 · 21504 = 2.1e9 bf16 values (4.2 GB), so expert offsets pass
#: 2^32 bytes
DBRX_EXPERT_GEMMS = [("moe_gemm_silu_glu", 16, 6144, 21504), ("moe_gemm", 16, 10752, 6144)]


@pytest.mark.parametrize("rows", [4, 64])
@pytest.mark.parametrize("class_id,e,k,n", DBRX_EXPERT_GEMMS)
def test_grouped_matmul_at_dbrx_expert_shapes(card, class_id, e, k, n, rows):
    """K1g at dbrx's two expert GEMMs under the default schedule, 4 rows per
    expert (decode: the rows body) and 64 (a chunk: the tensor cores),
    against the plain version, the last expert (past 2^32 bytes in the up
    stack) held on its own too."""
    g = torch.Generator(device=card).manual_seed(rows + n)
    x = torch.randn((e, rows, k), generator=g, device=card).to(torch.bfloat16)
    w = torch.empty((e, k, n), dtype=torch.bfloat16, device=card)
    for i in range(e):   # one expert's f32 draw at a time
        w[i] = torch.randn((k, n), generator=g, device=card) / k ** 0.5
    cs = ops.schedule_for(ops.instance(class_id, torch.bfloat16, M=rows * e, N=n, K=k, E=e))
    body = mm.body_for(torch.bfloat16, mm.schedule_key(cs)[0])
    assert body == ("rows" if rows <= 16 else "mma")
    before = mm.body_count(body, kernel="grouped_matmul", dtype=torch.bfloat16)
    got = ops.moe_gemm(x, w, class_id=class_id)
    assert mm.body_count(body, kernel="grouped_matmul", dtype=torch.bfloat16) == before + 1
    want = ops.moe_gemm(x, w, class_id=class_id, backend="ref")
    _close(got, want, BF16_TOL)
    _close(got[-1], ref.matmul(x[-1], w[-1], class_id.replace("moe_gemm", "matmul")), BF16_TOL)


def test_paged_engine_streams_equal_slot_at_full_width_mixtral(card):
    """mixtral-8x22b at full width with 1 layer: the paged engine (4 lanes,
    pages of 16, chunks of 64) gives the slot engine's streams (exact-length
    prefill), at prompt lengths whose one-shot prefill takes no rows-body
    tile in K1, K1g or the router, as the chunks do; K1g runs in the chunks
    on the tensor cores and in decode on the rows body."""
    import numpy as np

    from repro_torch.serving import PagedServingEngine

    cfg = dataclasses.replace(get_arch("mixtral-8x22b"), n_layers=1)
    model = build_model(cfg, card)
    params = model.init(seed=0)
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, size=n)]
               for n in (100, 150, 96, 120)]
    slot = ServingEngine(model, params, slots=4, max_len=512, prefill_buckets=False)
    want = [slot.add_request(p, max_new_tokens=8) for p in prompts]
    slot.run_to_completion()
    del slot
    mm.reset_launches()
    eng = PagedServingEngine(model, params, decode_batch=4, max_ctx=512, page_size=16, chunk=64)
    got = [eng.add_request(p, max_new_tokens=8) for p in prompts]
    eng.run_to_completion(max_steps=512)
    assert eng.prefill_padded_tokens == eng.prefill_true_tokens == sum(map(len, prompts))
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 8 for r in got)
    for body in ("mma", "rows"):
        assert mm.body_count(body, kernel="grouped_matmul", dtype=torch.bfloat16) > 0
