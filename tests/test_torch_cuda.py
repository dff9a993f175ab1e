"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need a CUDA card and nvcc, and skip where there is
none.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

f32 at rtol = atol = 2e-4 (the repo's f32 kernel tolerance), bf16 scan
outputs at 3e-2 (one bf16 rounding of f32 values computed in another
order; the scans' f32 states stay at 2e-4); the plain versions run in full
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


@pytest.mark.parametrize("class_id", ref.MATMUL_CLASSES)
@pytest.mark.parametrize("m,n,k", [(4, 64, 96), (3, 50, 17), (4, 1000, 64), (96, 80, 40)])
def test_matmul_kernel_matches_plain(card, class_id, m, n, k):
    g = torch.Generator(device=card).manual_seed(m + n + k)
    x = torch.randn((m, k), generator=g, device=card)
    w = torch.randn((k, n), generator=g, device=card) / k ** 0.5
    bias = torch.randn((n,), generator=g, device=card) if "bias" in class_id else None
    out_n = n // 2 if "glu" in class_id else n
    residual = torch.randn((m, out_n), generator=g, device=card) \
        if class_id == "matmul_residual" else None
    softcap = 2.0 if "softcap" in class_id else 0.0
    kw = dict(class_id=class_id, bias=bias, residual=residual, softcap=softcap)
    before = mm.launches
    got = ops.matmul(x, w, **kw)
    assert mm.launches == before + 1
    _close(got, ops.matmul(x, w, backend="ref", **kw))


@pytest.mark.parametrize("sq,skv,d,group,causal,window,softcap,q_offset", [
    (40, 40, 16, 2, True, 0, 0.0, 0),
    (33, 70, 64, 3, True, 0, 0.0, 37),
    (64, 64, 128, 1, True, 16, 0.0, 0),
    (50, 50, 128, 3, False, 0, 0.0, 0),
    (20, 20, 256, 2, True, 0, 30.0, 0),
    (1, 90, 80, 3, True, 0, 0.0, 89),
])
def test_attention_kernel_matches_plain(card, sq, skv, d, group, causal, window, softcap, q_offset):
    g = torch.Generator(device=card).manual_seed(sq + skv + d)
    q = torch.randn((2, 2 * group, sq, d), generator=g, device=card)
    k = torch.randn((2, 2, skv, d), generator=g, device=card)
    v = torch.randn((2, 2, skv, d), generator=g, device=card)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    before = fa.launches
    got = ops.flash_attention(q, k, v, **kw)
    assert fa.launches == before + 1
    _close(got, ref.attention(q, k, v, **kw))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("class_id", ref.GROUPED_CLASSES)
@pytest.mark.parametrize("e,m,n,k,tile_m", [(1, 6, 64, 40, None), (3, 20, 48, 33, None),
                                            (8, 4, 96, 64, None), (8, 300, 64, 32, None),
                                            (3, 13, 50, 24, 8)])
def test_grouped_kernel_matches_plain(card, dtype, class_id, e, m, n, k, tile_m):
    """E = 1/3/8, decode-shaped m = 4, m = 300 under the default tile of 120
    (ragged inside each expert, tiled body), 13 under a rows-body tile of 8."""
    from repro_torch.core.schedule import Schedule, concretize

    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(e + m + n + k)
    x = torch.randn((e, m, k), generator=g, device=card).to(dt)
    w = (torch.randn((e, k, n), generator=g, device=card) / k ** 0.5).to(dt)
    cs = ops.schedule_for(ops.instance(class_id, dt, M=m * e, N=n, K=k, E=e))
    if tile_m is not None:
        cs = concretize(Schedule.make(class_id, {"M": tile_m, "N": cs.t["N"], "K": k, "E": 1}),
                        cs.instance)
    before = mm.grouped_launches
    got = mm.grouped_matmul(x, w, cs, class_id=class_id)
    assert mm.grouped_launches == before + 1 and got.dtype == dt
    _close(got, ref.grouped_matmul(x, w, class_id), TOL if dt == torch.float32 else BF16_TOL)


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
