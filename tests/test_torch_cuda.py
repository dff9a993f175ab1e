"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need a CUDA card and nvcc, and skip where there is
none.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

f32 throughout, tolerance rtol = atol = 2e-4 (the repo's f32 kernel
tolerance); the plain versions run in full f32 (TF32 off).  This file
imports no JAX: the card's machine need not have it.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels.ops import use_backend
from repro_torch.models import build_model
from repro_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda
TOL = dict(rtol=2e-4, atol=2e-4)


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


def _close(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


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


# reduced minitron, and a variant whose layers drive the window, softcap,
# GLU and softcapped-head paths of both kernels
CONFIGS = {"minitron": {},
           "local_global_softcap_geglu": dict(layer_pattern=("L", "G"), window=8,
                                              attn_softcap=50.0, final_softcap=30.0,
                                              tie_embeddings=True, mlp_kind="geglu")}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def reduced_model(card, request):
    cfg = dataclasses.replace(reduced(get_arch("minitron-4b")), **CONFIGS[request.param])
    model = build_model(cfg, card)
    return model, model.init(seed=0)


def test_reduced_model_kernel_path_matches_plain_path(reduced_model):
    model, params = reduced_model
    toks = torch.randint(1, 512, (2, 12), generator=torch.Generator().manual_seed(0)).to(model.device)
    launches = (mm.launches, fa.launches)
    lk, ck = model.prefill(params, {"tokens": toks}, max_len=32, true_len=9)
    with use_backend("ref"):
        lr, cr = model.prefill(params, {"tokens": toks}, max_len=32, true_len=9)
    _close(lk, lr)
    assert mm.launches > launches[0] and fa.launches > launches[1]
    for step in range(3):
        feed = toks[:, step]
        lk, ck = model.decode_step(params, ck, feed)
        with use_backend("ref"):
            lr, cr = model.decode_step(params, cr, feed)
        _close(lk, lr)


def test_engine_on_the_card_finishes_requests(reduced_model):
    model, params = reduced_model
    eng = ServingEngine(model, params, slots=2, max_len=32)
    before = mm.launches
    reqs = [eng.add_request([1, 2, 3], max_new_tokens=4),
            eng.add_request([4, 5, 6, 7, 8], max_new_tokens=3)]
    eng.run_to_completion()
    assert [len(r.generated) for r in reqs] == [4, 3]
    assert mm.launches > before
    assert all(r.done for r in reqs)
