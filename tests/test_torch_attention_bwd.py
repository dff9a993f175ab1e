"""What the CPU reaches of K2's backward: the plain row log-sum-exp that
the forward kernel writes for it, and the backward's launch geometry.

``repro_torch.kernels.ref.attention_lse`` is the plain version of the
forward's ``lse`` output (``flash_attention.launch(..., with_lse=True)``),
which ``FlashAttentionFn`` saves for the backward.  Here it is held to a
float64 numpy log-sum-exp of the reference's masked, softcapped scores:
``repro.kernels.ref``'s own mask (``_mask_bias``) on numpy-seeded q and k.
The port sums its scores in f32 in another order, so the two agree within
2e-5 of the row's value (scores of order 1, rows of up to 200 keys).

``flash_attention.bwd_geometry`` is the backward's launch layout in pure
Python (the library plans the launch from its ``parts``, and the card's
tests hold its CTAs and shared bytes to this): every family's training
shape and head dim must be taken, and what the kernels refuse must raise
here.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

LSE_TOL = 2e-5


def _lse_f64(q, k, *, causal, window, softcap, q_offset):
    """float64 log-sum-exp of the reference's masked, softcapped scores;
    +inf for a fully masked row (the kernels' convention)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.astype(np.float64).reshape(b, hkv, hq // hkv, sq, d)
    s = np.einsum("bhgqd,bhkd->bhgqk", qg, k.astype(np.float64)) * d ** -0.5
    if softcap > 0:
        s = np.tanh(s / softcap) * softcap
    s = s + np.asarray(jref._mask_bias(sq, skv, q_offset, causal, window), np.float64)
    m = s.max(axis=-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        lse = (m + np.log(np.exp(s - m).sum(axis=-1, keepdims=True)))[..., 0]
    return np.where(np.isfinite(lse), lse, np.inf).reshape(b, hq, sq)


# (b, hq, hkv, sq, skv, d, causal, window, softcap, q_offset): causal, a
# window, non-causal, cross (Sq != Skv), softcap, GQA 3 and 10, and rows
# that mask every key (a causal row before the first key)
LSE_CASES = [(2, 4, 2, 37, 37, 16, True, 0, 0.0, 0),
             (1, 6, 2, 64, 64, 32, True, 8, 0.0, 0),
             (1, 3, 3, 50, 50, 16, False, 0, 0.0, 0),
             (2, 4, 4, 24, 150, 16, False, 0, 0.0, 0),
             (1, 10, 1, 45, 45, 64, True, 16, 50.0, 0),
             (1, 2, 1, 20, 20, 16, True, 0, 0.0, -3),
             (1, 4, 2, 97, 200, 32, True, 0, 2.0, 100)]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,softcap,q_offset", LSE_CASES)
def test_attention_lse_matches_reference(b, hq, hkv, sq, skv, d, causal, window, softcap, q_offset):
    rng = np.random.default_rng(sq + skv + d)
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    got = ref.attention_lse(torch.from_numpy(q), torch.from_numpy(k), **kw)
    want = _lse_f64(q, k, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, hq, sq)
    got = got.numpy().astype(np.float64)
    masked = np.isinf(want)
    assert np.array_equal(np.isinf(got), masked) and (got[masked] > 0).all()
    assert masked.any() == (q_offset < 0)
    np.testing.assert_allclose(got[~masked], want[~masked], rtol=LSE_TOL, atol=LSE_TOL)


def test_attention_lse_normalises_the_plain_attention():
    """exp(s - lse) is the softmax the plain attention applies: P V with it
    is ``ref.attention``'s output (f32, the same scores)."""
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((1, h, 40, 16), generator=g) for h in (4, 2, 2))
    kw = dict(causal=True, window=12, softcap=30.0)
    lse = ref.attention_lse(q, k, **kw)
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.reshape(1, 2, 2, 40, 16), k) * 16 ** -0.5
    s = torch.tanh(s / 30.0) * 30.0
    s = torch.where(ref._mask_ok(40, 40, 0, True, 12, "cpu"), s, float("-inf"))
    p = torch.exp(s - lse.reshape(1, 2, 2, 40, 1))
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v).reshape(1, 4, 40, 16)
    torch.testing.assert_close(o, ref.attention(q, k, v, **kw), rtol=1e-5, atol=1e-5)


# the families' training shapes, (B, Hq, Hkv, Sq, Skv, D): gemma2-2b,
# recurrentgemma-2b, mixtral-8x22b, minitron-4b, whisper-medium's encoder,
# decoder and cross-attention; then the reduced test configs' head dims
FAMILY_SHAPES = [(4, 8, 4, 512, 512, 256), (4, 10, 1, 512, 512, 256), (4, 48, 8, 512, 512, 128),
                 (1, 24, 8, 512, 512, 128), (4, 16, 16, 1500, 1500, 64), (4, 16, 16, 448, 448, 64),
                 (4, 16, 16, 448, 1500, 64), (2, 4, 2, 24, 24, 16), (1, 6, 2, 181, 181, 100),
                 (1, 4, 4, 1, 1, 8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", FAMILY_SHAPES)
def test_attention_bwd_geometry_takes_family_shapes(dtype, b, hq, hkv, sq, skv, d):
    geo = fa.bwd_geometry(b, hq, hkv, sq, skv, d, dtype)
    group = hq // hkv
    assert geo["body"] == fa.body_for(dtype)
    assert group % geo["parts"] == 0
    if geo["body"] == "mma":
        rows = fa.BWD_CTA_ROWS
        base = -(-skv // rows) * geo["col_blocks"] * b * hkv
        assert geo["col_blocks"] == (2 if d > 128 else 1)
        assert geo["dq_ctas"] == -(-sq // rows) * b * hq and geo["dkv_ctas"] == base * geo["parts"]
        # the fewest parts that reach the fill, or the whole group split
        fill = [p for p in range(1, group + 1) if group % p == 0 and base * p >= fa.BWD_FILL]
        assert geo["parts"] == (fill[0] if fill else group)
    else:
        assert (geo["parts"], geo["col_blocks"]) == (1, 1)
        assert geo["dq_ctas"] == -(-sq // 16) * b * hq and geo["dkv_ctas"] == -(-skv // 16) * b * hkv


@pytest.mark.parametrize("shape,parts,dkv_ctas", [((4, 8, 4, 512, 512, 256), 1, 256),
                                                  ((4, 10, 1, 512, 512, 256), 5, 320),
                                                  ((4, 48, 8, 512, 512, 128), 1, 256),
                                                  ((1, 24, 8, 512, 512, 128), 3, 192),
                                                  ((4, 16, 16, 448, 1500, 64), 1, 1536)])
def test_attention_bwd_geometry_fills_the_card(shape, parts, dkv_ctas):
    """recurrentgemma's one kv head is split five ways and minitron's
    groups three ways; gemma2's D = 256 splits its columns in two."""
    geo = fa.bwd_geometry(*shape, torch.bfloat16)
    assert (geo["parts"], geo["dkv_ctas"]) == (parts, dkv_ctas)


@pytest.mark.parametrize("args,match", [((1, 2, 2, 8, 8, 257, torch.bfloat16), "head dims"),
                                        ((1, 3, 2, 8, 8, 64, torch.bfloat16), "Hq % Hkv"),
                                        ((1, 2, 2, 0, 8, 64, torch.bfloat16), ">= 1"),
                                        ((0, 2, 2, 8, 8, 64, torch.float32), ">= 1"),
                                        ((1, 70000, 1, 8, 8, 64, torch.float32), "65535")])
def test_attention_bwd_geometry_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        fa.bwd_geometry(*args)


def test_attention_backward_launch_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 5, 16))
    lse = torch.zeros((1, 2, 5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.launch_bwd(q, q, q, q, lse, q)
