"""K1's and K1g's backward on transposed views, on the CPU.

``MatmulFn.backward`` and ``GroupedMatmulFn.backward`` hand the gradient
launch views (``w.T``, ``x.T``, ``dz.T``, ``.transpose(1, 2)``) and make no
transposed copy; ``kernels/matmul.py`` ``grad_geometry`` reads each
operand's layout from its strides and picks the body (``wgmma``, ``mma``
with operand modes, ``fma``).  Here, where a tensor on the CPU takes the
plain version (``ref.matmul``, ``ref.grouped_matmul`` on the same views):

* the dispatch rule at every training shape ``chip_smoke.py`` checks
  (``MM_BWD_SHAPES``, ``MOE_BWD_SHAPES``), whisper-medium's 51865-wide tied
  head and f32, on meta tensors (layouts without data);
* the plain version on each view layout equals it on the contiguous copy;
* both backwards, called on the CPU, against ``jax.vjp`` of the
  reference's ``repro.kernels.ref.matmul`` (and its ``jax.vmap``, the
  grouped kernel's oracle) on numpy-seeded f32 inputs: every gradient
  within 2e-4 of its largest entry (the two sum f32 products in other
  orders).
"""
import importlib.util
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as jref
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ref

GRAD_REL = 2e-4
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _k1_launches(class_id, m, k, n, tied, dtype=torch.bfloat16):
    """The gradient launches MatmulFn.backward makes at one K1 shape, as
    (name, a, b) views of meta tensors: dX, dW (a tied head: dE) and, for
    the gelu and GLU classes, the recomputed pre-activation."""
    x, w, dz = _meta(m, k, dtype=dtype), _meta(k, n, dtype=dtype), _meta(m, n, dtype=dtype)
    out = []
    if tied:
        emb = _meta(n, k, dtype=dtype)
        out += [("dx", dz, emb), ("dsrc", dz.T, x)]
    else:
        out += [("dx", dz, w.T), ("dw", x.T, dz)]
    if class_id in ("matmul_bias_gelu", "matmul_silu_glu", "matmul_gelu_glu"):
        out.append(("z", x, w))
    return out


def _k1g_launches(e, m, k, n, dtype=torch.bfloat16):
    x, w, dz = _meta(e, m, k, dtype=dtype), _meta(e, k, n, dtype=dtype), _meta(e, m, n, dtype=dtype)
    return [("dx", dz, w.transpose(1, 2)), ("dw", x.transpose(1, 2), dz), ("z", x, w)]


@pytest.mark.parametrize("name,class_id,m,k,n", SMOKE.MM_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dispatch_rule_at_gemma2_training_shapes(name, class_id, m, k, n, dtype):
    """Every bf16 gradient launch of gemma2-2b's training step takes
    ``wgmma`` (the tied head's dE too), every f32 one ``fma``; the wgmma
    body's 128x128 CTAs cover the default schedule's logical tiles."""
    for part, a, b in _k1_launches(class_id, m, k, n, tied=name == "head", dtype=dtype):
        geo = mm.grad_geometry(a, b)
        assert geo["body"] == ("wgmma" if dtype == torch.bfloat16 else "fma"), (name, part)
        cs = mm.grad_schedule("matmul", dtype, a.shape[0], b.shape[1], a.shape[1])
        tile_m, tile_n, *_ = mm.schedule_key(cs)
        cta_m, cta_n, ctas = mm.grad_cta(geo["body"], a.shape[0], b.shape[1], tile_m, tile_n)
        assert ctas == mm.cta_count(a.shape[0], b.shape[1], tile_m, tile_n, cta_m, cta_n)


@pytest.mark.parametrize("class_id,e,m,k,n", SMOKE.MOE_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dispatch_rule_at_mixtral_training_shapes(class_id, e, m, k, n, dtype):
    for part, a, b in _k1g_launches(e, m, k, n, dtype):
        geo = mm.grad_geometry(a, b)
        assert geo["body"] == ("wgmma" if dtype == torch.bfloat16 else "fma"), part
        assert geo["a"][2] and geo["b"][2]          # expert strides read from the views


@pytest.mark.parametrize("arch_shapes", [("rwkv6-1.6b", 2048, 2048, 65536, 7168),
                                         ("recurrentgemma-2b", 2048, 2560, 256000, 15360)])
def test_dispatch_rule_at_the_recurrent_families(arch_shapes):
    """rwkv6-1.6b's and recurrentgemma-2b's projections and tied heads at 4 x
    512 tokens: every bf16 gradient launch on ``wgmma``."""
    _, tokens, d, vocab, ff = arch_shapes
    for n in (d, ff, vocab):
        for part, a, b in _k1_launches("matmul", tokens, d, n, tied=n == vocab):
            assert mm.grad_geometry(a, b)["body"] == "wgmma", (n, part)


@pytest.mark.parametrize("tied", [False, True])
def test_dispatch_rule_at_whisper_head(tied):
    """whisper-medium's LM head (vocab 51865: dZ's and the head weight's
    rows are 103730 bytes, not a multiple of 16; its head is untied, a tied
    one is checked too) takes ``mma`` with operand modes in bf16, ``fma`` in
    f32; its other projections take ``wgmma``."""
    tokens, d, vocab = 4 * 448, 1024, 51865
    for part, a, b in _k1_launches("matmul_lmhead", tokens, d, vocab, tied=tied):
        assert mm.grad_geometry(a, b)["body"] == "mma", part
        assert mm.grad_geometry(a.float(), b.float())["body"] == "fma", part
    for part, a, b in _k1_launches("matmul_gelu_glu", tokens, d, 8192, tied=False):
        assert mm.grad_geometry(a, b)["body"] == "wgmma", part
    dz = _meta(tokens, vocab)
    assert mm.operand_layout(dz) == (0, vocab, 0)
    assert mm.operand_layout(dz.T) == (1, vocab, 0)


@pytest.mark.parametrize("part,want", [("dx", (128, 128, 1152)), ("dw", (128, 128, 35280))])
def test_internvl2_head_gradient_geometry(part, want):
    """internvl2-26b's LM head on its training path (``chip_smoke.py``
    ``INTERNVL2_HEAD``: 3072 rows, d_model 6144, vocab 92553): both gradient
    launches take ``mma`` with operand modes (rows of 92553 values are not
    16-byte aligned).  dW's own default schedule has an N tile of 3, so a
    128-column CTA covers 42 logical tiles (126 live columns): 48 × 735
    CTAs, where one CTA a tile launched 2961696 of 3 live columns; dX's N
    is d_model, its tiles wide, its CTAs as before."""
    t, d, v = SMOKE.INTERNVL2_HEAD
    x, w, dz = _meta(t, d), _meta(d, v), _meta(t, v)
    a, b = {"dx": (dz, w.T), "dw": (x.T, dz)}[part]
    geo = mm.grad_geometry(a, b)
    assert geo["body"] == "mma"
    m, n = a.shape[0], b.shape[1]
    assert (geo["tile_m"], geo["tile_n"]) == ((128, 3) if part == "dw" else (128, 512))
    got = mm.grad_cta("mma", m, n, geo["tile_m"], geo["tile_n"])
    assert got == want
    assert mm.n_group(n, geo["tile_n"], got[1]) == (42 if part == "dw" else 1)


def test_operand_layout_reads_the_strides():
    x = torch.zeros((6, 10))
    assert mm.operand_layout(x) == (0, 10, 0)
    assert mm.operand_layout(x.T) == (1, 10, 0)
    assert mm.operand_layout(x[:, :4]) == (0, 10, 0)              # a column slice keeps its stride
    assert mm.operand_layout(x[:1]) == (0, 10, 0)                 # one row: its stride is never read
    assert mm.operand_layout(x[:, :1].T) == (1, 10, 0)            # (1, 6) from a column
    e = torch.zeros((3, 6, 10))
    assert mm.operand_layout(e) == (0, 10, 60)
    assert mm.operand_layout(e.transpose(1, 2)) == (1, 10, 60)
    with pytest.raises(ValueError, match="contiguous"):
        mm.operand_layout(x[::2, ::2])
    with pytest.raises(ValueError, match="overlap"):
        mm.operand_layout(torch.zeros(30).as_strided((6, 10), (4, 1)))


def test_dispatch_rule_by_alignment():
    """bf16 takes ``wgmma`` only where both operands' base, row stride and
    expert stride are multiples of 16 bytes."""
    base = torch.zeros((64, 80), dtype=torch.bfloat16)
    b = torch.zeros((80, 48), dtype=torch.bfloat16)
    assert mm.grad_geometry(base, b)["body"] == "wgmma"
    assert mm.grad_geometry(base[:, 1:], b[1:])["body"] == "mma"        # base off 16 bytes
    assert mm.grad_geometry(base[:, :79], b[:79])["body"] == "wgmma"    # ragged K, strides aligned
    odd = torch.zeros((64, 81), dtype=torch.bfloat16)[:, :80]           # row stride 162 bytes
    assert mm.operand_layout(odd)[1] == 81
    assert mm.grad_geometry(odd, b)["body"] == "mma"
    assert mm.grad_geometry(b.T, odd.T)["body"] == "mma"
    e = torch.zeros((3, 5, 16), dtype=torch.bfloat16)                   # expert stride 160 bytes
    assert mm.grad_geometry(e, torch.zeros((3, 16, 8), dtype=torch.bfloat16))["body"] == "wgmma"
    e = torch.zeros(75, dtype=torch.bfloat16).as_strided((3, 3, 8), (25, 8, 1))   # 50 bytes
    assert mm.grad_geometry(e, torch.zeros((3, 8, 8), dtype=torch.bfloat16))["body"] == "mma"
    assert mm.grad_geometry(e[:1], torch.zeros((1, 8, 8), dtype=torch.bfloat16))["body"] == "wgmma"
    with pytest.raises(ValueError, match="one dtype"):
        mm.grad_geometry(base, b.float())


@pytest.mark.parametrize("m,n,tile_n,groups,want", [
    (2304, 18432, 512, 1, 256),      # gemma2's GeGLU up dW: 1296 CTAs of 128x256
    (2048, 9216, 512, 1, 256),       # its down dX
    (2048, 2304, 384, 1, 128),       # q dX: a 384-column tile would leave half a CTA idle
    (2304, 2048, 512, 1, 128),       # q dW: 144 wide CTAs, under two waves
    (6144, 32768, 512, 8, 256),      # mixtral's up dW, per expert
    (2048, 256, 256, 3, 128)])       # 24 wide CTAs over 3 experts
def test_wgmma_cta_tile_rule(m, n, tile_n, groups, want):
    cta_m, cta_n, ctas = mm.grad_cta("wgmma", m, n, 128, tile_n, groups)
    assert (cta_m, cta_n) == (128, want)
    assert ctas == mm.cta_count(m, n, 128, tile_n, cta_m, cta_n)


def test_dispatch_rule_by_tile_alignment():
    """Along an operand's contiguous M or N, TMA's boxes start at each
    logical tile's origin: a tile that is no multiple of 8 there (M = 1000's
    default M tile of 125) sends the launch to ``mma``; along a K-major
    operand it does not matter."""
    dz, x = _meta(18, 1000), _meta(18, 64)
    geo = mm.grad_geometry(dz.T, x)                      # a tied head's dE: A is M-major
    assert geo["tile_m"] == 125 and geo["body"] == "mma"
    geo = mm.grad_geometry(_meta(1000, 64), _meta(64, 64))   # the same M tile, A K-major
    assert geo["tile_m"] == 125 and geo["body"] == "wgmma"


@pytest.mark.parametrize("layout", ["w.T", "x.T", "dz.T", "expert w.T", "expert x.T"])
def test_plain_version_on_views_equals_the_contiguous_copy(layout):
    """On the CPU the gradient launch is the plain version on the views it
    is given; on each layout MatmulFn.backward and GroupedMatmulFn.backward
    make, its result equals the same launch on contiguous copies."""
    rng = np.random.default_rng(len(layout))
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
    m, k, n, e = 24, 40, 56, 3
    x, w, dz = t(m, k), t(k, n), t(m, n)
    xe, we, dze = t(e, m, k), t(e, k, n), t(e, m, n)
    a, b, launch = {"w.T": (dz, w.T, mm.grad_launch), "x.T": (x.T, dz, mm.grad_launch),
                    "dz.T": (dz.T, x, mm.grad_launch),
                    "expert w.T": (dze, we.transpose(1, 2), mm.grouped_grad_launch),
                    "expert x.T": (xe.transpose(1, 2), dze, mm.grouped_grad_launch)}[layout]
    assert not (a.is_contiguous() and b.is_contiguous())
    ref.reset_calls()
    got = launch(a, b)
    want = launch(a.contiguous(), b.contiguous())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def _assert_grad_close(name, got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= GRAD_REL * scale + 1e-7, f"{name}: max |err| {err} vs max |grad| {scale}"


def _ctx(saved, needs, **attrs):
    """What an autograd Function's backward reads of its context."""
    return types.SimpleNamespace(saved_tensors=saved, needs_input_grad=needs, **attrs)


K1_CLASSES = ["matmul", "matmul_bias", "matmul_bias_gelu", "matmul_silu_glu", "matmul_gelu_glu",
              "matmul_residual", "matmul_lmhead_softcap"]


@pytest.mark.parametrize("class_id", K1_CLASSES + ["tied_head"])
@pytest.mark.parametrize("m,k,n", [(12, 24, 40), (7, 33, 18)])
def test_matmul_fn_backward_matches_reference(class_id, m, k, n):
    """MatmulFn.backward called on CPU tensors (its gradient launches on
    views take the plain version) against jax.vjp of the reference's
    ``ref.matmul``, f32: dX, dW (a tied head: dE), the bias's and the
    residual's gradients."""
    rng = np.random.default_rng(m + k + n + len(class_id))
    tied = class_id == "tied_head"
    cls = "matmul_lmhead_softcap" if tied else class_id
    softcap = 3.0 if cls == "matmul_lmhead_softcap" else 0.0
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    n_out = n // 2 if "glu" in cls else n
    bias = (0.1 * rng.normal(size=(n,))).astype(np.float32) if "bias" in cls else None
    res = rng.normal(size=(m, n_out)).astype(np.float32) if cls == "matmul_residual" else None
    dy = rng.normal(size=(m, n_out)).astype(np.float32)
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    tb = torch.from_numpy(bias) if bias is not None else None
    y = ref.matmul(tx, tw, cls, bias=tb, residual=torch.from_numpy(res) if res is not None else None,
                   softcap=softcap)
    saved = (tx, tw.T.contiguous().T if tied else tw, tw.T.contiguous() if tied else None, tb,
             y if cls == "matmul_lmhead_softcap" else None)
    if tied:   # w is the embedding's contiguous transposed copy, its gradient goes to the embedding
        saved = (tx, tw.T.contiguous().T.contiguous(), tw.T.contiguous(), tb, saved[4])
    needs = (True, not tied, tied, bias is not None, res is not None)
    ctx = _ctx(saved, needs, class_id=cls, softcap=softcap, res_dtype=torch.float32)
    dx, dw, dsrc, db, dres, *_ = mm.MatmulFn.backward(ctx, tdy)

    inputs = [x, w] + [a for a in (bias, res) if a is not None]

    def fn(xa, wa, *rest):
        kw = {}
        if bias is not None:
            kw["bias"] = rest[0]
        if res is not None:
            kw["residual"] = rest[-1]
        return jref.matmul(xa, wa, cls, softcap=softcap, **kw)

    _, pull = jax.vjp(fn, *[jnp.asarray(a) for a in inputs])
    want = pull(jnp.asarray(dy))
    _assert_grad_close("dx", dx, want[0])
    if tied:
        assert dw is None
        _assert_grad_close("dsrc", dsrc, np.asarray(want[1]).T)
    else:
        assert dsrc is None
        _assert_grad_close("dw", dw, want[1])
    if bias is not None:
        _assert_grad_close("dbias", db, want[2])
    if res is not None:
        _assert_grad_close("dres", dres, want[-1])


@pytest.mark.parametrize("class_id", ref.GROUPED_CLASSES)
@pytest.mark.parametrize("e,m,k,n", [(1, 5, 16, 8), (3, 7, 33, 24), (4, 12, 40, 64)])
def test_grouped_matmul_fn_backward_matches_reference(class_id, e, m, k, n):
    """GroupedMatmulFn.backward on CPU tensors (dX, dW per expert on
    ``.transpose(1, 2)`` views) against jax.vjp of ``jax.vmap(ref.matmul)``."""
    rng = np.random.default_rng(e + m + k + n)
    x = rng.normal(size=(e, m, k)).astype(np.float32)
    w = (rng.normal(size=(e, k, n)) / np.sqrt(k)).astype(np.float32)
    n_out = n // 2 if "glu" in class_id else n
    dy = rng.normal(size=(e, m, n_out)).astype(np.float32)
    ctx = _ctx((torch.from_numpy(x), torch.from_numpy(w)), (True, True, False, False),
               class_id=class_id)
    got = mm.GroupedMatmulFn.backward(ctx, torch.from_numpy(dy))[:2]
    _, pull = jax.vjp(jax.vmap(lambda a, b: jref.matmul(a, b, class_id)), jnp.asarray(x),
                      jnp.asarray(w))
    for name, g, want in zip(("dx", "dw"), got, pull(jnp.asarray(dy))):
        _assert_grad_close(name, g, want)


def test_backward_hands_the_launch_views():
    """MatmulFn.backward's dX and dW launches get ``w.T`` and ``x.T`` as views
    of the saved tensors (no copy); GroupedMatmulFn's ``.transpose(1, 2)``."""
    seen = []
    real = mm.grad_launch, mm.grouped_grad_launch

    def spy(launch):
        def run(a, b, *args, **kw):
            seen.append((a.is_contiguous(), b.is_contiguous(), a.data_ptr(), b.data_ptr()))
            return launch(a, b, *args, **kw)
        return run

    x, w, dy = torch.randn(6, 8), torch.randn(8, 10), torch.randn(6, 10)
    xe, we, dye = torch.randn(2, 6, 8), torch.randn(2, 8, 10), torch.randn(2, 6, 10)
    mm.grad_launch, mm.grouped_grad_launch = spy(real[0]), spy(real[1])
    try:
        mm.MatmulFn.backward(_ctx((x, w, None, None, None), (True, True, False, False, False),
                                  class_id="matmul", softcap=0.0, res_dtype=None), dy)
        mm.GroupedMatmulFn.backward(_ctx((xe, we), (True, True), class_id="moe_gemm"), dye)
    finally:
        mm.grad_launch, mm.grouped_grad_launch = real
    (dx_c, wt_c, _, wt_p), (xt_c, _, xt_p, _), (_, we_c, _, we_p), (xe_c, _, xe_p, _) = seen
    assert dx_c and not wt_c and wt_p == w.data_ptr()
    assert not xt_c and xt_p == x.data_ptr()
    assert not we_c and we_p == we.data_ptr()
    assert not xe_c and xe_p == xe.data_ptr()
