"""Weight init without a second f32 copy (``repro_torch.models.common``,
``repro_torch.models.mlp``): the params equal, bit for bit, those of the
earlier init, which scaled each f32 draw into a second f32 tensor before
the cast and stacked a list of experts.  The earlier functions are kept
here as the reference."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduced
from repro_torch.models import attention, build_model, common, lm, mlp, recurrent
from repro_torch.models.common import _normal, dtype_of


def _dense_init(gen, fan_in, fan_out, dtype):
    scale = (2.0 / (fan_in + fan_out)) ** 0.5
    return (_normal(gen, (fan_in, fan_out)) * scale).to(dtype)


def _embed_init(gen, vocab, dim, dtype):
    return (_normal(gen, (vocab, dim)) * dim ** -0.5).to(dtype)


def _glu_init(gen, d, f, dtype):
    w_gate, w_up = _dense_init(gen, d, f, dtype), _dense_init(gen, d, f, dtype)
    return torch.stack([w_gate, w_up], dim=2).reshape(d, 2 * f)


def _moe_params(gen, cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype_of(cfg.dtype)
    return {
        "router": _dense_init(gen, d, e, torch.float32),
        "w_in": torch.stack([_glu_init(gen, d, f, dt) for _ in range(e)]),
        "w_out": torch.stack([_dense_init(gen, f, d, dt) for _ in range(e)]),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["minitron-4b", "mixtral-8x22b", "recurrentgemma-2b"])
def test_init_params_equal_the_earlier_init(arch, dtype, monkeypatch):
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype=dtype)
    new = build_model(cfg, "cpu").init(seed=3)
    for mod in (attention, common, lm, mlp, recurrent):
        for name, fn in (("dense_init", _dense_init), ("embed_init", _embed_init),
                         ("glu_init", _glu_init)):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, fn)
    monkeypatch.setattr(mlp, "moe_params", _moe_params)
    old = build_model(cfg, "cpu").init(seed=3)

    def flat(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for key in tree for k, v in flat(tree[key], f"{path}/{key}").items()}
        if isinstance(tree, list):
            return {k: v for i, x in enumerate(tree) for k, v in flat(x, f"{path}/{i}").items()}
        return {path: tree}

    got, want = flat(new), flat(old)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    if cfg.n_experts:
        assert got["/layers/0/moe/w_in"].is_contiguous()


def test_pack_glu_into_a_slice():
    g = torch.Generator().manual_seed(0)
    gate, up = torch.randn((3, 4), generator=g), torch.randn((3, 4), generator=g)
    want = torch.stack([gate, up], dim=2).reshape(3, 8)
    assert torch.equal(common.pack_glu(gate, up), want)
    stack = torch.zeros((2, 3, 8))
    out = common.pack_glu(gate, up, out=stack[1])
    assert out.data_ptr() == stack[1].data_ptr() and torch.equal(stack[1], want)
    assert torch.equal(stack[0], torch.zeros((3, 8)))
