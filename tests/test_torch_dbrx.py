"""dbrx-132b at its own routing (16 experts, top-4) in the port against
``repro``, on the CPU at reduced width (f32).

``reduced`` caps the experts at 4 and top-k at 2, so here both sides keep
dbrx's ``n_experts=16, moe_topk=4`` over the reduced widths.  The reference
builds the weights; ``repro_torch.convert`` hands them to the port.  The
converted params, prefill logits, the slot engine's decode logits under
teacher forcing, and one train step's loss and gradients agree within
rtol = atol = 2e-4 (the repo's f32 kernel tolerance; each gradient leaf
within 2e-4 of its own largest entry).  Plus the serve entry point's
``--layers`` for the MoE archs.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.kernels.ops import use_backend as juse_backend
from repro.models import build_model as jbuild_model
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import grads_from_jax, params_from_jax
from repro_torch.launch import serve, steps
from repro_torch.models import build_model, mlp
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaves_with_paths

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_REL = 2e-4
#: dbrx-132b's routing, kept over the reduced widths on both sides
ROUTING = dict(n_experts=16, moe_topk=4)
MAX_LEN = 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(1, 512, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def dbrx():
    jcfg = dataclasses.replace(jreduced(jget_arch("dbrx-132b")), **ROUTING)
    cfg = dataclasses.replace(reduced(get_arch("dbrx-132b")), **ROUTING)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    params = params_from_jax(_np(jparams), cfg)
    return cfg, jmodel, jparams, model, params


def test_full_config_routes_16_experts_top_4():
    cfg, jcfg = get_arch("dbrx-132b"), jget_arch("dbrx-132b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_experts, cfg.moe_topk, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (
        16, 4, 6144, 10752, 100352)
    assert cfg.param_count() == jcfg.param_count()


def test_converted_params_hold_every_expert(dbrx):
    cfg, _, jparams, _, params = dbrx
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert len(params["layers"]) == cfg.n_layers
    for j, layer in enumerate(params["layers"]):
        shapes = {key: tuple(v.shape) for key, v in layer["moe"].items()}
        assert shapes == {"router": (d, e), "w_in": (e, d, 2 * f), "w_out": (e, f, d)}
        for key in ("router", "w_in", "w_out"):
            np.testing.assert_array_equal(layer["moe"][key].numpy(),
                                          np.asarray(jparams["groups"]["0"]["moe"][key][j]))


def test_each_token_takes_four_of_sixteen_experts(dbrx):
    """The router's top-4 of 16, renormalised: every token's four gates sum
    to one and the batch reaches more experts than reduced's 4."""
    cfg, _, _, _, params = dbrx
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(24, cfg.d_model)).astype(np.float32))
    probs, gates, idx = mlp.moe_route(params["layers"][0]["moe"], cfg, x)
    assert probs.shape == (24, 16) and idx.shape == gates.shape == (24, 4)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert all(len(set(row)) == 4 for row in idx.tolist())
    assert len(set(idx.flatten().tolist())) > 4


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_prefill_logits_match(dbrx, backend):
    """The reference's plain path, and its Pallas kernels (the grouped expert
    GEMM among them) in interpret mode."""
    cfg, jmodel, jparams, model, params = dbrx
    toks = _tokens(2, 11, seed=41)
    with juse_backend(backend):
        jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    logits, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN)
    assert logits.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


def test_slot_engine_decode_logits_match(dbrx):
    """Requests join at different steps of both slot engines; every decode
    step's logits agree, teacher-forced by the reference's tokens."""
    _, jmodel, jparams, model, params = dbrx
    jeng = JServingEngine(jmodel, jparams, slots=2, max_len=MAX_LEN)
    eng = ServingEngine(model, params, slots=2, max_len=MAX_LEN)
    pending = [[5, 6, 7, 8, 9, 10, 11], [9, 10, 11], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]]
    jreqs, reqs, decoded = [], [], 0
    for _ in range(64):
        if pending and eng.free_slots:
            p = pending.pop(0)
            jreqs.append(jeng.add_request(p, max_new_tokens=5))
            reqs.append(eng.add_request(p, max_new_tokens=5))
            assert reqs[-1].generated[0] == jreqs[-1].generated[0]
        ran = bool(jeng.active)
        assert ran == bool(eng.active)
        jfin, fin = jeng.step(), eng.step()
        assert [r.uid for r in fin] == [r.uid for r in jfin]
        if ran:
            np.testing.assert_allclose(eng.last_logits.numpy(), np.asarray(jeng.last_logits),
                                       **TOL)
            decoded += 1
        for r, jr in zip(reqs, jreqs):
            r.generated[:] = jr.generated
        if not pending and not jeng.active:
            break
    assert decoded and all(r.done and len(r.generated) == 5 for r in reqs)


def test_train_step_loss_and_grads_match(dbrx):
    """``loss_fn`` and its gradients (the reference's ``jax.value_and_grad``)
    on a masked batch: the loss, its cross-entropy and its load-balance term
    within 2e-4, each gradient leaf within 2e-4 of its largest entry."""
    cfg, jmodel, jparams, model, params = dbrx
    rng = np.random.default_rng(42)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, size=(2, 12)).astype(np.int32),
             "mask": np.ones((2, 12), np.int32)}
    batch["mask"][:, -3:] = 0

    def jloss(p):
        return jmodel.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=False)

    (jval, jmet), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    val, met, grads = steps.value_and_grad(model, params,
                                           {k: torch.from_numpy(v) for k, v in batch.items()},
                                           remat=False)
    for got, want in ((val, jval), (met["ce"], jmet["ce"]), (met["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(got), float(want), **TOL)
    assert float(met["aux"]) > 0
    got, want = dict(leaves_with_paths(grads)), dict(leaves_with_paths(grads_from_jax(_np(jgrads),
                                                                                      cfg)))
    assert set(got) == set(want)
    for path, w in want.items():
        g, w = got[path].numpy(), w.numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, path
        assert float(np.abs(g - w).max()) <= GRAD_REL * scale, path


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_serve_main_keeps_the_first_layers(capsys, arch):
    """``--layers 1`` serves the requests with one layer at the preset's
    width, and the result says so; without it, the preset's depth."""
    argv = ["--device", "cpu", "--preset", "smoke", "--arch", arch]
    res = serve.main(argv + ["--layers", "1"])
    assert res["arch"] == arch and res["layers"] == 1
    assert res["requests"] == 8 and res["tokens"] == 8 * 8
    assert serve.main(argv + ["--requests", "2"])["layers"] == reduced(get_arch(arch)).n_layers
