"""Training in the port against the reference's, on the CPU at reduced size.

The reference builds the weights (f32, ``reduced``); ``repro_torch.convert``
hands them and its optimizer state to the port.  Inputs are made with numpy
from a seed and given to both.  Bounds:

* ``loss_fn`` and its grads (the reference's ``jax.value_and_grad``) for
  every arch family: the loss within 2e-4, each grad leaf within 5e-4 of
  its own largest entry (both sides sum f32 products in other orders);
* ``make_train_step`` over 3 steps, with and without ``grad_accum=2`` and
  ``compress_grads``: params within 5e-3.  AdamW's first step moves each
  entry by about ±lr·sign(g), so an entry whose grad is near zero can move
  the other way across frameworks; that is the reference's own tolerance
  (``tests/test_models.py``, grad accumulation);
* remat: losses and grads bit-equal with and without it;
* the tied embedding: after a step ``embed_t`` is ``embed.T`` bit for bit,
  and the optimizer state holds the reference's leaves (no ``embed_t``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import grads_from_jax, opt_state_from_jax, params_from_jax
from repro_torch.core.database import Record, ScheduleDB
from repro_torch.core.schedule import Schedule
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.models import build_model
from repro_torch.models.lm import trainable
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves, leaves_with_paths

FAMILIES = ["gemma2-2b", "minitron-4b", "mixtral-8x22b", "dbrx-132b", "rwkv6-1.6b", "recurrentgemma-2b",
            "whisper-medium", "internvl2-26b"]
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_REL = 5e-4
STEP_TOL = dict(rtol=5e-3, atol=5e-3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, b=2, s=8, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, size=(b, s)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    else:
        batch["mask"] = np.ones((b, s), np.int32)
        batch["mask"][:, -2:] = 0                       # masked positions drop out of the mean
    if cfg.vision_tokens:
        batch["patch_embeds"] = rng.normal(size=(b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pair(arch, seed=0):
    jcfg = jreduced(jget_arch(arch))
    cfg = reduced(get_arch(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = build_model(cfg, "cpu")
    params = params_from_jax(_np(jparams), cfg)
    return cfg, jmodel, jparams, model, params


def _by_path(tree):
    return dict(leaves_with_paths(tree))


def _assert_grads_close(got, want):
    got, want = _by_path(got), _by_path(want)
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path].float().numpy()
        w = w.float().numpy()
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_REL * scale + 1e-7, f"{path}: max |err| {err} vs max |grad| {scale}"


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    cfg, jmodel, jparams, model, params = _pair(arch)
    batch = _batch(cfg)

    def jloss(p):
        return jmodel.loss_fn(p, _jax_batch(batch), remat=False)

    (jval, jmet), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    val, met, grads = steps.value_and_grad(model, params, _torch_batch(batch), remat=False)
    np.testing.assert_allclose(float(val), float(jval), **LOSS_TOL)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]), **LOSS_TOL)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), **LOSS_TOL)
    if cfg.n_experts:
        assert float(met["aux"]) > 0
    _assert_grads_close(grads, grads_from_jax(_np(jgrads), cfg))


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_changes_no_number(arch):
    cfg = reduced(get_arch(arch))
    model = build_model(cfg, "cpu")
    params = model.init(3)
    batch = _torch_batch(_batch(cfg, seed=1))
    v0, m0, g0 = steps.value_and_grad(model, params, batch, remat=False)
    v1, m1, g1 = steps.value_and_grad(model, params, batch, remat=True)
    assert torch.equal(v0, v1) and torch.equal(m0["aux"], m1["aux"])
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)


def test_remat_recompute_keeps_the_forward_backend():
    """The backward of CUDA tensors runs on autograd's own thread, where the
    thread-local ops backend is the default: remat's recompute must run
    under the backend its forward ran under."""
    import threading

    from repro_torch.models.lm import rematted

    seen = []

    def layer(x):
        seen.append(ops.current_backend())
        return (x * x).sum()

    x = torch.ones(3, requires_grad=True)
    with ops.use_backend("ref"):
        y = rematted(layer, True)(x)
    out = []
    t = threading.Thread(target=lambda: out.append(torch.autograd.grad(y, x)[0]))
    t.start()
    t.join()
    assert seen == ["ref", "ref"] and ops.current_backend() == "cuda"
    assert torch.equal(out[0], 2 * x.detach())


def _run_steps(arch, n_steps, **kw):
    cfg, jmodel, jparams, model, params = _pair(arch, seed=2)
    ocfg = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(jmodel, JAdamWConfig(**ocfg), remat=False, **kw))
    jopt = jsteps.init_opt_state(jparams, compress_grads=kw.get("compress_grads", False))
    step = steps.make_train_step(model, AdamWConfig(**ocfg), remat=False, **kw)
    opt = steps.init_opt_state(params, compress_grads=kw.get("compress_grads", False))
    for i in range(n_steps):
        batch = _batch(cfg, b=4, s=8, seed=10 + i)
        jparams, jopt, jm = jstep(jparams, jopt, _jax_batch(batch))
        params, opt, m = step(params, opt, _torch_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    return cfg, jparams, jopt, params, opt


@pytest.mark.parametrize("kw", [{}, {"grad_accum": 2}, {"compress_grads": True},
                                {"grad_accum": 2, "compress_grads": True}],
                         ids=["plain", "grad_accum", "compress", "grad_accum_compress"])
def test_train_steps_match_reference(kw):
    cfg, jparams, jopt, params, opt = _run_steps("minitron-4b", 3, **kw)
    want = _by_path(params_from_jax(_np(jparams), cfg))
    for path, got in leaves_with_paths(params):
        np.testing.assert_allclose(got.numpy(), want[path].numpy(), **STEP_TOL, err_msg=path)
    assert int(opt["step"]) == int(jopt["step"]) == 3
    if kw.get("compress_grads"):
        assert set(_by_path(opt["residuals"])) == set(_by_path(trainable(params)))


def test_tied_embedding_stays_tied_and_state_matches_reference():
    cfg, jparams, jopt, params, opt = _run_steps("gemma2-2b", 1)
    assert cfg.tie_embeddings
    assert torch.equal(params["embed_t"], params["embed"].T)
    want = opt_state_from_jax(_np(jopt), cfg)
    assert set(opt) == set(want) == {"m", "v", "master", "step"}
    for key in ("m", "v", "master"):
        got_paths = _by_path(opt[key])
        assert set(got_paths) == set(_by_path(want[key]))
        assert not any("embed_t" in p for p in got_paths)
        for path, w in _by_path(want[key]).items():
            np.testing.assert_allclose(got_paths[path].numpy(), w.numpy(), **STEP_TOL, err_msg=path)


def test_init_opt_state_matches_reference_leaves():
    cfg, _, jparams, _, params = _pair("gemma2-2b")
    want = opt_state_from_jax(_np(jsteps.init_opt_state(jparams, compress_grads=True)), cfg)
    got = steps.init_opt_state(params, compress_grads=True)
    for key in ("m", "v", "master", "residuals"):
        g, w = _by_path(got[key]), _by_path(want[key])
        assert set(g) == set(w)
        for path in w:
            assert torch.equal(g[path], w[path]), path
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0


def test_training_loss_decreases():
    res = train_mod.main(["--device", "cpu", "--arch", "gemma2-2b", "--steps", "15",
                          "--batch", "4", "--seq", "24", "--log-every", "0"])
    assert set(res) == {"first_loss", "last_loss", "steps", "stragglers"}
    assert res["steps"] == 15
    assert res["last_loss"] < res["first_loss"]


def test_train_checkpoint_resume(tmp_path):
    d = str(tmp_path / "ckpt")
    res1 = train_mod.main(["--device", "cpu", "--arch", "minitron-4b", "--steps", "6",
                           "--batch", "2", "--seq", "16", "--ckpt-dir", d, "--log-every", "0"])
    res2 = train_mod.main(["--device", "cpu", "--arch", "minitron-4b", "--steps", "10",
                           "--batch", "2", "--seq", "16", "--ckpt-dir", d, "--resume",
                           "--log-every", "0"])
    assert res2["steps"] == 4  # resumed at 6, ran to 10
    assert res2["last_loss"] < res1["first_loss"]


@pytest.mark.parametrize("argv", [["--mesh-model", "2"], ["--strategy", "dp"],
                                  ["--strategy", "fsdp_tp"]])
def test_sharded_training_is_refused(argv, monkeypatch):
    """Without torchrun's environment the trainer is one process and
    refuses a mesh; under it, it trains sharded (test_torch_distributed)."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        train_mod.main(["--device", "cpu", "--steps", "1"] + argv)


def test_tuning_db_reaches_the_forward_launches(tmp_path):
    """The reference builds its --tuning-db provider and drops it; here the
    forward's kernel launches resolve through it."""
    cfg = reduced(get_arch("gemma2-2b"))
    b, s = 2, 16
    inst = ops.instance("matmul", torch.float32, M=b * s, N=cfg.n_heads * cfg.head_dim,
                        K=cfg.d_model)
    sched = Schedule.make("matmul", {"M": 8, "N": 32, "K": 32})
    db = ScheduleDB()
    db.add(Record(instance=inst, schedule=sched, seconds=1.0, model_id="donor", target="tpu-v5e"))
    path = str(tmp_path / "db.json")
    db.save(path)
    provider = train_mod.make_provider(path, "tpu-v5e")
    model = build_model(cfg, "cpu")
    params = model.init(0)
    step = steps.make_train_step(model, AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4),
                                 provider=provider)
    step(params, steps.init_opt_state(params), _torch_batch(_batch(cfg, b=b, s=s)))
    assert provider.hits >= cfg.n_layers   # each layer's q projection, plus remat's recompute
    res = train_mod.main(["--device", "cpu", "--arch", "gemma2-2b", "--steps", "3", "--batch",
                          str(b), "--seq", str(s), "--tuning-db", path, "--log-every", "0"])
    assert res["steps"] == 3
