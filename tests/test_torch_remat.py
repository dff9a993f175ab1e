"""The ``dots`` remat policy in the port, on the CPU at reduced size.

``dots`` saves the outputs of every K1 launch in a remat'd layer (the
reference's ``dots_with_no_batch_dims_saveable``) through
``torch.utils.checkpoint``'s selective checkpointing, and recomputes the
rest; the gelu and GLU classes keep their pre-activation Z too.  Bounds:

* per family, the loss and every gradient leaf bit-equal to ``full``'s in
  the port (neither policy changes a number);
* against the reference's ``jax.value_and_grad`` under
  ``set_remat_policy("dots")`` (``remat=True``), params carried across by
  ``repro_torch.convert``: the loss within f32 2e-4 (relative and
  absolute), each gradient leaf within 2e-4 of its own largest entry (both
  sides sum f32 products in other orders);
* counted: under ``dots`` no K1 plain forward runs in the recompute (as
  many as without remat; ``full`` runs the layers' twice), and the backward
  makes one gradient launch fewer per gelu or GLU launch (Z is the
  forward's);
* K1's dispatcher op on the CPU: Y and Z bit-equal to the plain version's
  (Z: class ``matmul``, ``matmul_bias`` with a bias);
* the recompute keeps the policy on autograd's thread;
* the planner's analytic train factor is 6 under ``dots`` (8 under
  ``full``), as the reference's.
"""
import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.distributed.context import set_remat_policy as jset_remat_policy
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import grads_from_jax, params_from_jax
from repro_torch.distributed.context import remat_policy, using_remat_policy
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.lm import rematted
from repro_torch.tree import leaves, leaves_with_paths

FAMILIES = ["gemma2-2b", "minitron-4b", "mixtral-8x22b", "rwkv6-1.6b", "recurrentgemma-2b",
            "whisper-medium", "internvl2-26b"]
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_REL = 2e-4


def _batch(cfg, b=2, s=8, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, size=(b, s)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    else:
        batch["mask"] = np.ones((b, s), np.int32)
        batch["mask"][:, -2:] = 0
    if cfg.vision_tokens:
        batch["patch_embeds"] = rng.normal(size=(b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _value_and_grad(model, params, batch, policy, remat=True):
    with using_remat_policy(policy):
        return steps.value_and_grad(model, params, batch, remat=remat)


@pytest.mark.parametrize("arch", FAMILIES)
def test_dots_is_bit_equal_to_full(arch):
    cfg = reduced(get_arch(arch))
    model = build_model(cfg, "cpu")
    params = model.init(3)
    batch = _torch_batch(_batch(cfg, seed=1))
    v0, m0, g0 = _value_and_grad(model, params, batch, "full")
    v1, m1, g1 = _value_and_grad(model, params, batch, "dots")
    assert torch.equal(v0, v1) and torch.equal(m0["aux"], m1["aux"])
    for (path, a), b in zip(leaves_with_paths(g0), leaves(g1)):
        assert torch.equal(a, b), path
    assert remat_policy() == "full"


@pytest.mark.parametrize("arch", FAMILIES)
def test_dots_matches_reference_dots(arch):
    jcfg = jreduced(jget_arch(arch))
    cfg = reduced(get_arch(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jset_remat_policy("dots")   # read when the step is traced
    try:
        (jval, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, jbatch, remat=True), has_aux=True))(jparams)
    finally:
        jset_remat_policy(None)
    val, _, grads = _value_and_grad(build_model(cfg, "cpu"), params, _torch_batch(batch), "dots")
    np.testing.assert_allclose(float(val), float(jval), **LOSS_TOL)
    want = dict(leaves_with_paths(grads_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg)))
    got = dict(leaves_with_paths(grads))
    assert set(got) == set(want)
    for path, w in want.items():
        g, w = got[path].float().numpy(), w.float().numpy()
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= GRAD_REL * scale + 1e-7, f"{path}: max |err| {err} vs max |grad| {scale}"


def _counted_run(monkeypatch, model, params, batch, policy, remat=True):
    """K1 plain forward calls (of the gelu and GLU classes too) and gradient
    launches of one value_and_grad."""
    calls = {"forward": 0, "z_forward": 0, "grad": 0}
    plain, grad = ref.matmul, mm.grad_launch

    def plain_spy(x, w, class_id="matmul", **kw):
        if "round_k" in kw:   # a forward's plain call (mm.matmul, mm.matmul_op)
            calls["forward"] += 1
            calls["z_forward"] += class_id in mm.Z_CLASSES
        return plain(x, w, class_id, **kw)

    def grad_spy(*args, **kw):
        calls["grad"] += 1
        return grad(*args, **kw)

    monkeypatch.setattr(ref, "matmul", plain_spy)
    monkeypatch.setattr(mm, "grad_launch", grad_spy)
    try:
        _value_and_grad(model, params, batch, policy, remat)
    finally:
        monkeypatch.setattr(ref, "matmul", plain)
        monkeypatch.setattr(mm, "grad_launch", grad)
    return calls


@pytest.mark.parametrize("arch,z_per_layer", [("gemma2-2b", 1), ("minitron-4b", 1),
                                              ("whisper-medium", 1), ("rwkv6-1.6b", 0)])
def test_dots_runs_no_k1_forward_twice(monkeypatch, arch, z_per_layer):
    """gemma2's GeGLU up, minitron's and whisper's gelu with a bias (in
    whisper's encoder and decoder layers) read their Z from the forward;
    rwkv6's layers have no gelu or GLU K1 class."""
    cfg = reduced(get_arch(arch))
    model = build_model(cfg, "cpu")
    params = model.init(0)
    batch = _torch_batch(_batch(cfg))
    once = _counted_run(monkeypatch, model, params, batch, "full", remat=False)
    full = _counted_run(monkeypatch, model, params, batch, "full")
    dots = _counted_run(monkeypatch, model, params, batch, "dots")
    heads = 1 + bool(cfg.vision_tokens)
    layers = cfg.n_layers + cfg.encoder_layers
    assert dots["forward"] == once["forward"]
    assert full["forward"] == 2 * once["forward"] - heads
    assert once["z_forward"] == z_per_layer * layers
    assert full["grad"] - dots["grad"] == once["z_forward"]
    assert full["grad"] == once["grad"]


@pytest.mark.parametrize("class_id", ["matmul_bias_gelu", "matmul_silu_glu", "matmul_gelu_glu",
                                      "matmul", "matmul_residual"])
def test_matmul_op_on_the_cpu_is_the_plain_version(class_id):
    g = torch.Generator().manual_seed(2)
    x, w = torch.randn((6, 16), generator=g), torch.randn((16, 10), generator=g)
    bias = torch.randn((10,), generator=g) if "bias" in class_id else None
    res = torch.randn((6, 10), generator=g) if class_id == "matmul_residual" else None
    with_z = class_id in mm.Z_CLASSES
    cs = ops.schedule_for(ops.instance(class_id, torch.float32, M=6, N=10, K=16))
    key = mm.launch_key(x, w, cs, class_id=class_id, bias=bias, residual=res, softcap=0.0)
    out = torch.ops.repro_torch.matmul(x, w, bias, res, class_id, 0.0, *key, with_z)
    assert len(out) == 1 + with_z
    assert torch.equal(out[0], ref.matmul(x, w, class_id, bias=bias, residual=res))
    if with_z:
        z_class = "matmul" if bias is None else "matmul_bias"
        assert torch.equal(out[1], ref.matmul(x, w, z_class, bias=bias))


def test_dots_recompute_keeps_the_policy_on_autograd_thread():
    """The recompute runs under the policy the forward ran under, also on
    another thread (the backward of CUDA tensors runs on autograd's)."""
    seen = []

    def layer(x):
        seen.append(mm.dots_saved())
        return (x * x).sum()

    x = torch.ones(3, requires_grad=True)
    with using_remat_policy("dots"):
        y = rematted(layer, True)(x)
    out = []
    t = threading.Thread(target=lambda: out.append(torch.autograd.grad(y, x)[0]))
    t.start()
    t.join()
    assert seen == [True, True] and not mm.dots_saved()
    assert torch.equal(out[0], 2 * x.detach())


def test_dryrun_analytic_factor_under_dots():
    full = dryrun.run_cell("gemma2-2b", "train_4k", False)
    dots = dryrun.run_cell("gemma2-2b", "train_4k", False, remat_policy_name="dots")
    assert full["status"] == dots["status"] == "ok"
    tokens = 256 * 4096
    n = get_arch("gemma2-2b").active_param_count()
    peak = dryrun.H100.peak_flops_bf16 * dots["chips"]
    assert dots["roofline"]["compute_analytic_s"] == pytest.approx(6 * n * tokens / peak)
    assert full["roofline"]["compute_analytic_s"] == pytest.approx(8 * n * tokens / peak)
    assert dots["collectives"] == full["collectives"]
    assert dots["remat_policy"] == "dots" and full["remat_policy"] == "full"
