"""Tensor-parallel compute under ``fsdp_tp`` (``repro_torch.distributed``),
on the CPU under gloo, against the port's one-process step and the
reference's single-device step.

Ranks are spawned as in ``tests/test_torch_distributed.py`` (its
``run_ranks``), each case under its own timeout.  Each case trains two
``fsdp_tp`` steps of a reduced arch from the port's seed-0 init on a seeded
batch and checks:

* the loss within 1e-5 of the one-process step's, and each step's
  gathered state within 1e-5 of the one-process step taken from the same
  state, or within twice the distance that step moves with the batch's
  rows reversed or the network's units stored in another order (the inner
  sums tensor parallelism splits, added in other orders); param entries
  within AdamW's eps scale up to a learning rate, counted
  (``_assert_near_one_process``); and within 2e-4 (loss) / 5e-4 (state)
  of the reference's jitted single-device step (``REF_LOSS_REL``,
  ``REF_STATE_REL``);
* every collective of every step and of a forward under the step's gather
  equal to ``plan_collectives``, op by op, bytes and sets of axes included;
* no leaf sharded over ``model`` gathered over ``model`` but the attention
  projections whose heads a shard would cut (``attn_heads_local``), and
  the all-gathers over ``model`` exactly the plan's;
* the residual stream a layer's checkpoint keeps D/m wide.

The cases cover the meshes 1x2, 2x2 and 1x4 (worlds 2 and 4): dense
(stablelm-12b), a tied head with softcaps and local layers (gemma2-2b),
expert-parallel MoE (mixtral-8x22b, dbrx-132b), the MoE TP fallback (a
mixtral with 3 experts at ``model`` 2), rwkv6-1.6b, griffin with its one KV
head split (recurrentgemma-2b), the encoder-decoder (whisper-medium) and
the vision prefix (internvl2-26b, and with a vocabulary of 511 that no
``model`` axis splits: the head whole on every rank), under ``full`` and
``dots``; and the (1, 1) mesh, bit-equal to the unsharded step.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh, make_production_mesh, make_test_mesh
from repro_torch.tree import flatten_up_to, leaves, leaves_with_paths, tree_map

from test_torch_distributed import (REF_LOSS_REL, REF_STATE_REL, _assert_near_one_process,
                                    _by_path, _np, _one_process_from, _report_exempt,
                                    _step_batch, _to_reference_layout, run_ranks)

#: (arch, config overrides, world, model axis, remat policy)
TP_CASES = [
    ("stablelm-12b", {}, 2, 2, "full"), ("stablelm-12b", {}, 4, 4, "full"),
    ("gemma2-2b", {}, 4, 2, "full"), ("gemma2-2b", {}, 4, 4, "dots"),
    ("mixtral-8x22b", {}, 2, 2, "full"), ("mixtral-8x22b", {}, 4, 4, "full"),
    ("mixtral-8x22b", {"n_experts": 3}, 2, 2, "full"),
    ("dbrx-132b", {}, 4, 2, "dots"),
    ("rwkv6-1.6b", {}, 2, 2, "full"), ("rwkv6-1.6b", {}, 4, 4, "dots"),
    ("recurrentgemma-2b", {}, 2, 2, "full"), ("recurrentgemma-2b", {}, 4, 4, "full"),
    ("whisper-medium", {}, 4, 2, "full"),
    ("internvl2-26b", {}, 2, 2, "full"), ("internvl2-26b", {"vocab_size": 511}, 4, 2, "dots"),
]


def _case_id(arch, over, world, model_axis, policy):
    extra = "".join(f"-{k}{v}" for k, v in over.items())
    return f"{arch}{extra}-{world // model_axis}x{model_axis}-{policy}"


def _cfg(arch: str, overrides: dict):
    return dataclasses.replace(reduced(get_arch(arch)), **overrides)


def _tp_batch(cfg) -> dict:
    """:func:`_step_batch`'s tokens (8 x 16) and the stub frontends' inputs,
    seeded."""
    batch = _step_batch(cfg)
    rng = np.random.default_rng(2)
    b = batch["tokens"].shape[0]
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.vision_tokens:
        batch["patch_embeds"] = torch.from_numpy(
            rng.normal(size=(b, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
    return batch


def _record_checkpoints(widths: list):
    """Wrap ``lm.checkpoint`` (every layer's remat) to record the width of
    the residual stream each layer's checkpoint keeps (its second
    argument)."""
    from repro_torch.models import lm

    inner = lm.checkpoint

    def recording(fn, *args, **kw):
        widths.append(args[1].shape[-1])
        return inner(fn, *args, **kw)

    lm.checkpoint = recording


def _tp_run(rank, world, arch, overrides, model_axis, policy, steps=2, oracle=True):
    """``steps`` ``fsdp_tp`` steps from the port's seed-0 init under
    ``policy``: per step the collectives (with their sets of axes), a
    forward's under the step's gather, the plans, the residual widths the
    layers' checkpoints keep, and on rank 0 the gathered state beside the
    one-process step's (on the batch and on its rows reversed) and, at
    ``model`` > 1, the one-process step from each step's state
    (``_one_process_from``)."""
    from repro_torch.distributed.collectives import ParamGather
    from repro_torch.distributed.context import gathered_params, using_remat_policy
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.build import build_model
    from repro_torch.models.lm import trainable
    from repro_torch.optim.adamw import AdamWConfig

    cfg = _cfg(arch, overrides)
    model = build_model(cfg, "cpu")
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=4)
    batch = _tp_batch(cfg)
    mesh = make_test_mesh(model=model_axis)
    widths: list = []
    _record_checkpoints(widths)
    with using_remat_policy(policy):
        step = steps_mod.make_sharded_train_step(model, opt_cfg, mesh, strategy="fsdp_tp")
        params = step.shard_params(model.init(0))
        opt = step.init_opt_state(params)
        counter = step.groups.counter
        losses, per_step = [], []
        tp = model_axis > 1
        states = [step.state_sharded(opt).gather({"params": params, "opt": opt})] if tp else []
        for _ in range(steps):
            counter.reset()
            params, opt, metrics = step(params, opt, batch)
            per_step.append(counter.snapshot())
            losses.append(float(metrics["loss"]))
            if tp:
                states.append(step.state_sharded(opt).gather({"params": params, "opt": opt}))
        shape = tuple(batch["tokens"].shape)
        plan = {"step": steps_mod.plan_collectives(cfg, step.params.like, step.specs, mesh,
                                                   strategy="fsdp_tp", batch=shape,
                                                   by_axes=True),
                "forward": steps_mod.plan_collectives(cfg, step.params.like, step.specs, mesh,
                                                      train=False, strategy="fsdp_tp",
                                                      batch=shape, by_axes=True)}
        counter.reset()
        gather = ParamGather(step.params, params, step.groups.size(step.batch_axes))
        with torch.no_grad(), gathered_params(gather):
            model.forward(params, step.batch_shard(batch))
        forward = counter.snapshot()
        model_gathered = [path for (path, _), pl in zip(leaves_with_paths(step.params.like),
                                                        step.params.compute)
                          if "model" in pl.gather_axes]
        state = step.state_sharded(opt).gather({"params": params, "opt": opt})
        out = {"losses": losses, "per_step": per_step, "forward": forward, "plan": plan,
               "widths": list(widths), "model_gathered": model_gathered}
        if rank == 0:
            out["state"] = state
            if tp:
                out["tp"] = _one_process_from(model, opt_cfg, {}, states, batch,
                                              inner_orders=True)
            if oracle:
                for name, rows in (("ref", batch),
                                   ("reordered", {k: v.flip(0) for k, v in batch.items()})):
                    ref = model.init(0)
                    ref_opt = steps_mod.init_opt_state(ref)
                    fn = steps_mod.make_train_step(model, opt_cfg)
                    ref_losses = []
                    for _ in range(steps):
                        ref, ref_opt, m = fn(ref, ref_opt, rows)
                        ref_losses.append(float(m["loss"]))
                    out[name] = {"params": trainable(ref), "opt": ref_opt}
                    out[f"{name}_losses"] = ref_losses
    return out


def _reference_layout(params: dict, cfg) -> dict:
    """The port's trainable params in the reference's layout (numpy)."""
    if cfg.family != "audio":
        return _to_reference_layout(params, cfg)
    out = {k: tree_map(lambda t: t.numpy(), v) for k, v in params.items()
           if k not in ("encoder", "decoder")}
    for key in ("encoder", "decoder"):
        out[key] = tree_map(lambda *ts: np.stack([t.numpy() for t in ts]), *params[key])
    return out


@functools.lru_cache(maxsize=None)
def _reference_steps(arch: str, overrides: tuple, steps: int = 2):
    """The reference's jitted single-device ``make_train_step`` from the
    port's seed-0 init on :func:`_tp_batch`: (its losses, its final
    {"params", "opt"} in the port's layout)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jget_arch
    from repro.configs import reduced as jreduced
    from repro.launch import steps as jsteps
    from repro.models import build_model as jbuild_model
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    from repro_torch.convert import opt_state_from_jax, params_from_jax
    from repro_torch.models.build import build_model
    from repro_torch.models.lm import trainable

    over = dict(overrides)
    cfg = _cfg(arch, over)
    jcfg = dataclasses.replace(jreduced(jget_arch(arch)), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    init = trainable(build_model(cfg, "cpu").init(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, _reference_layout(init, cfg))
    assert all(torch.equal(a, _by_path(init)[p]) for p, a in
               leaves_with_paths(trainable(params_from_jax(_np(jparams), cfg))))
    jstep = jax.jit(jsteps.make_train_step(jbuild_model(jcfg),
                                           JAdamWConfig(warmup_steps=1, total_steps=4),
                                           remat=False))
    jopt = jsteps.init_opt_state(jparams)
    batch = {k: jnp.asarray(v.numpy().astype(np.int32) if k == "tokens" else v.numpy())
             for k, v in _tp_batch(cfg).items()}
    losses = []
    for _ in range(steps):
        jparams, jopt, m = jstep(jparams, jopt, batch)
        losses.append(float(m["loss"]))
    return losses, {"params": trainable(params_from_jax(_np(jparams), cfg)),
                    "opt": opt_state_from_jax(_np(jopt), cfg)}


def _assert_plan(out):
    """Every step's collectives and a forward's are the plan's, op by op,
    with bytes and sets of axes (the counter's bytes per dtype left out)."""
    def issued(snap):
        return {op: ({k: v[k] for k in ("count", "operand_bytes", "result_bytes", "axes")}
                     if isinstance(v, dict) else v) for op, v in snap.items()}

    for got in out["per_step"]:
        assert issued(got) == out["plan"]["step"], (issued(got), out["plan"]["step"])
    assert issued(out["forward"]) == out["plan"]["forward"]


def _model_all_gathers(snap) -> int:
    return sum(n for axes, n in snap.get("all_gather", {}).get("axes", {}).items()
               if "model" in axes.split(","))


@pytest.mark.parametrize("arch,over,world,model_axis,policy", TP_CASES,
                         ids=[_case_id(*c) for c in TP_CASES])
def test_tp_step_matches_one_process_and_reference(tmp_path, arch, over, world, model_axis,
                                                   policy):
    cfg = _cfg(arch, over)
    mesh = make_test_mesh(world, model=model_axis)
    ref_losses, ref_state = _reference_steps(arch, tuple(sorted(over.items())))
    out = run_ranks(_tp_run, world, tmp_path, arch, over, model_axis, policy, timeout=300)
    lead = out[0]
    _report_exempt(_assert_near_one_process(lead))
    for got, want in zip(lead["losses"], ref_losses):
        assert abs(got - want) <= REF_LOSS_REL * abs(want), (lead["losses"], ref_losses)
    ref_state = _by_path(ref_state)
    for path, a in leaves_with_paths(lead["state"]):
        b = ref_state[path]
        if a.dtype == torch.float32:
            err = float((a - b).abs().max())
            assert err <= REF_STATE_REL * float(b.abs().max()), (path, err)
        else:
            assert torch.equal(a, b), path
    q_local, kv_local = shd.attn_heads_local(cfg, mesh)
    for r in out:
        _assert_plan(r)
        # only the attention projections whose heads a shard would cut are
        # gathered over model
        for path in r["model_gathered"]:
            keys = shd._path_keys(path)
            assert keys[-2] in shd.ATTN_KEYS and keys[-1] in ("wq", "wk", "wv"), path
            assert not (q_local if keys[-1] == "wq" else kv_local), path
        # the residual stream a layer's checkpoint keeps is D/m wide
        assert r["widths"] and set(r["widths"]) == {cfg.d_model // model_axis}, r["widths"]
        assert _model_all_gathers(r["per_step"][0]) > 0
    if arch == "recurrentgemma-2b":               # its one KV head: wk and wv gathered
        assert sorted({shd._path_keys(p)[-1] for p in lead["model_gathered"]}) == ["wk", "wv"]
    else:
        assert not lead["model_gathered"]


def _bits_run(rank, world, arch, policy):
    """(1, 1) ``fsdp_tp`` beside the unsharded step: two steps each."""
    return _tp_run(rank, world, arch, {}, 1, policy)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "mixtral-8x22b", "whisper-medium"])
def test_tp_at_1x1_is_bit_equal(tmp_path, arch, policy):
    """On a (1, 1) mesh the tensor-parallel step moves nothing over
    ``model`` (each leaf's gather is a copy, as at world 1 under ``dp``):
    losses, params and optimizer state equal the unsharded step's bit for
    bit, and the collectives are the plan's."""
    out = run_ranks(_bits_run, 1, tmp_path, arch, policy)[0]
    assert out["losses"] == out["ref_losses"]
    for (path, a), b in zip(leaves_with_paths(out["state"]), leaves(out["ref"])):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    _assert_plan(out)
    assert not any("model" in op.get("axes", {}) for op in out["per_step"][0].values()
                   if isinstance(op, dict))          # a model axis of one moves nothing


def test_plan_keeps_tp_leaves_local_on_the_production_mesh():
    """stablelm-12b's train_4k on 16x16 under fsdp+tp: no leaf sharded over
    model is gathered over it (its 32 q heads split 2 a rank, its 8 KV
    heads whole on every rank: wk and wv are gathered), each TP leaf is
    gathered over data only, and the params' bytes a device holds are the
    planner's as before."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import plan_collectives
    from repro_torch.models.build import build_model
    from repro_torch.models.lm import trainable

    cfg, mesh = get_arch("stablelm-12b"), make_production_mesh()
    params = trainable(build_model(cfg, "cpu").abstract_params())
    specs = shd.param_shardings(params, cfg, mesh)
    q_local, kv_local = shd.attn_heads_local(cfg, mesh)
    assert q_local and not kv_local
    local = {path for (path, _), s in zip(leaves_with_paths(params), flatten_up_to(specs, params))
             if shd.tp_keeps_local(path, s, cfg, mesh)}
    assert any(p.endswith("['attn']['wq']") for p in local)
    assert not any(p.endswith("['attn']['wk']") for p in local)
    plan = plan_collectives(cfg, params, specs, mesh, strategy="fsdp_tp", batch=(256, 4096),
                            by_axes=True)
    layers = cfg.n_layers
    # wk, wv gathered over data and model in the forward and recompute;
    # every other leaf over data (or not at all)
    assert plan["all_gather"]["axes"]["data,model"] == 2 * 2 * layers
    cell = dryrun.run_cell("stablelm-12b", "train_4k", False)
    assert cell["strategy"] == "fsdp+tp"
    assert cell["collectives"] == {k: v if not isinstance(v, dict) else
                                   {f: v[f] for f in ("count", "operand_bytes", "result_bytes")}
                                   for k, v in plan.items()}
    assert cell["param_bytes_per_device"] == shd.sharded_bytes(params, specs, mesh)


@pytest.mark.parametrize("arch,model_axis", [("gemma2-2b", 4), ("recurrentgemma-2b", 2),
                                             ("recurrentgemma-2b", 4), ("mixtral-8x22b", 16),
                                             ("dbrx-132b", 16), ("stablelm-12b", 16)])
def test_heads_split_contiguously(arch, model_axis):
    """The heads a rank attends with: q heads whole and KV heads a
    contiguous run in one group ratio, or every head whole on every rank."""
    cfg = get_arch(arch)
    mesh = Mesh(("data", "model"), (1, model_axis))
    q_local, kv_local = shd.attn_heads_local(cfg, mesh)
    per = cfg.n_heads // model_axis
    if kv_local:
        assert q_local and cfg.n_kv_heads % model_axis == 0
    elif q_local:
        group = cfg.n_heads // cfg.n_kv_heads
        for r in range(model_axis):
            kv = {h // group for h in range(r * per, (r + 1) * per)}
            first = r * per // group
            assert kv == set(range(first, first + max(1, per // group)))
    want = {("gemma2-2b", 4): (True, True), ("recurrentgemma-2b", 2): (True, False),
            ("recurrentgemma-2b", 4): (False, False), ("mixtral-8x22b", 16): (True, False),
            ("dbrx-132b", 16): (True, False), ("stablelm-12b", 16): (True, False)}
    assert (q_local, kv_local) == want[arch, model_axis]


def test_tensor_parallel_refuses_what_it_cannot_split():
    cfg = dataclasses.replace(reduced(get_arch("stablelm-12b")), d_ff=130)
    with pytest.raises(ValueError, match="d_ff 130"):
        shd.check_tensor_parallel(cfg, Mesh(("data", "model"), (1, 4)))
    shd.check_tensor_parallel(reduced(get_arch("mixtral-8x22b")), Mesh(("data", "model"), (1, 4)))



#: the card's bounds for one bf16 path against another (chip_smoke.py's
#: TRAIN_LOSS_REL, TRAIN_GRAD_COS, TRAIN_GRAD_MAXREL)
BF16_LOSS_REL, BF16_GRAD_COS, BF16_GRAD_MAXREL = 5e-3, 0.995, 5e-2


def _bf16_grads_run(rank, world, arch, model_axis, over=None):
    """One bf16 ``fsdp_tp`` forward and backward of ``arch`` (with the config
    overrides ``over``) from the port's
    seed-0 init on :func:`_tp_batch`: the loss, the gradients gathered
    whole, the collectives (with their bytes per dtype) beside the step's
    plan; on rank 0 the one-process loss and gradients."""
    from repro_torch.distributed.collectives import ParamGather
    from repro_torch.distributed.context import gathered_params
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = _cfg(arch, {**(over or {}), "dtype": "bfloat16"})
    model = build_model(cfg, "cpu")
    batch = _tp_batch(cfg)
    mesh = make_test_mesh(model=model_axis)
    step = steps_mod.make_sharded_train_step(model, AdamWConfig(), mesh, strategy="fsdp_tp")
    full = model.init(0)
    params = step.shard_params(full)
    counter = step.groups.counter
    counter.reset()
    gather = ParamGather(step.params, params, step.groups.size(step.batch_axes))
    with gathered_params(gather):
        loss, _, grads = steps_mod._grads_of(model, params, batch, 1, True, None,
                                             shard=step.batch_shard)
    out = {"loss": float(loss), "issued": counter.snapshot(),
           "plan": step.plan(tuple(batch["tokens"].shape))}
    grads = step.params.gather(grads)
    if rank == 0:
        one_loss, _, one_grads = steps_mod.value_and_grad(model, full, batch)
        out.update(grads=grads, one_loss=float(one_loss), one_grads=one_grads)
    return out


def _assert_bf16_grads_near_one_process(lead) -> None:
    """The loss and every gradient within the card's bounds for two bf16
    paths of the one-process bf16 step's."""
    assert abs(lead["loss"] - lead["one_loss"]) <= BF16_LOSS_REL * abs(lead["one_loss"])
    want = _by_path(lead["one_grads"])
    for path, a in leaves_with_paths(lead["grads"]):
        b = want[path].float().flatten()
        a = a.float().flatten()
        cos = float(torch.dot(a, b) / torch.clamp(a.norm() * b.norm(), min=1e-30))
        rel = float((a - b).abs().max() / torch.clamp(b.abs().max(), min=1e-30))
        assert cos >= BF16_GRAD_COS and rel <= BF16_GRAD_MAXREL, (path, cos, rel)


def _assert_issued_is_plan(r) -> None:
    """The collectives of one forward and backward are the step's plan, but
    for the step's own all-reduces (the metrics and the gradient norm)."""
    from repro_torch.launch.steps import LOSS_METRICS

    for op in ("reduce_scatter", "all_gather", "all_reduce"):
        got = {k: r["issued"].get(op, {}).get(k, 0)
               for k in ("count", "operand_bytes", "result_bytes")}
        want = {k: r["plan"].get(op, {}).get(k, 0) for k in got}
        if op == "all_reduce":
            step_only = 4 * (1 + LOSS_METRICS) + 4
            want = {"count": want["count"] - 2, "operand_bytes": want["operand_bytes"] - step_only,
                    "result_bytes": want["result_bytes"] - step_only}
        assert got == want, (op, got, want)


def test_bf16_tp_sums_partials_in_f32(tmp_path):
    """rwkv6-1.6b in bf16 at model 2 (ROADMAP C.13): every sum of partial
    products over ``model`` is taken in f32.  The reduce-scatters of the
    row-parallel products (``wo``, ``cv``) carry f32 partial sums and so do
    the backward's (the duals of the residual stream's gathers, whose
    partial input gradients come from the column-parallel products, the
    norms and the token mixes); the only bf16 one is the vocab-parallel
    embedding's lookup, whose sum has one addend that is not zero.  The
    all-reduces over model of the gradients of the leaves the row holds
    copies of are f32.  Bytes are the plan's.  The loss and gradients are held to the one-process
    bf16 step's by the card's bounds for two bf16 paths (the f32 test
    cases' 1e-5 bounds and their reordered-batch controls do not apply: in
    bf16 the reordered one-process step gives the same bits, and any f32
    reordering of a sum moves its bf16 rounding)."""
    from repro_torch.distributed.collectives import axes_key

    cfg = _cfg("rwkv6-1.6b", {"dtype": "bfloat16"})
    out = run_ranks(_bf16_grads_run, 2, tmp_path, "rwkv6-1.6b", 2, timeout=300)
    rows, seq = _tp_batch(cfg)["tokens"].shape
    lookup = rows * seq * cfg.d_model * 2           # the embedding's bf16 partial rows
    for r in out:
        rs = r["issued"]["reduce_scatter"]
        assert rs["dtypes"] == {"bfloat16": lookup, "float32": rs["operand_bytes"] - lookup}
        assert rs["axes"] == {axes_key(("model",)): rs["count"]}
        # the gradients of the leaves the row holds copies of (norm scales,
        # token mixes, the decay adapter) are summed over model in f32
        ar = r["issued"]["all_reduce"]
        assert set(ar["dtypes"]) == {"float32"}
        assert all("model" in axes.split(",") for axes in ar["axes"])
        _assert_issued_is_plan(r)
        # row-parallel products: two a layer, in the forward and the recompute
        assert rs["dtypes"]["float32"] >= 2 * 2 * cfg.n_layers * rows * seq * cfg.d_model * 4
    _assert_bf16_grads_near_one_process(out[0])

@pytest.mark.parametrize("d_model", [66, 64], ids=["whole_d", "split_d"])
def test_bf16_tp_sums_whole_residual_partials_in_f32(tmp_path, d_model):
    """gemma2-2b in bf16 at model 4 with d_model 66, which model does not
    split (ROADMAP C.13's last case): the residual stream is whole on every
    rank, so no all-gather reads it; each rank's partial input gradients of
    a read (from its heads, its d_ff slice and its vocabulary shard) reach
    their sum over model in f32 (an all-reduce of the f32 carrier's
    gradient) and are rounded after it, and a row-parallel product's sum
    (an all-reduce) is f32 too.  The only bf16 sum over model is the
    vocab-parallel lookup's, one addend not zero.  Held to the one-process
    bf16 step by the same bounds as the split case (d_model 64, run beside
    it), collectives the plan's."""
    over = {"d_model": d_model}
    cfg = _cfg("gemma2-2b", {**over, "dtype": "bfloat16"})
    out = run_ranks(_bf16_grads_run, 4, tmp_path, "gemma2-2b", 4, over, timeout=300)
    rows, seq = _tp_batch(cfg)["tokens"].shape
    lookup = rows * seq * cfg.d_model * 2           # the embedding's bf16 partial rows
    for r in out:
        _assert_issued_is_plan(r)
        summed = r["issued"]["reduce_scatter" if d_model % 4 == 0 else "all_reduce"]
        assert summed["dtypes"]["bfloat16"] == lookup, summed["dtypes"]
        assert all("model" in axes.split(",") for axes in summed["axes"])
        if d_model % 4:
            assert "reduce_scatter" not in r["issued"]
            assert "model" not in r["issued"].get("all_gather", {}).get("axes", {})
    _assert_bf16_grads_near_one_process(out[0])
