"""The port's slot engine on reduced minitron-4b, rwkv6-1.6b,
recurrentgemma-2b and mixtral-8x22b against ``repro.serving``.

Same converted weights, same prompts: per-step logits of the two engines
agree within rtol = atol = 2e-4 (f32).  Plus the engine's admission rules
and the serving entry point's result JSON.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.fleet.traffic import sample_prompts as jsample_prompts
from repro.models import build_model as jbuild_model
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.serving import ServingEngine, SlotsFull

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def pair():
    jcfg = jreduced(jget_arch("minitron-4b"))
    cfg = reduced(get_arch("minitron-4b"))
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return jmodel, jparams, model, params


def _serve_both(jeng, eng, prompts, new_tokens):
    """Admit prompts as slots free up and step both engines together; every
    decode step's logits agree and every request's first token is the same.
    Teacher forcing: both continue from the reference's tokens."""
    pending = list(prompts)
    jreqs, reqs = [], []
    for _ in range(64):
        if pending and eng.free_slots:
            p = pending.pop(0)
            jreqs.append(jeng.add_request(p, max_new_tokens=new_tokens))
            reqs.append(eng.add_request(p, max_new_tokens=new_tokens))
            assert reqs[-1].generated[0] == jreqs[-1].generated[0]
        ran = bool(jeng.active)
        assert ran == bool(eng.active)
        jfin, fin = jeng.step(), eng.step()
        assert [r.uid for r in fin] == [r.uid for r in jfin]
        if ran:
            np.testing.assert_allclose(eng.last_logits.numpy(), np.asarray(jeng.last_logits), **TOL)
        for r, jr in zip(reqs, jreqs):
            r.generated[:] = jr.generated
        if not pending and not jeng.active:
            break
    assert all(r.done for r in reqs) and all(len(r.generated) == new_tokens for r in reqs)


@pytest.mark.parametrize("slots,prompts", [
    (2, [[5, 6, 7, 8], [9, 10, 11], [3, 1, 4, 1, 5, 9, 2]]),
    (3, [[1, 2, 3, 4, 5, 6, 7, 8, 9], [42], [7, 7, 7, 7, 7]]),
])
def test_engine_steps_match_reference(pair, slots, prompts):
    """Requests join at different steps (continuous batching, per-slot
    positions, a slot freed and reused)."""
    jmodel, jparams, model, params = pair
    _serve_both(JServingEngine(jmodel, jparams, slots=slots, max_len=32),
                ServingEngine(model, params, slots=slots, max_len=32), prompts, 4)


def test_windowed_engine_matches_reference():
    """Local/global layers with an 8-slot ring: buckets stop at the ring size
    (a 12-token prompt prefills at its exact length) and decode wraps the
    ring."""
    import dataclasses

    kw = dict(layer_pattern=("L", "G"), window=8, attn_softcap=50.0)
    jcfg = dataclasses.replace(jreduced(jget_arch("minitron-4b")), **kw)
    cfg = dataclasses.replace(reduced(get_arch("minitron-4b")), **kw)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    jeng = JServingEngine(jmodel, jparams, slots=2, max_len=32)
    eng = ServingEngine(model, params, slots=2, max_len=32)
    assert [eng.bucket_for(n) for n in (5, 8, 12)] == [jeng.bucket_for(n) for n in (5, 8, 12)] == [8, 8, 12]
    _serve_both(jeng, eng, [list(range(1, 13)), [4, 5, 6, 7, 8], [9, 9, 2]], 10)


def test_slots_full_and_slot_reuse(pair):
    _, _, model, params = pair
    eng = ServingEngine(model, params, slots=2, max_len=32)
    assert eng.free_slots == 2 and eng.utilization() == 0.0
    eng.add_request([1, 2, 3])
    eng.add_request([4, 5])
    assert eng.free_slots == 0 and eng.utilization() == 1.0
    with pytest.raises(SlotsFull):
        eng.add_request([6])
    eng.run_to_completion()
    assert not eng.active and eng.free_slots == 2
    r = eng.add_request([7, 8], max_new_tokens=2)
    eng.run_to_completion()
    assert r.done


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_max_new_tokens_is_exact(pair, n):
    """``max_new_tokens=N`` yields exactly N tokens counting the prefill
    token; N <= 1 finishes at admission without holding a slot."""
    _, _, model, params = pair
    eng = ServingEngine(model, params, slots=1, max_len=32)
    r = eng.add_request([1, 2, 3], max_new_tokens=n)
    if n <= 1:
        assert r.done and not eng.active
    eng.run_to_completion()
    assert r.done and len(r.generated) == max(n, 1)


def test_prompt_longer_than_max_len_rejected(pair):
    _, _, model, params = pair
    eng = ServingEngine(model, params, slots=1, max_len=8)
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request(list(range(1, 10)))
    assert not eng.active


def test_eos_on_prefill_token_finishes_at_admission(pair):
    _, _, model, params = pair
    first = ServingEngine(model, params, slots=1, max_len=32).add_request(
        [1, 2, 3], max_new_tokens=4).generated[0]
    eng = ServingEngine(model, params, slots=1, max_len=32)
    r = eng.add_request([1, 2, 3], max_new_tokens=4, eos_id=first)
    assert r.done and r.generated == [first] and not eng.active


def test_prefill_buckets_are_powers_of_two_and_inert(pair):
    _, _, model, params = pair
    eng = ServingEngine(model, params, slots=1, max_len=32)
    exact = ServingEngine(model, params, slots=1, max_len=32, prefill_buckets=False)
    assert [eng.bucket_for(n) for n in (1, 3, 5, 17, 32)] == [1, 4, 8, 32, 32]
    assert exact.bucket_for(5) == 5
    rb = eng.add_request([9, 10, 11, 12, 13], max_new_tokens=3)
    re_ = exact.add_request([9, 10, 11, 12, 13], max_new_tokens=3)
    eng.step()
    exact.step()
    np.testing.assert_allclose(eng.last_logits.numpy(), exact.last_logits.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert eng.prefill_padded_tokens == 8 and eng.prefill_true_tokens == 5
    eng.run_to_completion()
    exact.run_to_completion()
    assert rb.generated == re_.generated


def test_sample_prompts_is_the_reference_stream():
    a = serve.sample_prompts(np.random.default_rng(3), 6, 512)
    b = jsample_prompts(np.random.default_rng(3), 6, 512)
    assert a == b


def test_serve_main_on_cpu_prints_result(capsys):
    res = serve.main(["--device", "cpu", "--preset", "smoke", "--requests", "5",
                      "--new-tokens", "3", "--slots", "2", "--max-len", "16"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == res
    assert {"arch", "preset", "device", "backend", "requests", "decode_steps", "tokens",
            "tok_per_s", "prefill_shapes", "kernel_launches"} <= set(res)
    assert res["requests"] == 5 and res["tokens"] == 15 and res["device"] == "cpu"
    # CPU tensors take the plain versions: no kernel launch
    assert res["kernel_launches"] == {"matmul": 0, "grouped_matmul": 0, "flash_attention": 0,
                                      "rwkv6_scan": 0, "rglru_scan": 0}


def test_serve_main_ref_backend_gives_same_tokens(capsys):
    argv = ["--device", "cpu", "--requests", "3", "--new-tokens", "3"]
    assert serve.main(argv)["tokens"] == serve.main(argv + ["--backend", "ref"])["tokens"] == 9


@pytest.fixture(scope="module", params=["rwkv6-1.6b", "recurrentgemma-2b"])
def recurrent_pair(request):
    jcfg = jreduced(jget_arch(request.param))
    cfg = reduced(get_arch(request.param))
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(4))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return jmodel, jparams, model, params


def test_recurrent_engine_steps_match_reference(recurrent_pair):
    """Recurrent archs prefill at the exact prompt length (a pad step would
    fold into the state); requests join at different steps, a slot is
    freed and reused with its state and carries replaced, and griffin's
    8-position attention ring wraps."""
    jmodel, jparams, model, params = recurrent_pair
    jeng = JServingEngine(jmodel, jparams, slots=2, max_len=32)
    eng = ServingEngine(model, params, slots=2, max_len=32)
    assert not eng.prefill_buckets and not jeng.prefill_buckets
    assert [eng.bucket_for(n) for n in (3, 5, 12)] == [3, 5, 12]
    _serve_both(jeng, eng, [list(range(1, 13)), [4, 5, 6, 7, 8], [9, 9, 2], [7] * 10], 6)
    assert eng.prefill_padded_tokens == eng.prefill_true_tokens == 12 + 5 + 3 + 10


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_serve_main_recurrent_arch_on_cpu(capsys, arch):
    res = serve.main(["--device", "cpu", "--preset", "smoke", "--arch", arch, "--requests", "3",
                      "--new-tokens", "4", "--slots", "2"])
    assert res["arch"] == arch and res["requests"] == 3 and res["tokens"] == 12
    assert set(res["kernel_launches"].values()) == {0}


def test_moe_engine_steps_match_reference():
    """Reduced mixtral (4 experts top-2, 8-position rings): prompts up to the
    ring size prefill in buckets, a longer one at its exact length; every
    decode step routes the active slots' tokens through the experts."""
    jcfg = jreduced(jget_arch("mixtral-8x22b"))
    cfg = reduced(get_arch("mixtral-8x22b"))
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    jeng = JServingEngine(jmodel, jparams, slots=3, max_len=32)
    eng = ServingEngine(model, params, slots=3, max_len=32)
    assert [eng.bucket_for(n) for n in (3, 5, 12)] == [jeng.bucket_for(n) for n in (3, 5, 12)]
    _serve_both(jeng, eng, [list(range(1, 13)), [4, 5, 6, 7, 8], [9, 9, 2], [7] * 6], 6)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_serve_main_moe_arch_on_cpu(capsys, arch):
    res = serve.main(["--device", "cpu", "--preset", "smoke", "--arch", arch, "--requests", "3",
                      "--new-tokens", "4", "--slots", "2"])
    assert res["arch"] == arch and res["requests"] == 3 and res["tokens"] == 12
    assert set(res["kernel_launches"].values()) == {0}


# ---------------------------------------------------------------------------
# Execution plans: resolution through a provider, re-planning at step
# boundaries, the entry point's tuning flags
# ---------------------------------------------------------------------------


def _service(tmp_path, **kw):
    from repro_torch.core.runner import AnalyticalRunner, CachedRunner
    from repro_torch.service import ScheduleRegistry, TuningService

    registry = ScheduleRegistry(str(tmp_path / "reg"))
    kw.setdefault("probe_candidates", 0)
    return registry, TuningService(registry, model_id="serve", max_workers=0,
                                   runner=CachedRunner(AnalyticalRunner()), **kw)


def test_plan_replans_at_step_boundary_and_serves_upgrade(pair, tmp_path):
    """A schedule published mid-serve reaches the live engine: the plan is
    swapped at a decode-step boundary (never mid-step) and the upgraded
    schedule becomes the plan's exact-tier entry (a port of the reference's
    test of the same name)."""
    import dataclasses

    from repro_torch.core.database import Record
    from repro_torch.core.schedule import default_schedule
    from repro_torch.kernels.ops import ScheduleProvider

    _, _, model, params = pair
    registry, service = _service(tmp_path)
    provider = ScheduleProvider(service=service)
    eng = ServingEngine(model, params, slots=2, max_len=32, provider=provider)
    assert eng.plan is not None and len(eng.plan) > 0

    eng.add_request([1, 2, 3], max_new_tokens=8)
    eng.add_request([4, 5, 6, 7], max_new_tokens=8)
    eng.step()
    eng.step()
    g0 = eng.plan.generation
    assert eng.replans == 0

    inst = next(u.instance for u in eng.plan.uses if u.instance.class_id == "matmul")
    assert eng.plan.lookup(inst).tier == "default"
    upgraded = dataclasses.replace(default_schedule(inst), unroll=4, source="background")
    registry.publish([Record(instance=inst, schedule=upgraded,
                             seconds=service.runner.seconds(inst, upgraded),
                             model_id="background", target=service.target)])
    # nothing swaps until the next step boundary
    assert eng.plan.generation == g0

    eng.run_to_completion()
    assert eng.replans == 1
    entry = eng.plan.lookup(inst)
    assert entry.tier == "exact" and entry.schedule == upgraded
    assert not eng.active  # the stream kept serving through the swap

    gens = [g for _, g in eng.plan_history]
    assert gens == sorted(gens)
    assert gens[0] == g0 and gens[-1] > g0
    assert len(gens) == len(set(gens)) == 2


def test_replan_mid_run_gives_the_final_plans_tokens(pair, tmp_path):
    """An engine that re-plans mid-run serves the same tokens as one that
    runs on the final plan throughout."""
    from repro_torch.core.database import Record
    from repro_torch.core.schedule import Schedule
    from repro_torch.kernels.ops import ScheduleProvider

    _, _, model, params = pair
    prompts = [[5, 6, 7, 8], [9, 10, 11], [3, 1, 4, 1, 5]]

    def run(registry, service, publish_at):
        eng = ServingEngine(model, params, slots=2, max_len=32,
                            provider=ScheduleProvider(service=service))
        pending, reqs, steps = list(prompts), [], 0
        while pending or eng.active:
            while pending and eng.free_slots:
                reqs.append(eng.add_request(pending.pop(0), max_new_tokens=6))
            eng.step()
            steps += 1
            if steps == publish_at:
                registry.publish([record])
        return eng, [r.generated for r in reqs]

    reg_a, svc_a = _service(tmp_path / "a")
    eng_a = ServingEngine(model, params, slots=2, max_len=32, provider=ScheduleProvider(service=svc_a))
    inst = next(u.instance for u in eng_a.plan.uses
                if u.instance.class_id == "matmul_bias_gelu" and u.instance.p["M"] == 2)
    sched = Schedule.make(inst.class_id, {"M": 2, "N": 32, "K": inst.p["K"]},
                          order=("N", "M", "K"))
    record = Record(instance=inst, schedule=sched, seconds=svc_a.runner.seconds(inst, sched),
                    model_id="background", target=svc_a.target)
    replanned, tokens_a = run(reg_a, svc_a, publish_at=3)
    assert replanned.replans == 1 and replanned.plan.lookup(inst).schedule == sched

    reg_b, svc_b = _service(tmp_path / "b")
    reg_b.publish([record])
    final, tokens_b = run(reg_b, svc_b, publish_at=0)
    assert final.replans == 0 and final.plan.lookup(inst).schedule == sched
    assert tokens_a == tokens_b


class _Recording:
    """Wraps a provider's ``get``: every instance asked, and whether the
    active plan answered it."""

    def __init__(self, provider):
        self.calls = []
        real = provider.get

        def get(inst):
            self.calls.append((inst, provider.plan is not None
                               and provider.plan.lookup(inst) is not None))
            return real(inst)

        provider.get = get

    def take(self):
        calls, self.calls = self.calls, []
        return calls


@pytest.mark.parametrize("arch", ["minitron-4b", "recurrentgemma-2b"])
def test_decode_steps_are_plan_hits_and_plan_matches_reference(arch, tmp_path):
    """Over one prefill and a few decode steps every decode-step instance is
    a plan hit; the misses are what the reference's ``plan_serving`` cannot
    cover either: the prefill LM head at 1 row, and every instance of a
    prompt at an unplanned (exact, unbucketed) length.  The plan's workload
    keys are the reference's ``plan_serving``'s for the same geometry."""
    from repro.core.resolution import ResolutionPipeline as JResolutionPipeline
    from repro.core.resolution import plan_serving as jplan_serving
    from repro.core.extract import extract_kernels as jextract
    from repro.configs import ShapeConfig as JShapeConfig
    from repro_torch.kernels.ops import ScheduleProvider

    cfg = reduced(get_arch(arch))
    model = build_model(cfg, "cpu")
    params = model.init(seed=0)
    _, service = _service(tmp_path)
    provider = ScheduleProvider(service=service)
    eng = ServingEngine(model, params, slots=2, max_len=32, provider=provider)
    jcfg = jreduced(jget_arch(arch))
    jplan = jplan_serving(jcfg, JResolutionPipeline.build(), slots=2, max_len=32,
                          prefill_lengths=eng._bucket_lengths())
    assert [u.instance.workload_key() for u in eng.plan.uses] == \
        [u.instance.workload_key() for u in jplan.uses]

    rec = _Recording(provider)
    eng.add_request([3, 1, 4, 1, 5], max_new_tokens=5)
    prefill = rec.take()
    for _ in range(3):
        eng.step()
        decode = rec.take()
        assert decode and all(hit for _, hit in decode)
    asked = {inst.workload_key(): inst for inst, _ in prefill}
    misses = {inst.workload_key() for inst, hit in prefill if not hit}
    assert misses == {k for k in asked if jplan.get(k) is None}
    if eng.prefill_buckets:
        # a bucketed prompt is planned (its 1-row LM head too: bucket 1's
        # prefill has one), except the global attention, which the ops key
        # with window=0 and extract_kernels without a window: the
        # reference's plan misses it alike
        assert {(asked[k].class_id, asked[k].p.get("window")) for k in misses} == \
            {("flash_attention_causal", 0)}
    else:
        # an exact-length prompt: none of its instances is planned, the
        # 1-row prefill LM head among them
        assert misses == set(asked)
        assert any(asked[k].class_id == "matmul_lmhead" and asked[k].p["M"] == 1 for k in misses)
        planned_prompt = {u.instance.workload_key()
                          for u in jextract(jcfg, JShapeConfig("p", 5, 1, "prefill"))}
        assert all(jplan.get(k) is None for k in planned_prompt)
    assert provider.stats()["plan_misses"] == sum(not hit for _, hit in prefill)


def test_serve_main_with_registry_reports_the_reference_blocks(capsys, tmp_path):
    """``--tuning-registry`` on the CPU under ``--target tpu-v5e``: the result
    JSON carries the reference's blocks (resolution tier counts, the plan's
    tiers, re-plans, the tuning service's stats) with the reference's keys."""
    from repro.core.runner import AnalyticalRunner as JAnalyticalRunner
    from repro.kernels.ops import ScheduleProvider as JScheduleProvider
    from repro.service import ScheduleRegistry as JScheduleRegistry
    from repro.service import TuningService as JTuningService

    res = serve.main(["--device", "cpu", "--preset", "smoke", "--target", "tpu-v5e",
                      "--tuning-registry", str(tmp_path / "reg"), "--requests", "3",
                      "--new-tokens", "3", "--slots", "2", "--max-len", "16"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["requests"] == res["requests"] == 3 and res["tokens"] == 9
    assert {"target", "schedule_hits", "schedule_misses", "resolution", "replans", "plan",
            "tuning_service"} <= set(res)
    assert res["target"] == "tpu-v5e" and res["replans"] >= 0
    jsvc = JTuningService(JScheduleRegistry(str(tmp_path / "jreg")), max_workers=0,
                          runner=JAnalyticalRunner())
    assert set(res["resolution"]) == set(JScheduleProvider(service=jsvc).stats())
    assert set(res["tuning_service"]) == set(jsvc.stats())
    assert set(res["plan"]) == {"entries", "generation", "tiers"}
    assert sum(res["plan"]["tiers"].values()) == res["plan"]["entries"] > 0
    # the deferred jobs ran at exit
    assert res["tuning_service"]["jobs_completed"] == res["tuning_service"]["jobs_enqueued"] > 0


def test_serve_main_refuses_a_measured_target_on_the_cpu(tmp_path):
    with pytest.raises(ValueError, match="timed on the card"):
        serve.main(["--device", "cpu", "--preset", "smoke", "--target", "h100",
                    "--tuning-registry", str(tmp_path / "reg")])
    with pytest.raises(ValueError, match="timed on the card"):
        serve.main(["--device", "cpu", "--preset", "smoke", "--target", "h100"])
