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
