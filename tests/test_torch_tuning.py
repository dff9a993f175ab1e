"""The port's transfer-tuning core against the reference's, bit for bit.

``repro_torch.core`` is a copy of ``repro.core`` (the port imports nothing
of ``repro``), so the same seeds must give the same workloads, schedules,
cost-model seconds, tuning results, donor rankings and transfers, compared
with ``==`` on floats, schedules and JSON, with
``CachedRunner(AnalyticalRunner())`` on the TPU targets.  Then
:class:`~repro_torch.core.measured_runner.MeasuredRunner` on the CPU: it
times the plain versions under a test target of its own, with the card's
validity and memo rules (the card's own timings come from
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import dataclasses
import functools
import json
import random
import re

import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.core import autoscheduler as jauto
from repro.core import cnn_workloads as jcnn
from repro.core import cost_model as jcost
from repro.core import heuristic as jheur
from repro.core import runner as jrunner
from repro.core import transfer as jtransfer
from repro.core import tuner as jtuner
from repro.core.database import ScheduleDB as JScheduleDB
from repro.core.extract import extract_kernels as jextract
from repro.core.schedule import ScheduleInvalid as JScheduleInvalid
from repro.core.schedule import concretize as jconcretize
from repro.core.schedule import default_schedule as jdefault_schedule
from repro.core.workload import KernelInstance as JKernelInstance
from repro.core.workload import KernelUse as JKernelUse
from repro.hw import specs as jspecs
from repro.hw.specs import TPU_V5E
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_arch
from repro_torch.core import autoscheduler as auto
from repro_torch.core import cnn_workloads as cnn
from repro_torch.core import cost_model as cost
from repro_torch.core import heuristic as heur
from repro_torch.core import runner as prunner
from repro_torch.core import transfer as ptransfer
from repro_torch.core import tuner
from repro_torch.core.database import Record, ScheduleDB
from repro_torch.core.extract import extract_kernels
from repro_torch.core.measured_runner import MeasuredRunner
from repro_torch.core.schedule import Schedule, ScheduleInvalid, concretize, default_schedule
from repro_torch.core.workload import KernelInstance, KernelUse
from repro_torch.hw import specs as pspecs
from repro_torch.targets import Target, registry

TPU_TARGETS = ("tpu-v5e", "tpu-v5e-lite", "tpu-v5p")
#: the serving prefill bucket the chip phase tunes at, beside the reference's shapes
SERVE_SHAPE = ("serve_prefill_256", 256, 1, "prefill")
DONORS = ("starcoder2-7b", "stablelm-12b", "rwkv6-1.6b")


def _port(x):
    """A reference KernelInstance / Schedule / KernelUse as the port's, by JSON."""
    if isinstance(x, JKernelUse):
        return KernelUse.from_json(x.to_json())
    if isinstance(x, JKernelInstance):
        return KernelInstance.from_json(x.to_json())
    return Schedule.from_json(x.to_json())


def _jrunner(target="tpu-v5e"):
    return jrunner.CachedRunner(jrunner.AnalyticalRunner(target))


def _prunner(target="tpu-v5e"):
    return prunner.CachedRunner(prunner.AnalyticalRunner(target))


def _uses_json(uses):
    return [u.to_json() for u in uses]


def _result(res, drop=("wall_time_s",)):
    """A tuning/transfer result as plain data: schedules, records and
    instances by their JSON, wall time left out."""
    def conv(v):
        if hasattr(v, "to_json"):
            return v.to_json()
        if dataclasses.is_dataclass(v):
            return {f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v
    return {f.name: conv(getattr(res, f.name)) for f in dataclasses.fields(res)
            if f.name not in drop}


# ---------------------------------------------------------------------------
# workloads, schedules and the cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_extract_kernels_match_reference(arch):
    """Every arch × every shape (and the chip phase's serving bucket, and a
    sharded mesh): the same workload keys, use counts and tags; and
    ``default_schedule`` / ``concretize`` agree on each instance."""
    shapes = [(SHAPES[s], JSHAPES[s]) for s in SHAPES]
    shapes.append((ShapeConfig(*SERVE_SHAPE), type(JSHAPES["train_4k"])(*SERVE_SHAPE)))
    for (shape, jshape), (dp, tp) in zip(shapes * 2, [(1, 1)] * len(shapes) + [(4, 2)] * len(shapes)):
        got = extract_kernels(get_arch(arch), shape, dp=dp, tp=tp)
        want = jextract(jget_arch(arch), jshape, dp=dp, tp=tp)
        assert _uses_json(got) == _uses_json(want), (shape.name, dp, tp)
        assert [u.instance.workload_key() for u in got] == [u.instance.workload_key() for u in want]
        for u, ju in zip(got, want):
            d, jd = default_schedule(u.instance), jdefault_schedule(ju.instance)
            assert d.to_json() == jd.to_json()
            cs, jcs = concretize(d, u.instance), jconcretize(jd, ju.instance)
            assert (cs.tiles, cs.grid, cs.adapted) == (jcs.tiles, jcs.grid, jcs.adapted)


@functools.lru_cache(maxsize=None)
def _grid_instances() -> tuple:
    """Reference kernel instances of all three families from a few archs and
    shapes."""
    out = []
    for arch, shape in (("minitron-4b", "train_4k"), ("rwkv6-1.6b", "prefill_32k"),
                        ("recurrentgemma-2b", "decode_32k"), ("dbrx-132b", "train_4k"),
                        ("gemma2-2b", "prefill_32k")):
        out += [u.instance for u in jextract(jget_arch(arch), JSHAPES[shape])]
    return tuple(out)


@pytest.mark.parametrize("target", TPU_TARGETS)
def test_cost_model_matches_reference(target):
    """``measure`` and ``kernel_seconds`` on a seeded grid of (instance,
    random schedule, seed, mode): the same Measurement and seconds, or both
    invalid."""
    rng = random.Random(7)
    name = target.upper().replace("-", "_")
    spec, jspec = getattr(pspecs, name), getattr(jspecs, name)
    families = set()
    for jinst in _grid_instances():
        inst = _port(jinst)
        families.add(inst.family)
        for _ in range(4):
            jsched = jauto.random_schedule(jinst, rng)
            if rng.random() < 0.5:   # a schedule tuned on another instance of the class
                donor = next(i for i in _grid_instances()[::-1] if i.class_id == jinst.class_id)
                jsched = jauto.random_schedule(donor, rng)
            seed, mode = rng.randrange(100), rng.choice(("strict", "adaptive"))
            m = cost.measure(inst, _port(jsched), mode=mode, seed=seed, spec=spec)
            jm = jcost.measure(jinst, jsched, mode=mode, seed=seed, spec=jspec)
            assert _result(m) == _result(jm)
            try:
                want = jcost.kernel_seconds(jinst, jsched, mode=mode, spec=jspec)
            except JScheduleInvalid as e:   # the port raises the same
                with pytest.raises(ScheduleInvalid, match=f"^{re.escape(str(e))}$"):
                    cost.kernel_seconds(inst, _port(jsched), mode=mode, spec=spec)
            else:
                assert cost.kernel_seconds(inst, _port(jsched), mode=mode, spec=spec) == want
    assert families == {"matmul", "attention", "scan"}


def test_random_schedules_and_mutations_match_reference():
    """The autoscheduler's draws from one seeded rng: the same schedules."""
    for jinst in _grid_instances()[:12]:
        inst = _port(jinst)
        rng, jrng = random.Random(3), random.Random(3)
        for _ in range(5):
            s, js = auto.random_schedule(inst, rng), jauto.random_schedule(jinst, jrng)
            assert s.to_json() == js.to_json()
            assert auto.mutate(s, inst, rng).to_json() == jauto.mutate(js, jinst, jrng).to_json()
            assert (auto.crossover(s, s, rng).to_json() == jauto.crossover(js, js, jrng).to_json())
            assert list(auto.featurize(s, inst)) == list(jauto.featurize(js, jinst))


# ---------------------------------------------------------------------------
# tuning
# ---------------------------------------------------------------------------


def test_tune_kernel_matches_reference():
    """GEMM 512³, 64 trials: the same best schedule, best seconds, trace and
    telemetry."""
    inst, jinst = (KernelInstance.make("matmul", M=512, N=512, K=512),
                   JKernelInstance.make("matmul", M=512, N=512, K=512))
    got = auto.tune_kernel(inst, trials=64, seed=0, runner=_prunner())
    want = jauto.tune_kernel(jinst, trials=64, seed=0, runner=_jrunner())
    assert got.best.to_json() == want.best.to_json()
    assert _result(got) == _result(want)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "minitron-4b"])
def test_tune_model_matches_reference(arch):
    """A whole arch at a reduced budget: the same records, seconds and trace."""
    got = tuner.tune_arch(ScheduleDB(), arch, "train_4k", total_trials=96, runner=_prunner())
    want = jtuner.tune_arch(JScheduleDB(), arch, "train_4k", total_trials=96, runner=_jrunner())
    assert [r.to_json() for r in got.records] == [r.to_json() for r in want.records]
    assert _result(got) == _result(want)


@pytest.fixture(scope="module")
def dbs():
    """Donor pools tuned by each package from the same seeds (records equal
    by test_tune_model_matches_reference)."""
    db, jdb = ScheduleDB(), JScheduleDB()
    for arch in DONORS:
        tuner.tune_arch(db, arch, "train_4k", total_trials=64, runner=_prunner())
        jtuner.tune_arch(jdb, arch, "train_4k", total_trials=64, runner=_jrunner())
    return db, jdb


def test_schedule_db_loads_across_packages(dbs, tmp_path):
    """A DB saved by the port loads in the reference and vice versa, to the
    same JSON."""
    db, jdb = dbs
    db.save(str(tmp_path / "port.json"))
    jdb.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    back = JScheduleDB.load(str(tmp_path / "port.json"))
    forth = ScheduleDB.load(str(tmp_path / "ref.json"))
    assert [r.to_json() for r in back.records()] == [r.to_json() for r in jdb.records()]
    assert [r.to_json() for r in forth.records()] == [r.to_json() for r in db.records()]
    assert json.dumps([r.to_json() for r in forth.records()]) == json.dumps(
        [r.to_json() for r in back.records()])


@pytest.mark.parametrize("arch", ["minitron-4b", "gemma2-2b", "recurrentgemma-2b"])
def test_donor_rankings_match_reference(dbs, arch):
    """Eq. 1 (``select_donor``, ``top_donors``, ``donor_scores``) and the
    compatibility-aware ``donor_scores_v2``: the same rankings and scores."""
    db, jdb = dbs
    uses, juses = tuner.arch_uses(arch), jtuner.arch_uses(arch)
    r, jr = _prunner(), _jrunner()
    assert heur.select_donor(uses, db, runner=r) == jheur.select_donor(juses, jdb, runner=jr)
    assert ([_result(s) for s in heur.top_donors(uses, db, k=3, runner=r)]
            == [_result(s) for s in jheur.top_donors(juses, jdb, k=3, runner=jr)])
    assert ([_result(s) for s in heur.donor_scores_v2(uses, db, runner=r)]
            == [_result(s) for s in jheur.donor_scores_v2(juses, jdb, runner=jr)])
    assert ([_result(s) for s in tuner.donor_ranking(db, arch, runner=r)]
            == [_result(s) for s in jtuner.donor_ranking(jdb, arch, runner=jr)])


def _kernels(res):
    return [(k.chosen.to_json() if k.chosen else None, k.chosen_from, k.seconds,
             k.untuned_seconds, k.candidates, k.invalid, k.exact_hit, k.pruned)
            for k in res.kernels]


@pytest.mark.parametrize("mode", ["strict", "adaptive"])
@pytest.mark.parametrize("arch", ["minitron-4b", "gemma2-2b"])
def test_transfer_tune_matches_reference(dbs, arch, mode):
    """Transfer from the Eq. 1 donor and from the mixed pool: the same chosen
    schedules, seconds and invalid counts."""
    db, jdb = dbs
    for donors in ("auto", None):
        got = tuner.transfer_arch(db, arch, donors=donors, mode=mode, runner=_prunner())
        want = jtuner.transfer_arch(jdb, arch, donors=donors, mode=mode, runner=_jrunner())
        assert _kernels(got) == _kernels(want)
        assert (got.invalid_transfers, got.untuned_seconds, got.tuned_seconds, got.search_time_s) == (
            want.invalid_transfers, want.untuned_seconds, want.tuned_seconds, want.search_time_s)
        assert _result(got, drop=("wall_time_s", "kernels", "uses")) == _result(
            want, drop=("wall_time_s", "kernels", "uses"))


def test_cross_target_transfer_and_matrix_match_reference(dbs):
    """tpu-v5e donors re-measured on tpu-v5e-lite (VMEM overflows surface as
    invalid transfers), and the Fig. 4 transfer matrix."""
    db, jdb = dbs
    uses, juses = tuner.arch_uses("minitron-4b"), jtuner.arch_uses("minitron-4b")
    got = ptransfer.cross_target_transfer(uses, db, source_target="tpu-v5e", target="tpu-v5e-lite",
                                          runner=_prunner("tpu-v5e-lite"))
    want = jtransfer.cross_target_transfer(juses, jdb, source_target="tpu-v5e",
                                           target="tpu-v5e-lite", runner=_jrunner("tpu-v5e-lite"))
    assert _kernels(got) == _kernels(want)
    assert got.invalid_transfers == want.invalid_transfers > 0
    assert (ptransfer.transfer_matrix(uses, db, donors=["starcoder2-7b"], runner=_prunner())
            == jtransfer.transfer_matrix(juses, jdb, donors=["starcoder2-7b"], runner=_jrunner()))


def test_pruning_runner_matches_reference(dbs):
    """``PruningRunner(CachedRunner(...), verify_top_k=4)``: the same tuning
    and transfer results and the same telemetry."""
    db, jdb = dbs
    r = prunner.PruningRunner(_prunner(), verify_top_k=4)
    jr = jrunner.PruningRunner(_jrunner(), verify_top_k=4)
    inst = KernelInstance.make("matmul_silu_glu", M=1024, N=2048, K=512)
    jinst = JKernelInstance.make("matmul_silu_glu", M=1024, N=2048, K=512)
    assert _result(auto.tune_kernel(inst, trials=48, runner=r)) == _result(
        jauto.tune_kernel(jinst, trials=48, runner=jr))
    got = tuner.transfer_arch(db, "minitron-4b", donors=None, runner=r)
    want = jtuner.transfer_arch(jdb, "minitron-4b", donors=None, runner=jr)
    assert _kernels(got) == _kernels(want)
    assert got.pruned_candidates == want.pruned_candidates > 0
    assert r.telemetry() == jr.telemetry()


@pytest.mark.parametrize("model", sorted(jcnn.CNN_MODELS))
def test_cnn_uses_match_reference(model):
    assert _uses_json(cnn.cnn_uses(model)) == _uses_json(jcnn.cnn_uses(model))
    assert ([u.instance.workload_key() for u in cnn.cnn_uses(model, batch=4)]
            == [u.instance.workload_key() for u in jcnn.cnn_uses(model, batch=4)])


# ---------------------------------------------------------------------------
# MeasuredRunner on the CPU: the plain versions, timed by the host clock,
# under a target of the test's own
# ---------------------------------------------------------------------------

CPU_TARGET = "cpu-plain-test"


@pytest.fixture
def cpu_runner(monkeypatch):
    """A CPU runner under a target registered for the test alone (the
    registry is restored after it, so other tests see the shipped targets)."""
    monkeypatch.setitem(registry._REGISTRY, CPU_TARGET,
                        Target(name=CPU_TARGET, spec=dataclasses.replace(TPU_V5E, name=CPU_TARGET)))
    return MeasuredRunner(target=CPU_TARGET, device="cpu")


def _f32(class_id, **params):
    return KernelInstance.make(class_id, dtype="float32", **params)


def test_measured_runner_validity_is_the_schedule_irs(cpu_runner):
    """A K tile that does not divide K is invalid, and so is a parallel
    reduction axis; a schedule that overflows tpu-v5e-lite's VMEM is valid
    (the card has no capacity rule)."""
    inst = _f32("matmul", M=256, N=256, K=192)
    bad = Schedule.make("matmul", {"M": 64, "N": 64, "K": 128})
    assert not cpu_runner.measure(inst, bad).valid
    with pytest.raises(ScheduleInvalid):
        cpu_runner.seconds(inst, bad)
    par = Schedule.make("matmul", {"M": 64, "N": 64, "K": 64}, order=("K", "M", "N"), parallel=1)
    assert not cpu_runner.measure(inst, par).valid
    inst_big = _f32("matmul", M=1024, N=1024, K=1024)
    huge = Schedule.make("matmul", {"M": 1024, "N": 1024, "K": 1024})
    assert not prunner.AnalyticalRunner("tpu-v5e-lite").measure(inst_big, huge).valid
    m = cpu_runner.measure(inst_big, huge)
    assert m.valid and m.seconds > 0 and m.measure_cost_s > 0


def test_measured_runner_times_one_launch_once(cpu_runner):
    """Schedules that differ only in what no launch reads (unroll, the K
    tile, vec, cache_write) get one timing; ``measure`` and ``seconds`` give
    it alike; another M tile is another timing."""
    inst = _f32("matmul_bias_gelu", M=64, N=96, K=48)
    a = Schedule.make("matmul_bias_gelu", {"M": 16, "N": 32, "K": 48}, unroll=0)
    b = Schedule.make("matmul_bias_gelu", {"M": 16, "N": 32, "K": 16}, unroll=64, vec=512,
                      cache_write=False)
    ma, mb = cpu_runner.measure(inst, a), cpu_runner.measure(inst, b)
    assert ma.seconds == mb.seconds == cpu_runner.seconds(inst, b)
    assert cpu_runner.stats.measurements == 1 and cpu_runner.ties == 1
    c = Schedule.make("matmul_bias_gelu", {"M": 32, "N": 32, "K": 48})
    cpu_runner.measure(inst, c)
    assert cpu_runner.stats.measurements == 2
    assert cpu_runner.telemetry()["ties"] == 1


def test_measured_runner_keys_follow_the_wrappers():
    """What each family's launch reads: matmul tiles M and N, the order (per
    expert for the grouped classes) and the rounding K tile (bf16 without
    the f32 scratch; 0 otherwise), attention the Q tile, RG-LRU the C tile,
    rwkv6 nothing."""
    key = MeasuredRunner.launch_key
    mm = _f32("matmul", M=64, N=64, K=64)
    s = lambda c, t, **kw: Schedule.make(c, t, **kw)  # noqa: E731
    assert key(concretize(s("matmul", {"M": 8, "N": 16, "K": 8}), mm))[1] == (8, 16, True, 0)
    assert key(concretize(s("matmul", {"M": 8, "N": 16, "K": 8}, order=("N", "M", "K")), mm))[1] == (
        8, 16, False, 0)
    bf = KernelInstance.make("matmul", M=64, N=64, K=64, dtype="bfloat16")
    assert key(concretize(s("matmul", {"M": 8, "N": 16, "K": 8}, order=("N", "K", "M")), bf))[1] == (
        8, 16, False, 8)
    moe = _f32("moe_gemm", M=64, N=32, K=16, E=4)
    assert key(concretize(s("moe_gemm", {"M": 64, "N": 64, "K": 16, "E": 1}), moe))[1] == (
        16, 32, True, 0)
    att = _f32("flash_attention_causal", Q=32, KV=32, H=2, D=16, B=1)
    assert key(concretize(s("flash_attention_causal", {"Q": 8, "KV": 16}), att))[1] == (8,)
    rwi = _f32("rwkv6_scan", T=16, C=32, D=16, B=1)
    assert key(concretize(s("rwkv6_scan", {"T": 4, "C": 16}), rwi))[1] == ()
    rgi = _f32("rglru_scan", T=16, C=64, B=1)
    assert key(concretize(s("rglru_scan", {"T": 4, "C": 16}), rgi))[1] == (16,)


def test_tuning_and_transfer_run_through_the_measured_runner(cpu_runner):
    """``tune_model``, ``select_donor`` and ``transfer_tune`` end to end on
    timed plain versions: records carry the test target, transferred kernels
    are never slower than untuned, and every family is launched."""
    from repro_torch.core.runner import CachedRunner

    runner = CachedRunner(cpu_runner)
    shape = ShapeConfig("tiny", 8, 1, "prefill")
    cfg = dataclasses.replace(get_arch("minitron-4b"), d_model=64, n_heads=4, n_kv_heads=2,
                              d_ff=128, vocab_size=256, n_layers=2, head_dim=0, dtype="float32")
    donor = dataclasses.replace(cfg, name="donor", d_model=32, n_heads=2, n_kv_heads=1, d_ff=96)
    db = ScheduleDB()
    res = auto.tune_model(extract_kernels(donor, shape), "donor", total_trials=48, runner=runner)
    for r in res.records:
        db.add(r)
    assert res.target == CPU_TARGET and {r.target for r in db.records()} == {CPU_TARGET}
    uses = extract_kernels(cfg, shape)
    assert heur.select_donor(uses, db, runner=runner) == "donor"
    tt = ptransfer.transfer_tune(uses, db, model_id=cfg.name, donors=["donor"], runner=runner)
    assert tt.target == CPU_TARGET and tt.measurements > 0
    assert all(k.seconds <= k.untuned_seconds for k in tt.kernels)
    assert tt.tuned_seconds <= tt.untuned_seconds
    for k in tt.kernels:   # the final seconds are the ones that chose the schedule
        if k.chosen is not None:
            assert k.seconds == cpu_runner.seconds(k.instance, k.chosen)
    scan = auto.tune_kernel(_f32("rglru_scan", T=16, C=64, B=1), trials=16, runner=runner)
    assert scan.target == CPU_TARGET and scan.search_time_s > 0
    wkv = auto.tune_kernel(_f32("rwkv6_scan", T=16, C=32, D=16, B=1), trials=16, runner=runner)
    assert wkv.runner_telemetry["measurements"] == 1   # one launch whatever the schedule


def test_measured_runner_refuses_cnn_classes(cpu_runner):
    inst = cnn.cnn_uses("resnet18")[0].instance
    with pytest.raises(ValueError, match=inst.class_id):
        cpu_runner.measure(inst, default_schedule(inst))
    with pytest.raises(ValueError, match=inst.class_id):
        cpu_runner.seconds(inst)


def test_measured_runner_needs_a_card_or_an_explicit_cpu_target():
    """No card: ``MeasuredRunner()`` raises, never falls back to the CPU; on
    the CPU a target must be named, and it may not be the card's."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        MeasuredRunner()
    with pytest.raises(ValueError):
        MeasuredRunner(device="cpu")
    with pytest.raises(ValueError, match="h100"):
        MeasuredRunner(target="h100", device="cpu")


def test_records_measured_by_the_port_are_plain_records(cpu_runner, tmp_path):
    """A DB of CPU-timed records round-trips through JSON under its target."""
    inst = _f32("matmul", M=32, N=32, K=32)
    res = auto.tune_kernel(inst, trials=8, runner=cpu_runner)
    db = ScheduleDB([Record(instance=inst, schedule=res.best, seconds=res.best_seconds,
                            model_id="m", target=res.target)])
    db.save(str(tmp_path / "db.json"))
    back = ScheduleDB.load(str(tmp_path / "db.json"))
    assert back.exact(inst, target=CPU_TARGET).seconds == res.best_seconds
    assert back.exact(inst) is None
