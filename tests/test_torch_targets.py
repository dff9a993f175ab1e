"""The port's hardware specs and target registry against the reference's.

The three TPU targets are copies, field by field; ``h100`` is the port's
own: registered, a server-tier target with the card's datasheet peaks, and
measured only — the analytical runner refuses it, so no cost-model second
can land in its namespace.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.hw import specs as jspecs
from repro.targets import registry as jregistry
from repro_torch.core.runner import AnalyticalRunner, CachedRunner, default_runner, resolve_runner
from repro_torch.hw import specs
from repro_torch.targets import DEFAULT_TARGET, get_target, list_targets, registry, resolve_target

TPU_TARGETS = ("tpu-v5e", "tpu-v5e-lite", "tpu-v5p")


@pytest.mark.parametrize("name", TPU_TARGETS)
def test_tpu_targets_equal_the_references(name):
    t, jt = get_target(name), jregistry.get_target(name)
    assert dataclasses.asdict(t.spec) == dataclasses.asdict(jt.spec)
    assert (t.name, t.tier, t.description) == (jt.name, jt.tier, jt.description)
    const = name.upper().replace("-", "_")
    assert dataclasses.asdict(getattr(specs, const)) == dataclasses.asdict(getattr(jspecs, const))


def test_registry_is_the_references_plus_h100():
    assert DEFAULT_TARGET == jregistry.DEFAULT_TARGET == "tpu-v5e"
    assert list_targets() == sorted([*jregistry.list_targets(), "h100"])
    assert resolve_target(None).name == "tpu-v5e"


def test_h100_target_has_the_cards_peaks():
    t = get_target("h100")
    assert t.tier == "server" and t.spec is specs.H100
    assert (t.spec.peak_flops_bf16, t.spec.hbm_bandwidth, t.spec.hbm_capacity) == (
        989e12, 3.35e12, 80 * 1024 ** 3)
    assert t.spec.vmem_capacity == 227 * 1024
    assert resolve_target(specs.H100) is t


@pytest.mark.parametrize("target", ["h100", specs.H100])
def test_analytical_runner_refuses_the_card(target):
    with pytest.raises(ValueError, match="MeasuredRunner"):
        AnalyticalRunner(target)
    with pytest.raises(ValueError, match="MeasuredRunner"):
        default_runner(target)
    with pytest.raises(ValueError, match="MeasuredRunner"):
        resolve_runner(None, target)


def test_runner_target_must_match_the_requested_one():
    runner = CachedRunner(AnalyticalRunner("tpu-v5p"))
    assert resolve_runner(runner)[1] == "tpu-v5p"
    with pytest.raises(ValueError, match="measures target"):
        resolve_runner(runner, "h100")


def test_a_spec_wearing_a_registered_name_is_refused():
    fake = dataclasses.replace(specs.H100, hbm_bandwidth=1e12)
    with pytest.raises(ValueError, match="differs"):
        registry.resolve_target(fake)
