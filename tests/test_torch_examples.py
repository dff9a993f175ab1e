"""The port's serve tracing and its examples, on the CPU, against the
reference's.

* ``repro_torch.launch.serve --trace-out --metrics-out`` on ``--device cpu
  --preset smoke`` against ``repro.launch.serve --backend pallas`` (the
  reference's path that resolves schedules) at the same seed: the same
  span and event names with the same counts, the same metrics keys, and
  every counter equal but the three that count lookups.  The reference
  resolves a kernel instance when it traces a step, once per shape; the
  port resolves at every call, so its one unplanned instance (the global
  attention's prefill key, ROADMAP C.5) adds a memo hit at every prefill
  after the first: ``cache_hits``, ``resolves`` and ``served_default``
  exceed the reference's by exactly the port's extra plan misses.
* ``transfer_tuning_demo``, ``serve_with_tuning`` and ``quickstart``'s
  steps 1-4 print the reference example's numbers line for line
  (analytical: the port's tuning core is a copy of the reference's;
  ``serve_with_tuning`` with its jobs deferred to its drain on both sides);
  quickstart's step 5 runs K1's plain version on the CPU (error 0).
* ``serve_lm`` and ``train_lm`` (20 steps) run at the
  reduced size and keep their original's checks: every request served,
  the loss falls, a checkpoint and the loss curve written.
"""
import collections
import contextlib
import importlib.util
import io
import json
import re
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import quickstart, serve_lm, serve_with_tuning, train_lm
from repro_torch.examples import transfer_tuning_demo
from repro_torch.launch import serve as serve_mod

ROOT = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?")


def _reference_example(name: str):
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed(fn, *args) -> tuple[list[str], object]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue().splitlines(), out


def _numbers(lines: list[str], paths: tuple[str, ...] = ()) -> list[list[str]]:
    """Each line's numbers, with the given paths taken out first."""
    out = []
    for ln in lines:
        for p in paths:
            ln = ln.replace(p, "")
        out.append(NUMBER.findall(ln))
    return out


def test_serve_trace_and_metrics_match_reference(tmp_path):
    from repro.launch import serve as jserve

    port, ref = tmp_path / "port", tmp_path / "ref"
    port.mkdir()
    ref.mkdir()
    args = ["--preset", "smoke", "--arch", "minitron-4b", "--seed", "3"]
    _, got = _printed(serve_mod.main, args + ["--device", "cpu", "--trace-out", str(port / "t.json"),
                                              "--metrics-out", str(port / "m.json")])
    _, want = _printed(jserve.main, args + ["--backend", "pallas", "--trace-out", str(ref / "t.json"),
                                            "--metrics-out", str(ref / "m.json")])

    def names(path):
        trace = json.loads(path.read_text())
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        return collections.Counter((e["ph"], e["name"]) for e in events)

    spans = names(port / "t.json")
    assert spans == names(ref / "t.json")
    assert spans["X", "prefill"] == got["requests"] == want["requests"] == 8
    assert spans["X", "decode_step"] == got["decode_steps"] == want["decode_steps"]
    m_got = json.loads((port / "m.json").read_text())
    m_want = json.loads((ref / "m.json").read_text())
    assert set(m_got) == set(m_want)
    extra = got["resolution"]["plan_misses"] - want["resolution"]["plan_misses"]
    assert extra > 0
    lookups = ("resolution.cache_hits", "resolution.resolves", "resolution.served_default")
    for key, v in m_want.items():
        assert m_got[key]["kind"] == v["kind"], key
        want_value = v["value"] + (extra if key in lookups else 0)
        assert m_got[key]["value"] == want_value, (key, m_got[key], v)


def test_transfer_tuning_demo_prints_the_reference_numbers():
    got, _ = _printed(transfer_tuning_demo.main, [])
    want, _ = _printed(_reference_example("transfer_tuning_demo").main)
    assert len(got) == len(want) > 10
    assert _numbers(got) == _numbers(want)
    assert "model-us" in got[1] and "us" in want[1]


def test_serve_with_tuning_prints_the_reference_numbers(tmp_path, monkeypatch):
    """Both with their tuning jobs deferred to the drain after request 1:
    with worker threads a job may publish before request 1 looks up, in
    either package, so their printouts differ from run to run."""
    for module in (serve_with_tuning, reference := _reference_example("serve_with_tuning")):
        service = module.TuningService
        monkeypatch.setattr(module, "TuningService",
                            lambda *a, _s=service, **kw: _s(*a, **{**kw, "max_workers": 0}))
    got, out = _printed(serve_with_tuning.main, ["--registry", str(tmp_path / "port")])
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))   # the reference's mkdtemp
    want, _ = _printed(reference.main)
    ref_root = next(p for p in tmp_path.iterdir() if p.name.startswith("schedule-registry-"))
    assert len(got) == len(want)
    assert _numbers(got, (str(tmp_path / "port"),)) == _numbers(want, (str(ref_root),))
    assert out["stats"]["upgrades"] > 0
    assert out["requests"][1]["tiers"]["exact"] == 0 < out["requests"][2]["tiers"]["exact"]


def test_quickstart_prints_the_reference_numbers(tmp_path, monkeypatch):
    db = tmp_path / "port_db.json"
    got, out = _printed(quickstart.main, ["--device", "cpu", "--db", str(db)])
    reference = _reference_example("quickstart")
    monkeypatch.setattr(reference, "DB_PATH", str(tmp_path / "ref_db.json"))
    want, _ = _printed(reference.main)
    step5 = next(i for i, ln in enumerate(want) if ln.startswith("== 5."))
    assert got[step5].startswith("== 5.")
    assert _numbers(got[:step5], (str(db),)) == _numbers(want[:step5], (str(tmp_path / "ref_db.json"),))
    assert got[step5 + 1] == "  kernel-vs-plain max err: 0.00e+00 (cpu)"
    assert db.exists() and out["max_err"] == 0.0


def test_serve_lm_serves_every_request():
    lines, out = _printed(serve_lm.main, ["--device", "cpu"])
    assert [r["arch"] for r in out] == ["minitron-4b", "mixtral-8x22b", "recurrentgemma-2b"]
    assert all(r["requests"] == 10 and r["tokens"] > 0 for r in out)
    assert len(lines) == 3 and all("10 requests" in ln for ln in lines)


def test_train_lm_reduces_the_loss(tmp_path):
    lines, out = _printed(train_lm.main, ["--device", "cpu", "--steps", "20", "--batch", "4",
                                          "--seq", "32", "--out", str(tmp_path)])
    assert out["losses"][-1] < out["losses"][0]
    assert (tmp_path / "loss.csv").read_text().count("\n") == 20
    assert any((tmp_path / "ckpt").iterdir())
    assert lines[0].startswith("model: ") and lines[-1].startswith("loss: ")
