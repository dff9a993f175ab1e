"""The port's checkpoint manager: the reference's layout and manifest,
async save, atomic commit, retention; bf16 leaves round-trip bit for bit
without ``ml_dtypes``; and checkpoints read across the two packages."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.tree import leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((4, 8), generator=g),
                   "b": torch.randn(8, generator=g).to(torch.bfloat16),
                   "layers": [{"u": torch.randn(3, generator=g).to(torch.bfloat16)}]},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "q": torch.randint(-127, 128, (5,), generator=g, dtype=torch.int8)},
    }


def _assert_bits_equal(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.dim() else x, y.view(torch.uint8) if y.dim() else y)


def test_roundtrip_is_bit_exact(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = _tree()
    tree["params"]["b"][0] = float("nan")            # any bit pattern survives
    m.save(5, tree)
    step, restored = m.restore(tree)
    assert step == 5
    _assert_bits_equal(tree, restored)


def test_manifest_has_the_reference_layout(tmp_path):
    CheckpointManager(str(tmp_path)).save(3, _tree())
    d = tmp_path / "step_00000003"
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["step"] == 3
    entries = {e["path"]: e for e in manifest["leaves"]}
    assert entries["['params']['b']"]["dtype"] == "bfloat16"
    assert entries["['params']['layers'][0]['u']"]["shape"] == [3]
    assert entries["['opt']['step']"]["dtype"] == "int32"
    for e in entries.values():
        raw = np.load(d / e["file"])
        assert raw.dtype == np.uint8 and raw.ndim == 1


def test_restore_onto_meta_template(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = _tree(1)
    m.save(1, tree)
    template = tree_map(lambda t: torch.empty_like(t, device="meta"), tree)
    _, restored = m.restore(template)
    _assert_bits_equal(tree, restored)


def test_async_save_retention_and_no_tmp_dirs(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, _tree(s), blocking=s % 2 == 0)
    m.wait()
    assert m.all_steps() == [3, 4] and m.latest_step() == 4
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_restore_errors(tmp_path):
    m = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        m.restore({})
    m.save(1, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        m.restore({"w": torch.zeros((3, 3))})
    with pytest.raises(KeyError):
        m.restore({"v": torch.zeros((2, 2))})


def test_reference_reads_the_ports_checkpoint(tmp_path):
    tree = _tree(2)
    CheckpointManager(str(tmp_path)).save(9, tree)
    jtemplate = tree_map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.dtype(str(t.dtype).removeprefix("torch."))),
        tree)
    step, restored = JCheckpointManager(str(tmp_path)).restore(jtemplate)
    assert step == 9
    for x, y in zip(jax.tree_util.tree_leaves(tree_map(lambda t: t.float().numpy(), tree)),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(x, np.asarray(y, np.float32))


def test_port_reads_the_reference_checkpoint(tmp_path):
    r = np.random.default_rng(0)
    jtree = {"params": {"w": jnp.asarray(r.normal(size=(4, 8)), jnp.float32),
                        "b": jnp.asarray(r.normal(size=8), jnp.bfloat16)},
             "opt": {"step": jnp.asarray(7, jnp.int32)}}
    JCheckpointManager(str(tmp_path)).save(4, jtree)
    template = {"params": {"w": torch.zeros((4, 8)), "b": torch.zeros(8, dtype=torch.bfloat16)},
                "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    step, restored = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 4
    for x, y in zip(jax.tree_util.tree_leaves(tree_map(lambda t: t.float().numpy(), restored)),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(x, np.asarray(y, np.float32))
    assert restored["params"]["b"].dtype == torch.bfloat16


def test_bf16_roundtrip_without_ml_dtypes(tmp_path):
    """The port's checkpoints need no ml_dtypes: with its import blocked, a
    bf16 leaf round-trips bit for bit and ml_dtypes is never loaded."""
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.checkpoint import CheckpointManager\n"
        "x = torch.randn(64).to(torch.bfloat16)\n"
        "m = CheckpointManager(sys.argv[1]); m.save(1, {'x': x})\n"
        "_, r = m.restore({'x': torch.empty_like(x)})\n"
        "assert torch.equal(r['x'].view(torch.int16), x.view(torch.int16))\n"
        "assert sys.modules['ml_dtypes'] is None\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
