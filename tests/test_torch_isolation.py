"""The port imports nothing of JAX or of the JAX package ``repro``: every
module, the copies of ``repro.obs`` and ``repro.service`` included, the
training modules (``data``, ``optim``, ``checkpoint``, ``distributed``,
``launch.steps``, ``launch.train``) and the distribution modules
(``distributed.sharding``, ``collectives``, ``pipeline``, ``launch.mesh``,
``launch.dryrun``, which sets no ``XLA_FLAGS`` when imported).  Its checkpoints need no ``ml_dtypes``
either: nothing of ``repro_torch.checkpoint`` imports it, and importing the
whole port loads it nowhere."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", sorted((PORT / "checkpoint").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_checkpoint_imports_no_ml_dtypes(path):
    assert "ml_dtypes" not in set(_imported_roots(path)), f"{path.relative_to(ROOT)} imports ml_dtypes"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, os, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "sys.path.insert(0, sys.argv[1]); import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 68, mods\n"
        "assert {'repro_torch.obs.tracer', 'repro_torch.obs.metrics', 'repro_torch.service.registry',\n"
        "        'repro_torch.service.tuning_service', 'repro_torch.core.resolution',\n"
        "        'repro_torch.data.pipeline', 'repro_torch.optim.adamw', 'repro_torch.optim.compression',\n"
        "        'repro_torch.checkpoint.manager', 'repro_torch.distributed.context',\n"
        "        'repro_torch.distributed.fault', 'repro_torch.launch.steps',\n"
        "        'repro_torch.launch.train', 'repro_torch.tree',\n"
        "        'repro_torch.distributed.sharding', 'repro_torch.distributed.collectives',\n"
        "        'repro_torch.distributed.pipeline', 'repro_torch.launch.mesh',\n"
        "        'repro_torch.launch.dryrun'} <= set(mods), mods\n"
        "assert 'XLA_FLAGS' not in os.environ, os.environ['XLA_FLAGS']\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
