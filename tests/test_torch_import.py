"""dipole_tpu_torch imports without JAX or optax and imports nothing of
dipole_tpu."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "dipole_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_CHECK = """
import sys
import dipole_tpu_torch
import dipole_tpu_torch.api
import dipole_tpu_torch.cli.orient_simple
import dipole_tpu_torch.cli.orient_pointcloud, dipole_tpu_torch.cli.orient_large
import dipole_tpu_torch.cli.dipole_api, dipole_tpu_torch.cli.reference_orientation
import dipole_tpu_torch.ops.estimate, dipole_tpu_torch.ops.fields
import dipole_tpu_torch.ops.propagate, dipole_tpu_torch.ops.metrics
import dipole_tpu_torch.ops.patching, dipole_tpu_torch.ops.neighbors
import dipole_tpu_torch.ops.neighbors_cuda
import dipole_tpu_torch.models.checkpoints, dipole_tpu_torch.models.pointcnn
import dipole_tpu_torch.models.inference
import dipole_tpu_torch.native, dipole_tpu_torch.utils.config
import dipole_tpu_torch.utils.prng
import dipole_tpu_torch.graphs, dipole_tpu_torch.ops.solve
import dipole_tpu_torch.serve.handlers, dipole_tpu_torch.pipelines.graph_dipole
import dipole_tpu_torch.cli.graph_dipole, dipole_tpu_torch.ops.propagate_cuda
import dipole_tpu_torch.tools.mxu_field_experiment
import dipole_tpu_torch.serve.protocol, dipole_tpu_torch.serve.batching
import dipole_tpu_torch.serve.server, dipole_tpu_torch.serve.server_para
import dipole_tpu_torch.train, dipole_tpu_torch.utils.torch_rng
import dipole_tpu_torch.utils.warmup
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "optax", "dipole_tpu")]
assert "jax" not in sys.modules, bad
assert not bad, bad
"""


def test_import_leaves_jax_out():
    r = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_source_imports_no_jax_and_no_dipole_tpu(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "optax", "dipole_tpu"), f"{path.name} imports {mod}"
