"""Nothing the benchmark runs imports jax or the JAX package, compared by
whole top-level names (dipole_tpu_torch begins with dipole_tpu), and the
reference imports nothing of the port."""
import ast
import subprocess
import sys

from portbench import core

MODULES = ["portbench.run", "portbench.control", "portbench.sweep", "portbench.trace",
           "portbench.loops.closed_loop", "portbench.loops.open_loop",
           "portbench.loops.open_loop_client", "portbench.entries.orient_simple",
           "portbench.entries.server_para", "portbench.reference.simple",
           "dipole_tpu_torch.api", "dipole_tpu_torch.serve.server_para"]


def test_top_level_names_are_compared_whole():
    assert core.forbidden_modules(["dipole_tpu_torch", "dipole_tpu_torch.api",
                                   "jaxtyping", "flaxen", "numpy"]) == []
    assert core.forbidden_modules(["dipole_tpu", "dipole_tpu.api", "jax.numpy",
                                   "jaxlib", "flax.linen"]) == [
        "dipole_tpu", "dipole_tpu.api", "flax.linen", "jax.numpy", "jaxlib"]


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n" % str(core.ROOT)
            + "".join(f"import {m}\n" for m in MODULES)
            + "from portbench import core\nprint(core.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=core.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().split("\n")[-1] == "[]"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_reference_imports_neither_jax_nor_either_package():
    for path in (core.PKG / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "dipole_tpu", "dipole_tpu_torch"), \
                (path.name, name)


def test_harness_sources_name_no_jax_package():
    for path in core.PKG.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in core.FORBIDDEN_MODULES, (path, name)
