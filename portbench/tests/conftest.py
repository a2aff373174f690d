"""portbench's own tests: CPU tests of the harness at small sizes, and tests
marked `gpu` that need a card (they skip without one).

    python -m pytest portbench/tests -q
"""
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda:0")


@pytest.fixture
def bench_root(tmp_path):
    """A copy of BENCHMARK.json and portbench/ that a test may edit."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root
