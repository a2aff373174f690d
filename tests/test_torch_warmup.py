"""utils.warmup.ensure_warm: nothing to do without a card (the JAX package's
ensure_warm returns False off the TPU), the kernel build and nothing else on
one, and JAX's opt-out switch."""
import torch

from dipole_tpu.utils import warmup as jwarmup
from dipole_tpu_torch.ops import _build
from dipole_tpu_torch.utils import warmup


def test_ensure_warm_is_a_no_op_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setenv("DIPOLE_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("DIPOLE_TPU_NO_AUTOWARM", raising=False)
    monkeypatch.setattr(_build, "build_all", lambda: 1 / 0)
    assert warmup.ensure_warm(quiet=True, device="cpu") is False
    assert warmup.ensure_warm(quiet=True) is jwarmup.ensure_warm(quiet=True) is False
    assert not any(tmp_path.iterdir())
    monkeypatch.setenv("DIPOLE_TPU_NO_AUTOWARM", "1")
    assert warmup.ensure_warm(quiet=True) is False


def test_ensure_warm_on_a_card_only_builds(monkeypatch):
    """On a card (is_available patched) it builds the libraries, every
    call (the build cache makes a repeat cheap); the switch skips it."""
    calls = []
    monkeypatch.delenv("DIPOLE_TPU_NO_AUTOWARM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build_all", lambda: calls.append(1))
    assert warmup.ensure_warm(quiet=True) is True
    assert warmup.ensure_warm(quiet=True, device="cuda:1") is True
    assert calls == [1, 1]
    assert warmup.ensure_warm(quiet=True, device="cpu") is False
    monkeypatch.setenv("DIPOLE_TPU_NO_AUTOWARM", "1")
    assert warmup.ensure_warm(quiet=True) is False
    assert calls == [1, 1]
