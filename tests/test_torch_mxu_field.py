"""The port's tensor-core field variants (dipole_tpu_torch.tools.
mxu_field_experiment) against the JAX prototype's Pallas kernels
(tools/mxu_field_experiment.py) in interpret mode on the CPU: the same numpy
inputs, made as the prototype makes them, go through both.

Tolerances are per target, on S_t = sum_s (|b||p| + |a|(|s| + |t|)) (the
size of the terms summed, `tolerance_scale`): the products and sums run in
other orders, and the expansion's r^2 = t.t + s.s - 2 t.s cancels."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dipole_tpu.ops import fields_pallas as jpallas
from dipole_tpu_torch.ops import fields
from dipole_tpu_torch.tools import mxu_field_experiment as mxu

_PROTO = Path(__file__).resolve().parent.parent / "tools" / "mxu_field_experiment.py"
RTOL = {"exact": 1e-5, "expansion": 1e-3}


def _prototype():
    spec = importlib.util.spec_from_file_location("jax_mxu_field_experiment", _PROTO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_variant(kernel, src, tgt, eps=1e-5):
    """The prototype's kernel on padded channel-major panels (sentinel
    positions at 1e6), as its main() calls it; E (T, 3)."""
    proto = _prototype()
    sp = -(-len(src) // proto.S_BLK) * proto.S_BLK
    tp = -(-len(tgt) // proto.T_BLK) * proto.T_BLK
    src8 = jpallas._to_channel_major(src, sp, sentinel_pos=True)
    tgt8 = jpallas._to_channel_major(tgt, tp, sentinel_pos=True)
    fn = proto.make_padded(getattr(proto, f"_field_kernel_mxu_{kernel}"))
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(fn(src8, tgt8, np.full((1, 1), eps, np.float32)))
    return out[:3, :len(tgt)].T


def _assert_within(got, want, src, tgt, rtol):
    scale = mxu.tolerance_scale(torch.as_tensor(src), torch.as_tensor(tgt)).numpy()
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    worst = (err / (rtol * scale[:, None])).max()
    assert np.isfinite(got).all()
    assert worst <= 1.0, f"error {worst} x the tolerance {rtol} S_t"


@pytest.mark.parametrize("kernel", ["exact", "expansion"])
@pytest.mark.parametrize("n_tgt,n_src", [(1000, 300), (5000, 1000)])
def test_plain_matches_jax_prototype(kernel, n_tgt, n_src):
    src, tgt, _ = mxu.tool_data(n_tgt, n_src)
    want = _jax_variant(kernel, src, tgt)
    plain = getattr(mxu, f"field_mxu_{kernel}_plain")
    got = plain(torch.as_tensor(src), torch.as_tensor(tgt)).numpy()
    _assert_within(got, want, src, tgt, RTOL[kernel])
    # the dispatch takes the plain version on the CPU
    disp = getattr(mxu, f"field_mxu_{kernel}")(src, tgt, device="cpu").numpy()
    np.testing.assert_array_equal(disp, got)


def test_exact_zero_distance_is_the_field():
    """A target on a source: that pair gives exactly 0, so the exact variant
    is the field of the other sources (fields.field_grad)."""
    src, tgt, _ = mxu.tool_data(400, 1300)
    tgt[:50] = src[100:150, :3]
    src[1200:] = src[:100]                        # duplicate sources
    s, t = torch.as_tensor(src), torch.as_tensor(tgt)
    got = mxu.field_mxu_exact(s, t, device="cpu").numpy()
    want = fields.field_grad(s, t).numpy()
    _assert_within(got, want, src, tgt, RTOL["exact"])
    others = fields.field_grad(torch.cat([s[:100], s[101:]]), t[:1]).numpy()
    _assert_within(got[:1], others, np.delete(src, 100, 0), tgt[:1], RTOL["exact"])


def test_main_on_cpu_prints_the_prototype_lines(capsys):
    res = mxu.main(n_tgt=300, n_src=1000, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    names = ["current", "mxu_exact", "mxu_expansion"]
    assert [ln.split(":")[0].strip() for ln in lines] == names + names[1:]
    assert all("GPairs/s" in ln for ln in lines[:3])
    assert all("rel max diff" in ln and "interaction-sign agreement" in ln
               for ln in lines[3:])
    assert all(np.isfinite(v) and v > 0 for v in res["gpairs_per_s"].values())
    assert res["sign_agreement"]["mxu_exact"] >= 0.99
    assert res["rel_max_diff"]["mxu_exact"] <= 1e-3


def test_main_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mxu.main()
