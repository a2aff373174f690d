"""The yardstick's counts at small shapes, against numbers worked by hand."""
import pytest

from portbench.counts import ops, peaks


def test_greedy_columns_counts():
    # 37 operations a pair, n^2 pairs; reads (n, 6), writes acc and sign
    assert ops.greedy_columns(10) == (37 * 100, 4 * (60 + 20))


def test_potential_and_orient_simple_call():
    assert ops.potential(5, 1000) == (17 * 5000, 4 * (30 + 3000 + 1000))
    # the greedy's n^2 pairs at 37 operations and the sign fix's potential
    n = 20000
    assert ops.orient_simple_call(n) == 37 * n * n + 17 * n * 1000
    assert ops.OPS_IMATRIX + ops.OPS_GREEDY_ROW == ops.OPS_GREEDY_COLUMN


def test_bound_and_share():
    t, by = peaks.bound_s(3.35e12, 67e12 / 2)
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = peaks.bound_s(0, 67e12)
    assert (t, by) == (pytest.approx(1.0), "operations")
    # the 180k column greedy, as PERF.md's kernel table: 17.9 ms of operations
    t, by = peaks.bound_s(*reversed(ops.greedy_columns(180000)))
    assert by == "operations" and t == pytest.approx(0.0179, rel=2e-3)
    assert peaks.share_pct(0.0179, 0.672) == pytest.approx(2.66, rel=1e-2)
    assert peaks.share_pct(1.0, 0.0) is None
