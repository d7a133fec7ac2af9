"""The frozen copies: the byte models behind the roofline shares and the
interval arithmetic of the device trace."""

import pytest

from benchmark.metrics._bytes import HBM_BYTES_PER_S, STREAMS, least_seconds
from benchmark.metrics._end_to_end import mean
from benchmark.metrics._intervals import gaps, union_seconds

N = 4_096_000


def test_kernel_bounds_are_the_kernel_tables():
    """PERF.md's kernel table: K2's bound 34.2 µs and K8's 88.0 µs at
    n = 4,096,000 in float32 at 3.35 TB/s."""
    assert HBM_BYTES_PER_S == 3.35e12
    assert least_seconds("tri_sweep.upper", N, 4) * 1e6 \
        == pytest.approx(34.2, abs=0.05)
    assert least_seconds("plain_factor_sweep", N, 4) * 1e6 \
        == pytest.approx(88.0, abs=0.05)
    assert STREAMS["tri_sweep.lower"] == STREAMS["tri_sweep.upper"] - 1


def test_union_and_gaps():
    iv = [(0.0, 10.0), (5.0, 12.0), (20.0, 25.0), (24.0, 24.5),
          (30.0, 31.0)]
    assert union_seconds(iv) == pytest.approx(18e-6)
    assert gaps(iv) == [(12.0, 20.0), (25.0, 30.0)]
    assert union_seconds([]) == 0.0 and gaps([]) == []
    # the order of the events does not matter
    assert union_seconds(iv[::-1]) == union_seconds(iv)


def test_busy_is_the_profile_scripts_union():
    """The same arithmetic as scripts/profile_solves.py's ``_busy_ms``."""
    events = [{"ts": t0, "dur": t1 - t0} for t0, t1 in
              [(3.0, 7.0), (1.0, 4.0), (9.0, 9.5), (9.2, 12.0)]]
    busy_us, end = 0.0, -1.0
    for e in sorted(events, key=lambda e: e["ts"]):
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    assert union_seconds([(e["ts"], e["ts"] + e["dur"]) for e in events]) \
        == pytest.approx(busy_us / 1e6)


def test_mean():
    assert mean([1, 2, 3]) == 2
    assert mean(iter([0.5, 1.5])) == 1.0
