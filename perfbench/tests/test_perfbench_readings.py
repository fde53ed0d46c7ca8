"""The readings: the rate, the p95, the idle share's union, the roofline's
counts."""
import math

import pytest

import run
from harness import roofline
from harness import trace as tr
from harness.record import Record
from spec_helpers import metric


def _ctx(records, window_s=10.0, trace=None, chunks=None):
    ctx = run.Context(records=records, window_s=window_s, setup_s=1.0, config={}, trace=trace)
    if chunks is not None:
        ctx.chunks = lambda r: chunks
    return ctx


def test_rate_is_all_completed_bytes_over_the_whole_window():
    recs = [Record("a", 2_000_000, 0.0, 4.0, True), Record("b", 3_000_000, 4.0, 9.5, True),
            Record("c", 5_500_000, 9.5, 10.5, True),   # sent before the close, ends after
            Record("d", 7_000_000, 2.0, 3.0, False)]   # failed: its time counts, not its bytes
    assert metric("throughput_mb_s").read(_ctx(recs, window_s=10.5)) == pytest.approx(1.0)


def test_p95_is_over_every_file_and_a_failure_is_infinitely_late():
    recs = [Record(f"f{i}", 1, i * 0.1, i * 0.1 + 0.01 * (i + 1), True) for i in range(40)]
    recs.reverse()  # the order of completion does not matter
    assert metric("file_p95_s").read(_ctx(recs)) == pytest.approx(0.38)
    # 2 failures of 40 stay within the 5% beyond the rank; a third does not
    for i in range(2):
        recs[i] = Record(f"f{i}", 1, i * 0.1, i * 0.1 + 0.01, False)
    assert metric("file_p95_s").read(_ctx(recs)) == pytest.approx(0.38)
    recs[2] = Record("f2", 1, 0.2, 0.21, False)
    assert math.isinf(metric("file_p95_s").read(_ctx(recs)))


def test_idle_share_merges_overlapping_intervals():
    # kernels 0-2 and 1-3 overlap, a copy 2.5-4 overlaps the second, 6-7 apart
    t = tr.Trace(window_s=10e-6, kernels=[("k", 0, 2), ("k", 1, 3), ("k", 6, 7)],
                 copies=[("Memcpy HtoD", 2.5, 4)], host=[("file x", 0, 10)])
    assert tr.union([(0, 2), (1, 3), (2.5, 4), (6, 7)]) == [(0, 4), (6, 7)]
    assert t.busy_s == pytest.approx(5e-6)
    assert metric("device.idle_share").read(_ctx([], trace=t)) == pytest.approx(50.0)
    assert tr.gaps(t.merged, 0, 10) == [(4, 6), (7, 10)]
    assert t.idle_gaps()[0] == ["file x", pytest.approx(3e-6)]


def test_roofline_counts_depend_on_the_chunk_not_on_the_timing():
    recs = [Record("a", 1_000_000, 0.0, 1.0, True, b"")]
    chunk = [(128, 4_305_675)]
    fast = tr.Trace(window_s=1.0, kernels=[("scan_kernel", 0, 500.0)])
    slow = tr.Trace(window_s=1.0, kernels=[("scan_kernel", 0, 1000.0)])
    a = metric("kernels_roofline").read(_ctx(recs, trace=fast, chunks=chunk))
    b = metric("kernels_roofline").read(_ctx(recs, trace=slow, chunks=chunk))
    least = roofline.least_s(4_305_675, 128)
    assert a == pytest.approx(100 * least / 500e-6) and b == pytest.approx(a / 2)


def test_roofline_table_shapes_give_the_kernel_table_bounds():
    """At bench.mp4's chunk 0 the counts are the kernel table's (PERF.md)."""
    w = roofline.work(4_305_675, 128)
    assert w["lane_scan_dev"] == (59_612_248, 43_056_750)
    assert w["lane_compact"][0] == pytest.approx(25_690_112)
    assert w["wire_expand4_blob"][0] == pytest.approx(141_364_340)
    assert set(roofline.bound_by(4_305_675, 128).values()) == {"bytes"}
