"""The rate and roofline arithmetic."""

import math
import re

import pytest

import cell as cellmod
import roofline


class FakeTrace:
    def __init__(self, busy, window, kernels):
        self.busy_s, self.window_s, self._k = busy, window, kernels

    def kernel_seconds(self, pattern):
        return sum(v for k, v in self._k.items() if re.search(pattern, k))


def test_rates_take_all_the_window():
    win = {"units": 3 * 8192, "seconds": 2.5}
    assert cellmod.end_to_end("events_per_s", win, 1.0) == 3 * 8192 / 2.5
    win = {"units": 3 * 64 * 4 * 1_250_000, "seconds": 2.0}
    assert cellmod.end_to_end("msamples_per_s", win, 1.0) == \
        pytest.approx(3 * 64 * 5.0 / 2.0)
    assert cellmod.end_to_end("setup_s", win, 31.5) == 31.5


def test_bound_matches_the_kernel_table():
    """PERF.md's bounds: rFFT [8192, 32768] 0.6411 ms, [2048, 32768]
    0.1603, the fused fit at B = 8192 0.3206 ms, all bytes-bound."""
    card = "NVIDIA H100 80GB HBM3"
    for kernel, calls, ms in (("rfft", [[1, 8192, 32768]], 0.6411),
                              ("rfft", [[1, 2048, 32768]], 0.1603),
                              ("rfft", [[1, 816, 16384]], 0.0319),
                              ("rfft", [[1, 416, 32768]], 0.0326),
                              ("fused_nodelay_of", [[1, 8192, 32768, 1]],
                               0.3206)):
        sec, which = roofline.bound_seconds(kernel, calls, card)
        assert 1e3 * sec == pytest.approx(ms, abs=1e-4)
        assert which == "bytes"
    assert roofline.bound_seconds("rfft", [[1, 8, 256]], "no such card") \
        is None


def test_work_counts():
    ops, nbytes = roofline.work("rfft", 32768, 2)
    m = 16384
    assert ops == 2 * (5 * m * math.log2(m) + 10 * m)
    assert nbytes == 2 * (4 * 32768 + 8 * (m + 1))


def reader(name):
    return cellmod.reader(cellmod.HERE, name)


def test_roofline_and_idle_readers():
    card = "NVIDIA H100 80GB HBM3"
    traffic = {"transforms": {"rfft": [[5, 2048, 32768]]}}
    least = 5 * roofline.bound_seconds("rfft", [[1, 2048, 32768]], card)[0]
    tr = FakeTrace(0.25, 1.0, {"void rfft_kernel<14>(float2 const*)": 4e-3})
    ctx = dict(trace=tr, trace_batches=4, traffic=traffic, card=card,
               stages={"read": 0.5, "drain": 0.1, "dispatch": 0.2},
               stage_window_s=2.0, stage_batches=8)
    assert reader("rfft_roofline.events")(ctx) == pytest.approx(
        100 * 4 * least / 4e-3)
    assert reader("idle_pct.events")(ctx) == pytest.approx(75.0)
    assert reader("read_wait_pct.events")(ctx) == pytest.approx(25.0)
    assert reader("drain_pct.events")(ctx) == pytest.approx(5.0)
    assert reader("dispatch_ms.continuous")(ctx) == pytest.approx(25.0)
    assert reader("drain_ms.continuous")(ctx) == pytest.approx(12.5)
    # nothing to read: no kernel of that name ran, or no trace
    assert reader("fused_roofline.events")(ctx) is None
    assert reader("idle_pct.events")({**ctx, "trace": None}) is None
