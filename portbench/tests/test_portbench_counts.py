"""The operation and byte counts, and the reduction of a device trace."""

import pytest

from portbench.lib import counts
from portbench.lib.trace import ANNOTATION, DeviceTrace, _reduce


def test_the_agz_network_costs_16_2_gflop_a_board():
    flops = counts.aznet_flops(19, 256, 19, 2, 1, 256)
    conv = 2 * 361 * 9 * 256 * 256
    by_hand = (2 * 361 * 9 * 6 * 256 + 38 * conv + 2 * 361 * 256 * 2 + 2 * 722 * 362
               + 2 * 361 * 256 + 2 * 361 * 256 + 2 * 256)
    assert flops == by_hand == 16_193_654_760
    assert counts.search_evaluations(32) == 33


def test_byte_counts_equal_hand_counts():
    assert counts.env_step_bytes(19) == 6 * 361 * 2 + 4 + 4 + 1 == 4341
    assert counts.bundle_flood_bytes(19, 12288) == 26_615_808
    assert counts.bundle_flood_bytes(19, 12288) / counts.HBM_BYTES == pytest.approx(7.945e-6, rel=1e-3)


class _Event:
    def __init__(self, name, start, dur, cuda, annotation=False):
        self._v = name, start, dur, cuda, annotation

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]


def test_a_trace_reduces_to_busy_idle_and_gaps():
    events = [
        _Event(ANNOTATION, 1000, 1000, False, True),
        _Event(ANNOTATION, 1000, 1000, True, True),  # the span's device-side image
        _Event("portbench.rollout", 1000, 500, False, True),
        _Event("cudaGraphLaunch", 1000, 100, False),
        _Event("kernel_a", 1100, 200, True),
        _Event("kernel_b", 1250, 100, True),  # overlaps kernel_a
        _Event("kernel_a", 1600, 100, True),
        _Event("aten::item", 1500, 500, False),
    ]
    t = _reduce(events, units=2)
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_intervals() == [[1100, 1350], [1600, 1700]]
    assert t.busy_s == pytest.approx(350e-9)
    assert t.op_count() == 3 and t.op_count("kernel_a") == 2
    assert t.op_seconds("kernel_a") == pytest.approx(300e-9)
    assert t.durations("kernel_b") == [pytest.approx(100e-9)]
    assert t.top_ops() == [["kernel_a", pytest.approx(300e-9)], ["kernel_b", pytest.approx(100e-9)]]
    gaps = dict(t.idle_gaps())
    # 1000-1100 under the launch in the rollout span, 1350-1600 in the span, 1700-2000 under the fetch
    assert gaps == {"cudaGraphLaunch in portbench.rollout": pytest.approx(100e-9),
                    "portbench.rollout": pytest.approx(250e-9), "aten::item": pytest.approx(300e-9)}


def test_a_trace_without_its_span_is_refused():
    with pytest.raises(RuntimeError):
        _reduce([_Event("kernel_a", 0, 1, True)], units=1)


def test_an_empty_trace_reads_nothing():
    t = DeviceTrace([], [], (0, 1000), 1)
    assert t.busy_s == 0 and t.top_ops() == [] and t.idle_gaps() == [["(none)", pytest.approx(1e-6)]]
