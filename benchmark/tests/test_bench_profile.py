"""The trace reader: busy time is the union of device work inside the
window, the ranges' own device annotations are no work, and each idle gap
is named by what the host was doing."""

import pytest
from torch.autograd import DeviceType

from benchmark.core import profile


class _Ev:
    def __init__(self, name, dev, a, b):
        self._v = (name, dev, a, b)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_hidden_event(self):
        return False


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events": lambda _self: events})()


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def test_busy_idle_and_gap_names():
    us = 1000  # the profiler's clock is in ns
    ev = [_Ev(profile.WINDOW, CPU, 1000 * us, 2000 * us), _Ev(profile.WINDOW, GPU, 1000 * us, 2000 * us),
          _Ev("bench: tracing", GPU, 1000 * us, 2000 * us),
          _Ev("k1", GPU, 500 * us, 1050 * us), _Ev("k2", GPU, 1100 * us, 1200 * us),
          _Ev("k2", GPU, 1150 * us, 1300 * us), _Ev("k4", GPU, 1310 * us, 1320 * us),
          _Ev("k3", GPU, 1800 * us, 2000 * us),
          _Ev("cudaLaunchKernel", CPU, 1090 * us, 1095 * us),
          _Ev("cudaGraphLaunch", CPU, 1140 * us, 1145 * us),
          _Ev("bench: graph", CPU, 1400 * us, 1900 * us), _Ev("aten::copy_", CPU, 1550 * us, 1570 * us),
          _Ev("cudaStreamSynchronize", CPU, 1500 * us, 1550 * us)]
    tr = profile.read(_Prof(ev))
    assert tr.window_s == pytest.approx(1e-3)
    # k1 clipped to 1000..1050, k2 1100..1300, k4, k3; the annotations are no work
    assert tr.busy_s == pytest.approx(460e-6)
    assert tr.host_launch_calls == 2
    assert tr.kernel_s("k2") == (pytest.approx(250e-6), 2)
    # 1050..1100: no runtime call or span covers its middle; 1300..1310:
    # short; 1320..1800: its middle, 1560, lies in the graph span (the
    # sync ended at 1550; aten ops name no gap)
    assert tr.idle_by_host["no host op recorded"] == pytest.approx(50e-6)
    assert tr.idle_by_host[profile.SHORT] == pytest.approx(10e-6)
    assert tr.idle_by_host["bench: graph"] == pytest.approx(480e-6)
    assert [n for n, _ in tr.top_ops()] == ["k2", "k3", "k1", "k4"]
