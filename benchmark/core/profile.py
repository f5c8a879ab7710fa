"""The profiler's raw events over the traced window.

A copy of the event reader of chip_smoke.py's `phase_profile` as it stood
when the benchmark was defined: torch.profiler's raw kineto events (name,
device, start and end ns), not its FunctionEvent list, which costs ~70 us
an event. The window is the CPU span of the record_function named
`WINDOW`; device time is the union of the device spans inside it.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

WINDOW = "benchmark window"
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")
LOOKBACK = 256
#: the benchmark's own spans around the program's layers (run.SPANS)
SPAN_PREFIX = "bench: "
SHORT_NS = 50_000
SHORT = "gaps under 50 us"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device: List[Tuple[str, int, int]]  # kernels, copies and sets inside the window
    host_launch_calls: int
    idle_by_host: Dict[str, float]  # idle seconds by the innermost host op at each gap

    def kernel_s(self, *names: str) -> Tuple[float, int]:
        """Device seconds and launches of the ops whose name holds any of `names`."""
        hit = [(a, b) for n, a, b in self.device if any(k in n for k in names)]
        return sum(b - a for a, b in hit) / 1e9, len(hit)

    def top_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, int] = {}
        for n, a, b in self.device:
            tot[n] = tot.get(n, 0) + (b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], ns / 1e9] for n, ns in top]

    def top_gaps(self, k: int = 10) -> List[List]:
        top = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], s] for n, s in top]


def read(prof) -> Trace:
    from torch.autograd import DeviceType

    ev = [(e.name(), e.device_type(), e.start_ns(), e.end_ns())
          for e in prof.profiler.kineto_results.events() if not e.is_hidden_event()]
    spans = [(a, b) for n, d, a, b in ev if n == WINDOW and d == DeviceType.CPU]
    if not spans:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = spans[0]
    # the benchmark's own ranges leave a device-side annotation spanning
    # their whole length: not device work
    dev = sorted(((n, max(a, w0), min(b, w1)) for n, d, a, b in ev
                  if d == DeviceType.CUDA and n != WINDOW and not n.startswith(SPAN_PREFIX)
                  and not n.startswith("Activity Buffer") and "spin_kernel" not in n
                  and b > w0 and a < w1), key=lambda e: e[1])
    busy, end = 0, w0
    gaps = []
    for _, a, b in dev:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    # the host events that name a gap: the runtime's calls and the
    # benchmark's layer spans (not every aten op: there are millions)
    host = [(n, a, b) for n, d, a, b in ev if d == DeviceType.CPU and n != WINDOW
            and n.startswith(("cu", SPAN_PREFIX)) and b > w0 and a < w1]
    launches = sum(1 for n, a, _ in host if n.startswith(LAUNCH_CALLS) and w0 <= a <= w1)
    # each gap is named by the shortest runtime call covering its middle
    # among the last LOOKBACK begun before it, else by the shortest layer
    # span covering it; gaps under SHORT_NS are summed as one
    idle: Dict[str, float] = {}
    host.sort(key=lambda e: e[1])
    begins = [a for _, a, _ in host]
    layers = [(n, a, b) for n, a, b in host if n.startswith(SPAN_PREFIX)]
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_NS:
            idle[SHORT] = idle.get(SHORT, 0.0) + (g1 - g0) / 1e9
            continue
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(begins, mid)
        cover = [(b - a, n) for n, a, b in host[max(0, i - LOOKBACK):i] if b >= mid]
        if not cover:
            cover = [(b - a, n) for n, a, b in layers if a <= mid <= b]
        name = min(cover)[1] if cover else "no host op recorded"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e9
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, device=dev,
                 host_launch_calls=launches, idle_by_host=idle)
