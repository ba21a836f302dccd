"""The device trace of a traced section: ``torch.profiler``'s events, kept in
memory (no trace file is written) and reduced to what the per-layer readers
take.

The section is the span of a host annotation, ``ANNOTATION``, that begins
after the device has drained and ends after it has drained again.  Device
operations are its kernels, copies and sets (CUPTI reports the kernels of a
replayed CUDA graph one by one); the GPU-side images of host annotations are
left out.  Busy time is the union of their intervals, idle time the rest of
the section.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses

import torch

ANNOTATION = "portbench.traced"
SPAN_PREFIX = "portbench."
# a gap is labelled by the innermost host event over its middle found within this many events back
_LOOKBACK = 4096
_NAME_CHARS = 160


@dataclasses.dataclass
class DeviceTrace:
    """Device operations ``(start_ns, end_ns, name)`` and host events
    ``(start_ns, end_ns, name)`` of one traced section, its span, and the
    units of work it held (steps, searches, genmoves)."""

    ops: list
    host: list
    window: tuple
    units: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list:
        """The union of the operations' intervals, clipped to the window."""
        lo, hi = self.window
        merged = []
        for start, end, _ in sorted(self.ops):
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(end - start for start, end in self.busy_intervals()) / 1e9

    def op_seconds(self, contains: str = "") -> float:
        """Summed duration of the operations whose name holds ``contains``."""
        return sum(end - start for start, end, name in self.ops if contains in name) / 1e9

    def op_count(self, contains: str = "") -> int:
        return sum(1 for _, _, name in self.ops if contains in name)

    def durations(self, contains: str) -> list:
        return [(end - start) / 1e9 for start, end, name in self.ops if contains in name]

    def top_ops(self, k: int = 10) -> list:
        """``[[name, seconds], ...]``: the ``k`` operations by summed time."""
        total = collections.Counter()
        for start, end, name in self.ops:
            total[name[:_NAME_CHARS]] += (end - start) / 1e9
        return [[name, s] for name, s in total.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """``[[label, seconds], ...]``: idle time summed by what the host was
        doing over each gap's middle (its innermost event, and the innermost
        of the benchmark's own spans around it), the ``k`` largest."""
        host = sorted(self.host, key=lambda h: (h[0], -h[1]))  # an outer event before the inner ones it starts with
        starts = [h[0] for h in host]
        total = collections.Counter()
        edge = self.window[0]
        for start, end in self.busy_intervals() + [[self.window[1], self.window[1]]]:
            if start > edge:
                total[self._label(host, starts, (edge + start) // 2)] += (start - edge) / 1e9
            edge = max(edge, end)
        return [[name, s] for name, s in total.most_common(k)]

    @staticmethod
    def _label(host, starts, t) -> str:
        inner = span = None
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - _LOOKBACK), -1):
            start, end, name = host[j]
            if end < t:
                continue
            if inner is None:
                inner = name
            if name.startswith(SPAN_PREFIX):
                span = name
                break
        if inner is None:
            return "(none)"
        return inner[:_NAME_CHARS] if span in (None, inner) else f"{inner[:_NAME_CHARS]} in {span}"


def _reduce(events, units: int) -> DeviceTrace:
    from torch.autograd import DeviceType

    ops, host, window = [], [], None
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # the device-side image of a host span is no operation
            if not (e.is_user_annotation() or name.startswith(SPAN_PREFIX)):
                ops.append((start, end, name))
        elif name == ANNOTATION:
            window = (start, end)
        else:
            host.append((start, end, name))
    if window is None:
        raise RuntimeError(f"the profiler recorded no {ANNOTATION!r} span")
    return DeviceTrace(ops, host, window, units)


@contextlib.contextmanager
def traced(device: torch.device):
    """Profile the block; on leaving it, ``holder["trace"]`` is its
    ``DeviceTrace``.  The block sets ``holder["units"]``, the units of work
    it ran."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    holder = {"units": 0}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(ANNOTATION):
            yield holder
            if cuda:
                torch.cuda.synchronize(device)
    holder["trace"] = _reduce(prof.profiler.kineto_results.events(), holder["units"])


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own, ``portbench.<name>``, around a
    call into one layer of the program; outside a trace it costs a check of
    whether the profiler runs."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield
