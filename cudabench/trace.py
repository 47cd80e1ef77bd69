"""Read a ``torch.profiler`` capture of the measured window.

The harness marks its own host phases with ``record_function`` ranges
named ``cudabench.*`` (the window itself is ``cudabench.window``).  From
the capture this module takes the device operations (kernels, copies and
sets on the card) inside the window, their union (the device's busy time),
the time by operation name, and the longest gaps in which the card ran
nothing, each named by the harness phase and the host operation under its
midpoint.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Optional

WINDOW = "cudabench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def annotate(name: str, enabled: bool):
    """A ``record_function`` range when tracing, else nothing."""
    if not enabled:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


def profiler(enabled: bool):
    """A profile of the host and the card when tracing, else nothing."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _span(ev) -> tuple[float, float]:
    """An event's (start, end) in microseconds of the capture."""
    if hasattr(ev, "start_ns"):
        return ev.start_ns() / 1e3, ev.end_ns() / 1e3
    return ev.start_us(), ev.start_us() + ev.duration_us()


def _on_device(ev) -> bool:
    from torch.autograd import DeviceType
    if ev.device_type() != DeviceType.CUDA:
        return False
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        kind = str(kind()).lower()
        return any(k in kind for k in DEVICE_ACTIVITIES) or \
            kind.endswith(("kernel", "memcpy", "memset"))
    return not ev.name().startswith("cudabench.")


@dataclasses.dataclass
class Capture:
    window: tuple[float, float]              # (start, end) us
    ops: list[tuple[str, float, float]]      # device operations in it
    host: list[tuple[str, float, float]]     # host events in it

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def by_name(self, part: Optional[str] = None
                ) -> dict[str, tuple[int, float]]:
        """Device operations by name: (count, seconds); with ``part``, only
        names that contain it."""
        out: dict[str, tuple[int, float]] = {}
        for name, a, b in self.ops:
            if part is None or part in name:
                c, s = out.get(name, (0, 0.0))
                out[name] = (c + 1, s + (b - a) / 1e6)
        return out

    def per_launch_s(self, part: str) -> Optional[float]:
        """Mean device seconds of an operation whose name contains
        ``part``; None where none ran in the window."""
        got = self.by_name(part)
        count = sum(c for c, _ in got.values())
        return sum(s for _, s in got.values()) / count if count else None

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The longest gaps with no device operation, each named by the
        harness phase and the host operation under its midpoint."""
        busy = self.busy_intervals()
        w0, w1 = self.window
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            under = [h for h in host[:bisect.bisect_right(starts, mid)]
                     if h[2] >= mid]
            phase = [h for h in under if h[0].startswith("cudabench.")]
            op = [h for h in under if not h[0].startswith("cudabench.")]
            name = min(phase, key=lambda h: h[2] - h[1])[0] if phase \
                else "outside the harness"
            if op:
                name += " / " + min(op, key=lambda h: h[2] - h[1])[0]
            out.append([name, (b - a) / 1e6])
        return out

    def device_ops(self, top: int = 10) -> list[list]:
        rows = sorted(self.by_name().items(), key=lambda kv: -kv[1][1])
        return [[name, s] for name, (_, s) in rows[:top]]


def read(prof) -> Capture:
    """The window's device operations and host events from a finished
    profile (``profiler(True)``)."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    wins = [_span(e) for e in events
            if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if not wins:
        raise RuntimeError("the capture holds no cudabench.window range")
    w0, w1 = min(a for a, _ in wins), max(b for _, b in wins)
    ops, host = [], []
    for e in events:
        a, b = _span(e)
        if b < w0 or a > w1:
            continue
        if _on_device(e):
            ops.append((e.name(), max(a, w0), min(b, w1)))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), a, b))
    return Capture((w0, w1), ops, host)
