"""Spans the harness records around its calls into the program, and the
reduction of a ``torch.profiler`` trace of the window to device time.

Spans are kept in memory: ``(name, start, end)`` on the host clock. In a
traced run each span is also a ``record_function`` range, so the
profiler's timeline holds what the host was doing beside what the device
ran.
"""
from __future__ import annotations

import bisect
import contextlib
import os
import time
from collections import defaultdict

import torch

#: the profiled window's own range
WINDOW = "bench.window"
#: seconds the card is left idle after the profiler starts and before the
#: window: a session's first milliseconds may lose their device records
SETTLE_S = 0.05


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced
        self.items: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = (torch.profiler.record_function(name) if self.traced
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        self.items.append((name, t0, time.perf_counter()))

    def durations(self, name: str) -> list[float]:
        return [b - a for n, a, b in self.items if n == name]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profiled(traced: bool):
    """A profiler session over the block (None where not traced). CUPTI
    stays set up between sessions, and the session settles before the
    block's work."""
    if not traced:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        yield prof


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class DeviceTrace:
    """The device's side of a traced window: its kernels, copies and sets
    clipped to the window, by name, and the host spans around them.
    Times in seconds."""

    def __init__(self, prof):
        evs = prof.events()
        host = [e for e in evs if e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("bench.")]
        win = [e for e in host if e.name == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no window range")
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        self.window_s = (w1 - w0) * 1e-6
        self.by_name: dict[str, float] = defaultdict(float)
        ivs = []
        for e in evs:
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.name.startswith("bench.")):
                continue
            a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if b <= a:
                continue
            ivs.append((a, b))
            self.by_name[e.name] += (b - a) * 1e-6
        if not ivs:
            raise RuntimeError("the profiler recorded no device event in "
                               "the window")
        busy = _union(ivs)
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        self._gaps = self._label_gaps(busy, w0, w1, [
            (e.name, e.time_range.start, e.time_range.end)
            for e in host if e.name != WINDOW])

    @staticmethod
    def _label_gaps(busy, w0, w1, spans):
        """Idle seconds by the innermost host span around each gap's
        middle ('other' where none is)."""
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        out: dict[str, float] = defaultdict(float)
        spans = sorted(spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            at = bisect.bisect_right(starts, mid)
            inner = [s for s in spans[max(0, at - 8):at] if mid <= s[2]]
            name = (min(inner, key=lambda s: s[2] - s[1])[0] if inner
                    else "other")
            out[name] += (b - a) * 1e-6
        return out

    def seconds(self, patterns) -> float:
        """Device seconds of the kernels whose name holds a pattern."""
        return sum(t for n, t in self.by_name.items()
                   if any(p in n for p in patterns))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self._gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in gaps]}
