"""The benchmark's spans and the device trace of a `--trace 1` run.

`Tracer` wraps the measured window. With tracing off its spans cost
nothing and record nothing. With tracing on the window runs under
torch.profiler (CPU and CUDA activity), each span is a
`record_function` annotation on the profiler's own clock, and on leaving
the trace is exported once and reduced (`reduce`) to what the per-layer
metrics and the result's `breakdown` read.

The profiler at times records none of a window's first device
activities: so, before the window span opens, a few short spin kernels are
queued on every device (torch.cuda._sleep, as the port's bench does). A
trace that holds none of them is not trusted: `TraceSummary.complete` is
False and every device number reads as missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile

#: spin kernels queued on each device before the window, and their length
#: in cycles
GUARD_SPINS = 4
GUARD_CYCLES = 1000
WINDOW_SPAN = "acmbench.window"
SPAN_PREFIX = "acmbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceEvent:
    name: str
    cat: str
    device: int
    start_us: float
    dur_us: float
    nbytes: int | None


@dataclasses.dataclass
class TraceSummary:
    """The device activity of the traced window, on the profiler's clock."""

    complete: bool
    window_start_us: float
    window_us: float
    #: device activity inside the window (guard spins left out)
    events: list[DeviceEvent]
    #: benchmark spans: (name, start us, duration us)
    spans: list[tuple[str, float, float]]
    devices: list[int]

    @property
    def window_s(self) -> float:
        return self.window_us / 1e6

    def busy_s(self, device: int) -> float:
        """Seconds in which some operation ran on `device` (the union of
        its activity, clipped to the window)."""
        return sum(b - a for a, b in self.busy_intervals(device)) / 1e6

    def busy_intervals(self, device: int) -> list[tuple[float, float]]:
        lo, hi = self.window_start_us, self.window_start_us + self.window_us
        iv = sorted((max(e.start_us, lo), min(e.start_us + e.dur_us, hi))
                    for e in self.events if e.device == device)
        merged: list[list[float]] = []
        for a, b in iv:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def mean_busy_s(self) -> float:
        return sum(self.busy_s(d) for d in self.devices) / len(self.devices)

    def of(self, cat: str, name_part: str = "") -> list[DeviceEvent]:
        return [e for e in self.events if e.cat == cat and name_part in e.name]

    def device_ops(self, top: int = 10) -> list[list]:
        """[name, seconds] of the device operations that took most time."""
        tot: dict[str, float] = {}
        for e in self.events:
            tot[e.name] = tot.get(e.name, 0.0) + e.dur_us / 1e6
        return [[n, s] for n, s in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """[what the host was doing, idle seconds]: every stretch of the
        window in which no device worked, summed over the devices and
        named by the innermost benchmark span around its midpoint."""
        lo, hi = self.window_start_us, self.window_start_us + self.window_us
        tot: dict[str, float] = {}
        for d in self.devices:
            edges = [lo]
            for a, b in self.busy_intervals(d):
                edges += [a, b]
            edges.append(hi)
            for a, b in zip(edges[::2], edges[1::2]):
                if b > a:
                    name = self.span_at((a + b) / 2)
                    tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return [[n, s / len(self.devices)] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def span_at(self, t_us: float) -> str:
        best, best_start = "outside any span", None
        for name, s, d in self.spans:
            if name != WINDOW_SPAN and s <= t_us <= s + d and (
                    best_start is None or s >= best_start):
                best, best_start = name, s
        return best


def reduce(trace: dict, n_devices: int) -> TraceSummary:
    """Reduce an exported Chrome trace (torch.profiler's
    export_chrome_trace) to the window's device activity."""
    window = None
    spans: list[tuple[str, float, float]] = []
    events: list[DeviceEvent] = []
    spins = 0
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            if name == WINDOW_SPAN:
                window = (ts, dur)
            spans.append((name, ts, dur))
        elif cat in DEVICE_CATS:
            args = ev.get("args", {})
            if "spin_kernel" in name or "sleep" in name.lower():
                spins += 1
                continue
            nbytes = args.get("bytes")
            events.append(DeviceEvent(name, cat, int(args.get("device", 0)),
                                      ts, dur,
                                      None if nbytes is None else int(nbytes)))
    if window is None:
        return TraceSummary(False, 0.0, 0.0, [], spans, list(range(n_devices)))
    lo, hi = window[0], window[0] + window[1]
    inside = [e for e in events if e.start_us < hi and e.start_us + e.dur_us > lo]
    return TraceSummary(spins > 0, window[0], window[1], inside, spans,
                        list(range(n_devices)))


class Tracer:
    """Spans of the benchmark's own files; with `enabled`, the window
    under torch.profiler."""

    def __init__(self, enabled: bool, devices: list, tmpdir: str):
        self.enabled = enabled
        self.devices = devices
        self.tmpdir = tmpdir
        self.summary: TraceSummary | None = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN_PREFIX + name)

    @contextlib.contextmanager
    def window(self):
        """The measured window: under the profiler when tracing."""
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        cuda = [d for d in self.devices if d.type == "cuda"]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            for d in cuda:
                with torch.cuda.device(d):
                    for _ in range(GUARD_SPINS):
                        torch.cuda._sleep(GUARD_CYCLES)
            for d in cuda:
                torch.cuda.synchronize(d)
            with torch.profiler.record_function(WINDOW_SPAN):
                yield
        fd, path = tempfile.mkstemp(suffix=".json", dir=self.tmpdir)
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        self.summary = reduce(trace, len(self.devices))


def idle_pct(summary: TraceSummary | None) -> float | None:
    """1 less the device's busy share of the window, in %, averaged over
    the devices; None without a trusted trace or a window."""
    if summary is None or not summary.complete or summary.window_us <= 0:
        return None
    return (1 - summary.mean_busy_s() / summary.window_s) * 100
