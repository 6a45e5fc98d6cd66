"""What every cell's run shares: the spans and counters the benchmark
records around its calls into the program, the profiler of a traced run,
and the reading of its trace.

Spans are taken from the benchmark's own files, around calls into a
layer of the program; nothing is recorded inside the program.  In a
traced run the profiler covers the first ``profile_s`` seconds of the
window (the traffic file's), each span is also a ``record_function``
range there, and the readers under ``metrics/`` take what they need from
``Trace``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import tempfile
import time
from dataclasses import dataclass, field


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


@dataclass
class Span:
    name: str
    t0: float           # host clock (perf_counter), seconds
    t1: float
    meta: dict = field(default_factory=dict)
    profiled: bool = False


class Recorder:
    """Spans and counters of one run, in memory; the profiler of a traced
    run over its first part of the window."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.spans: list[Span] = []
        self.counters: dict = {}
        self.prof = None
        self.profiling = False
        self.profile_start = None

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        rf = None
        if self.profiling:
            import torch
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        s = Span(name, t0, t0, dict(meta), self.profiling)
        try:
            yield s
        finally:
            s.t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.spans.append(s)

    def start_profile(self):
        if not self.trace:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.profiling = True
        torch.cuda.synchronize()
        self.profile_start = time.perf_counter()

    def stop_profile(self):
        if not self.profiling:
            return
        import torch
        torch.cuda.synchronize()
        self.profiling = False
        self.prof.stop()

    def read_trace(self) -> "Trace | None":
        """The profiled part as plain lists (after the window)."""
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return Trace.from_events(events)


@dataclass
class Trace:
    """The profiled part of a window: device operations (name, start,
    end), launches (host time), the benchmark's spans as annotations
    (name, start, end) and the profiled window, all in microseconds of
    the trace's clock."""

    device_ops: list
    launches: list
    annotations: list
    window_us: tuple

    @staticmethod
    def from_events(events):
        ops, launches, notes = [], [], []
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X":
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                ops.append((e["name"], ts, ts + dur))
            elif cat == "cuda_runtime" and e["name"] in LAUNCH_NAMES:
                launches.append(ts)
            elif cat == "user_annotation":
                notes.append((e["name"], ts, ts + dur))
        ops.sort(key=lambda o: o[1])
        launches.sort()
        # the profiled window on the trace's clock: from the first to the
        # last event the profiler recorded
        starts = [o[1] for o in ops] + launches + [n[1] for n in notes]
        ends = [o[2] for o in ops] + launches + [n[2] for n in notes]
        window = (min(starts), max(ends)) if starts else (0.0, 0.0)
        ops = [o for o in ops if o[2] > window[0] and o[1] < window[1]]
        ops = [(nm, max(a, window[0]), min(b, window[1]))
               for nm, a, b in ops]
        return Trace(ops, launches, notes, window)

    def busy_intervals(self):
        """The union of the device operations' intervals, in order."""
        out = []
        for _, a, b in self.device_ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_us(self):
        return sum(b - a for a, b in self.busy_intervals())

    def span_us(self):
        return self.window_us[1] - self.window_us[0]

    def idle_gaps(self, n=10):
        """The longest idle gaps of the device, each labelled by the
        benchmark span open on the host for most of it."""
        busy = self.busy_intervals()
        gaps = []
        edges = [self.window_us[0]] + [x for ab in busy for x in ab] + \
            [self.window_us[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            best, label = 0.0, "outside the benchmark's spans"
            for name, s, e in self.annotations:
                ov = min(b, e) - max(a, s)
                if ov > best:
                    best, label = ov, name
            out.append([label, (b - a) * 1e-6])
        return out

    def top_ops(self, n=10):
        tot: dict = {}
        for name, a, b in self.device_ops:
            tot[name] = tot.get(name, 0.0) + (b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], us * 1e-6] for name, us in top]

    def launches_in(self, name):
        """(launches inside the annotations called `name`, how many such
        annotations)."""
        import bisect
        spans = [(s, e) for nm, s, e in self.annotations if nm == name]
        n = 0
        for s, e in spans:
            n += bisect.bisect_right(self.launches, e) - \
                bisect.bisect_left(self.launches, s)
        return n, len(spans)


@dataclass
class Context:
    """What a metric reader is given after a traced run."""

    cell: str
    spans: list
    counters: dict
    trace: Trace | None
    result: dict

    def window_spans(self, name):
        """The spans called `name` outside the profiled part."""
        return [s for s in self.spans if s.name == name and not s.profiled]


def record(numbers, info, what, pick, gaps, errs):
    """The widest gap, angle and length of one kind of judged pair as
    numbers; each pair's, and its error against the truth, into info."""
    for key, unit in (("rms_m", "gap_max_m"), ("rot_deg", "rot_max_deg"),
                      ("trans_m", "trans_max_m")):
        numbers[f"{what}_{unit}"] = max(g[key] for g in gaps) if gaps \
            else float("inf")
    if info is not None:
        for key in ("rms_m", "rot_deg", "trans_m", "overlap"):
            info[f"{what}_{key}"] = [round(g[key], 6) for g in gaps]
    if info is not None:
        info[f"{what}_judged"] = pick
        info[f"{what}_error_vs_truth_m"] = [round(e, 6) for e in errs]


def mean_ms(spans):
    """The spans' total length over their count, in ms."""
    if not spans:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(spans)


def p95_ms(spans):
    """The 95th percentile (nearest rank) of the spans' lengths."""
    if len(spans) < 20:
        return None
    d = sorted(s.t1 - s.t0 for s in spans)
    return 1e3 * d[math.ceil(0.95 * len(d)) - 1]
