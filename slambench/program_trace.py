"""The program's own spans in a traced run of a cell.

    python3 slambench/program_trace.py --workload <cell> --seed <n> \
        --seconds <s> --tracer <0|1>

Runs ``run.py --trace 1`` with the same arguments: one traced run, with the
program's tracer (``mvil_fusion_torch.utils.timing.TRACER``) on over the
window (``--tracer 1``) or left off (``--tracer 0``, the run the tracer's
overhead is read against).  The tracer is turned on where the feed starts
the window's profiler, after set-up, and drained after the run; the
global mapper's ``readbacks`` counter is read at the same two points.
After run.py's result line, one more line of standard output holds
``program``: what the program's spans and counter read.

- ``local_map.scan_to_map_ms``, ``local_map.readback_wait_ms``,
  ``global_map.register_ms``, ``global_map.solve_ms``: those spans
  outside the profiled part, total over count (host clock);
- ``local_map.launches_per_sweep``: kernel launches inside the
  ``local_map.compensate``, ``local_map.deskew`` and
  ``local_map.process_full`` annotations of the trace, over the number of
  ``local_map.process_full`` annotations;
- ``global_map.readbacks_per_submap``: the window's increase in
  ``GlobalMapper.readbacks`` over its ``global_map.submap`` spans;
- ``idle_by_span``: the profiled part's device idle time by the innermost
  program span open on the host (``idle_by_span``), the 10 largest, s;
  ``idle_in_program_share``: the share of that idle time under some
  program span;
- ``sweep_root_share``, ``submap_root_share``: the median over the
  window's ``local_map.sweep`` (``global_map.add_submap``) spans outside
  the profiled part of the summed lengths of the program's root spans
  inside it over its length.

This is not the benchmark's command and no cell runs it: it reads what
the benchmark's runs do not read yet, and it does so from outside the
benchmark's files (it wraps the harness's recorder and the global
mapper's constructor for the run), which stay as they are.  A record
counts as profiled when it started inside the profiled part, as the
benchmark's spans do.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from slambench import harness, run                      # noqa: E402

OUTSIDE = "outside the program's spans"
SWEEP_ROOTS = ("local_map.compensate", "local_map.deskew",
               "local_map.process_full")


def window_records(records, name, profiled_ns):
    """The records called `name` that started outside the profiled part
    ``(start, end)`` (ns on the records' clock)."""
    a, b = profiled_ns
    return [r for r in records if r.name == name and not a <= r.t0_ns < b]


def mean_ms(records):
    """The records' total length over their count, in ms."""
    if not records:
        return None
    return sum(r.t1_ns - r.t0_ns for r in records) / len(records) / 1e6


def launches_per_sweep(trace):
    """Kernel launches inside the sweep's program annotations, over the
    number of ``local_map.process_full`` annotations."""
    if trace is None:
        return None
    counts = [trace.launches_in(name) for name in SWEEP_ROOTS]
    sweeps = counts[-1][1]
    return sum(n for n, _ in counts) / sweeps if sweeps else None


def _depths(notes):
    """Each annotation's nesting depth among `notes` (name, start, end),
    by start; an annotation inside another is one deeper."""
    order = sorted(range(len(notes)),
                   key=lambda k: (notes[k][1], -notes[k][2]))
    depth, open_ = [0] * len(notes), []
    for k in order:
        _, s, e = notes[k]
        while open_ and notes[open_[-1]][2] <= s:
            open_.pop()
        depth[k] = len(open_)
        if e > s:
            open_.append(k)
    return depth


def idle_by_span(trace, names, n=10):
    """The profiled part's device idle time summed by the innermost
    annotation among `names` open on the host (the deeper of two that
    overlap; time under none goes to OUTSIDE): ([name, s] of the `n`
    largest, the share of idle time under some program span)."""
    notes = [a for a in trace.annotations if a[0] in names]
    depth = _depths(notes)
    w0, w1 = trace.window_us
    busy = trace.busy_intervals()
    starts = [a for a, _ in busy]
    before = [0.0]
    for a, b in busy:
        before.append(before[-1] + (b - a))

    def busy_until(x):
        k = bisect.bisect_right(starts, x)
        out = before[k]
        if k and busy[k - 1][1] > x:
            out -= busy[k - 1][1] - x
        return out

    def idle(a, b):
        return (b - a) - (busy_until(b) - busy_until(a))

    cuts = sorted({w0, w1} | {t for _, s, e in notes for t in (s, e)
                              if w0 < t < w1})
    events = sorted(range(len(notes)), key=lambda k: notes[k][1])
    total: dict = {}
    live, j = [], 0
    for a, b in zip(cuts, cuts[1:]):
        while j < len(events) and notes[events[j]][1] <= a:
            live.append(events[j])
            j += 1
        live = [k for k in live if notes[k][2] > a]
        label = notes[max(live, key=lambda k: (depth[k], notes[k][1]))][0] \
            if live else OUTSIDE
        total[label] = total.get(label, 0.0) + idle(a, b)
    idle_all = sum(total.values())
    share = 1.0 - total.get(OUTSIDE, 0.0) / idle_all if idle_all else None
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, us * 1e-6] for name, us in top], share


def root_share(records, spans, outer, roots):
    """The median over the benchmark's `outer` spans outside the profiled
    part of the summed lengths of the program's root records named in
    `roots` that start inside each, over its length."""
    recs = sorted((r.t0_ns, r.t1_ns) for r in records
                  if r.parent is None and r.name in roots)
    if not recs:
        return None
    t0s = [a for a, _ in recs]
    ratios = []
    for s in spans:
        if s.name != outer or s.profiled or s.t1 <= s.t0:
            continue
        a, b = int(s.t0 * 1e9), int(s.t1 * 1e9)
        inside = recs[bisect.bisect_left(t0s, a):bisect.bisect_left(t0s, b)]
        ratios.append(sum(e - s_ for s_, e in inside) / (b - a))
    return statistics.median(ratios) if ratios else None


def readings(records, spans, trace, profiled_ns, readbacks):
    """What the program's spans and counter read in one run (see the
    module docstring); an entry that has nothing to read is left out."""
    out = {
        "local_map.scan_to_map_ms": mean_ms(window_records(
            records, "local_map.scan_to_map", profiled_ns)),
        "local_map.readback_wait_ms": mean_ms(window_records(
            records, "local_map.readback", profiled_ns)),
        "local_map.launches_per_sweep": launches_per_sweep(trace),
        "global_map.register_ms": mean_ms(window_records(
            records, "global_map.register", profiled_ns)),
        "global_map.solve_ms": mean_ms(window_records(
            records, "global_map.solve", profiled_ns)),
        "sweep_root_share": root_share(records, spans, "local_map.sweep",
                                       SWEEP_ROOTS),
        "submap_root_share": root_share(
            records, spans, "global_map.add_submap", ("global_map.submap",)),
    }
    submaps = sum(1 for r in records if r.name == "global_map.submap")
    if submaps and readbacks is not None:
        out["global_map.readbacks_per_submap"] = \
            (readbacks[1] - readbacks[0]) / submaps
    if trace is not None and records:
        out["idle_by_span"], out["idle_in_program_share"] = idle_by_span(
            trace, {r.name for r in records})
    return {k: v for k, v in out.items() if v is not None}


@contextlib.contextmanager
def program_traced(tracer_on):
    """Within: each run of ``run.run_cell`` records the program's spans
    over its window (with `tracer_on`) and notes the profiled part and the
    global mapper's readbacks at the window's start and end.  Yields the
    list of those runs' recorders."""
    from mvil_fusion_torch.mapping import global_mapping
    from mvil_fusion_torch.utils.timing import TRACER
    runs, mappers = [], []
    base = harness.Recorder

    class Recorder(base):
        def __init__(self, trace):
            super().__init__(trace)
            self.profiled_ns = [0, 0]
            self.readbacks = None
            self.trace_read = None
            runs.append(self)

        def start_profile(self):
            # the feed starts the window here, after set-up
            super().start_profile()
            self.profiled_ns = [time.perf_counter_ns()] * 2
            self.readbacks = [mappers[-1].readbacks] * 2
            if tracer_on:
                TRACER.enable()

        def stop_profile(self):
            # called once the profiled part is over and again (the last
            # call) as the window ends
            if self.profiling:
                self.profiled_ns[1] = time.perf_counter_ns()
            self.readbacks[1] = mappers[-1].readbacks
            super().stop_profile()

        def read_trace(self):
            self.trace_read = super().read_trace()
            return self.trace_read

    init = global_mapping.GlobalMapper.__init__

    def registered(mapper, *a, **k):
        init(mapper, *a, **k)
        mappers.append(mapper)
    harness.Recorder = Recorder
    global_mapping.GlobalMapper.__init__ = registered
    try:
        yield runs
    finally:
        harness.Recorder = base
        global_mapping.GlobalMapper.__init__ = init
        TRACER.disable()


def run_readings(rec, records):
    """`readings` of the run that recorder `rec` (of `program_traced`)
    recorded, with the program's `records` of its window."""
    return readings(records, rec.spans, rec.trace_read, rec.profiled_ns,
                    rec.readbacks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args, rest = ap.parse_known_args(argv)
    from mvil_fusion_torch.utils.timing import TRACER
    with program_traced(bool(args.tracer)) as runs:
        rc = run.main(rest + ["--trace", "1"])
    records = TRACER.drain()
    if rc == 0:
        print(json.dumps({"tracer": args.tracer,
                          "program_spans": len(records),
                          "program": run_readings(runs[-1], records)}),
              flush=True)
    return rc


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
