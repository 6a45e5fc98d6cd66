"""What ``program_trace.py`` reads from the program's spans: on hand-made
records and profiler events, and in one short run of the mapping cell on
the CPU."""

import time

import pytest
import torch
from conftest import MAPPING, bench

from mvil_fusion_torch.utils.timing import TRACER, Record
from slambench import program_trace as P
from slambench import run as R
from slambench.harness import Span, Trace


def _events():
    """One sweep of the program inside the benchmark's span, in µs:
    compensate [0, 10), deskew [10, 15), process_full [20, 100) holding
    features [20, 40) and readback [60, 90); kernels and launches."""
    note = lambda name, ts, dur: dict(  # noqa: E731
        ph="X", cat="user_annotation", name=name, ts=ts, dur=dur)
    ev = [note("local_map.sweep", 0, 120),
          note("local_map.compensate", 0, 10),
          note("local_map.deskew", 10, 5),
          note("local_map.process_full", 20, 80),
          note("local_map.features", 20, 20),
          note("local_map.readback", 60, 30)]
    ev += [dict(ph="X", cat="kernel", name="k", ts=ts, dur=dur)
           for ts, dur in ((5, 3), (30, 5), (50, 20))]
    ev += [dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=t,
                dur=1) for t in (2, 12, 25, 45, 110)]
    return ev


NAMES = {"local_map.compensate", "local_map.deskew",
         "local_map.process_full", "local_map.features",
         "local_map.readback"}


def test_idle_goes_to_the_innermost_program_span():
    tr = Trace.from_events(_events())
    assert tr.window_us == (0.0, 120.0)
    top, share = P.idle_by_span(tr, NAMES)
    got = {name: round(s * 1e6, 6) for name, s in top}
    # busy [5,8] [30,35] [50,70]: idle 92 µs of 120
    assert got == {"local_map.compensate": 7.0, "local_map.deskew": 5.0,
                   "local_map.features": 15.0,
                   # [40,50) and [90,100) outside features and readback
                   "local_map.process_full": 20.0,
                   # the gap [70,90) lies inside readback, inside
                   # process_full: it goes to the inner one
                   "local_map.readback": 20.0,
                   P.OUTSIDE: 25.0}
    assert share == pytest.approx(1 - 25 / 92)
    # names outside the program's are not program spans
    top, share = P.idle_by_span(tr, {"local_map.process_full"})
    assert dict(top)["local_map.process_full"] == pytest.approx(55e-6)
    assert share == pytest.approx(55 / 92)


def test_launches_per_sweep_over_the_program_roots():
    tr = Trace.from_events(_events())
    # launches at 2 and 12 in compensate and deskew, 25 and 45 in
    # process_full; 110 in the benchmark's span alone
    assert P.launches_per_sweep(tr) == 4.0
    assert P.launches_per_sweep(None) is None


def _rec(name, t0_ms, t1_ms, parent=None, rid=None):
    return Record(name, int(t0_ms * 1e6), int(t1_ms * 1e6), parent, rid, 1)


def test_readings_of_hand_made_records():
    records = [
        _rec("local_map.process_full", 0, 10, rid=0.1),
        _rec("local_map.scan_to_map", 1, 5, 0),
        _rec("local_map.readback", 6, 8, 0),
        _rec("local_map.process_full", 100, 140, rid=0.2),  # profiled
        _rec("local_map.scan_to_map", 101, 131, 3),
        _rec("local_map.readback", 132, 140, 3),
        _rec("local_map.process_full", 200, 220, rid=0.3),
        _rec("local_map.scan_to_map", 201, 209, 6),
        _rec("local_map.readback", 210, 214, 6),
        _rec("global_map.submap", 220, 320, rid=0.3),
        _rec("global_map.register", 230, 280, 9),
        _rec("global_map.submap", 400, 450, rid=0.5),
    ]
    spans = [Span("local_map.sweep", 0.0, 0.0125),
             Span("local_map.sweep", 0.1, 0.15, profiled=True),
             Span("local_map.sweep", 0.2, 0.22),
             Span("global_map.add_submap", 0.22, 0.325),
             Span("global_map.add_submap", 0.4, 0.45)]
    got = P.readings(records, spans, None, (int(90e6), int(150e6)),
                     [40, 47])
    assert got["local_map.scan_to_map_ms"] == pytest.approx(6.0)
    assert got["local_map.readback_wait_ms"] == pytest.approx(3.0)
    assert got["global_map.register_ms"] == pytest.approx(50.0)
    # no solve in the window: nothing to read
    assert "global_map.solve_ms" not in got
    assert got["global_map.readbacks_per_submap"] == pytest.approx(3.5)
    # sweeps 10/12.5 and 20/20; submaps 100/105 and 50/50
    assert got["sweep_root_share"] == pytest.approx((0.8 + 1.0) / 2)
    assert got["submap_root_share"] == pytest.approx((100 / 105 + 1) / 2)
    assert "idle_by_span" not in got and "local_map.launches_per_sweep" \
        not in got


def _tiny(conf, traffic, limits):
    traffic["warm"] = {"min_sweeps": 4, "max_sweeps": 4}
    traffic["judge"].update(pairs=2, loop_pairs=0)


def test_a_short_cpu_run_records_the_mapping_spans():
    torch.set_num_threads(4)
    with P.program_traced(True) as runs:
        line, out = R.run_cell(bench(), MAPPING, 20261023, 0.1, 0,
                               torch.device("cpu"), time.perf_counter(),
                               _tiny)
    assert not TRACER.on
    records = TRACER.drain()
    names = {r.name for r in records}
    assert {"local_map.compensate", "local_map.deskew",
            "local_map.process_full", "local_map.scan_to_map",
            "local_map.readback"} <= names
    # nothing of set-up: the window's sweeps only
    sweeps = [r for r in records if r.name == "local_map.process_full"]
    assert len(sweeps) == out["attempted"]
    got = P.run_readings(runs[-1], records)
    assert got["local_map.scan_to_map_ms"] > 0
    assert got["local_map.readback_wait_ms"] >= 0
    assert 0.5 < got["sweep_root_share"] <= 1.0
    assert line["metrics"]["sensor_s_per_s"]["value"] > 0
