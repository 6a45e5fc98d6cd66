"""The VIL cell's readers on hand-made program records, counters and
profiler events; each reads nothing where the program has no such span
or counter (a program before the estimator's spans)."""

import importlib.util
from pathlib import Path

import pytest

from slambench.harness import Context, Trace
from mvil_fusion_torch.utils.timing import Record

METRICS = Path(__file__).resolve().parents[1] / "metrics"
MS = 1_000_000


def read(name, ctx):
    spec = importlib.util.spec_from_file_location(f"m_{name}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _records():
    """Three keyframe solves (one in the profiled part, 20-30 ms) and two
    sweeps, ns on the host clock."""
    return [Record("vio.frame", 0, 1000 * MS, None, 0.1, 1),
            Record("vio.step", 10 * MS, 900 * MS, 0, 0.1, 1),
            Record("vio.frame", 2000 * MS, 2500 * MS, None, 0.2, 1),
            Record("vio.frame", 3000 * MS, 4500 * MS, None, 0.3, 1),
            Record("lidar_odom.sweep", 100 * MS, 112 * MS, None, 0.15, 1),
            Record("lidar_odom.sweep", 3100 * MS, 3120 * MS, None, 0.25, 1)]


def _ctx(counters, events=None):
    tr = Trace.from_events(events) if events is not None else None
    return Context("vil_odom.feature_replay", [], counters, tr, {})


def test_span_means_leave_out_the_profiled_part():
    c = _ctx({"program_records": _records(),
              "profiled_ns": (1500 * MS, 2800 * MS)})
    assert read("vio.frame_ms", c) == pytest.approx((1000 + 1500) / 2)
    assert read("lidar_odom.sweep_ms", c) == pytest.approx(16.0)


def test_lm_iterations_per_solve_from_the_counters():
    assert read("vio.lm_iters_per_frame",
                _ctx({"vio_lm_iters": 96, "vio_solves": 12})) == 8.0


def test_launches_per_frame_from_the_annotations():
    ev = [dict(ph="X", cat="user_annotation", name="vio.frame", ts=0,
               dur=100),
          dict(ph="X", cat="user_annotation", name="vio.frame", ts=200,
               dur=100),
          dict(ph="X", cat="kernel", name="k", ts=10, dur=5)]
    ev += [dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=t,
                dur=1) for t in (5, 50, 150, 210, 250, 260)]
    assert read("vio.launches_per_frame", _ctx({}, ev)) == 2.5


@pytest.mark.parametrize("name", ["vio.frame_ms", "lidar_odom.sweep_ms",
                                  "vio.lm_iters_per_frame",
                                  "vio.launches_per_frame"])
def test_nothing_to_read_reads_nothing(name):
    # what a program without the spans and counters hands over: no
    # records, counters of None, and a trace without the annotations
    c = _ctx({"program_records": [], "profiled_ns": (0, 1),
              "vio_lm_iters": None, "vio_solves": None},
             [dict(ph="X", cat="kernel", name="k", ts=0, dur=5)])
    assert read(name, c) is None
    assert read(name, _ctx({})) is None
