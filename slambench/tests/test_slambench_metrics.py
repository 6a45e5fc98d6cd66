"""The metric readers on hand-made spans and profiler events."""

import importlib.util
from pathlib import Path

import pytest

from slambench.harness import Context, Span, Trace
from slambench.peaks import knn_bound_s

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def read(name, ctx):
    spec = importlib.util.spec_from_file_location(f"m_{name}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _events():
    """Two spans of `global_map.add_submap` and one of `local_map.sweep`, kernels
    (two of them the k-NN kernel), launches, in microseconds."""
    ev = [
        dict(ph="X", cat="user_annotation", name="global_map.add_submap", ts=0, dur=100),
        dict(ph="X", cat="user_annotation", name="global_map.add_submap",
             ts=200, dur=100),
        dict(ph="X", cat="user_annotation", name="local_map.sweep", ts=300,
             dur=100),
        dict(ph="X", cat="kernel", name="k1", ts=10, dur=20),
        dict(ph="X", cat="kernel", name="k2", ts=20, dur=20),   # overlaps
        dict(ph="X", cat="kernel", name="knn_topk_scan_kernel", ts=250,
             dur=10),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=350, dur=50),
        dict(ph="X", cat="kernel", name="knn_topk_merge_kernel", ts=380,
             dur=10),
    ]
    ev += [dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=t,
                dur=1) for t in (5, 15, 205, 210, 215)]
    ev.append(dict(ph="X", cat="cuda_runtime", name="cudaMemcpyAsync",
                   ts=220, dur=1))
    return ev


def _ctx(spans=(), counters=None, trace=True, result=None):
    tr = Trace.from_events(_events()) if trace else None
    return Context("cell", list(spans), counters or {}, tr, result or {})


def test_trace_busy_idle_and_gaps():
    tr = Trace.from_events(_events())
    assert tr.window_us == (0.0, 400.0)
    # union: [10,40] + [250,260] + [350,400] = 30 + 10 + 50
    assert tr.busy_us() == 90.0
    assert read("device_idle_share", _ctx()) == pytest.approx(1 - 90 / 400)
    gaps = tr.idle_gaps(2)
    assert gaps[0] == ["global_map.add_submap", pytest.approx(210e-6)]
    assert gaps[1][1] == pytest.approx(90e-6)
    assert tr.top_ops(1) == [["Memcpy DtoH", pytest.approx(50e-6)]]


def test_span_means_leave_out_the_profiled_part():
    spans = [Span("local_map.sweep", 0.0, 0.040),
             Span("local_map.sweep", 1.0, 1.060),
             Span("local_map.sweep", 2.0, 2.500, profiled=True),
             Span("global_map.add_submap", 3.0, 4.0),
             Span("global_map.add_submap", 5.0, 5.5, profiled=True)]
    c = _ctx(spans)
    assert read("local_map.sweep_ms", c) == pytest.approx(50.0)
    assert read("global_map.add_submap_ms", c) == pytest.approx(1000.0)
    assert read("global_map.add_submap_ms", _ctx(spans[:3])) is None


def test_p95_over_all_sweeps():
    spans = [Span("local_map.sweep", 0.0, 0.001 * (k + 1))
             for k in range(100)]
    c = _ctx(spans)
    assert read("local_map.sweep_p95_ms", c) == pytest.approx(95.0)
    assert read("local_map.sweep_ms", c) == pytest.approx(50.5)
    assert read("local_map.sweep_p95_ms", _ctx(spans[:10])) is None


def test_knn_roofline_from_live_counts():
    calls = [(4096, 32768, 5, 5000), (256, 16384, 5, 300)]
    c = _ctx(counters={"knn_calls": calls})
    bound = knn_bound_s(*calls[0]) + knn_bound_s(*calls[1])
    assert read("knn_topk_roofline", c) == pytest.approx(
        100 * bound / 20e-6)
    assert read("knn_topk_roofline", _ctx()) is None


def test_knn_bound_is_the_larger_of_bytes_and_operations():
    # operations bound: 8 * 4096 * 26141 / 67e12
    assert knn_bound_s(4096, 32768, 5, 26141) == pytest.approx(
        8 * 4096 * 26141 / 67e12)
    # bytes bound when nothing is live
    assert knn_bound_s(256, 16384, 5, 0) == pytest.approx(
        (12 * 256 + 13 * 16384 + 8 * 256 * 5) / 3.35e12)


def test_end_to_end_readers():
    c = _ctx(result={"sensor_s": 3.0, "window_s": 30.0, "setup_s": 42.0})
    assert read("sensor_s_per_s", c) == pytest.approx(0.1)
    assert read("setup_s", c) == 42.0
