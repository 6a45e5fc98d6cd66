"""The port's tracer (``mvil_fusion_torch/utils/timing.py``) on the CPU.

A span's record holds its parent and request (its own or its parent's);
the summary's self time is a span's length less its children's.  Off,
``span`` hands out one shared do-nothing context: nothing is recorded,
allocated, clocked or annotated.  Two threads' spans nest apart.  A span
is a ``user_annotation`` of a recording ``torch.profiler`` and opens no
``record_function`` without one.  A short stream of sweeps through the
compensator, the deskew, the local mapper and the global mapper (small
capacities, so that every span of the mapping layers runs) records each
span of those layers, and each submap's spans carry the request of the
sweep that emitted it.
"""

import dataclasses
import json
import threading
import time
import tracemalloc
import types

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.frontend.lidar_compensator import LidarCompensator
from mvil_fusion_torch.io.synthetic import SyntheticTrajectory
from mvil_fusion_torch.io.synthetic_lidar import BoxWorld, simulate_sweep
from mvil_fusion_torch.mapping.global_mapping import GlobalMapper
from mvil_fusion_torch.mapping.local_mapping import LocalMapper
from mvil_fusion_torch.ops import deskew
from mvil_fusion_torch.utils import timing
from mvil_fusion_torch.utils.timing import TRACER
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

MAPPING_SPANS = {
    "local_map.compensate", "local_map.deskew", "local_map.process_full",
    "local_map.features", "local_map.scan_to_map", "local_map.map_update",
    "local_map.readback", "local_map.emit_submap", "global_map.submap",
    "global_map.evict", "global_map.reference_map", "global_map.register",
    "global_map.descriptor", "global_map.loop_search", "global_map.solve"}


def summary_rows(tracer):
    """The summary's rows by span name: (count, mean, p95, self ms)."""
    rows = tracer.summary().splitlines()
    assert rows[0].split() == ["span", "count", "mean", "ms", "p95", "ms",
                               "self", "ms"]
    return {r.split()[0]: (int(r.split()[1]), *map(float, r.split()[2:]))
            for r in rows[1:]}


def test_nesting_parent_rid_and_self_time():
    tr = timing.Tracer()
    tr.enable()
    with tr.span("outer", rid=7.5):
        time.sleep(0.02)
        with tr.span("inner"):
            time.sleep(0.03)
        with tr.span("inner", rid=8.0):
            pass
    with tr.span("alone"):
        pass
    rows = summary_rows(tr)
    recs = tr.drain()
    assert [r.name for r in recs] == ["outer", "inner", "inner", "alone"]
    assert [r.parent for r in recs] == [None, 0, 0, None]
    assert [r.rid for r in recs] == [7.5, 7.5, 8.0, None]
    assert {r.thread for r in recs} == {threading.get_ident()}
    assert all(r.t0_ns <= r.t1_ns for r in recs)
    o, i1, i2 = recs[:3]
    assert o.t0_ns <= i1.t0_ns and i2.t1_ns <= o.t1_ns
    child = (i1.t1_ns - i1.t0_ns) + (i2.t1_ns - i2.t0_ns)
    self_ms = (o.t1_ns - o.t0_ns - child) / 1e6
    assert rows["outer"][0] == 1 and rows["inner"][0] == 2
    assert abs(rows["outer"][3] - self_ms) <= 1e-3
    assert self_ms >= 20.0 and i1.t1_ns - i1.t0_ns >= 30e6
    # a span without children is its own self time
    assert rows["inner"][3] == rows["inner"][1]
    assert tr.drain() == [] and summary_rows(tr) == {}


def test_off_is_one_shared_context_that_does_nothing(monkeypatch):
    tr = timing.Tracer()
    assert tr.span("a") is tr.span("b", rid=1.0) is TRACER.span("c")
    calls = []

    def called(*a, **k):
        calls.append(a)
        raise AssertionError("the off tracer reached for this")
    # no clock read, no profiler check, no record_function
    monkeypatch.setattr(timing, "time",
                        types.SimpleNamespace(perf_counter_ns=called))
    monkeypatch.setattr(timing, "torch", types.SimpleNamespace(
        autograd=types.SimpleNamespace(_profiler_enabled=called),
        profiler=types.SimpleNamespace(record_function=called)))
    with profile(activities=[ProfilerActivity.CPU]):
        with tr.span("a", rid=2.0):
            with tr.span("b"):
                pass
    tracemalloc.start()
    try:
        for _ in range(1000):
            with tr.span("x", rid=3.0):
                pass
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = snap.filter_traces([tracemalloc.Filter(True, timing.__file__)])
    assert sum(s.size for s in here.statistics("filename")) == 0
    assert calls == [] and tr.drain() == []
    tr.enable()
    tr.disable()
    with tr.span("after"):
        pass
    assert tr.drain() == []


def test_threads_keep_their_own_stacks():
    tr = timing.Tracer()
    tr.enable()
    both_open = threading.Barrier(2, timeout=30)
    inner_done = threading.Barrier(2, timeout=30)

    def work(name, rid):
        with tr.span(name, rid=rid):
            both_open.wait()
            with tr.span(name + ".inner"):
                inner_done.wait()
    threads = [threading.Thread(target=work, args=(n, r))
               for n, r in (("a", 1.0), ("b", 2.0))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    recs = tr.drain()
    assert sorted(r.name for r in recs) == ["a", "a.inner", "b", "b.inner"]
    for r in recs:
        if r.name.endswith(".inner"):
            parent = recs[r.parent]
            assert parent.name == r.name[:-len(".inner")]
            assert parent.thread == r.thread and r.rid == parent.rid
        else:
            assert r.parent is None
    assert len({r.thread for r in recs}) == 2


def test_spans_are_profiler_annotations_only_under_a_profiler(
        tmp_path, monkeypatch):
    opened = []
    record_function = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return record_function(name)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    tr = timing.Tracer()
    tr.enable()
    with tr.span("tracing.unprofiled"):
        torch.ones(4).sum()
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("tracing.outer"):
            with tr.span("tracing.inner"):
                torch.ones(4).sum()
    assert opened == ["tracing.outer", "tracing.inner"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    notes = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"tracing.outer", "tracing.inner"} <= set(notes)
    assert "tracing.unprofiled" not in notes
    o, i = notes["tracing.outer"], notes["tracing.inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert [r.name for r in tr.drain()] == [
        "tracing.unprofiled", "tracing.outer", "tracing.inner"]


TRAJ = SyntheticTrajectory(duration=8.0, w_amp=(0.2, 0.15, 0.4),
                           w_freq=(0.2, 0.15, 0.25),
                           p_amp=(1.5, 1.2, 0.3), p_freq=(0.2, 0.25, 0.15),
                           lin_vel=(0.5, 0.25, 0.0))


def test_mapping_stream_records_every_span_with_its_request():
    """Five sweeps of 16 × 180, each handing over a submap to a graph of
    4 nodes: the fifth submap evicts; every submap re-solves (a z jump
    above -1 m always counts) and searches for loops, which a 100 m
    radius verifies."""
    base = SystemConfig()
    cfg = base.replace(
        local_mapping=dataclasses.replace(base.local_mapping,
                                          submap_trigger_frames=1),
        global_mapping=dataclasses.replace(
            base.global_mapping, pg_n_max=4, pg_iters=2,
            z_refresh_jump=-1.0, poses_before_reclosing=0,
            skip_recent_poses=1, proximity_threshold=100.0))
    comp = LidarCompensator(cfg, device="cpu")
    mapper = LocalMapper(cfg, device="cpu")
    gm = GlobalMapper(cfg, device="cpu")
    period = cfg.lidar.scan_period
    TRACER.enable()
    try:
        for k in range(5):
            t0 = 0.8 + period * k
            s = simulate_sweep(BoxWorld(), TRAJ, t0, n_azimuth=180)
            p0, q0 = TRAJ.pose_at(t0)
            p1, q1 = TRAJ.pose_at(t0 + period)
            odom = [torch.as_tensor(np.asarray(v, np.float32))
                    for v in (p0, q0, p1, q1)]
            sw = comp.process(t0, s["pts"], s["mask"])
            full = deskew.deskew_to_end(sw.pts, sw.rel_time, *odom, period)
            sm = mapper.process_full(t0 + period, full, sw.ring,
                                     sw.rel_time, sw.mask, None, odom[2],
                                     odom[3], n_rings=16, n_azimuth=256,
                                     scan_period=period)
            if sm is not None:
                gm.add_submap(sm)
    finally:
        TRACER.disable()
        recs = TRACER.drain()
    assert gm.evictions == 1 and gm.n_nodes == 4
    assert {r.name for r in recs} == MAPPING_SPANS
    roots = [r for r in recs if r.parent is None]
    assert {r.name for r in roots} == {
        "local_map.compensate", "local_map.deskew", "local_map.process_full",
        "global_map.submap"}
    sweeps = {r.rid for r in roots if r.name == "local_map.process_full"}
    assert sweeps == {r.rid for r in roots
                      if r.name == "local_map.compensate"}
    assert len(sweeps) == 5
    for r in recs:
        if r.parent is not None:
            p = recs[r.parent]
            assert r.rid == p.rid
            assert p.t0_ns <= r.t0_ns <= r.t1_ns <= p.t1_ns
            assert r.name.split(".")[0] == p.name.split(".")[0]
    # each submap's request is the sweep that emitted it: the sweep whose
    # process_full holds an emit_submap
    emitted = [recs[r.parent].rid for r in recs
               if r.name == "local_map.emit_submap"]
    submaps = [r.rid for r in recs if r.name == "global_map.submap"]
    assert len(submaps) == 5 and submaps == emitted
    loops = [k for k, r in enumerate(recs)
             if r.name == "global_map.loop_search"]
    inside = {r.name for r in recs if r.parent in loops}
    assert {"global_map.reference_map", "global_map.register"} <= inside
