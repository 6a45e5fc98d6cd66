"""The port's channels, runner and 3-stage pipeline
(``mvil_fusion_torch/pipeline/{channels,runner,async_system}.py`` over
``mvil_fusion_torch/runtime``) against the JAX package's.

- tests/test_pipeline.py's cases, each run on both implementations (FIFO,
  BLOCK backpressure, DROP_OLDEST, close and timeout, threaded,
  deterministic with errors, MultiOut with quiesce), and the port's `stop`
  raising for a stage that does not finish;
- the deterministic pipeline of each package on one hand-built NON_LINEAR
  window fed the same IMU, LiDAR and flush messages, with the mappers
  replaced by one stand-in that emits a submap every second sweep: each
  stage's outputs (kinds and times), the drain decisions, the sweep count,
  the depth register's slot times, the LPS channel and the estimator's LPS
  list, all exactly;
- the port's deterministic pipeline against the port's synchronous
  VilSystem on that window with the real mappers: trajectories, submaps,
  LPS and the depth ring equal to the bit;
- the flush sentinel through the threaded pipeline (the port's counterpart
  of tests/test_deferred_readback.py::test_flush_sentinel_through_pipeline).
"""

import threading
import time

import numpy as np
import pytest

from mvil_fusion_tpu.pipeline import async_system as jasync
from mvil_fusion_tpu.pipeline import channels as jchannels
from mvil_fusion_tpu.pipeline import runner as jrunner
from mvil_fusion_tpu.pipeline.system import VilSystem as JVilSystem
from mvil_fusion_torch.pipeline import async_system as tasync
from mvil_fusion_torch.pipeline import channels as tchannels
from mvil_fusion_torch.pipeline import runner as trunner
from mvil_fusion_torch.pipeline.system import VilSystem
from test_torch_cuda import (IMU, feed_system, saved_state, small_cfg,
                             stream, window)
from test_torch_vil import jax_config
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

CPU = "cpu"
IMPLS = {"jax": (jchannels, jrunner), "torch": (tchannels, trunner)}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


# ---------------------------------------------------------------------------
# tests/test_pipeline.py on both implementations
# ---------------------------------------------------------------------------

def test_channel_fifo_and_payloads(impl):
    ch_mod, _ = impl
    ch = ch_mod.Channel(capacity=8)
    arrays = [np.arange(k, k + 5) for k in range(5)]
    for a in arrays:
        ch.put(a)
    assert len(ch) == 5
    for a in arrays:
        np.testing.assert_array_equal(ch.get(), a)


def test_channel_block_backpressure(impl):
    ch_mod, _ = impl
    ch = ch_mod.Channel(capacity=2, policy=ch_mod.Policy.BLOCK)
    ch.put(1)
    ch.put(2)
    done = []

    def producer():
        ch.put(3)   # blocks until a slot frees
        done.append(True)

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.1)
    assert not done
    assert ch.get() == 1
    t.join(2.0)
    assert done and not t.is_alive()
    assert ch.get() == 2 and ch.get() == 3


def test_channel_drop_oldest(impl):
    ch_mod, _ = impl
    ch = ch_mod.Channel(capacity=3, policy=ch_mod.Policy.DROP_OLDEST)
    for k in range(10):
        ch.put(k)
    assert len(ch) == 3
    assert ch.dropped == 7
    assert ch.get() == 7   # oldest surviving


def test_channel_close_and_timeout(impl):
    ch_mod, _ = impl
    ch = ch_mod.Channel(capacity=2)
    with pytest.raises(TimeoutError):
        ch.get(timeout=0.05)
    ch.put("x")
    ch.close()
    assert ch.get() == "x"      # drains after close
    with pytest.raises(ch_mod.Closed):
        ch.get()
    with pytest.raises(ch_mod.Closed):
        ch.put("y")


def test_pipeline_threaded(impl):
    _, run_mod = impl
    p = run_mod.Pipeline()
    inbox = p.add_stage("double", lambda x: x * 2)
    p.add_stage("plus1", lambda x: x + 1)
    results = []
    p.add_stage("sink", lambda x: results.append(x))
    p.start()
    for k in range(50):
        inbox.put(k)
    p.stop()
    assert sorted(results) == [2 * k + 1 for k in range(50)]
    assert all(not st.errors for st in p.stages)
    assert not any(st.thread.is_alive() for st in p.stages)


def test_pipeline_deterministic_and_errors(impl):
    _, run_mod = impl
    p = run_mod.Pipeline(deterministic=True)

    def flaky(x):
        if x == 3:
            raise RuntimeError("boom")
        return x
    p.add_stage("flaky", flaky)
    out = []
    p.add_stage("sink", lambda x: out.append(x))
    for k in range(6):
        p.feed(k)
    assert out == [0, 1, 2, 4, 5]
    assert len(p.stages[0].errors) == 1


def test_pipeline_multiout_and_quiesce(impl):
    """A stage can emit several downstream items from one input (MultiOut —
    the sweep-buffer drain), and quiesce() waits for full drain including
    in-flight work."""
    _, run_mod = impl
    p = run_mod.Pipeline()

    def burst(x):
        time.sleep(0.05)                 # in-flight work quiesce must see
        return run_mod.MultiOut([x, x + 100]) if x % 2 == 0 else x

    inbox = p.add_stage("burst", burst)
    out = []
    p.add_stage("sink", lambda x: out.append(x))
    p.start()
    for k in range(6):
        inbox.put(k)
    assert p.quiesce(timeout=10.0)
    assert sorted(out) == [0, 1, 2, 3, 4, 5, 100, 102, 104]
    # pipeline still alive after quiesce: feed more
    inbox.put(7)
    assert p.quiesce(timeout=10.0)
    assert 7 in out
    p.stop()
    assert all(not st.errors for st in p.stages)


def test_stop_raises_for_a_stage_that_does_not_finish():
    """The reference's stop returns silently with a stage thread still
    running; the port's names it."""
    release = threading.Event()
    p = trunner.Pipeline()
    inbox = p.add_stage("stuck", lambda x: release.wait(10.0))
    p.start()
    inbox.put(0)
    assert not p.quiesce(timeout=0.2)
    with pytest.raises(RuntimeError, match="stuck"):
        p.stop(timeout=0.2)
    release.set()
    p.stages[0].thread.join(5.0)
    assert not p.stages[0].thread.is_alive()
    assert p.quiesce(timeout=1.0)


def test_channel_library_builds_under_build_runtime():
    from mvil_fusion_torch import runtime
    lib = runtime.library_path()
    runtime.load_library()
    assert lib.exists() and lib.parent.name == "runtime" \
        and lib.parent.parent.name == "build"
    assert lib.parent.parent.parent == runtime._SRC.parents[2]


# ---------------------------------------------------------------------------
# the 3-stage pipeline on a hand-built NON_LINEAR window
# ---------------------------------------------------------------------------

class StandInMappers:
    """The mapping stage's two mappers in one: every second mapped sweep
    emits a submap, and so does the flush; a submap is its time, and its
    localizer pose a function of it."""

    def __init__(self):
        self.mapped = []
        self.trajectory = []

    def process_full(self, t, *args, **kwargs):
        self.mapped.append(round(t, 6))
        return t if len(self.mapped) % 2 == 0 else None

    def flush(self):
        """The submap left at the end of the stream."""
        return self.mapped[-1] + 0.05 if self.mapped else None

    def add_submap(self, t):
        p = np.asarray([t, -t, 0.5 * t], np.float32)
        q = np.asarray([np.cos(t), 0.0, 0.0, np.sin(t)], np.float32)
        return dict(t=t, p=p, q=q)


def run_deterministic(pipe_mod, sys_, msgs):
    """Feed msgs to the deterministic pipeline of `sys_`; returns the
    pipeline and each stage's outputs as (kind, t)."""
    pipe = pipe_mod.build_pipeline(sys_, deterministic=True)
    outs = {}
    for st in pipe.stages:
        seen = outs.setdefault(st.name, [])

        def wrapped(msg, fn=st.fn, seen=seen):
            res = fn(msg)
            for r in ([] if res is None else res if isinstance(res, list)
                      else [res]):
                seen.append((r[0], round(r[1], 6)))
            return res
        st.fn = wrapped
    for m in msgs:
        pipe.feed(m)
    for st in pipe.stages:
        assert not st.errors, st.errors[:1]
    return pipe, outs


def drain_channel(ch):
    items = []
    while len(ch):
        t, p, q = ch.get(timeout=0.0)
        items.append((round(t, 6), np.asarray(p).tolist(),
                      np.asarray(q).tolist()))
    return items


def pipeline_record(sys_, pipe, outs):
    est = sys_.estimator
    ring = sys_.depth_register._snap[2]
    return dict(
        outs=outs,
        mapped=list(sys_.local_mapper.mapped),
        pending=[round(s.t_start, 6) for s, _ in sys_._pending_sweeps],
        count=sys_.lidar_sweep_count,
        slots=[float(t) for t in ring],
        modes=list(est.lidar.mode_counts),
        lps_list=[(round(t, 6), p.tolist(), q.tolist())
                  for t, p, q in est.lps_list],
        lps_channel=drain_channel(pipe.lps_channel),
        imu=len(est._pending.t))


def test_deterministic_pipeline_matches_reference():
    cfg = small_cfg()
    msgs = stream()
    records = []
    for pipe_mod, sys_ in (
            (jasync, JVilSystem(jax_config(cfg), enable_mapping=False)),
            (tasync, VilSystem(cfg, enable_mapping=False, device=CPU))):
        window(sys_, 0.5)
        sys_.local_mapper = sys_.global_mapper = StandInMappers()
        pipe, outs = run_deterministic(pipe_mod, sys_, msgs)
        records.append(pipeline_record(sys_, pipe, outs))
    jrec, trec = records
    assert trec == jrec
    # the window [0.5, 1.1] takes the sweeps at 0.55-0.85 and holds the
    # two past its end; the stale one is dropped
    assert trec["mapped"] == [0.65, 0.75, 0.85, 0.95]
    assert trec["pending"] == [1.05, 1.2] and trec["count"] == 7
    assert trec["outs"]["estimator"].count(("lidar_out", 0.75)) == 1
    # two localizer poses reached the estimator; the flush's waits
    assert [t for t, _, _ in trec["lps_list"]] == [0.75, 0.95]
    assert [t for t, _, _ in trec["lps_channel"]] == [1.0]
    assert trec["outs"]["frontend"][-1] == ("flush", 1.3)


def test_deterministic_pipeline_equals_sync_system():
    """The port's deterministic pipeline is the synchronous VilSystem with
    its calls regrouped by stage: on the same messages, with the real
    mappers (a submap every sweep; two sweeps are mapped, since LOAM's
    plain k-NN takes ~12 s a sweep on one CPU thread), every field that a
    checkpoint saves is equal to the bit."""
    from mvil_fusion_torch.config import LocalMappingConfig
    cfg = small_cfg().replace(local_mapping=LocalMappingConfig(
        submap_trigger_frames=1))
    msgs = stream((0.3, 0.55, 0.65, 1.2))
    sync = VilSystem(cfg, device=CPU)
    window(sync, 0.5)
    feed_system(sync, msgs)
    det = VilSystem(cfg, device=CPU)
    window(det, 0.5)
    pipe, _ = run_deterministic(tasync, det, msgs)
    # the pipeline hands its last localizer pose to the estimator at the
    # estimator's next message, the synchronous system at once
    while len(pipe.lps_channel):
        det.estimator.process_lps(*pipe.lps_channel.get(timeout=0.0))
    assert sync.local_mapper.submaps_emitted == 2
    assert len(sync.global_mapper.trajectory()) == 2
    assert len(sync.estimator.lps_list) == 2
    assert saved_state(det) == saved_state(sync)


def test_flush_sentinel_through_threaded_pipeline():
    """('flush', t, ()) drains every stage's pending state without error
    in the threaded pipeline."""
    from mvil_fusion_torch.io.fixture import fixture_config
    system = VilSystem(fixture_config(), use_tracker=False,
                       enable_mapping=True, device=CPU)
    pipe = tasync.build_pipeline(system, deterministic=False)
    assert system.estimator.defer_readback
    assert pipe.streams == {"frontend": None, "estimator": None,
                            "mapping": None}
    pipe.start()
    try:
        for k in range(20):
            pipe.feed(("imu", k * 0.005, IMU))
        pipe.feed(("flush", 0.1, ()))
        assert pipe.quiesce(timeout=60.0)
    finally:
        pipe.stop(timeout=30.0)
    for st in pipe.stages:
        assert not st.errors, st.errors[:1]
        assert not st.thread.is_alive()
    assert [st.processed for st in pipe.stages] == [21, 21, 1]
    assert len(system.estimator._pending.t) == 20
