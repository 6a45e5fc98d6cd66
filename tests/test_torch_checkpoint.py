"""Checkpoint/resume of the port (``mvil_fusion_torch/utils/checkpoint.py``)
and its stage timer (``utils/timing.py``).

A VilSystem on the hand-built NON_LINEAR window of tests/test_torch_system.py
(mapping on, a submap every second sweep) is saved after one mapped sweep
with a sweep still waiting for the window; a fresh system restores it.
Every saved tensor and host field of the restored system equals the
original's, and both, fed the same next messages, end in the same state to
the bit (the CPU runs the same operations in the same order).  The file
names no global outside numpy and this package (no `torch`), and the
restricted unpickler refuses any other.  `slow`, as the reference's is:
tests/test_checkpoint.py::test_checkpoint_resume_continues on the port's
VIOEstimator.
"""

import os
import pickle
import pickletools

import numpy as np
import pytest
import torch

import chip_smoke
from mvil_fusion_torch.config import LocalMappingConfig
from mvil_fusion_torch.estimator.vio import VIOEstimator
from mvil_fusion_torch.pipeline.system import VilSystem
from mvil_fusion_torch.utils import checkpoint, timing
from test_torch_cuda import (feed_system, saved_state, small_cfg, stream,
                             window)
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

CPU = "cpu"


def pickle_globals(path):
    """(module, name) of every global a pickle file names."""
    found, strings = [], []
    with open(path, "rb") as f:
        for op, arg, _ in pickletools.genops(f):
            if op.name == "GLOBAL":
                found.append(tuple(arg.split(" ", 1)))
            elif op.name == "STACK_GLOBAL":
                found.append(tuple(strings[-2:]))
            elif isinstance(arg, str):
                strings.append(arg)
    return set(found)


def test_system_checkpoint_resumes(tmp_path):
    cfg = small_cfg().replace(local_mapping=LocalMappingConfig(
        submap_trigger_frames=2))
    msgs = stream((0.3, 0.55, 0.65))[:-1]
    first = [m for m in msgs if m[1] < 0.6]
    rest = [m for m in msgs if m[1] >= 0.6]
    # a sweep past the window's end waits in the system when it is saved
    first += [m for m in stream((1.05,)) if m[0] == "lidar"]
    sys_ = VilSystem(cfg, device=CPU)
    window(sys_, 0.5)
    feed_system(sys_, first)
    path = str(tmp_path / "ckpt.pkl")
    checkpoint.save_system(sys_, path)
    assert [round(s.t_start, 6) for s, _ in sys_._pending_sweeps] == [1.05]
    assert sys_.local_mapper.initialized and sys_.lidar_sweep_count == 3
    assert len(sys_.depth_register.clouds) == 1

    restored = VilSystem(cfg, device=CPU)
    checkpoint.load_system(restored, path)
    assert saved_state(restored) == saved_state(sys_)
    assert restored.estimator.lidar.prev.vmap.mean.dtype == torch.float32

    feed_system(sys_, rest)
    feed_system(restored, rest)
    assert sys_.local_mapper.submaps_emitted == 1
    assert len(sys_.estimator.lps_list) == 1
    assert saved_state(restored) == saved_state(sys_)

    modules = {m for m, _ in pickle_globals(path)}
    assert modules and not {m for m in modules if m.startswith("torch")}
    assert all(m.startswith(("numpy", "mvil_fusion_torch.", "collections",
                             "builtins")) for m in modules), modules


class _Runs:
    def __reduce__(self):
        return (os.system, ("true",))


@pytest.mark.parametrize("payload", [_Runs(), torch.zeros(3)],
                         ids=["os.system", "torch tensor"])
def test_checkpoint_refuses_foreign_globals(tmp_path, payload):
    path = str(tmp_path / "bad.pkl")
    with open(path, "wb") as f:
        pickle.dump({"estimator": payload}, f)
    est = VIOEstimator(small_cfg(), device=CPU)
    with pytest.raises(pickle.UnpicklingError, match="disallowed global"):
        checkpoint.load_system(est, path)


def test_profiler_sections(tmp_path):
    prof = timing.Profiler()
    with prof.section("a"):
        sum(range(1000))
    with prof.section("a"):
        pass
    with prof.section("b", sync=True):
        pass
    assert prof.stats["a"].count == 2
    assert "a" in prof.summary() and "b" in prof.summary()
    with timing.torch_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py on the port
# ---------------------------------------------------------------------------

def drive(est, world, t0, t_end):
    """tests/test_checkpoint.py::drive: frames of noise-free features and
    IMU into an existing estimator."""
    traj = world.traj
    frame_times = np.arange(t0, t_end, 0.1)
    prev_norm, prev_t = {}, None
    for fi, t in enumerate(frame_times):
        t_prev = frame_times[fi - 1] if fi > 0 else t - 0.1
        acc, gyr, _, ts = traj.imu_sequence(max(t_prev, 0.0) + 1e-9, t,
                                            200.0)
        for k in range(len(ts)):
            est.process_imu(ts[k], acc[k], gyr[k])
        _, norm, _, vis = world.project(t, np.eye(3), np.zeros(3))
        ids = np.nonzero(vis)[0][:150]
        n = norm[ids]
        vel = np.zeros((len(ids), 2), np.float32)
        if prev_t is not None:
            for j, fid in enumerate(ids):
                if fid in prev_norm:
                    vel[j] = (n[j] - prev_norm[fid]) / (t - prev_t)
        prev_norm = {fid: n[j] for j, fid in enumerate(ids)}
        prev_t = t
        est.process_features(t, ids, n.astype(np.float32), vel)
    return est


@pytest.mark.slow
def test_checkpoint_resume_continues(tmp_path):
    world = chip_smoke.sequence_world(8.0)
    cfg = chip_smoke.sequence_config(max_features=128)
    est = drive(VIOEstimator(cfg, device=CPU), world, 0.5, 2.6)
    assert est.status == VIOEstimator.NON_LINEAR
    path = str(tmp_path / "ckpt.pkl")
    checkpoint.save_system(est, path)
    drive(est, world, 2.6, 3.4)
    est2 = VIOEstimator(cfg, device=CPU)
    checkpoint.load_system(est2, path)
    assert est2.status == VIOEstimator.NON_LINEAR
    drive(est2, world, 2.6, 3.4)
    np.testing.assert_allclose(est2.state.p.numpy(), est.state.p.numpy(),
                               atol=1e-4)
    assert len(est2.trajectory) == len(est.trajectory)
