"""The port's synchronous system (``mvil_fusion_torch/pipeline/system.py``,
``VilSystem``) against the JAX package's: the sweep drain policy (stale
sweeps dropped, sweeps past the window held back, at most 5 waiting before
initialization), the depth-cloud cadence (every 2nd sweep), the camera
pose and feature depths handed to the estimator, and the four result
files, byte for byte, on a hand-built NON_LINEAR window of a stationary
scene; and tests/test_full_system.py on the port (``slow``, as the
reference's is).

Tolerances: the drain decisions, the sweeps' modes, the ring's slot times
and the result files exactly; the camera pose within 1e-6 and the feature
depths within 1e-4 m (tests/test_torch_depth_register.py).
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from mvil_fusion_tpu.pipeline.system import VilSystem as JVilSystem
from mvil_fusion_torch.config import LocalMappingConfig
from mvil_fusion_torch.pipeline.system import VilSystem
from test_torch_cuda import small_cfg, sweep, window
from test_torch_depth_register import box_scene
from test_torch_vil import jax_config
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

CPU = "cpu"


@pytest.fixture(scope="module")
def systems():
    cfg = small_cfg()
    return (JVilSystem(jax_config(cfg), enable_mapping=False),
            VilSystem(cfg, enable_mapping=False, device=CPU))


def state(sys_):
    lid = sys_.estimator.lidar
    return dict(pending=[round(s.t_start, 6) for s, _ in sys_._pending_sweeps],
                count=sys_.lidar_sweep_count,
                slots=[float(t) for t in sys_.depth_register._snap[2]],
                modes=list(lid.mode_counts),
                prev=None if lid.prev is None else round(lid.prev.t_end, 6))


def test_drain_policy_and_depth_cadence_match_reference(systems):
    seen = []
    for sys_ in systems:
        run = []
        # before initialization: sweeps wait, at most the newest 5
        for k in range(7):
            sys_.process_lidar(*sweep(0.1 + 0.05 * k))
        run.append(state(sys_))
        # a window over [0.5, 1.1]: the waiting sweeps are stale, a sweep
        # inside it is taken, sweeps past its end wait
        window(sys_, 0.5)
        for t in (0.3, 0.55, 0.65, 0.75, 1.05, 1.2):
            out = sys_.process_lidar(*sweep(t))
            run.append((state(sys_), None if out is None else (
                round(out["t_end"], 6), out["mode"])))
        # the window advances: the held sweeps are taken
        window(sys_, 0.7)
        sys_._pump_lidar()
        run.append(state(sys_))
        seen.append(run)
    assert seen[0] == seen[1]
    final = seen[1][-1]
    assert final["pending"] == [] and final["count"] == 13
    # one cloud: the sweep taken at an even count (the two the window's
    # advance took came in at an odd one)
    assert final["slots"][-1] == 0.75 and sum(np.isfinite(final["slots"])) == 1
    assert final["modes"][4] == 4 and final["prev"] == 1.3  # zero velocity
    assert seen[1][0]["pending"] == [0.2, 0.25, 0.3, 0.35, 0.4]


def test_feature_depths_match_reference(systems):
    rng = np.random.default_rng(5)
    cloud, norm, _ = box_scene(rng, n_feat=150)
    depths = []
    for sys_ in systems:
        sys_.depth_register.add_cloud(1.2, cloud)
        est = sys_.estimator
        est.last_pose_host = (np.asarray([0.2, -0.1, 0.05], np.float32),
                              np.asarray([np.cos(0.2), 0, 0, np.sin(0.2)],
                                         np.float32),
                              np.asarray([0.05, -0.02, 0.01], np.float32),
                              np.asarray([0.5, -0.5, 0.5, -0.5], np.float32))
        depths.append((sys_._camera_pose_host(),
                       sys_._feature_depths(1.3, norm, np.ones(150, bool))))
    (pj, qj), dj = depths[0]
    (pt, qt), dt = depths[1]
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-6)
    assert dt.shape == dj.shape == (150,)
    both = (dj > 0) & (dt > 0)
    assert both.sum() > 30 and ((dj > 0) != (dt > 0)).sum() <= 1
    np.testing.assert_allclose(dt[both], dj[both], rtol=0, atol=1e-4)


def test_result_files_match_reference(tmp_path):
    """save_results of both systems on the same rows: Frontend, Midend,
    Backend and ex_results, byte for byte."""
    cfg = small_cfg()
    rng = np.random.default_rng(6)
    rows = [(0.5 + 0.1 * k + 1e-7 * k, rng.normal(size=3).astype(np.float32),
             rng.normal(size=4).astype(np.float32),
             rng.normal(size=3).astype(np.float32)) for k in range(5)]
    files = []
    for k, sys_ in enumerate((JVilSystem(jax_config(cfg)),
                              VilSystem(cfg, device=CPU))):
        est = sys_.estimator
        est.trajectory = list(rows)
        for t, p, q, _ in rows:
            est._record_ex_results(t, p, q / np.linalg.norm(q), t * 1e-3)
        sys_.local_mapper.trajectory = [r[:3] for r in rows[1:]]
        sys_.global_mapper.trajectory = lambda: [r[:3] for r in rows[2:]]
        prefix = str(tmp_path / f"{k}_")
        sys_.save_results(prefix)
        files.append({n: open(prefix + n, "rb").read() for n in (
            "Frontend.txt", "Midend.txt", "Backend.txt", "ex_results.txt")})
    assert files[0] == files[1]
    assert files[1]["ex_results.txt"].count(b"\n") == 5
    assert len(files[1]["ex_results.txt"].split(b"\n")[0].split()) == 14


def test_system_needs_a_card_by_default():
    if torch.cuda.is_available():
        assert VilSystem(small_cfg()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            VilSystem(small_cfg())
    sys_ = VilSystem(small_cfg(), enable_mapping=False, device=CPU)
    assert sys_.estimator.lidar.device.type == "cpu"
    assert sys_.depth_register.device.type == "cpu"


# ---------------------------------------------------------------------------
# tests/test_full_system.py on the port
# ---------------------------------------------------------------------------

def full_system_config():
    """tests/test_full_system.py::make_cfg on the port."""
    return dataclasses.replace(
        chip_smoke.vil_config(max_features=128, vgicp_iters=8),
        local_mapping=LocalMappingConfig(submap_trigger_dist=1.0,
                                         submap_trigger_frames=8))


@pytest.mark.slow
def test_full_system_end_to_end(tmp_path):
    cfg = full_system_config()
    frames, sweeps = chip_smoke.vil_sequence(
        chip_smoke.sequence_world(7.0), cfg, t_end=5.2,
        lidar_times=np.arange(1.35, 4.8, 0.2), n_azimuth=360)
    sys_ = VilSystem(cfg, use_tracker=False, enable_mapping=True,
                     device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        chip_smoke.run_stream(
            sys_, frames, sweeps,
            lambda s: sys_.process_lidar(s["t_start"], s["pts"], s["mask"]))
    est = sys_.estimator
    assert est.status == est.NON_LINEAR
    assert est.failures == 0
    assert len(sys_.frontend_trajectory()) > 25
    assert len(sys_.midend_trajectory()) > 5
    assert len(sys_.backend_trajectory()) >= 1
    assert len(sys_.depth_register.clouds) >= 1
    assert chip_smoke.ate_4dof(est.trajectory, frames) < 0.3
    sys_.save_results(str(tmp_path) + "/")
    for name in ("Frontend.txt", "Midend.txt", "Backend.txt"):
        path = os.path.join(tmp_path, name)
        assert os.path.exists(path)
        assert len(open(path).readlines()) >= 1
