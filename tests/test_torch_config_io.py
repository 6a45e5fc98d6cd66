"""The port's own configuration and synthetic data against the JAX
package's: every field of ``mvil_fusion_torch.config`` holds the
reference's default, and the port's trajectory and sweep generators give
bit-identical output for the same arguments, as do the IMU stream, the
landmarks' projection and the rendered image of the VIO slice.  Also
checks that ``chip_smoke.py`` imports nothing of JAX or of the JAX
package."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

from mvil_fusion_tpu import config as jconfig
from mvil_fusion_tpu.io import synthetic as jsyn
from mvil_fusion_tpu.io import synthetic_lidar as jsl
from mvil_fusion_torch import config as tconfig
from mvil_fusion_torch.io import synthetic as tsyn
from mvil_fusion_torch.io import synthetic_lidar as tsl

TRAJ_ARGS = dict(duration=8.0, w_amp=(0.2, 0.15, 0.4),
                 w_freq=(0.2, 0.15, 0.25), p_amp=(1.5, 1.2, 0.3),
                 p_freq=(0.2, 0.25, 0.15), lin_vel=(0.5, 0.25, 0.0))


@pytest.fixture(scope="module")
def trajs():
    return jsyn.SyntheticTrajectory(**TRAJ_ARGS), \
        tsyn.SyntheticTrajectory(**TRAJ_ARGS)


@pytest.mark.parametrize("section", [f.name for f in
                                     dataclasses.fields(tconfig.SystemConfig)])
def test_config_defaults_match_reference(section):
    ours = getattr(tconfig.SystemConfig(), section)
    ref = getattr(jconfig.SystemConfig(), section)
    assert type(ours).__name__ == type(ref).__name__
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


def test_trajectory_matches_reference(trajs):
    tj, tt = trajs
    for name in ("times", "p", "q", "w"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(tj, name))
    for t in (0.0, 0.8, 1.23, 4.9):
        for a, b in zip(tt.pose_at(t), tj.pose_at(t)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("t0,n_azimuth", [(0.8, 480), (2.7, 900)])
def test_sweep_matches_reference(trajs, t0, n_azimuth):
    tj, tt = trajs
    sj = jsl.simulate_sweep(jsl.BoxWorld(), tj, t0, n_azimuth=n_azimuth)
    st = tsl.simulate_sweep(tsl.BoxWorld(), tt, t0, n_azimuth=n_azimuth)
    assert st.keys() == sj.keys()
    for key in sj:
        np.testing.assert_array_equal(st[key], sj[key], err_msg=key)
    assert st["mask"].sum() > 0.9 * st["mask"].size


# ---------------------------------------------------------------------------
# the sensor front ends: camera, tracker and IMU sections; IMU stream,
# projection and rendered image
# ---------------------------------------------------------------------------

RIC = np.asarray([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
TIC = np.asarray([0.05, -0.02, 0.01])


# what the port leaves out of each class: the JAX pipeline's own, and
# estimator fields that neither package reads
LEFT_OUT = {"CameraConfig": {"border", "upload_workers"},
            "TrackerConfig": {"border", "upload_workers"},
            "ImuConfig": {"border", "upload_workers"},
            "EstimatorConfig": {"angle_vi", "max_obs_per_feature",
                                "keyframe_parallax_px", "dtype",
                                "solver_dtype"}}


@pytest.mark.parametrize("cls", ["CameraConfig", "TrackerConfig",
                                 "ImuConfig", "EstimatorConfig"])
def test_front_end_config_classes_match_reference(cls):
    ours, ref = getattr(tconfig, cls)(), getattr(jconfig, cls)()
    ref_fields = {f.name for f in dataclasses.fields(ref)}
    names = [f.name for f in dataclasses.fields(ours)]
    assert set(names) <= ref_fields
    for name in names:
        assert getattr(ours, name) == getattr(ref, name), name
    assert ref_fields - set(names) <= LEFT_OUT[cls]
    if cls == "CameraConfig":
        assert ours.intrinsics == ref.intrinsics
        assert ours.distortion == ref.distortion
        assert isinstance(ours.poly, tuple)


def test_imu_stream_matches_reference(trajs):
    tj, tt = trajs
    for name in ("v", "a"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(tj, name))
    np.testing.assert_array_equal(tt.gravity, tj.gravity)
    for t in (0.0, 1.23, 4.9):
        for a, b in zip(tt.state_at(t), tj.state_at(t)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tt.imu_at(t), tj.imu_at(t)):
            np.testing.assert_array_equal(a, b)
    kw = dict(ba=[0.05, -0.02, 0.03], bg=[0.01, 0.0, -0.02], noise_acc=0.02,
              noise_gyr=0.005)
    sj = tj.imu_sequence(1.0, 1.35, 200.0, rng=np.random.default_rng(3), **kw)
    st = tt.imu_sequence(1.0, 1.35, 200.0, rng=np.random.default_rng(3), **kw)
    assert len(st) == len(sj) == 4 and len(st[0]) == 71
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tt.imu_sequence(7.9, 8.2, 100.0),
                    tj.imu_sequence(7.9, 8.2, 100.0)):   # clipped at the end
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(
    fx=356.37, fy=354.92, cx=326.88, cy=250.94, width=320, height=240)])
def test_world_projection_and_image_match_reference(trajs, kw):
    tj, tt = trajs
    wj = jsyn.SyntheticWorld(traj=tj, n_landmarks=600, seed=4)
    wt = tsyn.SyntheticWorld(traj=tt, n_landmarks=600, seed=4)
    np.testing.assert_array_equal(wt.landmarks, wj.landmarks)
    for t in (0.5, 3.3):
        pj, pt = wj.project(t, RIC, TIC, **kw), wt.project(t, RIC, TIC, **kw)
        assert pt[3].sum() > 5
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a, b)
        ij = wj.render_image(t, RIC, TIC, **kw)
        it = wt.render_image(t, RIC, TIC, **kw)
        assert it.dtype == np.float32 and it.max() > 100.0
        assert it.shape == (kw.get("height", 480), kw.get("width", 640))
        np.testing.assert_array_equal(it, ij)


def test_chip_smoke_imports_only_the_port():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "mvil_fusion_torch" in roots
    assert not roots & {"jax", "jaxlib", "mvil_fusion_tpu"}, roots
