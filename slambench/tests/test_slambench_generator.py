"""The benchmark's copy of the synthetic sources against the port's
``io/`` at small sizes."""

import numpy as np
import pytest

from slambench import generator as gen


def _traj_args():
    return dict(p_amp=(1.3, 1.1, 0.4), p_freq=(0.31, 0.37, 0.21),
                w_amp=(0.45, 0.4, 0.5), w_freq=(0.37, 0.29, 0.43),
                lin_vel=(0.25, 0.0, 0.0))


def test_handheld_trajectory_is_synthetic_trajectory():
    from mvil_fusion_torch.io.synthetic import SyntheticTrajectory
    a = _traj_args()
    ref = SyntheticTrajectory(duration=2.0, **a)
    ours = gen.HandheldTrajectory(2.0, **a)
    for name in ("p", "v", "a", "q", "w"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(ref, name))
    for t in (0.0, 0.37, 1.5):
        acc, gyr = ours.imu_at(np.asarray([t]))
        racc, rgyr = ref.imu_at(t)
        np.testing.assert_allclose(acc[0], racc, rtol=0, atol=1e-12)
        np.testing.assert_allclose(gyr[0], rgyr, rtol=0, atol=0)


def test_ray_range_is_box_world_with_one_origin_per_ray():
    from mvil_fusion_torch.io.synthetic_lidar import BoxWorld
    box = BoxWorld()
    room = gen.Room(size=box.room, boxes=box.boxes)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(500, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.asarray([0.5, -1.0, 0.2])
    np.testing.assert_array_equal(room.ray_range(o, d),
                                  box.ray_range(o, d))


def test_sweep_is_simulate_sweep_within_rounding():
    """The column-vectorized sweep against the port's per-column loop at
    16 × 64."""
    from mvil_fusion_torch.io.synthetic import SyntheticTrajectory
    from mvil_fusion_torch.io.synthetic_lidar import BoxWorld, simulate_sweep
    a = _traj_args()
    traj = SyntheticTrajectory(duration=2.0, **a)
    box = BoxWorld()
    ref = simulate_sweep(box, traj, 0.8, n_azimuth=64)
    lidar = gen.Lidar(16, 64, -15.0, 15.0, 0.1, 0.5, 70.0,
                      np.asarray([1.0, 0, 0, 0]), np.zeros(3))
    ours_traj = gen.HandheldTrajectory(2.0, **a)
    ranges, valid, rel = gen.sweep_ranges(gen.Room(box.room, box.boxes),
                                          ours_traj, lidar, 0.8)
    dirs, _ = lidar.directions()
    pts = gen.sweep_points(dirs, ranges, valid)
    np.testing.assert_array_equal(valid, ref["mask"])
    np.testing.assert_allclose(rel, ref["rel_time"], atol=1e-7)
    np.testing.assert_allclose(pts[valid], ref["pts"][valid], atol=2e-5)


def test_orbit_repeats_every_lap():
    o = gen.OrbitTrajectory(20.0, (3.0, 1.5, 0.9), (1, 2, 1),
                            (0.2, 0.15, 0.3), (2, 1, 3))
    t = np.linspace(0, 20, 7)
    p0, q0 = o.pose_at(t)
    p1, q1 = o.pose_at(t + 40.0)
    np.testing.assert_allclose(p0, p1, atol=1e-9)
    np.testing.assert_allclose(q0, q1, atol=1e-9)
