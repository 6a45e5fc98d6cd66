"""The plain reference on hand-checked cases."""

import numpy as np
import pytest
import torch

from slambench import generator as gen
from slambench.reference import scan_judge as sj

f64 = torch.float64


def _quat(axis, angle):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def test_slerp_and_deskew_of_a_pure_translation():
    pts = torch.tensor([[1.0, 0, 0], [1.0, 0, 0]], dtype=f64)
    rel = torch.tensor([0.0, 0.1], dtype=f64)
    q = torch.tensor([1.0, 0, 0, 0], dtype=f64)
    out = sj.deskew(pts, rel, 0.1, torch.zeros(3, dtype=f64), q,
                    torch.tensor([0.5, 0, 0], dtype=f64), q)
    # the first point was seen 0.5 m behind the end pose
    np.testing.assert_allclose(out.numpy(), [[0.5, 0, 0], [1.0, 0, 0]])
    qs = sj.quat_slerp(q, torch.tensor(_quat([0, 0, 1], 1.0), dtype=f64),
                       torch.tensor([0.5], dtype=f64))
    np.testing.assert_allclose(qs[0].numpy(), _quat([0, 0, 1], 0.5),
                               atol=1e-12)


def test_voxel_filter_averages_each_voxel():
    pts = torch.tensor([[0.1, 0.1, 0.1], [0.2, 0.2, 0.2], [1.1, 0, 0]],
                       dtype=f64)
    out = sj.voxel_filter(pts, 1.0)
    got = sorted(map(tuple, np.round(out.numpy(), 9)))
    assert got == [(0.15, 0.15, 0.15), (1.1, 0.0, 0.0)]


def test_rotation_round_trip():
    q = torch.tensor(_quat([1, 2, 3], 0.7), dtype=f64)
    Rq = sj.quat_to_mat(q)
    np.testing.assert_allclose((Rq @ Rq.T).numpy(), np.eye(3), atol=1e-12)
    axis = np.asarray([1, 2, 3]) / np.linalg.norm([1, 2, 3])
    np.testing.assert_allclose(
        sj.so3_exp(torch.tensor(0.7 * axis, dtype=f64)).numpy(), Rq.numpy(),
        atol=1e-12)
    w = torch.tensor([0.1, -0.2, 0.3], dtype=f64)
    R = sj.so3_exp(w)
    np.testing.assert_allclose((R @ R.T).numpy(), np.eye(3), atol=1e-12)


def _room_scan(p=(0.0, 0.0, 0.0), yaw=0.0, n_az=720, height=3.0):
    """A motionless 16 × n_az sweep of the benchmark's room from `p`,
    turned by `yaw`: (points (16, n_az, 3) in the sensor frame, valid)."""
    room = gen.Room(size=(24.0, 20.0, height),
                    boxes=[((5.0, 4.0, 0.0), (1.0, 1.5, 2.0))])
    q = np.asarray([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])
    traj = gen.OrbitTrajectory(10.0, (0, 0, 0), (1, 1, 1), (0, 0, 0),
                               (1, 1, 1), q_mount=q, center=p)
    lidar = gen.Lidar(16, n_az, -15.0, 15.0, 0.1, 0.5, 70.0,
                      np.asarray([1.0, 0, 0, 0]), np.zeros(3))
    ranges, valid, _ = gen.sweep_ranges(room, traj, lidar, 0.0)
    dirs, _ = lidar.directions()
    pts = gen.sweep_points(dirs, ranges, valid).astype(np.float64)
    return (torch.tensor(pts).reshape(16, n_az, 3),
            torch.tensor(valid).reshape(16, n_az))


def test_grid_normals_of_walls():
    grid, valid = _room_scan()
    _, n, ok = sj.grid_normals(grid, valid, cols=2)
    n = n[ok]
    assert ok.sum() > 3000
    # the normals are the room's axes, but for a few that straddle an edge
    along = n.abs().max(dim=1).values > np.cos(np.radians(1.0))
    assert along.double().mean() > 0.97


@pytest.mark.parametrize("move", [(0.05, 0.0, 0.0, 0.0),
                                  (0.0, -0.04, 0.02, 0.01)])
def test_icp_recovers_a_known_motion(move):
    dst_grid, dst_valid = _room_scan()
    c, n, ok = sj.grid_normals(dst_grid, dst_valid, cols=2)
    src_grid, src_valid = _room_scan(p=move[:3], yaw=move[3])
    src = sj.voxel_filter(src_grid[src_valid], 0.25)
    R_true = sj.so3_exp(torch.tensor([0.0, 0.0, move[3]], dtype=f64))
    t_true = torch.tensor(move[:3], dtype=f64)
    R, t, n_pairs = sj.icp(src, c[ok], n[ok], torch.eye(3, dtype=f64),
                           torch.zeros(3, dtype=f64))
    assert n_pairs > 500
    np.testing.assert_allclose(R.numpy(), R_true.numpy(), atol=5e-4)
    np.testing.assert_allclose(t.numpy(), t_true.numpy(), atol=3e-3)


def test_icp_leaves_an_unobserved_direction_alone():
    """In a room too high for any ring to reach floor or ceiling, height
    is not observed: the alignment does not move it."""
    dst_grid, dst_valid = _room_scan(height=12.0)
    c, n, ok = sj.grid_normals(dst_grid, dst_valid, cols=2)
    src_grid, src_valid = _room_scan(p=(0.03, 0.0, 0.05), height=12.0)
    src = sj.voxel_filter(src_grid[src_valid], 0.25)
    R, t, _ = sj.icp(src, c[ok], n[ok], torch.eye(3, dtype=f64),
                     torch.zeros(3, dtype=f64))
    assert abs(float(t[0]) - 0.03) < 2e-3
    assert abs(float(t[2])) < 1e-3


def test_compensate_rings_and_times_by_hand():
    from slambench.reference import compensate as cp
    # azimuths 5, -90, 180 and 90 degrees, turned clockwise from 10; at
    # elevations -15 and 1 degree (rings 0 and 8 of 16, 2 degrees apart)
    el = np.radians([-15.0, 1.0, 1.0, 1.0])
    az = np.radians([5.0, -90.0, 180.0, 90.0])
    pts = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                    np.sin(el)], 1) * 5.0
    ring, rel, kept, frac = cp.annotate(
        torch.tensor(pts), torch.tensor([True, True, True, False]),
        torch.tensor(np.radians(10.0), dtype=f64), 16, 0.1, -15.0, 15.0,
        0.5, 70.0)
    assert ring.tolist() == [0, 8, 8, 8]
    np.testing.assert_allclose(frac.numpy(), [5 / 360, 100 / 360, 190 / 360,
                                              280 / 360], atol=1e-12)
    np.testing.assert_allclose(rel.numpy(), 0.1 * frac.numpy())
    assert kept.tolist() == [True, True, True, False]
    assert cp.start_azimuth([0.1, 0.3, 0.2]) == pytest.approx(0.3)
    # the history's most counter-clockwise azimuth, across the wrap
    v = cp.start_azimuth([3.1, -3.1])
    assert (np.cos(v), np.sin(v)) == pytest.approx((np.cos(-3.1),
                                                    np.sin(-3.1)))


def _program_sweep(dtype_ref):
    """A 16 × 64 sweep along a turning path, through the program's
    compensator and deskew and the reference's: (program, reference)
    as ``deskew_gap`` takes them."""
    from mvil_fusion_torch.config import SystemConfig
    from mvil_fusion_torch.frontend.lidar_compensator import \
        LidarCompensator
    from mvil_fusion_torch.ops import deskew

    from slambench.reference import compensate as cp
    room = gen.Room(size=(24.0, 20.0, 8.0),
                    boxes=[((5.0, 4.0, 0.0), (1.0, 1.5, 2.0))])
    traj = gen.OrbitTrajectory(20.0, (3.0, 1.5, 0.9), (1, 2, 1),
                               (0.2, 0.15, 0.3), (2, 1, 3))
    lidar = gen.Lidar(16, 64, -15.0, 15.0, 0.1, 0.5, 70.0,
                      np.asarray([1.0, 0, 0, 0]), np.zeros(3))
    ranges, valid, _ = gen.sweep_ranges(room, traj, lidar, 1.3)
    dirs, _ = lidar.directions()
    pts = gen.sweep_points(dirs, ranges, valid,
                           np.random.default_rng(0), 0.01)
    (p0, q0), (p1, q1) = traj.pose_at(1.3), traj.pose_at(1.4)
    odom = [np.asarray(v, np.float32) for v in (p0, q0, p1, q1)]
    comp = LidarCompensator(SystemConfig(), device="cpu")
    sw = comp.process(1.3, pts, valid)
    full = deskew.deskew_to_end(sw.pts, sw.rel_time,
                                *[torch.as_tensor(v) for v in odom], 0.1)
    spec = dict(n_rings=16, fov_down_deg=-15.0, fov_up_deg=15.0,
                period=0.1, min_range_m=0.5, max_range_m=70.0)
    ref = cp.deskewed(pts, valid, 0.0, odom, spec)
    low = cp.deskewed(pts, valid, 0.0, odom, spec, dtype=dtype_ref)
    return (full, sw.mask, None), ref, low


def test_the_program_deskews_as_the_reference_and_bfloat16_does_not():
    from slambench.reference import compensate as cp
    program, ref, low = _program_sweep(torch.bfloat16)
    assert cp.deskew_gap(program, ref) < 1e-5
    assert cp.deskew_gap(low, ref) > 1e-3
    # a point that one side keeps and the other drops
    pts, mask, _ = program
    mask = mask.clone()
    mask[int(torch.nonzero(ref[1] & (ref[2] > 0.1))[0])] = False
    assert cp.deskew_gap((pts, mask, None), ref) == float("inf")
