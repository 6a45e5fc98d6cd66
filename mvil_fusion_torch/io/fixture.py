"""Fixture rosbag recorder: a realistic synthetic VIL sequence in real
sensor_msgs encodings.

Counterpart of ``mvil_fusion_tpu/io/fixture.py``: the same arguments record
the same bytes, from the port's own synthetic worlds and bag writer.

The reference's released bags (README.md:44-57) cannot be fetched in this
environment, so this records their stand-in: 200 Hz sensor_msgs/Imu,
30 Hz mono8 sensor_msgs/Image (rendered landmark dots), and 10 Hz
sensor_msgs/PointCloud2 sweeps with 16-ring LeiShen geometry, rolling
capture times (motion distortion) and a reflectivity intensity channel —
the same topics/encodings `run.py` consumes from a real bag.

Everything is deterministic (seeded) so the recorded bag doubles as a
regression fixture; ground truth is written alongside in TUM format.
"""

from __future__ import annotations

import numpy as np

from mvil_fusion_torch.io import rosbag as rb
from mvil_fusion_torch.io.synthetic import SyntheticTrajectory, SyntheticWorld
from mvil_fusion_torch.io.synthetic_lidar import BoxWorld, simulate_sweep
from mvil_fusion_torch.utils.evaluation import save_tum

IMU_TOPIC = "/mynteye/imu/data_raw"
IMAGE_TOPIC = "/mynteye/left/image_mono"
LIDAR_TOPIC = "/lslidar_point_cloud"

FIXTURE_FX, FIXTURE_FY = 460.0, 460.0
FIXTURE_CX, FIXTURE_CY = 320.0, 240.0


def fixture_config(fx: float = FIXTURE_FX, fy: float = FIXTURE_FY,
                   cx: float = FIXTURE_CX, cy: float = FIXTURE_CY):
    """SystemConfig matching the fixture's sensor rig: ideal 460-focal
    pinhole, identity camera-IMU and lidar-IMU extrinsics, zero td (the
    analog of the per-bag YAML the reference ships per sensor rig)."""
    from mvil_fusion_torch.config import (CameraConfig, EstimatorConfig,
                                        LidarConfig, SystemConfig)
    return SystemConfig(
        camera=CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy,
                            k1=0.0, k2=0.0, p1=0.0, p2=0.0),
        estimator=EstimatorConfig(
            ric=(1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0),
            tic=(0.0, 0.0, 0.0), td_init=0.0,
            estimate_extrinsic=0, estimate_td=False),
        lidar=LidarConfig(
            rlb=(1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0),
            tlb=(0.0, 0.0, 0.0)),
    )


def surface_reflectivity(pw: np.ndarray) -> np.ndarray:
    """Deterministic world-anchored reflectivity field: banded pattern over
    position so intensity is consistent between revisits (what the LOAM
    intensity machinery exploits)."""
    return (110.0 + 60.0 * np.sin(1.7 * pw[:, 0])
            + 45.0 * np.cos(2.3 * pw[:, 1]) + 25.0 * np.sin(3.1 * pw[:, 2]))


def record_fixture_bag(path: str, duration: float = 12.0,
                       imu_hz: float = 200.0, image_hz: float = 30.0,
                       lidar_hz: float = 10.0, n_azimuth: int = 720,
                       seed: int = 0, compression: str = "bz2",
                       gt_path: str | None = None,
                       imu_noise: bool = True,
                       width: int = 640, height: int = 480,
                       fx: float | None = None, fy: float | None = None,
                       cx: float | None = None, cy: float | None = None):
    """Record the fixture bag; returns the SyntheticWorld used."""
    fx = FIXTURE_FX if fx is None else fx
    fy = FIXTURE_FY if fy is None else fy
    cx = FIXTURE_CX if cx is None else cx
    cy = FIXTURE_CY if cy is None else cy
    rng = np.random.default_rng(seed)
    traj = SyntheticTrajectory(duration=duration + 0.5,
                               w_amp=(0.45, 0.4, 0.5),
                               w_freq=(0.37, 0.29, 0.43),
                               p_amp=(1.3, 1.1, 0.4),
                               p_freq=(0.31, 0.37, 0.21))
    world = SyntheticWorld(traj=traj, n_landmarks=600, landmark_radius=8.0)
    box = BoxWorld()

    w = rb.BagWriter(path, compression=compression)
    w.add_connection(IMU_TOPIC, "sensor_msgs/Imu")
    w.add_connection(IMAGE_TOPIC, "sensor_msgs/Image")
    w.add_connection(LIDAR_TOPIC, "sensor_msgs/PointCloud2")

    ric = np.eye(3)
    tic = np.zeros(3)

    # IMU
    acc_n = 0.02 if imu_noise else 0.0
    gyr_n = 0.004 if imu_noise else 0.0
    acc, gyr, _, ts = traj.imu_sequence(0.0, duration, imu_hz,
                                        noise_acc=acc_n, noise_gyr=gyr_n,
                                        rng=rng)
    for k in range(len(ts)):
        w.write(IMU_TOPIC, ts[k], rb.encode_imu(ts[k], acc[k], gyr[k]))

    # images (ideal pinhole at the fixture intrinsics)
    for t in np.arange(0.2, duration, 1.0 / image_hz):
        img = world.render_image(t, ric, tic, fx=fx, fy=fy, cx=cx, cy=cy,
                                 width=width, height=height)
        w.write(IMAGE_TOPIC, t, rb.encode_image(t, img))

    # lidar sweeps (points in sensor frame at capture time + reflectivity)
    scan_period = 1.0 / lidar_hz
    for t in np.arange(0.25, duration - scan_period, scan_period):
        s = simulate_sweep(box, traj, t, scan_period=scan_period,
                           n_azimuth=n_azimuth, rng=rng, noise=0.01)
        inten = surface_reflectivity(s["pts_world"])
        inten = np.where(s["mask"], inten, 0.0).astype(np.float32)
        pts = np.where(s["mask"][:, None], s["pts"], 0.0)
        w.write(LIDAR_TOPIC, t, rb.encode_pointcloud2(t, pts, inten))
    w.close()

    if gt_path is not None:
        rows = []
        for t in np.arange(0.0, duration, 0.02):
            p, q = traj.pose_at(t)
            rows.append((t, p, q))
        save_tum(gt_path, rows)
    return world


def record_hard_fixture_bag(path: str, duration: float = 45.0,
                            imu_hz: float = 200.0, image_hz: float = 12.0,
                            lidar_hz: float = 4.0, n_azimuth: int = 360,
                            seed: int = 0, compression: str = "lz4",
                            gt_path: str | None = None):
    """The HARD regression fixture: a long multi-floor trajectory with
    exact revisits, so the full loop-closure machinery must fire (radius +
    ScanContext candidates, floor bands, z-driven graph refreshes, and —
    at reduced graph caps — capacity eviction).

    The closed orbit has xy/z period = duration/2, so the second half of
    the run re-traverses the first half's poses exactly: every late
    keyed scan has a same-floor early neighbor within the proximity gate
    (reference loop machinery: globalMappingIkdTree.cpp:300-312,434-510).
    Used with checked-in expected metrics (tests/data/
    hard_fixture_expected.json) as the accuracy ledger."""
    rng = np.random.default_rng(seed)
    period = duration / 2.0
    traj = SyntheticTrajectory(duration=duration + 0.5,
                               p_amp=(3.0, 1.5, 0.9),
                               p_freq=(1.0 / period, 2.0 / period,
                                       1.0 / period),
                               w_amp=(0.2, 0.15, 0.3),
                               w_freq=(2.0 / period, 1.0 / period,
                                       3.0 / period),
                               lin_vel=(0.0, 0.0, 0.0))
    world = SyntheticWorld(traj=traj, n_landmarks=900,
                           landmark_radius=10.0)
    box = BoxWorld(room=(24.0, 20.0, 8.0))

    w = rb.BagWriter(path, compression=compression)
    w.add_connection(IMU_TOPIC, "sensor_msgs/Imu")
    w.add_connection(IMAGE_TOPIC, "sensor_msgs/Image")
    w.add_connection(LIDAR_TOPIC, "sensor_msgs/PointCloud2")
    ric, tic = np.eye(3), np.zeros(3)
    acc, gyr, _, ts = traj.imu_sequence(0.0, duration, imu_hz,
                                        noise_acc=0.02, noise_gyr=0.004,
                                        rng=rng)
    for k in range(len(ts)):
        w.write(IMU_TOPIC, ts[k], rb.encode_imu(ts[k], acc[k], gyr[k]))
    for t in np.arange(0.2, duration, 1.0 / image_hz):
        img = world.render_image(t, ric, tic, fx=FIXTURE_FX, fy=FIXTURE_FY,
                                 cx=FIXTURE_CX, cy=FIXTURE_CY,
                                 width=640, height=480)
        w.write(IMAGE_TOPIC, t, rb.encode_image(t, img))
    scan_period = 1.0 / lidar_hz
    for t in np.arange(0.25, duration - scan_period, scan_period):
        s = simulate_sweep(box, traj, t, scan_period=scan_period,
                           n_azimuth=n_azimuth, rng=rng, noise=0.01)
        inten = surface_reflectivity(s["pts_world"])
        inten = np.where(s["mask"], inten, 0.0).astype(np.float32)
        pts = np.where(s["mask"][:, None], s["pts"], 0.0)
        w.write(LIDAR_TOPIC, t, rb.encode_pointcloud2(t, pts, inten))
    w.close()

    if gt_path is not None:
        rows = []
        for t in np.arange(0.0, duration, 0.02):
            p, q = traj.pose_at(t)
            rows.append((t, p, q))
        save_tum(gt_path, rows)
    return world
