"""Offline runner CLI: rosbag → full VIL-SLAM system → trajectory files.

Counterpart of ``mvil_fusion_tpu/run.py``: the replacement for the
reference's `roslaunch + rosbag play` workflow (reference: README.md:44-57
runs the released bags through the six-node graph and collects
Frontend/Midend/Backend.txt).  One command:

    python -m mvil_fusion_torch.run --bag X.bag --out /tmp/run_ \\
        [--config cfg.json] [--golden gt_tum.txt] [--threaded] \\
        [--device cpu]

reads the bag (none/bz2/lz4 chunks), drives images through the KLT
tracker, IMU and LiDAR through the estimator and mapping stack, writes the
three trajectory files, and — when a golden/ground-truth TUM file is given
— prints ATE/RPE metrics as one JSON line.  It runs on the card unless
`--device` names another device (the CPU tests pass `--device cpu`); the
reference's `--platform` switch of JAX backends has no counterpart.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.io import rosbag as rb
from mvil_fusion_torch.io.fixture import IMAGE_TOPIC, IMU_TOPIC, LIDAR_TOPIC
from mvil_fusion_torch.pipeline.system import VilSystem
from mvil_fusion_torch.utils import evaluation as ev
from mvil_fusion_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mvil_fusion_torch.run",
        description="Run the VIL-SLAM engine on a rosbag.")
    ap.add_argument("--bag", required=True, help="rosbag v2.0 path")
    ap.add_argument("--out", default="./", help="output prefix for "
                    "Frontend/Midend/Backend.txt")
    ap.add_argument("--config", default=None, help="SystemConfig JSON")
    ap.add_argument("--imu-topic", default=IMU_TOPIC)
    ap.add_argument("--image-topic", default=IMAGE_TOPIC)
    ap.add_argument("--lidar-topic", default=LIDAR_TOPIC)
    ap.add_argument("--golden", default=None,
                    help="ground-truth/golden TUM file; prints ATE/RPE")
    ap.add_argument("--no-mapping", action="store_true",
                    help="VIO+LiDAR odometry only (reference: comment out "
                    "FOR_GLOBAL)")
    ap.add_argument("--save-map", action="store_true",
                    help="write the aggregated global map as <out>Map.npz "
                    "and <out>Map.pcd (the reference's Map.pcd, "
                    "globalMappingIkdTree.cpp:118-131)")
    ap.add_argument("--threaded", action="store_true",
                    help="run stages concurrently on the async pipeline")
    ap.add_argument("--lossless", action="store_true",
                    help="threaded mode: back-pressure instead of shedding "
                    "stale sweeps when mapping lags (offline replays)")
    ap.add_argument("--realtime-budget", action="store_true",
                    help="enforce the per-frame solver wall-clock budget "
                    "(adaptive LM iterations; reference ceres 0.05 s cap)")
    ap.add_argument("--max-sensor-time", type=float, default=None,
                    help="stop after this many seconds of sensor data")
    ap.add_argument("--pace", type=float, default=None,
                    help="threaded only: feed the bag at this many "
                    "sensor-seconds per wall-second (real time = 1.0); "
                    "when the machine cannot keep up, the mapping stage "
                    "sheds stale sweeps exactly like the reference's "
                    "localMapping queue drain (localMapping.cpp:328-332)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (e.g. cpu); default: the "
                    "current CUDA card, an error where there is none")
    return ap


def write_pcd(path: str, pts: np.ndarray):
    """ASCII PCD v0.7 writer (the reference saves Map.pcd via
    pcl::io::savePCDFile, globalMappingIkdTree.cpp:927-946)."""
    n = len(pts)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n"
                "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                f"COUNT 1 1 1\nWIDTH {n}\nHEIGHT 1\n"
                f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n")
        for p in pts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def _paced(messages, pace: float):
    """Yield bag messages at `pace` sensor-seconds per wall-second —
    the real-time feeder of the reference's live ROS graph, sped up or
    slowed by a fixed factor."""
    t_first = None
    wall_first = None
    for kind, t, payload in messages:
        if t_first is None:
            t_first, wall_first = t, time.perf_counter()
        else:
            due = wall_first + (t - t_first) / pace
            lag = due - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
        yield kind, t, payload


def run(args) -> dict:
    device = resolve_device(args.device)
    cfg = (SystemConfig.from_json(args.config) if args.config
           else SystemConfig())
    system = VilSystem(cfg, use_tracker=True,
                       enable_mapping=not args.no_mapping, device=device)
    if getattr(args, "realtime_budget", False):
        system.estimator.enforce_budget = True

    t0 = None
    wall0 = time.perf_counter()
    n_msgs = {"imu": 0, "image": 0, "lidar": 0}

    def feed(kind, t, payload):
        nonlocal t0
        if t0 is None:
            t0 = t
        if args.max_sensor_time is not None and t - t0 > args.max_sensor_time:
            return False
        n_msgs[kind] += 1
        if kind == "imu":
            acc, gyr = payload
            system.process_imu(t, acc, gyr)
        elif kind == "image":
            (img,) = payload
            system.process_image(t, img)
        else:
            (fields,) = payload
            system.process_lidar(t, fields["pts"],
                                 reflectivity=fields.get("intensity"))
        return True

    if args.threaded:
        from mvil_fusion_torch.pipeline.async_system import run_threaded
        messages = rb.play(args.bag, args.imu_topic, args.image_topic,
                           args.lidar_topic)
        pace = getattr(args, "pace", None)
        if pace:
            messages = _paced(messages, pace)
        stats = run_threaded(system, messages,
                             max_sensor_time=args.max_sensor_time,
                             shed_mapping=not getattr(args, "lossless",
                                                      False))
        shed = stats.pop("shed", {})
        n_msgs.update(stats)
        n_msgs["shed"] = shed
    else:
        for kind, t, payload in rb.play(args.bag, args.imu_topic,
                                        args.image_topic, args.lidar_topic):
            if not feed(kind, t, payload):
                break

    wall = time.perf_counter() - wall0
    system.flush()            # drain deferred readbacks (threaded mode)
    system.save_results(args.out)

    result = {
        "wall_s": round(wall, 2),
        "msgs": n_msgs,
        "frontend_poses": len(system.frontend_trajectory()),
        "midend_poses": len(system.midend_trajectory()),
        "backend_poses": len(system.backend_trajectory()),
        "failures": system.estimator.failures,
    }
    if system.estimator.solve_info.get("failure"):
        # metrics of the last failureDetection trip (observability)
        result["last_failure"] = system.estimator.solve_info["failure"]
    if system.global_mapper is not None:
        result["mapping"] = system.global_mapper.mapping_stats()
    if system.estimator.lidar is not None:
        result["lidar_modes"] = list(system.estimator.lidar.mode_counts)
    result["solver"] = {
        "iters": system.estimator._iters_current,
        "budget_overruns": system.estimator.budget_overruns,
        "budget_enforced": system.estimator.enforce_budget,
    }
    if args.save_map and system.global_mapper is not None:
        pts = system.global_mapper.global_map()
        np.savez_compressed(args.out + "Map.npz", points=pts)
        write_pcd(args.out + "Map.pcd", pts)
        result["map_points"] = int(len(pts))
    if system.frontend_trajectory():
        span = (system.frontend_trajectory()[-1][0]
                - system.frontend_trajectory()[0][0])
        result["sensor_sec_per_sec"] = round(span / max(wall, 1e-9), 3)

    if args.golden:
        tg, pg, _ = ev.load_tum(args.golden)
        for name, rows in (("frontend", system.frontend_trajectory()),
                           ("midend", system.midend_trajectory()),
                           ("backend", system.backend_trajectory())):
            if len(rows) < 3:
                continue
            te = np.asarray([r[0] for r in rows])
            pe = np.asarray([np.asarray(r[1]) for r in rows])
            result[f"ate_{name}_m"] = round(
                ev.ate_rmse(te, pe, tg, pg, mode="4dof"), 4)
            result[f"rpe_{name}_m_per_s"] = round(
                ev.rpe_rmse(te, pe, tg, pg, delta=1.0), 4)
    return result


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    result = run(args)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
