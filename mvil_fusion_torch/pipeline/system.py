"""Full VIL-SLAM system: one deterministic pipeline.

Counterpart of ``mvil_fusion_tpu/pipeline/system.py``: the reference's six
ROS processes and their topic graph (SURVEY.md §1) as one single-process
pipeline:

  image  ──► FeatureTracker ──► VIOEstimator (window BA) ──► trajectory
  imu    ───────────────────────────┤  ▲     │
  lidar  ──► LidarCompensator ──────┘  │     ├─► deskewed cloud ─► DepthRegister
                                       │     │        (lidar-aided feature depth)
             LPS feedback ◄────────────┘     ├─► LOAM features ─► LocalMapper
                                             │                        │ submaps
             GlobalMapper ◄───────────────────────────────────────────┘
                (pose graph + loops)  → /laser_localizer → estimator LPS

Every hop that was a serialized ROS message is an in-process value;
sensor timestamps order the calls.  Every stage runs on the system's
device, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.estimator.vio import VIOEstimator
from mvil_fusion_torch.frontend.depth_register import DepthRegister
from mvil_fusion_torch.frontend.feature_tracker import FeatureTracker
from mvil_fusion_torch.frontend.lidar_compensator import LidarCompensator
from mvil_fusion_torch.mapping.global_mapping import GlobalMapper
from mvil_fusion_torch.mapping.local_mapping import LocalMapper
from mvil_fusion_torch.utils import nplie
from mvil_fusion_torch.utils.device import resolve_device


GRID_AZ = 1024


class VilSystem:
    """Config 3/4 of BASELINE.json: indoor/outdoor full SLAM."""

    def __init__(self, cfg: SystemConfig, use_tracker: bool = False,
                 enable_mapping: bool = True,
                 device: torch.device | str | None = None):
        """`device` None is the current CUDA device (a RuntimeError where
        there is no card); a CPU caller passes ``device="cpu"``."""
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.estimator = VIOEstimator(cfg, device=dev)
        self.estimator.enable_lidar()
        self.tracker = FeatureTracker(cfg, device=dev) if use_tracker \
            else None
        self.compensator = LidarCompensator(cfg, device=dev)
        self.depth_register = DepthRegister(cfg, device=dev)
        self.local_mapper = LocalMapper(cfg, device=dev) if enable_mapping \
            else None
        self.global_mapper = GlobalMapper(cfg, device=dev) \
            if enable_mapping else None
        self.lidar_sweep_count = 0
        # sweeps waiting for the VIO window to cover their time span (the
        # reference's l_buf: the lidar thread holds clouds until fresh
        # odometry brackets them, estimator_node.cpp:338-376)
        self._pending_sweeps: list = []

    # ----------------------------------------------------------- sensors

    def process_imu(self, t: float, acc, gyr):
        self.estimator.process_imu(t, acc, gyr)

    def process_features(self, t: float, ids, norm, vel):
        """Direct feature injection (when an external tracker is used)."""
        depth = self._feature_depths(t, norm, np.ones(len(ids), bool))
        self.estimator.process_features(t, ids, norm, vel, depth)
        self._pump_lidar()

    def process_image(self, t: float, img: np.ndarray):
        if self.tracker is None:
            raise RuntimeError("VilSystem built without a tracker "
                               "(use_tracker=False)")
        frame = self.tracker.process(t, img)
        if frame is None:
            return
        ids = frame.ids[frame.valid]
        norm = frame.norm[frame.valid]
        vel = frame.vel[frame.valid]
        depth = self._feature_depths(t, norm, np.ones(len(ids), bool))
        self.estimator.process_features(t, ids, norm, vel, depth)
        self._pump_lidar()

    def _camera_pose_host(self):
        """T_w_c from the estimator's host pose cache (one frame stale by
        design: a fresh fetch would wait for the card).  Before a solve
        has filled the cache (after initialization in deferred mode, after
        a reboot) it reads the estimator's window state, which the
        threaded pipeline writes on another stage's thread and stream: the
        state is taken with the event after its last write, and the read
        waits for that event on this thread's stream."""
        est = self.estimator
        cached = est.last_pose_host
        if cached is not None:
            p_b, q_b, tic, qic = cached
        else:
            k = min(est.frame_count, est.W - 1)
            s, written = est.state_ready
            if written is not None:
                torch.cuda.current_stream(s.p.device).wait_event(written)
            p_b = s.p[k].cpu().numpy()
            q_b = s.q[k].cpu().numpy()
            tic = s.tic.cpu().numpy()
            qic = s.qic.cpu().numpy()
        q_c = nplie.quat_mul(q_b, qic)
        q_c = (q_c / np.linalg.norm(q_c)).astype(np.float32)
        p_c = (np.asarray(p_b)
               + nplie.quat_to_mat(q_b) @ np.asarray(tic)).astype(np.float32)
        return p_c, q_c

    def _feature_depths_device(self, t, norm_dev, valid_dev):
        """Enqueue-only depth lookup on full-capacity DEVICE feature
        tensors: a device (N,) depth tensor, or None when no cloud is
        live."""
        if not self.depth_register.clouds:
            return None
        p_c, q_c = self._camera_pose_host()
        return self.depth_register.get_depth_device(t, norm_dev, valid_dev,
                                                    p_c, q_c)

    def flush(self):
        """Drain every deferred readback (end of stream): lidar sweep pack,
        estimator pack, local-mapping pack (may emit a final submap)."""
        if self.estimator.lidar is not None:
            self.estimator.lidar._harvest_pack()
        self.estimator.flush()
        if self.local_mapper is not None:
            sm = self.local_mapper.flush()
            if sm is not None and self.global_mapper is not None:
                info = self.global_mapper.add_submap(sm)
                self.estimator.process_lps(info["t"], info["p"], info["q"])

    def _feature_depths(self, t, norm, valid):
        """LiDAR-aided feature depth (the reference's DepthRegister path,
        feature_tracker_node.cpp:252-337), at the pose the estimator read
        back with its last solve."""
        if not self.depth_register.clouds:
            return None
        p_c, q_c = self._camera_pose_host()
        # a static feature capacity: the lookup's shapes stay the same
        # from frame to frame
        n = len(norm)
        cap = max(self.cfg.tracker.max_features_pad, n)
        norm_p = np.zeros((cap, 2), np.float32)
        norm_p[:n] = norm
        valid_p = np.zeros(cap, bool)
        valid_p[:n] = valid
        depth = self.depth_register.get_depth(t, norm_p, valid_p, p_c, q_c)
        return depth[:n]

    def process_lidar(self, t_start: float, pts: np.ndarray,
                      valid: np.ndarray | None = None,
                      reflectivity: np.ndarray | None = None):
        """One raw sweep through compensator → estimator → mapping.

        reflectivity: optional per-point sensor intensity; carried through
        the LOAM chain (the reference's mapping nodes keep the original
        intensity channel)."""
        sweep = self.compensator.process(t_start, pts, valid)
        self.lidar_sweep_count += 1
        self._pending_sweeps.append((sweep, reflectivity))
        res = None
        for sweep_, out, refl in self._drain_sweeps():
            self._register_depth_cloud(out)
            res = self._map_lidar(sweep_, out, refl)
        return res

    def _drain_sweeps(self):
        """Process every buffered sweep the VIO window now covers; drop
        sweeps that fell off the window (the reference's stale-cloud
        load-shedding)."""
        est = self.estimator
        done = []
        if est.status != est.NON_LINEAR or est.lidar is None:
            self._pending_sweeps = self._pending_sweeps[-5:]
            return done
        n_t = min(len(est.times), est.W)
        times = est.times[:n_t]
        if not times:
            return done
        period = self.cfg.lidar.scan_period
        keep = []
        for sweep, refl in self._pending_sweeps:
            t_end = sweep.t_start + period
            if sweep.t_start < times[0]:
                continue                      # stale — drop
            if t_end > times[-1]:
                keep.append((sweep, refl))    # too new — wait for frames
                continue
            out = est.process_lidar(sweep.t_start, sweep.pts,
                                    sweep.rel_time, sweep.mask)
            if out is not None:
                done.append((sweep, out, refl))
        self._pending_sweeps = keep
        return done

    def _pump_lidar(self):
        """Drain newly-bracketed sweeps after the window advanced."""
        for sweep_, out, refl in self._drain_sweeps():
            self._register_depth_cloud(out)
            self._map_lidar(sweep_, out, refl)

    def _register_depth_cloud(self, out):
        """Deskewed cloud → depth register (every 2nd sweep ≈ 5 Hz,
        feature_tracker_node.cpp:255); it stays on the device."""
        if self.lidar_sweep_count % 2 == 0:
            self.depth_register.add_cloud(out["t_end"], out["pts"],
                                          out["mask"], out["p_l"],
                                          out["q_l"])

    def _map_lidar(self, sweep, out, reflectivity=None, lps_sink=None):
        """Post-estimator LiDAR path: LOAM feature extraction + local/
        global mapping, with the localizer's pose fed back to the estimator
        (the threaded pipeline runs this on the mapping stage; `lps_sink`
        redirects the localizer feedback into a channel instead of calling
        into the estimator from another thread)."""
        if self.local_mapper is None:
            return out
        lc = self.cfg.lidar
        lm = self.cfg.local_mapping
        inten = None if (reflectivity is None or not lm.use_intensity) \
            else np.asarray(reflectivity, np.float32)
        sm = self.local_mapper.process_full(
            out["t_end"], out["full_pts"], sweep.ring, sweep.rel_time,
            out["full_mask"], inten, out["p_l"], out["q_l"],
            n_rings=lc.n_rings, n_azimuth=GRID_AZ,
            scan_period=lc.scan_period)
        if sm is not None and self.global_mapper is not None:
            info = self.global_mapper.add_submap(sm)
            # LPS feedback (the /laser_localizer → estimator loop)
            if lps_sink is None:
                self.estimator.process_lps(info["t"], info["p"], info["q"])
            else:
                lps_sink((info["t"], info["p"], info["q"]))
        return out

    # ------------------------------------------------------------ outputs

    def frontend_trajectory(self):
        return self.estimator.trajectory

    def midend_trajectory(self):
        return self.local_mapper.trajectory if self.local_mapper else []

    def backend_trajectory(self):
        return self.global_mapper.trajectory() if self.global_mapper else []

    def save_results(self, prefix: str):
        """Write Frontend/Midend/Backend.txt (TUM format) like the
        reference's result files (SURVEY.md §4)."""
        def dump(path, rows):
            with open(path, "w") as f:
                for row in rows:
                    t, p, q = row[0], row[1], row[2]
                    f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                            f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")

        dump(prefix + "Frontend.txt",
             [(t, p, q) for (t, p, q, *_) in self.estimator.trajectory])
        if self.local_mapper:
            dump(prefix + "Midend.txt", self.local_mapper.trajectory)
        if self.global_mapper:
            dump(prefix + "Backend.txt", self.global_mapper.trajectory())
        # online extrinsic stream (reference ex_results.txt,
        # estimator_node.cpp:312-336): t, cam-IMU ypr+t, lidar-IMU ypr+t, td
        with open(prefix + "ex_results.txt", "w") as f:
            for t, vi_ypr, vi_t, li_ypr, li_t, td in self.estimator.ex_results:
                vals = [*vi_ypr, *vi_t, *li_ypr, *li_t, td]
                f.write(f"{t:.6f} " + " ".join(f"{v:.6f}" for v in vals)
                        + "\n")
