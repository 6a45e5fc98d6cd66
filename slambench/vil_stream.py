"""The sensor stream of the VIL odometry cells: what the ``vils_estimator``
node receives, made from a seed.

A traffic file (``traffic/<name>.json``) names the orbit and the room of
``generator.py``, the rig's attitude on the orbit (``q_mount``: the body
(IMU) frame in the world at zero rotation), and the sensors' rates and
noise; the configuration gives the published camera, IMU and LiDAR and
their mounting (``ric``/``tic``, ``rlb``/``tlb``).  All host numpy,
float64 until a message is handed over.

- **IMU** at the configuration's rate: the orbit's specific force and
  body rate in closed form (the orbit's orientation is exp of a periodic
  rotation vector, so the body rate is its right Jacobian times the
  vector's rate), with white noise at the yaml's ``acc_n``/``gyr_n`` on
  every sample and biases that random-walk from zero at
  ``acc_w``/``gyr_w`` per √s.
- **Features** at the tracker's rate: the projections of fixed landmarks
  on the room's surfaces (walls, floor, ceiling and the boxes' faces, at
  a density from the traffic) into the published pinhole, seen where in
  front, inside the image and not occluded; a track persists while its
  landmark stays visible and is replaced when lost, new tracks taken in
  an order drawn from the seed at least ``min_dist`` px from every other,
  up to ``max_cnt`` a frame (the KLT node's behaviour); Gaussian pixel
  noise on every observation, and each track's normalized-plane velocity
  as the tracker reports it.  Frames are stamped on the camera's clock,
  ``td_init`` before the IMU's.
- **LiDAR**: ``generator.sweep_ranges`` sweeps of the configuration's
  C16 from the LiDAR's pose (the body's, through the mounting: upright,
  its spin axis the rig's vertical), range
  noise from the seed.  The orbit repeats every lap, so one lap of
  noiseless sweeps is cast once (`cast_lap`) and each sent sweep gets
  fresh noise.

`messages()` yields ``(arrival time, kind, payload)`` in arrival order:
IMU samples at their time, a frame at its IMU-clock time after the IMU
samples up to it, a sweep at its end.
"""

from __future__ import annotations

import numpy as np

from slambench import generator as gen


def right_jacobian(phi):
    """The right Jacobian of SO(3) at rotation vectors phi (..., 3)."""
    th = np.linalg.norm(phi, axis=-1)[..., None, None]
    K = np.zeros(phi.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = (-phi[..., 2], phi[..., 1],
                                                -phi[..., 0])
    K[..., 1, 0], K[..., 2, 0], K[..., 2, 1] = (phi[..., 2], -phi[..., 1],
                                                phi[..., 0])
    small = th < 1e-8
    ths = np.where(small, 1.0, th)
    a = np.where(small, 0.5, (1 - np.cos(ths)) / ths ** 2)
    b = np.where(small, 1.0 / 6.0, (ths - np.sin(ths)) / ths ** 3)
    return np.eye(3) - a * K + b * (K @ K)


def orbit_imu(traj, t, g_norm):
    """Ideal (specific force, body rate) of an ``OrbitTrajectory`` at
    times t (N,): (N,3), (N,3)."""
    tt = np.asarray(t, float)[:, None]
    acc_w = -traj.p_amp * traj.p_om ** 2 * np.sin(traj.p_om * tt)
    phi = traj.r_amp * np.sin(traj.r_om * tt)
    dphi = traj.r_amp * traj.r_om * np.cos(traj.r_om * tt)
    w_b = np.einsum("nij,nj->ni", right_jacobian(phi), dphi)
    _, q = traj.pose_at(t)
    R = gen.quat_to_mat(q)
    f = acc_w + np.asarray([0.0, 0.0, g_norm])
    return np.einsum("nji,nj->ni", R, f), w_b


def orbit_velocity(traj, t):
    tt = np.asarray(t, float)[..., None]
    return traj.p_amp * traj.p_om * np.cos(traj.p_om * tt)


def surface_landmarks(room, density, rng):
    """Points drawn uniformly on the room's six faces and on every face of
    its boxes, `density` per m² (their total count from the seed)."""
    pts = []

    def faces(center, half, inward):
        c, h = np.asarray(center, float), np.asarray(half, float)
        for axis in range(3):
            for sgn in (-1.0, 1.0):
                u, v = [a for a in range(3) if a != axis]
                area = 4 * h[u] * h[v]
                n = rng.poisson(density * area)
                p = np.empty((n, 3))
                p[:, axis] = c[axis] + sgn * h[axis] * \
                    (1 - 1e-6 if inward else 1 + 1e-6)
                p[:, u] = c[u] + rng.uniform(-h[u], h[u], n)
                p[:, v] = c[v] + rng.uniform(-h[v], h[v], n)
                pts.append(p)

    faces((0.0, 0.0, 0.0), np.asarray(room.size) / 2.0, True)
    for c, h in room.boxes:
        faces(c, h, False)
    return np.concatenate(pts)


class VilStream:
    """The stream of one run, made from `seed`: IMU, feature frames and
    sweeps from ``t = 0`` (the IMU's clock) to the traffic's
    ``stream_s``."""

    def __init__(self, conf: dict, traffic: dict, seed: int):
        sysc, sensor = conf["system"], conf["sensor"]
        est, imu, cam = sysc["estimator"], sysc["imu"], sysc["camera"]
        trk, lid = sysc["tracker"], sensor["lidar"]
        self.seed = seed
        self.traj = gen.make_trajectory(traffic["trajectory"], 0.0,
                                        q_mount=traffic["q_mount"])
        self.room = gen.make_room(traffic["room"])
        self.g_norm = imu["g_norm"]
        self.td = float(est["td_init"])
        # the camera in the body: R_bc, t_bc (ric maps camera to IMU)
        self.R_bc = np.asarray(est["ric"], float).reshape(3, 3)
        self.t_bc = np.asarray(est["tic"], float)
        self.cam = dict(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"],
                        cy=cam["cy"], w=cam["width"], h=cam["height"])
        # the LiDAR in the body: the configuration's rlb/tlb are the
        # yaml's body in the LiDAR (R^l_b, t^l_b, named as ric/tic are),
        # so the LiDAR sits at R^b_l = rlbᵀ, t^b_l = -rlbᵀ tlb: p_l = p_b
        # + R_b t^b_l, q_l = q_b ⊗ quat(R^b_l)
        rlb = np.asarray(sysc["lidar"]["rlb"], float).reshape(3, 3)
        tlb = np.asarray(sysc["lidar"]["tlb"], float)
        self.period = 1.0 / lid["rate_hz"]
        self.lidar = gen.Lidar(
            lid["n_rings"], lid["n_azimuth"], lid["fov_down_deg"],
            lid["fov_up_deg"], self.period, lid["min_range_m"],
            lid["max_range_m"], gen.mat_to_quat(rlb.T), -rlb.T @ tlb)
        self.range_noise = lid["range_noise_m"]
        self.dirs, _ = self.lidar.directions()
        self.t_end = float(traffic["stream_s"])
        self.n_lap = int(round(traffic["trajectory"]["period_s"]
                               / self.period))
        self.first_sweep = float(traffic["first_sweep_s"])
        self.lap = None

        # IMU: every sample of the stream at once
        rate = imu["rate_hz"]
        n = int(round(self.t_end * rate)) + 1
        self.imu_t = np.arange(n) / rate
        acc, gyr = orbit_imu(self.traj, self.imu_t, self.g_norm)
        rng = np.random.default_rng([seed, 10])
        dt = 1.0 / rate
        self.ba = np.cumsum(rng.normal(scale=imu["acc_w"] * np.sqrt(dt),
                                       size=(n, 3)), axis=0)
        self.bg = np.cumsum(rng.normal(scale=imu["gyr_w"] * np.sqrt(dt),
                                       size=(n, 3)), axis=0)
        self.acc = acc + self.ba + rng.normal(scale=imu["acc_n"],
                                              size=(n, 3))
        self.gyr = gyr + self.bg + rng.normal(scale=imu["gyr_n"],
                                              size=(n, 3))

        # frames on the IMU's clock: one every `imu_per_frame` samples
        self.imu_per_frame = int(round(rate / trk["freq"]))
        self.frame_imu = np.arange(self.imu_per_frame, n,
                                   self.imu_per_frame)
        self.max_cnt, self.min_dist = trk["max_cnt"], trk["min_dist"]
        self.pixel_noise = traffic["features"]["pixel_noise_px"]
        self.landmarks = surface_landmarks(
            self.room, traffic["features"]["landmarks_per_m2"],
            np.random.default_rng([seed, 11]))
        self._feat_rng = np.random.default_rng([seed, 12])
        self._tracks: dict = {}           # id -> landmark
        self._prev: dict = {}             # id -> (norm, t)
        self._next_id = 0
        self._frames: list = []

    # ------------------------------------------------------------- truth

    def frame_time(self, k):
        """Frame k's time on the IMU's clock."""
        return float(self.imu_t[self.frame_imu[k]])

    def body_pose(self, t):
        """The body's true (p, q) at IMU-clock time t."""
        return self.traj.pose_at(t)

    # ------------------------------------------------------------ camera

    def _visible(self, t):
        """Landmarks seen at time t: (indices, normalized coordinates,
        pixel coordinates)."""
        p_b, q_b = self.traj.pose_at(t)
        R_b = gen.quat_to_mat(q_b)
        R_wc = R_b @ self.R_bc
        p_wc = p_b + R_b @ self.t_bc
        rel = self.landmarks - p_wc
        pc = rel @ R_wc
        z = pc[:, 2]
        c = self.cam
        ok = z > 0.2
        zs = np.where(ok, z, 1.0)
        x, y = pc[:, 0] / zs, pc[:, 1] / zs
        u, v = c["fx"] * x + c["cx"], c["fy"] * y + c["cy"]
        ok &= (u >= 0) & (u < c["w"]) & (v >= 0) & (v < c["h"])
        idx = np.nonzero(ok)[0]
        dist = np.linalg.norm(rel[idx], axis=1)
        hit = self.room.ray_range(p_wc, rel[idx] / dist[:, None],
                                  max_range=dist.max() + 1.0 if len(idx)
                                  else 1.0)
        seen = hit >= dist - 0.02
        idx = idx[seen]
        return idx, np.stack([x[idx], y[idx]], -1), \
            np.stack([u[idx], v[idx]], -1)

    def frame(self, k):
        """Feature frame k (made in order, as a tracker would): (camera
        stamp, ids (N,), norm (N,2) float32, vel (N,2) float32, seen
        landmarks (N,))."""
        while len(self._frames) <= k:
            self._frames.append(self._make_frame(len(self._frames)))
        return self._frames[k]

    def _make_frame(self, k):
        t = self.frame_time(k)
        idx, norm, uv = self._visible(t)
        where = {int(lm): j for j, lm in enumerate(idx)}
        kept = [(fid, lm) for fid, lm in self._tracks.items()
                if lm in where]
        taken = [uv[where[lm]] for _, lm in kept]
        tracked = {lm for _, lm in kept}
        order = self._feat_rng.permutation(len(idx))
        d2 = self.min_dist ** 2
        for j in order:
            if len(kept) >= self.max_cnt:
                break
            lm = int(idx[j])
            if lm in tracked:
                continue
            if taken and np.min(np.sum((np.asarray(taken) - uv[j]) ** 2,
                                       axis=1)) < d2:
                continue
            kept.append((self._next_id, lm))
            taken.append(uv[j])
            tracked.add(lm)
            self._next_id += 1
        self._tracks = dict(kept)
        rng = self._feat_rng
        ids = np.asarray([fid for fid, _ in kept], np.int64)
        lms = np.asarray([lm for _, lm in kept], np.int64)
        n = np.asarray([norm[where[lm]] for lm in lms]).reshape(-1, 2)
        c = self.cam
        n = n + rng.normal(size=n.shape) * (self.pixel_noise
                                            / np.asarray([c["fx"], c["fy"]]))
        vel = np.zeros_like(n)
        for j, fid in enumerate(ids):
            prev = self._prev.get(int(fid))
            if prev is not None:
                vel[j] = (n[j] - prev[0]) / (t - prev[1])
        self._prev = {int(fid): (n[j], t) for j, fid in enumerate(ids)}
        return (t - self.td, ids, n.astype(np.float32),
                vel.astype(np.float32), lms)

    # ------------------------------------------------------------- LiDAR

    def sweep_start(self, s):
        return self.first_sweep + s * self.period

    def cast_lap(self):
        """Cast one lap of noiseless sweeps (the orbit repeats them)."""
        if self.lap is None:
            self.lap = [gen.sweep_ranges(self.room, self.traj, self.lidar,
                                         self.sweep_start(s))
                        for s in range(self.n_lap)]

    def sweep(self, s):
        """(pts (N,3) float32, rel_time (N,), valid (N,)) of sweep s, in
        the LiDAR's frame at each point's capture time."""
        self.cast_lap()
        ranges, valid, rel = self.lap[s % self.n_lap]
        pts = gen.sweep_points(self.dirs, ranges, valid,
                               np.random.default_rng([self.seed, 13, s]),
                               self.range_noise)
        return pts, rel, valid

    def lidar_pose(self, p_b, q_b):
        """The LiDAR's (p, q) from the body's."""
        return self.lidar.pose_from_body(np.asarray(p_b, float),
                                         np.asarray(q_b, float))

    # ---------------------------------------------------------- messages

    def messages(self):
        """(arrival time, kind, payload) in arrival order: ("imu", (t,
        acc, gyr)), ("frame", k), ("sweep", s)."""
        n_frames = len(self.frame_imu)
        k, s = 0, 0
        for i, t in enumerate(self.imu_t):
            yield t, "imu", (float(t), self.acc[i].astype(np.float32),
                             self.gyr[i].astype(np.float32))
            if k < n_frames and self.frame_imu[k] == i:
                yield t, "frame", k
                k += 1
            while self.sweep_start(s) + self.period <= t + 1e-9:
                yield self.sweep_start(s) + self.period, "sweep", s
                s += 1
