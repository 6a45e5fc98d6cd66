"""Synthetic ground-truth world (host-side, numpy, float64).

Counterpart of ``mvil_fusion_tpu/io/synthetic.py``: ``SyntheticTrajectory``
with its poses, velocities and ideal IMU stream, and ``SyntheticWorld``
with its landmarks, their projection and a rendered mono image, built by
the same arithmetic, so that the same arguments give bit-identical arrays.

Conventions match the estimator: world gravity G = [0,0,g] (z up), the
IMU measures specific force a_m = Rᵀ(ẍ + G) and body rate ω; dynamics
v̇ = R a_m − G.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _quat_mul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def _quat_exp(phi):
    theta = np.linalg.norm(phi, axis=-1, keepdims=True)
    small = theta < 1e-12
    half = 0.5 * theta
    w = np.cos(half)
    s = np.where(small, 0.5, np.sin(half) / np.where(small, 1.0, theta))
    return np.concatenate([w, s * phi], axis=-1)


def _quat_to_mat(q):
    w, x, y, z = np.moveaxis(q, -1, 0)
    m = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


@dataclass
class SyntheticTrajectory:
    """Analytic trajectory: closed-form p/v/a, body rate ω, q integrated on a
    fine grid (RK-midpoint) so (q, ω) are exactly consistent."""

    duration: float = 30.0
    dt: float = 5e-4
    g_norm: float = 9.795
    # position sinusoid params
    p_amp: tuple = (1.5, 1.2, 0.4)
    p_freq: tuple = (0.23, 0.31, 0.17)
    # body-rate sinusoid params (rad/s)
    w_amp: tuple = (0.25, 0.2, 0.3)
    w_freq: tuple = (0.31, 0.23, 0.11)
    lin_vel: tuple = (0.25, 0.0, 0.0)
    times: np.ndarray = field(init=False)
    p: np.ndarray = field(init=False)
    v: np.ndarray = field(init=False)
    a: np.ndarray = field(init=False)
    q: np.ndarray = field(init=False)
    w: np.ndarray = field(init=False)

    def __post_init__(self):
        n = int(round(self.duration / self.dt)) + 1
        t = np.arange(n) * self.dt
        A = np.asarray(self.p_amp)
        W = 2 * np.pi * np.asarray(self.p_freq)
        L = np.asarray(self.lin_vel)
        self.times = t
        tt = t[:, None]
        self.p = A * np.sin(W * tt) + L * tt
        self.v = A * W * np.cos(W * tt) + L
        self.a = -A * W * W * np.sin(W * tt)
        wA = np.asarray(self.w_amp)
        wW = 2 * np.pi * np.asarray(self.w_freq)
        self.w = wA * np.sin(wW * tt)  # body rate, closed form
        # integrate orientation: q_{k+1} = q_k ⊗ exp(ω_mid dt)
        q = np.zeros((n, 4))
        q[0] = [1, 0, 0, 0]
        w_mid = 0.5 * (self.w[:-1] + self.w[1:])
        dq = _quat_exp(w_mid * self.dt)
        for k in range(n - 1):
            q[k + 1] = _quat_mul(q[k], dq[k])
            q[k + 1] /= np.linalg.norm(q[k + 1])
        self.q = q

    @property
    def gravity(self):
        return np.array([0.0, 0.0, self.g_norm])

    def index_of(self, t):
        return int(round(t / self.dt))

    def pose_at(self, t):
        i = self.index_of(t)
        return self.p[i], self.q[i]

    def state_at(self, t):
        i = self.index_of(t)
        return self.p[i], self.q[i], self.v[i]

    def imu_at(self, t):
        """Ideal IMU sample (specific force, body rate) at grid time t."""
        i = self.index_of(t)
        R = _quat_to_mat(self.q[i])
        acc = R.T @ (self.a[i] + self.gravity)
        return acc, self.w[i]

    def imu_sequence(self, t0, t1, rate_hz, ba=None, bg=None,
                     noise_acc=0.0, noise_gyr=0.0, rng=None):
        """Sample IMU between t0 and t1 at rate_hz (grid-snapped).

        Returns (acc (N,3), gyr (N,3), dt (N,) with dt[k] = t[k+1]-t[k],
        dt[-1] = 0, times (N,)).
        """
        ba = np.zeros(3) if ba is None else np.asarray(ba)
        bg = np.zeros(3) if bg is None else np.asarray(bg)
        step = 1.0 / rate_hz
        ts = np.arange(t0, t1 + 0.5 * step, step)
        ts = np.clip(ts, 0, self.times[-1])
        accs, gyrs = [], []
        for t in ts:
            acc, gyr = self.imu_at(t)
            accs.append(acc + ba)
            gyrs.append(gyr + bg)
        acc = np.asarray(accs)
        gyr = np.asarray(gyrs)
        if rng is not None and (noise_acc > 0 or noise_gyr > 0):
            acc = acc + rng.normal(scale=noise_acc, size=acc.shape)
            gyr = gyr + rng.normal(scale=noise_gyr, size=gyr.shape)
        dts = np.zeros(len(ts))
        dts[:-1] = np.diff(ts)
        return acc, gyr, dts, ts


@dataclass
class SyntheticWorld:
    """Trajectory + landmarks for camera simulation."""

    traj: SyntheticTrajectory = field(default_factory=SyntheticTrajectory)
    n_landmarks: int = 400
    landmark_radius: float = 12.0
    seed: int = 0
    landmarks: np.ndarray = field(init=False)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # landmarks in a shell around the trajectory volume
        pts = rng.uniform(-1, 1, size=(self.n_landmarks, 3))
        pts /= np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-9)
        r = rng.uniform(0.35 * self.landmark_radius, self.landmark_radius,
                        size=(self.n_landmarks, 1))
        self.landmarks = pts * r + self.traj.p.mean(axis=0)

    def project(self, t, ric, tic, fx=460.0, fy=460.0, cx=320.0, cy=240.0,
                width=640, height=480, min_depth=0.2):
        """Project landmarks into the camera at time t.

        ric/tic: camera-in-IMU extrinsics (R maps cam→imu).
        Returns (uv (N,2), normalized (N,2), depth (N,), visible (N,) bool).
        """
        p_wb, q_wb = self.traj.pose_at(t)
        R_wb = _quat_to_mat(q_wb)
        R_wc = R_wb @ ric
        p_wc = R_wb @ tic + p_wb
        pc = (self.landmarks - p_wc) @ R_wc  # (N,3) in camera frame
        z = pc[:, 2]
        ok = z > min_depth
        zs = np.where(ok, z, 1.0)
        xn = pc[:, 0] / zs
        yn = pc[:, 1] / zs
        u = fx * xn + cx
        v = fy * yn + cy
        vis = ok & (u >= 0) & (u < width) & (v >= 0) & (v < height)
        return (np.stack([u, v], -1), np.stack([xn, yn], -1), z, vis)

    def render_image(self, t, ric, tic, fx=460.0, fy=460.0, cx=320.0,
                     cy=240.0, width=640, height=480, dot_sigma=1.8,
                     background=24.0):
        """Render a trackable mono image at time t: Gaussian dots at the
        projected landmarks over a flat background.

        Gives the KLT front end (CLAHE → LK → RANSAC → refill) real pixels
        whose ground-truth geometry is known."""
        uv, _, z, vis = self.project(t, ric, tic, fx=fx, fy=fy, cx=cx,
                                     cy=cy, width=width, height=height)
        img = np.full((height, width), background, np.float32)
        # stable per-landmark brightness (id-hash) so dots are distinguishable
        amp = 120.0 + 120.0 * ((np.arange(len(self.landmarks)) * 2654435761)
                               % 997) / 997.0
        r = int(np.ceil(3 * dot_sigma))
        ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
        for i in np.nonzero(vis)[0]:
            u, v = uv[i]
            iu, iv = int(round(u)), int(round(v))
            du, dv = u - iu, v - iv
            patch = amp[i] * np.exp(-((xs - du) ** 2 + (ys - dv) ** 2)
                                    / (2 * dot_sigma ** 2))
            y0, y1 = iv - r, iv + r + 1
            x0, x1 = iu - r, iu + r + 1
            py0, px0 = max(0, -y0), max(0, -x0)
            y0, x0 = max(0, y0), max(0, x0)
            y1, x1 = min(height, y1), min(width, x1)
            if y1 <= y0 or x1 <= x0:
                continue
            img[y0:y1, x0:x1] += patch[py0:py0 + (y1 - y0),
                                       px0:px0 + (x1 - x0)]
        return np.clip(img, 0.0, 255.0)
