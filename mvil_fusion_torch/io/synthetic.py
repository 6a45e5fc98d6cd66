"""Synthetic ground-truth trajectory (host-side, numpy, float64).

Counterpart of ``mvil_fusion_tpu/io/synthetic.py``, the part the LiDAR
slice needs: ``SyntheticTrajectory`` with its poses, built by the same
arithmetic, so that the same arguments give bit-identical poses.  The IMU
stream and the camera world come with the VIO slice.
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
    """Analytic trajectory: closed-form position, body rate ω, q integrated
    on a fine grid (RK-midpoint) so (q, ω) are exactly consistent."""

    duration: float = 30.0
    dt: float = 5e-4
    # position sinusoid params
    p_amp: tuple = (1.5, 1.2, 0.4)
    p_freq: tuple = (0.23, 0.31, 0.17)
    # body-rate sinusoid params (rad/s)
    w_amp: tuple = (0.25, 0.2, 0.3)
    w_freq: tuple = (0.31, 0.23, 0.11)
    lin_vel: tuple = (0.25, 0.0, 0.0)
    times: np.ndarray = field(init=False)
    p: np.ndarray = field(init=False)
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

    def index_of(self, t):
        return int(round(t / self.dt))

    def pose_at(self, t):
        i = self.index_of(t)
        return self.p[i], self.q[i]
