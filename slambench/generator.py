"""Sensor streams of the benchmark's traffic mixes, made from a seed.

One general generator: a traffic file (``traffic/<name>.json``) names a
trajectory, a room and the sensors' rates and noise; this module turns
them into time-ordered messages.  All host numpy, float64 until a message
is handed over.

The pieces are copies, rewritten for speed, of the port's synthetic
sources (``mvil_fusion_torch/io/synthetic.py`` and ``synthetic_lidar.py``):

- ``HandheldTrajectory`` is ``SyntheticTrajectory`` (closed-form position,
  orientation integrated from a closed-form body rate), turned by a fixed
  mounting rotation;
- ``OrbitTrajectory`` is the hard fixture's closed orbit, with a
  closed-form orientation, so that every lap repeats the first exactly;
- ``Room.ray_range`` is ``BoxWorld.ray_range`` with one origin per ray;
- ``sweep`` casts every ring and azimuth column of a sweep at once (the
  port's ``simulate_sweep`` loops over columns in Python).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


# ------------------------------------------------------------ quaternions

def quat_mul(a, b):
    aw, ax, ay, az = np.moveaxis(np.asarray(a), -1, 0)
    bw, bx, by, bz = np.moveaxis(np.asarray(b), -1, 0)
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def quat_exp(phi):
    phi = np.asarray(phi, np.float64)
    theta = np.linalg.norm(phi, axis=-1, keepdims=True)
    small = theta < 1e-12
    s = np.where(small, 0.5, np.sin(0.5 * theta) / np.where(small, 1.0,
                                                            theta))
    return np.concatenate([np.cos(0.5 * theta), s * phi], axis=-1)


def quat_to_mat(q):
    w, x, y, z = np.moveaxis(np.asarray(q), -1, 0)
    m = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def mat_to_quat(R):
    """Rotation matrix (3,3) → unit quaternion (w, x, y, z), w ≥ 0."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        q = [0.0] * 4
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q = np.asarray(q)
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


# ----------------------------------------------------------- trajectories

class HandheldTrajectory:
    """``SyntheticTrajectory`` of the port's ``io/synthetic.py`` by the
    same arithmetic (``q_mount`` identity gives its arrays), its
    orientation premultiplied by the mounting rotation ``q_mount``."""

    def __init__(self, duration, p_amp, p_freq, w_amp, w_freq, lin_vel,
                 q_mount=(1.0, 0.0, 0.0, 0.0), dt=5e-4, g_norm=9.795):
        self.dt, self.g_norm = dt, g_norm
        n = int(round(duration / dt)) + 1
        t = np.arange(n) * dt
        A, W = np.asarray(p_amp), 2 * np.pi * np.asarray(p_freq)
        L = np.asarray(lin_vel)
        tt = t[:, None]
        self.times = t
        self.p = A * np.sin(W * tt) + L * tt
        self.v = A * W * np.cos(W * tt) + L
        self.a = -A * W * W * np.sin(W * tt)
        wA, wW = np.asarray(w_amp), 2 * np.pi * np.asarray(w_freq)
        self.w = wA * np.sin(wW * tt)
        q = np.zeros((n, 4))
        q[0] = [1, 0, 0, 0]
        dq = quat_exp(0.5 * (self.w[:-1] + self.w[1:]) * dt)
        for k in range(n - 1):
            q[k + 1] = quat_mul(q[k], dq[k])
            q[k + 1] /= np.linalg.norm(q[k + 1])
        self.q = quat_mul(np.asarray(q_mount, float)[None, :], q)

    def index(self, t):
        return np.rint(np.asarray(t) / self.dt).astype(np.int64)

    def pose_at(self, t):
        i = self.index(t)
        return self.p[i], self.q[i]

    def state_at(self, t):
        i = self.index(t)
        return self.p[i], self.q[i], self.v[i]

    def imu_at(self, t):
        """Ideal specific force and body rate at grid times `t`."""
        i = self.index(t)
        R = quat_to_mat(self.q[i])
        f = self.a[i] + np.asarray([0.0, 0.0, self.g_norm])
        return np.einsum("...ji,...j->...i", R, f), self.w[i]


class OrbitTrajectory:
    """The hard fixture's closed orbit (``io/fixture.py::
    record_hard_fixture_bag``: amplitudes (3.0, 1.5, 0.9) m at 1, 2 and 1
    cycles a period), with a closed-form orientation: the mounting
    rotation times exp of a periodic rotation vector whose amplitudes are
    the fixture's body-rate amplitudes over their angular frequencies.
    Every lap repeats the first to the bit."""

    def __init__(self, period, p_amp, p_cycles, w_amp, w_cycles,
                 q_mount=(1.0, 0.0, 0.0, 0.0), center=(0.0, 0.0, 0.0)):
        self.period = float(period)
        self.p_amp = np.asarray(p_amp, float)
        self.p_om = 2 * np.pi * np.asarray(p_cycles, float) / period
        om = 2 * np.pi * np.asarray(w_cycles, float) / period
        self.r_amp = np.asarray(w_amp, float) / om
        self.r_om = om
        self.q_mount = np.asarray(q_mount, float)
        self.center = np.asarray(center, float)

    def pose_at(self, t):
        tt = np.asarray(t, float)[..., None]
        p = self.center + self.p_amp * np.sin(self.p_om * tt)
        phi = self.r_amp * np.sin(self.r_om * tt)
        q = quat_mul(np.broadcast_to(self.q_mount, phi.shape[:-1] + (4,)),
                     quat_exp(phi))
        return p, q


def make_trajectory(spec: dict, duration: float,
                    q_mount=(1.0, 0.0, 0.0, 0.0)):
    """The trajectory a traffic file names, `duration` seconds long (an
    orbit has no end), mounted by `q_mount`."""
    kind = spec["kind"]
    if kind == "handheld":
        return HandheldTrajectory(
            duration + 1.0, spec["p_amp"], spec["p_freq"], spec["w_amp"],
            spec["w_freq"], spec["lin_vel"], q_mount=q_mount)
    if kind == "orbit":
        return OrbitTrajectory(spec["period_s"], spec["p_amp"],
                               spec["p_cycles"], spec["w_amp"],
                               spec["w_cycles"], q_mount=q_mount,
                               center=spec.get("center", (0.0, 0.0, 0.0)))
    raise ValueError(f"unknown trajectory kind {kind!r}")


# ------------------------------------------------------------------ room

@dataclass
class Room:
    """Axis-aligned room centred at the origin, with interior boxes
    (``BoxWorld`` of the port's ``io/synthetic_lidar.py``)."""

    size: tuple
    boxes: list

    def ray_range(self, origin, dirs, max_range=70.0):
        """Smallest positive hit distance of each ray: `origin` (3,) or
        (N,3), `dirs` (N,3) → (N,)."""
        n = dirs.shape[0]
        origin = np.broadcast_to(np.asarray(origin, float), (n, 3))
        t_best = np.full(n, max_range)
        half = np.asarray(self.size) / 2.0
        with np.errstate(divide="ignore", invalid="ignore"):
            for axis in range(3):
                for sgn in (+1.0, -1.0):
                    t = (sgn * half[axis] - origin[:, axis]) / dirs[:, axis]
                    ok = (t > 0.05) & np.isfinite(t)
                    hp = origin + t[:, None] * dirs
                    for other in range(3):
                        if other != axis:
                            ok &= np.abs(hp[:, other]) <= half[other] + 1e-6
                    t_best = np.where(ok & (t < t_best), t, t_best)
            inv = 1.0 / dirs
            for c, h in self.boxes:
                c, h = np.asarray(c), np.asarray(h)
                t0 = (c - h - origin) * inv
                t1 = (c + h - origin) * inv
                tmin = np.minimum(t0, t1).max(axis=1)
                tmax = np.maximum(t0, t1).min(axis=1)
                hit = (tmax > tmin) & (tmin > 0.05)
                t_best = np.where(hit & (tmin < t_best), tmin, t_best)
        return t_best


def make_room(spec: dict) -> Room:
    return Room(size=tuple(spec["size"]),
                boxes=[(tuple(c), tuple(h)) for c, h in spec["boxes"]])


# ---------------------------------------------------------------- sweeps

@dataclass
class Lidar:
    n_rings: int
    n_azimuth: int
    fov_down: float
    fov_up: float
    period: float
    min_range: float
    max_range: float
    q_bl: np.ndarray        # LiDAR orientation in the body frame
    t_bl: np.ndarray        # LiDAR position in the body frame

    def directions(self):
        """(R·A, 3) ray directions in the LiDAR frame, ring-major, the
        azimuth clockwise, as ``simulate_sweep`` orders them; (A,) column
        times from the sweep's start."""
        elev = np.radians(np.linspace(self.fov_down, self.fov_up,
                                      self.n_rings))
        azi = -np.linspace(0, 2 * np.pi, self.n_azimuth, endpoint=False)
        E, A = np.meshgrid(elev, azi, indexing="ij")
        dirs = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A),
                         np.sin(E)], axis=-1).reshape(-1, 3)
        rel = np.linspace(0, self.period, self.n_azimuth, endpoint=False)
        return dirs, rel

    def pose_from_body(self, p_b, q_b):
        """LiDAR poses in the world from body poses (..,3), (..,4)."""
        R = quat_to_mat(q_b)
        p = p_b + np.einsum("...ij,j->...i", R, self.t_bl)
        return p, quat_mul(q_b, np.broadcast_to(self.q_bl, q_b.shape))


def sweep_ranges(room: Room, traj, lidar: Lidar, t_start: float):
    """One motion-distorted sweep without noise: every ray's range from
    the LiDAR's pose at its column's capture time.  Returns (ranges (N,),
    valid (N,), rel_time (N,))."""
    dirs, rel = lidar.directions()
    p_b, q_b = traj.pose_at(t_start + rel)
    p_l, q_l = lidar.pose_from_body(p_b, q_b)
    R = quat_to_mat(q_l)                                  # (A,3,3)
    col = np.tile(np.arange(lidar.n_azimuth), lidar.n_rings)
    d_w = np.einsum("nij,nj->ni", R[col], dirs)
    rng_hit = room.ray_range(p_l[col], d_w, lidar.max_range)
    ok = (rng_hit > lidar.min_range) & (rng_hit < lidar.max_range * 0.999)
    return rng_hit, ok, rel[col]


def sweep_points(dirs, ranges, valid, rng=None, noise=0.0):
    """Points in the LiDAR frame at capture time, with N(0, noise) on
    each valid range; points without a return are zero."""
    r = ranges
    if noise > 0:
        r = r + rng.normal(scale=noise, size=r.shape)
    pts = dirs * r[:, None]
    return np.where(valid[:, None], pts, 0.0).astype(np.float32)
