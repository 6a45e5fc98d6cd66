"""Synthetic LiDAR sweeps: ray-cast a box room (+ interior boxes) from a
moving sensor, with per-point capture times for motion-distortion tests.

Counterpart of ``mvil_fusion_tpu/io/synthetic_lidar.py``, by the same
arithmetic: the same world, trajectory and arguments give bit-identical
sweeps.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mvil_fusion_torch.io.synthetic import SyntheticTrajectory, _quat_to_mat


@dataclass
class BoxWorld:
    """Axis-aligned room centered at origin + optional interior boxes."""

    room: tuple = (24.0, 20.0, 6.0)       # full extents (x, y, z)
    boxes: list = field(default_factory=lambda: [
        # (center, half-extents)
        ((5.0, 4.0, 0.0), (1.0, 1.5, 2.0)),
        ((-6.0, -3.0, -0.5), (2.0, 1.0, 1.5)),
        ((2.0, -6.0, 0.0), (1.2, 1.2, 2.5)),
    ])

    def ray_range(self, origin: np.ndarray, dirs: np.ndarray,
                  max_range: float = 70.0) -> np.ndarray:
        """Smallest positive hit distance per ray (N,3) → (N,)."""
        n = dirs.shape[0]
        t_best = np.full(n, max_range)
        # room interior: hit the inside of the walls (planes x=±hx …)
        half = np.asarray(self.room) / 2.0
        for axis in range(3):
            for sgn in (+1.0, -1.0):
                denom = dirs[:, axis]
                with np.errstate(divide="ignore", invalid="ignore"):
                    t = (sgn * half[axis] - origin[axis]) / denom
                ok = (t > 0.05) & np.isfinite(t)
                # hit point must be within the wall rectangle
                hp = origin[None, :] + t[:, None] * dirs
                for other in range(3):
                    if other == axis:
                        continue
                    ok &= np.abs(hp[:, other]) <= half[other] + 1e-6
                t_best = np.where(ok & (t < t_best), t, t_best)
        # interior boxes: slab test, nearest positive entry
        for (c, h) in self.boxes:
            c = np.asarray(c)
            h = np.asarray(h)
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / dirs
            t0 = (c - h - origin) * inv
            t1 = (c + h - origin) * inv
            tmin = np.minimum(t0, t1).max(axis=1)
            tmax = np.maximum(t0, t1).min(axis=1)
            hit = (tmax > tmin) & (tmin > 0.05)
            t_best = np.where(hit & (tmin < t_best), tmin, t_best)
        return t_best


def simulate_sweep(world: BoxWorld, traj: SyntheticTrajectory,
                   t_start: float, scan_period: float = 0.1,
                   n_rings: int = 16, n_azimuth: int = 900,
                   fov_up: float = 15.0, fov_down: float = -15.0,
                   min_range: float = 0.5, max_range: float = 70.0,
                   rng=None, noise: float = 0.0):
    """One motion-distorted sweep.

    Returns dict with:
      pts:      (N,3) points in the sensor frame at each CAPTURE time
      rel_time: (N,)
      ring:     (N,)
      mask:     (N,) valid returns
      pts_true_end: (N,3) ground-truth deskewed points (sensor frame at
                    sweep end) for validation.
    """
    elev = np.radians(np.linspace(fov_down, fov_up, n_rings))
    azi = -np.linspace(0, 2 * np.pi, n_azimuth, endpoint=False)  # clockwise
    rel = np.linspace(0, scan_period, n_azimuth, endpoint=False)

    E, A = np.meshgrid(elev, azi, indexing="ij")          # (R, Az)
    REL = np.broadcast_to(rel[None, :], E.shape)
    RING = np.broadcast_to(np.arange(n_rings)[:, None], E.shape)
    dirs_sensor = np.stack([np.cos(E) * np.cos(A),
                            np.cos(E) * np.sin(A),
                            np.sin(E)], axis=-1).reshape(-1, 3)
    rel_time = REL.reshape(-1)
    ring = RING.reshape(-1)

    pts = np.zeros_like(dirs_sensor)
    pts_world = np.zeros_like(dirs_sensor)
    mask = np.zeros(len(dirs_sensor), bool)
    # group by capture time for efficiency (one pose per azimuth column)
    p_end, q_end = traj.pose_at(t_start + scan_period)
    R_end = _quat_to_mat(q_end)
    pts_true_end = np.zeros_like(dirs_sensor)

    for j in range(n_azimuth):
        t = t_start + rel[j]
        p_w, q_w = traj.pose_at(t)
        R_w = _quat_to_mat(q_w)
        sel = np.nonzero(REL.reshape(-1) == rel[j])[0]
        d_w = dirs_sensor[sel] @ R_w.T
        rng_hit = world.ray_range(p_w, d_w, max_range)
        ok = (rng_hit > min_range) & (rng_hit < max_range * 0.999)
        if noise > 0 and rng is not None:
            rng_hit = rng_hit + rng.normal(scale=noise, size=rng_hit.shape)
        # sensor-frame point at capture time
        pts[sel] = dirs_sensor[sel] * rng_hit[:, None]
        mask[sel] = ok
        # ground truth in end frame: world point → end sensor frame
        pw = p_w[None, :] + d_w * rng_hit[:, None]
        pts_world[sel] = pw
        pts_true_end[sel] = (pw - p_end[None, :]) @ R_end

    return dict(pts=pts.astype(np.float32),
                rel_time=rel_time.astype(np.float32),
                ring=ring.astype(np.int32), mask=mask,
                pts_true_end=pts_true_end.astype(np.float32),
                pts_world=pts_world.astype(np.float32),
                t_start=t_start, t_end=t_start + scan_period)
