"""Batched camera models (project / unproject) in PyTorch.

Counterpart of ``mvil_fusion_tpu/frontend/camera.py``, model for model
(the reference's vendored camodocal `camera_model` package:
PinholeCamera, CataCamera, EquidistantCamera, ScaramuzzaCamera;
`liftProjective` / `spaceToPlane` are the hot calls).  All functions are
batched over leading dims and run on the device of their input;
undistortion uses a fixed-iteration fixed-point solve, so nothing waits
for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeRadtan(NamedTuple):
    """Pinhole + radial-tangential distortion (reference PinholeCamera.cc;
    the model used by both released configs)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def distort(self, xy):
        """Normalized ideal coords → distorted normalized coords."""
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        rad = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        xd = x * rad + 2 * self.p1 * x * y + self.p2 * (r2 + 2 * x * x)
        yd = y * rad + self.p1 * (r2 + 2 * y * y) + 2 * self.p2 * x * y
        return torch.stack([xd, yd], dim=-1)

    def space_to_plane(self, pts):
        """3-D camera-frame points → pixel coords (spaceToPlane)."""
        z = pts[..., 2:3]
        safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        xy = pts[..., :2] / safe_z
        d = self.distort(xy)
        u = self.fx * d[..., 0] + self.cx
        v = self.fy * d[..., 1] + self.cy
        return torch.stack([u, v], dim=-1)

    def lift_projective(self, uv, iters: int = 8):
        """Pixels → normalized undistorted coords (liftProjective):
        fixed-point inverse distortion, matching the recursive
        distortion-inverse of PinholeCamera::liftProjective."""
        xd = torch.stack([(uv[..., 0] - self.cx) / self.fx,
                        (uv[..., 1] - self.cy) / self.fy], dim=-1)
        x = xd
        for _ in range(iters):
            d = self.distort(x) - x          # distortion offset at estimate
            x = xd - d
        return x

    def pixel_velocity_to_normalized(self, uv_vel):
        return torch.stack([uv_vel[..., 0] / self.fx,
                          uv_vel[..., 1] / self.fy], dim=-1)


class Mei(NamedTuple):
    """MEI (catadioptric/omni) model (reference CataCamera.cc)."""

    xi: float
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def _distort(self, xy):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        rad = self.k1 * r2 + self.k2 * r2 * r2
        dx = x * rad + 2 * self.p1 * x * y + self.p2 * (r2 + 2 * x * x)
        dy = y * rad + self.p1 * (r2 + 2 * y * y) + 2 * self.p2 * x * y
        return torch.stack([dx, dy], dim=-1)

    def space_to_plane(self, pts):
        n = torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
        zxi = pts[..., 2:3] + self.xi * n
        safe = torch.where(torch.abs(zxi) < 1e-9, 1e-9, zxi)
        xy = pts[..., :2] / safe
        d = xy + self._distort(xy)
        u = self.fx * d[..., 0] + self.cx
        v = self.fy * d[..., 1] + self.cy
        return torch.stack([u, v], dim=-1)

    def lift_projective(self, uv, iters: int = 8):
        xd = torch.stack([(uv[..., 0] - self.cx) / self.fx,
                        (uv[..., 1] - self.cy) / self.fy], dim=-1)
        x = xd
        for _ in range(iters):
            x = xd - self._distort(x)
        # undo the unit-sphere projection (CataCamera::liftProjective)
        r2 = torch.sum(x * x, dim=-1, keepdim=True)
        xi = self.xi
        disc = 1.0 + (1.0 - xi * xi) * r2
        lam = (xi + torch.sqrt(disc.clamp_min(0.0))) / (1.0 + r2)
        z = lam - xi
        safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        return lam * x / safe_z


class Equidistant(NamedTuple):
    """Kannala-Brandt equidistant fisheye (reference EquidistantCamera.cc)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0

    def _theta_d(self, theta):
        t2 = theta * theta
        return theta * (1.0 + self.k2 * t2 + self.k3 * t2 ** 2
                        + self.k4 * t2 ** 3 + self.k5 * t2 ** 4)

    def space_to_plane(self, pts):
        r = torch.linalg.vector_norm(pts[..., :2], dim=-1)
        theta = torch.atan2(r, pts[..., 2])
        td = self._theta_d(theta)
        safe_r = torch.where(r < 1e-9, 1e-9, r)
        u = self.fx * td * pts[..., 0] / safe_r + self.cx
        v = self.fy * td * pts[..., 1] / safe_r + self.cy
        return torch.stack([u, v], dim=-1)

    def lift_projective(self, uv, iters: int = 10):
        xd = torch.stack([(uv[..., 0] - self.cx) / self.fx,
                        (uv[..., 1] - self.cy) / self.fy], dim=-1)
        td = torch.linalg.vector_norm(xd, dim=-1)
        theta = td
        for _ in range(iters):   # Newton on theta_d(theta) = td
            f = self._theta_d(theta) - td
            t2 = theta * theta
            fp = (1.0 + 3 * self.k2 * t2 + 5 * self.k3 * t2 ** 2
                  + 7 * self.k4 * t2 ** 3 + 9 * self.k5 * t2 ** 4)
            theta = theta - f / torch.where(torch.abs(fp) < 1e-9, 1e-9, fp)
        safe_td = torch.where(td < 1e-9, 1e-9, td)
        scale = torch.tan(theta) / safe_td
        return xd * scale[..., None]


class Scaramuzza(NamedTuple):
    """Scaramuzza omnidirectional polynomial model (reference
    ScaramuzzaCamera.cc).  z = poly(ρ) with ρ the image-plane radius;
    projection inverts the polynomial with damped Newton (static trip count)
    instead of requiring fitted inverse-poly coefficients."""

    cx: float
    cy: float
    poly: tuple            # (a0, a1, a2, ...): z = Σ a_k ρ^k
    c: float = 1.0         # affine [c d; e 1]
    d: float = 0.0
    e: float = 0.0

    def _poly(self, rho):
        z = torch.zeros_like(rho)
        for k, a in enumerate(self.poly):
            z = z + a * rho ** k
        return z

    def _dpoly(self, rho):
        z = torch.zeros_like(rho)
        for k, a in enumerate(self.poly):
            if k >= 1:
                z = z + k * a * rho ** (k - 1)
        return z

    def lift_projective(self, uv):
        mx = uv[..., 0] - self.cx
        my = uv[..., 1] - self.cy
        inv_det = 1.0 / (self.c - self.d * self.e)
        x = inv_det * (mx - self.d * my)
        y = inv_det * (-self.e * mx + self.c * my)
        rho = torch.sqrt(x * x + y * y)
        z = self._poly(rho)
        # normalized plane coords (z forward; Scaramuzza's poly gives -z for
        # forward points: flip to the camera convention)
        safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        return torch.stack([x / -safe, y / -safe], dim=-1)

    def space_to_plane(self, pts, iters: int = 12):
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        r_xy = torch.sqrt(x * x + y * y)
        safe_rxy = r_xy.clamp_min(1e-9)
        # solve poly(ρ)·r_xy = -z·ρ for ρ (Newton)
        rho = torch.full_like(r_xy, 1.0)
        for _ in range(iters):
            f = self._poly(rho) * safe_rxy + z * rho
            fp = self._dpoly(rho) * safe_rxy + z
            fp = torch.where(torch.abs(fp) < 1e-9, 1e-9, fp)
            rho = (rho - f / fp).clamp(0.0, 1e4)
        xi = x / safe_rxy * rho
        yi = y / safe_rxy * rho
        u = self.c * xi + self.d * yi + self.cx
        v = self.e * xi + yi + self.cy
        return torch.stack([u, v], dim=-1)


def from_config(cfg):
    """Build the camera from a CameraConfig: the factory dispatch over all
    four models (reference CameraFactory.cc)."""
    if cfg.model == "pinhole":
        return PinholeRadtan(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
                             k1=cfg.k1, k2=cfg.k2, p1=cfg.p1, p2=cfg.p2)
    if cfg.model == "mei":
        return Mei(xi=cfg.xi, fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
                   k1=cfg.k1, k2=cfg.k2, p1=cfg.p1, p2=cfg.p2)
    if cfg.model == "equidistant":
        return Equidistant(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
                           k2=cfg.k2, k3=cfg.k3, k4=cfg.k4, k5=cfg.k5)
    if cfg.model == "scaramuzza":
        return Scaramuzza(cx=cfg.cx, cy=cfg.cy, poly=tuple(cfg.poly),
                          c=cfg.aff_c, d=cfg.aff_d, e=cfg.aff_e)
    raise NotImplementedError(f"camera model {cfg.model}")
