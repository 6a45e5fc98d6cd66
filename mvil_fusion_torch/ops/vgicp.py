"""Voxelized GICP registration as a fixed-iteration Gauss-Newton solve.

Counterpart of ``mvil_fusion_tpu/ops/vgicp.py`` (the reference's vendored
fast_gicp FastVGICP: fast_vgicp_impl.hpp, lsq_registration_impl.hpp:13-63).
Instead of per-point k-NN covariances, trees and threads:

  * the target cloud becomes a Gaussian voxel map (one scatter pass);
  * source points inherit the covariance of their *own* cloud's voxel
    (distribution-to-distribution, like VGICP's voxel means);
  * each GN iteration gathers voxel stats, forms Mahalanobis-weighted
    residuals and the 6-dof normal equations, and solves them.

Everything runs in fp32 (``utils/precision.set_fp32_policy``: no TF32) and
nothing waits for the device: the 6×6 solve is ``torch.linalg.solve_ex``,
which skips the host-side check of ``torch.linalg.solve``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvil_fusion_torch.ops import voxel
from mvil_fusion_torch.utils import lie


def _inv3(C: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Closed-form batched symmetric 3x3 inverse (adjugate/det)."""
    C = C + eps * torch.eye(3, dtype=C.dtype, device=C.device)
    a, b, c = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    d, e = C[..., 1, 1], C[..., 1, 2]
    f = C[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    Cc = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * Cc
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    inv = torch.stack([
        torch.stack([A, B, Cc], -1),
        torch.stack([B, D, E], -1),
        torch.stack([Cc, E, F], -1),
    ], -2)
    return inv / det[..., None, None]


class VgicpResult(NamedTuple):
    p: torch.Tensor         # (3,) translation target←source
    q: torch.Tensor         # (4,) rotation
    fitness: torch.Tensor   # mean squared point-to-voxel-mean distance
    n_corr: torch.Tensor    # matched source points (last iteration), int64
    converged: torch.Tensor


def _correspond(src, w_valid, tgt_map, p, q, max_corr_dist):
    """Source points under (p, q), their nearest target voxel among 7, the
    offsets to its mean and which points found one within range."""
    ts = lie.quat_rotate(q[None, :], src) + p[None, :]
    mean_t, cov_t, hit_t = voxel.lookup7(tgt_map, ts)
    d = ts - mean_t
    dist2 = torch.sum(d * d, dim=-1)
    ok = w_valid & hit_t & (dist2 < max_corr_dist * max_corr_dist)
    return d, dist2, cov_t, ok


def vgicp_align(src: torch.Tensor, src_mask: torch.Tensor,
                tgt_map: voxel.GaussianVoxelMap,
                src_map: voxel.GaussianVoxelMap,
                p0: torch.Tensor, q0: torch.Tensor,
                iters: int = 12, max_corr_dist: float = 0.8,
                eps: float = 5e-4) -> VgicpResult:
    """Align source points to the target voxel map, initialized at (p0, q0).

    src_map supplies per-source-point covariances (their own voxel's cov).
    """
    dtype, dev = src.dtype, src.device
    n = src.shape[0]
    _, cov_s, hit_s = voxel.lookup(src_map, src)
    w_valid = src_mask & hit_s
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    skew_src = lie.skew(src)                                  # (N,3,3)

    p, q = p0.to(dtype), q0.to(dtype)
    last_dx = torch.full((), torch.inf, dtype=dtype, device=dev)
    for _ in range(iters):
        R = lie.quat_to_mat(q)
        d, _, cov_t, ok = _correspond(src, w_valid, tgt_map, p, q,
                                      max_corr_dist)
        # fused covariance: C = cov_t + R cov_s Rᵀ; weight W = C⁻¹
        W = _inv3(cov_t + R @ cov_s @ R.T)
        # residual r = ts − mean_t; J wrt [δθ (right), δp]:
        # ∂r/∂δθ = −R [src]× ; ∂r/∂δp = I
        J = torch.cat([-(R @ skew_src), eye3.expand(n, 3, 3)], dim=-1)
        JoT = (J * ok.to(dtype)[:, None, None]).transpose(-1, -2)  # (N,6,3)
        H = (JoT @ (W @ J)).sum(0) + 1e-6 * eye6
        g = -(JoT @ (W @ d[:, :, None])).sum(0)[:, 0]
        dx = torch.linalg.solve_ex(H, g).result
        q = lie.quat_boxplus(q, dx[:3])
        p = p + dx[3:]
        last_dx = torch.linalg.vector_norm(dx)

    # final fitness on the converged pose (pcl-style mean squared distance
    # of matched points — the gate used by the reference's constraint-mode
    # classifier, estimator.cpp:324-436)
    _, d2, _, ok = _correspond(src, w_valid, tgt_map, p, q, max_corr_dist)
    n_corr = ok.sum()
    fitness = torch.where(ok, d2, 0.0).sum() / n_corr.clamp_min(1)
    converged = (last_dx < eps) & (n_corr > 50)
    return VgicpResult(p=p, q=q, fitness=fitness, n_corr=n_corr,
                       converged=converged)
