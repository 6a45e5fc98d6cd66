"""Batched multi-view triangulation.

Counterpart of ``mvil_fusion_tpu/ops/triangulate.py``
(FeatureManager::triangulate's per-feature SVD loop in the reference): one
batched DLT solve over all landmark slots.  For each feature, stack the
two projection rows of every observing frame (masked), form the 4x4 normal
matrix AᵀA and take its smallest eigenvector with `eigh`.

On a CUDA card `torch.linalg.eigh` waits for the device once, to check
that the solver converged; it is the only wait in this module.
"""

from __future__ import annotations

import torch

from mvil_fusion_torch.utils import lie


def triangulate_window(p_wc: torch.Tensor, q_wc: torch.Tensor,
                       obs: torch.Tensor, mask: torch.Tensor,
                       start: torch.Tensor):
    """Triangulate all features against camera poses.

    Args:
      p_wc, q_wc: (W,3), (W,4) camera poses in world (T_w_c).
      obs: (F,W,2) normalized observations; mask: (F,W) validity.
      start: (F,) start-frame index (depth expressed in that camera).

    Returns (inv_depth (F,), good (F,)): good requires ≥2 views and a
    positive, finite depth in the start frame.
    """
    dtype = obs.dtype

    # camera projection matrices world→cam: R = R_wcᵀ, t = -Rᵀ p
    R_cw = lie.quat_to_mat(q_wc).transpose(-1, -2)            # (W,3,3)
    t_cw = -(R_cw @ p_wc[..., None])[..., 0]                  # (W,3)
    P = torch.cat([R_cw, t_cw[..., None]], dim=-1)            # (W,3,4)

    # DLT rows per (f,w): x*P[2] - P[0], y*P[2] - P[1]
    x = obs[..., 0:1]                                         # (F,W,1)
    y = obs[..., 1:2]
    r0 = x * P[None, :, 2, :] - P[None, :, 0, :]              # (F,W,4)
    r1 = y * P[None, :, 2, :] - P[None, :, 1, :]
    m = mask[..., None].to(dtype)
    A = torch.cat([r0 * m, r1 * m], dim=1)                    # (F,2W,4)
    AtA = A.transpose(-1, -2) @ A                             # (F,4,4)
    _, V = torch.linalg.eigh(AtA)
    X = V[..., 0]                                  # smallest eigvec (F,4)
    w = X[..., 3]
    safe_w = torch.where(w.abs() < 1e-12, 1e-12, w)
    pts = X[..., :3] / safe_w[..., None]           # (F,3) world points

    # depth in the start camera
    R_s = R_cw[start]                                         # (F,3,3)
    t_s = t_cw[start]
    pc = (R_s @ pts[..., None])[..., 0] + t_s
    depth = pc[..., 2]
    n_obs = torch.sum(mask, dim=1)
    good = ((n_obs >= 2) & (depth > 0.1) & (depth < 200.0)
            & torch.isfinite(depth))
    inv_depth = torch.where(good, 1.0 / depth.clamp_min(0.1), 1.0)
    return inv_depth, good


def camera_poses_from_body(p_wb, q_wb, tic, qic):
    """T_w_c = T_w_b ∘ T_b_c for the whole window."""
    p_wc = p_wb + lie.quat_rotate(q_wb, tic.expand_as(p_wb))
    q_wc = lie.quat_normalize(lie.quat_mul(q_wb, qic.expand_as(q_wb)))
    return p_wc, q_wc
