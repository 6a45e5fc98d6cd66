"""Batched multi-view triangulation.

Counterpart of ``mvil_fusion_tpu/ops/triangulate.py``
(FeatureManager::triangulate's per-feature SVD loop in the reference): one
batched DLT solve over all landmark slots.  For each feature, stack the
two projection rows of every observing frame (masked), form the 4x4 normal
matrix AᵀA and take its smallest eigenvector.

The reference takes that eigenvector with `eigh`.  On a CUDA card
`torch.linalg.eigh` waits for the device to check that it converged, so
here it comes from inverse iteration instead: the inverse of AᵀA + σI by
`cholesky_ex` and two triangular solves, squared a fixed number of times,
and its largest column.  AᵀA is formed and inverted in float64 (in fp32
the rounding of AᵀA, not the eigensolver, limits a low-parallax depth).
Nothing in this module waits for the device.
"""

from __future__ import annotations

import torch

from mvil_fusion_torch.utils import lie

# (AᵀA + σI)⁻¹ is raised to the power 2**_SQUARINGS: the other directions
# shrink by ((λ₁ + σ) / (λ₂ + σ)) ** 2**_SQUARINGS against the smallest
_SQUARINGS = 3
_SHIFT = 1e-12          # σ relative to the trace of AᵀA


def smallest_eigvec(AtA: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of each symmetric
    positive semi-definite (..., n, n) matrix, in float64 (its sign is
    arbitrary).  Batched, and never waits for the device."""
    A = AtA.double()
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    trace = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    sigma = (_SHIFT * trace + 1e-30)[..., None, None]
    L, _ = torch.linalg.cholesky_ex(A + sigma * eye)
    L_inv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    M = L_inv.transpose(-1, -2) @ L_inv                  # (AᵀA + σI)⁻¹
    for _ in range(_SQUARINGS):
        M = M / M.abs().amax(dim=(-2, -1), keepdim=True)
        M = M @ M
    col = torch.linalg.vector_norm(M, dim=-2).argmax(dim=-1)
    X = torch.take_along_dim(M, col[..., None, None].expand(
        M.shape[:-1] + (1,)), dim=-1)[..., 0]
    return X / torch.linalg.vector_norm(X, dim=-1, keepdim=True)


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

    # DLT rows per (f,w): x*P[2] - P[0], y*P[2] - P[1], in float64
    P64 = P.double()
    x = obs[..., 0:1].double()                                # (F,W,1)
    y = obs[..., 1:2].double()
    r0 = x * P64[None, :, 2, :] - P64[None, :, 0, :]          # (F,W,4)
    r1 = y * P64[None, :, 2, :] - P64[None, :, 1, :]
    m = mask[..., None].double()
    A = torch.cat([r0 * m, r1 * m], dim=1)                    # (F,2W,4)
    AtA = A.transpose(-1, -2) @ A                             # (F,4,4)
    X = smallest_eigvec(AtA).to(dtype)             # (F,4)
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
