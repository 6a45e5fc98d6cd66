"""LOAM scan-to-map registration: edge (point-to-line) and plane
(point-to-plane) correspondences + Gauss-Newton on SE(3).

Counterpart of ``mvil_fusion_tpu/ops/loam_icp.py``.  k-NN runs through
``ops/knn_topk.py`` (the CUDA kernel on the card); line fits are closed-form
sym3 eigen decompositions, plane fits a closed-form 3×3 adjugate solve; the
outer (re-associate) × inner (Gauss-Newton) iterations are Python loops.
Nothing here reads a tensor back to the host, so a sweep's work queues on
the device without a sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvil_fusion_torch.ops.knn_topk import knn_topk
from mvil_fusion_torch.ops.voxel import sym3_eigvals, sym3_eigvec
from mvil_fusion_torch.utils import lie


def _solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3×3 solve via the adjugate (closed form; the plane gates
    downstream are sensitive to the solve's rounding, so this keeps the
    reference's exact arithmetic)."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = (A[..., 0, 0] * c00 + A[..., 0, 1] * c10 + A[..., 0, 2] * c20)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, float("inf"), det)
    x0 = (c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]) * inv_det
    x1 = (c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]) * inv_det
    x2 = (c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


def knn(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor,
        k: int):
    """Brute-force k-NN: (Nq,3) vs (Nr,3) → (idx (Nq,k), d2 (Nq,k)).  The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    return knn_topk(query.contiguous(), ref.contiguous(),
                    ref_mask.contiguous(), k)


class Correspondences(NamedTuple):
    """Precomputed geometric targets for one GN stage."""

    edge_pt: torch.Tensor      # (Ne,3) source corner points (sensor frame)
    edge_a: torch.Tensor       # (Ne,3) line point A (world)
    edge_b: torch.Tensor       # (Ne,3) line point B (world)
    edge_ok: torch.Tensor      # (Ne,)
    plane_pt: torch.Tensor     # (Np,3)
    plane_n: torch.Tensor      # (Np,3) unit normal (world)
    plane_d: torch.Tensor      # (Np,) plane offset: n·x + d = 0
    plane_ok: torch.Tensor     # (Np,)


def find_correspondences(corner_src, corner_mask, surf_src, surf_mask,
                         corner_map, corner_map_mask, surf_map,
                         surf_map_mask, p, q,
                         max_corr_dist: float = 1.0,
                         k_edge: int = 5, k_surf: int = 5,
                         surf_i=None, surf_map_i=None,
                         k_surf_knn: int = 10
                         ) -> Correspondences:
    """Associate transformed source features with map lines/planes.

    Edges need the 5-NN cluster to be line-like (λ2 > 3λ1); planes need a
    consistent LSQ plane fit.  When surf intensities are given, the plane
    fit uses the `k_surf` most reflectivity-similar of the `k_surf_knn`
    nearest map points.
    """
    dtype = corner_src.dtype
    cw = lie.quat_rotate(q[None, :], corner_src) + p[None, :]
    sw = lie.quat_rotate(q[None, :], surf_src) + p[None, :]
    gate = max_corr_dist * max_corr_dist
    # device constants come from kernels, never from a host list: copying
    # one to a card would wait for the stream
    eye = torch.eye(3, dtype=dtype, device=cw.device)

    # ---- edges
    eidx, ed2 = knn(cw, corner_map, corner_map_mask, k_edge)
    near_ok = ed2[:, -1] < gate
    nbr = corner_map[eidx.long()]                            # (Ne,k,3)
    ctr = torch.mean(nbr, dim=1, keepdim=True)
    dc = nbr - ctr
    cov = torch.einsum("nki,nkj->nij", dc, dc) / k_edge
    lam0, lam1, lam2 = sym3_eigvals(cov)                 # closed form
    dir_ = sym3_eigvec(cov, lam0, lam1, eye[0])    # main axis, else x
    line_like = lam2 > 3.0 * lam1
    a = ctr[:, 0, :] + 0.1 * dir_
    b = ctr[:, 0, :] - 0.1 * dir_
    edge_ok = corner_mask & near_ok & line_like & torch.isfinite(ed2[:, -1])

    # ---- planes
    if surf_i is not None and surf_map_i is not None:
        sidx10, sd2_10 = knn(sw, surf_map, surf_map_mask, k_surf_knn)
        sidx10 = sidx10.long()
        # distance gate on the k_surf-th nearest, then keep the k_surf most
        # intensity-similar neighbors for the fit
        snear = sd2_10[:, k_surf - 1] < gate
        di = torch.abs(surf_map_i[sidx10] - surf_i[:, None])     # (Np,10)
        di = torch.where(torch.isfinite(sd2_10), di, float("inf"))
        _, sel = torch.topk(-di, k_surf, dim=1)                  # (Np,k)
        sidx = torch.take_along_dim(sidx10, sel, dim=1)
        sd2 = torch.take_along_dim(sd2_10, sel, dim=1)
    else:
        sidx, sd2 = knn(sw, surf_map, surf_map_mask, k_surf)
        sidx = sidx.long()
        snear = sd2[:, -1] < gate
    snbr = surf_map[sidx]                                    # (Np,k,3)
    # LSQ plane: N·x = -1 (A-LOAM formulation), trace-relative ridge for
    # f32 robustness on near-collinear clusters
    ones = -torch.ones((snbr.shape[0], k_surf, 1), dtype=dtype,
                       device=snbr.device)
    AtA = torch.einsum("nki,nkj->nij", snbr, snbr)
    Atb = torch.einsum("nki,nkl->nil", snbr, ones)[..., 0]
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    ridge = (1e-5 * tr + 1e-6) * eye
    n_raw = _solve3x3(AtA + ridge, Atb)
    finite_n = torch.isfinite(n_raw).all(dim=-1)
    n_raw = torch.where(finite_n[:, None], n_raw, 1.0)
    norm = torch.linalg.vector_norm(n_raw, dim=-1, keepdim=True)
    n_unit = n_raw / norm.clamp_min(1e-9)
    d_plane = 1.0 / norm[..., 0].clamp_min(1e-9)
    d_plane = torch.where(torch.isfinite(d_plane), d_plane, 0.0)
    # fit validity: all neighbors within 0.2 of the plane AND the cluster is
    # genuinely planar, not a single scan-line
    dist_nb = torch.abs(torch.einsum("nki,ni->nk", snbr, n_unit)
                        + d_plane[:, None])
    plane_fit_ok = torch.all(dist_nb < 0.2, dim=1)
    sctr = torch.mean(snbr, dim=1, keepdim=True)
    sdc = snbr - sctr
    scov = torch.einsum("nki,nkj->nij", sdc, sdc) / k_surf
    slam0, slam1, _ = sym3_eigvals(scov)                 # closed form
    planar = slam1 > torch.clamp_min(10.0 * slam0, 1e-4)
    plane_ok = (surf_mask & snear & plane_fit_ok & planar & finite_n
                & torch.isfinite(sd2[:, -1]))

    return Correspondences(edge_pt=corner_src, edge_a=a, edge_b=b,
                           edge_ok=edge_ok, plane_pt=surf_src,
                           plane_n=n_unit, plane_d=d_plane,
                           plane_ok=plane_ok)


def _huber_w(a: torch.Tensor, huber_delta: float) -> torch.Tensor:
    return torch.where(a <= huber_delta, 1.0,
                       torch.sqrt(huber_delta / a.clamp_min(1e-12)))


def _residuals(corr: Correspondences, p, q, huber_delta: float = 0.1):
    """Per-correspondence residuals + Huber weights at pose (p,q).

    Edge residual is A-LOAM's smooth 3-vector cross/‖ab‖; plane residual is
    n·x + d.  Huber weights are IRLS weights: constants of the
    linearisation.
    """
    pe = lie.quat_rotate(q[None, :], corr.edge_pt) + p[None, :]
    ab = corr.edge_b - corr.edge_a
    pa = pe - corr.edge_a
    cross = torch.linalg.cross(pa, ab, dim=-1)
    r_edge3 = cross / torch.linalg.vector_norm(
        ab, dim=-1, keepdim=True).clamp_min(1e-9)            # (Ne,3)
    ps = lie.quat_rotate(q[None, :], corr.plane_pt) + p[None, :]
    r_plane = torch.einsum("ni,ni->n", ps, corr.plane_n) + corr.plane_d

    e_norm = torch.sqrt(torch.sum(r_edge3 * r_edge3, dim=-1) + 1e-12)
    we = _huber_w(e_norm, huber_delta) * corr.edge_ok.to(p.dtype)
    wp = _huber_w(torch.abs(r_plane), huber_delta) * \
        corr.plane_ok.to(p.dtype)
    return r_edge3, we, r_plane, wp


def _gn_system(corr: Correspondences, p, q):
    """Weighted residual r and its analytic jacobian J (rows: 3 per edge,
    then 1 per plane; columns: δθ then δp) at δ = 0 of the right
    perturbation (p + δp, q ⊗ exp(δθ)).

    d/dδθ R(q ⊗ exp(δθ)) x = −R [x]×, so a world point's jacobian is
    [−R[x]×, I]; the edge residual is (x_w − a) × ab / ‖ab‖, whose
    derivative in x_w is −[ab]× / ‖ab‖; the plane residual n·x_w + d has
    derivative nᵀ.  The Huber weights scale rows and are held constant."""
    re3, we, rp, wp = _residuals(corr, p, q)
    R = lie.quat_to_mat(q)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)

    def point_jac(x):                                 # (N,3,6)
        rot = -R[None] @ lie.skew(x)
        return torch.cat([rot, eye.expand(x.shape[0], 3, 3)], dim=-1)

    ab = corr.edge_b - corr.edge_a
    inv_ab = 1.0 / torch.linalg.vector_norm(ab, dim=-1).clamp_min(1e-9)
    dres = -lie.skew(ab) * inv_ab[:, None, None]      # (Ne,3,3)
    Je = (dres @ point_jac(corr.edge_pt)) * we[:, None, None]
    Jp = (corr.plane_n[:, None, :] @ point_jac(corr.plane_pt))[:, 0, :] \
        * wp[:, None]
    r = torch.cat([(re3 * we[:, None]).reshape(-1), rp * wp])
    J = torch.cat([Je.reshape(-1, 6), Jp], dim=0)
    return r, J


def scan_to_map(corner_src, corner_mask, surf_src, surf_mask,
                corner_map, corner_map_mask, surf_map, surf_map_mask,
                p0, q0, outer_iters: int = 2, gn_iters: int = 4,
                max_corr_dist: float = 1.0,
                surf_i=None, surf_map_i=None):
    """Full LOAM scan-to-map alignment (outer: re-associate; inner: GN).

    Runs in fp32 (call utils.precision.set_fp32_policy on a CUDA card).
    Returns device tensors (p, q, n_edge, n_plane, mean_res); nothing is
    read back to the host.
    """
    dtype = corner_src.dtype
    eye6 = torch.eye(6, dtype=dtype, device=corner_src.device)
    ikw = dict(surf_i=surf_i, surf_map_i=surf_map_i)
    p, q = p0, q0
    for _ in range(outer_iters):
        corr = find_correspondences(
            corner_src, corner_mask, surf_src, surf_mask,
            corner_map, corner_map_mask, surf_map, surf_map_mask,
            p, q, max_corr_dist, **ikw)
        for _ in range(gn_iters):
            r, J = _gn_system(corr, p, q)
            H = J.T @ J + 1e-6 * eye6
            g = -J.T @ r
            # solve_ex: no error check, hence no host sync
            dx = torch.linalg.solve_ex(H, g)[0]
            q = lie.quat_boxplus(q, dx[0:3])
            p = p + dx[3:6]

    # diagnostics: final matched counts
    corr = find_correspondences(
        corner_src, corner_mask, surf_src, surf_mask,
        corner_map, corner_map_mask, surf_map, surf_map_mask, p, q,
        max_corr_dist, **ikw)
    re3, we, rp, wp = _residuals(corr, p, q)
    n_edge = torch.sum(corr.edge_ok)
    n_plane = torch.sum(corr.plane_ok)
    mean_res = (torch.sum(torch.linalg.vector_norm(re3, dim=-1)
                          * corr.edge_ok)
                + torch.sum(torch.abs(rp) * corr.plane_ok)) / torch.clamp_min(
        n_edge + n_plane, 1)
    return p, q, n_edge, n_plane, mean_res
