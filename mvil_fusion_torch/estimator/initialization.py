"""Visual-inertial initialization.

Counterpart of ``mvil_fusion_tpu/estimator/initialization.py``, the
reference's initialization stack:

* camera-IMU rotation hand-eye calibration
  (reference: vils_estimator/src/initial/initial_ex_rotation.cpp:24-113)
* relative pose by essential matrix (reference: initial/solve_5pts.cpp:193-230
  — a batched 8-point essential RANSAC, same geometry, batch-parallel)
* global SfM: two-view triangulation chain + PnP + full BA
  (reference: initial/initial_sfm.cpp:21-309)
* gyro bias + linear alignment (legacy VINS path kept by the reference,
  initial/initial_aligment.cpp:10-219)
* the reference's bounded two-stage VI init: per-interval gyro bias + RIC +
  per-frame td from rotation consistency, then per-frame velocity +
  per-frame scale + acc bias + pbc + gravity direction
  (reference: initial_aligment.cpp:221-484, constraints
  initial/initial_alignment.h:36-233), solved with projected LM
  (``ops/lm.py``) instead of bounded Ceres.

Frame conventions follow the reference: SfM gives camera poses
(R_c0_ci, p_c0_ci) in the reference-camera frame c0; stage A converts frame
rotations to body (R_c0_bi = R_c0_ci · RICᵀ); velocities in stage B live in
each body frame.

Everything runs on the device of its inputs (``global_sfm`` on the device
it is given), in fp32 with TF32 off.  Least squares go through an SVD with
the reference's (``jnp.linalg.lstsq``) rank rule, so a rank-deficient
system gets the minimum-norm answer on every device.  The functions that
return Python values (``global_sfm``, ``linear_alignment`` and the two
stages) read their results back to the host; the hand-eye and essential
SVDs wait for the device on a card as well.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mvil_fusion_torch.ops import lm, triangulate as tri
from mvil_fusion_torch.ops import preintegration as pre
from mvil_fusion_torch.ops.ransac import _eight_point, sample_hypotheses
from mvil_fusion_torch.utils import lie, nplie
from mvil_fusion_torch.utils.device import resolve_device
from mvil_fusion_torch.utils.precision import full_precision


def lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least-squares solution of A x = b (A (M,N), b (M,)) with the
    semantics of ``jnp.linalg.lstsq``: by SVD, singular values below
    eps·max(M, N)·s_max dropped, so a rank-deficient A gets the minimum-
    norm solution (``torch.linalg.lstsq`` on a card assumes full rank)."""
    m, n = A.shape
    rcond = torch.finfo(A.dtype).eps * max(m, n)
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return Vh.T @ (s_inv * (U.T @ b))


# ---------------------------------------------------------------------------
# Hand-eye rotation calibration (ESTIMATE_EXTRINSIC == 2 path)
# ---------------------------------------------------------------------------

@full_precision
def hand_eye_rotation(q_b: torch.Tensor, q_c: torch.Tensor,
                      weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Solve q_bc from paired relative rotations: q_b ⊗ q_bc = q_bc ⊗ q_c.

    q_b, q_c: (N,4) body / camera relative rotations of the same intervals.
    Stacks N 4x4 (L(q_b) − R(q_c)) blocks and takes the smallest right
    singular vector — the construction of the reference's
    CalibrationExRotation (initial_ex_rotation.cpp:24-113).  The vector's
    sign is free; the result is canonical (w ≥ 0).
    """
    def lmat(q):
        w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        return torch.stack([
            torch.stack([w, -x, -y, -z], -1),
            torch.stack([x, w, -z, y], -1),
            torch.stack([y, z, w, -x], -1),
            torch.stack([z, -y, x, w], -1),
        ], -2)

    def rmat(q):
        w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        return torch.stack([
            torch.stack([w, -x, -y, -z], -1),
            torch.stack([x, w, z, -y], -1),
            torch.stack([y, -z, w, x], -1),
            torch.stack([z, y, -x, w], -1),
        ], -2)

    A = lmat(q_b) - rmat(q_c)                       # (N,4,4)
    if weights is not None:
        A = A * weights[:, None, None]
    _, _, Vh = torch.linalg.svd(A.reshape(-1, 4), full_matrices=False)
    return lie.quat_canonical(lie.quat_normalize(Vh[-1]))


# ---------------------------------------------------------------------------
# Essential-matrix relative pose (the reference's 5-pt role)
# ---------------------------------------------------------------------------

class RelPose(NamedTuple):
    R: torch.Tensor        # (3,3) such that x_l ~ R x_c + t (c → l)
    t: torch.Tensor        # (3,) unit norm
    inliers: torch.Tensor  # (N,)
    ok: torch.Tensor


def _sampson_e(E: torch.Tensor, x_l: torch.Tensor,
               x_c: torch.Tensor) -> torch.Tensor:
    """Sampson distance (B,N) of x_c ᵀ E x_l = 0 for each E of (B,3,3)."""
    x1h = torch.cat([x_l, torch.ones_like(x_l[:, :1])], -1)
    x2h = torch.cat([x_c, torch.ones_like(x_c[:, :1])], -1)
    Ex1 = x1h @ E.transpose(1, 2)
    Etx2 = x2h @ E
    num = torch.sum(x2h * Ex1, -1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 \
        + Etx2[..., 1] ** 2
    return num / den.clamp_min(1e-15)


@full_precision
def essential_relative_pose(x_l: torch.Tensor, x_c: torch.Tensor,
                            valid: torch.Tensor, n_hyp: int = 256,
                            thr: float = 0.3 / 460.0,
                            generator: Optional[torch.Generator] = None,
                            idx: Optional[torch.Tensor] = None) -> RelPose:
    """Relative pose from normalized correspondences (reference
    solveRelativeRT semantics: returns R,t mapping current-frame points into
    the l frame).  Batched 8-point essential + cheirality vote.

    The hypotheses sample the slots `idx` (n_hyp, 8) where given (a
    comparison with the reference passes its draws), else slots drawn
    uniformly from the valid ones by `generator`."""
    dtype, dev = x_l.dtype, x_l.device
    if idx is None:
        idx = sample_hypotheses(valid, n_hyp, generator)
    Es = _eight_point(x_l[idx], x_c[idx])           # (B,3,3)
    inl = (_sampson_e(Es, x_l, x_c) < thr * thr) & valid[None, :]
    counts = torch.sum(inl, -1)
    # indexed by one-element tensors: a 0-dim index is read back to the host
    best = torch.argmax(counts).reshape(1)
    E = Es[best][0]
    inliers = inl[best][0]

    # decompose E (x2ᵀ E x1 = 0 with x1 in l, x2 in c ⇒ E = [t]x R maps l→c)
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    Wm = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                      dtype=dtype, device=dev)
    R1 = U @ Wm @ Vh
    R2 = U @ Wm.T @ Vh
    tt = U[:, 2]
    Rs = torch.stack([R1, R1, R2, R2])                # (4,3,3)
    ts = torch.stack([tt, -tt, tt, -tt])              # (4,3)

    # cheirality: linear triangulation of every correspondence under each
    # candidate (x_c ~ Rc x_l + tc, P1 = [I|0], P2 = [Rc|tc]); count the
    # inliers in front of both cameras
    P2 = torch.cat([Rs, ts[:, :, None]], dim=2)       # (4,3,4)
    e = torch.eye(4, dtype=dtype, device=dev)
    a, b = x_l[:, :, None], x_c[:, :, None]           # (N,2,1)
    rows = torch.stack(torch.broadcast_tensors(
        a[:, 0] * e[2] - e[0], a[:, 1] * e[2] - e[1],
        b[:, 0] * P2[:, None, 2] - P2[:, None, 0],
        b[:, 1] * P2[:, None, 2] - P2[:, None, 1]), dim=-2)   # (4,N,4,4)
    X = tri.smallest_eigvec(rows.transpose(-1, -2) @ rows).to(dtype)
    w = torch.where(X[..., 3].abs() < 1e-12, 1e-12, X[..., 3])
    p1 = X[..., :3] / w[..., None]                    # (4,N,3)
    z2 = (p1 @ Rs.transpose(1, 2) + ts[:, None, :])[..., 2]
    votes = torch.sum((p1[..., 2] > 0) & (z2 > 0) & inliers, dim=-1)
    ibest = torch.argmax(votes).reshape(1)
    R_lc = Rs[ibest][0]
    t_lc = ts[ibest][0]
    # (R_lc, t_lc) map l→c; invert to map current→l as the reference returns
    return RelPose(R=R_lc.T, t=-R_lc.T @ t_lc, inliers=inliers,
                   ok=counts[best][0] >= 12)


# ---------------------------------------------------------------------------
# PnP (LM refine) — used by the SfM chain
# ---------------------------------------------------------------------------

@full_precision
def pnp(pts3d: torch.Tensor, obs: torch.Tensor, mask: torch.Tensor,
        p0: torch.Tensor, q0: torch.Tensor, iters: int = 10):
    """Camera pose (world→cam R, t as T_c_w) refinement from 3-D points and
    normalized observations, starting at (p0, q0) = T_w_c guess.

    Returns (p_wc, q_wc, ok)."""
    m = mask.to(pts3d.dtype)

    def residual(x):
        q = lie.quat_boxplus(q0, x[3:6])
        pc = lie.quat_rotate_inv(q, pts3d - x[:3])
        z = torch.where(pc[:, 2].abs() < 1e-6, 1e-6, pc[:, 2])
        r = (pc[:, :2] / z[:, None] - obs) * m[:, None]
        # penalize negative depth to keep the solution in front
        pen = torch.clamp_min(-pc[:, 2], 0.0) * m
        return torch.cat([r.reshape(-1), pen])

    res = lm.lm_solve(residual, torch.cat([p0, torch.zeros_like(p0)]),
                      iters=iters)
    n_used = torch.sum(mask)
    ok = (n_used >= 6) & (res.cost < 0.01 * n_used.clamp_min(1))
    return res.x[:3], lie.quat_boxplus(q0, res.x[3:6]), ok


# ---------------------------------------------------------------------------
# Global SfM (reference GlobalSFM::construct)
# ---------------------------------------------------------------------------

class SfmResult(NamedTuple):
    ok: bool
    p_c0_c: np.ndarray     # (W,3) camera positions in c0 (unscaled)
    q_c0_c: np.ndarray     # (W,4) camera rotations
    pts: np.ndarray        # (F,3) world points in c0
    pts_ok: np.ndarray     # (F,)


def global_sfm(obs: np.ndarray, mask: np.ndarray, l: int,
               R_lc: np.ndarray, t_lc: np.ndarray,
               device: torch.device | str | None = None) -> SfmResult:
    """Host-orchestrated SfM over the window, its solves on `device` (None:
    the current CUDA device).

    obs (F,W,2) normalized observations, mask (F,W); l = reference frame;
    (R_lc, t_lc) = pose of the newest frame (index W-1) in frame l.
    Mirrors initial_sfm.cpp:116-309: triangulate l↔newest, PnP the frames
    between, then the frames before l, triangulate everything, full BA.
    """
    dev = resolve_device(device)
    F, W, _ = obs.shape
    up = lambda a, t=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a)).to(device=dev, dtype=t)
    p = np.zeros((W, 3), np.float32)
    q = np.tile(np.array([1, 0, 0, 0], np.float32), (W, 1))
    p[W - 1] = t_lc
    q[W - 1] = lie.mat_to_quat(torch.as_tensor(
        np.asarray(R_lc, np.float32))).numpy()

    pts = np.zeros((F, 3), np.float32)
    pts_ok = np.zeros(F, bool)

    def triangulate(obs_t, mask_t, start):
        p_wc, q_wc = up(p), up(q)
        inv_d, good = tri.triangulate_window(p_wc, q_wc, up(obs_t),
                                             up(mask_t, torch.bool),
                                             up(start, torch.int64))
        return inv_d.cpu().numpy(), good.cpu().numpy()

    def tri_pair(i, j):
        """Triangulate features seen in frames i and j with known poses."""
        sel = mask[:, i] & mask[:, j] & ~pts_ok
        if not sel.any():
            return
        obs2 = np.zeros((F, W, 2), np.float32)
        m2 = np.zeros((F, W), bool)
        obs2[:, i] = obs[:, i]
        obs2[:, j] = obs[:, j]
        m2[:, i] = sel
        m2[:, j] = sel
        inv_d, good = triangulate(obs2, m2, np.full(F, i, np.int64))
        good = good & sel
        # world point from start-frame depth
        d = 1.0 / np.maximum(inv_d, 1e-6)
        R_i = nplie.quat_to_mat(q[i]).astype(np.float32)
        xyw = np.concatenate([obs[:, i], np.ones((F, 1), np.float32)], -1)
        pw = (xyw * d[:, None]) @ R_i.T + p[i]
        pts[good] = pw[good]
        pts_ok[good] = True

    def do_pnp(i, guess_from):
        sel = mask[:, i] & pts_ok
        if sel.sum() < 6:
            return False
        pp, qq, ok = pnp(up(pts), up(obs[:, i]), up(sel, torch.bool),
                         up(p[guess_from]), up(q[guess_from]))
        if not bool(ok):
            return False
        p[i] = pp.cpu().numpy()
        q[i] = qq.cpu().numpy()
        return True

    tri_pair(l, W - 1)
    # frames l+1 .. W-2: PnP from existing points, then triangulate with W-1
    for i in range(l + 1, W - 1):
        if not do_pnp(i, i - 1 if i > l else l):
            return SfmResult(False, p, q, pts, pts_ok)
        tri_pair(i, W - 1)
    # triangulate l..i for more points
    for i in range(l + 1, W - 1):
        tri_pair(l, i)
    # frames l-1 .. 0: PnP + triangulate with l
    for i in range(l - 1, -1, -1):
        if not do_pnp(i, i + 1):
            return SfmResult(False, p, q, pts, pts_ok)
        tri_pair(i, l)
    # triangulate all remaining features with ≥2 observing frames
    start = np.argmax(mask, axis=1)
    inv_d, good = triangulate(obs, mask & ~pts_ok[:, None], start)
    good = good & ~pts_ok & (mask.sum(1) >= 2)
    d = 1.0 / np.maximum(inv_d, 1e-6)
    f = np.nonzero(good)[0]
    if len(f):
        R_w = np.stack([nplie.quat_to_mat(q_i) for q_i in q])
        R_s = R_w[start[f]].astype(np.float32)
        xyw = np.concatenate([obs[f, start[f]],
                              np.ones((len(f), 1), np.float32)], -1)
        pts[f] = np.einsum("fij,fj->fi", R_s, xyw * d[f, None]) \
            + p[start[f]]
        pts_ok[f] = True

    if pts_ok.sum() < 15:
        return SfmResult(False, p, q, pts, pts_ok)

    # full BA: optimize all poses (l's rotation fixed; l and W-1 translations
    # fixed, reference initial_sfm.cpp:231+) + points
    p_t, q_t, pts_t = _sfm_ba(up(p), up(q), up(pts), up(pts_ok, torch.bool),
                              up(obs), up(mask, torch.bool), l)
    return SfmResult(True, p_t.cpu().numpy(), q_t.cpu().numpy(),
                     pts_t.cpu().numpy(), pts_ok)


@full_precision
def _sfm_ba(p, q, pts, pts_ok, obs, mask, l, iters: int = 15):
    W = p.shape[0]
    F = pts.shape[0]
    free_t = torch.ones((W, 1), dtype=p.dtype, device=p.device)
    free_t[l].fill_(0.0)
    free_r = free_t.clone()
    free_t[W - 1].fill_(0.0)

    def unpack(x):
        dp = x[: 3 * W].reshape(W, 3) * free_t
        dth = x[3 * W:6 * W].reshape(W, 3) * free_r
        dpt = x[6 * W:].reshape(F, 3)
        return p + dp, lie.quat_boxplus(q, dth), pts + dpt

    m = (mask & pts_ok[:, None]).to(p.dtype).T[..., None]   # (W,F,1)
    obs_w = obs.transpose(0, 1)                               # (W,F,2)

    def residual(x):
        pp, qq, ppts = unpack(x)
        # all (w, f) reprojections
        pc = lie.quat_rotate_inv(qq[:, None, :], ppts[None] - pp[:, None])
        z = torch.where(pc[..., 2].abs() < 1e-6, 1e-6, pc[..., 2])
        return ((pc[..., :2] / z[..., None] - obs_w) * m).reshape(-1)

    res = lm.lm_solve(residual, p.new_zeros(6 * W + 3 * F), iters=iters)
    return unpack(res.x)


# ---------------------------------------------------------------------------
# Gyro bias (legacy linear path, reference initial_aligment.cpp:10-50)
# ---------------------------------------------------------------------------

@full_precision
def solve_gyroscope_bias(q_c0_b: torch.Tensor, preints: pre.Preintegrated,
                         interval_mask: torch.Tensor) -> torch.Tensor:
    """Linear LS for a single gyro bias from SfM body rotations."""
    q_ij = lie.quat_mul(lie.quat_conj(q_c0_b[:-1]), q_c0_b[1:])
    J = preints.J[:, 3:6, 12:15]                     # (W-1,3,3) dq/dbg
    r = 2.0 * lie.quat_mul(lie.quat_conj(preints.dq), q_ij)[:, 1:4]
    m = interval_mask.to(q_c0_b.dtype)[:, None]
    return lstsq((J * m[..., None]).reshape(-1, 3), (r * m).reshape(-1))


# ---------------------------------------------------------------------------
# Legacy linear alignment (reference initial_aligment.cpp:147-219, the VINS
# path kept by the reference as fallback) — single global scale, per-frame
# velocity, gravity; overdetermined linear system, production init path.
# ---------------------------------------------------------------------------

class LinearAlign(NamedTuple):
    ok: bool
    vel: torch.Tensor     # (W,3) body-frame velocities
    g_c0: torch.Tensor    # gravity in c0
    scale: torch.Tensor   # () global scale
    cost: float
    scale_sigma: float = float("inf")   # 1-sigma scale uncertainty from
    #                                     the normal matrix (observability)


def _alignment_system(p_c0_c, R, preints, pbc, g_cols, g_rhs):
    """Rows of the linear alignment over the intervals, (6(W-1), 3W + G + 1)
    and (6(W-1),): per-frame velocities, G gravity unknowns whose position
    and velocity columns are g_cols(Rbi, dt) (each (nI,3,G)), the scale,
    and the right-hand side minus g_rhs(Rbi, dt) (each (nI,3))."""
    W = p_c0_c.shape[0]
    nI = W - 1
    dtype, dev = p_c0_c.dtype, p_c0_c.device
    dt = preints.sum_dt[:, None, None]               # (nI,1,1)
    Rbi = R[:-1].transpose(-1, -2)                   # c0 → body_i
    RR = Rbi @ R[1:]
    eye = torch.eye(3, dtype=dtype, device=dev)
    gp, gv = g_cols(Rbi, dt)
    G = gp.shape[-1]
    A = torch.zeros((nI, 6, 3 * W + G + 1), dtype=dtype, device=dev)
    for k in range(nI):
        A[k, 0:3, 3 * k:3 * k + 3] = -dt[k] * eye
        A[k, 3:6, 3 * k:3 * k + 3] = -eye
        A[k, 3:6, 3 * (k + 1):3 * (k + 1) + 3] = RR[k]
    A[:, 0:3, 3 * W:3 * W + G] = gp
    A[:, 3:6, 3 * W:3 * W + G] = gv
    A[:, 0:3, 3 * W + G] = (Rbi @ (p_c0_c[1:] - p_c0_c[:-1])[..., None]
                            )[..., 0]
    rp, rv = g_rhs(Rbi, dt)
    b = torch.cat([preints.dp - pbc + (RR @ pbc) - rp, preints.dv - rv],
                  dim=-1)
    return A.reshape(6 * nI, -1), b.reshape(-1)


@full_precision
def linear_alignment(p_c0_c: torch.Tensor, q_c0_b: torch.Tensor,
                     preints: pre.Preintegrated, g_norm: float,
                     pbc: torch.Tensor) -> LinearAlign:
    """Solve [v_0..v_{W-1} (body), g_c0, s] from preintegrated deltas and
    unscaled SfM camera positions.  Linear LS, then fixed-norm gravity
    refinement (RefineGravity of the reference)."""
    W = p_c0_c.shape[0]
    dtype, dev = p_c0_c.dtype, p_c0_c.device
    R = lie.quat_to_mat(q_c0_b)                      # R_c0_bi
    zero3 = lambda Rbi, dt: (torch.zeros_like(Rbi[..., 0]),) * 2  # noqa
    # position rows: dp = Rbi( s·(p_{k+1}−p_k) − 0.5 g dt² ) − v_k dt
    #                + (Rbi R_{k+1} − I) pbc
    # velocity rows: dv = Rbi( R_{k+1} v_{k+1} − R_k v_k − g dt )
    A, b = _alignment_system(
        p_c0_c, R, preints, pbc,
        lambda Rbi, dt: (0.5 * Rbi * dt * dt, Rbi * dt), zero3)
    x = lstsq(A, b)
    g = x[3 * W:3 * W + 3]

    def tangent_basis(g):
        a = g / torch.linalg.vector_norm(g).clamp_min(1e-9)
        tmp = torch.where(a[2].abs() > 0.9,
                          torch.tensor([1.0, 0.0, 0.0], dtype=dtype,
                                       device=dev),
                          torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                                       device=dev))
        b1 = tmp - a * torch.dot(a, tmp)
        b1 = b1 / torch.linalg.vector_norm(b1).clamp_min(1e-9)
        return b1, torch.linalg.cross(a, b1)

    # refine gravity on the fixed-norm manifold: g = g_norm·ĝ + w1 b1 + w2 b2
    for _ in range(4):
        b1, b2 = tangent_basis(g)
        ghat = g / torch.linalg.vector_norm(g).clamp_min(1e-9) * g_norm
        B = torch.stack([b1, b2], dim=-1)            # (3,2)
        # substitute g = ghat + w1 b1 + w2 b2 into the same system
        A2, c2 = _alignment_system(
            p_c0_c, R, preints, pbc,
            lambda Rbi, dt: (0.5 * dt * dt * (Rbi @ B), dt * (Rbi @ B)),
            lambda Rbi, dt: (0.5 * dt[..., 0] * dt[..., 0] * (Rbi @ ghat),
                             dt[..., 0] * (Rbi @ ghat)))
        x2 = lstsq(A2, c2)
        g = ghat + x2[3 * W] * b1 + x2[3 * W + 1] * b2
        s = x2[3 * W + 2]
        vel = x2[:3 * W].reshape(W, 3)

    resid = A2 @ x2 - c2
    cost = float(0.5 * torch.sum(resid * resid))
    g_final = g / torch.linalg.vector_norm(g).clamp_min(1e-9) * g_norm
    ok = bool(s > 0.0) and np.isfinite(cost)
    # scale observability: 1-sigma of s from the normal matrix.  Short or
    # weakly-excited windows leave a near-null direction mixing (s, g, v):
    # the fit then looks perfect (tiny cost) at a scale tens of percent
    # off, which seeds the filter with a wrong metric scale.  Callers gate
    # initialization on scale_sigma/scale.
    A2h = A2.cpu().numpy().astype(np.float64)
    m, n2 = A2h.shape
    sigma2 = 2.0 * cost / max(m - n2, 1)
    try:
        cov_ss = float(np.linalg.inv(A2h.T @ A2h)[-1, -1])
        scale_sigma = float(np.sqrt(max(sigma2 * cov_ss, 0.0)))
    except np.linalg.LinAlgError:
        scale_sigma = float("inf")
    return LinearAlign(ok=ok, vel=vel, g_c0=g_final, scale=s, cost=cost,
                       scale_sigma=scale_sigma)


# ---------------------------------------------------------------------------
# Bounded two-stage alignment (reference initial_aligment.cpp:221-484)
# ---------------------------------------------------------------------------

class StageA(NamedTuple):
    ok: bool
    q_ric: torch.Tensor    # refined camera→IMU rotation
    bgs: torch.Tensor      # (W-1,3) per-interval gyro bias
    td: torch.Tensor       # (W,) per-frame time offset
    cost: float


def _with_w(v: torch.Tensor, w: float = 1.0) -> torch.Tensor:
    """(..., 3) vectors as (..., 4) quaternions [w, v]."""
    return torch.cat([torch.full_like(v[..., :1], w), v], dim=-1)


@full_precision
def estimate_ric_td_bg(q_c0_c: torch.Tensor, preints: pre.Preintegrated,
                       gyr_first: torch.Tensor, gyr_last: torch.Tensor,
                       q_ric0: torch.Tensor, fix_ric: bool = False,
                       cost_gate: float = 1e-5,
                       reg: float = 1e-3) -> StageA:
    """Stage A: rotation-consistency solve for (RIC, per-interval bg,
    per-frame td), all bounded — reference Estimate_ric_td_bg.

    gyr_first/gyr_last: (W-1,3) first/last raw gyro sample of each interval
    (the reference's gyr_0 / gyr_1 of frame_j's preintegration).
    """
    W = q_c0_c.shape[0]
    nI = W - 1
    dtype, dev = q_c0_c.dtype, q_c0_c.device
    Jbg = preints.J[:, 3:6, 12:15]
    ric_on = 0.0 if fix_ric else 1.0
    qcj_c0 = lie.quat_conj(q_c0_c[1:])
    qc0_ci = q_c0_c[:-1]

    def residual(x):
        q_ric = lie.quat_boxplus(q_ric0, x[0:3] * ric_on)
        bgs = x[3:3 + 3 * nI].reshape(nI, 3)
        td = x[3 + 3 * nI:3 + 3 * nI + W]
        Ql = _with_w(-0.5 * gyr_last * td[1:, None])
        Qr = _with_w(0.5 * gyr_first * td[:-1, None])
        qjbg = _with_w(0.5 * (Jbg @ bgs[..., None])[..., 0])
        # Ql ⊗ Qbc ⊗ qcjc0 ⊗ qc0ci ⊗ Qcb ⊗ Qr ⊗ qbibj ⊗ qjbg
        out = lie.quat_mul(Ql, q_ric.expand(nI, 4))
        out = lie.quat_mul(out, qcj_c0)
        out = lie.quat_mul(out, qc0_ci)
        out = lie.quat_mul(out, lie.quat_conj(q_ric).expand(nI, 4))
        out = lie.quat_mul(out, Qr)
        out = lie.quat_mul(out, preints.dq)
        out = lie.quat_mul(out, qjbg)
        data = (2.0 * out[:, 1:4]).reshape(-1)
        # Weak min-norm regularizer on (bgs, td): the rotation-consistency
        # system is underdetermined per interval; this picks the smallest-
        # parameter member so the translation stage sees camera rotations
        # consistent with the nominal frame timestamps.
        return torch.cat([data, reg * x[3:]])

    n = 3 + 3 * nI + W
    lower = torch.full((n,), -float("inf"), dtype=dtype, device=dev)
    upper = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    lower[3:].fill_(-0.1)
    upper[3:].fill_(0.1)
    res = lm.lm_solve(residual, torch.zeros((n,), dtype=dtype, device=dev),
                      iters=30, lower=lower, upper=upper)
    x = res.x
    cost = float(res.cost)
    return StageA(ok=cost < cost_gate * max(nI, 1) * 50,
                  q_ric=lie.quat_boxplus(q_ric0, x[0:3] * ric_on),
                  bgs=x[3:3 + 3 * nI].reshape(nI, 3),
                  td=x[3 + 3 * nI:3 + 3 * nI + W], cost=cost)


class StageB(NamedTuple):
    ok: bool
    vel: torch.Tensor      # (W,3) body-frame velocities
    scale: torch.Tensor    # (W,) per-frame scale
    g_c0: torch.Tensor     # gravity in c0
    pbc: torch.Tensor      # camera-IMU translation
    bas: torch.Tensor      # (W-1,3) per-interval acc bias
    cost: float


@full_precision
def estimate_vel_g_s_tic(p_c0_c: torch.Tensor, q_c0_b: torch.Tensor,
                         preints: pre.Preintegrated, g_norm: float,
                         pbc0: torch.Tensor,
                         pbc_lower: torch.Tensor, pbc_upper: torch.Tensor,
                         fix_pbc: bool = False,
                         cost_gate: float = 5e-4,
                         vel0: Optional[torch.Tensor] = None,
                         g0: Optional[torch.Tensor] = None,
                         scale0=None) -> StageB:
    """Stage B: per-frame velocity/scale + acc bias + pbc + gravity
    direction — reference Estimate_vel_g_s_tic (bounded projected LM).

    The per-frame-scale system is underdetermined (the bounds + damping
    regularize it), so convergence depends on the seed: pass (vel0, g0,
    scale0) from the linear alignment to start in the consistent basin —
    the solve then refines per-frame scale, acc bias and pbc around it."""
    W = p_c0_c.shape[0]
    nI = W - 1
    dtype, dev = p_c0_c.dtype, p_c0_c.device
    R_c0_b = lie.quat_to_mat(q_c0_b)                  # (W,3,3)
    Jp = preints.J[:, 0:3, 9:12]
    Jv = preints.J[:, 6:9, 9:12]
    dt = preints.sum_dt[:, None]                      # (nI,1)
    Rbic0 = R_c0_b[:-1].transpose(-1, -2)
    Rc0bj = R_c0_b[1:]
    RR = Rbic0 @ Rc0bj

    # layout: vel (3W), pbc (3), gdir (3), s (W), bas (3(W-1))
    ofs_p, ofs_g, ofs_s, ofs_a = 3 * W, 3 * W + 3, 3 * W + 6, 4 * W + 6
    n = 4 * W + 6 + 3 * nI

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    def residual(x):
        vel = x[:3 * W].reshape(W, 3)
        pbc = pbc0 if fix_pbc else x[ofs_p:ofs_p + 3]
        gdir = x[ofs_g:ofs_g + 3]
        s = x[ofs_s:ofs_s + W]
        bas = x[ofs_a:].reshape(nI, 3)
        # fixed-norm gravity (the reference fixes ‖G‖ and solves only the
        # direction): normalized inside the residual, so the magnitude can
        # never soak up scale error
        Gc0 = g_norm * gdir / torch.linalg.vector_norm(gdir).clamp_min(1e-6)
        dp = preints.dp + mv(Jp, bas)
        dv = preints.dv + mv(Jv, bas)
        r_p = (dp - pbc + mv(RR, pbc.expand(nI, 3))
               - mv(Rbic0, s[1:, None] * p_c0_c[1:] - s[:-1, None]
                    * p_c0_c[:-1])
               + vel[:-1] * dt - mv(0.5 * Rbic0, Gc0.expand(nI, 3)) * dt * dt)
        r_v = dv - mv(Rbic0, mv(Rc0bj, vel[1:]) - mv(R_c0_b[:-1], vel[:-1])
                      + Gc0 * dt)
        return torch.cat([r_p, r_v], dim=-1).reshape(-1)

    lower = torch.full((n,), -float("inf"), dtype=dtype, device=dev)
    upper = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    lower[ofs_s:ofs_s + W].fill_(0.0)
    lower[ofs_a:].fill_(-0.2)
    upper[ofs_a:].fill_(0.2)
    if not fix_pbc:
        lower[ofs_p:ofs_p + 3] = pbc_lower
        upper[ofs_p:ofs_p + 3] = pbc_upper

    x0 = torch.zeros((n,), dtype=dtype, device=dev)
    if not fix_pbc:
        x0[ofs_p:ofs_p + 3] = pbc0
    if g0 is not None:
        g_guess = torch.as_tensor(g0, dtype=dtype, device=dev)
        g_guess = g_guess / torch.linalg.vector_norm(g_guess).clamp_min(1e-9)
    else:
        # gravity direction init: down-ish in c0 — the dv of the first
        # interval (dominated by gravity for slow motion)
        g_guess = preints.dv[0] / torch.linalg.vector_norm(
            preints.dv[0]).clamp_min(1e-6)
        g_guess = R_c0_b[0] @ g_guess
    x0[ofs_g:ofs_g + 3] = g_guess
    s_init = torch.as_tensor(1.0 if scale0 is None else scale0, dtype=dtype,
                             device=dev)
    x0[ofs_s:ofs_s + W] = s_init
    if vel0 is not None:
        x0[:3 * W] = torch.as_tensor(vel0, dtype=dtype,
                                     device=dev).reshape(-1)
    else:
        # analytic velocity seed from the scaled camera positions (finite
        # difference in c0, rotated to body) — a zero seed with a nonzero
        # scale seed starts LM outside the true basin
        v_c0 = torch.diff(p_c0_c, dim=0) * s_init / dt.clamp_min(1e-6)
        v_c0 = torch.cat([v_c0, v_c0[-1:]], dim=0)          # (W,3)
        x0[:3 * W] = mv(R_c0_b.transpose(-1, -2), v_c0).reshape(-1)

    res = lm.lm_solve(residual, x0, iters=60, lower=lower, upper=upper)
    x = res.x
    gdir = x[ofs_g:ofs_g + 3]
    cost = float(res.cost)
    return StageB(ok=cost < cost_gate, vel=x[:3 * W].reshape(W, 3),
                  scale=x[ofs_s:ofs_s + W],
                  g_c0=g_norm * gdir / torch.linalg.vector_norm(
                      gdir).clamp_min(1e-9),
                  pbc=(pbc0 if fix_pbc else x[ofs_p:ofs_p + 3]),
                  bas=x[ofs_a:].reshape(nI, 3), cost=cost)
