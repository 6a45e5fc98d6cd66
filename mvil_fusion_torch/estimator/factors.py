"""Factor residuals and batched Gauss-Newton system assembly for the
sliding window.

Counterpart of ``mvil_fusion_tpu/estimator/factors.py``, in place of the
reference's Ceres cost functions:

* projection-with-td factor   (reference: vils_estimator/src/factor/
  projection_td_factor.cpp, sqrt_info = FOCAL/2·I, estimator.cpp:18-19)
* IMU preintegration factor   (reference: factor/imu_factor.h:12-189)
* marginalization prior       (reference: factor/marginalization_factor.cpp)
* Cauchy robust loss on vision (reference: estimator.cpp:1129)

Every factor family is one batched evaluation over a static-capacity
table.  Its Jacobians come from forward-mode AD of the residual in the
factor's *local* parameters (``torch.func.vmap`` of ``torch.func.jacfwd``,
the per-factor inputs gathered before the transform) and are placed into
the packed pose-side layout by ``scatter_add_`` on column indices, so
that two blocks on one column (a masked factor with i = j) add.  Each
family also has a residual-only path (``vision_cost``, ``imu_cost``,
``prior_cost``, ``anchor_cost``) for the LM step's trial cost.
"""

from __future__ import annotations

import functools
from typing import Mapping, NamedTuple

import torch
from torch.func import jacfwd, vmap

from mvil_fusion_torch.estimator import state as st
from mvil_fusion_torch.ops import preintegration as pre
from mvil_fusion_torch.utils import lie
from mvil_fusion_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=None)
def _range(n: int, device: torch.device) -> torch.Tensor:
    """torch.arange(n) on `device`, made once."""
    return torch.arange(n, device=device)


def activity(active, dtype, device) -> torch.Tensor:
    """`active` (a Python bool or a 0-dim tensor) as a 0-dim float tensor,
    made on the device without a copy from the host."""
    if isinstance(active, torch.Tensor):
        return active.to(dtype)
    return torch.full((), float(bool(active)), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Projection (vision) factor with td
# ---------------------------------------------------------------------------

def proj_residual(p_i, q_i, p_j, q_j, tic, qic, inv_dep, td,
                  obs_i, vel_i, obs_j, vel_j, td_ref_i, td_ref_j):
    """2-dim reprojection residual of (feature, frame-j) pairs, batched
    over leading dimensions.

    Mirrors ProjectionTdFactor::Evaluate (reference:
    factor/projection_td_factor.cpp): the feature is parameterized by
    inverse depth in its start frame i; both observations are
    velocity-compensated by the current time-offset estimate.
    """
    pts_i = obs_i - (td - td_ref_i)[..., None] * vel_i
    pts_j = obs_j - (td - td_ref_j)[..., None] * vel_j
    pts_cam_i = torch.cat([pts_i, torch.ones_like(pts_i[..., :1])],
                          dim=-1) / inv_dep[..., None]
    pts_imu_i = lie.quat_rotate(qic, pts_cam_i) + tic
    pts_w = lie.quat_rotate(q_i, pts_imu_i) + p_i
    pts_imu_j = lie.quat_rotate_inv(q_j, pts_w - p_j)
    pts_cam_j = lie.quat_rotate_inv(qic, pts_imu_j - tic)
    z = pts_cam_j[..., 2:3]
    safe_z = torch.where(z.abs() < 1e-6, torch.sign(z) * 1e-6 + 1e-12, z)
    return pts_cam_j[..., :2] / safe_z - pts_j


class VisionSystem(NamedTuple):
    Jg: torch.Tensor    # (N,2,D) global pose-side jacobians (weighted)
    Jl: torch.Tensor    # (N,2)   landmark jacobians (weighted)
    r: torch.Tensor     # (N,2)   whitened+weighted residuals
    fidx: torch.Tensor  # (N,)    feature slot of each factor
    w: torch.Tensor     # (N,)    active mask as float (0 inactive)
    cost: torch.Tensor  # ()      robust cost total


def _vision_inputs(s: st.WindowState, f: st.Features):
    """Every (feature, frame) factor's gathered inputs, N = F·W in
    feature-major order: (fidx, iidx, jidx, active, per-factor tensors)."""
    W = s.window
    F = f.start.shape[0]
    dev = s.p.device
    fidx = _range(F, dev)[:, None].expand(F, W).reshape(-1)
    jidx = _range(W, dev)[None, :].expand(F, W).reshape(-1)
    iidx = f.start[fidx]
    active = (f.valid[fidx] & f.mask[fidx, iidx] & f.mask[fidx, jidx]
              & (jidx != iidx))
    per = (s.p[iidx], s.q[iidx], s.p[jidx], s.q[jidx], s.inv_depth[fidx],
           f.obs[fidx, iidx], f.vel[fidx, iidx], f.obs[fidx, jidx],
           f.vel[fidx, jidx], f.td_ref[fidx, iidx], f.td_ref[fidx, jidx])
    return fidx, iidx, jidx, active, per


def _proj_local(delta, pi, qi, pj, qj, lam, obs_i, vel_i, obs_j, vel_j,
                tdr_i, tdr_j, tic, qic, td):
    """One factor's residual in its 20 local parameters
    [δpose_i(6), δpose_j(6), δext(6), δλ(1), δtd(1)], returned twice (the
    second as jacfwd's aux: the value)."""
    pi2 = pi + delta[0:3]
    qi2 = lie.quat_mul(qi, lie.quat_exp(delta[3:6]))
    pj2 = pj + delta[6:9]
    qj2 = lie.quat_mul(qj, lie.quat_exp(delta[9:12]))
    tic2 = tic + delta[12:15]
    qic2 = lie.quat_mul(qic, lie.quat_exp(delta[15:18]))
    r = proj_residual(pi2, qi2, pj2, qj2, tic2, qic2, lam + delta[18],
                      td + delta[19], obs_i, vel_i, obs_j, vel_j, tdr_i,
                      tdr_j)
    return r, r


def _cauchy(r, active, cauchy_c):
    """(IRLS weight, robust cost terms) of whitened residual rows."""
    s2 = torch.sum(r * r, dim=-1)
    w = torch.where(active, 1.0 / (1.0 + s2 / cauchy_c ** 2), 0.0)
    cost = torch.where(active, 0.5 * cauchy_c ** 2
                       * torch.log1p(s2 / cauchy_c ** 2), 0.0)
    return w, cost


def vision_system(s: st.WindowState, f: st.Features, focal: float,
                  cauchy_c: float = 1.0) -> VisionSystem:
    """Evaluate all (feature, observing-frame) projection factors.

    Returns weighted jacobians/residuals; factors where frame j == start
    frame or unobserved are masked to zero.  N = F * W.
    """
    W = s.window
    D = st.pose_dim(W)
    sqrt_info = focal / 2.0
    fidx, iidx, jidx, active, per = _vision_inputs(s, f)
    N = fidx.shape[0]
    zeros = s.p.new_zeros(20)
    J, r = vmap(jacfwd(_proj_local, has_aux=True),
                in_dims=(None,) + (0,) * 11 + (None,) * 3)(
        zeros, *per, s.tic, s.qic, s.td)            # (N,2,20), (N,2)
    r = r * sqrt_info
    w, cost = _cauchy(r, active, cauchy_c)
    sw = torch.sqrt(w)[:, None]
    J = J * (sqrt_info * sw[..., None])

    # local pose blocks to their global columns: 6 of frame i, 6 of frame j,
    # 6 of the extrinsic, 1 of td (the landmark column stays local)
    base6 = _range(6, s.p.device)
    toff = st.td_offset(W)
    cols = torch.cat([(15 * iidx)[:, None] + base6,
                      (15 * jidx)[:, None] + base6,
                      (st.ext_offset(W) + base6).expand(N, 6),
                      _range(D, s.p.device)[toff:toff + 1].expand(N, 1)],
                     dim=1)                                  # (N,19)
    Jloc = torch.cat([J[..., 0:18], J[..., 19:20]], dim=-1)  # (N,2,19)
    Jg = J.new_zeros((N, 2, D)).scatter_add_(
        2, cols[:, None, :].expand(N, 2, 19), Jloc)
    return VisionSystem(Jg=Jg, Jl=J[..., 18], r=r * sw, fidx=fidx, w=w,
                        cost=torch.sum(cost))


def vision_cost(s: st.WindowState, f: st.Features, focal: float,
                cauchy_c: float = 1.0) -> torch.Tensor:
    """`vision_system(...).cost` without the Jacobians."""
    _, _, _, active, per = _vision_inputs(s, f)
    r = proj_residual(per[0], per[1], per[2], per[3], s.tic, s.qic, per[4],
                      s.td, *per[5:]) * (focal / 2.0)
    return torch.sum(_cauchy(r, active, cauchy_c)[1])


# ---------------------------------------------------------------------------
# IMU factors
# ---------------------------------------------------------------------------

class DenseSystem(NamedTuple):
    """A stack of factors already in global coordinates."""

    J: torch.Tensor    # (M, D) rows of the weighted jacobian
    r: torch.Tensor    # (M,)   weighted residuals
    cost: torch.Tensor


def _imu_local(delta, pi, qi, vi, bai, bgi, pj, qj, vj, baj, bgj, pk,
               gravity):
    """The unweighted IMU residual of one interval in the 30 local
    parameters of frames k, k+1, returned twice (value as aux)."""
    di, dj = delta[:15], delta[15:]
    r = pre.imu_residual(
        pk, pi + di[0:3], lie.quat_mul(qi, lie.quat_exp(di[3:6])),
        vi + di[6:9], bai + di[9:12], bgi + di[12:15],
        pj + dj[0:3], lie.quat_mul(qj, lie.quat_exp(dj[3:6])),
        vj + dj[6:9], baj + dj[9:12], bgj + dj[12:15], gravity)
    return r, r


def _imu_inputs(s: st.WindowState):
    return (s.p[:-1], s.q[:-1], s.v[:-1], s.ba[:-1], s.bg[:-1],
            s.p[1:], s.q[1:], s.v[1:], s.ba[1:], s.bg[1:])


def imu_system(s: st.WindowState, preints: pre.Preintegrated,
               interval_mask: torch.Tensor, gravity: torch.Tensor
               ) -> DenseSystem:
    """All W-1 consecutive-frame IMU factors as one batched evaluation.

    preints: Preintegrated with leading axis (W-1,) for intervals k→k+1.
    interval_mask: (W-1,) bool — inactive intervals contribute zero.
    """
    W = s.window
    D = st.pose_dim(W)
    nI = W - 1
    si = pre.sqrt_information(preints)                      # (nI,15,15)
    J, r = vmap(jacfwd(_imu_local, has_aux=True),
                in_dims=(None,) + (0,) * 11 + (None,))(
        s.p.new_zeros(30), *_imu_inputs(s), preints, gravity)
    m = interval_mask.to(s.p.dtype)[:, None]
    r = (si @ r[..., None])[..., 0] * m                      # (nI,15)
    J = (si @ J) * m[..., None]                              # (nI,15,30)
    # interval k occupies global columns [15k, 15k+30)
    cols = (15 * _range(nI, s.p.device))[:, None] + _range(30, s.p.device)
    Jg = J.new_zeros((nI, 15, D)).scatter_(
        2, cols[:, None, :].expand(nI, 15, 30), J)
    return DenseSystem(J=Jg.reshape(nI * 15, D), r=r.reshape(-1),
                       cost=0.5 * torch.sum(r * r))


def imu_cost(s: st.WindowState, preints: pre.Preintegrated,
             interval_mask: torch.Tensor, gravity: torch.Tensor
             ) -> torch.Tensor:
    """`imu_system(...).cost` without the Jacobians."""
    r = pre.imu_residual(preints, *_imu_inputs(s), gravity)
    r = (pre.sqrt_information(preints) @ r[..., None])[..., 0]
    r = r * interval_mask.to(s.p.dtype)[:, None]
    return 0.5 * torch.sum(r * r)


# ---------------------------------------------------------------------------
# Marginalization prior factor
# ---------------------------------------------------------------------------

class Prior(NamedTuple):
    """Linearized Gaussian prior  r(x) = r0 + J0 (x ⊟ x0)  over the packed
    pose-side parameters (reference: MarginalizationFactor)."""

    J: torch.Tensor          # (Np, D)
    r0: torch.Tensor         # (Np,)
    x0: st.WindowState       # linearization point
    valid: torch.Tensor      # () bool — inactive before first marginalization


def empty_prior(w: int, f: int, dtype=torch.float32,
                device: torch.device | str | None = None) -> Prior:
    dev = resolve_device(device)
    D = st.pose_dim(w)
    return Prior(J=torch.zeros((D, D), dtype=dtype, device=dev),
                 r0=torch.zeros((D,), dtype=dtype, device=dev),
                 x0=st.make_window_state(w, f, dtype, dev),
                 valid=torch.zeros((), dtype=torch.bool, device=dev))


def prior_from_numpy(arrays, dtype=torch.float32,
                     device: torch.device | str | None = None) -> Prior:
    """A Prior from numpy fields (a Mapping or a NamedTuple such as the
    JAX package's prior; `x0` a Mapping or NamedTuple of the state's
    fields), copied onto `device`."""
    dev = resolve_device(device)
    if not isinstance(arrays, Mapping):
        arrays = arrays._asdict()
    return Prior(J=st.from_numpy(arrays["J"], dtype, dev),
                 r0=st.from_numpy(arrays["r0"], dtype, dev),
                 x0=st.window_state_from_numpy(arrays["x0"], dtype, dev),
                 valid=st.from_numpy(arrays["valid"], torch.bool, dev))


def prior_system(prior: Prior, s: st.WindowState) -> DenseSystem:
    dx = st.state_boxminus(s, prior.x0)
    active = prior.valid.to(s.p.dtype)
    r = (prior.r0 + prior.J @ dx) * active
    return DenseSystem(J=prior.J * active, r=r, cost=0.5 * torch.sum(r * r))


def prior_cost(prior: Prior, s: st.WindowState) -> torch.Tensor:
    """`prior_system(...).cost` without scaling the Jacobian."""
    r = (prior.r0 + prior.J @ st.state_boxminus(s, prior.x0)) \
        * prior.valid.to(s.p.dtype)
    return 0.5 * torch.sum(r * r)


# ---------------------------------------------------------------------------
# Anchor (gauge) factor — used before the first marginalization prior exists
# ---------------------------------------------------------------------------

def _anchor_res(delta, p0, q0, p_ref, q_ref):
    dp = p0 + delta[0:3] - p_ref
    dth = lie.quat_boxminus(lie.quat_mul(q0, lie.quat_exp(delta[3:6])),
                            q_ref)
    r = torch.cat([dp, dth])
    return r, r


def anchor_system(s: st.WindowState, s_ref: st.WindowState,
                  weight: float, active) -> DenseSystem:
    """Soft prior pinning frame-0 position and yaw of `s` to `s_ref`,
    removing the 4 unobservable dofs when no marginalization prior exists
    (the reference handles this through its prior and the double2vector
    yaw rewind, estimator.cpp:960-1074; this does both)."""
    D = st.pose_dim(s.window)
    a = activity(active, s.p.dtype, s.p.device) * weight
    J6, r = jacfwd(_anchor_res, has_aux=True)(
        s.p.new_zeros(6), s.p[0], s.q[0], s_ref.p[0], s_ref.q[0])
    r = r * a
    J = torch.cat([J6 * a, J6.new_zeros((6, D - 6))], dim=1)
    return DenseSystem(J=J, r=r, cost=0.5 * torch.sum(r * r))


def anchor_cost(s: st.WindowState, s_ref: st.WindowState, weight: float,
                active) -> torch.Tensor:
    """`anchor_system(...).cost` without the Jacobian."""
    r = _anchor_res(s.p.new_zeros(6), s.p[0], s.q[0], s_ref.p[0],
                    s_ref.q[0])[0]
    r = r * (activity(active, s.p.dtype, s.p.device) * weight)
    return 0.5 * torch.sum(r * r)
