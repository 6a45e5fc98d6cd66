"""LiDAR constraint factors for the sliding-window BA.

Counterpart of ``mvil_fusion_tpu/estimator/lidar_factors.py``, the
reference's Ceres autodiff factors (vils_estimator/src/lidar_backend.h):

* `LidarICPConstraint_b` (:97-184): scan-to-scan relative translation,
  4 window poses (a,b bracket sweep i; c,d bracket sweep j), slerp/lerp
  interpolation to the sweep timestamps, residual on the x/z components of
  Qj⁻¹Qi (PIJ − Qi⁻¹(Pj−Pi)) scaled by sqrt_info (y is zeroed).
* `LPSConstraint` (:35-95): rotation-only pull toward the global-mapping
  localizer pose, 2 bracketing poses, residual 2·vec(Qi⁻¹ Q_meas)/0.01.
* zero-velocity freeze (mode 4): strong prior pinning the second-newest
  frame's pose and zeroing its velocity (reference estimator.cpp:1354-1375
  SetParameterBlockConstant + v=0).

All constraint slots are static-capacity with masks; factors are built as
dense rows (E, D) for BAProblem.extra_J/extra_r.  The poses of each
constraint are gathered before the Jacobian transform, and its local
blocks go to their global columns by ``scatter_add_``.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
from torch.func import jacfwd, vmap

from mvil_fusion_torch.estimator import state as st
from mvil_fusion_torch.estimator.factors import _range, activity
from mvil_fusion_torch.utils import lie
from mvil_fusion_torch.utils.device import resolve_device

MAX_ICP = 5     # reference: LidarICPConstraints list ≤ 5
MAX_LPS = 7     # reference: LidarLPSConstraints list ≤ 7
_CAUCHY_C2 = 2.3849 ** 2   # reference estimator.cpp:1130


class IcpConstraints(NamedTuple):
    """Static-capacity 4-pose ICP constraint table."""

    ids: torch.Tensor        # (C,4) int64 window indices a,b,c,d
    alpha_i: torch.Tensor    # (C,) (ti-ta)/(tb-ta)
    alpha_j: torch.Tensor    # (C,) (tj-tc)/(td-tc)
    trans_p: torch.Tensor    # (C,3) measured relative translation (body)
    weight: torch.Tensor     # (C,) sqrt_info scalar (100/fitness)
    active: torch.Tensor     # (C,) bool (mode == 3 and ids found)


class LpsConstraints(NamedTuple):
    ids: torch.Tensor        # (L,2) int64 bracketing window indices
    alpha: torch.Tensor      # (L,)
    q_meas: torch.Tensor     # (L,4) measured body orientation (world)
    active: torch.Tensor     # (L,)


def empty_icp(dtype=torch.float32,
              device: torch.device | str | None = None) -> IcpConstraints:
    dev = resolve_device(device)
    C = MAX_ICP
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)  # noqa
    return IcpConstraints(
        ids=torch.zeros((C, 4), dtype=torch.int64, device=dev),
        alpha_i=z(C), alpha_j=z(C), trans_p=z(C, 3), weight=z(C),
        active=torch.zeros((C,), dtype=torch.bool, device=dev))


def empty_lps(dtype=torch.float32,
              device: torch.device | str | None = None) -> LpsConstraints:
    dev = resolve_device(device)
    L = MAX_LPS
    return LpsConstraints(
        ids=torch.zeros((L, 2), dtype=torch.int64, device=dev),
        alpha=torch.zeros((L,), dtype=dtype, device=dev),
        q_meas=lie.quat_identity(dtype, dev).repeat(L, 1),
        active=torch.zeros((L,), dtype=torch.bool, device=dev))


def _table_from_numpy(cls, arrays, dtype, device):
    dev = resolve_device(device)
    if not isinstance(arrays, Mapping):
        arrays = arrays._asdict()
    kinds = dict(ids=torch.int64, active=torch.bool)
    return cls(**{n: st.from_numpy(arrays[n], kinds.get(n, dtype), dev)
                  for n in cls._fields})


def icp_from_numpy(arrays, dtype=torch.float32,
                   device: torch.device | str | None = None
                   ) -> IcpConstraints:
    """An ICP table from numpy fields (a Mapping or a NamedTuple)."""
    return _table_from_numpy(IcpConstraints, arrays, dtype, device)


def lps_from_numpy(arrays, dtype=torch.float32,
                   device: torch.device | str | None = None
                   ) -> LpsConstraints:
    """An LPS table from numpy fields (a Mapping or a NamedTuple)."""
    return _table_from_numpy(LpsConstraints, arrays, dtype, device)


def _pose_cols(ids: torch.Tensor, first: int, n: int) -> torch.Tensor:
    """(C, k·n) global columns 15·id + first .. + n of each of k ids."""
    C, k = ids.shape
    off = _range(n, ids.device) + first
    return (15 * ids[..., None] + off).reshape(C, k * n)


def _icp_local(delta, pa, qa, pb, qb, pc, qc, pd, qd, ai, aj, t_meas, w):
    """One constraint's residual in the 24 local parameters of its poses
    a, b, c, d, returned twice (value as aux)."""
    pa = pa + delta[0:3]
    qa = lie.quat_mul(qa, lie.quat_exp(delta[3:6]))
    pb = pb + delta[6:9]
    qb = lie.quat_mul(qb, lie.quat_exp(delta[9:12]))
    pc = pc + delta[12:15]
    qc = lie.quat_mul(qc, lie.quat_exp(delta[15:18]))
    pd = pd + delta[18:21]
    qd = lie.quat_mul(qd, lie.quat_exp(delta[21:24]))
    Qi = lie.quat_slerp(qa, qb, ai)
    Qj = lie.quat_slerp(qc, qd, aj)
    Pi = pa + (pb - pa) * ai
    Pj = pc + (pd - pc) * aj
    temQ = lie.quat_mul(lie.quat_conj(Qj), Qi)
    temP = lie.quat_rotate_inv(Qi, Pj - Pi)
    res = lie.quat_rotate(temQ, t_meas - temP)
    # x/z only, y zeroed (lidar_backend.h:158-161)
    r = torch.stack([res[0], torch.zeros_like(res[0]), res[2]]) * w
    return r, r


def icp_system(s: st.WindowState, c: IcpConstraints):
    """(3·C, D) weighted jacobian rows + residuals at the current state."""
    D = st.pose_dim(s.window)
    C = c.ids.shape[0]
    poses = []
    for k in range(4):
        poses += [s.p[c.ids[:, k]], s.q[c.ids[:, k]]]
    J, r = vmap(jacfwd(_icp_local, has_aux=True),
                in_dims=(None,) + (0,) * 12)(
        s.p.new_zeros(24), *poses, c.alpha_i, c.alpha_j, c.trans_p,
        c.weight)                                    # (C,3,24), (C,3)
    # Cauchy IRLS weight: the reference adds these blocks under the
    # problem-wide robust loss (estimator.cpp:1129, :1395), which caps a
    # disagreeing ICP measurement's influence
    w_rob = torch.sqrt(1.0 / (1.0 + torch.sum(r * r, dim=-1) / _CAUCHY_C2))
    m = (c.active.to(s.p.dtype) * w_rob)[:, None]
    cols = _pose_cols(c.ids, 0, 6)                       # (C,24)
    Jg = J.new_zeros((C, 3, D)).scatter_add_(
        2, cols[:, None, :].expand(C, 3, 24), J * m[..., None])
    return Jg.reshape(-1, D), (r * m).reshape(-1)


def _lps_local(delta, ql, qr, a, q_meas, sigma):
    ql = lie.quat_mul(ql, lie.quat_exp(delta[0:3]))
    qr = lie.quat_mul(qr, lie.quat_exp(delta[3:6]))
    Qi = lie.quat_slerp(ql, qr, a)
    q12 = lie.quat_mul(lie.quat_conj(Qi), q_meas)
    r = 2.0 * q12[1:4] / sigma
    return r, r


def lps_system(s: st.WindowState, c: LpsConstraints, sigma: float = 0.01):
    """(3·L, D) rotation-only LPS rows (lidar_backend.h:35-95)."""
    D = st.pose_dim(s.window)
    L = c.ids.shape[0]
    J, r = vmap(jacfwd(_lps_local, has_aux=True),
                in_dims=(None, 0, 0, 0, 0, None))(
        s.p.new_zeros(6), s.q[c.ids[:, 0]], s.q[c.ids[:, 1]], c.alpha,
        c.q_meas, sigma)                             # (L,3,6), (L,3)
    # Cauchy IRLS weight (reference estimator.cpp:1129, :1322 adds the LPS
    # block under the robust loss): at sigma = 0.01 a few degrees of
    # disagreement is a |r| of 5-10
    w_rob = torch.sqrt(1.0 / (1.0 + torch.sum(r * r, dim=-1) / _CAUCHY_C2))
    m = (c.active.to(s.p.dtype) * w_rob)[:, None]
    cols = _pose_cols(c.ids, 3, 3)                       # rotation columns
    Jg = J.new_zeros((L, 3, D)).scatter_add_(
        2, cols[:, None, :].expand(L, 3, 6), J * m[..., None])
    return Jg.reshape(-1, D), (r * m).reshape(-1)


def zero_velocity_system(s: st.WindowState, active, weight: float = 1e4):
    """(9, D) rows freezing frame W-2's pose at its current estimate and its
    velocity at zero (reference mode-4 handling, estimator.cpp:1354-1375)."""
    W = s.window
    D = st.pose_dim(W)
    k = W - 2
    m = activity(active, s.p.dtype, s.p.device) * weight
    # rows: δp(3) [pin], δθ(3) [pin], v(3) [drive to zero]
    eye9 = torch.eye(9, dtype=s.p.dtype, device=s.p.device) * m
    J = torch.cat([s.p.new_zeros((9, 15 * k)), eye9,
                   s.p.new_zeros((9, D - 15 * k - 9))], dim=1)
    r = torch.cat([s.p.new_zeros(6), s.v[k] * m])
    return J, r
