"""IMU preintegration.

Counterpart of ``mvil_fusion_tpu/ops/preintegration.py`` (the reference's
`IntegrationBase`): midpoint integration of (Δp, Δq, Δv) with the 15x15
first-order-bias Jacobian and the 15x15 covariance, plus the 15-dim
residual of the IMU factor.  Error-state ordering: [δp, δθ, δv, δba, δbg].

The JAX package scans the samples one by one and takes the transition
matrix F (15x15) and the noise matrix V (15x18) of every step by forward
AD of the midpoint step in local coordinates.  Here the same quantities
are laid out for a device that is fed one small kernel at a time:

* only what really depends on the step before runs as a loop over the
  samples: the orientation chain (one 4x4 product and a normalization per
  step) and the products J ← F J, P ← F P Fᵀ + V Q Vᵀ;
* everything else (midpoint rates, rotated accelerations, Δv and Δp as
  running sums, F and V of all steps and all intervals) is computed at
  once on (intervals, steps, ...) tensors;
* F and V are the analytic derivatives of the midpoint step in those local
  coordinates, with the exact rotation of the step and the right Jacobian
  of SO(3), not the first-order forms of the reference's hand derivation;
  they equal the forward-AD matrices to rounding.

Padding steps (masked, trailing) are exact no-ops whatever their samples
hold.  Nothing in `preintegrate_batch` waits for the device.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from mvil_fusion_torch.utils import lie
from mvil_fusion_torch.utils.device import resolve_device

STATE_DIM = 15
NOISE_DIM = 18


class Preintegrated(NamedTuple):
    """Result of preintegrating one IMU interval, or a batch of them with
    one more leading dimension on every field."""

    dp: torch.Tensor       # (3,) position delta in frame i
    dq: torch.Tensor       # (4,) orientation delta (w,x,y,z)
    dv: torch.Tensor       # (3,) velocity delta in frame i
    J: torch.Tensor        # (15,15) d(state)/d(linearization point incl. bias)
    P: torch.Tensor        # (15,15) covariance of the error state
    sum_dt: torch.Tensor   # () total integrated time
    ba: torch.Tensor       # (3,) linearization accel bias
    bg: torch.Tensor       # (3,) linearization gyro bias


def preintegrated_from_numpy(arrays, dtype=torch.float32,
                             device: torch.device | str | None = None
                             ) -> Preintegrated:
    """A (batch of) Preintegrated from its eight fields as numpy (a
    Mapping, or a NamedTuple such as the JAX package's), copied onto
    `device` (None: the current CUDA device)."""
    dev = resolve_device(device)
    if not isinstance(arrays, Mapping):
        arrays = arrays._asdict()
    return Preintegrated(**{
        n: torch.as_tensor(np.array(arrays[n], copy=True)).to(device=dev,
                                                                dtype=dtype)
        for n in Preintegrated._fields})

def noise_covariance(acc_n, gyr_n, acc_w, gyr_w, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """18x18 continuous-ish noise covariance, diag([na0,ng0,na1,ng1,nba,nbg]),
    mirroring the reference's `noise` block (integration_base.h ctor)."""
    stds = (acc_n, gyr_n, acc_n, gyr_n, acc_w, gyr_w)
    d = torch.cat([torch.full((3,), s ** 2, dtype=dtype, device=device)
                   for s in stds])
    return torch.diag(d)


def _midpoint_step(dp, dq, dv, ba, bg, acc0, gyr0, acc1, gyr1, dt, noise):
    """One midpoint step with additive measurement noise (18,).

    Mirrors integration_base.h midPointIntegration dynamics; noise layout
    [na0, ng0, na1, ng1, nba, nbg].  `preintegrate_batch` computes the same
    step for all samples at once; this form states it for one, and the
    tests take its forward-AD Jacobians.
    """
    na0, ng0 = noise[0:3], noise[3:6]
    na1, ng1 = noise[6:9], noise[9:12]
    nba, nbg = noise[12:15], noise[15:18]
    un_gyr = 0.5 * (gyr0 + gyr1) - bg - 0.5 * (ng0 + ng1)
    dq_new = lie.quat_mul(dq, lie.quat_exp(un_gyr * dt))
    dq_new = lie.quat_normalize(dq_new)
    un_acc0 = lie.quat_rotate(dq, acc0 - ba - na0)
    un_acc1 = lie.quat_rotate(dq_new, acc1 - ba - na1)
    un_acc = 0.5 * (un_acc0 + un_acc1)
    dp_new = dp + dv * dt + 0.5 * un_acc * dt * dt
    dv_new = dv + un_acc * dt
    ba_new = ba + nba * dt
    bg_new = bg + nbg * dt
    return dp_new, dq_new, dv_new, ba_new, bg_new


def _right_mul_matrix(b: torch.Tensor) -> torch.Tensor:
    """(...,4,4) matrix M with M a = a ⊗ b for quaternions b (...,4)."""
    w, x, y, z = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    m = torch.stack([w, -x, -y, -z,
                     x, w, z, -y,
                     y, -z, w, x,
                     z, y, -x, w], dim=-1)
    return m.reshape(b.shape[:-1] + (4, 4))


def _step_jacobians(R0, R1, w, a0, a1, h):
    """F (...,15,15) and V (...,15,18) of midpoint steps.

    R0, R1: (...,3,3) rotations of Δq before and after the step; w (...,3)
    the step's rotation vector (midpoint rate less bias, times h); a0, a1
    (...,3) the two accelerations less bias; h (...) the step's time.
    Local coordinates: right perturbation on Δq, additive elsewhere.
    """
    dtype, dev = R0.dtype, R0.device
    Rw_t = lie.so3_exp(w).transpose(-1, -2)
    Jr = lie.so3_right_jacobian(w)
    h1 = h[..., None, None]
    h2 = h1 * h1
    # un_acc = (R0 a0 + R1 a1) / 2 and its derivatives
    G = R1 @ lie.skew(a1) @ Jr          # d(R1 a1) = G · d(rotation vector)
    dA_dth = -0.5 * (R0 @ lie.skew(a0) + R1 @ lie.skew(a1) @ Rw_t)
    dA_dba = -0.5 * (R0 + R1)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    batch = R0.shape[:-2]
    F = torch.eye(STATE_DIM, dtype=dtype, device=dev).repeat(batch + (1, 1))
    F[..., 0:3, 3:6] = 0.5 * h2 * dA_dth
    F[..., 0:3, 6:9] = h1 * eye3
    F[..., 0:3, 9:12] = 0.5 * h2 * dA_dba
    F[..., 0:3, 12:15] = 0.25 * h2 * h1 * G
    F[..., 3:6, 3:6] = Rw_t
    F[..., 3:6, 12:15] = -h1 * Jr
    F[..., 6:9, 3:6] = h1 * dA_dth
    F[..., 6:9, 9:12] = h1 * dA_dba
    F[..., 6:9, 12:15] = 0.5 * h2 * G

    V = R0.new_zeros(batch + (STATE_DIM, NOISE_DIM))
    V[..., 0:3, 0:3] = -0.25 * h2 * R0
    V[..., 0:3, 6:9] = -0.25 * h2 * R1
    V[..., 6:9, 0:3] = -0.5 * h1 * R0
    V[..., 6:9, 6:9] = -0.5 * h1 * R1
    for c in (3, 9):                    # ng0 and ng1 enter alike
        V[..., 0:3, c:c + 3] = 0.125 * h2 * h1 * G
        V[..., 3:6, c:c + 3] = -0.5 * h1 * Jr
        V[..., 6:9, c:c + 3] = 0.25 * h2 * G
    V[..., 9:12, 12:15] = h1 * eye3
    V[..., 12:15, 15:18] = h1 * eye3
    return F, V


def preintegrate_batch(acc: torch.Tensor, gyr: torch.Tensor,
                       dt: torch.Tensor, ba: torch.Tensor, bg: torch.Tensor,
                       noise_cov: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> Preintegrated:
    """Preintegrate B (padded) IMU sample streams at once.

    Args:
      acc, gyr: (B, N, 3) raw measurements; consecutive pairs are midpoint-
        integrated, i.e. step k uses samples k and k+1 (N-1 steps).
      dt: (B, N) where dt[:, k] is the time from sample k to k+1
        (dt[:, N-1] unused but must exist; set 0).
      ba, bg: (B, 3) linearization biases.
      noise_cov: (18,18) from `noise_covariance`.
      mask: (B, N) boolean; False entries are padding (their step is a
        no-op).  Defaults to all-valid.  Padding must be trailing.
    """
    B, N, _ = acc.shape
    n = N - 1
    dtype, dev = acc.dtype, acc.device
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.bool, device=dev)
    step_mask = mask[:, :-1] & mask[:, 1:]                       # (B,n)
    h = torch.where(step_mask, dt[:, :-1], 0.0).to(dtype)
    # a masked step sees zeros, so that garbage in the padding stays out
    m3 = step_mask[..., None]
    a0 = torch.where(m3, acc[:, :-1], 0.0) - ba[:, None]
    a1 = torch.where(m3, acc[:, 1:], 0.0) - ba[:, None]
    un_gyr = torch.where(m3, 0.5 * (gyr[:, :-1] + gyr[:, 1:]), 0.0) \
        - bg[:, None]
    w = un_gyr * h[..., None]                                    # (B,n,3)

    # orientation chain: q ← normalize(q ⊗ exp(w_k)), the one part of the
    # state that every later step needs
    step_q = _right_mul_matrix(lie.quat_exp(w))                  # (B,n,4,4)
    q = acc.new_zeros((B, 4))
    q[:, 0].fill_(1.0)
    qs = [q]
    for k in range(n):
        q_new = lie.quat_normalize((step_q[:, k] @ q[..., None])[..., 0])
        q = torch.where(step_mask[:, k, None], q_new, q)
        qs.append(q)
    qs = torch.stack(qs, dim=1)                                  # (B,N,4)
    q0, q1 = qs[:, :-1], qs[:, 1:]

    # Δv and Δp as running sums of the steps' increments
    un_acc = 0.5 * (lie.quat_rotate(q0, a0) + lie.quat_rotate(q1, a1))
    dv_after = torch.cumsum(un_acc * h[..., None], dim=1)
    dv_before = torch.cat([dv_after.new_zeros((B, 1, 3)), dv_after[:, :-1]],
                          dim=1)
    dp = torch.sum(dv_before * h[..., None]
                   + 0.5 * un_acc * (h * h)[..., None], dim=1)

    # J ← F J and P ← F P Fᵀ + V Q Vᵀ, step by step; a masked step has
    # F = I and V = 0 exactly
    F, V = _step_jacobians(lie.quat_to_mat(q0), lie.quat_to_mat(q1), w,
                           a0, a1, h)
    Q = V @ noise_cov @ V.transpose(-1, -2)                      # (B,n,15,15)
    J = torch.eye(STATE_DIM, dtype=dtype, device=dev).expand(B, -1, -1)
    P = acc.new_zeros((B, STATE_DIM, STATE_DIM))
    Ft = F.transpose(-1, -2)
    for k in range(n):
        J = F[:, k] @ J
        P = F[:, k] @ P @ Ft[:, k] + Q[:, k]
    return Preintegrated(dp=dp, dq=qs[:, -1], dv=dv_after[:, -1], J=J, P=P,
                         sum_dt=torch.sum(h, dim=1), ba=ba, bg=bg)


def preintegrate(acc: torch.Tensor, gyr: torch.Tensor, dt: torch.Tensor,
                 ba: torch.Tensor, bg: torch.Tensor, noise_cov: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> Preintegrated:
    """Preintegrate one (padded) IMU sample stream: `preintegrate_batch`
    with acc, gyr (N,3), dt and mask (N,), ba and bg (3,)."""
    pre = preintegrate_batch(acc[None], gyr[None], dt[None], ba[None],
                             bg[None], noise_cov,
                             None if mask is None else mask[None])
    return Preintegrated(*(f[0] for f in pre))


def bias_corrected_delta(pre: Preintegrated, ba_new: torch.Tensor,
                         bg_new: torch.Tensor):
    """First-order bias correction of (Δp, Δq, Δv)
    (reference: integration_base.h evaluate :175-189).  Batched over
    leading dimensions."""
    dba = (ba_new - pre.ba)[..., None]
    dbg = (bg_new - pre.bg)[..., None]
    J = pre.J
    dp = pre.dp + (J[..., 0:3, 9:12] @ dba + J[..., 0:3, 12:15] @ dbg)[..., 0]
    dv = pre.dv + (J[..., 6:9, 9:12] @ dba + J[..., 6:9, 12:15] @ dbg)[..., 0]
    dq = lie.quat_mul(pre.dq,
                      lie.quat_exp((J[..., 3:6, 12:15] @ dbg)[..., 0]))
    return dp, lie.quat_normalize(dq), dv


def imu_residual(pre: Preintegrated,
                 p_i, q_i, v_i, ba_i, bg_i,
                 p_j, q_j, v_j, ba_j, bg_j,
                 gravity) -> torch.Tensor:
    """15-dim unweighted IMU residual (integration_base.h:175-201), batched
    over leading dimensions.

    gravity: (3,) world gravity vector G (positive up-magnitude, e.g.
    [0,0,9.795]); dynamics are v̇ = R a_m - G.
    """
    dp, dq, dv = bias_corrected_delta(pre, ba_i, bg_i)
    dt = pre.sum_dt[..., None]
    qi_inv = lie.quat_conj(q_i)
    r_p = lie.quat_rotate(
        qi_inv, 0.5 * gravity * dt * dt + p_j - p_i - v_i * dt) - dp
    r_q = 2.0 * lie.quat_mul(lie.quat_conj(dq),
                             lie.quat_mul(qi_inv, q_j))[..., 1:4]
    r_v = lie.quat_rotate(qi_inv, gravity * dt + v_j - v_i) - dv
    r_ba = ba_j - ba_i
    r_bg = bg_j - bg_i
    return torch.cat([r_p, r_q, r_v, r_ba, r_bg], dim=-1)


def sqrt_information(pre: Preintegrated, eps: float = 1e-8) -> torch.Tensor:
    """Lower-triangular sqrt information L⁻¹ from the covariance P = L Lᵀ
    (reference imu_factor.h uses LLT of P.inverse()).  `cholesky_ex` does
    not wait for the device to report a failed factorization; a P that is
    not positive definite gives non-finite rows instead of an error."""
    P = pre.P
    eye = torch.eye(STATE_DIM, dtype=P.dtype, device=P.device)
    L, _ = torch.linalg.cholesky_ex(P + eps * eye)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def propagate_state(p, q, v, ba, bg, acc0, gyr0, acc1, gyr1, dt, gravity):
    """World-frame midpoint propagation for IMU-rate pose prediction
    (reference: estimator_node.cpp predict() :52-77)."""
    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    q_new = lie.quat_normalize(lie.quat_mul(q, lie.quat_exp(un_gyr * dt)))
    un_acc0 = lie.quat_rotate(q, acc0 - ba) - gravity
    un_acc1 = lie.quat_rotate(q_new, acc1 - ba) - gravity
    un_acc = 0.5 * (un_acc0 + un_acc1)
    p_new = p + v * dt + 0.5 * un_acc * dt * dt
    v_new = v + un_acc * dt
    return p_new, q_new, v_new
