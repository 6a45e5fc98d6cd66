"""SO(3)/SE(3)/quaternion math in PyTorch.

Counterpart of ``mvil_fusion_tpu/utils/lie.py``, function for function.
Every function is batched over leading dimensions (quaternion/vector data
in the trailing dimension), preserves dtype and runs on the device of its
inputs.

Conventions
-----------
* Quaternions are Hamilton, stored ``(w, x, y, z)``, unit norm, acting as
  ``v' = q ⊗ v ⊗ q*`` (i.e. ``quat_rotate(q, v) == quat_to_mat(q) @ v``).
* Pose perturbations are *right* (body-frame) perturbations:
  ``q ⊞ δθ = q ⊗ exp(δθ/2)``.
* ``g2R`` reproduces the reference's gravity alignment with zeroed yaw.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# Quaternion primitives
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / _norm(q, keepdim=True).clamp_min(_EPS)


def quat_canonical(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so w >= 0 (double cover canonicalization)."""
    return torch.where(q[..., :1] < 0, -q, q)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q.  v' = R(q) v."""
    qw = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → quaternion (w,x,y,z), branch-free (Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate 4*q*q_k formulations; pick the numerically largest pivot.
    qw0 = torch.sqrt((1.0 + tr).clamp_min(0.0)) / 2
    c0 = torch.stack([qw0, (m21 - m12) / (4 * qw0 + _EPS),
                      (m02 - m20) / (4 * qw0 + _EPS),
                      (m10 - m01) / (4 * qw0 + _EPS)], dim=-1)
    qx1 = torch.sqrt((1.0 + m00 - m11 - m22).clamp_min(0.0)) / 2
    c1 = torch.stack([(m21 - m12) / (4 * qx1 + _EPS), qx1,
                      (m01 + m10) / (4 * qx1 + _EPS),
                      (m02 + m20) / (4 * qx1 + _EPS)], dim=-1)
    qy2 = torch.sqrt((1.0 - m00 + m11 - m22).clamp_min(0.0)) / 2
    c2 = torch.stack([(m02 - m20) / (4 * qy2 + _EPS),
                      (m01 + m10) / (4 * qy2 + _EPS), qy2,
                      (m12 + m21) / (4 * qy2 + _EPS)], dim=-1)
    qz3 = torch.sqrt((1.0 - m00 - m11 + m22).clamp_min(0.0)) / 2
    c3 = torch.stack([(m10 - m01) / (4 * qz3 + _EPS),
                      (m02 + m20) / (4 * qz3 + _EPS),
                      (m12 + m21) / (4 * qz3 + _EPS), qz3], dim=-1)

    # Pivot selection identical to the classic branchy algorithm.
    use0 = tr > 0
    use1 = ~use0 & (m00 >= m11) & (m00 >= m22)
    use2 = ~use0 & ~use1 & (m11 >= m22)
    q = torch.where(use0[..., None], c0,
                    torch.where(use1[..., None], c1,
                                torch.where(use2[..., None], c2, c3)))
    return quat_normalize(quat_canonical(q))


def quat_exp(phi: torch.Tensor) -> torch.Tensor:
    """Exponential map: rotation vector (axis*angle, 3) → quaternion.

    Taylor-safe at the origin.  theta carries an _EPS² floor under the
    square root so that both `where` branches, and their forward-mode
    derivatives, stay finite at phi = 0.
    """
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    half = 0.5 * theta
    small = theta2 < 1e-8
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    s = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return torch.cat([w, s * phi], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Log map: quaternion → rotation vector (3,). Angle in [0, pi]."""
    q = quat_canonical(quat_normalize(q))
    w = q[..., :1].clamp(-1.0, 1.0)
    qv = q[..., 1:]
    n = _norm(qv, keepdim=True)
    angle = 2.0 * torch.atan2(n, w)
    small = n < 1e-6
    scale = torch.where(small, 2.0 / w.clamp_min(_EPS),
                        angle / n.clamp_min(_EPS))
    return scale * qv


def delta_q(theta: torch.Tensor) -> torch.Tensor:
    """First-order quaternion from a small angle: [1, θ/2], normalized."""
    half = 0.5 * theta
    one = torch.ones(theta.shape[:-1] + (1,), dtype=theta.dtype,
                     device=theta.device)
    return quat_normalize(torch.cat([one, half], dim=-1))


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation, shortest arc, lerp fallback for tiny angles."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d).clamp(-1.0, 1.0)
    theta = torch.arccos(d.clamp(0.0, 1.0 - 1e-7))
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    t = t[..., None] if t.ndim < d.ndim else t
    small = sin_theta < 1e-5
    w0 = torch.where(small, 1.0 - t,
                     torch.sin((1.0 - t) * theta) / sin_theta.clamp_min(_EPS))
    w1 = torch.where(small, t,
                     torch.sin(t * theta) / sin_theta.clamp_min(_EPS))
    return quat_normalize(w0 * q0 + w1 * q1)


def quat_boxplus(q: torch.Tensor, dtheta: torch.Tensor) -> torch.Tensor:
    """Right (body-frame) perturbation: q ⊗ exp(δθ)."""
    return quat_normalize(quat_mul(q, quat_exp(dtheta)))


def quat_boxminus(q1: torch.Tensor, q0: torch.Tensor) -> torch.Tensor:
    """Local difference: log(q0^{-1} ⊗ q1)."""
    return quat_log(quat_mul(quat_conj(q0), q1))


# ---------------------------------------------------------------------------
# so(3) matrix forms
# ---------------------------------------------------------------------------

def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation vector → rotation matrix (Rodrigues, Taylor-safe)."""
    return quat_to_mat(quat_exp(phi))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    return quat_log(mat_to_quat(R))


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3):
    exp((phi+dphi)^) ≈ exp(J_l dphi ^) exp(phi^)."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = skew(phi)
    K2 = K @ K
    I = torch.eye(3, dtype=phi.dtype, device=phi.device)
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1 - torch.cos(theta)) / theta2.clamp_min(_EPS))
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / (theta2 * theta).clamp_min(_EPS))
    return I + a * K + b * K2


def so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    return so3_left_jacobian(-phi)


# ---------------------------------------------------------------------------
# SE(3) poses as (p[3], q[4]) pairs
# ---------------------------------------------------------------------------

def pose_compose(p1, q1, p2, q2):
    """T1 * T2 for T = (p, q): (p1 + R1 p2, q1 q2)."""
    return p1 + quat_rotate(q1, p2), quat_normalize(quat_mul(q1, q2))


def pose_inverse(p, q):
    qi = quat_conj(q)
    return -quat_rotate(qi, p), qi


def pose_apply(p, q, x):
    """Transform point(s) x by pose (p, q)."""
    return quat_rotate(q, x) + p


def pose_between(p1, q1, p2, q2):
    """T1^{-1} * T2."""
    qi = quat_conj(q1)
    return quat_rotate(qi, p2 - p1), quat_normalize(quat_mul(qi, q2))


# ---------------------------------------------------------------------------
# Euler / gravity helpers (reference semantics)
# ---------------------------------------------------------------------------

def mat_to_ypr(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → (yaw, pitch, roll) in radians, ZYX convention."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.atan2(-R[..., 2, 0],
                        R[..., 0, 0] * torch.cos(yaw)
                        + R[..., 1, 0] * torch.sin(yaw))
    roll = torch.atan2(R[..., 0, 2] * torch.sin(yaw)
                       - R[..., 1, 2] * torch.cos(yaw),
                       -R[..., 0, 1] * torch.sin(yaw)
                       + R[..., 1, 1] * torch.cos(yaw))
    return torch.stack([yaw, pitch, roll], dim=-1)


def ypr_to_mat(ypr: torch.Tensor) -> torch.Tensor:
    """(yaw, pitch, roll) radians → rotation matrix, R = Rz(y) Ry(p) Rx(r)."""
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    m = torch.stack(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def g2R(g: torch.Tensor) -> torch.Tensor:
    """Rotation R0 aligning measured gravity direction g to +z with zero yaw.

    R0 @ normalize(g) == [0,0,1]; yaw(R0) == 0.
    """
    ng1 = g / _norm(g, keepdim=True).clamp_min(_EPS)
    ng2 = torch.tensor([0.0, 0.0, 1.0], dtype=g.dtype, device=g.device)
    # Rotation taking ng1 to ng2 (axis = ng1 × ng2).
    axis = _cross(ng1, ng2)
    s = _norm(axis)
    c = torch.sum(ng1 * ng2, dim=-1)
    angle = torch.atan2(s, c)
    axis = axis / s[..., None].clamp_min(_EPS)
    R0 = so3_exp(axis * angle[..., None])
    # Zero out yaw.
    yaw = mat_to_ypr(R0)[..., 0]
    ypr = torch.stack([-yaw, torch.zeros_like(yaw), torch.zeros_like(yaw)],
                      dim=-1)
    return ypr_to_mat(ypr) @ R0
