"""Host-side (numpy) pose/quaternion helpers.

Counterpart of ``mvil_fusion_tpu/utils/nplie.py``.  The device versions
live in utils/lie.py; these exist so that per-event host bookkeeping
(pose-graph chaining, radius loops, trajectory logs) reads the mapper's
host mirror and never waits for the device.
Quaternions are (w, x, y, z), matching utils/lie.py.
"""

from __future__ import annotations

import numpy as np


def quat_to_mat(q):
    w, x, y, z = np.asarray(q, np.float64)
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def quat_mul(a, b):
    aw, ax, ay, az = np.asarray(a, np.float64)
    bw, bx, by, bz = np.asarray(b, np.float64)
    return np.asarray([aw * bw - ax * bx - ay * by - az * bz,
                       aw * bx + ax * bw + ay * bz - az * by,
                       aw * by - ax * bz + ay * bw + az * bx,
                       aw * bz + ax * by - ay * bx + az * bw])


def quat_conj(q):
    w, x, y, z = np.asarray(q, np.float64)
    return np.asarray([w, -x, -y, -z])


def quat_normalize(q):
    q = np.asarray(q, np.float64)
    return q / max(np.linalg.norm(q), 1e-12)


def quat_rotate(q, v):
    return quat_to_mat(q) @ np.asarray(v, np.float64)


def quat_rotate_inv(q, v):
    return quat_to_mat(q).T @ np.asarray(v, np.float64)


def pose_between(p_i, q_i, p_j, q_j):
    """T_i⁻¹ ∘ T_j → (dp, dq): j expressed in i's frame."""
    dq = quat_normalize(quat_mul(quat_conj(q_i), q_j))
    dp = quat_rotate_inv(q_i, np.asarray(p_j, np.float64)
                         - np.asarray(p_i, np.float64))
    return dp.astype(np.float32), dq.astype(np.float32)


def pose_compose(p_i, q_i, dp, dq):
    """T_i ∘ T_delta."""
    q = quat_normalize(quat_mul(q_i, dq))
    p = np.asarray(p_i, np.float64) + quat_rotate(q_i, dp)
    return p.astype(np.float32), q.astype(np.float32)
