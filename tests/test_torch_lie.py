"""Parity of the port's Lie math (mvil_fusion_torch/utils/lie.py) with the
JAX reference (mvil_fusion_tpu/utils/lie.py): every function on the same
seeded numpy inputs, within atol 1e-6 (fp32 on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu.utils import lie as jlie
from mvil_fusion_torch.utils import lie as tlie

ATOL = 1e-6
N = 64


def _quats(rng, n=N):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _vecs(rng, n=N, scale=1.0):
    return (rng.normal(size=(n, 3)) * scale).astype(np.float32)


def _rotvecs(rng, n=N):
    # mix of ordinary angles and angles inside the Taylor branch
    phi = _vecs(rng, n)
    phi[: n // 4] *= 1e-5
    phi[n // 4: n // 4 + 2] = 0.0
    return phi


def _vecs4(rng, n=N):
    return (2.0 * rng.normal(size=(n, 4))).astype(np.float32)


def _mats(rng, n=N):
    return np.array(jlie.quat_to_mat(jnp.asarray(_quats(rng, n))))


# name -> function of rng that makes the tuple of numpy arguments
CASES = {
    "quat_normalize": lambda r: (_vecs4(r),),
    "quat_canonical": lambda r: (_quats(r),),
    "quat_conj": lambda r: (_quats(r),),
    "quat_mul": lambda r: (_quats(r), _quats(r)),
    "quat_rotate": lambda r: (_quats(r), _vecs(r, N, 10.0)),
    "quat_rotate_inv": lambda r: (_quats(r), _vecs(r, N, 10.0)),
    "quat_to_mat": lambda r: (_quats(r),),
    "mat_to_quat": lambda r: (_mats(r),),
    "quat_exp": lambda r: (_rotvecs(r),),
    "quat_log": lambda r: (_quats(r),),
    "delta_q": lambda r: (_vecs(r, N, 0.1),),
    "quat_slerp": lambda r: (_quats(r), _quats(r),
                             r.uniform(0, 1, N).astype(np.float32)),
    "quat_boxplus": lambda r: (_quats(r), _rotvecs(r)),
    "quat_boxminus": lambda r: (_quats(r), _quats(r)),
    "skew": lambda r: (_vecs(r),),
    "so3_exp": lambda r: (_rotvecs(r),),
    "so3_log": lambda r: (_mats(r),),
    "so3_left_jacobian": lambda r: (_rotvecs(r),),
    "so3_right_jacobian": lambda r: (_rotvecs(r),),
    "pose_compose": lambda r: (_vecs(r), _quats(r), _vecs(r), _quats(r)),
    "pose_inverse": lambda r: (_vecs(r), _quats(r)),
    "pose_apply": lambda r: (_vecs(r), _quats(r), _vecs(r)),
    "pose_between": lambda r: (_vecs(r), _quats(r), _vecs(r), _quats(r)),
    "mat_to_ypr": lambda r: (_mats(r),),
    "ypr_to_mat": lambda r: (r.uniform(-1.5, 1.5, (N, 3)).astype(np.float32),),
    "g2R": lambda r: (_vecs(r, N, 9.8),),
}


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lie_function_matches_jax(rng, name):
    args = CASES[name](rng)
    out_j = _as_tuple(getattr(jlie, name)(*[jnp.asarray(a) for a in args]))
    out_t = _as_tuple(getattr(tlie, name)(*[torch.as_tensor(a)
                                            for a in args]))
    assert len(out_j) == len(out_t)
    for oj, ot in zip(out_j, out_t):
        assert ot.dtype == torch.float32
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                                   atol=ATOL)


def test_quat_identity():
    np.testing.assert_array_equal(tlie.quat_identity().numpy(),
                                  np.asarray(jlie.quat_identity()))


def test_quat_exp_forward_jacobian_finite_at_zero():
    """Both `where` branches of quat_exp stay finite at δ = 0, so the
    forward-mode jacobian there is finite and equals the reference's."""
    zero = np.zeros(3, np.float32)
    jac_j = np.asarray(jax.jacfwd(jlie.quat_exp)(jnp.asarray(zero)))
    jac_t = torch.func.jacfwd(tlie.quat_exp)(torch.as_tensor(zero)).numpy()
    assert np.isfinite(jac_t).all()
    np.testing.assert_allclose(jac_t, jac_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(jac_t[1:], 0.5 * np.eye(3), atol=ATOL)
