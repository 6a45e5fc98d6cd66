"""The port's VGICP registration against the JAX package's
(``ops/vgicp.py``) on the two scenarios of tests/test_lidar_ops.py: two
sweeps 0.2 s apart from a perturbed initial pose, and a sweep against
itself.  Both packages get the same deskewed numpy clouds.

Tolerances.  On the same voxel maps (the port's, handed to the JAX
function as arrays) the two alignments agree to 1e-5 m and 1e-5 rad, with
equal `n_corr` and `fitness` within 1e-5: far inside the 2 mm / 0.05° the
registration is held to.  With each package building its own maps the
poses differ by up to 1 cm and 0.15°, and are held to 1.5 cm / 0.3°,
`n_corr` within 1 % and `fitness` within 1e-3: a synthetic wall is an
exact plane, so a voxel's smallest covariance eigenvalue (~1e-8 m²) lies
below the rounding of cov = E[xxᵀ] − mean·meanᵀ in fp32 (~1e-5 m²), and on
a scan line two eigenvalues do.  The plane normal of such a voxel is
rounding noise in both packages: against float64 each has about 70 % of
its normals right, and they are not the same 70 %.  Both land as close to
the true motion (the gates of tests/test_lidar_ops.py).  `_inv3` within
1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu.io.synthetic import SyntheticTrajectory, _quat_to_mat
from mvil_fusion_tpu.io.synthetic_lidar import BoxWorld, simulate_sweep
from mvil_fusion_tpu.ops import deskew as jdsk
from mvil_fusion_tpu.ops import vgicp as jvg
from mvil_fusion_tpu.ops import voxel as jvox
from mvil_fusion_tpu.utils import lie as jlie
from mvil_fusion_torch.ops import vgicp as tvg
from mvil_fusion_torch.ops import voxel as tvox
from mvil_fusion_torch.utils import lie as tlie
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401


TRAJ = SyntheticTrajectory(duration=4.0, w_amp=(0.3, 0.25, 0.6),
                           w_freq=(0.3, 0.25, 0.35),
                           p_amp=(1.0, 0.9, 0.3), p_freq=(0.3, 0.37, 0.21),
                           lin_vel=(0.6, 0.3, 0.0))
LEAF = 0.5
TABLE = 1 << 16

_jbuild = jax.jit(jvox.build_gaussian_voxel_map,
                  static_argnames=("leaf", "table_size"))
_jalign = jax.jit(jvg.vgicp_align,
                  static_argnames=("iters", "max_corr_dist", "eps"))


@pytest.fixture(scope="module")
def sweeps():
    """Two sweeps of 16 × 450 points deskewed to their end frames with the
    true poses: [(pts, mask, (p_end, q_end))]."""
    out = []
    for t0 in (1.0, 1.2):
        s = simulate_sweep(BoxWorld(), TRAJ, t_start=t0, n_azimuth=450)
        p0, q0 = TRAJ.pose_at(s["t_start"])
        p1, q1 = TRAJ.pose_at(s["t_end"])
        f32 = jnp.float32
        pts = jdsk.deskew_to_end(
            jnp.asarray(s["pts"]), jnp.asarray(s["rel_time"]),
            jnp.asarray(p0, f32), jnp.asarray(q0, f32),
            jnp.asarray(p1, f32), jnp.asarray(q1, f32), 0.1)
        out.append((np.asarray(pts), s["mask"], (p1, q1)))
    return out


def _as_jax_map(vm):
    return jvox.GaussianVoxelMap(
        mean=jnp.asarray(vm.mean.numpy()), cov=jnp.asarray(vm.cov.numpy()),
        count=jnp.asarray(vm.count.numpy()),
        coords=jnp.asarray(vm.coords.numpy()), leaf=vm.leaf,
        table_size=vm.table_size)


def _align_both(src, src_m, tgt, tgt_m, p0, q0, iters, same_map=False,
                own_maps=True):
    """(JAX result, port result).  `same_map`: the target map is also the
    source map.  `own_maps` False: JAX gets the port's maps."""
    tm = lambda a, m: tvox.build_gaussian_voxel_map(
        torch.as_tensor(a.copy()), torch.as_tensor(m.copy()), LEAF,
        table_size=TABLE)
    jm = (lambda a, m: _jbuild(jnp.asarray(a), jnp.asarray(m), leaf=LEAF,
                               table_size=TABLE)) if own_maps else \
        (lambda a, m: _as_jax_map(tm(a, m)))
    tgt_j, tgt_t = jm(tgt, tgt_m), tm(tgt, tgt_m)
    src_j, src_t = (tgt_j, tgt_t) if same_map else (jm(src, src_m),
                                                    tm(src, src_m))
    rj = _jalign(jnp.asarray(src), jnp.asarray(src_m), tgt_j, src_j,
                 jnp.asarray(p0), jnp.asarray(q0), iters=iters)
    rt = tvg.vgicp_align(torch.as_tensor(src.copy()),
                         torch.as_tensor(src_m.copy()), tgt_t, src_t, torch.as_tensor(p0),
                         torch.as_tensor(q0), iters=iters)
    return rj, rt


def _assert_close(rt, rj, own_maps=True):
    p_tol, q_tol, n_tol, f_tol = (1.5e-2, np.radians(0.3), 0.01, 1e-3) \
        if own_maps else (1e-5, 1e-5, 0.0, 1e-5)
    assert np.linalg.norm(rt.p.numpy() - np.asarray(rj.p)) < p_tol
    dq = tlie.quat_boxminus(rt.q, torch.as_tensor(np.asarray(rj.q)))
    assert float(torch.linalg.vector_norm(dq)) < q_tol
    assert rt.n_corr.dtype == torch.int64
    assert abs(int(rt.n_corr) - int(rj.n_corr)) <= n_tol * int(rj.n_corr)
    assert abs(float(rt.fitness) - float(rj.fitness)) < f_tol
    if not own_maps:
        assert bool(rt.converged) == bool(rj.converged)


@pytest.mark.parametrize("own_maps", [False, True])
def test_vgicp_recovers_relative_pose_as_jax_does(sweeps, own_maps):
    (tgt, tgt_m, (p_t, q_t)), (src, src_m, (p_s, q_s)) = sweeps
    R_t, R_s = _quat_to_mat(q_t), _quat_to_mat(q_s)
    R_rel = (R_t.T @ R_s).astype(np.float32)
    t_rel = R_t.T @ (p_s - p_t)
    q_true = jlie.mat_to_quat(jnp.asarray(R_rel))
    q0 = np.asarray(jlie.quat_boxplus(q_true,
                                      jnp.asarray([0.03, -0.02, 0.04])))
    p0 = (t_rel + np.asarray([0.1, -0.08, 0.05])).astype(np.float32)
    rj, rt = _align_both(src, src_m, tgt, tgt_m, p0, q0, iters=12,
                         own_maps=own_maps)
    _assert_close(rt, rj, own_maps)
    # and the port recovers the true motion by itself
    assert int(rt.n_corr) > 1000
    assert np.linalg.norm(rt.p.numpy() - t_rel) < 0.05
    r_err = tlie.quat_boxminus(rt.q, torch.as_tensor(np.asarray(q_true)))
    assert float(torch.linalg.vector_norm(r_err)) < 0.02
    assert float(rt.fitness) < 0.15


@pytest.mark.parametrize("own_maps", [False, True])
def test_vgicp_identity_when_same_cloud(sweeps, own_maps):
    (tgt, tgt_m, _), _ = sweeps
    p0 = np.zeros(3, np.float32)
    q0 = np.asarray([1, 0, 0, 0], np.float32)
    rj, rt = _align_both(tgt, tgt_m, tgt, tgt_m, p0, q0, iters=6,
                         same_map=True, own_maps=own_maps)
    _assert_close(rt, rj, own_maps)
    assert np.linalg.norm(rt.p.numpy()) < 1e-3
    assert float(rt.fitness) < 0.08


def test_vgicp_without_correspondences_keeps_the_guess(sweeps):
    """Nothing within range: the damped normal equations give a zero step
    and the count is 0 (an integer)."""
    (tgt, tgt_m, _), _ = sweeps
    p0 = np.asarray([500.0, 0, 0], np.float32)
    q0 = np.asarray([1, 0, 0, 0], np.float32)
    rj, rt = _align_both(tgt, tgt_m, tgt, tgt_m, p0, q0, iters=3,
                         same_map=True)
    assert int(rt.n_corr) == int(rj.n_corr) == 0
    np.testing.assert_array_equal(rt.p.numpy(), p0)
    assert float(rt.fitness) == 0.0 and not bool(rt.converged)


@pytest.mark.parametrize("seed", [0, 1])
def test_inv3_matches_jax(seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(200, 3, 3))
    C = (A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3)).astype(np.float32)
    C[0] = 0.0          # singular: only the eps on the diagonal is left
    it = tvg._inv3(torch.as_tensor(C)).numpy()
    ij = np.asarray(jvg._inv3(jnp.asarray(C)))
    np.testing.assert_allclose(it, ij, rtol=1e-5,
                               atol=1e-5 * np.abs(ij).max())
    eye = np.einsum("nij,njk->nik", it[1:], C[1:] + 1e-6 * np.eye(3))
    np.testing.assert_allclose(eye, np.tile(np.eye(3), (199, 1, 1)),
                               atol=5e-3)
