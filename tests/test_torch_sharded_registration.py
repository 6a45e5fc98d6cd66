"""The port's point-sharded VGICP
(``mvil_fusion_torch/parallel/sharded_registration.py``) on CPU meshes of
1, 2, 4 and 8 shards, against the port's unsharded ``vgicp_align`` and
against the JAX package's sharded aligner on its 8-device mesh and its
single-device ``vgicp_align``, on the sweep pair of
tests/test_sharded_registration.py (two deskewed sweeps of 16 × 900
points 0.2 s apart, the source downsampled to 4096 points, 10 iterations
from a perturbed guess).  Every solve gets the same points and the same
voxel maps (the port's, handed to JAX as arrays), as
tests/test_torch_vgicp.py compares the packages on the same maps.

Tolerances.  Against the port's unsharded solve: within 1e-5 m and 1e-5
rad, `n_corr` equal, fitness within 1e-6 (only the order of the sums
differs).  Against JAX's two solves: tests/test_sharded_registration.py's
gates of JAX's sharded solve against its own single-device one, 1e-3 m,
1e-3 rad, `n_corr` within 2; and the truth within 0.06 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu.io.synthetic import _quat_to_mat
from mvil_fusion_tpu.ops import vgicp as jvg
from mvil_fusion_tpu.parallel import mesh as jmesh
from mvil_fusion_tpu.parallel import sharded_registration as jsreg
from mvil_fusion_tpu.utils import lie as jlie
from mvil_fusion_torch.ops import voxel as tvox
from mvil_fusion_torch.ops import vgicp as tvg
from mvil_fusion_torch.parallel import mesh as tmesh
from mvil_fusion_torch.parallel import sharded_registration as tsreg
from mvil_fusion_torch.utils import lie as tlie
from test_sharded_registration import _pair
from test_torch_vgicp import _as_jax_map
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

CPU = "cpu"
ITERS = 10
LEAF = 0.5


@pytest.fixture(scope="module")
def solves():
    (tgt, tm, (pt, qt)), (src, sm, (ps, qs)) = _pair()
    Rt, Rs = _quat_to_mat(qt), _quat_to_mat(qs)
    t_rel = Rt.T @ (ps - pt)
    q0 = jlie.quat_boxplus(
        jlie.mat_to_quat(jnp.asarray(Rt.T @ Rs, jnp.float32)),
        jnp.asarray([0.03, -0.02, 0.04]))
    p0 = jnp.asarray(t_rel, jnp.float32) + jnp.asarray([0.1, -0.08, 0.05])
    up = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    tgt_map = tvox.build_gaussian_voxel_map(up(tgt), up(tm), LEAF)
    src_map = tvox.build_gaussian_voxel_map(up(src), up(sm), LEAF)
    reg = tvox.voxel_downsample(up(src), up(sm), LEAF, 4096)
    jt, js = _as_jax_map(tgt_map), _as_jax_map(src_map)
    jpts, jmask = jnp.asarray(reg.pts.numpy()), jnp.asarray(reg.mask.numpy())
    mesh = jmesh.make_mesh(8)
    j_sharded = jsreg.make_sharded_vgicp(mesh, iters=ITERS)(
        *jsreg.shard_points(mesh, jpts, jmask), jt, js, p0, q0)
    j_single = jvg.vgicp_align(jpts, jmask, jt, js, p0, q0, iters=ITERS)
    tp0, tq0 = up(p0), up(q0)
    return dict(
        pts=reg.pts, mask=reg.mask, maps=(tgt_map, src_map), p0=tp0,
        q0=tq0, t_rel=t_rel,
        unsharded=tvg.vgicp_align(reg.pts, reg.mask, tgt_map, src_map, tp0,
                                  tq0, iters=ITERS),
        jax=[j_sharded, j_single])


def check(res, ref, p_tol, q_tol, n_tol):
    p_ref, q_ref = np.asarray(ref.p), torch.as_tensor(np.array(ref.q))
    assert np.abs(res.p.numpy() - p_ref).max() < p_tol
    assert float(torch.linalg.vector_norm(
        tlie.quat_boxminus(res.q, q_ref))) < q_tol
    assert abs(int(res.n_corr) - int(ref.n_corr)) <= n_tol


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_vgicp_matches_unsharded_and_reference(solves, n):
    mesh = tmesh.make_mesh(devices=[CPU] * n)
    pts, mask = tsreg.shard_points(mesh, solves["pts"], solves["mask"])
    assert [x.shape[0] for x in pts] == [4096 // n] * n
    res = tsreg.make_sharded_vgicp(mesh, iters=ITERS)(
        pts, mask, *solves["maps"], solves["p0"], solves["q0"])
    ref = solves["unsharded"]
    check(res, ref, 1e-5, 1e-5, 0)
    assert abs(float(res.fitness) - float(ref.fitness)) < 1e-6
    assert bool(res.converged) == bool(ref.converged)
    for j in solves["jax"]:
        check(res, j, 1e-3, 1e-3, 2)
    assert int(res.n_corr) > 1000
    assert np.linalg.norm(res.p.numpy() - solves["t_rel"]) < 0.06
