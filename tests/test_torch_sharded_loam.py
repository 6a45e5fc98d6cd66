"""The port's query-sharded LOAM scan-to-map
(``mvil_fusion_torch/parallel/sharded_loam.py``) on CPU meshes of 1, 2, 4
and 8 shards, against the port's unsharded ``loam_icp.scan_to_map`` and
against the JAX package's sharded solve on its 8-device mesh and its
single-device solve, on the world of tests/test_sharded_loam.py (128
corners and 256 surfs against 1024/2048-point maps, 2 outer × 3
Gauss-Newton iterations from the identity; every shard runs the k-NN on
its own block of queries).

Tolerances.  The first association (at the common starting pose) gives
the same edge and plane counts exactly: each query is associated on its
own.  Against the port's unsharded solve: the final pose within 1e-4 m
and |q·q_ref| within 1e-6 of 1, as tests/test_sharded_loam.py holds
JAX's sharded solve to its single-device one, and the final counts
within 1 % (the sharded normal equations are summed in another order,
and a re-association can flip a plane at its fit gates: MULTICHIP_r05
lost 69 of ~1400 planes that way at reference scale); measured 2.4e-8 m
and equal counts.  Against JAX: tests/test_torch_loam.py's tolerances of
scan_to_map across the packages, 1.5e-2 m, 2e-3 rad and counts within
3 %: on this world one ulp of the surf map moves JAX's solve by 1.5 mm
and the port's by 11.9 mm and flips a plane; the packages lie 4.7e-3 m
and 6.9e-4 rad apart with equal counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu.ops import loam_icp as jloam
from mvil_fusion_tpu.parallel import mesh as jmesh
from mvil_fusion_tpu.parallel import sharded_loam as jsl
from mvil_fusion_tpu.utils import lie as jlie
from mvil_fusion_torch.ops import loam_icp as tloam
from mvil_fusion_torch.parallel import mesh as tmesh
from mvil_fusion_torch.parallel import sharded_loam as tsl
from test_sharded_loam import _world
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

CPU = "cpu"
OUTER, GN = 2, 3
OFFSET = np.asarray([0.06, -0.04, 0.02])


@pytest.fixture(scope="module")
def solves():
    args = tuple(np.asarray(a) for a in _world(np.random.default_rng(0)))
    jargs = tuple(jnp.asarray(a) for a in args)
    p0, q0 = jnp.zeros(3), jlie.quat_identity()
    mesh = jmesh.make_mesh(8)
    s2m = jsl.make_sharded_scan_to_map(mesh, outer_iters=OUTER,
                                       gn_iters=GN)
    j_sharded = s2m(*jsl.shard_features(mesh, *jargs[:4]), *jargs[4:], p0,
                    q0)
    j_single = jloam.scan_to_map(*jargs, p0, q0, outer_iters=OUTER,
                                 gn_iters=GN)
    j_first = jloam.find_correspondences(*jargs, p0, q0)
    targs = tuple(torch.as_tensor(a.copy()) for a in args)
    tp0, tq0 = torch.zeros(3), torch.tensor([1.0, 0.0, 0.0, 0.0])
    return dict(
        targs=targs, p0=tp0, q0=tq0,
        unsharded=tloam.scan_to_map(*targs, tp0, tq0, outer_iters=OUTER,
                                    gn_iters=GN),
        jax={name: [np.asarray(x) for x in out[:4]]
             for name, out in (("sharded", j_sharded),
                               ("single", j_single))},
        first=(int(np.sum(j_first.edge_ok)), int(np.sum(j_first.plane_ok))))


def angle(q, q_ref):
    return 2.0 * np.arccos(min(abs(float(np.dot(q, q_ref))), 1.0))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_scan_to_map_matches_unsharded_and_reference(solves, n):
    mesh = tmesh.make_mesh(devices=[CPU] * n)
    targs, p0, q0 = solves["targs"], solves["p0"], solves["q0"]
    shards = tsl.shard_features(mesh, *targs[:4])
    assert [x.shape[0] for x in shards[2]] == [256 // n] * n

    # the first association, shard by shard, at the starting pose
    first = [tloam.find_correspondences(*(x[k] for x in shards),
                                        *targs[4:], p0, q0)
             for k in range(n)]
    counts = (sum(int(c.edge_ok.sum()) for c in first),
              sum(int(c.plane_ok.sum()) for c in first))
    whole = tloam.find_correspondences(*targs, p0, q0)
    assert counts == (int(whole.edge_ok.sum()), int(whole.plane_ok.sum()))
    assert counts == solves["first"]

    p, q, n_edge, n_plane = tsl.make_sharded_scan_to_map(
        mesh, outer_iters=OUTER, gn_iters=GN)(*shards, *targs[4:], p0, q0)
    p, q = p.numpy(), q.numpy()
    up, uq, ue, upl, _ = solves["unsharded"]
    np.testing.assert_allclose(p, up.numpy(), atol=1e-4)
    np.testing.assert_allclose(abs(float(np.dot(q, uq.numpy()))), 1.0,
                               atol=1e-6)
    for got, want in ((n_edge, ue), (n_plane, upl)):
        assert abs(int(got) - int(want)) <= 0.01 * int(want)
    for jp, jq, je, jpl in solves["jax"].values():
        np.testing.assert_allclose(p, jp, atol=1.5e-2)
        assert angle(q, jq) < 2e-3
        for got, want in ((n_edge, je), (n_plane, jpl)):
            assert abs(int(got) - int(want)) <= 0.03 * int(want)
    # and the solve converged toward the injected offset
    assert np.linalg.norm(p + OFFSET) < 0.05
