"""The port's edge-sharded pose-graph CG
(``mvil_fusion_torch/parallel/sharded_pose_graph.py``) on CPU meshes of 1,
2, 4 and 8 shards, against the port's unsharded ``solve_cg`` and against
the JAX package's sharded solve on its 8-device mesh and its
single-device ``solve_cg``, on the random graph of
tests/test_sharded_pose_graph.py (N = 64, E = 256, Z = 16; 40 nodes, 120
edges, 8 z priors; 6 LM × 48 CG iterations).

Tolerances.  Against the port's unsharded solve: positions and
quaternions within 1e-5, and the same host syncs and queued iterations
(the stop flags are read as `solve_cg` reads them).  Against JAX's two
solves: 2e-4, tests/test_sharded_pose_graph.py's gate of JAX's sharded
solve against its single-device one.  The result does not depend on
`check_every` (0, 1, 16): equal to the bit.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mvil_fusion_tpu.mapping import pose_graph as jpg
from mvil_fusion_tpu.parallel.sharded_pose_graph import (
    solve_cg_sharded as jsolve_sharded)
from mvil_fusion_torch.mapping import pose_graph as tpg
from mvil_fusion_torch.parallel import mesh as tmesh
from mvil_fusion_torch.parallel.sharded_pose_graph import solve_cg_sharded
from test_sharded_pose_graph import _random_graph
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

CPU = "cpu"
KW = dict(iters=6, cg_iters=48)


@pytest.fixture(scope="module")
def solves():
    g, p_gt = _random_graph(np.random.default_rng(0))
    mesh = Mesh(np.array(jax.devices()[:8]), ("graph",))
    jax_out = {"sharded": jsolve_sharded(g, mesh, axis="graph", **KW),
               "single": jpg.solve_cg(g, **KW)}
    tg = tpg.graph_from_numpy({k: np.asarray(v) for k, v in
                               g._asdict().items()}, device=CPU)
    stats = {}
    return dict(graph=tg, p_gt=p_gt, stats=stats,
                unsharded=tpg.solve_cg(tg, stats=stats, **KW),
                jax={k: (np.asarray(v.p), np.asarray(v.q))
                     for k, v in jax_out.items()})


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_cg_matches_unsharded_and_reference(solves, n):
    mesh = tmesh.make_mesh(axis="graph", devices=[CPU] * n)
    stats = {}
    out = solve_cg_sharded(solves["graph"], mesh, axis="graph",
                           stats=stats, **KW)
    ref = solves["unsharded"]
    np.testing.assert_allclose(out.p.numpy(), ref.p.numpy(), atol=1e-5)
    np.testing.assert_allclose(out.q.numpy(), ref.q.numpy(), atol=1e-5)
    assert stats == solves["stats"]
    for p, q in solves["jax"].values():
        np.testing.assert_allclose(out.p.numpy(), p, atol=2e-4)
        np.testing.assert_allclose(out.q.numpy(), q, atol=2e-4)
    # and the solve improved the graph toward the ground truth
    n_live = len(solves["p_gt"])
    err0 = np.linalg.norm(solves["graph"].p.numpy()[:n_live]
                          - solves["p_gt"], axis=1).mean()
    err1 = np.linalg.norm(out.p.numpy()[:n_live] - solves["p_gt"],
                          axis=1).mean()
    assert err1 < 0.9 * err0


@pytest.mark.parametrize("check_every", [0, 1, 16])
def test_result_does_not_depend_on_check_every(solves, check_every):
    mesh = tmesh.make_mesh(axis="graph", devices=[CPU] * 4)
    base = solve_cg_sharded(solves["graph"], mesh, **KW)
    stats = {}
    out = solve_cg_sharded(solves["graph"], mesh, check_every=check_every,
                           stats=stats, **KW)
    assert torch.equal(out.p, base.p) and torch.equal(out.q, base.q)
    assert stats["syncs"] == (0 if check_every == 0 else KW["iters"] * -(
        -KW["cg_iters"] // check_every))


def test_capacities_must_divide_into_the_shards(solves):
    mesh = tmesh.make_mesh(devices=[CPU] * 3)
    with pytest.raises(ValueError, match="pad with masked slots"):
        solve_cg_sharded(solves["graph"], mesh, **KW)
    with pytest.raises(ValueError, match="axis"):
        solve_cg_sharded(solves["graph"], mesh, axis="graph", **KW)
