"""The port's feature-sharded bundle adjustment
(``mvil_fusion_torch/parallel/sharded_ba.py``) on CPU meshes of 1, 2, 4
and 8 shards, against the port's unsharded ``ba.solve`` and against the
JAX package's sharded solver on its 8-device mesh and its single-device
solve, on the window of tests/test_sharded_ba.py (W = 7, F = 64, 6
iterations from a perturbed state).

Tolerances are those of tests/test_sharded_ba.py, sharded against
unsharded: cost0 within 1e-4 relative, cost1 within 0.2 relative (later
iterations may part through accept/reject decisions at the cost's
rounding), positions within 2e-3 m, inverse depths within 5e-3, the same
accepted count.  The shards' partials are summed in another order than
one JᵀJ sums them, and than XLA's psum sums JAX's, so nothing is held to
the bit.
"""

import jax
import numpy as np
import pytest
import torch

from helpers import build_window_problem, make_problem, perturb_state
from mvil_fusion_tpu.estimator import ba as jba
from mvil_fusion_tpu.io.synthetic import SyntheticTrajectory, SyntheticWorld
from mvil_fusion_tpu.parallel import mesh as jmesh
from mvil_fusion_tpu.parallel import sharded_ba as jsba
from mvil_fusion_torch.estimator import ba as tba
from mvil_fusion_torch.estimator import state as tst
from mvil_fusion_torch.parallel import mesh as tmesh
from mvil_fusion_torch.parallel import sharded_ba as tsba
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

FOCAL = 460.0
ITERS = 6
CPU = "cpu"


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def solves():
    """The window, the JAX solves (8-device mesh and single device) and the
    port's unsharded solve, once per module."""
    world = SyntheticWorld(
        traj=SyntheticTrajectory(duration=8.0, w_amp=(0.9, 0.8, 1.0),
                                 w_freq=(0.5, 0.4, 0.6)),
        landmark_radius=8.0)
    s_true, feats, preints, imask, _ = build_window_problem(world)
    prob = make_problem(s_true, feats, preints, imask)
    s0 = perturb_state(s_true, np.random.default_rng(3))
    mesh = jmesh.make_mesh(8)
    solver = jsba.make_sharded_solver(mesh, FOCAL, iters=ITERS)
    j_sharded = solver(*jsba.shard_problem(mesh, s0, prob))
    j_single = jax.jit(lambda s, p: jba.solve(s, p, FOCAL, iters=ITERS))(
        s0, prob)
    s0_t = tst.window_state_from_numpy(as_np(s0), device=CPU)
    prob_t = tba.problem_from_numpy(as_np(prob), device=CPU)
    return dict(s_true=s_true, s0=s0_t, prob=prob_t,
                unsharded=tba.solve(s0_t, prob_t, FOCAL, iters=ITERS),
                jax={"sharded": as_np(j_sharded), "single": as_np(j_single)})


def check_close(res, state, ref):
    """tests/test_sharded_ba.py's gates on a solve (res, its whole state)
    against a reference result."""
    np.testing.assert_allclose(float(res.cost0), float(ref.cost0),
                               rtol=1e-4)
    np.testing.assert_allclose(float(res.cost1), float(ref.cost1),
                               rtol=0.2, atol=1e-4)
    np.testing.assert_allclose(state.p.numpy(), np.asarray(ref.state.p),
                               atol=2e-3)
    np.testing.assert_allclose(state.inv_depth.numpy(),
                               np.asarray(ref.state.inv_depth), atol=5e-3)
    assert int(res.n_accepted) == int(ref.n_accepted)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_solve_matches_unsharded_and_reference(solves, n):
    mesh = tmesh.make_mesh(devices=[CPU] * n)
    s_sh, prob_sh = tsba.shard_problem(mesh, solves["s0"], solves["prob"])
    assert [x.shape[0] for x in s_sh.inv_depth] == [64 // n] * n
    res = tsba.make_sharded_solver(mesh, FOCAL, iters=ITERS)(s_sh, prob_sh)
    assert len(res.state.inv_depth) == n
    state = tsba.gather_state(res.state)
    check_close(res, state, solves["unsharded"])
    for ref in solves["jax"].values():
        check_close(res, state, ref)
    # and the solve moved toward the truth
    err = np.abs(state.p.numpy() - np.asarray(solves["s_true"].p)).max()
    assert err < 0.03, err


def test_failed_factorization_rejects_the_step(solves):
    """A reduced system that is not positive definite (a negative jitter
    larger than its diagonal) is rejected by the sharded solver as by the
    unsharded one: the state does not move and nothing is accepted."""
    mesh = tmesh.make_mesh(devices=[CPU] * 4)
    s_sh, prob_sh = tsba.shard_problem(mesh, solves["s0"], solves["prob"])
    res = tsba.make_sharded_solver(mesh, FOCAL, iters=1, jitter=-1e12)(
        s_sh, prob_sh)
    ref = tba.solve(solves["s0"], solves["prob"], FOCAL, iters=1,
                    jitter=-1e12)
    assert int(res.n_accepted) == int(ref.n_accepted) == 0
    state = tsba.gather_state(res.state)
    assert torch.equal(state.p, solves["s0"].p)
    assert torch.equal(state.inv_depth, solves["s0"].inv_depth)


def test_landmarks_must_divide_into_the_shards(solves):
    mesh = tmesh.make_mesh(devices=[CPU] * 3)
    with pytest.raises(ValueError, match="pad with masked slots"):
        tsba.shard_problem(mesh, solves["s0"], solves["prob"])
