"""Feature-sharded bundle adjustment over a mesh.

Counterpart of ``mvil_fusion_tpu/parallel/sharded_ba.py``.  The reference
runs its whole window BA in one Ceres solve on one CPU (reference:
vils_estimator/src/estimator.cpp:1124-1687).  Here the landmark axis, the
large and independent axis of the reduced camera system, is sharded:

  * each shard holds a block of the feature table and its inverse depths,
    on its own device, and assembles its vision factors: its partial
    H_v = Σ JᵀJ and g_v, its vision cost and its landmark blocks
    (H_pl, H_ll, g_l);
  * per LM iteration each shard reduces its landmarks out of the system
    (S_part = H_pl H_ll⁻¹ H_plᵀ, rhs_part = H_pl H_ll⁻¹ g_l), and the mesh
    sums the partials (`mesh.psum`);
  * the dense factors (IMU, prior, anchor, extra rows) and the (D, D)
    reduced system are computed once, on the mesh's first device (JAX
    replicates them on every device; one controller needs them once);
    the dense rows join the first shard's JᵀJ, so that one shard forms
    the unsharded system's product to the bit, and each shard updates its
    own landmarks with the solved dx.

The LM loop is ``ba.solve_blocks`` with one block per shard and the
mesh's `psum`, so, as in ``ba.solve``, a failed Cholesky factorization
(its `info`) rejects the step, where JAX's sharded step relies on the NaN
factor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvil_fusion_torch.estimator import ba, state as st
from mvil_fusion_torch.parallel import mesh as mesh_lib


class ShardedState(NamedTuple):
    """A window state with its landmarks sharded: the pose side on the
    mesh's first device (its `inv_depth` empty) and each shard's block of
    inverse depths on the shard's device."""

    pose: st.WindowState
    inv_depth: tuple[torch.Tensor, ...]


class ShardedProblem(NamedTuple):
    """A `ba.BAProblem` with its feature table sharded: `dense` holds the
    rest on the mesh's first device (its `feats` None)."""

    dense: ba.BAProblem
    feats: tuple[st.Features, ...]


def shard_problem(mesh: mesh_lib.Mesh, s: st.WindowState,
                  prob: ba.BAProblem) -> tuple[ShardedState, ShardedProblem]:
    """The state and problem laid out over `mesh`: landmarks and the
    feature table in contiguous blocks, one per shard; the rest on the
    first device.  F must divide into the mesh's shards."""
    blocks = [mesh_lib.shard(x, mesh) for x in prob.feats]
    feats = tuple(st.Features(*fields) for fields in zip(*blocks))
    pose = ba.to_device(s._replace(inv_depth=s.inv_depth[:0]), mesh.first)
    dense = ba.to_device(prob._replace(feats=None), mesh.first)
    return (ShardedState(pose, mesh_lib.shard(s.inv_depth, mesh)),
            ShardedProblem(dense, feats))


def gather_state(s: ShardedState) -> st.WindowState:
    """This process's state whole, on the pose side's device (a
    comparison's convenience: the solver keeps the blocks apart)."""
    dev = s.pose.p.device
    return s.pose._replace(inv_depth=torch.cat(
        [x.to(dev) for x in s.inv_depth]))


def make_sharded_solver(mesh: mesh_lib.Mesh, focal: float, iters: int = 8,
                        axis: str | None = None, mu0: float = 1e-4,
                        jitter: float = 1e-6):
    """The LM solver of ``ba.solve`` over `mesh`: returns
    ``solve(state, problem) -> ba.SolveResult`` for a `ShardedState` and
    a `ShardedProblem` (from `shard_problem`), whose `state` is a
    `ShardedState`.  Nothing waits for the card."""
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")

    def solve(s: ShardedState, prob: ShardedProblem) -> ba.SolveResult:
        res = ba.solve_blocks(s.pose, s.inv_depth, prob.dense, prob.feats,
                              focal, lambda parts: mesh_lib.psum(mesh, parts),
                              iters, mu0, jitter,
                              dense_rows=mesh.offset == 0)
        return res._replace(state=ShardedState(*res.state))

    return solve
