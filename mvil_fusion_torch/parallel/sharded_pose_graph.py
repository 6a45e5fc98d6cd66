"""Edge-sharded pose-graph optimization over a mesh.

Counterpart of ``mvil_fusion_tpu/parallel/sharded_pose_graph.py``.  The
matrix-free ``mapping/pose_graph.py::solve_cg`` sums per-edge (6,)
contributions per node and nothing else, so it shards on the FACTOR axis:

  * each shard owns E/n between factors and Z/n z priors on its device;
  * the (N, 6) state lives once, on the mesh's first device;
  * the rhs, the block diagonal, each matvec's product (before the damped
    diagonal, which is added once after the sum) and both costs of an LM
    step are summed over the mesh;
  * the LM and CG control flow runs once on the summed values, with
    ``solve_cg``'s stop flags, read by the host every `check_every` CG
    iterations as there, so the result does not depend on `check_every`
    and a solve makes as many host syncs as the unsharded one.
"""

from __future__ import annotations

from typing import Optional

from mvil_fusion_torch.mapping.pose_graph import PoseGraph, solve_cg_blocks
from mvil_fusion_torch.parallel import mesh as mesh_lib
from mvil_fusion_torch.utils.precision import full_precision

_FACTOR_FIELDS = ("e_i", "e_j", "e_dp", "e_dq", "e_w", "e_mask", "z_node",
                  "z_val", "z_w", "z_mask")


def shard_graph(g: PoseGraph, mesh: mesh_lib.Mesh) -> list[PoseGraph]:
    """One graph per local shard: its block of the edge and z tables, on
    its device (the node tables whole there).  The capacities E and Z must
    divide into the mesh's shards (pad with masked slots)."""
    tables = {name: mesh_lib.shard(getattr(g, name), mesh)
              for name in _FACTOR_FIELDS}
    nodes = {name: mesh_lib.replicate(getattr(g, name), mesh)
             for name in ("p", "q", "node_mask")}
    return [PoseGraph(**{name: parts[k] for name, parts in
                         (tables | nodes).items()})
            for k in range(mesh.local_size)]


@full_precision
def solve_cg_sharded(g: PoseGraph, mesh: mesh_lib.Mesh,
                     axis: str | None = None, iters: int = 10,
                     cg_iters: int = 64, anchor_weight: float = 1e4,
                     mu0: float = 1e-6, jitter: float = 1e-6,
                     cg_tol: float = 1e-12, xtol: float = 1e-8,
                     check_every: int = 16,
                     stats: Optional[dict] = None) -> PoseGraph:
    """``pose_graph.solve_cg`` with the edge and z tables sharded over
    `mesh` (the whole graph `g` as input); returns `g` with the solved
    poses on the mesh's first device.  `stats` as in `solve_cg`."""
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    g = g._replace(p=g.p.to(mesh.first), q=g.q.to(mesh.first),
                   node_mask=g.node_mask.to(mesh.first))
    return solve_cg_blocks(g, shard_graph(g, mesh),
                           lambda parts: mesh_lib.psum(mesh, parts), iters,
                           cg_iters, anchor_weight, mu0, jitter, cg_tol,
                           xtol, check_every, stats)
