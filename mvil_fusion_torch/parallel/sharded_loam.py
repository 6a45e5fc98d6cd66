"""Query-sharded LOAM scan-to-map over a mesh.

Counterpart of ``mvil_fusion_tpu/parallel/sharded_loam.py``.  The
correspondence search of ``ops/loam_icp.py`` (10³ queries against 10⁴ map
points, the k-NN kernel on the card) shards on the QUERY axis: each shard
holds a block of the source corner and surf features, the maps are whole
on every shard's device, each shard associates and linearizes its own
queries (``knn_topk`` on its block), and the 6-dof normal equations are
summed over the mesh once per Gauss-Newton iteration, with the matched
counts at the end: the global normal equations of the single-device solve
(reference: localMapping.cpp:586-793, one kd-tree and one thread).
Nothing is read back to the host.
"""

from __future__ import annotations

import torch

from mvil_fusion_torch.ops import loam_icp
from mvil_fusion_torch.parallel import mesh as mesh_lib
from mvil_fusion_torch.utils.precision import full_precision


def make_sharded_scan_to_map(mesh: mesh_lib.Mesh, outer_iters: int = 2,
                             gn_iters: int = 4, max_corr_dist: float = 1.0,
                             axis: str | None = None):
    """``loam_icp.scan_to_map`` over `mesh`: returns
    ``s2m(corner, corner_mask, surf, surf_mask, corner_map,
    corner_map_mask, surf_map, surf_map_mask, p0, q0) ->
    (p, q, n_edge, n_plane)``, where the four source tensors are the
    shards' blocks (`shard_features`) and the maps and (p0, q0) whole;
    the result lies on the mesh's first device."""
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")

    @full_precision
    def s2m(corner, corner_mask, surf, surf_mask, corner_map,
            corner_map_mask, surf_map, surf_map_mask, p0, q0):
        maps = [mesh_lib.replicate(x, mesh) for x in (
            corner_map, corner_map_mask, surf_map, surf_map_mask)]
        blocks = [(corner[k], corner_mask[k], surf[k], surf_mask[k],
                   *(m[k] for m in maps), None, None)
                  for k in range(mesh.local_size)]
        p, q, n_edge, n_plane, _ = loam_icp.scan_to_map_blocks(
            blocks, p0.to(mesh.first), q0.to(mesh.first),
            lambda parts: mesh_lib.psum(mesh, parts), outer_iters,
            gn_iters, max_corr_dist)
        return p, q, n_edge, n_plane

    return s2m


def shard_features(mesh: mesh_lib.Mesh, corner: torch.Tensor,
                   corner_mask: torch.Tensor, surf: torch.Tensor,
                   surf_mask: torch.Tensor):
    """The source features in blocks, one per shard on its device: four
    tuples (corner, corner_mask, surf, surf_mask)."""
    return tuple(mesh_lib.shard(x, mesh)
                 for x in (corner, corner_mask, surf, surf_mask))
