"""Point-sharded VGICP registration over a mesh.

Counterpart of ``mvil_fusion_tpu/parallel/sharded_registration.py``.  The
source points of ``ops/vgicp.py::vgicp_align`` shard over the mesh; both
voxel maps are whole on every shard's device; each shard evaluates its
points' Mahalanobis residuals, and the 6-dof normal equations are summed
over the mesh once per Gauss-Newton step, with the correspondence count
and the fitness sum at the end (no reference counterpart: fast_gicp
spreads its points over OpenMP threads on one CPU).
"""

from __future__ import annotations

import torch

from mvil_fusion_torch.ops import vgicp, voxel
from mvil_fusion_torch.parallel import mesh as mesh_lib
from mvil_fusion_torch.utils.precision import full_precision


def _replicate_map(vm: voxel.GaussianVoxelMap, mesh: mesh_lib.Mesh):
    fields = [mesh_lib.replicate(x, mesh) if isinstance(x, torch.Tensor)
              else (x,) * mesh.local_size for x in vm]
    return [type(vm)(*f) for f in zip(*fields)]


def make_sharded_vgicp(mesh: mesh_lib.Mesh, iters: int = 12,
                       max_corr_dist: float = 0.8, eps: float = 5e-4,
                       axis: str | None = None):
    """``vgicp.vgicp_align`` over `mesh`: returns ``align(src, src_mask,
    tgt_map, src_map, p0, q0) -> vgicp.VgicpResult``, where src and
    src_mask are the shards' blocks (`shard_points`) and the maps and
    (p0, q0) whole; the result lies on the mesh's first device."""
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")

    @full_precision
    def align(src, src_mask, tgt_map, src_map, p0, q0):
        blocks = list(zip(src, src_mask, _replicate_map(tgt_map, mesh),
                          _replicate_map(src_map, mesh)))
        return vgicp.align_blocks(
            blocks, p0.to(mesh.first), q0.to(mesh.first),
            lambda parts: mesh_lib.psum(mesh, parts), iters,
            max_corr_dist, eps)

    return align


def shard_points(mesh: mesh_lib.Mesh, pts: torch.Tensor,
                 mask: torch.Tensor):
    """The source points and their mask in blocks, one per shard on its
    device."""
    return mesh_lib.shard(pts, mesh), mesh_lib.shard(mask, mesh)
