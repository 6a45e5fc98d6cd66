"""LOAM curvature feature extraction on a fixed ring grid.

Counterpart of ``mvil_fusion_tpu/ops/loam_features.py``: the sweep is
organized as a dense (R, A) ring × azimuth grid (invalid cells masked);
curvature is an 11-tap stencil along the azimuth axis; sharp/flat selection
is a per-(ring, subregion) top-k.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LoamFeatures(NamedTuple):
    sharp: torch.Tensor         # (NS,3) corner points (strongest)
    sharp_mask: torch.Tensor
    less_sharp: torch.Tensor    # (NLS,3)
    less_sharp_mask: torch.Tensor
    flat: torch.Tensor          # (NF,3)
    flat_mask: torch.Tensor
    less_flat: torch.Tensor     # (NLF,3) downsampled remainder
    less_flat_mask: torch.Tensor
    less_flat_i: torch.Tensor   # (NLF,) intensity of less-flat points


def organize_grid(pts: torch.Tensor, ring: torch.Tensor,
                  rel_time: torch.Tensor, mask: torch.Tensor, n_rings: int,
                  n_azimuth: int, scan_period: float,
                  intensity: torch.Tensor | None = None):
    """Compact an unordered sweep into a (R, A, 3) per-ring sequence grid:
    each ring's points are sorted by azimuth and left-packed, so column
    neighbors are consecutive emitted points.

    n_azimuth is the per-ring point capacity (overflow points drop).
    Returns (grid (R,A,3), occ (R,A), igrid (R,A)); igrid is zeros when no
    per-point intensity is supplied.  Dropped points are written to a spare
    cell past the grid and cut off, which keeps the scatter free of a host
    sync."""
    N = pts.shape[0]
    dev = pts.device
    n_cells = n_rings * n_azimuth
    a_idx = (rel_time / scan_period * n_azimuth).to(torch.int32).clamp(
        0, n_azimuth - 1)
    r_idx = ring.to(torch.int32).clamp(0, n_rings - 1)
    # sort all points by (ring, azimuth); invalid points sink to the end
    key = torch.where(mask, r_idx * n_azimuth + a_idx, n_cells)
    order = torch.sort(key, stable=True).indices
    seg = torch.where(mask[order], r_idx[order], n_rings).long()
    # within-ring rank: position minus the ring's first sorted position
    pos = torch.arange(N, dtype=torch.int64, device=dev)
    ring_start = torch.full((n_rings + 1,), N, dtype=torch.int64,
                            device=dev).scatter_reduce(
        0, seg, pos, reduce="amin", include_self=True)
    rank = pos - ring_start[seg]
    dest = torch.where((seg < n_rings) & (rank < n_azimuth),
                       seg * n_azimuth + rank, n_cells)
    grid = pts.new_zeros((n_cells + 1, 3))
    grid[dest] = pts[order]
    # index_fill_ takes the scalar as a kernel argument; `occ[dest] = True`
    # would copy it from the host and wait for the stream
    occ = torch.zeros((n_cells + 1,), dtype=torch.bool,
                      device=dev).index_fill_(0, dest, True)
    if intensity is None:
        igrid = pts.new_zeros((n_rings, n_azimuth))
    else:
        ig = pts.new_zeros((n_cells + 1,))
        ig[dest] = intensity[order].to(pts.dtype)
        igrid = ig[:n_cells].reshape(n_rings, n_azimuth)
    return (grid[:n_cells].reshape(n_rings, n_azimuth, 3),
            occ[:n_cells].reshape(n_rings, n_azimuth), igrid)


def extract(grid: torch.Tensor, occ: torch.Tensor,
            igrid: torch.Tensor | None = None,
            n_subregions: int = 8,
            sharp_per_region: int = 2,
            less_sharp_per_region: int = 10,
            flat_per_region: int = 4,
            curvature_threshold: float = 0.1,
            min_range: float = 0.3,
            use_intensity_mask: bool = False) -> LoamFeatures:
    """Curvature features from the organized grid.

    grid (R,A,3), occ (R,A), igrid (R,A) per-point intensity.  Capacities
    are static: sharp R·S·sharp, etc.  Among tied masked cells the top-k
    picks may differ from the reference's; those picks carry mask False.
    """
    R, A, _ = grid.shape
    rng_ = torch.linalg.vector_norm(grid, dim=-1)            # (R,A)
    valid = occ & (rng_ > min_range)
    if igrid is None:
        igrid = grid.new_zeros((R, A))

    # 11-tap curvature: sum of 5 neighbors each side minus 10x center
    def shift(x, k):
        return torch.roll(x, k, dims=1)

    acc = -10.0 * grid
    nb_ok = valid
    diff_i = torch.zeros((R, A), dtype=torch.int32, device=grid.device)
    ic = torch.abs(igrid).clamp_min(1e-6)
    for k in list(range(-5, 0)) + list(range(1, 6)):
        acc = acc + shift(grid, k)
        nb_ok = nb_ok & shift(valid, k)
        # diff_i: count of ±5 neighbors whose intensity ratio to the
        # center truncates to 1, i.e. is in [1,2) — "similar reflectivity"
        ratio = shift(igrid, k) / ic
        diff_i = diff_i + (torch.floor(ratio) == 1).to(torch.int32)
    curv = torch.sum(acc * acc, dim=-1) / (rng_ * rng_).clamp_min(1e-6)
    usable = nb_ok & valid

    # occlusion / parallel-beam mask: neighbors with a large range jump are
    # unreliable
    r_next = shift(rng_, -1)
    r_prev = shift(rng_, 1)
    occl = (torch.abs(r_next - rng_) > 0.3 * rng_) | \
        (torch.abs(r_prev - rng_) > 0.3 * rng_)
    usable = usable & ~occl

    if use_intensity_mask:
        # high-curvature points whose neighborhood reflectivity is uniform
        # (diff_i > 4) and flat points whose reflectivity varies
        # (diff_i < 5) are both excluded
        i_bad = ((curv > curvature_threshold / 2) & (diff_i > 4)) | \
            ((curv < curvature_threshold / 10) & (diff_i < 5))
        usable = usable & ~i_bad

    curv_m = torch.where(usable, curv, -1.0)

    # per-(ring, subregion) top-k — sharp
    S = n_subregions
    As = A // S
    curv_s = curv_m[:, : S * As].reshape(R, S, As)
    grid_s = grid[:, : S * As].reshape(R, S, As, 3)

    def topk_feats(vals, k):
        top_v, top_i = torch.topk(vals, k, dim=-1)           # (R,S,k)
        pts = torch.take_along_dim(grid_s, top_i[..., None], dim=2)
        return top_v, pts

    sh_v, sh_p = topk_feats(curv_s, sharp_per_region)
    sh_ok = sh_v > curvature_threshold
    ls_v, ls_p = topk_feats(curv_s, less_sharp_per_region)
    ls_ok = ls_v > curvature_threshold

    # flat: smallest curvature among usable (mask unusable to +inf)
    curv_f = torch.where(usable, curv, float("inf"))[:, : S * As].reshape(
        R, S, As)
    fl_v, fl_p = topk_feats(-curv_f, flat_per_region)
    fl_ok = (-fl_v) < curvature_threshold

    # less-flat: every usable point that is not less-sharp (downsampling is
    # done by the caller's voxel filter); subsample the grid 4x along
    # azimuth for capacity
    lf_p = grid[:, ::4, :].reshape(-1, 3)
    lf_ok = (usable & (curv < curvature_threshold))[:, ::4].reshape(-1)
    lf_i = igrid[:, ::4].reshape(-1)

    return LoamFeatures(
        sharp=sh_p.reshape(-1, 3), sharp_mask=sh_ok.reshape(-1),
        less_sharp=ls_p.reshape(-1, 3), less_sharp_mask=ls_ok.reshape(-1),
        flat=fl_p.reshape(-1, 3), flat_mask=fl_ok.reshape(-1),
        less_flat=lf_p, less_flat_mask=lf_ok, less_flat_i=lf_i)
