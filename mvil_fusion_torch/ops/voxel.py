"""Voxel hashing primitives: downsampling and Gaussian voxel statistics.

Counterpart of ``mvil_fusion_tpu/ops/voxel.py``: closed-form sym3 eigen,
the spatial hash, ``voxel_downsample``, and the Gaussian voxel map with
its single-voxel and 7-neighbour lookups.  Trees and k-NN are replaced by
a single-probe spatial hash with stored voxel coordinates for collision
rejection.  The hash reproduces the reference's bucket ids bit for bit
(int32 products that wrap, ``abs`` of INT_MIN staying INT_MIN, a
floor-mod), so that both packages lay their maps out in the same slot
order.  Nothing here waits for the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# large primes for the 3-D spatial hash (classic Teschner et al.)
_P1, _P2, _P3 = 73856093, 19349663, 83492791
_INT32_MIN = -(1 << 31)


def sym3_eigvals(A: torch.Tensor):
    """Cardano closed-form eigenvalues of batched symmetric 3x3 matrices:
    (λ₀ ≤ λ₁ ≤ λ₂)."""
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(p2.clamp_min(1e-30))
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))
    r = (detB / (2.0 * p ** 3)).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam2 = q + 2.0 * p * torch.cos(phi)                          # largest
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)    # smallest
    lam1 = 3.0 * q - lam0 - lam2
    return lam0, lam1, lam2


def sym3_eigvec(A: torch.Tensor, lamA: torch.Tensor, lamB: torch.Tensor,
                fallback) -> torch.Tensor:
    """Unit eigenvector for the remaining eigenvalue of symmetric 3x3 A via
    Cayley-Hamilton: any column of (A−λ_A I)(A−λ_B I) lies along it.
    `fallback` (3,) is returned where that product vanishes; give it as a
    tensor on A's device, since a host sequence is copied to the device on
    every call, which on a card waits for the stream."""
    I = torch.eye(3, dtype=A.dtype, device=A.device)
    M = (A - lamA[..., None, None] * I) @ (A - lamB[..., None, None] * I)
    norms = torch.linalg.vector_norm(M, dim=-2)               # column norms
    best = torch.argmax(norms, dim=-1)
    col = torch.take_along_dim(M, best[..., None, None], dim=-1)[..., 0]
    cn = torch.linalg.vector_norm(col, dim=-1, keepdim=True)
    fb = torch.as_tensor(fallback, dtype=A.dtype, device=A.device)
    return torch.where(cn > 1e-12, col / cn.clamp_min(1e-30), fb)


def voxel_coords(pts: torch.Tensor, leaf: float) -> torch.Tensor:
    return torch.floor(pts / leaf).to(torch.int32)


def hash_coords(c: torch.Tensor, table_size: int) -> torch.Tensor:
    """Bucket id of int32 voxel coords, exactly as the reference computes
    it in int32: the products wrap, |INT_MIN| stays INT_MIN and the modulo
    is a floor-mod.  Computed in int64 and wrapped explicitly, since C++
    leaves signed int32 overflow undefined.  Returns int64 ids."""
    c = c.to(torch.int64)
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    h = torch.remainder(h + (1 << 31), 1 << 32) - (1 << 31)   # wrap to int32
    a = torch.where(h == _INT32_MIN, h, h.abs())
    return torch.remainder(a, table_size)


class VoxelDownsample(NamedTuple):
    pts: torch.Tensor    # (M,D) centroids (padded)
    mask: torch.Tensor   # (M,)


def voxel_downsample(pts: torch.Tensor, mask: torch.Tensor, leaf: float,
                     max_out: int, table_size: int = 1 << 18
                     ) -> VoxelDownsample:
    """Centroid voxel downsample with static output capacity.

    pts may be (N,3) xyz or (N,3+C) xyz + extra channels (e.g. intensity);
    voxelization keys on xyz, all channels are voxel-averaged.  Output slot
    order is the rank of each occupied bucket among the occupied buckets.
    On a CUDA card `index_add_` sums with float atomics, so centroids vary
    in their last bits from run to run.
    """
    D = pts.shape[-1]
    h = hash_coords(voxel_coords(pts[..., :3], leaf), table_size)
    w = mask.to(pts.dtype)
    sums = pts.new_zeros((table_size, D)).index_add_(0, h, pts * w[:, None])
    cnts = pts.new_zeros((table_size,)).index_add_(0, h, w)
    occ = cnts > 0
    centroids = sums / cnts.clamp_min(1.0)[:, None]
    # compact the occupied buckets into the first max_out slots; empties
    # and overflow go to a spare row that is cut off afterwards
    rank = torch.cumsum(occ, 0) - 1
    slot = torch.where(occ & (rank < max_out), rank, max_out)
    out = pts.new_zeros((max_out + 1, D))
    out[slot] = centroids
    out_mask = torch.zeros((max_out + 1,), dtype=torch.bool,
                           device=pts.device)
    out_mask[slot] = occ
    return VoxelDownsample(pts=out[:max_out], mask=out_mask[:max_out])


def _smallest_eigvec_sym3(A: torch.Tensor) -> torch.Tensor:
    _, lam1, lam2 = sym3_eigvals(A)
    fallback = torch.eye(3, dtype=A.dtype, device=A.device)[2]
    return sym3_eigvec(A, lam1, lam2, fallback)


class GaussianVoxelMap(NamedTuple):
    """Per-voxel Gaussian statistics in a single-probe hash table."""

    mean: torch.Tensor     # (H,3)
    cov: torch.Tensor      # (H,3,3)
    count: torch.Tensor    # (H,)
    coords: torch.Tensor   # (H,3) int32 owner voxel coords (for collision
                           # rejection; the highest point index wins a
                           # contested bucket)
    leaf: float
    table_size: int


def build_gaussian_voxel_map(pts: torch.Tensor, mask: torch.Tensor,
                             leaf: float, table_size: int = 1 << 18,
                             min_points: int = 2,
                             plane_eps: float = 1e-3) -> GaussianVoxelMap:
    """Voxel means + covariances via scatter-add (one pass, no k-NN).

    Covariances get fast_gicp's PLANE regularization: eigenvalues replaced
    by (1, 1, eps) (reference: fast_gicp RegularizationMethod::PLANE), so
    the Mahalanobis weight carries direction only and magnitudes are
    normalized.

    Where two voxels hash to one bucket, the voxel of the highest-indexed
    unmasked point owns it (the reference writes its points in order, so
    its last writer is the same one) and the other voxel's points are
    dropped.  The winner is chosen by a scatter-max of point indices, so
    `coords` and `count` are the same from run to run on a card too;
    `mean` and `cov` are summed there with float atomics and vary in
    their last bits, which `cov = E[xxᵀ] − mean·meanᵀ` in fp32 at world
    coordinates amplifies.
    """
    dtype, dev = pts.dtype, pts.device
    n_pts = pts.shape[0]
    c = voxel_coords(pts, leaf)
    h = hash_coords(c, table_size)
    # purity pass: claim buckets, then accumulate only points whose voxel
    # owns their bucket — hash collisions drop the losing voxel instead of
    # corrupting the winner's statistics.  Masked points claim a spare row.
    h_masked = torch.where(mask, h, table_size)
    winner = torch.full((table_size + 1,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, h_masked, torch.arange(n_pts, device=dev),
                           "amax", include_self=True)
    winner = winner[:table_size]
    coords = torch.where((winner >= 0)[:, None], c[winner.clamp_min(0)],
                         _INT32_MIN).to(torch.int32)
    mine = torch.all(coords[h] == c, dim=-1) & mask
    w = mine.to(dtype)
    s1 = pts.new_zeros((table_size, 3)).index_add_(0, h, pts * w[:, None])
    s2 = pts.new_zeros((table_size, 3, 3)).index_add_(
        0, h, (pts[:, :, None] * pts[:, None, :]) * w[:, None, None])
    n = pts.new_zeros((table_size,)).index_add_(0, h, w)
    n_safe = n.clamp_min(1.0)
    mean = s1 / n_safe[:, None]
    cov = s2 / n_safe[:, None, None] - mean[:, :, None] * mean[:, None, :]
    # PLANE regularization: eigenvalues → (1, 1, eps), written as
    # I − (1−eps)·v₀v₀ᵀ with v₀ the smallest eigenvector in closed form
    # (Cardano eigenvalues + Cayley-Hamilton projector)
    eye = torch.eye(3, dtype=dtype, device=dev)
    v0 = _smallest_eigvec_sym3(cov + 1e-9 * eye)
    cov = eye[None] - (1.0 - plane_eps) * v0[:, :, None] * v0[:, None, :]
    count = torch.where(n >= min_points, n, 0.0)
    return GaussianVoxelMap(mean=mean, cov=cov, count=count, coords=coords,
                            leaf=leaf, table_size=table_size)


def lookup(vm: GaussianVoxelMap, pts: torch.Tensor):
    """Query the voxel containing each point.

    Returns (mean (N,3), cov (N,3,3), hit (N,)).  A hit requires the stored
    owner coords to match (hash-collision rejection)."""
    c = voxel_coords(pts, vm.leaf)
    h = hash_coords(c, vm.table_size)
    hit = (vm.count[h] > 0) & torch.all(vm.coords[h] == c, dim=-1)
    return vm.mean[h], vm.cov[h], hit


def _neighbor7(device) -> torch.Tensor:
    """(7,3) int32 offsets: the voxel itself, then ±x, ±y, ±z.  Built on
    the device by arithmetic: a host table would be copied there at every
    call, which waits for the stream."""
    k = torch.arange(7, device=device)[:, None]
    axis = torch.arange(3, device=device)[None, :]
    on = (k > 0) & (axis == torch.div(k - 1, 2, rounding_mode="floor"))
    return (on * (2 * (k % 2) - 1)).to(torch.int32)


def lookup7(vm: GaussianVoxelMap, pts: torch.Tensor):
    """Query the containing voxel and its 6 face neighbors, returning the
    nearest-mean valid hit (fast_gicp's DIRECT7 neighborhood mode).  Widens
    the convergence basin vs center-only.  Among equally near hits the
    first in the order (self, +x, −x, +y, −y, +z, −z) wins."""
    c = voxel_coords(pts, vm.leaf)                          # (N,3)
    cn = c[:, None, :] + _neighbor7(pts.device)[None, :, :]  # (N,7,3)
    h = hash_coords(cn, vm.table_size)                      # (N,7)
    mean = vm.mean[h]                                       # (N,7,3)
    hit = (vm.count[h] > 0) & torch.all(vm.coords[h] == cn, dim=-1)
    d2 = torch.sum((mean - pts[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(hit, d2, torch.inf)
    d2_best, best = torch.min(d2, dim=-1)                   # (N,)
    h_best = torch.gather(h, 1, best[:, None])[:, 0]
    return vm.mean[h_best], vm.cov[h_best], torch.isfinite(d2_best)
