"""Voxel hashing primitives: downsampling and closed-form sym3 eigen.

Counterpart of ``mvil_fusion_tpu/ops/voxel.py``, the parts the LOAM
mapping stage uses: ``sym3_eigvals``, ``sym3_eigvec``, ``voxel_coords``,
``hash_coords`` and ``voxel_downsample``.  The spatial hash reproduces the
reference's bucket ids bit for bit (int32 products that wrap, ``abs`` of
INT_MIN staying INT_MIN, a floor-mod), so that both packages lay their
maps out in the same slot order.
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
