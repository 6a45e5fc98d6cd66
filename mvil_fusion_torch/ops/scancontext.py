"""ScanContext place-recognition descriptors.

Counterpart of ``mvil_fusion_tpu/ops/scancontext.py`` (the reference's
vendored ScanContext + nanoflann ring-key kd-tree: Scancontext.cpp
makeAndSaveScancontextAndKeys :71-197, detectLoopClosureID :338-381,
params Scancontext.h:82-97 — 20 rings x 60 sectors, candidate search over
ring keys, column-shift alignment).

Descriptor = scatter-max into the polar grid (a float max does not depend
on the order of its writers, so it is the same from run to run on a
card); ring-key search = squared distances to every stored key; column
shift alignment = all sector shifts gathered through one index table.  No
trees, and nothing waits for the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def make_descriptor(pts: torch.Tensor, mask: torch.Tensor,
                    n_ring: int = 20, n_sector: int = 60,
                    max_radius: float = 80.0) -> torch.Tensor:
    """Polar max-height descriptor (R, S) from a body-frame cloud."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.remainder(torch.atan2(y, x), 2 * math.pi)
    ring = (r / max_radius * n_ring).to(torch.int32).clamp(0, n_ring - 1)
    sector = (theta / (2 * math.pi) * n_sector).to(torch.int32).clamp(
        0, n_sector - 1)
    ok = mask & (r < max_radius)
    # points out of range or masked go to a spare cell that is cut off
    idx = torch.where(ok, ring * n_sector + sector, n_ring * n_sector)
    desc = pts.new_full((n_ring * n_sector + 1,), -1e9).scatter_reduce_(
        0, idx.to(torch.int64), z, "amax", include_self=True)
    desc = desc[:n_ring * n_sector]
    desc = torch.where(desc < -1e8, 0.0, desc)
    return desc.reshape(n_ring, n_sector)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant ring key: mean occupancy per ring (R,)."""
    return desc.mean(dim=-1)


def sc_distance(d1: torch.Tensor, d2: torch.Tensor):
    """Rotation-aligned cosine distance between descriptor d1 (R,S) and
    d2 (..., R, S).

    Evaluates all sector shifts of d2 and returns (min distance, best
    shift), each of d2's leading shape — the reference's column-shift
    alignment, batched.  Columns that are empty in either descriptor are
    left out of the mean; the lowest shift wins a tie.
    """
    S = d1.shape[-1]
    col = torch.arange(S, device=d1.device)
    # rolled[..., s, j] = d2[..., (j - s) % S]: d2 rolled right by s
    src_col = torch.remainder(col[None, :] - col[:, None], S)      # (S,S)
    d2s = d2[..., :, src_col]                                      # (...,R,S,S)
    num = torch.sum(d1[:, None, :] * d2s, dim=-3)                  # (...,S,S)
    n1 = torch.linalg.vector_norm(d1, dim=0)                       # (S,)
    n2 = torch.linalg.vector_norm(d2s, dim=-3)                     # (...,S,S)
    ok = (n1 > 1e-9) & (n2 > 1e-9)
    cos = torch.where(ok, num / (n1 * n2).clamp_min(1e-9), 0.0)
    cnt = ok.sum(dim=-1).clamp_min(1)
    dists = 1.0 - cos.sum(dim=-1) / cnt                            # (...,S)
    dist, best = torch.min(dists, dim=-1)
    return dist, best


class LoopCandidates(NamedTuple):
    idx: torch.Tensor      # (K,) candidate indices
    dist: torch.Tensor     # (K,) full SC distance
    shift: torch.Tensor    # (K,) best sector shift


def detect_loop(query_desc: torch.Tensor, query_key: torch.Tensor,
                db_desc: torch.Tensor, db_keys: torch.Tensor,
                db_mask: torch.Tensor, n_candidates: int = 10
                ) -> LoopCandidates:
    """Ring-key candidate search + full SC distance on the top candidates.

    db_desc (N,R,S), db_keys (N,R), db_mask (N,) — static capacity.  The
    candidates come nearest key first, the lower index first among equal
    key distances (a stable sort: `torch.topk` leaves that order open, and
    all masked entries tie at infinity).  A masked candidate's distance is
    infinite.
    """
    d2 = torch.sum((db_keys - query_key[None, :]) ** 2, dim=-1)
    d2 = torch.where(db_mask, d2, torch.inf)
    near, idx = torch.sort(d2, stable=True)
    near, idx = near[:n_candidates], idx[:n_candidates]
    dist, shift = sc_distance(query_desc, db_desc[idx])
    dist = torch.where(torch.isfinite(near), dist, torch.inf)
    return LoopCandidates(idx=idx, dist=dist, shift=shift)
