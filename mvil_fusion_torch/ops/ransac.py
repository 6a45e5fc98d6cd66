"""Batched fundamental-matrix RANSAC for tracker outlier rejection.

Counterpart of ``mvil_fusion_tpu/ops/ransac.py`` (cv::findFundamentalMat
(FM_RANSAC) in the reference's rejectWithF; points are lifted to a virtual
460-focal image first, threshold 1 px).  All hypotheses are evaluated in
one batch: B random 8-point samples → normalized 8-point solve → Sampson
distance → inlier counts → argmax.  Every function takes the hypotheses as
a leading batch dimension.  Nothing here waits for the device.

The hypotheses' sample indices come from a ``torch.Generator`` or from the
caller: no generator of PyTorch reproduces another library's random bits,
so a comparison with the reference passes the reference's indices in.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mvil_fusion_torch.ops.voxel import _smallest_eigvec_sym3
from mvil_fusion_torch.utils import lie


class RansacResult(NamedTuple):
    inliers: torch.Tensor    # (N,) bool
    F: torch.Tensor          # (3,3) best model
    n_inliers: torch.Tensor


def _nullvec9(A: torch.Tensor) -> torch.Tensor:
    """Unit null vectors (B,9) of (B,8,9) systems via Householder QR of Aᵀ.

    8 unrolled reflections triangularize Aᵀ (9×8); the last column of the
    accumulated Q spans the orthogonal complement of A's row space, i.e.
    the (least-squares) null direction.  All slices are static, so the
    routine is batched vector arithmetic: no LAPACK loop.  The sign of
    the result is that of the reflections' product and carries no meaning.
    """
    R = A.transpose(1, 2).clone()                        # (B,9,8)
    us = []
    for k in range(8):
        x = R[:, k:, k]                                  # (B,9-k)
        sgn = torch.where(x[:, :1] >= 0, 1.0, -1.0)
        alpha = -sgn * lie._norm(x, keepdim=True)
        u = torch.cat([x[:, :1] - alpha, x[:, 1:]], dim=1)
        u = u / lie._norm(u, keepdim=True).clamp_min(1e-30)
        R[:, k:, :] -= 2.0 * u[:, :, None] * (u[:, None, :] @ R[:, k:, :])
        us.append(u)
    q = A.new_zeros((A.shape[0], 9))
    q[:, 8].fill_(1.0)
    for k in range(7, -1, -1):
        u = us[k]
        q[:, k:] -= 2.0 * u * torch.sum(u * q[:, k:], dim=1, keepdim=True)
    return q


def _eight_point(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point: x1, x2 (B,8,2) → F (B,3,3)."""
    def normalize(x):
        mean = torch.mean(x, dim=1, keepdim=True)                # (B,1,2)
        d = torch.mean(lie._norm(x - mean), dim=1)               # (B,)
        s = math.sqrt(2.0) / d.clamp_min(1e-9)
        zero, one = torch.zeros_like(s), torch.ones_like(s)
        T = torch.stack([s, zero, -s * mean[:, 0, 0],
                         zero, s, -s * mean[:, 0, 1],
                         zero, zero, one], dim=-1).reshape(-1, 3, 3)
        xh = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
        return (xh @ T.transpose(1, 2))[..., :2], T

    n1, T1 = normalize(x1)
    n2, T2 = normalize(x2)
    u1, v1 = n1[..., 0], n1[..., 1]
    u2, v2 = n2[..., 0], n2[..., 1]
    one = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     one], dim=-1)                               # (B,8,9)
    f = _nullvec9(A).reshape(-1, 3, 3)

    # rank-2 enforcement: with v3 the smallest right singular vector
    # (= smallest eigenvector of fᵀf, closed form for symmetric 3×3),
    # dropping the smallest singular component is f(I − v3v3ᵀ).
    v3 = _smallest_eigvec_sym3(f.transpose(1, 2) @ f)            # (B,3)
    f2 = f - (f @ v3[:, :, None]) * v3[:, None, :]
    return T2.transpose(1, 2) @ f2 @ T1


def _sampson(F: torch.Tensor, x1: torch.Tensor,
             x2: torch.Tensor) -> torch.Tensor:
    """Sampson distance (B,N) of correspondences x (N,2) under F (B,3,3)."""
    x1h = torch.cat([x1, torch.ones_like(x1[:, :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[:, :1])], dim=-1)
    Fx1 = x1h @ F.transpose(1, 2)     # (B,N,3)
    Ftx2 = x2h @ F                    # (B,N,3)
    num = torch.sum(x2h * Fx1, dim=-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2
           + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)
    return num / den.clamp_min(1e-12)


def sample_hypotheses(valid: torch.Tensor, n_hyp: int,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """(n_hyp, 8) indices drawn uniformly, with replacement, from the valid
    slots (degenerate samples simply score poorly).  `generator` must live
    on valid's device.  With no valid slot every index is the last slot."""
    n = valid.shape[0]
    u = torch.rand((n_hyp, 8), device=valid.device, generator=generator)
    seen = torch.cumsum(valid, dim=0)                   # valid slots up to i
    rank = torch.floor(u * seen[-1]).to(seen.dtype)     # which valid slot
    return torch.searchsorted(seen, rank, right=True).clamp_max(n - 1)


def fundamental_ransac(x1: torch.Tensor, x2: torch.Tensor,
                       valid: torch.Tensor, threshold: float = 1.0,
                       n_hyp: int = 256,
                       generator: Optional[torch.Generator] = None,
                       idx: Optional[torch.Tensor] = None) -> RansacResult:
    """x1, x2: (N,2) correspondences in (virtual-focal) pixel coords;
    valid: (N,) slot mask.  threshold in the same pixel units.  The
    hypotheses sample the slots `idx` (n_hyp, 8) where given, else slots
    drawn from `generator` (the default generator of valid's device where
    that is None too)."""
    if idx is None:
        idx = sample_hypotheses(valid, n_hyp, generator)
    Fs = _eight_point(x1[idx], x2[idx])                 # (B,3,3)
    d = _sampson(Fs, x1, x2)                            # (B,N)
    inl = (d < threshold * threshold) & valid[None, :]
    counts = torch.sum(inl, dim=-1)
    # indexed by a one-element tensor: a 0-dim index would be read back to
    # the host as a Python integer
    best = torch.argmax(counts).reshape(1)
    return RansacResult(inliers=inl[best][0], F=Fs[best][0],
                        n_inliers=counts[best][0])
