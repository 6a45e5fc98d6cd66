"""Pyramidal Lucas-Kanade optical flow, batched over features.

Counterpart of ``mvil_fusion_tpu/ops/klt.py`` (cv::calcOpticalFlowPyrLK
with a 21x21 window and 3 pyramid levels in the reference front end): the
same inverse-compositional LK, level by level, with the same memory
picture.  Around each feature an S×S patch is cut out of the image at an
integer corner (S = win + 2·margin + 2); the win×win window is sampled
bilinearly *inside the patch*, so a sample that leaves the patch clamps at
the patch's edge, not the image's, and the iterate can move by `margin`
per extraction.  The target patch is cut again, centred on the iterate,
between the two halves of the iterations.

Where the reference selects patch columns with a one-hot matrix and
samples with tent-matrix products, this module gathers: one indexed read
cuts the patches, and one gather of the four bilinear taps samples a
window.  Nothing here waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class KLTResult(NamedTuple):
    pts: torch.Tensor     # (N,2) tracked positions in the new image
    ok: torch.Tensor      # (N,) bool tracking success
    err: torch.Tensor     # (N,) mean abs residual of the final window


def _extract(img: torch.Tensor, bx: torch.Tensor, by: torch.Tensor,
             S: int) -> torch.Tensor:
    """(N,S,S) integer-aligned patches at (bx, by) corners; rows and
    columns beyond the image repeat its edge."""
    H, W = img.shape
    off = torch.arange(S, device=img.device)
    rows = (by[:, None] + off).clamp(0, H - 1)                    # (N,S)
    cols = (bx[:, None] + off).clamp(0, W - 1)                    # (N,S)
    return img.reshape(-1)[rows[:, :, None] * W + cols[:, None, :]]


def _scharr_patch(p: torch.Tensor):
    """Dense 3x3 Scharr gradients on (N,S,S) patches (edge-replicated)."""
    S = p.shape[-1]
    pp = F.pad(p[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    w = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)
    gx = gy = None
    for k in range(3):
        dx = pp[:, k:k + S, 2:2 + S] - pp[:, k:k + S, 0:S]
        dy = pp[:, 2:2 + S, k:k + S] - pp[:, 0:S, k:k + S]
        gx = w[k] * dx if gx is None else torch.add(gx, dx, alpha=w[k])
        gy = w[k] * dy if gy is None else torch.add(gy, dy, alpha=w[k])
    return gx, gy


def _sample(patches: torch.Tensor, cy: torch.Tensor,
            cx: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (N,C,S,S) patches on the grid of rows cy (N,Q)
    and columns cx (N,Q), in patch coordinates: (N,C,Q,Q).  Coordinates
    are clamped to [0, S-1] (the patch's edge repeats)."""
    N, C, S, _ = patches.shape
    Q = cy.shape[1]
    c = torch.stack([cy, cx], dim=1).clamp(0.0, S - 1.0)          # (N,2,Q)
    c0 = c.floor()
    f = c - c0
    i0 = c0.to(torch.int64)
    i1 = (i0 + 1).clamp_max(S - 1)
    taps = torch.stack([i0, i1], dim=2)                           # (N,2,2,Q)
    wts = torch.stack([1.0 - f, f], dim=2)                        # (N,2,2,Q)
    # index (N, a, b, y, x) = row tap a of grid row y, column tap b of x
    idx = (taps[:, 0, :, None, :, None] * S
           + taps[:, 1, None, :, None, :]).reshape(N, 1, 4 * Q * Q)
    v = torch.gather(patches.reshape(N, C, S * S), 2,
                     idx.expand(N, C, 4 * Q * Q)).reshape(N, C, 2, 2, Q, Q)
    # blend along the rows first, then along the columns
    rows = (v * wts[:, 0, None, :, None, :, None]).sum(dim=2)     # (N,C,2,Q,Q)
    return (rows * wts[:, 1, None, :, None, :]).sum(dim=2)


def _track_level(img0, img1, pts0_lvl, guess, win, iters, min_eig_thr,
                 margin: int = 10):
    """One pyramid level of LK for all features.

    pts0_lvl: (N,2) template positions at this level.
    guess: (N,2) current displacement estimate (this level's scale).
    Returns (new displacement, ok, err).
    """
    H, W = img0.shape
    r = (win - 1) / 2.0
    S = win + 2 * margin + 2
    win_off = torch.arange(win, device=img0.device, dtype=img0.dtype)

    def base_of(p):
        """Integer patch corner (x, y), kept inside the image."""
        b = torch.floor(p - r - margin)
        return (b[:, 0].clamp(0.0, max(W - S, 0)),
                b[:, 1].clamp(0.0, max(H - S, 0)))

    def extract(img, bx, by):
        return _extract(img, bx.to(torch.int64), by.to(torch.int64), S)

    def window(p_center, bx, by):
        """Rows and columns, in the patch cut at (bx, by), of the win x win
        grid centred at p_center (image coordinates)."""
        cy = (p_center[:, 1] - r)[:, None] + win_off - by[:, None]
        cx = (p_center[:, 0] - r)[:, None] + win_off - bx[:, None]
        return cy, cx

    b0x, b0y = base_of(pts0_lvl)
    p0 = extract(img0, b0x, b0y)
    gx, gy = _scharr_patch(p0)

    # template and gradient windows, sampled once
    tpl = _sample(torch.stack([p0, gx, gy], dim=1),
                  *window(pts0_lvl, b0x, b0y))
    t, ixy = tpl[:, :1], tpl[:, 1:]
    ix, iy = ixy[:, 0], ixy[:, 1]

    gxx = torch.sum(ix * ix, (1, 2))
    gxy = torch.sum(ix * iy, (1, 2))
    gyy = torch.sum(iy * iy, (1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = (tr - torch.sqrt((tr * tr - 4 * det).clamp_min(0.0))) / 2.0
    good_g = min_eig / float(win * win) > min_eig_thr
    inv_det = torch.where(det.abs() < 1e-12, 0.0, 1.0 / det)
    # step = inv_det · [[gyy, -gxy], [-gxy, gxx]] · b
    adj = torch.stack([gyy, -gxy, -gxy, gxx], dim=-1).reshape(-1, 2, 2)

    def run_half(d, n_it):
        """Cut the target patch centred on the current iterate, then n_it
        LK iterations against it."""
        b1x, b1y = base_of(pts0_lvl + d)
        p1 = extract(img1, b1x, b1y)[:, None]
        step = None
        for _ in range(n_it):
            di = _sample(p1, *window(pts0_lvl + d, b1x, b1y)) - t
            b = torch.sum(di * ixy, (2, 3))                       # (N,2)
            step = inv_det[:, None] * torch.sum(adj * b[:, None, :], -1)
            d = d - step
        return d, step, p1, b1x, b1y

    half = max(iters // 2, 1)
    d, _, _, _, _ = run_half(guess, half)
    d, step, p1, b1x, b1y = run_half(d, max(iters - half, 1))
    resid = _sample(p1, *window(pts0_lvl + d, b1x, b1y)) - t
    err = torch.mean(resid.abs(), (1, 2, 3))
    ok = good_g & (torch.linalg.vector_norm(step, dim=-1) < 1.0)
    return d, ok, err


def track(pyr0, pyr1, pts0: torch.Tensor, valid: torch.Tensor,
          win: int = 21, iters: int = 10, min_eig_thr: float = 1e-4,
          max_err: float = 30.0) -> KLTResult:
    """Track pts0 from pyramid pyr0 to pyr1 (lists from build_pyramid).

    pts0: (N,2) full-resolution positions; valid: (N,) slot mask.
    """
    levels = len(pyr0) - 1
    n = pts0.shape[0]
    d = pts0.new_zeros((n, 2))
    ok_all = torch.ones((n,), dtype=torch.bool, device=pts0.device)
    err = pts0.new_zeros((n,))
    for lvl in range(levels, -1, -1):
        scale = 2.0 ** lvl
        d, ok, err = _track_level(pyr0[lvl], pyr1[lvl], pts0 / scale, d,
                                  win, iters, min_eig_thr)
        ok_all = ok_all & ok
        if lvl > 0:
            d = d * 2.0
    pts1 = pts0 + d
    H, W = pyr0[0].shape
    inb = ((pts1[:, 0] >= 1.0) & (pts1[:, 0] < W - 1.0)
           & (pts1[:, 1] >= 1.0) & (pts1[:, 1] < H - 1.0))
    ok_final = valid & ok_all & inb & (err < max_err)
    return KLTResult(pts=pts1, ok=ok_final, err=err)
