"""Shi-Tomasi corner detection with min-distance suppression.

Counterpart of ``mvil_fusion_tpu/ops/corners.py`` (cv::goodFeaturesToTrack
plus the reference's track-count-priority mask): existing features claim
their min_dist-sized cell and its 8 neighbours, new corners are the
per-cell argmax of the Shi-Tomasi response, winners beaten by a close
neighbouring winner die, and a global top-k picks the strongest.  Ties go
as in the reference: the row-major first maximum within a cell, the lower
cell index in the top-k.  Nothing here waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from mvil_fusion_torch.ops import image as im


def shi_tomasi_response(img: torch.Tensor, block: int = 3) -> torch.Tensor:
    """Min-eigenvalue corner response (cv::cornerMinEigenVal semantics)."""
    gx, gy = im.sobel_gradients(img)
    prods = torch.stack([gx * gx, gx * gy, gy * gy])[None]      # (1,3,H,W)
    # block x block box mean, edge-replicated
    pad = block // 2
    box = F.avg_pool2d(F.pad(prods, (pad,) * 4, mode="replicate"), block,
                       stride=1)[0]
    sxx, sxy, syy = box[0], box[1], box[2]
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    return (tr - torch.sqrt((tr * tr - 4 * det).clamp_min(0.0))) / 2.0


class Corners(NamedTuple):
    pts: torch.Tensor     # (K,2) x,y
    score: torch.Tensor   # (K,)
    ok: torch.Tensor      # (K,) bool


def detect(img: torch.Tensor, existing: torch.Tensor,
           existing_valid: torch.Tensor, max_new: int, min_dist: int = 30,
           quality: float = 0.01, border: int = 10) -> Corners:
    """Detect up to max_new corners at least min_dist from each other and
    from `existing` (N,2) valid features."""
    H, W = img.shape
    dev = img.device
    resp = shi_tomasi_response(img)

    # border mask
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inb = ((yy >= border) & (yy < H - border)
           & (xx >= border) & (xx < W - border))
    resp = torch.where(inb, resp, -1.0)

    # per-cell maximum and its row-major first position
    gh = -(-H // min_dist)
    gw = -(-W // min_dist)
    rp = F.pad(resp, (0, gw * min_dist - W, 0, gh * min_dist - H),
               value=-1.0)
    blocks = rp.reshape(gh, min_dist, gw, min_dist).permute(
        0, 2, 1, 3).reshape(gh, gw, min_dist * min_dist)
    ws, loc = torch.max(blocks, dim=2)
    ly = loc // min_dist
    lx = loc % min_dist
    wy = torch.arange(gh, device=dev)[:, None] * min_dist + ly   # (gh,gw)
    wx = torch.arange(gw, device=dev)[None, :] * min_dist + lx
    wi = (wy * W + wx).to(resp.dtype)     # < 2^24: exact in fp32
    wy = wy.to(resp.dtype)
    wx = wx.to(resp.dtype)

    # cells claimed by existing features (own cell + 8 neighbours ≈ the
    # reference's min_dist circular mask), in a table with a ring of 2
    # cells that is never read back.  Invalid slots sit far outside; all
    # indices are clamped into the ring.
    ex = torch.where(existing_valid[:, None], existing, -1e6)
    exc_x = torch.floor(ex[:, 0] / min_dist).clamp(-2, gw + 1).to(torch.int64)
    exc_y = torch.floor(ex[:, 1] / min_dist).clamp(-2, gh + 1).to(torch.int64)
    d3 = torch.arange(-1, 2, device=dev)
    cy = (exc_y[:, None, None] + 2 + d3[None, :, None]).clamp(0, gh + 3)
    cx = (exc_x[:, None, None] + 2 + d3[None, None, :]).clamp(0, gw + 3)
    claimed = torch.zeros((gh + 4) * (gw + 4), dtype=torch.bool, device=dev)
    claimed.index_fill_(0, (cy * (gw + 4) + cx).reshape(-1), True)
    claimed = claimed.reshape(gh + 4, gw + 4)
    ws = torch.where(claimed[2:2 + gh, 2:2 + gw], -1.0, ws)
    # absolute quality floor
    ws = torch.where(ws >= quality, ws, -1.0)

    # neighbour suppression between adjacent-cell winners: a winner dies if
    # a strictly stronger (ties → lower index) winner in one of the 8
    # neighbouring cells lies within min_dist.  Cells two apart are always
    # ≥ min_dist away, so this enforces the full circular constraint.  The
    # 3x3 neighbourhood of every cell is unfolded at once; a cell is
    # neither stronger than itself nor of lower index, so the centre tap
    # changes nothing.
    fields = torch.stack([
        F.pad(ws, (1, 1, 1, 1), value=-1e9),
        F.pad(wx, (1, 1, 1, 1), value=1e9),
        F.pad(wy, (1, 1, 1, 1), value=1e9),
        F.pad(wi, (1, 1, 1, 1), value=float(2 ** 30))])
    nb = F.unfold(fields[None], 3).reshape(4, 9, gh, gw)
    ns, nx, ny, ni = nb[0], nb[1], nb[2], nb[3]
    close = (nx - wx) ** 2 + (ny - wy) ** 2 < min_dist ** 2
    stronger = (ns > ws) | ((ns == ws) & (ni < wi))
    alive = (ws > 0) & ~torch.any(close & stronger, dim=0)
    winner_score = torch.where(alive, ws, -1.0).reshape(-1)

    # global top-k cells by score; a stable sort keeps the lower cell first
    # among equal scores
    order = torch.sort(winner_score, descending=True, stable=True)
    top_score, top_cell = order.values[:max_new], order.indices[:max_new]
    py = wy.reshape(-1)[top_cell]
    px = wx.reshape(-1)[top_cell]
    # threshold relative to best response (goodFeaturesToTrack qualityLevel)
    best = top_score[0].clamp_min(1e-9)
    ok = top_score > quality * best
    return Corners(pts=torch.stack([px, py], dim=-1), score=top_score, ok=ok)
