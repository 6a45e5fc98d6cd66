"""Image preprocessing: CLAHE, pyramids, gradients, bilinear sampling.

Counterpart of ``mvil_fusion_tpu/ops/image.py`` (the reference front end's
cv::CLAHE(3.0, 8x8) and the pyramid inside cv::calcOpticalFlowPyrLK).
Images are (H, W) float32 in [0, 256) on any device.  Where the reference
contracts one-hot indicators, this module scatters and gathers: the
histograms are an ``index_add_`` of ones and the LUTs are read per pixel.
Nothing here waits for the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clahe_luts(img: torch.Tensor, clip_limit: float = 3.0,
               tiles: tuple[int, int] = (8, 8), n_bins: int = 256):
    """The per-tile parts of `clahe`: (pix (H,W) int64 bin of each pixel,
    hists (ty*tx, n_bins) counts, luts (ty, tx, n_bins))."""
    H, W = img.shape
    ty, tx = tiles
    th, tw = H // ty, W // tx
    pix = img.clamp(0, n_bins - 1).to(torch.int64)      # truncates

    # per-tile histogram: every pixel of the tiled area adds one to its
    # tile's bin.  Sums of ones are exact in fp32, so the order in which
    # the card's atomics add them does not show.
    dev = img.device
    tile_y = torch.arange(ty * th, device=dev) // th
    tile_x = torch.arange(tx * tw, device=dev) // tw
    tile = tile_y[:, None] * tx + tile_x[None, :]
    slot = (tile * n_bins + pix[: ty * th, : tx * tw]).reshape(-1)
    hists = img.new_zeros(ty * tx * n_bins).index_add_(
        0, slot, img.new_ones(()).expand(slot.shape[0]))
    hists = hists.reshape(ty * tx, n_bins)

    # clip & redistribute (OpenCV style)
    clip = max(clip_limit * th * tw / n_bins, 1.0)
    clipped = hists.clamp_max(clip)
    excess = torch.sum(hists - clipped, dim=1, keepdim=True)
    clipped = clipped + excess / n_bins

    cdf = torch.cumsum(clipped, dim=1)
    cdf_min = cdf[:, :1]
    denom = (th * tw - cdf_min).clamp_min(1.0)
    luts = (cdf - cdf_min) / denom * (n_bins - 1)
    return pix, hists, luts.reshape(ty, tx, n_bins)


def clahe(img: torch.Tensor, clip_limit: float = 3.0,
          tiles: tuple[int, int] = (8, 8), n_bins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization.

    Matches cv::createCLAHE(clip, tiles) semantics (clip limit scaled by
    tile size / bins): per-tile histograms → clipped CDF LUTs → bilinear
    LUT blend per pixel.  The blend is the reference's separable tent
    blend written out: each pixel reads its bin from the LUTs of the two
    nearest tile rows and tile columns, blends along the rows, then along
    the columns.
    """
    H, W = img.shape
    ty, tx = tiles
    th, tw = H // ty, W // tx
    pix, _, luts = clahe_luts(img, clip_limit, tiles, n_bins)

    dev, dtype = img.device, img.dtype
    fy = ((torch.arange(H, device=dev, dtype=dtype) - th / 2) / th).clamp(
        0.0, ty - 1.0)
    fx = ((torch.arange(W, device=dev, dtype=dtype) - tw / 2) / tw).clamp(
        0.0, tx - 1.0)
    y0 = fy.floor()
    x0 = fx.floor()
    wy = (fy - y0)[:, None]
    wx = (fx - x0)[None, :]
    y0 = y0.to(torch.int64)
    x0 = x0.to(torch.int64)
    y1 = (y0 + 1).clamp_max(ty - 1)
    x1 = (x0 + 1).clamp_max(tx - 1)

    flat = luts.reshape(-1)

    def read(yi, xi):
        return flat[(yi[:, None] * tx + xi[None, :]) * n_bins + pix]

    left = (1.0 - wy) * read(y0, x0) + wy * read(y1, x0)
    right = (1.0 - wy) * read(y0, x1) + wy * read(y1, x1)
    return (1.0 - wx) * left + wx * right


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool downsample (pyramid level step)."""
    return F.avg_pool2d(img[None, None], 2)[0, 0]


def build_pyramid(img: torch.Tensor, levels: int):
    """[level0 (full res), level1, ...]: levels+1 images."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(downsample2(pyr[-1]))
    return pyr


def _stencil3(img: torch.Tensor, k) -> torch.Tensor:
    """3x3 correlation with edge replication, summed tap by tap in
    row-major order as the reference does (zero taps left out)."""
    H, W = img.shape
    pad = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    out = None
    for dy in range(3):
        for dx in range(3):
            if k[dy][dx] == 0:
                continue
            tap = pad[dy:dy + H, dx:dx + W]
            out = k[dy][dx] * tap if out is None else torch.add(
                out, tap, alpha=k[dy][dx])
    return out


_SCHARR_X = tuple(tuple(v / 32.0 for v in row)
                  for row in ((-3, 0, 3), (-10, 0, 10), (-3, 0, 3)))
_SOBEL_X = tuple(tuple(v / 8.0 for v in row)
                 for row in ((-1, 0, 1), (-2, 0, 2), (-1, 0, 1)))


def _transpose3(k):
    return tuple(zip(*k))


def scharr_gradients(img: torch.Tensor):
    """(gx, gy) via 3x3 Scharr (same weighting family OpenCV LK uses)."""
    return _stencil3(img, _SCHARR_X), _stencil3(img, _transpose3(_SCHARR_X))


def sobel_gradients(img: torch.Tensor):
    return _stencil3(img, _SOBEL_X), _stencil3(img, _transpose3(_SOBEL_X))


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample img at continuous (x, y) positions; xy (..., 2).
    Out-of-bounds clamps to the border."""
    H, W = img.shape
    x = xy[..., 0].clamp(0.0, W - 1.001)
    y = xy[..., 1].clamp(0.0, H - 1.001)
    x0 = x.floor().to(torch.int64)
    y0 = y.floor().to(torch.int64)
    x1 = x0 + 1
    y1 = y0 + 1
    wx = x - x0
    wy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))
