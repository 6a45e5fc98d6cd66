"""LiDAR motion deskew (undistortion to sweep end) and ring/time annotation.

Counterpart of ``mvil_fusion_tpu/ops/deskew.py``: each point, stamped with
its relative time inside the sweep, is transformed by the slerp-interpolated
sensor motion so that the whole cloud is expressed at the sweep-end pose.
"""

from __future__ import annotations

import math

import torch

from mvil_fusion_torch.utils import lie
from mvil_fusion_torch.utils.timing import TRACER


def deskew_to_end(pts: torch.Tensor, rel_time: torch.Tensor,
                  p_start: torch.Tensor, q_start: torch.Tensor,
                  p_end: torch.Tensor, q_end: torch.Tensor,
                  scan_period: float) -> torch.Tensor:
    """Undistort points to the sweep-end frame.

    pts: (N,3) in the (moving) sensor frame at each point's capture time;
    rel_time: (N,) seconds from sweep start; (p,q)_start/end: sensor poses in
    a common frame at sweep start/end.
    """
    with TRACER.span("local_map.deskew"):
        s = (rel_time / scan_period).clamp(0.0, 1.0)
        q_t = lie.quat_slerp(q_start[None, :], q_end[None, :], s)
        p_t = (p_start[None, :] * (1.0 - s[:, None])
               + p_end[None, :] * s[:, None])
        # world point at capture time, then into the end frame
        pw = lie.quat_rotate(q_t, pts) + p_t
        return lie.quat_rotate_inv(q_end[None, :], pw - p_end[None, :])


def ring_and_time(pts: torch.Tensor, n_rings: int, scan_period: float,
                  fov_up_deg: float = 15.0, fov_down_deg: float = -15.0,
                  start_azimuth: torch.Tensor | float = 0.0,
                  elev_table_deg: torch.Tensor | None = None):
    """Ring index from elevation + relative time from azimuth.

    Elevation maps onto the ring ladder; azimuth (unwound clockwise from
    `start_azimuth`) maps onto [0, scan_period].  elev_table_deg: optional
    (n_rings,) ascending per-ring elevation table for non-uniform ladders;
    each point snaps to the nearest entry, valid if within 0.6× the local
    inter-ring gap.
    """
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r_xy = torch.sqrt(x * x + y * y)
    elev = torch.rad2deg(torch.atan2(z, r_xy))
    if elev_table_deg is None:
        step = (fov_up_deg - fov_down_deg) / (n_rings - 1)
        ring = torch.round((elev - fov_down_deg) / step).to(torch.int32)
        ring_ok = (ring >= 0) & (ring < n_rings)
        ring = ring.clamp(0, n_rings - 1)
    else:
        tab = torch.as_tensor(elev_table_deg, dtype=pts.dtype,
                              device=pts.device)          # (R,) ascending
        mids = 0.5 * (tab[1:] + tab[:-1])                  # (R-1,) bin edges
        ring = torch.searchsorted(mids, elev.contiguous()).to(torch.int32)
        ring = ring.clamp(0, n_rings - 1)
        lo = ring.clamp_min(1).long()
        hi = (ring + 1).clamp_max(n_rings - 1).long()
        gap_lo = tab[lo] - tab[lo - 1]
        gap_hi = tab[hi] - tab[hi - 1]
        tol = 0.6 * torch.maximum(gap_lo, gap_hi)
        ring_ok = torch.abs(elev - tab[ring.long()]) <= tol
    azi = torch.atan2(y, x)                     # [-pi, pi]
    two_pi = 2.0 * math.pi
    frac = torch.remainder(start_azimuth - azi, two_pi) / two_pi  # cw sweep
    rel_time = frac * scan_period
    return ring, rel_time, ring_ok
