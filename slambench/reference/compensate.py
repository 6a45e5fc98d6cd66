"""The plain reference of the LiDAR compensator and the deskew.

Plain PyTorch (float64 by default), from the reference system's
compensator node and LOAM's deskew, and from nothing of the program: the
ring of a point from its elevation on the sensor's evenly spaced ladder,
its time in the sweep from its azimuth turned clockwise from the sweep's
start azimuth, and the deskew of every point to the sweep's end by the
slerp / lerp of the sweep's start and end poses
(``scan_judge.deskew``).  The start azimuth is the first valid point's,
tracked over the last ten sweeps: the most counter-clockwise of those
azimuths about their circular mean.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slambench.reference.scan_judge import deskew

HISTORY = 10


def first_azimuth(pts, valid):
    """The azimuth of a sweep's first valid point (None without one)."""
    idx = np.nonzero(valid)[0]
    if len(idx) == 0:
        return None
    p = np.asarray(pts[idx[0]], np.float64)
    return math.atan2(p[1], p[0])


def start_azimuth(history):
    """The start azimuth from the first-point azimuths of the last
    `HISTORY` sweeps, oldest first."""
    s = np.asarray(history[-HISTORY:], np.float64)
    mean = math.atan2(np.sin(s).mean(), np.cos(s).mean())
    dev = (s - mean + np.pi) % (2.0 * np.pi) - np.pi
    return mean + float(dev.max())


def annotate(pts, valid, start, n_rings, period, fov_down, fov_up,
             min_range, max_range):
    """(ring (N,), time in the sweep (N,), kept (N,), share of the turn
    (N,)) of every point (N,3) of a sweep."""
    x, y, z = pts.unbind(-1)
    elev = torch.rad2deg(torch.atan2(z, torch.sqrt(x * x + y * y)))
    step = (fov_up - fov_down) / (n_rings - 1)
    ring = torch.round((elev - fov_down) / step)
    frac = torch.remainder(start - torch.atan2(y, x), 2 * math.pi) \
        / (2 * math.pi)
    r = pts.norm(dim=-1)
    kept = valid & (ring >= 0) & (ring < n_rings) & (r > min_range) \
        & (r < max_range)
    return ring.clamp(0, n_rings - 1), frac * period, kept, frac


def deskewed(pts, valid, start, odom, comp, dtype=torch.float64,
             device="cpu"):
    """A sweep's points deskewed to its end with the odometry's start and
    end poses `odom` (p0, q0, p1, q1), as a compensator configured by
    `comp` (``n_rings``, ``fov_down_deg``, ``fov_up_deg``, ``period``,
    ``min_range_m``, ``max_range_m``) and the deskew compute them:
    (points (N,3), kept (N,), share of the turn (N,)) in `dtype`."""
    def t(v):
        return torch.as_tensor(np.asarray(v), device=device).to(dtype)
    x = t(pts)
    _, rel, kept, frac = annotate(
        x, torch.as_tensor(np.asarray(valid, bool), device=device),
        torch.tensor(start, dtype=dtype, device=device), comp["n_rings"],
        comp["period"], comp["fov_down_deg"], comp["fov_up_deg"],
        comp["min_range_m"], comp["max_range_m"])
    out = deskew(x, rel, comp["period"], *[t(v) for v in odom])
    return out, kept, frac


def deskew_gap(program, reference, wrap=1e-4):
    """The widest distance (m) between the program's deskewed points and
    the reference's over the points the reference keeps, leaving out
    those within `wrap` of a turn from the start azimuth, where a last
    bit decides whether a point opens or closes the sweep.  A point that
    one side keeps and the other does not makes the gap infinite.
    `program` and `reference` are (points, kept, share of the turn)."""
    pp, pk, _ = program
    rp, rk, rf = reference
    clear = (rf > wrap) & (rf < 1 - wrap)
    if bool(((pk.to(rk.device) != rk) & clear).any()):
        return float("inf")
    sel = rk & clear
    if not bool(sel.any()):
        return float("inf")
    d = (pp.to(rp.device, torch.float64)[sel] - rp.double()[sel]).norm(
        dim=-1)
    return float(d.max())
