"""LiDAR compensator front end: ring split + per-point relative time.

Counterpart of ``mvil_fusion_tpu/frontend/lidar_compensator.py``: 16/32/64
ring sensor presets, the HDL-64 two-section elevation table,
sweep-start azimuth inference, and azimuth → relative-time annotation with
intensity rewritten as ring + rel_time.  The annotation runs on the
compensator's device; its output feeds the deskew and the LOAM grid.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.ops import deskew as dsk
from mvil_fusion_torch.utils.device import resolve_device
from mvil_fusion_torch.utils.timing import TRACER

# elevation presets (deg): (fov_down, fov_up, n_rings)
SENSOR_PRESETS = {
    "leishen_c16": (-15.0, 15.0, 16),
    "vlp16": (-15.0, 15.0, 16),
    "hdl32": (-30.67, 10.67, 32),
    "hdl64": (-24.9, 2.0, 64),
}


def _hdl64_table() -> np.ndarray:
    """HDL-64 per-ring elevation table (ascending, degrees): two sections —
    lower block 32 lasers ≈1/2° apart (−24.9…−9.0°), upper block 32 lasers
    1/3° apart (−8.33…+2.0°)."""
    lower = np.linspace(-24.9, -9.0, 32)
    upper = np.linspace(-8.33, 2.0, 32)
    return np.concatenate([lower, upper]).astype(np.float32)


# non-uniform ladders: preset name -> (R,) ascending elevation table
SENSOR_ELEV_TABLES = {
    "hdl64": _hdl64_table(),
}


class CompensatedSweep(NamedTuple):
    """Fields are tensors on the compensator's device."""
    pts: torch.Tensor       # (N,3)
    ring: torch.Tensor      # (N,) int32
    rel_time: torch.Tensor  # (N,)
    mask: torch.Tensor      # (N,) bool
    intensity: torch.Tensor # (N,) ring + rel_time (reference encoding)
    t_start: float


def annotate(pts, mask, start_azi, elev_table, n_rings: int,
             scan_period: float, fov_down: float, fov_up: float,
             min_dist: float, max_dist: float):
    """Ring, relative time, validity and intensity of every point."""
    ring, rel_time, ring_ok = dsk.ring_and_time(
        pts, n_rings, scan_period, fov_up_deg=fov_up, fov_down_deg=fov_down,
        start_azimuth=start_azi, elev_table_deg=elev_table)
    rng = torch.linalg.vector_norm(pts, dim=-1)
    ok = mask & ring_ok & (rng > min_dist) & (rng < max_dist)
    intensity = ring.to(pts.dtype) + rel_time
    return ring, rel_time, ok, intensity


class LidarCompensator:
    def __init__(self, cfg: SystemConfig, sensor: str = "leishen_c16",
                 device: torch.device | str | None = None):
        """`device` None is the current CUDA device (a RuntimeError where
        there is no card); a CPU caller passes ``device="cpu"``."""
        self.cfg = cfg
        self.sensor = sensor
        self.device = resolve_device(device)
        # start-orientation history (the sweep start azimuth is inferred
        # from the last 10 sweeps instead of assuming azimuth 0)
        self._start_hist: list[float] = []

    def _infer_start(self, pts: np.ndarray, valid: np.ndarray) -> float:
        """Sweep-start azimuth from the first emitted point, tracked over
        the last 10 sweeps: the most counter-clockwise first-point azimuth
        seen, so per-sweep jitter never wraps a first point to
        ~scan_period."""
        idx = np.nonzero(valid)[0][:1]
        if len(idx) == 0:
            return self._start_hist[-1] if self._start_hist else 0.0
        est = float(np.arctan2(pts[idx[0], 1], pts[idx[0], 0]))
        self._start_hist.append(est)
        if len(self._start_hist) > 10:
            self._start_hist.pop(0)
        s = np.asarray(self._start_hist)
        mean = float(np.arctan2(np.sin(s).mean(), np.cos(s).mean()))
        dev = (s - mean + np.pi) % (2.0 * np.pi) - np.pi
        return mean + float(dev.max())

    def process(self, t_start: float, pts: np.ndarray,
                valid: np.ndarray | None = None) -> CompensatedSweep:
        """Annotate one raw host sweep (N,3) with ring ids and relative
        times, on the compensator's device."""
        lc = self.cfg.lidar
        with TRACER.span("local_map.compensate",
                         rid=t_start + lc.scan_period):
            fov_down, fov_up, n_rings = SENSOR_PRESETS[self.sensor]
            if valid is None:
                valid = np.isfinite(pts).all(axis=-1)
            start_azi = (self._infer_start(pts, valid)
                         if lc.infer_start_ori else 0.0)
            table = SENSOR_ELEV_TABLES.get(self.sensor)
            dev = self.device
            pts_dev = torch.as_tensor(np.asarray(pts, np.float32),
                                      device=dev)
            ring, rel, ok, inten = annotate(
                pts_dev,
                torch.as_tensor(np.asarray(valid, bool), device=dev),
                torch.tensor(start_azi, dtype=torch.float32, device=dev),
                None if table is None
                else torch.as_tensor(table, device=dev),
                n_rings=n_rings, scan_period=lc.scan_period,
                fov_down=fov_down, fov_up=fov_up,
                min_dist=lc.min_distance, max_dist=lc.max_distance)
            return CompensatedSweep(pts=pts_dev, ring=ring, rel_time=rel,
                                    mask=ok, intensity=inten,
                                    t_start=t_start)
