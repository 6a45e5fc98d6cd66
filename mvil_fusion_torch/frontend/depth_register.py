"""LiDAR-aided feature depth registration.

Counterpart of ``mvil_fusion_tpu/frontend/depth_register.py``: the
reference's DepthRegister (feature_tracker_/src/feature_tracker.h:67-343 —
5 s deque of deskewed world-frame clouds, 360x360 range-image dedup,
unit-sphere kd-tree 3-NN, depth = mean neighbor range when the spread is
< 2 m and depth > 3 m) and its node hookup (feature_tracker_node.cpp:
252-337, every 2nd sweep ≈ 5 Hz).

The kd-tree is one features × cloud max-inner-product matmul on the unit
sphere (fp32, TF32 off); the range-image dedup is a scatter-min onto a
fixed polar grid with a drop cell.  The cloud window is a fixed-capacity
ring buffer on the device: clouds arrive there from the estimator's
deskew, and a lookup queues its work and reads its result back once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.utils import lie
from mvil_fusion_torch.utils.device import resolve_device, upload
from mvil_fusion_torch.utils.precision import full_precision
from mvil_fusion_torch.utils.timing import TRACER

N_CLOUDS = 8           # ring slots (≈ 5 s at the reference's 5 Hz feed)
CLOUD_PTS = 8192       # per-cloud padded capacity (estimator's down.pts)
GRID = 360             # range-image cells per axis


def _push_cloud(bufs, masks, pts_l, mask, p_l, q_l):
    """Roll the ring and write the new WORLD-frame cloud at slot -1."""
    world = lie.quat_rotate(q_l[None, :], pts_l) + p_l[None, :]
    bufs = torch.cat([bufs[1:], world[None]], dim=0)
    masks = torch.cat([masks[1:], mask[None]], dim=0)
    return bufs, masks


def _top3_lower_first(sim: torch.Tensor):
    """The 3 largest entries of each row and their columns, the lower
    column first among equal values (``jax.lax.top_k``'s order):
    three first-maximum passes, each winner then pushed below any value."""
    vals, idx = [], []
    for k in range(3):
        if k:
            sim = sim.scatter(1, idx[-1][:, None], -math.inf)
        v, i = torch.max(sim, dim=-1)
        vals.append(v)
        idx.append(i)
    return torch.stack(vals, -1), torch.stack(idx, -1)


@full_precision
def _register_depth(feat_norm, feat_valid, bufs, masks, slot_ok,
                    p_wc, q_wc, min_depth: float = 3.0,
                    max_spread: float = 2.0):
    """feat_norm (F,2) normalized camera coords; bufs (S,N,3) world-frame
    ring.  Returns depth (F,) (-1 unknown)."""
    cloud_w = bufs.reshape(-1, 3)
    cloud_mask = (masks & slot_ok[:, None]).reshape(-1)
    R = lie.quat_to_mat(q_wc)
    cloud_cam = (cloud_w - p_wc[None, :]) @ R

    f3 = torch.cat([feat_norm, torch.ones_like(feat_norm[:, :1])], -1)
    f_dir = f3 / torch.linalg.vector_norm(f3, dim=-1, keepdim=True)
    rng_ = torch.linalg.vector_norm(cloud_cam, dim=-1)
    in_front = cloud_mask & (cloud_cam[:, 2] > 0.2) & (rng_ > 0.3)
    c_dir = cloud_cam / rng_[:, None].clamp_min(1e-6)

    # range-image dedup (360x360 polar grid, keep nearest per cell —
    # feature_tracker.h:143-180); points behind go to a drop cell
    az = torch.atan2(c_dir[:, 0], c_dir[:, 2])
    el = torch.arcsin(c_dir[:, 1].clamp(-1.0, 1.0))
    gi = ((az / math.pi + 1.0) * 180).to(torch.int64).clamp(0, GRID - 1)
    gj = ((el / math.pi + 0.5) * 360).to(torch.int64).clamp(0, GRID - 1)
    cell = torch.where(in_front, gi * GRID + gj, GRID * GRID)
    best = torch.full((GRID * GRID + 1,), math.inf, dtype=rng_.dtype,
                      device=rng_.device)
    best.scatter_reduce_(0, cell, rng_, "amin", include_self=True)
    keep = in_front & (rng_ <= best[cell] + 1e-3)

    # 3-NN by max inner product on the sphere (fp32: a bf16 or TF32
    # cosine error ~4e-3 is the same order as the 1.5 deg gate)
    sim = f_dir @ c_dir.T                                   # (F,S*N)
    sim = torch.where(keep[None, :], sim, -2.0)
    top_sim, top_idx = _top3_lower_first(sim)
    r3 = rng_[top_idx]                                      # (F,3)
    ang_ok = torch.all(top_sim > math.cos(math.radians(1.5)), dim=-1)
    spread = r3.max(dim=-1).values - r3.min(dim=-1).values
    depth = r3.mean(dim=-1)
    ok = (feat_valid & ang_ok & (spread < max_spread)
          & (depth > min_depth))
    return torch.where(ok, depth, -1.0)


class DepthRegister:
    """Thread-safety: in a threaded pipeline the estimator stage WRITES
    (add_cloud) while the frontend stage READS (get_depth) concurrently.
    The ring (bufs, masks, slot_t) is therefore published as ONE tuple
    (`_snap`) — a single atomic attribute store — so a reader can never
    pair a new cloud ring with stale slot timestamps.  There is exactly
    one writer; no lock needed.

    On the card the two stages run on their own streams, so the tuple also
    carries the event recorded after the ring's write (None where the ring
    was written before any stage ran, or off the card).  A reader's stream
    waits for it before reading, and the ring's memory is kept until the
    reader's queued work is done (`record_stream`), whenever the writer
    drops it."""

    def __init__(self, cfg: SystemConfig, window_sec: float = 5.0,
                 device: torch.device | str | None = None):
        """`device` None is the current CUDA device (a RuntimeError where
        there is no card); a CPU caller passes ``device="cpu"``."""
        self.cfg = cfg
        self.window_sec = window_sec
        self.device = dev = resolve_device(device)
        self._snap = (torch.zeros((N_CLOUDS, CLOUD_PTS, 3), device=dev),
                      torch.zeros((N_CLOUDS, CLOUD_PTS), dtype=torch.bool,
                                  device=dev),
                      np.full(N_CLOUDS, -np.inf), None)
        # counters of `get_depth`'s host path: the valid features looked
        # up and those given a depth (read from its readback)
        self.lookups = 0
        self.features_with_depth = 0

    def _up(self, x, dtype=torch.float32) -> torch.Tensor:
        return upload(x, self.device, dtype)

    @property
    def clouds(self):
        """Truthy when any cloud is live (API kept from the list version)."""
        return [t for t in self._snap[2] if np.isfinite(t)]

    def add_cloud(self, t: float, pts_l, mask=None, p_l=None, q_l=None):
        """Deskewed cloud + lidar pose (device tensors): rolled into the
        world-frame ring on the device, with no readback.  Host callers
        may pass a bare world-frame (M,3) numpy cloud (mask/pose omitted).
        Traced as `depth.add_cloud`."""
        with TRACER.span("depth.add_cloud", rid=t):
            self._add_cloud(t, pts_l, mask, p_l, q_l)

    def _add_cloud(self, t, pts_l, mask, p_l, q_l):
        if mask is None or p_l is None:
            # host world-frame cloud: chunk across ring slots if oversized
            arr = np.asarray(pts_l, np.float32)
            if len(arr) > CLOUD_PTS:
                for k in range(0, min(len(arr), CLOUD_PTS * N_CLOUDS),
                               CLOUD_PTS):
                    self._add_cloud(t, arr[k:k + CLOUD_PTS], None, None,
                                    None)
                return
            pts_np = np.zeros((CLOUD_PTS, 3), np.float32)
            n = len(arr)
            pts_np[:n] = arr
            m = np.zeros(CLOUD_PTS, bool)
            m[:n] = True
            pts_l, mask = self._up(pts_np), self._up(m, torch.bool)
            p_l = np.zeros(3, np.float32)
            q_l = np.asarray([1, 0, 0, 0], np.float32)
        bufs, masks, slot_t, _ = self._snap
        bufs, masks = _push_cloud(bufs, masks, pts_l, mask, self._up(p_l),
                                  self._up(q_l))
        slot_t = np.roll(slot_t, -1).copy()
        slot_t[-1] = t
        slot_t[slot_t < t - self.window_sec] = -np.inf
        written = None
        if bufs.is_cuda:
            written = torch.cuda.Event()
            written.record(torch.cuda.current_stream(self.device))
        self._snap = (bufs, masks, slot_t, written)    # atomic publish

    def get_depth(self, t_img: float, feat_norm: np.ndarray,
                  feat_valid: np.ndarray, p_wc: np.ndarray,
                  q_wc: np.ndarray) -> np.ndarray:
        """Depths for the current features given the camera pose T_w_c:
        the lookup's work queued, then one readback.  Traced as
        `depth.lookup`; counted in `lookups` and `features_with_depth`."""
        with TRACER.span("depth.lookup", rid=t_img):
            depth = self._lookup(t_img, feat_norm, feat_valid, p_wc, q_wc)
            depth = np.full(len(feat_norm), -1.0, np.float32) \
                if depth is None else depth.cpu().numpy()
        self.lookups += int(np.count_nonzero(feat_valid))
        self.features_with_depth += int(np.count_nonzero(depth > 0))
        return depth

    def get_depth_device(self, t_img: float, feat_norm, feat_valid,
                         p_wc, q_wc):
        """Enqueue-only depth lookup: a device (F,) depth tensor, or None
        when no cloud is live.  Traced as `depth.lookup`; not counted
        (counting would wait for the card)."""
        with TRACER.span("depth.lookup", rid=t_img):
            return self._lookup(t_img, feat_norm, feat_valid, p_wc, q_wc)

    def _lookup(self, t_img, feat_norm, feat_valid, p_wc, q_wc):
        bufs, masks, slot_t, written = self._snap   # one consistent snapshot
        slot_ok = np.isfinite(slot_t) & (slot_t > t_img - self.window_sec)
        if not slot_ok.any():
            return None
        if written is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(written)
            bufs.record_stream(cur)
            masks.record_stream(cur)
        return _register_depth(
            self._up(feat_norm), self._up(feat_valid, torch.bool), bufs,
            masks, self._up(slot_ok, torch.bool), self._up(p_wc),
            self._up(q_wc))
