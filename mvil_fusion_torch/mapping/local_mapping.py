"""LOAM local mapping: scan-to-map refinement on a rolling feature map.

Counterpart of ``mvil_fusion_tpu/mapping/local_mapping.py``: two
fixed-capacity world-frame feature buffers cropped to a radius around the
sensor, brute-force k-NN correspondences (``ops/loam_icp.py``), and the
submap handoff to the global back end (accumulate a body-frame submap,
publish every > 2 m or 30 frames, then reset the map).

The mapper's state lives on its ``device``.  A sweep queues its whole
device work — grid, features, scan-to-map, count gate, map inserts and
crop, submap accumulation — and reads back one 17-float pack; a submap
emission reads back the submap once more.  On a card scan-to-map replays
as CUDA graphs (``loam_icp.ScanToMapGraphs``), fed copies of the rolling
maps, so the map's own tensors stay the mapper's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.ops import loam_features as lfe
from mvil_fusion_torch.ops import loam_icp, voxel
from mvil_fusion_torch.utils import lie
from mvil_fusion_torch.utils.device import resolve_device
from mvil_fusion_torch.utils.precision import set_fp32_policy
from mvil_fusion_torch.utils.timing import TRACER

CORNER_CAP = 16384
SURF_CAP = 32768
SUBMAP_CAP = 32768

# state that load_reference_state takes: device arrays, then host fields
DEVICE_STATE = ("corner_map", "corner_mask", "surf_map", "surf_mask",
                "surf_map_i", "accum_buf", "accum_mask", "p_corr", "q_corr")
HOST_STATE = ("accum_start_pose", "frames_since_submap", "initialized",
              "submaps_emitted")


@dataclass
class Submap:
    """Keyed local map handed to the global back end (body frame of the
    submap's key pose)."""

    t: float
    p_w: np.ndarray
    q_w: np.ndarray
    pts: np.ndarray
    odom_p: np.ndarray     # odometry pose at key time (for delta chaining)
    odom_q: np.ndarray


def _insert(buf, msk, new_pts, new_mask, leaf, cap, table_size):
    """Append + re-voxelize a rolling buffer."""
    ds = voxel.voxel_downsample(torch.cat([buf, new_pts], dim=0),
                                torch.cat([msk, new_mask], dim=0),
                                leaf, cap, table_size=table_size)
    return ds.pts, ds.mask


def _gate(p_guess, q_guess, p, q, n_e, n_p, res, p_odom, q_odom):
    """The count gate (a degenerate association, or an empty or reset map,
    keeps the guess), the new map-to-odometry correction and the pack:
    (p, q, p_corr, q_corr, pack).  Scan-to-map's `finish`."""
    cnt_ok = (n_e + n_p) >= 50
    p_new = torch.where(cnt_ok, p, p_guess)
    q_new = torch.where(cnt_ok, q, q_guess)
    p_oi, q_oi = lie.pose_inverse(p_odom, q_odom)
    p_corr, q_corr = lie.pose_compose(p_new, q_new, p_oi, q_oi)
    return p_new, q_new, p_corr, q_corr, _pack(p_new, q_new, n_e, n_p, res,
                                               p_odom, q_odom)


def _pack(p_new, q_new, n_e, n_p, res, p_odom, q_odom):
    """The sweep's single host readback: 0:3 p, 3:7 q, 7:10 (n_edge,
    n_plane, mean residual), 10:13 odometry p, 13:17 odometry q."""
    f32 = torch.float32
    return torch.cat([
        p_new.to(f32), q_new.to(f32),
        torch.stack([n_e.to(f32), n_p.to(f32), res.to(f32)]),
        p_odom.to(f32), q_odom.to(f32),
    ])


class LocalMapper:
    def __init__(self, cfg: SystemConfig,
                 device: torch.device | str | None = None):
        """`device` None is the current CUDA device (a RuntimeError where
        there is no card); a CPU caller passes ``device="cpu"``."""
        set_fp32_policy()
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        f32 = torch.float32
        self.corner_map = torch.zeros((CORNER_CAP, 3), dtype=f32, device=dev)
        self.corner_mask = torch.zeros((CORNER_CAP,), dtype=torch.bool,
                                       device=dev)
        self.surf_map = torch.zeros((SURF_CAP, 3), dtype=f32, device=dev)
        self.surf_mask = torch.zeros((SURF_CAP,), dtype=torch.bool,
                                     device=dev)
        # per-point reflectivity of the surf map (voxel-averaged alongside
        # positions; used for intensity-similar correspondence selection)
        self.surf_map_i = torch.zeros((SURF_CAP,), dtype=f32, device=dev)
        # map-to-odometry correction (reference wmap_wodom)
        self.p_corr = torch.zeros(3, dtype=f32, device=dev)
        self.q_corr = lie.quat_identity(f32, dev)
        self.initialized = False
        # submap accumulation — fixed-capacity device buffer
        self.accum_buf = torch.zeros((SUBMAP_CAP, 3), dtype=f32, device=dev)
        self.accum_mask = torch.zeros((SUBMAP_CAP,), dtype=torch.bool,
                                      device=dev)
        self.accum_start_pose: Optional[tuple] = None
        self.frames_since_submap = 0
        self.trajectory: list = []     # Midend.txt equivalent
        self.submaps_emitted = 0
        # deferred-readback mode: the per-sweep pack is harvested at the
        # next sweep instead of blocking after dispatch; ordering
        # (trajectory rows, submap trigger, map reset) is identical to sync
        # mode, just shifted to the next call
        self.defer_pack = False
        self._pending: Optional[tuple] = None
        # scan-to-map, replayed as CUDA graphs on a card; its counts of
        # captures, replays and eager calls say how often they engage
        self.scan_graphs = loam_icp.ScanToMapGraphs()

    # ------------------------------------------------------------------

    def _t(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def load_reference_state(self, arrays: Mapping[str, np.ndarray],
                             host: dict) -> None:
        """Take over a mapper state given as numpy arrays (e.g. the JAX
        mapper's): the device arrays of DEVICE_STATE go onto this mapper's
        device, the host fields of HOST_STATE are copied."""
        for name in DEVICE_STATE:
            cur = getattr(self, name)
            a = np.array(arrays[name], copy=True)
            if a.shape != tuple(cur.shape):
                raise ValueError(f"{name}: shape {a.shape}, expected "
                                 f"{tuple(cur.shape)}")
            setattr(self, name, torch.as_tensor(a, device=self.device).to(
                cur.dtype))
        pose = host["accum_start_pose"]
        self.accum_start_pose = None if pose is None else tuple(
            np.array(v, copy=True) if isinstance(v, np.ndarray) else v
            for v in pose)
        self.frames_since_submap = int(host["frames_since_submap"])
        self.initialized = bool(host["initialized"])
        self.submaps_emitted = int(host["submaps_emitted"])

    def _apply_corr(self, p_odom, q_odom):
        """w_map ← w_odom composition (transformAssociateToMap)."""
        q = lie.quat_mul(self.q_corr, q_odom)
        p = lie.quat_rotate(self.q_corr, p_odom) + self.p_corr
        return p, lie.quat_normalize(q)

    def _crop(self, center: torch.Tensor):
        radius = self.cfg.local_mapping.map_crop_radius
        d = torch.linalg.vector_norm(self.surf_map - center[None, :], dim=-1)
        self.surf_mask = self.surf_mask & (d < radius)
        dc = torch.linalg.vector_norm(self.corner_map - center[None, :],
                                      dim=-1)
        self.corner_mask = self.corner_mask & (dc < radius)

    def _register(self, sharp, sharp_mask, flat, flat_mask, flat_i, use_i,
                  p_odom, q_odom):
        """Scan-to-map from the corrected odometry guess, then `_gate` on
        the device: the count gate and the new map-to-odometry correction.
        On a card both replay as CUDA graphs (`scan_graphs`).  Returns the
        pose and the sweep's 17-float pack."""
        with TRACER.span("local_map.scan_to_map"):
            m = self.cfg.local_mapping
            p_guess, q_guess = self._apply_corr(p_odom, q_odom)
            ikw = dict(surf_i=flat_i, surf_map_i=self.surf_map_i) if use_i \
                else dict(surf_i=None, surf_map_i=None)
            p_new, q_new, self.p_corr, self.q_corr, pack = self.scan_graphs(
                sharp, sharp_mask, flat, flat_mask, self.corner_map,
                self.corner_mask, self.surf_map, self.surf_mask, p_guess,
                q_guess, outer_iters=m.outer_iters, gn_iters=m.gn_iters,
                finish=_gate, finish_args=(p_odom, q_odom), **ikw)
            return p_new, q_new, pack

    def _update_maps(self, p_new, q_new, sharp, sharp_mask, flat, flat_mask,
                     flat_i):
        """Insert the sweep's features, in the world frame, into the
        rolling maps (re-voxelized; the surf map carries intensity as a 4th
        voxel-averaged channel), crop them around the sensor, and add the
        flat points to the submap accumulation."""
        with TRACER.span("local_map.map_update"):
            m = self.cfg.local_mapping
            ts = m.downsample_table_size
            sharp_w = lie.quat_rotate(q_new[None, :], sharp) + p_new[None, :]
            flat_w = lie.quat_rotate(q_new[None, :], flat) + p_new[None, :]
            self.corner_map, self.corner_mask = _insert(
                self.corner_map, self.corner_mask, sharp_w, sharp_mask,
                m.corner_leaf, CORNER_CAP, ts)
            surf4 = torch.cat([self.surf_map, self.surf_map_i[:, None]],
                              dim=1)
            new4 = torch.cat([flat_w, flat_i[:, None]], dim=1)
            surf4_new, self.surf_mask = _insert(
                surf4, self.surf_mask, new4, flat_mask, m.surf_leaf,
                SURF_CAP, ts)
            self.surf_map = surf4_new[:, :3].contiguous()
            self.surf_map_i = surf4_new[:, 3].contiguous()
            self._crop(p_new)
            self.accum_buf, self.accum_mask = _insert(
                self.accum_buf, self.accum_mask, flat_w, flat_mask,
                m.surf_leaf, SUBMAP_CAP, ts)
            self.initialized = True

    # ------------------------------------------------------------------

    def process_full(self, t: float, full_pts, ring, rel_time, full_mask,
                     inten, p_odom, q_odom,
                     n_rings: int, n_azimuth: int,
                     scan_period: float) -> Optional[Submap]:
        """One deskewed sweep through LOAM extraction + scan-to-map +
        map/submap maintenance, with one blocking readback."""
        with TRACER.span("local_map.process_full", rid=t):
            m = self.cfg.local_mapping
            # drain the previous sweep's deferred pack FIRST: a submap
            # emission must reset the rolling map before this sweep's
            # insert runs
            sm_prev = self._harvest() if self.defer_pack else None
            use_i = m.use_intensity and inten is not None
            full_pts = self._t(full_pts)
            if inten is None:
                inten = torch.zeros((full_pts.shape[0],),
                                    dtype=torch.float32, device=self.device)
            p_odom, q_odom = self._t(p_odom), self._t(q_odom)

            with TRACER.span("local_map.features"):
                grid, occ, igrid = lfe.organize_grid(
                    full_pts, self._t(ring, torch.int32), self._t(rel_time),
                    self._t(full_mask, torch.bool), n_rings=n_rings,
                    n_azimuth=n_azimuth, scan_period=scan_period,
                    intensity=self._t(inten))
                feats = lfe.extract(grid, occ, igrid,
                                    use_intensity_mask=use_i)
            sharp, sharp_mask = feats.sharp, feats.sharp_mask
            flat, flat_mask = feats.less_flat, feats.less_flat_mask
            flat_i = feats.less_flat_i

            p_new, q_new, pack = self._register(sharp, sharp_mask, flat,
                                                flat_mask, flat_i, use_i,
                                                p_odom, q_odom)
            self._update_maps(p_new, q_new, sharp, sharp_mask, flat,
                              flat_mask, flat_i)
            if self.defer_pack:
                host = pack.to("cpu", non_blocking=True)
                ready = None
                if pack.is_cuda:
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(self.device))
                self._pending = (t, host, ready, p_new, q_new)
                return sm_prev
            with TRACER.span("local_map.readback"):
                hp = pack.cpu().numpy()      # the stage's single readback
            return self._after_step(t, hp, p_new, q_new)

    def _harvest(self) -> Optional[Submap]:
        """Drain the deferred sweep pack; may emit the pending submap."""
        if self._pending is None:
            return None
        t, host, ready, p_dev, q_dev = self._pending
        self._pending = None
        with TRACER.span("local_map.readback"):
            if ready is not None:
                ready.synchronize()
            hp = host.numpy()
        return self._after_step(t, hp, p_dev, q_dev)

    def flush(self) -> Optional[Submap]:
        """End-of-stream: drain any deferred pack (final trajectory row /
        submap)."""
        return self._harvest()

    def _after_step(self, t, hp, p_dev, q_dev) -> Optional[Submap]:
        """Host bookkeeping shared by process/process_full: trajectory,
        submap trigger, emission."""
        m = self.cfg.local_mapping
        p_np, q_np = hp[0:3], hp[3:7]
        odom_p_np, odom_q_np = hp[10:13], hp[13:17]
        self.trajectory.append((t, p_np, q_np))
        if self.accum_start_pose is None:
            self.accum_start_pose = (p_np.copy(), q_np.copy(), t,
                                     odom_p_np.copy(), odom_q_np.copy())
        self.frames_since_submap += 1
        dist = np.linalg.norm(p_np - self.accum_start_pose[0])
        if (dist > m.submap_trigger_dist
                or self.frames_since_submap >= m.submap_trigger_frames):
            return self._emit_submap(t, p_np, q_np, p_dev, q_dev,
                                     odom_p_np, odom_q_np)
        return None

    def process(self, t: float, sharp, sharp_mask, flat, flat_mask,
                p_odom, q_odom, flat_i=None) -> Optional[Submap]:
        """One feature frame: returns a Submap when the handoff triggers."""
        m = self.cfg.local_mapping
        sharp, flat = self._t(sharp), self._t(flat)
        sharp_mask = self._t(sharp_mask, torch.bool)
        flat_mask = self._t(flat_mask, torch.bool)
        use_i = m.use_intensity and flat_i is not None
        if flat_i is None:
            flat_i = torch.zeros((flat.shape[0],), dtype=torch.float32,
                                 device=self.device)
        else:
            flat_i = self._t(flat_i)
        p_odom, q_odom = self._t(p_odom), self._t(q_odom)

        p_new, q_new, pack = self._register(sharp, sharp_mask, flat,
                                            flat_mask, flat_i, use_i, p_odom,
                                            q_odom)
        self._update_maps(p_new, q_new, sharp, sharp_mask, flat, flat_mask,
                          flat_i)
        with TRACER.span("local_map.readback"):
            hp = pack.cpu().numpy()      # the frame's single readback
        return self._after_step(t, hp, p_new, q_new)

    def _emit_submap(self, t, p_np, q_np, p_dev, q_dev,
                     p_odom, q_odom) -> Submap:
        """Publish the accumulated map in the key-pose body frame (one
        readback), then reset the rolling map."""
        with TRACER.span("local_map.emit_submap"):
            pts_b = lie.quat_rotate_inv(q_dev[None, :],
                                        self.accum_buf - p_dev[None, :])
            packed = torch.cat([pts_b, self.accum_mask[:, None].to(
                torch.float32)], dim=1).cpu().numpy()
            pts_b = packed[packed[:, 3] > 0.5, :3]
            sm = Submap(t=t, p_w=p_np.copy(), q_w=q_np.copy(),
                        pts=pts_b.astype(np.float32),
                        odom_p=np.asarray(p_odom).copy(),
                        odom_q=np.asarray(q_odom).copy())
            # reset the rolling map (the global back end owns long-term
            # consistency)
            self.corner_mask = torch.zeros_like(self.corner_mask)
            self.surf_mask = torch.zeros_like(self.surf_mask)
            self.initialized = False
            self.accum_mask = torch.zeros_like(self.accum_mask)
            self.accum_start_pose = None
            self.frames_since_submap = 0
            self.submaps_emitted += 1
            return sm
