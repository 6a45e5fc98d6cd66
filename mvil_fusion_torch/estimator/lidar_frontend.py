"""Scan-to-scan LiDAR processing inside the estimator.

Counterpart of ``mvil_fusion_tpu/estimator/lidar_frontend.py``: the
reference's ``Estimator::processLidar`` (vils_estimator/src/
estimator.cpp:122-504) and its LiDAR-IMU extrinsic calibration
(lidar_frontend.cpp:32-331):

  sweep → bracket by window frames → deskew to sweep end (slerp from VIO
  poses) → voxel downsample → VGICP vs previous key sweep with VIO-predicted
  init → constraint-mode classification {0 off, 1 icp-fail, 2 agree,
  3 drift-correct, 4 zero-velocity, 5 pure-rotation} → bounded constraint
  list → factors for the window BA.

`sweep_full` (the counterpart of ``_sweep_full_jit``) queues a sweep's
device work op by op and waits for nothing; the host reads its (47,) pack
once per classified sweep, right away (`read_host_pack`) or, in deferred
mode, at the next sweep or solve (`start_host_pack_copy`).  What the
reference decides with ``lax.cond``/``jnp.where`` on host-known flags
(`has_prev`, `prev_bracketed`) are Python branches here, so its
placeholder map for the first sweep (``_empty_vmap``) has no counterpart.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.estimator import initialization as vinit
from mvil_fusion_torch.estimator import lidar_factors as lf
from mvil_fusion_torch.estimator import state as st
from mvil_fusion_torch.estimator.vio import (read_host_pack,
                                             start_host_pack_copy)
from mvil_fusion_torch.ops import deskew as dsk
from mvil_fusion_torch.ops import lm as lm_mod
from mvil_fusion_torch.ops import vgicp, voxel
from mvil_fusion_torch.utils import lie
from mvil_fusion_torch.utils.device import resolve_device, upload
from mvil_fusion_torch.utils.precision import full_precision

PACK_SIZE = 47


@full_precision
def sweep_full(pts, rel_time, mask, state_p, state_q, idx, alphas,
               prev_stored_p, prev_stored_q, prev_bracketed: bool,
               has_prev: bool, prev_vmap, q_lb, tlb, rlb,
               scan_period: float, leaf_size: float,
               vgicp_resolution: float, iters: int, max_corr_dist: float,
               ds_table: int = 1 << 16, vg_table: int = 1 << 16):
    """One sweep's device work: window-pose interpolation → lidar-frame
    poses → deskew → downsamples → Gaussian voxel map → (when a previous
    key sweep exists) VGICP and the inputs of the constraint-mode
    classification, packed into one (47,) tensor.

    `idx` (3,2) host ints and `alphas` (3,) tensor: the (start, end,
    prev-end) window brackets computed on the host.  Returns (undist,
    down.pts, down.mask, vmap_new, reg.pts, reg.mask, pl_e, ql_e, p_be,
    q_be, pack); the pack is zeros without a previous sweep."""
    dtype = torch.float32

    def interp(k):
        i, j = int(idx[k][0]), int(idx[k][1])
        a = alphas[k]
        q = lie.quat_slerp(state_q[i], state_q[j], a)
        p = state_p[i] * (1 - a) + state_p[j] * a
        return p, q

    p_bs, q_bs = interp(0)
    p_be, q_be = interp(1)

    def b2l(p, q):
        return (p + lie.quat_rotate(q, tlb),
                lie.quat_normalize(lie.quat_mul(q, q_lb)))

    pl_s, ql_s = b2l(p_bs, q_bs)
    pl_e, ql_e = b2l(p_be, q_be)

    undist = dsk.deskew_to_end(pts, rel_time, pl_s, ql_s, pl_e, ql_e,
                               scan_period)
    down = voxel.voxel_downsample(undist, mask, leaf_size, 8192,
                                  table_size=ds_table)
    vmap_new = voxel.build_gaussian_voxel_map(undist, mask,
                                              vgicp_resolution,
                                              table_size=vg_table)
    reg = voxel.voxel_downsample(undist, mask, vgicp_resolution, 4096,
                                 table_size=ds_table)

    if not has_prev:
        pack = torch.zeros((PACK_SIZE,), dtype=dtype, device=pts.device)
        return (undist, down.pts, down.mask, vmap_new, reg.pts, reg.mask,
                pl_e, ql_e, p_be, q_be, pack)

    if prev_bracketed:
        p_bp, q_bp = interp(2)
    else:
        p_bp, q_bp = prev_stored_p, prev_stored_q
    pl_p, ql_p = b2l(p_bp, q_bp)
    p_rel, q_rel = lie.pose_between(pl_p, ql_p, pl_e, ql_e)
    res = vgicp.vgicp_align(reg.pts, reg.mask, prev_vmap, vmap_new,
                            p_rel, q_rel, iters=iters,
                            max_corr_dist=max_corr_dist)
    yaw = torch.abs(torch.rad2deg(
        lie.mat_to_ypr(lie.quat_to_mat(q_rel))[0]))
    n_src = torch.sum(reg.mask).to(dtype)
    R_icp = lie.quat_to_mat(res.q)
    Rb = rlb @ R_icp @ rlb.T
    tb_ = rlb @ res.p + tlb - Rb @ tlb
    q_b_icp = lie.mat_to_quat(Rb)
    q_b_rel = lie.quat_mul(lie.quat_conj(q_bp), q_be)
    t_b_rel = lie.quat_rotate_inv(q_bp, p_be - p_bp)
    pack = torch.cat([
        res.p, res.q,                                          # 0:3, 3:7
        torch.stack([res.fitness, res.n_corr.to(dtype), n_src,
                     yaw]),                                    # 7:11
        p_rel, q_rel,                                          # 11:14,14:18
        tb_, q_b_icp,                                          # 18:21,21:25
        q_b_rel, t_b_rel,                                      # 25:29,29:32
        pl_e, ql_e,                                            # 32:35,35:39
        p_be, q_be,                                            # 39:42,42:46
        res.converged.to(dtype)[None],                         # 46
    ])
    return (undist, down.pts, down.mask, vmap_new, reg.pts, reg.mask,
            pl_e, ql_e, p_be, q_be, pack)


def lidar_align(q_l: torch.Tensor, t_l: torch.Tensor, t_b: torch.Tensor,
                q_b: torch.Tensor, q_lb0: torch.Tensor,
                plb_lower, plb_upper, iters: int = 40):
    """Joint (R_lb, T_lb) refinement from paired relative motions.

    The reference's bounded Ceres solve (lidar_frontend.cpp Lidar_align
    :233-331, residual lidar_frontend.h LidarInitConstraint :156-238):
      translation rows: (I − R_l) T_lb − t_l + R_lb t_b
      rotation rows:    2·vec( R_lb R_b R_lbᵀ R_lᵀ )
    with T_lb box-bounded by PLB_*, solved by projected LM; the residuals
    of all pairs are one batched expression.

    Returns (q_lb, t_lb, ok); `ok` reads the final cost back (one wait).
    """
    dtype, dev = t_l.dtype, t_l.device
    R_l = lie.quat_to_mat(q_l)                    # (N,3,3)
    R_b = lie.quat_to_mat(q_b)
    I3 = torch.eye(3, dtype=dtype, device=dev)

    def residual(x):
        q_lb = lie.quat_boxplus(q_lb0, x[0:3])
        t_lb = x[3:6]
        R_lb = lie.quat_to_mat(q_lb)
        r_t = ((I3 - R_l) @ t_lb) - t_l + t_b @ R_lb.T
        Rres = R_lb @ R_b @ R_lb.T @ R_l.transpose(-1, -2)
        r_r = 2.0 * lie.mat_to_quat(Rres)[:, 1:4]
        return torch.cat([r_t, r_r], dim=-1).reshape(-1)

    lo = torch.as_tensor(plb_lower, dtype=dtype).to(dev)
    hi = torch.as_tensor(plb_upper, dtype=dtype).to(dev)
    inf = torch.full((3,), math.inf, dtype=dtype, device=dev)
    lower = torch.cat([-inf, lo])
    upper = torch.cat([inf, hi])
    x0 = torch.cat([torch.zeros(3, dtype=dtype, device=dev),
                    torch.minimum(torch.maximum(
                        torch.zeros(3, dtype=dtype, device=dev), lo), hi)])
    res = lm_mod.lm_solve(residual, x0, iters=iters, lower=lower,
                          upper=upper)
    q_lb = lie.quat_boxplus(q_lb0, res.x[0:3])
    ok = float(res.cost) < 1.0   # reference gate: final_cost > 1.0 → fail
    return q_lb, res.x[3:6], ok


@dataclass
class IcpRecord:
    """Host-side record of one scan-to-scan constraint (the reference's
    LidarICPConstraint struct)."""

    mode: int
    t_i: float
    t_j: float
    ta: float
    tb: float
    tc: float
    td: float
    trans_p: np.ndarray
    trans_q: np.ndarray
    weight: float


@dataclass
class KeySweep:
    t_end: float
    pts: torch.Tensor         # (M,3) downsampled, deskewed (lidar frame)
    mask: torch.Tensor
    reg_pts: torch.Tensor     # registration source (vgicp-leaf centroids)
    reg_mask: torch.Tensor
    vmap: voxel.GaussianVoxelMap
    bracket: tuple            # (ta, tb) image times bracketing the sweep end
    p_w: torch.Tensor         # body pose at sweep end (VIO, for prediction)
    q_w: torch.Tensor


class LidarFrontend:
    def __init__(self, cfg: SystemConfig,
                 device: torch.device | str | None = None):
        """`device` None is the current CUDA device (a RuntimeError where
        there is no card); a CPU caller passes ``device="cpu"``."""
        self.cfg = cfg
        self.device = resolve_device(device)
        lc = cfg.lidar
        self.rlb = np.asarray(lc.rlb, np.float32).reshape(3, 3)
        self.tlb = np.asarray(lc.tlb, np.float32)
        self.q_lb = lie.mat_to_quat(torch.as_tensor(self.rlb)).numpy()
        self.constraints: list[IcpRecord] = []
        self.prev: Optional[KeySweep] = None
        self.first_zv = True
        self.zv_pose: Optional[tuple] = None
        self.last_mode = 0
        # LI extrinsic calibration buffers (lidar_frontend.cpp:32-141)
        self.calib_q_b: list = []
        self.calib_q_l: list = []
        self.calib_t_b: list = []
        self.calib_t_l: list = []
        self.calib_w: list = []
        # constraint-mode histogram (modes 0-5; the reference surfaces the
        # mode as colored RViz markers, mynteye_leishen_indoor.yaml:136)
        self.mode_counts = [0] * 6
        self.calibrated = not lc.use_estimated_extrinsic
        # deferred readback: the sweep's pack is copied to pinned memory
        # without waiting and harvested at the next sweep or at the next
        # solve, whichever comes first
        self.defer_pack = False
        self._pending_pack: Optional[tuple] = None

    # -------------------------------------------------------------- helpers

    def _up(self, x, dtype=torch.float32) -> torch.Tensor:
        return upload(x, self.device, dtype)

    @staticmethod
    def find_bracket(times, t):
        """Nearest two window frames around t (reference FindNearest2ID)."""
        for i in range(len(times) - 1):
            if times[i] <= t <= times[i + 1]:
                return i, i + 1
        return None

    # ------------------------------------------------------------- main API

    def process_sweep(self, t_start: float, pts, rel_time, mask,
                      window_times: list, s: st.WindowState
                      ) -> Optional[dict]:
        """One compensated sweep against the current VIO window.

        Returns a dict with the deskewed downsampled cloud + lidar pose (for
        mapping/depth feedback), or None if the sweep cannot be bracketed.
        `pts`, `rel_time` and `mask` are tensors on the front end's device
        (the compensator's output) or host arrays.  A classified sweep
        waits for the card once (its pack), and not at all in deferred
        mode.
        """
        lc = self.cfg.lidar
        self._harvest_pack()        # drain the previous sweep's deferred pack
        t_end = t_start + lc.scan_period
        bs = self.find_bracket(window_times, t_start)
        be = self.find_bracket(window_times, t_end)
        if bs is None or be is None:
            return None

        prev = self.prev

        def alpha(bracket, t):
            i, j = bracket
            return (t - window_times[i]) / max(window_times[j]
                                               - window_times[i], 1e-6)

        # host-computed brackets for (sweep start, sweep end, prev end);
        # the previous key-sweep pose is re-interpolated from the CURRENT
        # window when still bracketed (reference PredictRelative_rt,
        # lidar_frontend.cpp:921-987 — the stored snapshot goes stale as
        # the window re-optimizes), else its stored pose is used
        bp = (self.find_bracket(window_times, prev.t_end)
              if prev is not None else None)
        idx = [bs, be, bp if bp is not None else (0, 1)]
        # one upload: alphas, the extrinsic (q_lb, tlb, rlb)
        host = np.concatenate([
            np.asarray([alpha(bs, t_start), alpha(be, t_end),
                        alpha(bp, prev.t_end) if bp is not None else 0.0],
                       np.float32),
            self.q_lb, self.tlb, self.rlb.reshape(-1)]).astype(np.float32)
        dev_host = self._up(host)
        alphas, q_lb, tlb = dev_host[0:3], dev_host[3:7], dev_host[7:10]
        rlb = dev_host[10:19].reshape(3, 3)

        pts, rel_time = self._up(pts), self._up(rel_time)
        mask = self._up(mask, torch.bool)
        (undist, down_pts, down_mask, vmap_new, reg_pts, reg_mask,
         pl_e, ql_e, p_be, q_be, pack) = sweep_full(
            pts, rel_time, mask, s.p, s.q, idx, alphas,
            prev.p_w if prev is not None else None,
            prev.q_w if prev is not None else None,
            bp is not None, prev is not None,
            prev.vmap if prev is not None else None, q_lb, tlb, rlb,
            scan_period=lc.scan_period, leaf_size=lc.leaf_size,
            vgicp_resolution=lc.vgicp_resolution,
            iters=lc.vgicp_iters, max_corr_dist=lc.max_corr_dist,
            ds_table=lc.downsample_table_size,
            vg_table=lc.vgicp_table_size)

        out = dict(t_end=t_end, pts=down_pts, mask=down_mask,
                   full_pts=undist, full_mask=mask,
                   p_l=pl_e, q_l=ql_e, mode=0)
        cur = KeySweep(t_end=t_end, pts=down_pts, mask=down_mask,
                       reg_pts=reg_pts, reg_mask=reg_mask,
                       vmap=vmap_new,
                       bracket=(window_times[be[0]], window_times[be[1]]),
                       p_w=p_be, q_w=q_be)
        if prev is None:
            self.prev = cur
            return out

        if self.defer_pack:
            # copy to pinned memory without waiting; classification and
            # the constraint record happen at the harvest point
            self._pending_pack = (start_host_pack_copy(pack), prev, cur)
            self.prev = cur
            out["mode"] = None        # known at harvest (self.last_mode)
            return out

        hp = read_host_pack(pack)       # the sweep's single blocking readback
        mode = self._apply_sweep_pack(hp, prev, cur)
        out["mode"] = mode
        self.prev = cur
        return out

    def _harvest_pack(self):
        """Drain a deferred sweep pack (no-op when none is pending)."""
        if self._pending_pack is None:
            return
        (host, done), prev, cur = self._pending_pack
        self._pending_pack = None
        if done is not None:
            done.synchronize()
        self._apply_sweep_pack(host.numpy(), prev, cur)

    def _apply_sweep_pack(self, hp: np.ndarray, prev: KeySweep,
                          cur: KeySweep) -> int:
        """Constraint-mode classification + record/calibration bookkeeping
        from the fetched (47,) sweep pack."""
        lc = self.cfg.lidar
        t_end = cur.t_end
        t_icp, q_icp = hp[0:3], hp[3:7]
        fitness = float(hp[7])
        n_corr = int(hp[8])
        n_src = int(hp[9])
        yaw_guess = abs(float(hp[10]))
        p_rel_h = hp[11:14]
        converged = bool(hp[46] > 0.5)

        # ---- constraint-mode classification (estimator.cpp:324-436);
        # additionally gate on correspondence count — with too few matched
        # voxels the registration is unconstrained garbage
        diff_t = float(np.abs(p_rel_h - t_icp).sum())
        icp_t_l1 = float(np.abs(t_icp).sum())
        icp_good = (fitness < lc.fitness_fail
                    and n_corr >= max(50, int(0.4 * n_src)))
        if icp_good and diff_t > 0.1 and converged:
            # drift-correct: only from a CONVERGED registration — the
            # reference trusts its fitness alone (estimator.cpp:340), but a
            # non-converged GN disagreeing with VIO by >10 cm is exactly
            # the case where the heavy mode-3 factor would inject garbage
            mode = 3
        elif icp_good:
            mode = 2
        else:
            mode = 1
        # zero-velocity / pure-rotation override (reference hardcodes the
        # 0.01 m gate for its point-to-point ICP; ours is configurable and
        # requires a trustworthy registration)
        if icp_t_l1 < lc.zero_velocity_trans and icp_good:
            mode = 4 if yaw_guess < lc.pure_rotation_yaw else 5
        self.last_mode = mode
        self.mode_counts[mode] += 1

        # body-frame measured relative translation (EX_LB⁻¹ T EX_LB),
        # computed by sweep_full, read from the pack
        tb_ = hp[18:21]
        q_b_icp = hp[21:25]

        rec = IcpRecord(
            mode=mode, t_i=prev.t_end, t_j=t_end,
            ta=prev.bracket[0], tb=prev.bracket[1],
            tc=cur.bracket[0], td=cur.bracket[1],
            trans_p=tb_.astype(np.float32), trans_q=q_b_icp,
            # reference weight is 100/fitness in its point-to-point metric;
            # our voxel-mean fitness has a discretization floor, so cap the
            # weight at the ~2 cm-sigma level to keep factors sane
            weight=min(100.0 / max(fitness, 1e-3), 50.0)
            if mode == 3 else 0.0)

        # zero-velocity bookkeeping (estimator.cpp:388-412); the pose
        # stays on the device (reading it would be a second wait)
        if mode == 4:
            if self.first_zv:
                self.zv_pose = (prev.p_w, prev.q_w)
                self.first_zv = False
                while len(self.constraints) > 1:
                    self.constraints.pop(0)
        elif mode == 3 and not self.first_zv and len(self.constraints) == 1:
            self.constraints.pop(0)
            self.first_zv = True
        self.constraints.append(rec)
        while len(self.constraints) > lf.MAX_ICP:
            self.constraints.pop(0)

        # LI extrinsic calibration data (rotation pairs weighted by fitness)
        if not self.calibrated and mode in (2, 3):
            q_b_rel = hp[25:29]
            t_b_rel = hp[29:32]
            self.calib_q_b.append(q_b_rel)
            self.calib_q_l.append(q_icp)
            self.calib_t_b.append(t_b_rel)
            self.calib_t_l.append(t_icp)
            self.calib_w.append(1.0 / max(fitness, 1e-2))
            if len(self.calib_q_b) >= 30:
                self._calibrate_extrinsics()
        return mode

    def _calibrate_extrinsics(self):
        """Hand-eye LI rotation (lidar_frontend.cpp
        CalibrationLidarExRotation :32-141) followed by the bounded joint
        (R_lb, T_lb) refinement (Lidar_align :233-331), on the front end's
        device: two waits (the cost gate and the result)."""
        lc = self.cfg.lidar
        up = self._up
        q_lb = vinit.hand_eye_rotation(up(np.asarray(self.calib_q_b)),
                                       up(np.asarray(self.calib_q_l)),
                                       up(np.asarray(self.calib_w)))
        q_lb_r, t_lb, ok = lidar_align(
            up(np.asarray(self.calib_q_l)), up(np.asarray(self.calib_t_l)),
            up(np.asarray(self.calib_t_b)), up(np.asarray(self.calib_q_b)),
            q_lb, lc.plb_lower, lc.plb_upper)
        if not ok:
            # keep rotation-only result, retry translation later
            # (reference watchdog resets after 200 frames,
            # lidar_frontend.cpp:58-63)
            if len(self.calib_q_b) > 200:
                self.calib_q_b.clear()
                self.calib_q_l.clear()
                self.calib_t_b.clear()
                self.calib_t_l.clear()
                self.calib_w.clear()
            return
        qt = torch.cat([q_lb_r, t_lb]).cpu()
        self.q_lb = qt[:4].numpy()
        self.rlb = lie.quat_to_mat(qt[:4]).numpy()
        self.tlb = qt[4:].numpy()
        self.calibrated = True

    # ------------------------------------------------------- factor tables

    def build_constraints(self, window_times: list):
        """Device tables for the window BA (modes 3 → ICP rows; any mode 4
        in the list → zero-velocity flag).

        In deferred mode the newest sweep's pack is NOT force-harvested
        here: its record enters the list at the next sweep instead, so the
        solve never waits for the sweep in flight.  The reference has the
        same relaxation — its lidar thread classifies constraints
        concurrently with `process`, and whatever list exists at
        optimization time is used (estimator_node.cpp:338-376)."""
        if not self.defer_pack:
            self._harvest_pack()
        ids = np.zeros((lf.MAX_ICP, 4), np.int64)
        a_i = np.zeros(lf.MAX_ICP, np.float32)
        a_j = np.zeros(lf.MAX_ICP, np.float32)
        tp = np.zeros((lf.MAX_ICP, 3), np.float32)
        w = np.zeros(lf.MAX_ICP, np.float32)
        act = np.zeros(lf.MAX_ICP, bool)
        zero_vel = self.fill_constraint_tables(window_times, ids, a_i, a_j,
                                               tp, w, act)
        icp = lf.icp_from_numpy(dict(ids=ids, alpha_i=a_i, alpha_j=a_j,
                                     trans_p=tp, weight=w, active=act),
                                device=self.device)
        return icp, zero_vel

    def fill_constraint_tables(self, window_times: list, ids, a_i, a_j,
                               tp, w, act) -> bool:
        """Write the 4-pose ICP constraint rows into the given arrays
        (host views of the frame tables).  Returns the zero-velocity flag.
        Does not harvest the sweep pack in flight: the caller does, by
        the same policy as build_constraints."""
        zero_vel = False
        tmap = {round(t, 6): i for i, t in enumerate(window_times)}
        for k, rec in enumerate(self.constraints[-lf.MAX_ICP:]):
            if rec.mode == 4:
                zero_vel = True
                continue
            if rec.mode != 3:
                continue
            key = [tmap.get(round(t, 6)) for t in
                   (rec.ta, rec.tb, rec.tc, rec.td)]
            if any(v is None for v in key):
                continue
            ids[k] = key
            a_i[k] = (rec.t_i - rec.ta) / max(rec.tb - rec.ta, 1e-6)
            a_j[k] = (rec.t_j - rec.tc) / max(rec.td - rec.tc, 1e-6)
            tp[k] = rec.trans_p
            w[k] = rec.weight
            act[k] = True
        return zero_vel

