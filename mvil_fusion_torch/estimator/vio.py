"""The per-frame device program of the sliding-window VIO estimator.

Counterpart of the device half of ``mvil_fusion_tpu/estimator/vio.py``
(``_frame_step_body``, ``_gauge_fix``, ``_extras_body``): the reference's
processImage → optimization → slideWindow numerics (vils_estimator/src/
estimator.cpp :506-616, :1124-1814) for one keyframe.

`frame_step` is queued on the device op by op.  It waits for the card
twice, in the two ``torch.linalg.eigh`` of the marginalization;
`read_host_pack` is the step's one copy back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from mvil_fusion_torch.estimator import ba
from mvil_fusion_torch.estimator import lidar_factors as lfac
from mvil_fusion_torch.estimator import state as st
from mvil_fusion_torch.ops import preintegration as pre
from mvil_fusion_torch.ops import triangulate as tri
from mvil_fusion_torch.utils import lie
from mvil_fusion_torch.utils.precision import full_precision

# host_pack layout: metrics(5) cost(1) p(3) q(4) v(3) tic(3) qic(4) td(1)
# bg(3) inv_depth(F)
HOST_PACK_HEAD = 27


@full_precision
def frame_step(state, feats, need_depth, accs, gyrs, dts, imu_masks,
               prior, gravity, noise_cov, icp_tab, lps_tab, zero_vel,
               fix_mask, focal, iters, marg_old):
    """One keyframe: preintegration → triangulation of new landmarks →
    extras → window BA → failure metrics → marginalization.

    `iters` and `marg_old` are Python values.  Returns (s_new, prior_new,
    metrics (5,), cost1, host_pack (27 + F,)).
    """
    preints = pre.preintegrate_batch(accs, gyrs, dts, state.ba[:-1],
                                     state.bg[:-1], noise_cov, imu_masks)
    imask = imu_masks.any(dim=1)

    p_wc, q_wc = tri.camera_poses_from_body(state.p, state.q, state.tic,
                                            state.qic)
    inv_d, good = tri.triangulate_window(p_wc, q_wc, feats.obs, feats.mask,
                                         feats.start)
    state = state._replace(inv_depth=torch.where(good & need_depth, inv_d,
                                                 state.inv_depth))

    eJ, er = _extras_body(state, icp_tab, lps_tab, zero_vel)
    prob = ba.BAProblem(
        feats=feats, preints=preints, interval_mask=imask, prior=prior,
        gravity=gravity, anchor_ref=state, extra_J=eJ, extra_r=er,
        extra_x0=state, fix_mask=fix_mask)
    res = ba.solve(state, prob, focal, iters=iters)
    s_new = _gauge_fix(state, res.state)

    prev_p = state.p[-1]
    metrics = torch.stack([
        torch.linalg.vector_norm(s_new.ba[-1]),
        torch.linalg.vector_norm(s_new.bg[-1]),
        torch.linalg.vector_norm(s_new.p[-1] - prev_p),
        torch.abs(s_new.p[-1, 2] - prev_p[2]),
        torch.isfinite(torch.sum(s_new.p)).to(s_new.p.dtype),
    ])

    if marg_old:
        prior_new = ba.marginalize_old(s_new, prob, focal)
    else:
        prior_new = ba.marginalize_second_new(s_new, prob)

    host_pack = torch.cat([
        metrics, res.cost1[None], s_new.p[-1], s_new.q[-1], s_new.v[-1],
        s_new.tic, s_new.qic, s_new.td[None], s_new.bg[-1],
        s_new.inv_depth])
    return s_new, prior_new, metrics, res.cost1, host_pack


def read_host_pack(host_pack: torch.Tensor) -> np.ndarray:
    """`host_pack` on the host: on the card, one copy into pinned memory
    and one wait for the stream."""
    if host_pack.device.type != "cuda":
        return host_pack.numpy().copy()
    out = torch.empty(host_pack.shape, dtype=host_pack.dtype,
                      pin_memory=True)
    out.copy_(host_pack, non_blocking=True)
    torch.cuda.current_stream(host_pack.device).synchronize()
    return out.numpy()


def _gauge_fix(s_old: st.WindowState, s_new: st.WindowState
               ) -> st.WindowState:
    """4-dof gauge re-anchor after every solve (the reference's
    double2vector, estimator.cpp:960-1074): rotate and translate the whole
    window so frame 0 keeps its pre-solve yaw and position.  Yaw and
    global translation are exact null directions of the visual-inertial
    cost (gravity [0,0,g] is yaw-invariant); without the re-anchor the
    gauge random-walks from solve to solve."""
    R_old0 = lie.quat_to_mat(s_old.q[0])
    R_new0 = lie.quat_to_mat(s_new.q[0])
    ypr_old = lie.mat_to_ypr(R_old0)
    ypr_new = lie.mat_to_ypr(R_new0)
    y_diff = ypr_old[0] - ypr_new[0]
    zero = torch.zeros_like(y_diff)
    R_yaw = lie.ypr_to_mat(torch.stack([y_diff, zero, zero]))
    # pitch-singularity fallback (reference: "euler singular point!")
    lim = np.deg2rad(89.0)
    singular = (ypr_old[1].abs() > lim) | (ypr_new[1].abs() > lim)
    R_diff = torch.where(singular, R_old0 @ R_new0.T, R_yaw)
    q_diff = lie.mat_to_quat(R_diff)
    p = (s_new.p - s_new.p[0:1]) @ R_diff.T + s_old.p[0:1]
    v = s_new.v @ R_diff.T
    q = lie.quat_normalize(lie.quat_mul(q_diff, s_new.q))
    return s_new._replace(p=p, q=q, v=v)


def _extras_body(s: st.WindowState, icp_tab: lfac.IcpConstraints,
                 lps_tab: lfac.LpsConstraints, zero_vel):
    J1, r1 = lfac.icp_system(s, icp_tab)
    J2, r2 = lfac.lps_system(s, lps_tab)
    J3, r3 = lfac.zero_velocity_system(s, zero_vel)
    return torch.cat([J1, J2, J3], dim=0), torch.cat([r1, r2, r3], dim=0)
