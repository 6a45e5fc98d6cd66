"""Sliding-window state layout of the VIO estimator.

Counterpart of ``mvil_fusion_tpu/estimator/state.py``: the reference's
``para_Pose / para_SpeedBias / para_Feature / para_Ex_Pose / para_Td``
parameter blocks (vils_estimator/src/estimator.cpp vector2double/
double2vector :906-1074) as one fixed-shape NamedTuple of tensors and a
single packed local-delta vector.

Local-delta layout (dimension D = 15*W + 6 + 1):
  frame k (k = 0..W-1): [δp(3), δθ(3), δv(3), δba(3), δbg(3)] at offset 15k
  camera-IMU extrinsic: [δt(3), δθ(3)] at offset 15W
  time offset td:       [δtd]          at offset 15W + 6
Landmark inverse depths are a separate (F,) vector, Schur-eliminated in the
solver.  All shapes are static; invalid slots are masked.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from mvil_fusion_torch.utils import lie
from mvil_fusion_torch.utils.device import resolve_device


def frame_offset(k: int) -> int:
    return 15 * k


def ext_offset(w: int) -> int:
    return 15 * w


def td_offset(w: int) -> int:
    return 15 * w + 6


def pose_dim(w: int) -> int:
    """Total pose-side local dimension D."""
    return 15 * w + 7


class WindowState(NamedTuple):
    """All optimizable state of the sliding window."""

    p: torch.Tensor    # (W,3) body position in world
    q: torch.Tensor    # (W,4) body orientation (w,x,y,z)
    v: torch.Tensor    # (W,3) velocity in world
    ba: torch.Tensor   # (W,3) accel bias
    bg: torch.Tensor   # (W,3) gyro bias
    tic: torch.Tensor  # (3,) camera-in-IMU translation
    qic: torch.Tensor  # (4,) camera-in-IMU rotation
    td: torch.Tensor   # () camera-IMU time offset
    inv_depth: torch.Tensor  # (F,) landmark inverse depths (start-frame)

    @property
    def window(self) -> int:
        return self.p.shape[0]

    @property
    def num_features(self) -> int:
        return self.inv_depth.shape[0]


def make_window_state(w: int, f: int, dtype=torch.float32,
                      device: torch.device | str | None = None
                      ) -> WindowState:
    """The identity window on `device` (None: the current CUDA device)."""
    dev = resolve_device(device)
    qid = lie.quat_identity(dtype, dev)
    return WindowState(
        p=torch.zeros((w, 3), dtype=dtype, device=dev),
        q=qid.repeat(w, 1),
        v=torch.zeros((w, 3), dtype=dtype, device=dev),
        ba=torch.zeros((w, 3), dtype=dtype, device=dev),
        bg=torch.zeros((w, 3), dtype=dtype, device=dev),
        tic=torch.zeros((3,), dtype=dtype, device=dev),
        qic=qid,
        td=torch.zeros((), dtype=dtype, device=dev),
        inv_depth=torch.ones((f,), dtype=dtype, device=dev),
    )


class Features(NamedTuple):
    """Per-landmark observation table over the window (static shapes),
    the reference's FeatureManager track list
    (vils_estimator/src/feature_manager.h:19-75) as a dense (F, W) table."""

    start: torch.Tensor       # (F,) int64 reference (host) frame index
    obs: torch.Tensor         # (F,W,2) normalized undistorted coords
    vel: torch.Tensor         # (F,W,2) normalized-plane velocity (for td)
    td_ref: torch.Tensor      # (F,W) td estimate at packaging time
    mask: torch.Tensor        # (F,W) bool: observed in frame w
    depth_fixed: torch.Tensor  # (F,) bool: lidar-measured depth, hold constant
    valid: torch.Tensor       # (F,) bool: slot in use (and in the problem)


def from_numpy(a, dtype, device: torch.device) -> torch.Tensor:
    """A copy of numpy-like `a` as a `dtype` tensor on `device`."""
    return torch.as_tensor(np.array(a, copy=True)).to(device=device,
                                                       dtype=dtype)


def window_state_from_numpy(arrays, dtype=torch.float32,
                            device: torch.device | str | None = None
                            ) -> WindowState:
    """A WindowState from its nine fields as numpy (a Mapping, or a
    NamedTuple such as the JAX package's state), copied onto `device`."""
    dev = resolve_device(device)
    if not isinstance(arrays, Mapping):
        arrays = arrays._asdict()
    return WindowState(**{n: from_numpy(arrays[n], dtype, dev)
                          for n in WindowState._fields})


def features_from_numpy(arrays, dtype=torch.float32,
                        device: torch.device | str | None = None
                        ) -> Features:
    """A Features table from its seven fields as numpy (a Mapping or a
    NamedTuple), copied onto `device`; `start` becomes int64 and the
    masks bool."""
    dev = resolve_device(device)
    if not isinstance(arrays, Mapping):
        arrays = arrays._asdict()
    kinds = dict(start=torch.int64, mask=torch.bool,
                 depth_fixed=torch.bool, valid=torch.bool)
    return Features(**{n: from_numpy(arrays[n], kinds.get(n, dtype), dev)
                       for n in Features._fields})


def apply_delta(s: WindowState, dx: torch.Tensor,
                dl: Optional[torch.Tensor] = None) -> WindowState:
    """Boxplus: apply a packed pose-side delta (D,) and optional landmark
    delta (F,)."""
    w = s.window
    dxf = dx[: 15 * w].reshape(w, 15)
    p = s.p + dxf[:, 0:3]
    q = lie.quat_normalize(lie.quat_mul(s.q, lie.quat_exp(dxf[:, 3:6])))
    v = s.v + dxf[:, 6:9]
    ba = s.ba + dxf[:, 9:12]
    bg = s.bg + dxf[:, 12:15]
    e = ext_offset(w)
    tic = s.tic + dx[e:e + 3]
    qic = lie.quat_normalize(lie.quat_mul(s.qic,
                                          lie.quat_exp(dx[e + 3:e + 6])))
    td = s.td + dx[td_offset(w)]
    inv_depth = s.inv_depth if dl is None else s.inv_depth + dl
    return s._replace(p=p, q=q, v=v, ba=ba, bg=bg, tic=tic, qic=qic, td=td,
                      inv_depth=inv_depth)


def state_boxminus(s: WindowState, s0: WindowState) -> torch.Tensor:
    """Packed local difference s ⊟ s0 of the pose-side parameters (D,),
    used to relinearize the marginalization prior r = r0 + J0 (x ⊟ x0)
    (reference: marginalization_factor.cpp MarginalizationFactor::Evaluate).
    """
    dp = s.p - s0.p
    dth = lie.quat_boxminus(s.q, s0.q)
    dv = s.v - s0.v
    dba = s.ba - s0.ba
    dbg = s.bg - s0.bg
    frames = torch.cat([dp, dth, dv, dba, dbg], dim=-1).reshape(-1)
    dext = torch.cat([s.tic - s0.tic, lie.quat_boxminus(s.qic, s0.qic)])
    return torch.cat([frames, dext, (s.td - s0.td)[None]])


def gauge_fix(s: WindowState, p0_old: torch.Tensor, q0_old: torch.Tensor
              ) -> WindowState:
    """Re-anchor the window so frame 0 keeps its pre-optimization position
    and yaw (the 4 unobservable dofs), as the reference's double2vector
    yaw correction does (estimator.cpp:960-1074)."""
    ypr_old = lie.mat_to_ypr(lie.quat_to_mat(q0_old))
    ypr_new = lie.mat_to_ypr(lie.quat_to_mat(s.q[0]))
    dyaw = ypr_old[0] - ypr_new[0]
    zero = torch.zeros_like(dyaw)
    R = lie.ypr_to_mat(torch.stack([dyaw, zero, zero]))
    q_rot = lie.mat_to_quat(R)
    p = (s.p - s.p[0:1]) @ R.T + p0_old
    q = lie.quat_normalize(lie.quat_mul(q_rot[None, :], s.q))
    v = s.v @ R.T
    return s._replace(p=p, q=q, v=v)
