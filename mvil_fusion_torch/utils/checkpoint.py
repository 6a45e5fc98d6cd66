"""Checkpoint / resume for the full SLAM system.

Counterpart of ``mvil_fusion_tpu/utils/checkpoint.py``.  The reference has
NO runtime persistence — the iSAM2 graph and map live only in memory and
the result files are written in destructors (SURVEY.md §5,
globalMappingIkdTree.cpp:118-131).  Here the whole system state — sliding
window + marginalization prior + feature tracks + raw IMU buffers + LiDAR
front end + rolling local map + pose graph + keyed scans + the depth
register's ring and the sweeps waiting for the window — serializes to one
file, so a crashed or migrated session resumes mid-run.  The KLT tracker
and the compensator are not saved (nor in the reference): a resumed system
starts tracking anew.

Every tensor is stored as a numpy array (a pickle persistent id) and
restored onto the restoring system's device, so the file names no `torch`
global and a checkpoint taken on the card resumes on the CPU.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from mvil_fusion_torch.mapping.global_mapping import (STATE_ARRAYS,
                                                      STATE_COUNTERS,
                                                      STATE_LISTS)
from mvil_fusion_torch.mapping.local_mapping import DEVICE_STATE, HOST_STATE

# Deserialization is restricted to the classes a checkpoint legitimately
# contains: numpy array reconstructors and this package's own state types.
# A tampered file can therefore not execute arbitrary callables (the
# classic pickle RCE); it can at worst corrupt numeric state.
_SAFE_MODULE_PREFIXES = ("mvil_fusion_torch.",)
_SAFE_GLOBALS = {
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("collections", "OrderedDict"),
    ("builtins", "complex"),
}

# what is saved of each part (attribute names)
ESTIMATOR = ("status", "frame_count", "times", "tracks", "slots",
             "intervals", "_pending", "last_imu", "marg_old", "_prior_valid",
             "state", "prior", "td_host", "bg_host", "qic_host", "failures",
             "imu_decimations", "imu_disorder", "_iters_current",
             "_headroom", "_solves", "budget_overruns", "trajectory",
             "last_pose_host", "ex_results", "lps_list", "_lps_fresh")
LIDAR = ("rlb", "tlb", "q_lb", "constraints", "prev", "first_zv", "zv_pose",
         "last_mode", "calib_q_b", "calib_q_l", "calib_t_b", "calib_t_l",
         "calib_w", "mode_counts", "calibrated")
LOCAL = DEVICE_STATE + HOST_STATE + ("trajectory",)
GLOBAL = (("graph",) + STATE_ARRAYS + STATE_LISTS + STATE_COUNTERS
          + ("readbacks", "last_registration"))
SYSTEM = ("lidar_sweep_count", "_pending_sweeps")


class _Pickler(pickle.Pickler):
    """Tensors go out as ("tensor", numpy array)."""

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            return ("tensor", obj.detach().cpu().numpy())
        return None


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, f, device: torch.device):
        super().__init__(f)
        self.device = device

    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS or module.startswith(
                _SAFE_MODULE_PREFIXES):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint contains disallowed global {module}.{name}")

    def persistent_load(self, pid):
        if (not isinstance(pid, tuple) or len(pid) != 2
                or pid[0] != "tensor" or not isinstance(pid[1], np.ndarray)):
            raise pickle.UnpicklingError(
                f"checkpoint contains an unknown persistent id {pid!r}")
        return torch.from_numpy(pid[1]).to(self.device)


def _take(obj, names) -> dict:
    return {n: getattr(obj, n) for n in names}


def _put(obj, values: dict) -> None:
    for n, v in values.items():
        setattr(obj, n, v)


def save_system(system, path: str):
    """Serialize a VilSystem (or bare VIOEstimator) to `path`, after
    draining every deferred readback (the estimator's pack, the LiDAR
    front end's and the local mapper's)."""
    est = getattr(system, "estimator", system)
    if hasattr(system, "estimator"):
        system.flush()
    else:
        if est.lidar is not None:
            est.lidar._harvest_pack()
        est.flush()
    blob = {"estimator": _take(est, ESTIMATOR)}
    if est.lidar is not None:
        blob["lidar"] = _take(est.lidar, LIDAR)
    if getattr(system, "local_mapper", None) is not None:
        blob["local"] = _take(system.local_mapper, LOCAL)
    if getattr(system, "global_mapper", None) is not None:
        blob["global"] = _take(system.global_mapper, GLOBAL)
    if hasattr(system, "lidar_sweep_count"):
        blob["system"] = _take(system, SYSTEM)
        blob["system"]["depth_ring"] = system.depth_register._snap[:3]
    with open(path, "wb") as f:
        _Pickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(blob)


def load_system(system, path: str):
    """Restore state saved by save_system into a freshly constructed
    system of the same configuration, on that system's device."""
    est = getattr(system, "estimator", system)
    with open(path, "rb") as f:
        blob = _RestrictedUnpickler(f, est.device).load()
    _put(est, blob["estimator"])
    if "lidar" in blob:
        est.enable_lidar()
        _put(est.lidar, blob["lidar"])
    if "local" in blob and getattr(system, "local_mapper", None) is not None:
        _put(system.local_mapper, blob["local"])
    if "global" in blob \
            and getattr(system, "global_mapper", None) is not None:
        _put(system.global_mapper, blob["global"])
    if "system" in blob and hasattr(system, "lidar_sweep_count"):
        s = dict(blob["system"])
        system.depth_register._snap = (*s.pop("depth_ring"), None)
        _put(system, s)
    return system
