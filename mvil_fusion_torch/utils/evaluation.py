"""Trajectory evaluation: TUM-format I/O, alignment, ATE / RPE.

Counterpart of ``mvil_fusion_tpu/utils/evaluation.py``, a numpy copy.

The reference validates by writing Frontend/Midend/Backend.txt and
comparing offline (e.g. with `evo`; reference SURVEY.md §4).  This module
is that offline comparison, built in: association by timestamp, SE(3)
Umeyama or 4-DoF (yaw+translation, the mono-VIO gauge) alignment, and
ATE-RMSE / RPE metrics, so the runner CLI can emit a number instead of a
plot.
"""

from __future__ import annotations

import numpy as np


def load_tum(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a TUM trajectory file → (t (N,), p (N,3), q_wxyz (N,4))."""
    ts, ps, qs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            if len(v) < 8:
                continue
            ts.append(v[0])
            ps.append(v[1:4])
            qs.append([v[7], v[4], v[5], v[6]])   # file is qx qy qz qw
    return (np.asarray(ts), np.asarray(ps), np.asarray(qs))


def save_tum(path: str, rows) -> None:
    """rows: iterable of (t, p (3,), q_wxyz (4,))."""
    with open(path, "w") as f:
        for t, p, q in rows:
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def associate(t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.05
              ) -> tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association (indices into a and b)."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(t_a):
        j = int(np.argmin(np.abs(t_b - t)))
        if abs(t_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def umeyama_se3(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment src→dst (Umeyama 1991).
    Returns (s, R, t) with dst ≈ s·R·src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    cs = src - mu_s
    cd = dst - mu_d
    cov = cd.T @ cs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (cs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def align_4dof(src: np.ndarray, dst: np.ndarray):
    """Yaw + translation alignment (gravity-aligned mono-VIO gauge)."""
    cs = src - src.mean(0)
    cd = dst - dst.mean(0)
    num = np.sum(cd[:, 0] * cs[:, 1] - cd[:, 1] * cs[:, 0])
    den = np.sum(cd[:, 0] * cs[:, 0] + cd[:, 1] * cs[:, 1])
    yaw = np.arctan2(num, den)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.asarray([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    t = dst.mean(0) - R @ src.mean(0)
    return R, t


def ate_rmse(t_est, p_est, t_gt, p_gt, mode: str = "4dof",
             max_dt: float = 0.05) -> float:
    """Absolute trajectory error RMSE after alignment.

    mode: '4dof' (yaw+trans), 'se3', or 'sim3' (adds scale)."""
    ia, ib = associate(t_est, t_gt, max_dt)
    if len(ia) < 3:
        return float("inf")
    src = p_est[ia]
    dst = p_gt[ib]
    if mode == "4dof":
        R, t = align_4dof(src, dst)
        src_al = src @ R.T + t
    else:
        s, R, t = umeyama_se3(src, dst, with_scale=(mode == "sim3"))
        src_al = s * src @ R.T + t
    err = np.linalg.norm(src_al - dst, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def rpe_rmse(t_est, p_est, t_gt, p_gt, delta: float = 1.0,
             max_dt: float = 0.05) -> float:
    """Relative pose (translation) error RMSE over `delta`-second hops —
    drift rate, alignment-free."""
    ia, ib = associate(t_est, t_gt, max_dt)
    if len(ia) < 3:
        return float("inf")
    te, pe = t_est[ia], p_est[ia]
    pg = p_gt[ib]
    errs = []
    for i in range(len(te)):
        j = int(np.searchsorted(te, te[i] + delta))
        if j >= len(te):
            break
        de = np.linalg.norm(pe[j] - pe[i])
        dg = np.linalg.norm(pg[j] - pg[i])
        errs.append(de - dg)
    if not errs:
        return float("inf")
    return float(np.sqrt(np.mean(np.asarray(errs) ** 2)))
