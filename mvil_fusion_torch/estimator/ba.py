"""Sliding-window bundle adjustment: batched assembly, Schur-complement
Levenberg-Marquardt, and marginalization.

Counterpart of ``mvil_fusion_tpu/estimator/ba.py``, in place of the
reference's Ceres DENSE_SCHUR+DOGLEG solve (vils_estimator/src/
estimator.cpp optimization() :1124-1687) and its Schur-complement
marginalization prior (factor/marginalization_factor.cpp:251-301).

Structure exploited: landmark inverse depths are scalars, so H_ll is
diagonal and the reduced camera system S = H_pp − H_pl H_ll⁻¹ H_plᵀ is one
dense (D,D) matrix (D = 15·W + 7 = 112 at W = 7), solved by Cholesky.

What differs from the reference's XLA program, by design:

* the LM loop is a Python loop of `iters` steps; the damping, the accept
  flag and the accepted count stay on the device and a rejected step is
  a `torch.where` per field, so nothing waits for the card;
* a failed Cholesky factorization (``cholesky_ex``'s `info` > 0) rejects
  the step, as the NaN factor of ``cho_factor`` does in the reference;
* the trial cost of a step is evaluated by residual-only paths
  (``factors.vision_cost`` and the like), without the Jacobians;
* ``torch.linalg.eigh`` (twice per marginalization) waits for the card
  to check that it converged: the only waits of a solve and slide.
"""

from __future__ import annotations

import functools
from typing import Mapping, NamedTuple

import torch

from mvil_fusion_torch.estimator import factors as fac
from mvil_fusion_torch.estimator import state as st
from mvil_fusion_torch.ops import preintegration as pre
from mvil_fusion_torch.utils.device import resolve_device
from mvil_fusion_torch.utils.precision import full_precision


class Assembled(NamedTuple):
    H_pp: torch.Tensor   # (D,D)
    H_pl: torch.Tensor   # (D,F)
    H_ll: torch.Tensor   # (F,)
    g_p: torch.Tensor    # (D,)  = -Jᵀr
    g_l: torch.Tensor    # (F,)
    cost: torch.Tensor   # ()
    lam_free: torch.Tensor  # (F,) bool — landmarks actually optimized


class BAProblem(NamedTuple):
    """Static-shape problem description consumed by `solve`."""

    feats: st.Features
    preints: pre.Preintegrated      # leading axis (W-1,)
    interval_mask: torch.Tensor     # (W-1,) bool
    prior: fac.Prior
    gravity: torch.Tensor           # (3,)
    anchor_ref: st.WindowState      # gauge anchor (used iff prior invalid)
    # extra dense linearized factors (lidar ICP / LPS / zero-velocity…):
    # r(x) = extra_r + extra_J (x ⊟ extra_x0)
    extra_J: torch.Tensor           # (E, D)
    extra_r: torch.Tensor           # (E,)
    extra_x0: st.WindowState
    # (D,) bool — True freezes that local dim (the reference's
    # SetParameterBlockConstant for extrinsics/td, estimator.cpp:1161-1169)
    fix_mask: torch.Tensor


def problem_from_numpy(arrays, dtype=torch.float32,
                       device: torch.device | str | None = None
                       ) -> BAProblem:
    """A BAProblem from numpy fields (a Mapping or a NamedTuple such as the
    JAX package's problem, its parts likewise), copied onto `device`."""
    dev = resolve_device(device)
    if not isinstance(arrays, Mapping):
        arrays = arrays._asdict()
    up = lambda n, t=dtype: st.from_numpy(arrays[n], t, dev)  # noqa: E731
    return BAProblem(
        feats=st.features_from_numpy(arrays["feats"], dtype, dev),
        preints=pre.preintegrated_from_numpy(arrays["preints"], dtype, dev),
        interval_mask=up("interval_mask", torch.bool),
        prior=fac.prior_from_numpy(arrays["prior"], dtype, dev),
        gravity=up("gravity"),
        anchor_ref=st.window_state_from_numpy(arrays["anchor_ref"], dtype,
                                              dev),
        extra_J=up("extra_J"), extra_r=up("extra_r"),
        extra_x0=st.window_state_from_numpy(arrays["extra_x0"], dtype, dev),
        fix_mask=up("fix_mask", torch.bool))


def empty_extra(w: int, e: int = 0, dtype=torch.float32,
                device: torch.device | str | None = None):
    dev = resolve_device(device)
    D = st.pose_dim(w)
    return (torch.zeros((e, D), dtype=dtype, device=dev),
            torch.zeros((e,), dtype=dtype, device=dev))


def make_fix_mask(w: int, fix_ext: bool = False, fix_td: bool = False,
                  device: torch.device | str | None = None) -> torch.Tensor:
    dev = resolve_device(device)
    m = torch.zeros(st.pose_dim(w), dtype=torch.bool, device=dev)
    if fix_ext:
        m[st.ext_offset(w):st.ext_offset(w) + 6].fill_(True)
    if fix_td:
        m[st.td_offset(w)].fill_(True)
    return m


def _lam_free_mask(f: st.Features) -> torch.Tensor:
    n_obs = torch.sum(f.mask, dim=1)
    return f.valid & (~f.depth_fixed) & (n_obs >= 2)


def _extra_residual(s: st.WindowState, prob: BAProblem) -> torch.Tensor:
    return prob.extra_r + prob.extra_J @ st.state_boxminus(s, prob.extra_x0)


def _landmark_blocks(vs: fac.VisionSystem, F: int, W: int):
    """(H_pl (D,F), H_ll (F,), g_l (F,)) of a vision system."""
    Jg_f = vs.Jg.reshape(F, 2 * W, -1)
    Jl_f = vs.Jl.reshape(F, 2 * W)
    r_f = vs.r.reshape(F, 2 * W)
    H_ll = torch.sum(Jl_f * Jl_f, dim=1)
    H_pl = (Jl_f[:, None, :] @ Jg_f)[:, 0, :].T
    g_l = -torch.sum(Jl_f * r_f, dim=1)
    return H_pl, H_ll, g_l


@full_precision
def assemble(s: st.WindowState, prob: BAProblem, focal: float,
             anchor_weight: float = 1e3) -> Assembled:
    W = s.window
    F = s.num_features
    D = st.pose_dim(W)

    vs = fac.vision_system(s, prob.feats, focal)
    imus = fac.imu_system(s, prob.preints, prob.interval_mask, prob.gravity)
    prs = fac.prior_system(prob.prior, s)
    anc = fac.anchor_system(s, prob.anchor_ref, anchor_weight,
                            ~prob.prior.valid)
    extra_r = _extra_residual(s, prob)

    J = torch.cat([imus.J, prs.J, anc.J, prob.extra_J,
                   vs.Jg.reshape(-1, D)], dim=0)
    r = torch.cat([imus.r, prs.r, anc.r, extra_r, vs.r.reshape(-1)])
    H_pp = J.T @ J
    g_p = -(J.T @ r)

    H_pl, H_ll, g_l = _landmark_blocks(vs, F, W)
    lam_free = _lam_free_mask(prob.feats)
    H_ll = torch.where(lam_free, H_ll, 1.0)
    H_pl = torch.where(lam_free[None, :], H_pl, 0.0)
    g_l = torch.where(lam_free, g_l, 0.0)

    extra_cost = 0.5 * torch.sum(extra_r * extra_r)
    cost = vs.cost + imus.cost + prs.cost + anc.cost + extra_cost
    return Assembled(H_pp, H_pl, H_ll, g_p, g_l, cost, lam_free)


@full_precision
def evaluate_cost(s: st.WindowState, prob: BAProblem, focal: float,
                  anchor_weight: float = 1e3) -> torch.Tensor:
    """Residual-only total robust cost: the same sum as `assemble`'s cost,
    with no Jacobian computed."""
    extra_r = _extra_residual(s, prob)
    return (fac.vision_cost(s, prob.feats, focal)
            + fac.imu_cost(s, prob.preints, prob.interval_mask,
                           prob.gravity)
            + fac.prior_cost(prob.prior, s)
            + fac.anchor_cost(s, prob.anchor_ref, anchor_weight,
                              ~prob.prior.valid)
            + 0.5 * torch.sum(extra_r * extra_r))


class SolveResult(NamedTuple):
    state: st.WindowState
    cost0: torch.Tensor
    cost1: torch.Tensor
    n_accepted: torch.Tensor


def lm_step(a: Assembled, mu: torch.Tensor, fix_mask: torch.Tensor,
            jitter: float = 1e-6):
    """One damped Schur-complement step: (dx (D,), dl (F,), factored ()).

    `factored` is False where the Cholesky factorization of the reduced
    system failed (not positive definite); the step must then be rejected.
    """
    D = a.H_pp.shape[0]
    eye = torch.eye(D, dtype=a.H_pp.dtype, device=a.H_pp.device)
    diag = torch.diagonal(a.H_pp)
    Hd = a.H_pp + torch.diag(mu * diag + jitter)
    inv_ll = 1.0 / (a.H_ll * (1.0 + mu) + jitter)
    S = Hd - (a.H_pl * inv_ll[None, :]) @ a.H_pl.T
    rhs = a.g_p - a.H_pl @ (a.g_l * inv_ll)
    # frozen dims (extrinsics/td when not estimated — the reference's
    # SetParameterBlockConstant): identity row/col, zero rhs → δ = 0
    fm = fix_mask
    S = torch.where(fm[:, None] | fm[None, :], 0.0, S) + torch.diag(
        fm.to(S.dtype))
    rhs = torch.where(fm, 0.0, rhs)
    L, info = torch.linalg.cholesky_ex(S + jitter * eye)
    y = torch.linalg.solve_triangular(L, rhs[:, None], upper=False)
    dx = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    dl = (a.g_l - a.H_pl.T @ dx) * inv_ll
    dl = torch.where(a.lam_free, dl, 0.0)
    return dx, dl, info == 0


@full_precision
def solve(s0: st.WindowState, prob: BAProblem, focal: float,
          iters: int = 8, mu0: float = 1e-4,
          jitter: float = 1e-6) -> SolveResult:
    """Levenberg-Marquardt with landmark Schur complement.

    Fixed iteration count; rejected steps are no-ops via `where`, damping
    adapts multiplicatively — the functional equivalent of the reference's
    ≤8-iteration DOGLEG budget (estimator.cpp:1400-1414).
    """
    s = s0
    mu = torch.full((), mu0, dtype=s0.p.dtype, device=s0.p.device)
    n_acc = torch.zeros((), dtype=torch.int32, device=s0.p.device)
    cost0 = None
    for _ in range(iters):
        a = assemble(s, prob, focal)
        if cost0 is None:
            cost0 = a.cost
        dx, dl, factored = lm_step(a, mu, prob.fix_mask, jitter)
        s_try = st.apply_delta(s, dx, dl)
        cost_try = evaluate_cost(s_try, prob, focal)
        ok = factored & torch.isfinite(cost_try) & (cost_try < a.cost)
        s = st.WindowState(*(torch.where(ok, new, old)
                             for new, old in zip(s_try, s)))
        mu = torch.where(ok, (mu * 0.4).clamp_min(1e-6),
                         (mu * 6.0).clamp_max(1e3))
        n_acc = n_acc + ok.to(torch.int32)
    return SolveResult(state=s, cost0=cost0,
                       cost1=evaluate_cost(s, prob, focal), n_accepted=n_acc)


# ---------------------------------------------------------------------------
# Marginalization
# ---------------------------------------------------------------------------

def _schur_drop_first(A: torch.Tensor, b: torch.Tensor, nd: int,
                      jitter: float = 1e-8):
    """Schur-eliminate the first nd dims of (A, b)."""
    Amm = A[:nd, :nd] + jitter * torch.eye(nd, dtype=A.dtype,
                                           device=A.device)
    Amr = A[:nd, nd:]
    Arr = A[nd:, nd:]
    bm = b[:nd]
    br = b[nd:]
    # symmetric pseudo-solve via eigh (robust to rank deficiency, as the
    # reference does for Amm — marginalization_factor.cpp:274-290)
    w, V = torch.linalg.eigh(Amm)
    w_inv = torch.where(w > 1e-8 * torch.max(w.abs()), 1.0 / w, 0.0)
    Amm_inv = (V * w_inv[None, :]) @ V.T
    A_new = Arr - Amr.T @ Amm_inv @ Amr
    b_new = br - Amr.T @ Amm_inv @ bm
    return A_new, b_new


def _sqrt_factor(A: torch.Tensor, b: torch.Tensor):
    """Eigen-decomposition square root: A = JᵀJ, r0 = J⁻ᵀ b
    (reference: marginalization_factor.cpp:292-301)."""
    w, V = torch.linalg.eigh(A)
    thresh = 1e-8 * torch.max(w.abs()).clamp_min(1e-20)
    keep = w > thresh
    sqrt_w = torch.sqrt(torch.where(keep, w, 0.0))
    inv_sqrt_w = torch.where(keep, 1.0 / sqrt_w.clamp_min(1e-20), 0.0)
    J = sqrt_w[:, None] * V.T
    r0 = (inv_sqrt_w[:, None] * V.T) @ b
    return J, r0


@full_precision
def marginalize_old(s: st.WindowState, prob: BAProblem, focal: float
                    ) -> fac.Prior:
    """Marginalize frame 0 (15 dims) and all landmarks rooted there into a
    new linearized prior, then shift to the post-slide layout.

    Factor set as the reference's slideWindow-old marginalization
    (estimator.cpp:1483-1620): previous prior + IMU factor of interval 0 +
    vision factors whose start frame is 0 + those LiDAR-ICP/LPS extras whose
    interpolation bracket touches frame 0 (the reference's NeedICPmarg /
    NeedLPSmarg handling, :1312-1317, :1345-1352).
    """
    W = s.window
    F = s.num_features
    D = st.pose_dim(W)
    dtype = s.p.dtype

    # vision factors restricted to features rooted at frame 0 (the IRLS
    # weight at the solution is reused)
    feats = prob.feats
    rooted = feats.valid & (feats.start == 0)
    vs = fac.vision_system(s, feats._replace(valid=rooted), focal)
    imus = fac.imu_system(s, prob.preints, fac._range(W - 1, s.p.device) == 0,
                          prob.gravity)
    prs = fac.prior_system(prob.prior, s)

    # extras (linearized rows) that touch frame 0's local dims
    touches0 = torch.any(prob.extra_J[:, :15].abs() > 0, dim=1).to(dtype)
    eJ = prob.extra_J * touches0[:, None]
    er = _extra_residual(s, prob) * touches0

    J = torch.cat([imus.J, prs.J, eJ, vs.Jg.reshape(-1, D)], dim=0)
    r = torch.cat([imus.r, prs.r, er, vs.r.reshape(-1)])
    A_pp = J.T @ J
    b_p = -(J.T @ r)
    A_pl, A_ll, b_l = _landmark_blocks(vs, F, W)

    # eliminate the dropped landmarks first (diagonal Schur); landmarks not
    # rooted at frame 0 have zero blocks here, so eliminating "all" is
    # eliminating exactly the rooted ones
    drop_l = rooted & (~feats.depth_fixed)
    A_ll_safe = torch.where(drop_l & (A_ll > 1e-12), A_ll, 1.0)
    inv_ll = drop_l.to(dtype) / A_ll_safe
    A_pp = A_pp - (A_pl * inv_ll[None, :]) @ A_pl.T
    b_p = b_p - A_pl @ (b_l * inv_ll)

    # eliminate frame 0 pose/speedbias dims (static slice 0:15)
    A_new, b_new = _schur_drop_first(A_pp, b_p, 15)
    J_r, r0_r = _sqrt_factor(A_new, b_new)   # (D-15, D-15)
    # prior residual convention: r(x) = r0 + J dx with b = -Jᵀ r0
    r0_r = -r0_r

    # shift to post-slide layout: old cols 15..D ↔ new cols 0..D-15 for
    # frames, ext/td stay at their (unchanged) offsets
    nk = D - 15
    nf = 15 * (W - 1)           # frame part of the kept block
    J_new = J_r.new_zeros((D, D))
    J_new[:nk, 0:nf] = J_r[:, 0:nf]                       # frames 1..W-1
    J_new[:nk, st.ext_offset(W):D] = J_r[:, nf:]          # ext+td
    r0_new = torch.cat([r0_r, r0_r.new_zeros(15)])
    return fac.Prior(J=J_new, r0=r0_new, x0=shift_state(s),
                     valid=torch.ones((), dtype=torch.bool,
                                      device=s.p.device))


@functools.lru_cache(maxsize=None)
def _second_new_index(w: int, device: torch.device):
    """(idx_keep, perm) of marginalize_second_new, made once per device:
    the 15 dims of frame W-2 first, then the others in order."""
    D = st.pose_dim(w)
    lo, hi = 15 * (w - 2), 15 * (w - 1)
    idx = torch.arange(D, device=device)
    idx_keep = torch.cat([idx[:lo], idx[hi:]])
    return idx_keep, torch.cat([idx[lo:hi], idx_keep])


@full_precision
def marginalize_second_new(s: st.WindowState, prob: BAProblem) -> fac.Prior:
    """Drop the second-newest frame's dims from the prior only
    (reference: MARGIN_SECOND_NEW path, estimator.cpp:1621-1683 — vision
    factors of that frame are discarded, IMU intervals are merged by the
    host window manager).

    The reference drops only the 6 pose dims and asserts the prior has no
    columns on that frame's speed/bias.  The eigh-based square root gives a
    dense prior whose speed/bias columns for frame W-2 are only
    numerically zero, so the full 15 dims are Schur-eliminated — identical
    in exact arithmetic, and no v/ba/bg information of the discarded frame
    is misattributed to the newest frame after `shift_state_second_new`
    overwrites slot W-2.
    """
    W = s.window
    D = st.pose_dim(W)
    prs = fac.prior_system(prob.prior, s)
    A = prs.J.T @ prs.J
    b = -prs.J.T @ prs.r
    idx_keep, perm = _second_new_index(W, s.p.device)
    A_p = A.index_select(0, perm).index_select(1, perm)
    b_p = b.index_select(0, perm)
    A_new, b_new = _schur_drop_first(A_p, b_p, 15)
    J_r, r0_r = _sqrt_factor(A_new, b_new)
    nk = D - 15
    J_new = J_r.new_zeros((D, D))
    J_new[:nk].index_copy_(1, idx_keep, J_r)
    r0_new = torch.cat([-r0_r, r0_r.new_zeros(15)])
    return fac.Prior(J=J_new, r0=r0_new, x0=shift_state_second_new(s),
                     valid=torch.ones((), dtype=torch.bool,
                                      device=s.p.device))


def shift_state(s: st.WindowState) -> st.WindowState:
    """Window shift after marginalize-old: frame k+1 → k, last slot
    duplicated (host overwrites it with the incoming frame)."""
    def sh(x):
        return torch.cat([x[1:], x[-1:]], dim=0)
    return s._replace(p=sh(s.p), q=sh(s.q), v=sh(s.v), ba=sh(s.ba),
                      bg=sh(s.bg))


def shift_state_second_new(s: st.WindowState) -> st.WindowState:
    """After marginalize-second-new: newest frame (W-1) moves to slot W-2."""
    def sh(x):
        return torch.cat([x[:-2], x[-1:], x[-1:]], dim=0)
    return s._replace(p=sh(s.p), q=sh(s.q), v=sh(s.v), ba=sh(s.ba),
                      bg=sh(s.bg))
