"""The plain reference of the VIL estimator's window problem, with which
the cell ``vil_odom.feature_replay`` judges a run's window solves
(``feeds/vil.py``) and to which ``tests/test_torch_vil_reference.py``
holds the port's window solve; it imports neither the port nor JAX.

Plain PyTorch, float64 by default, written from the published estimator
(VINS-Mono's ``IntegrationBase``, ``ProjectionTdFactor``, ``IMUFactor``
and ``MarginalizationFactor``, mVIL-Fusion's ``lidar_backend.h``) and
from nothing of the program:

- midpoint IMU preintegration with the bias Jacobians and the covariance
  propagated step by step, each step's transition and noise matrices
  taken by forward-mode AD of the midpoint step in local coordinates;
- inverse-depth reprojection factors with the time-offset velocity
  compensation, whitened by the square-root information focal / 2, under
  a Cauchy loss of scale 1;
- the IMU factor whitened by the inverse of the preintegrated covariance;
- a dense Levenberg-Marquardt solve over every free parameter at once
  (the window's poses, velocities and biases, and the free inverse
  depths) to convergence: no Schur complement, no batching, no graphs.

Taken from the program as given measurements, not re-derived: the
scan-to-scan LiDAR relative-pose rows (each row's four bracketing frames,
interpolation fractions, measured body-frame translation and weight), the
localizer rows (bracket, fraction, measured orientation) and the
marginalization prior (J, r0 and its linearization point).  Their
residuals are evaluated here: the LiDAR and localizer rows as
``lidar_backend.h`` states them, each weighted by the square root of its
Cauchy weight (scale 2.3849), the prior as r0 + J (x ⊟ x0).

Departures from the published estimator, each where the program departs
too, so that both solve one problem:

- the window is re-anchored after the solve: rotated about the vertical
  and translated so that frame 0 keeps its yaw and position from before
  the solve (``double2vector``), without its pitch-singularity branch;
- before a prior exists, frame 0's pose is held by a soft anchor of
  weight 1e3 (the published estimator fixes it);
- the LiDAR and localizer rows are linearized once, at the state the
  solve starts from, their Cauchy weights held there (the published
  estimator re-evaluates them every iteration);
- the zero-velocity rows pin the second-newest frame's pose at its value
  before the solve with weight 1e4 and drive its velocity to zero;
- fixed parameters (the extrinsic and the time offset when they are not
  estimated) are left out of the solve;
- the LM damping starts at 1e-4 and is multiplied by 0.4 on an accepted
  step and by 6 on a rejected one, as the program's; the published
  estimator's solver is Ceres's dogleg, whose optimum is the same.

Quaternions are (w, x, y, z); a pose perturbation is right-multiplied
(q ⊗ exp(δθ)).  The window's state is a dict of tensors: ``p, q, v, ba,
bg`` (W, ·), ``tic, qic, td``, ``inv_depth`` (F,).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

CAUCHY_C = 1.0              # the vision factors' loss scale
LIDAR_CAUCHY_C = 2.3849     # the LiDAR and localizer rows' loss scale
ANCHOR_WEIGHT = 1e3
ZERO_VELOCITY_WEIGHT = 1e4
LPS_SIGMA = 0.01


# ------------------------------------------------------------ quaternions

def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def qconj(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qnorm(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def qrot(q, v):
    """R(q) v, batched (q and v broadcast)."""
    qv, v = torch.broadcast_tensors(q[..., 1:], v)
    t = 2.0 * torch.cross(qv, v, dim=-1)
    return v + q[..., :1] * t + torch.cross(qv, t, dim=-1)


def qrot_inv(q, v):
    return qrot(qconj(q), v)


def qexp(phi):
    """Rotation vector → quaternion; the series near zero keeps the value
    and its forward-mode derivative finite."""
    th2 = (phi * phi).sum(-1, keepdim=True)
    th = torch.sqrt(th2 + 1e-30)
    small = th2 < 1e-10
    w = torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th))
    s = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * th) / th)
    return torch.cat([w, s * phi], -1)


def qlog(q):
    """Quaternion → rotation vector, the angle in [0, π]."""
    q = torch.where(q[..., :1] < 0, -q, q)
    v = q[..., 1:]
    n = torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-30)
    ang = 2.0 * torch.atan2(n, q[..., :1])
    small = n < 1e-8
    return torch.where(small, 2.0 / q[..., :1], ang / n) * v


def qbox_minus(q1, q0):
    return qlog(qmul(qconj(q0), q1))


def qslerp(q0, q1, t):
    d = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = d.abs().clamp(max=1.0 - 1e-12)
    th = torch.acos(d)
    s = torch.sin(th)
    t = t[..., None]
    small = s < 1e-8
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * th) / s)
    w1 = torch.where(small, t, torch.sin(t * th) / s)
    return qnorm(w0 * q0 + w1 * q1)


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def yaw_of(q):
    R = quat_to_mat(q)
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])


def yaw_quat(yaw):
    h = 0.5 * yaw
    z = torch.zeros_like(h)
    return torch.stack([torch.cos(h), z, z, torch.sin(h)], -1)


# -------------------------------------------------------- preintegration

def _step(dp, dq, dv, acc0, gyr0, acc1, gyr1, ba, bg, h, noise):
    """One midpoint step of ``IntegrationBase::midPointIntegration``, the
    noise [na0, ng0, na1, ng1] added to the samples."""
    w = 0.5 * (gyr0 + noise[3:6] + gyr1 + noise[9:12]) - bg
    dq1 = qnorm(qmul(dq, qexp(w * h)))
    a = 0.5 * (qrot(dq, acc0 + noise[0:3] - ba)
               + qrot(dq1, acc1 + noise[6:9] - ba))
    return dp + dv * h + 0.5 * a * h * h, dq1, dv + a * h


def _step_local(x, noise, dp, dq, dv, acc0, gyr0, acc1, gyr1, ba, bg, h):
    """The step in the error state's local coordinates [δp, δθ, δv, δba,
    δbg] around (dp, dq, dv, ba, bg), for its F and V."""
    p1, q1, v1 = _step(dp + x[0:3], qmul(dq, qexp(x[3:6])), dv + x[6:9],
                       acc0, gyr0, acc1, gyr1, ba + x[9:12], bg + x[12:15],
                       h, noise[:12])
    n0, q0, v0 = _step(dp, dq, dv, acc0, gyr0, acc1, gyr1, ba, bg, h,
                       torch.zeros_like(noise[:12]))
    return torch.cat([p1 - n0, qbox_minus(q1, q0), v1 - v0,
                      x[9:12] + noise[12:15] * h,
                      x[12:15] + noise[15:18] * h])


def noise_covariance(acc_n, gyr_n, acc_w, gyr_w, dtype=torch.float64,
                     device=None):
    """diag([na0, ng0, na1, ng1, nba, nbg]²) of the published node."""
    d = []
    for s in (acc_n, gyr_n, acc_n, gyr_n, acc_w, gyr_w):
        d += [s * s] * 3
    return torch.diag(torch.tensor(d, dtype=dtype, device=device))


def preintegrate(acc, gyr, dt, mask, ba, bg, noise_cov):
    """Preintegrate B intervals at once: `acc`, `gyr` (B, N, 3) samples,
    `dt` (B, N) with dt[:, k] from sample k to k+1, `mask` (B, N) with
    trailing padding, `ba`, `bg` (B, 3) the linearization biases.  Returns
    a dict of dp, dq, dv (B, ·), the 15 × 15 Jacobian J and covariance P,
    sum_dt, ba, bg."""
    B, N, _ = acc.shape
    dtype, dev = acc.dtype, acc.device
    dp = acc.new_zeros((B, 3))
    dv = acc.new_zeros((B, 3))
    dq = acc.new_zeros((B, 4))
    dq[:, 0] = 1.0
    J = torch.eye(15, dtype=dtype, device=dev).repeat(B, 1, 1)
    P = acc.new_zeros((B, 15, 15))
    zero_x = acc.new_zeros(15)
    zero_n = acc.new_zeros(18)
    jac = vmap(jacfwd(_step_local, argnums=(0, 1)),
               in_dims=(None, None) + (0,) * 10)
    sum_dt = acc.new_zeros(B)
    steps = mask[:, :-1] & mask[:, 1:]
    last = int(steps.any(0).nonzero().max()) + 1 if bool(steps.any()) else 0
    for k in range(last):
        on = mask[:, k] & mask[:, k + 1]
        h = torch.where(on, dt[:, k], 0.0)
        args = (acc[:, k], gyr[:, k], acc[:, k + 1], gyr[:, k + 1], ba, bg,
                h)
        F, V = jac(zero_x, zero_n, dp, dq, dv, *args)
        p1, q1, v1 = vmap(_step)(dp, dq, dv, *args,
                                 zero_n[None, :12].expand(B, 12))
        m = on[:, None]
        dp, dq, dv = (torch.where(m, p1, dp), torch.where(m, q1, dq),
                      torch.where(m, v1, dv))
        m3 = on[:, None, None]
        J = torch.where(m3, F @ J, J)
        P = torch.where(m3, F @ P @ F.transpose(1, 2)
                        + V @ noise_cov @ V.transpose(1, 2), P)
        sum_dt = sum_dt + h
    return dict(dp=dp, dq=dq, dv=dv, J=J, P=P, sum_dt=sum_dt, ba=ba, bg=bg)


def imu_residual(pre, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j,
                 gravity):
    """The 15-row residual of ``IntegrationBase::evaluate`` (batched over
    intervals), with the first-order bias correction."""
    J = pre["J"]
    dba = (ba_i - pre["ba"])[..., None]
    dbg = (bg_i - pre["bg"])[..., None]
    dp = pre["dp"] + (J[:, 0:3, 9:12] @ dba + J[:, 0:3, 12:15] @ dbg)[..., 0]
    dv = pre["dv"] + (J[:, 6:9, 9:12] @ dba + J[:, 6:9, 12:15] @ dbg)[..., 0]
    dq = qmul(pre["dq"], qexp((J[:, 3:6, 12:15] @ dbg)[..., 0]))
    t = pre["sum_dt"][:, None]
    r_p = qrot_inv(q_i, 0.5 * gravity * t * t + p_j - p_i - v_i * t) - dp
    r_q = 2.0 * qmul(qconj(dq), qmul(qconj(q_i), q_j))[..., 1:]
    r_v = qrot_inv(q_i, gravity * t + v_j - v_i) - dv
    return torch.cat([r_p, r_q, r_v, ba_j - ba_i, bg_j - bg_i], -1)


# ---------------------------------------------------------------- problem

class WindowProblem:
    """One window solve's problem in `dtype` on `device`, from the
    program's tables as numpy (``tables``: the names of the estimator's
    frame tables), its state before the solve (``start``, a dict of
    numpy) and its prior (``prior``: J, r0, x0 as such a dict, valid),
    and the configuration's numbers (``spec``: gravity, the IMU noise,
    focal, whether the extrinsic and td are estimated).  `lidar` False
    leaves the LiDAR rows out (a fault's problem)."""

    def __init__(self, tables, start, prior, spec, device,
                 dtype=torch.float64, lidar=True):
        t = lambda a, d=dtype: torch.as_tensor(a).to(device, d)  # noqa
        self.dtype, self.device = dtype, device
        self.W = W = tables["obs"].shape[1]
        self.F = tables["obs"].shape[0]
        self.start_state = {k: t(v) for k, v in start.items()}
        self.gravity = t([0.0, 0.0, spec["g_norm"]])
        self.focal = float(spec["focal_length"])
        # the features
        self.obs, self.vel = t(tables["obs"]), t(tables["vel"])
        self.td_ref = t(tables["td_ref"])
        self.mask = t(tables["mask"], torch.bool)
        self.start_idx = t(tables["start"], torch.int64)
        self.valid = t(tables["valid"], torch.bool)
        self.depth_fixed = t(tables["depth_fixed"], torch.bool)
        n_obs = self.mask.sum(1)
        self.lam_free = self.valid & ~self.depth_fixed & (n_obs >= 2)
        # IMU, preintegrated at the biases the solve starts from
        noise = noise_covariance(spec["acc_n"], spec["gyr_n"], spec["acc_w"],
                                 spec["gyr_w"], dtype, device)
        s0 = self.start_state
        self.interval_on = t(tables["imu_masks"], torch.bool).any(1)
        self.pre = preintegrate(t(tables["accs"]), t(tables["gyrs"]),
                                t(tables["dts"]),
                                t(tables["imu_masks"], torch.bool),
                                s0["ba"][:-1], s0["bg"][:-1], noise)
        # whitening by L⁻¹ with P = L Lᵀ, so that |L⁻¹ r|² = rᵀ P⁻¹ r
        # (factored in float64 whatever the problem's dtype: no bfloat16
        # factorization exists)
        eye = torch.eye(15, dtype=torch.float64, device=device)
        P = self.pre["P"].double() + 1e-8 * eye
        L = torch.linalg.cholesky(P)
        self.imu_sqrt_info = torch.linalg.solve_triangular(
            L, eye.expand_as(L), upper=False).to(dtype)
        # the given rows
        self.icp = dict(ids=t(tables["icp_ids"], torch.int64),
                        ai=t(tables["icp_ai"]), aj=t(tables["icp_aj"]),
                        tp=t(tables["icp_tp"]), w=t(tables["icp_w"]),
                        on=t(tables["icp_act"], torch.bool) & lidar)
        self.lps = dict(ids=t(tables["lps_ids"], torch.int64),
                        a=t(tables["lps_alpha"]), qm=t(tables["lps_qm"]),
                        on=t(tables["lps_act"], torch.bool) & lidar)
        self.zero_vel = bool(tables["zero_vel"][0]) and lidar
        self.prior_valid = bool(prior["valid"])
        self.prior_J, self.prior_r0 = t(prior["J"]), t(prior["r0"])
        self.prior_x0 = {k: t(v) for k, v in prior["x0"].items()}
        # the free parameters: each frame's 15 local dims, the extrinsic's
        # 6 and td's 1 where estimated, then the free inverse depths
        D = 15 * W + 7
        free = torch.ones(D, dtype=torch.bool)
        if not spec["estimate_extrinsic"]:
            free[15 * W:15 * W + 6] = False
        if not spec["estimate_td"]:
            free[15 * W + 6] = False
        cols = torch.cat([torch.nonzero(free)[:, 0],
                          D + torch.nonzero(self.lam_free.cpu())[:, 0]])
        self.n = len(cols)
        self.select = torch.zeros((D + self.F, self.n), dtype=dtype,
                                  device=device)
        self.select[cols.to(device), torch.arange(self.n, device=device)] = 1
        self.D = D
        self.lidar_r0, self.lidar_J0 = self._linearize_lidar()

    # the state moved by a local step
    def plus(self, s, delta, select=None):
        """s ⊞ δ for δ over the free parameters (n,), or over the columns
        of `select` (D + F, ·) where given."""
        sel = self.select if select is None else select
        return self._plus_full(s, sel @ delta)

    def held_select(self, s):
        """The free parameters with frame 0's position and yaw held, the
        four directions that re-anchoring (`gauge_fix`) sets: frame 0's
        δp left out, and its δθ spanned by the two directions orthogonal
        to the world's vertical in its body frame (R_0ᵀ e_z at `s`), so a
        step turns frame 0 about no vertical axis to first order."""
        z = qrot_inv(s["q"][0], s["p"].new_tensor([0.0, 0.0, 1.0]))
        z = z.to(self.dtype)
        a = torch.zeros_like(z)
        a[int(torch.argmin(z.abs()))] = 1.0
        u1 = torch.linalg.cross(z, a)
        u1 = u1 / torch.linalg.vector_norm(u1)
        u2 = torch.linalg.cross(z, u1)
        keep = self.select[:, (self.select[0:6].abs().sum(0) == 0)]
        rot = self.select.new_zeros((self.select.shape[0], 2))
        rot[3:6, 0], rot[3:6, 1] = u1, u2
        return torch.cat([rot, keep], 1)

    def _plus_full(self, s, full):
        """s ⊞ δ for δ over every parameter (D + F,)."""
        W, D = self.W, self.D
        f = full[:15 * W].reshape(W, 15)
        e = full[15 * W:D]
        return dict(p=s["p"] + f[:, 0:3],
                    q=qnorm(qmul(s["q"], qexp(f[:, 3:6]))),
                    v=s["v"] + f[:, 6:9], ba=s["ba"] + f[:, 9:12],
                    bg=s["bg"] + f[:, 12:15], tic=s["tic"] + e[0:3],
                    qic=qnorm(qmul(s["qic"], qexp(e[3:6]))),
                    td=s["td"] + e[6],
                    inv_depth=s["inv_depth"] + full[D:])

    def _vision(self, s):
        W, F = self.W, self.F
        fi = torch.arange(F, device=self.device)[:, None].expand(F, W)
        j = torch.arange(W, device=self.device)[None, :].expand(F, W)
        i = self.start_idx[:, None].expand(F, W)
        on = (self.valid[:, None] & self.mask[fi, i] & self.mask & (j != i))
        obs_i, vel_i = self.obs[fi, i], self.vel[fi, i]
        pi_ = obs_i - (s["td"] - self.td_ref[fi, i])[..., None] * vel_i
        pj_ = self.obs - (s["td"] - self.td_ref)[..., None] * self.vel
        ray = torch.cat([pi_, torch.ones_like(pi_[..., :1])], -1)
        # an unused slot may hold a zero inverse depth: its rows are masked
        # out, and kept finite so that their derivatives are too
        inv = s["inv_depth"]
        inv = torch.where(inv == 0, torch.ones_like(inv), inv)
        x_c = ray / inv[:, None, None]
        x_b = qrot(s["qic"], x_c) + s["tic"]
        x_w = qrot(s["q"][i], x_b) + s["p"][i]
        x_bj = qrot_inv(s["q"][j], x_w - s["p"][j])
        x_cj = qrot_inv(s["qic"], x_bj - s["tic"])
        z = x_cj[..., 2:3]
        z = torch.where(z.abs() < 1e-6, torch.sign(z) * 1e-6 + 1e-12, z)
        r = (x_cj[..., :2] / z - pj_) * (self.focal / 2.0)
        return torch.where(on[..., None], r, 0.0).reshape(-1, 2), \
            on.reshape(-1)

    def _imu(self, s):
        r = imu_residual(self.pre, s["p"][:-1], s["q"][:-1], s["v"][:-1],
                         s["ba"][:-1], s["bg"][:-1], s["p"][1:], s["q"][1:],
                         s["v"][1:], s["ba"][1:], s["bg"][1:], self.gravity)
        r = (self.imu_sqrt_info @ r[..., None])[..., 0]
        return torch.where(self.interval_on[:, None], r, 0.0).reshape(-1)

    @staticmethod
    def _local_diff(s, x0):
        """s ⊟ x0 over the pose side (D,): each frame's [δp, δθ, δv, δba,
        δbg], then the extrinsic's [δt, δθ] and δtd."""
        frames = torch.cat([s["p"] - x0["p"], qbox_minus(s["q"], x0["q"]),
                            s["v"] - x0["v"], s["ba"] - x0["ba"],
                            s["bg"] - x0["bg"]], -1).reshape(-1)
        return torch.cat([frames, s["tic"] - x0["tic"],
                          qbox_minus(s["qic"], x0["qic"]),
                          (s["td"] - x0["td"])[None]])

    def _prior(self, s):
        return self.prior_r0 + self.prior_J @ self._local_diff(s,
                                                               self.prior_x0)

    def _linearize_lidar(self):
        """The LiDAR and localizer rows at the starting state, each
        weighted by the square root of its Cauchy weight there, and their
        Jacobian over the pose side: (r0 (E,), J0 (E, D))."""
        s0 = self.start_state

        def rows(s):
            out = []
            for r in (self._icp(s), self._lps(s)):
                w = 1.0 / (1.0 + (r * r).sum(-1) / LIDAR_CAUCHY_C ** 2)
                out.append((r * torch.sqrt(w)[:, None]).reshape(-1))
            return torch.cat(out)
        zero = s0["p"].new_zeros(self.D + self.F)
        J0 = jacfwd(lambda d: rows(self._plus_full(s0, d)))(zero)
        # the weights are held: the rows' value and slope at s0
        return rows(s0).detach(), J0[:, :self.D].detach()

    def _lidar(self, s):
        return self.lidar_r0 + self.lidar_J0 @ self._local_diff(
            s, self.start_state)

    def _icp(self, s):
        ids = self.icp["ids"]
        pa, pb, pc, pd = (s["p"][ids[:, k]] for k in range(4))
        qa, qb, qc, qd = (s["q"][ids[:, k]] for k in range(4))
        ai, aj = self.icp["ai"], self.icp["aj"]
        Qi, Qj = qslerp(qa, qb, ai), qslerp(qc, qd, aj)
        Pi = pa + (pb - pa) * ai[:, None]
        Pj = pc + (pd - pc) * aj[:, None]
        res = qrot(qmul(qconj(Qj), Qi), self.icp["tp"] - qrot_inv(Qi,
                                                                  Pj - Pi))
        r = torch.stack([res[:, 0], torch.zeros_like(res[:, 0]),
                         res[:, 2]], -1) * self.icp["w"][:, None]
        return torch.where(self.icp["on"][:, None], r, 0.0)

    def _lps(self, s):
        ids = self.lps["ids"]
        Qi = qslerp(s["q"][ids[:, 0]], s["q"][ids[:, 1]], self.lps["a"])
        r = 2.0 * qmul(qconj(Qi), self.lps["qm"])[:, 1:] / LPS_SIGMA
        return torch.where(self.lps["on"][:, None], r, 0.0)

    def _fixed(self, s):
        """The anchor (before a prior exists) and the zero-velocity rows,
        against the state the solve starts from."""
        s0, W = self.start_state, self.W
        out = []
        if not self.prior_valid:
            out.append(ANCHOR_WEIGHT * torch.cat([
                s["p"][0] - s0["p"][0], qbox_minus(s["q"][0], s0["q"][0])]))
        if self.zero_vel:
            k = W - 2
            out.append(ZERO_VELOCITY_WEIGHT * torch.cat([
                s["p"][k] - s0["p"][k], qbox_minus(s["q"][k], s0["q"][k]),
                s["v"][k]]))
        return torch.cat(out) if out else s["p"].new_zeros(0)

    def blocks(self, s):
        """(plain rows, [(rows (M, k), loss scale)] of the robust blocks)."""
        vis, _ = self._vision(s)
        plain = [self._imu(s), self._fixed(s), self._lidar(s)]
        if self.prior_valid:
            plain.append(self._prior(s))
        return torch.cat(plain), [(vis, CAUCHY_C)]

    def cost(self, s):
        plain, robust = self.blocks(s)
        c = 0.5 * (plain * plain).sum()
        for rows, scale in robust:
            s2 = (rows * rows).sum(-1)
            c = c + 0.5 * scale * scale * torch.log1p(
                s2 / (scale * scale)).sum()
        return c

    def residual(self, s):
        """The stacked rows, each robust block weighted by the square
        root of its Cauchy weight at `s` (IRLS), and those weights."""
        plain, robust = self.blocks(s)
        rows, weights = [plain], []
        for r, scale in robust:
            w = 1.0 / (1.0 + (r * r).sum(-1) / (scale * scale))
            weights.append(w)
            rows.append((r * torch.sqrt(w)[:, None]).reshape(-1))
        return torch.cat(rows), weights

    def _weighted_at(self, s, weights):
        """The rows at `s` with the Cauchy weights held (for the
        Jacobian)."""
        plain, robust = self.blocks(s)
        rows = [plain]
        for (r, _), w in zip(robust, weights):
            rows.append((r * torch.sqrt(w)[:, None]).reshape(-1))
        return torch.cat(rows)

    def gauge_fix(self, s, ref):
        """Rotate about the vertical and translate `s` so that frame 0
        keeps `ref`'s frame-0 yaw and position."""
        dyaw = yaw_of(ref["q"][0]) - yaw_of(s["q"][0])
        qz = yaw_quat(dyaw)
        p = qrot(qz.expand_as(s["q"]), s["p"] - s["p"][0]) + ref["p"][0]
        return dict(s, p=p, q=qnorm(qmul(qz.expand_as(s["q"]), s["q"])),
                    v=qrot(qz.expand_as(s["q"]), s["v"]))

    def solve(self, s, anchor, iters=50, mu0=1e-4, tol=1e-7,
              solve_dtype=None, hold_gauge=False):
        """Levenberg-Marquardt on the whole problem from state `s` (a dict
        of tensors in this problem's dtype), until an accepted step moves
        no window position by `tol` m, the damping saturates, or after
        `iters` iterations; then the re-anchoring to `anchor`'s frame 0.
        Returns (the state, iterations run).  The normal equations are
        factored in `solve_dtype` (default: the problem's dtype; bfloat16
        has no factorization, so its control factors in float32).  With
        `hold_gauge` frame 0's position and yaw are held at `s`'s
        (`held_select`): the prior is not invariant to them, so the
        unheld optimum lies where re-anchoring does not return."""
        sel = self.held_select(s) if hold_gauge else self.select
        zero = s["p"].new_zeros(sel.shape[1])
        sd = solve_dtype or self.dtype
        mu, cost = mu0, self.cost(s)
        H0 = None
        it = 0
        for it in range(1, iters + 1):
            if H0 is None:      # linearized anew after an accepted step
                r, weights = self.residual(s)
                J = jacfwd(lambda d: self._weighted_at(
                    self.plus(s, d, sel), weights))(zero)
                J, r = J.to(sd), r.to(sd)
                H0, g = J.T @ J, -(J.T @ r)
            H = H0 + torch.diag(mu * torch.diagonal(H0) + 1e-12)
            L, info = torch.linalg.cholesky_ex(H)
            if int(info) == 0:
                step = torch.cholesky_solve(g[:, None], L)[:, 0]
                s_try = self.plus(s, step.to(self.dtype), sel)
                c_try = self.cost(s_try)
                if bool(torch.isfinite(c_try)) and float(c_try) < float(cost):
                    moved = float((s_try["p"] - s["p"]).abs().max())
                    s, cost, H0 = s_try, c_try, None
                    mu = max(mu * 0.4, 1e-12)
                    if moved < tol:
                        break
                    continue
            mu = mu * 6.0
            if mu > 1e8:
                break
        return self.gauge_fix(s, anchor), it


def state_from(d, dtype, device):
    """A state dict of numpy arrays (or tensors) as tensors."""
    return {k: torch.as_tensor(v).to(device, dtype) for k, v in d.items()}


def window_move(problem, answer, iters=50, hold_gauge=False, tol=1e-7):
    """How far the reference's LM, started from `answer` (a state dict of
    tensors, re-anchored after its solve) on `problem`, moves any window
    position (m), the re-anchoring keeping the answer's own frame-0 yaw
    and position (with `hold_gauge`, held there through the solve too).
    Returns (the move, the reference's state, its iterations)."""
    ref, it = problem.solve(answer, answer, iters=iters, tol=tol,
                            hold_gauge=hold_gauge)
    d = torch.linalg.vector_norm((ref["p"] - answer["p"]).double(), dim=-1)
    return float(d.max()), ref, it
