"""The port's frame step (``mvil_fusion_torch/estimator/vio.py``) against
the JAX package's ``_frame_step_body`` (through ``vio._frame_step_jit``),
on a window of ``tests/test_ba.py``'s strongly excited trajectory (W = 7,
F = 64, 0.5 px of observation noise) with raw 200 Hz IMU samples in 64
slots an interval, depths to triangulate on a third of the slots, ICP
and LPS constraints from the true poses, and both marginalizations.

Tolerances, through `host_pack` and the new prior: metrics within 1e-3,
the newest frame's position within 1e-3 m, its orientation 1e-3 rad, its
velocity 5e-3 m/s, inverse depths 1e-3 relative, cost1 1e-3 relative;
the new prior in information form (JᵀJ within 1e-3 of its largest entry,
Jᵀr0 within 5e-3 once moved to the port's linearization point, or 2e-2
for a marginalize-old without a previous prior: see
``tests/test_torch_ba.py``), x0 within 1e-3.  With the zero-velocity
rows, frame W-2 stopped by both.  The gauge re-anchor alone and the
extras within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import build_window_problem, make_problem, perturb_state
from mvil_fusion_tpu.estimator import ba as jba
from mvil_fusion_tpu.estimator import factors as jfac
from mvil_fusion_tpu.estimator import lidar_factors as jlf
from mvil_fusion_tpu.estimator import vio as jvio
from mvil_fusion_tpu.io.synthetic import SyntheticTrajectory, SyntheticWorld
from mvil_fusion_tpu.ops import preintegration as jpre
from mvil_fusion_tpu.utils import lie as jlie
from mvil_fusion_torch.estimator import factors as tfac
from mvil_fusion_torch.estimator import lidar_factors as tlf
from mvil_fusion_torch.estimator import state as tst
from mvil_fusion_torch.estimator import vio as tvio
from mvil_fusion_torch.utils import lie as tlie
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

FOCAL = 460.0
W, F, CAP = 7, 64, 64
ITERS = 8
CPU = "cpu"
T = torch.as_tensor


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def imu_buffers(traj, times):
    """The ideal 200 Hz samples of each interval in CAP slots."""
    acc = np.zeros((W - 1, CAP, 3), np.float32)
    gyr = np.zeros((W - 1, CAP, 3), np.float32)
    dts = np.zeros((W - 1, CAP), np.float32)
    mask = np.zeros((W - 1, CAP), bool)
    for k in range(W - 1):
        a, g, d, ts = traj.imu_sequence(times[k], times[k + 1], 200.0)
        n = len(ts)
        acc[k, :n], gyr[k, :n], dts[k, :n], mask[k, :n] = a, g, d, True
    return acc, gyr, dts, mask


def lidar_tables(p, q):
    """ICP (4 of 5 active) and LPS (6 of 7) tables measured from the
    true poses, JAX form."""
    def slerp(a, b, t):
        return np.asarray(jlie.quat_slerp(jnp.asarray(a), jnp.asarray(b), t))
    ids = np.array([[0, 1, 2, 3], [1, 2, 4, 5], [2, 3, 5, 6], [0, 1, 5, 6],
                    [3, 4, 4, 5]], np.int32)
    ai = np.array([0.3, 0.5, 0.7, 0.2, 0.9], np.float32)
    aj = np.array([0.6, 0.1, 0.4, 0.8, 0.5], np.float32)
    trans = []
    for (a, b, c, d), x, y in zip(ids, ai, aj):
        Pi = p[a] + (p[b] - p[a]) * x
        Pj = p[c] + (p[d] - p[c]) * y
        trans.append(np.asarray(jlie.quat_rotate_inv(
            jnp.asarray(slerp(q[a], q[b], x)), jnp.asarray(Pj - Pi))))
    icp = jlf.IcpConstraints(
        ids=jnp.asarray(ids), alpha_i=jnp.asarray(ai), alpha_j=jnp.asarray(aj),
        trans_p=jnp.asarray(np.asarray(trans, np.float32)),
        weight=jnp.full((5,), 20.0, jnp.float32),
        active=jnp.asarray([True] * 4 + [False]))
    lids = np.array([[k, k + 1] for k in range(6)] + [[5, 6]], np.int32)
    la = np.linspace(0.1, 0.9, 7).astype(np.float32)
    qm = np.stack([slerp(q[a], q[b], t)
                   for (a, b), t in zip(lids, la)]).astype(np.float32)
    lps = jlf.LpsConstraints(ids=jnp.asarray(lids), alpha=jnp.asarray(la),
                             q_meas=jnp.asarray(qm),
                             active=jnp.asarray([True] * 6 + [False]))
    return icp, lps


@pytest.fixture(scope="module")
def step_inputs():
    """The frame step's arguments in JAX form, without prior and zero_vel,
    and the true window."""
    world = SyntheticWorld(
        traj=SyntheticTrajectory(duration=8.0, w_amp=(0.9, 0.8, 1.0),
                                 w_freq=(0.5, 0.4, 0.6)),
        landmark_radius=8.0)
    s_true, feats, _, _, times = build_window_problem(
        world, t0=1.0, noise_px=0.5, rng=np.random.default_rng(11))
    s0 = perturb_state(s_true, np.random.default_rng(8), dp=0.02, dth=0.01,
                       dv=0.02)
    need = np.zeros(F, bool)
    need[::3] = True
    icp, lps = lidar_tables(np.asarray(s_true.p), np.asarray(s_true.q))
    # the prior of the window one frame earlier, frame 0 marginalized at
    # the truth
    prev = build_window_problem(world, t0=0.9)
    prior = jax.jit(jba.marginalize_old, static_argnums=2)(
        prev[0], make_problem(*prev[:4]), FOCAL)
    args = dict(state=s0, feats=feats, need_depth=jnp.asarray(need),
                imu=tuple(jnp.asarray(a) for a in
                          imu_buffers(world.traj, times)),
                gravity=jnp.asarray([0.0, 0.0, 9.795], jnp.float32),
                noise_cov=jpre.noise_covariance(0.02065, 0.00519, 0.00667,
                                                0.00088056),
                icp=icp, lps=lps,
                fix_mask=jba.make_fix_mask(W, fix_ext=True, fix_td=True))
    return args, s_true, prior


def run_jax(a, prior, zero_vel, marg_old):
    return jvio._frame_step_jit(
        a["state"], a["feats"], a["need_depth"], *a["imu"], prior,
        a["gravity"], a["noise_cov"], a["icp"], a["lps"],
        jnp.asarray(zero_vel), a["fix_mask"], focal=FOCAL, iters=ITERS,
        marg_old=marg_old)


def run_port(a, prior, zero_vel, marg_old):
    up = lambda x: T(np.array(x))  # noqa: E731
    return tvio.frame_step(
        tst.window_state_from_numpy(as_np(a["state"]), device=CPU),
        tst.features_from_numpy(as_np(a["feats"]), device=CPU),
        up(a["need_depth"]), *(up(x) for x in a["imu"]),
        tfac.prior_from_numpy(as_np(prior), device=CPU), up(a["gravity"]),
        up(a["noise_cov"]), tlf.icp_from_numpy(as_np(a["icp"]), device=CPU),
        tlf.lps_from_numpy(as_np(a["lps"]), device=CPU), zero_vel,
        up(a["fix_mask"]), FOCAL, ITERS, marg_old)


def information(prior):
    J = np.asarray(prior.J, np.float64)
    return J.T @ J, J.T @ np.asarray(prior.r0, np.float64)


@pytest.mark.parametrize("marg_old,with_prior", [
    (True, False), (False, True), (True, True)])
def test_frame_step_matches_reference(step_inputs, marg_old, with_prior):
    a, s_true, prior = step_inputs
    if not with_prior:
        prior = jfac.empty_prior(W, F)
    out_j = run_jax(a, prior, False, marg_old)
    out_t = run_port(a, prior, False, marg_old)
    assert len(out_t) == 5
    hj = np.asarray(out_j[4])
    ht = tvio.read_host_pack(out_t[4])
    assert ht.shape == hj.shape == (tvio.HOST_PACK_HEAD + F,)
    assert np.isfinite(ht).all() and ht[4] == 1.0
    x = 1.0
    np.testing.assert_allclose(ht[0:5], hj[0:5], rtol=0, atol=1e-3 * x)
    assert rel_err(ht[5], hj[5]) < 1e-3 * x                  # cost1
    np.testing.assert_allclose(ht[6:9], hj[6:9], rtol=0, atol=1e-3 * x)
    ang = tlie.quat_boxminus(T(ht[9:13]), T(hj[9:13])).norm()
    assert float(ang) < 1e-3 * x
    np.testing.assert_allclose(ht[13:16], hj[13:16], rtol=0, atol=5e-3 * x)
    np.testing.assert_allclose(ht[16:27], hj[16:27], rtol=0, atol=1e-3 * x)
    np.testing.assert_allclose(ht[27:], hj[27:], rtol=1e-3 * x)
    # the other results agree with the pack
    np.testing.assert_array_equal(ht[:5], out_t[2].numpy())
    np.testing.assert_array_equal(ht[5], out_t[3].numpy())
    np.testing.assert_array_equal(ht[6:9], out_t[0].p[-1].numpy())

    # each package linearizes its new prior at its own solved state, and
    # the two differ by δ (up to 4e-5): the same Gaussian has Jᵀr0 moved by
    # JᵀJ δ, and what that first-order shift leaves is up to 2e-3 (without
    # it, 1.6e-2)
    Ht, bt = information(as_np(out_t[1]))
    Hj, bj = information(out_j[1])
    delta = tst.state_boxminus(out_t[1].x0, tst.window_state_from_numpy(
        as_np(out_j[1].x0), device=CPU)).double().numpy()
    assert rel_err(Ht, Hj) < 1e-3 * x
    assert rel_err(bt, bj + Hj @ delta) < (
        2e-2 if marg_old and not with_prior else 5e-3) * x
    for u, v in zip(out_t[1].x0, out_j[1].x0):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=0,
                                   atol=1e-3 * x)
    assert np.abs(out_t[0].p.numpy() - np.asarray(s_true.p)).max() < 0.02


def test_zero_velocity_rows_stop_frame_w_minus_2(step_inputs):
    """The zero-velocity rows (weight 1e4) on this moving window: both
    packages stop frame W-2 (|v| below 5e-3 m/s).  The rest of the window
    is pulled off the truth (the newest accel bias takes ~3 m/s², frame
    W-2 moves 0.88 m against frame 0, some inverse depths turn negative),
    so the two are held only to the same displacement of frame W-2
    against frame 0, within 5e-3 m."""
    a, _, prior = step_inputs
    k = W - 2
    s_in = as_np(a["state"])
    moved = []
    for out in (run_jax(a, prior, True, True), run_port(a, prior, True, True)):
        s_new = as_np(out[0])
        assert np.abs(s_new.v[k]).max() < 5e-3
        moved.append((s_new.p[k] - s_new.p[0]) - (s_in.p[k] - s_in.p[0]))
    np.testing.assert_allclose(moved[1], moved[0], rtol=0, atol=5e-3)


def test_frame_step_triangulates_only_where_asked(step_inputs):
    """Slots not asked for keep their depth into the solve, so a step
    with no depth asked for starts from the state's inverse depths."""
    a, _, _ = step_inputs
    a = dict(a, need_depth=jnp.zeros(F, bool))
    prior = jfac.empty_prior(W, F)
    out_j = run_jax(a, prior, False, True)
    out_t = run_port(a, prior, False, True)
    np.testing.assert_allclose(out_t[4].numpy()[27:],
                               np.asarray(out_j[4])[27:], rtol=1e-3)


@pytest.mark.parametrize("pitch_deg", [10.0, 89.5])
def test_gauge_fix_matches_reference(step_inputs, pitch_deg):
    """Both branches: a yaw rotation, and the whole rotation of frame 0
    where its pitch is beyond 89° (the reference's singular point)."""
    a, s_true, _ = step_inputs
    s_old = s_true._replace(q=s_true.q.at[0].set(jlie.mat_to_quat(
        jlie.ypr_to_mat(jnp.deg2rad(jnp.asarray([30.0, pitch_deg, 5.0]))))))
    s_new = a["state"]
    gj = jvio._gauge_fix(s_old, s_new)
    gt = tvio._gauge_fix(tst.window_state_from_numpy(as_np(s_old), device=CPU),
                         tst.window_state_from_numpy(as_np(s_new), device=CPU))
    for x, y in zip(gt, gj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(gt.p[0].numpy(), np.asarray(s_old.p[0]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("zero_vel", [True, False])
def test_extras_match_reference(step_inputs, zero_vel):
    a, _, _ = step_inputs
    Jj, rj = jax.jit(jvio._extras_body)(a["state"], a["icp"], a["lps"],
                               jnp.asarray(zero_vel))
    Jt, rt = tvio._extras_body(
        tst.window_state_from_numpy(as_np(a["state"]), device=CPU),
        tlf.icp_from_numpy(as_np(a["icp"]), device=CPU),
        tlf.lps_from_numpy(as_np(a["lps"]), device=CPU), zero_vel)
    assert Jt.shape == (3 * tlf.MAX_ICP + 3 * tlf.MAX_LPS + 9, 15 * W + 7)
    assert rel_err(Jt.numpy(), Jj) < 1e-6
    assert rel_err(rt.numpy(), rj) < 1e-5
