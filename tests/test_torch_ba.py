"""The port's window bundle adjustment (``mvil_fusion_torch/estimator/ba.py``)
against the JAX package's, on the window of ``tests/test_ba.py``'s
strongly excited trajectory (W = 7, F = 64), with 0.5 px of observation
noise where two solves are compared, LiDAR ICP rows as extras, and a
prior from a marginalization.

Tolerances.  `assemble`: H_pp, g_p, H_pl, H_ll, g_l within 1e-4 of their
largest entry, cost within 1e-5 relative.  One LM step's (dx, dl) within
1e-4 of its largest entry at a damping of 0.1 (within 5e-3 at the
solver's damping of 1e-4: see the test); a system that is not positive
definite is rejected by both.  `solve`, 8 iterations from a perturbed
state: positions within 1e-3 m, angles 1e-3 rad, velocities 5e-3 m/s,
inverse depths 1e-3 relative, cost1 1e-3 relative, the same accepted
count.
Marginalization in information form (JᵀJ and Jᵀr0, which do not depend
on the eigenvectors' signs and rotations) within 1e-3 of the largest
entry (Jᵀr0 within 2e-2 without a previous prior, see the test), x0
within 1e-5, and the prior's columns zero where the reference's are.
The prior is taken at a perturbed state: at a solved one Jᵀr0 is a
difference of terms 10⁴ times larger, and fp32 leaves both packages 15 %
from float64 there.  Where the two packages are held looser than 1e-4
(a step) or 1e-3 (a prior), the test says how far each is from float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import build_window_problem, make_problem, perturb_state
from mvil_fusion_tpu.estimator import ba as jba
from mvil_fusion_tpu.estimator import lidar_factors as jlf
from mvil_fusion_tpu.io.synthetic import SyntheticTrajectory, SyntheticWorld
from mvil_fusion_tpu.utils import lie as jlie
from mvil_fusion_torch.estimator import ba as tba
from mvil_fusion_torch.estimator import state as tst
from mvil_fusion_torch.utils import lie as tlie
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

FOCAL = 460.0
W = 7
CPU = "cpu"

_jassemble = jax.jit(jba.assemble, static_argnums=2)
_jcost = jax.jit(jba.evaluate_cost, static_argnums=2)
_jstep = jax.jit(lambda s, prob, mu0: jba.solve(s, prob, FOCAL, iters=1,
                                                 mu0=mu0))
_jsolve = jax.jit(lambda s, prob: jba.solve(s, prob, FOCAL, iters=8))
_jmarg_old = jax.jit(jba.marginalize_old, static_argnums=2)
_jmarg_new = jax.jit(jba.marginalize_second_new)


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def icp_extras(s_true, s_lin):
    """ICP rows (JAX form) linearized at s_lin, measured from the truth;
    the first constraint brackets frame 0."""
    p, q = np.asarray(s_true.p), np.asarray(s_true.q)
    ids = np.array([[0, 1, 2, 3], [1, 2, 4, 5], [2, 3, 5, 6], [0, 0, 0, 0],
                    [0, 0, 0, 0]], np.int32)
    ai = np.array([0.3, 0.5, 0.7, 0.0, 0.0], np.float32)
    aj = np.array([0.6, 0.1, 0.4, 0.0, 0.0], np.float32)
    trans = np.zeros((5, 3), np.float32)
    for c in range(3):
        a, b, cc, d = ids[c]
        Qi = jlie.quat_slerp(jnp.asarray(q[a]), jnp.asarray(q[b]), ai[c])
        Pi = p[a] + (p[b] - p[a]) * ai[c]
        Pj = p[cc] + (p[d] - p[cc]) * aj[c]
        trans[c] = np.asarray(jlie.quat_rotate_inv(Qi, jnp.asarray(Pj - Pi)))
    tab = jlf.IcpConstraints(
        ids=jnp.asarray(ids), alpha_i=jnp.asarray(ai), alpha_j=jnp.asarray(aj),
        trans_p=jnp.asarray(trans), weight=jnp.full((5,), 20.0, jnp.float32),
        active=jnp.asarray([True, True, True, False, False]))
    return jax.jit(jlf.icp_system)(s_lin, tab)


@pytest.fixture(scope="module")
def win():
    world = SyntheticWorld(
        traj=SyntheticTrajectory(duration=8.0, w_amp=(0.9, 0.8, 1.0),
                                 w_freq=(0.5, 0.4, 0.6)),
        landmark_radius=8.0)
    exact = build_window_problem(world)
    s_true, times = exact[0], exact[4]
    prob_exact = make_problem(*exact[:4], n_extra=15)
    # every case has 15 extra rows (zero where there are none), so that
    # each JAX function compiles once
    noise = dict(noise_px=0.5, rng=np.random.default_rng(11))
    prob = make_problem(*build_window_problem(world, **noise)[:4],
                        n_extra=15)
    s0 = perturb_state(s_true, np.random.default_rng(3))
    eJ, er = icp_extras(s_true, s0)
    # extrinsic and td held, as with estimate_extrinsic 0
    prob_x = prob._replace(extra_J=eJ, extra_r=er, extra_x0=s0,
                           fix_mask=jba.make_fix_mask(W, True, True))
    # the window one frame later, with the prior of the first one's frame 0
    # marginalized at the truth (anchor off)
    nxt = build_window_problem(world, t0=times[1], **noise)
    prob_p = make_problem(*nxt[:4], n_extra=15)._replace(
        prior=_jmarg_old(s_true, prob_exact, FOCAL))
    s0_p = perturb_state(nxt[0], np.random.default_rng(5), dp=0.02,
                         dth=0.01, dv=0.02, keep_first=False)
    return dict(world=world, s_true=s_true, times=times,
                prob_exact=prob_exact,
                cases=dict(prob=(s0, prob), prob_x=(s0, prob_x),
                           prob_p=(s0_p, prob_p)))


def tstate(s):
    return tst.window_state_from_numpy(as_np(s), device=CPU)


def tprob(prob):
    return tba.problem_from_numpy(as_np(prob), device=CPU)


@pytest.mark.parametrize("which", ["prob", "prob_x", "prob_p"])
def test_assemble_matches_reference(win, which):
    """Without a prior (anchor on), with ICP extras, with a prior (anchor
    off)."""
    s0, prob = win["cases"][which]
    aj = _jassemble(s0, prob, FOCAL)
    at = tba.assemble(tstate(s0), tprob(prob), FOCAL)
    for name in ("H_pp", "g_p", "H_pl", "H_ll", "g_l"):
        assert rel_err(getattr(at, name).numpy(), getattr(aj, name)) < 1e-4, \
            name
    assert rel_err(at.cost.numpy(), aj.cost) < 1e-5
    np.testing.assert_array_equal(at.lam_free.numpy(), np.asarray(aj.lam_free))
    # the residual-only cost is the same sum
    ct = tba.evaluate_cost(tstate(s0), tprob(prob), FOCAL)
    assert rel_err(ct.numpy(), at.cost.numpy()) < 1e-6
    assert rel_err(ct.numpy(), _jcost(s0, prob, FOCAL)) < 1e-5


def step_delta(s1, s0):
    """(dx, dl) that took s0 to s1."""
    return (tst.state_boxminus(s1, s0).numpy(),
            (s1.inv_depth - s0.inv_depth).numpy())


@pytest.mark.parametrize("which", ["prob_x", "prob_p"])
@pytest.mark.parametrize("mu0,tol", [(1e-1, 1e-4), (1e-4, 5e-3)])
def test_one_lm_step_matches_reference(win, which, mu0, tol):
    """At the solver's own damping (1e-4) the step is held within 5e-3:
    there each package's fp32 step is 4e-4 to 2e-3 from a float64 one (the
    weak velocity/accel-bias mode; the amount moves with the summation
    order, one thread or four), so the two differ by up to twice that.
    At 1e-2 both are within 7e-5 of it, at 1e-1 closer still."""
    s0j, prob = win["cases"][which]
    rj = _jstep(s0j, prob, mu0)
    s0 = tstate(s0j)
    rt = tba.solve(s0, tprob(prob), FOCAL, iters=1, mu0=mu0)
    assert int(rj.n_accepted) == int(rt.n_accepted) == 1
    dx_j, dl_j = step_delta(tstate(rj.state), s0)
    dx_t, dl_t = step_delta(rt.state, s0)
    assert np.abs(dx_j).max() > 1e-2
    assert rel_err(dx_t, dx_j) < tol
    assert rel_err(dl_t, dl_j) < tol
    assert rel_err(rt.cost0.numpy(), rj.cost0) < 1e-5
    # lm_step alone gives the same step
    a = tba.assemble(s0, tprob(prob), FOCAL)
    dx, dl, ok = tba.lm_step(a, torch.tensor(mu0), tprob(prob).fix_mask)
    assert bool(ok)
    assert rel_err(dx.numpy(), dx_t) < 1e-4


def test_system_that_is_not_positive_definite_is_rejected(win):
    """A negative damping (mu0 = -3) makes the reduced system indefinite:
    the reference's Cholesky returns NaN and rejects the step, the port's
    reports info > 0 and rejects it too."""
    s0j, prob = win["cases"]["prob_x"]
    rj = _jstep(s0j, prob, -3.0)
    s0 = tstate(s0j)
    rt = tba.solve(s0, tprob(prob), FOCAL, iters=1, mu0=-3.0)
    assert int(rj.n_accepted) == int(rt.n_accepted) == 0
    for a, b in zip(rt.state, s0):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    a = tba.assemble(s0, tprob(prob), FOCAL)
    _, _, ok = tba.lm_step(a, torch.tensor(-3.0), a.lam_free.new_zeros(
        a.H_pp.shape[0]))
    assert not bool(ok)


def pose_errors(st_a, st_b):
    """(max position, max angle, max velocity, max relative inverse depth)
    differences of two port states."""
    ang = tlie.quat_boxminus(st_a.q, st_b.q).norm(dim=-1).max()
    return (float((st_a.p - st_b.p).abs().max()), float(ang),
            float((st_a.v - st_b.v).abs().max()),
            float(((st_a.inv_depth - st_b.inv_depth).abs()
                   / st_b.inv_depth.abs()).max()))


@pytest.mark.parametrize("which", ["prob_x", "prob_p"])
def test_solve_matches_reference(win, which):
    s0, prob = win["cases"][which]
    rj = _jsolve(s0, prob)
    rt = tba.solve(tstate(s0), tprob(prob), FOCAL, iters=8)
    dp, dth, dv, dlam = pose_errors(rt.state, tstate(rj.state))
    assert dp < 1e-3 and dth < 1e-3 and dv < 5e-3 and dlam < 1e-3, \
        (dp, dth, dv, dlam)
    assert rel_err(rt.cost1.numpy(), rj.cost1) < 1e-3
    assert rel_err(rt.cost0.numpy(), rj.cost0) < 1e-5
    assert int(rt.n_accepted) == int(rj.n_accepted)
    assert float(rt.cost1) < 1e-2 * float(rt.cost0)


def test_fixed_extrinsic_and_td_stay_put(win):
    s0, prob = win["cases"]["prob_x"]
    np.testing.assert_array_equal(
        tba.make_fix_mask(W, True, True, device=CPU).numpy(),
        np.asarray(prob.fix_mask))
    s0 = s0._replace(tic=jnp.asarray([0.01, 0.0, -0.01], jnp.float32),
                            td=jnp.asarray(0.002, jnp.float32))
    rj = _jsolve(s0, prob)
    rt = tba.solve(tstate(s0), tprob(prob), FOCAL, iters=8)
    for name in ("tic", "qic", "td"):
        np.testing.assert_array_equal(getattr(rt.state, name).numpy(),
                                      np.asarray(getattr(s0, name)))
    dp, dth, dv, _ = pose_errors(rt.state, tstate(rj.state))
    assert dp < 1e-3 and dth < 1e-3 and dv < 5e-3


def test_fixed_depths_stay_put(win):
    s0, prob = win["cases"]["prob"]
    fixed = np.zeros(prob.feats.start.shape[0], bool)
    fixed[:8] = True
    prob = prob._replace(feats=prob.feats._replace(
        depth_fixed=jnp.asarray(fixed)))
    s0 = tstate(s0)
    rt = tba.solve(s0, tprob(prob), FOCAL, iters=4)
    np.testing.assert_array_equal(rt.state.inv_depth[:8].numpy(),
                                  s0.inv_depth[:8].numpy())
    assert (rt.state.inv_depth[8:] != s0.inv_depth[8:]).any()


def test_solve_recovers_truth(win):
    """`tests/test_ba.py::test_solve_recovers_truth`'s gates on the port."""
    s0 = tstate(perturb_state(win["s_true"], np.random.default_rng(3)))
    prob = tprob(win["prob_exact"])
    c0 = float(tba.evaluate_cost(s0, prob, FOCAL))
    res = tba.solve(s0, prob, FOCAL, iters=20)
    assert float(res.cost1) < 1e-2 * c0
    dp, dth, dv, _ = pose_errors(res.state, tstate(win["s_true"]))
    assert dp < 0.02 and dth < 0.01 and dv < 0.05, (dp, dth, dv)


def information(prior):
    J = np.asarray(prior.J, np.float64)
    return J.T @ J, J.T @ np.asarray(prior.r0, np.float64)


def check_prior(pt, pj, s_shifted, b_tol=1e-3):
    Ht, bt = information(as_np(pt))
    Hj, bj = information(pj)
    assert rel_err(Ht, Hj) < 1e-3
    assert rel_err(bt, bj) < b_tol
    zero_j = np.abs(np.asarray(pj.J)).max(axis=0) == 0
    assert zero_j.sum() >= 15
    np.testing.assert_array_equal(pt.J.numpy()[:, zero_j], 0.0)
    np.testing.assert_array_equal(pt.r0.numpy()[-15:], 0.0)
    assert bool(pt.valid)
    for a, b in zip(pt.x0, s_shifted):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("which,b_tol", [("prob", 2e-2), ("prob_x", 2e-2),
                                         ("prob_p", 1e-3)])
def test_marginalize_old_matches_reference(win, which, b_tol):
    """Without a previous prior among the factors, Jᵀr0 of the noisy window
    is 3e-3 to 6e-3 (port) and 5e-3 to 9e-3 (reference) of its largest
    entry from a float64 marginalization of the same inputs, also on the
    well-determined eigenspace of JᵀJ (the landmark Schur complement
    cancels): held within 2e-2 there, within 1e-3 with a prior."""
    s0, prob = win["cases"][which]
    pj = _jmarg_old(s0, prob, FOCAL)
    pt = tba.marginalize_old(tstate(s0), tprob(prob), FOCAL)
    check_prior(pt, pj, jba.shift_state(s0), b_tol)
    # the slid newest slot carries no information
    assert np.abs(pt.J.numpy()[:, 15 * (W - 1):15 * W]).max() == 0


def test_marginalize_second_new_matches_reference(win):
    s0, prob = win["cases"]["prob_p"]
    pj = _jmarg_new(s0, prob)
    pt = tba.marginalize_second_new(tstate(s0), tprob(prob))
    check_prior(pt, pj, jba.shift_state_second_new(s0))
    k = W - 2
    assert np.abs(pt.J.numpy()[:, 15 * k:15 * k + 15]).max() == 0


def test_shift_states_match_reference(win):
    s0 = win["cases"]["prob"][0]
    s = tstate(s0)
    for tf, jf in ((tba.shift_state, jba.shift_state),
                   (tba.shift_state_second_new, jba.shift_state_second_new)):
        for a, b in zip(tf(s), jf(s0)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_marginalize_old_then_solve_stays_at_truth(win):
    """`tests/test_ba.py`'s slide: marginalize frame 0, rebuild the window
    one frame later with the new prior (anchor off), solve again."""
    rng = np.random.default_rng(8)
    prob = tprob(win["prob_exact"])
    res = tba.solve(tstate(perturb_state(win["s_true"], rng)), prob, FOCAL,
                    iters=10)
    prior = tba.marginalize_old(res.state, prob, FOCAL)
    s_true2, feats2, preints2, imask2, _ = build_window_problem(
        win["world"], t0=win["times"][1])
    prob2 = tprob(make_problem(s_true2, feats2, preints2,
                               imask2))._replace(prior=prior)
    s0 = tstate(perturb_state(s_true2, rng, dp=0.02, dth=0.01, dv=0.02,
                              keep_first=False))
    res2 = tba.solve(s0, prob2, FOCAL, iters=10)
    assert float((res2.state.p - tstate(s_true2).p).abs().max()) < 0.05
