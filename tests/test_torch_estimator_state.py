"""The port's window state, factors and LiDAR factors
(``mvil_fusion_torch/estimator/{state,factors,lidar_factors}.py``) against
the JAX package's, on the window of ``tests/test_ba.py``'s strongly
excited trajectory (W = 7, F = 64), perturbed, with LiDAR constraints
taken from the true poses.

Tolerances.  `apply_delta`, `state_boxminus` and `gauge_fix` within 1e-6.
Residuals (vision, IMU, prior, anchor, ICP, LPS, zero velocity) within
1e-5 of their largest entry, with identical active masks (the vision rows
before their Cauchy weight, which bounds the weighted rows by 1 px, below
fp32's rounding of a 230 px whitening; the weights within 2e-5); costs
within 1e-5 relative.  Jacobians (`Jg`, `Jl` and the dense rows) within 1e-4 of
their largest entry, and within 1e-6 of central finite differences of
the port's own residuals in float64 (step 1e-6 on the packed state).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import build_window_problem, perturb_state
from mvil_fusion_tpu.estimator import factors as jfac
from mvil_fusion_tpu.estimator import lidar_factors as jlf
from mvil_fusion_tpu.estimator import state as jst
from mvil_fusion_tpu.io.synthetic import SyntheticTrajectory, SyntheticWorld
from mvil_fusion_tpu.utils import lie as jlie
from mvil_fusion_torch.estimator import factors as tfac
from mvil_fusion_torch.estimator import lidar_factors as tlf
from mvil_fusion_torch.estimator import state as tst
from mvil_fusion_torch.ops import preintegration as tpre
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

FOCAL = 460.0
W = 7
CPU = "cpu"

_jvision = jax.jit(jfac.vision_system, static_argnums=2)
_jimu = jax.jit(jfac.imu_system)
_jprior = jax.jit(jfac.prior_system)
_janchor = jax.jit(jfac.anchor_system, static_argnums=2)
_jicp = jax.jit(jlf.icp_system)
_jlps = jax.jit(jlf.lps_system)
# the position and rotation columns of the window's frames
POSE_COLS = {15 * k + i for k in range(W) for i in range(6)}


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def lidar_tables(p_true, q_true):
    """ICP and LPS tables (JAX form) whose measurements are the truth's:
    4 of 5 ICP and 6 of 7 LPS slots active."""
    def slerp(a, b, t):
        return np.asarray(jlie.quat_slerp(jnp.asarray(a), jnp.asarray(b), t))
    ids = np.array([[0, 1, 2, 3], [1, 2, 4, 5], [2, 3, 5, 6], [0, 1, 5, 6],
                    [3, 4, 4, 5]], np.int32)
    ai = np.array([0.3, 0.5, 0.7, 0.2, 0.9], np.float32)
    aj = np.array([0.6, 0.1, 0.4, 0.8, 0.5], np.float32)
    trans = []
    for (a, b, c, d), x, y in zip(ids, ai, aj):
        Qi = slerp(q_true[a], q_true[b], x)
        Pi = p_true[a] + (p_true[b] - p_true[a]) * x
        Pj = p_true[c] + (p_true[d] - p_true[c]) * y
        trans.append(np.asarray(jlie.quat_rotate_inv(jnp.asarray(Qi),
                                                     jnp.asarray(Pj - Pi))))
    icp = jlf.IcpConstraints(
        ids=jnp.asarray(ids), alpha_i=jnp.asarray(ai),
        alpha_j=jnp.asarray(aj),
        trans_p=jnp.asarray(np.asarray(trans, np.float32)),
        weight=jnp.full((5,), 20.0, jnp.float32),
        active=jnp.asarray([True] * 4 + [False]))
    lids = np.array([[k, k + 1] for k in range(6)] + [[5, 6]], np.int32)
    la = np.linspace(0.1, 0.9, 7).astype(np.float32)
    qm = np.stack([slerp(q_true[a], q_true[b], t)
                   for (a, b), t in zip(lids, la)]).astype(np.float32)
    lps = jlf.LpsConstraints(ids=jnp.asarray(lids), alpha=jnp.asarray(la),
                             q_meas=jnp.asarray(qm),
                             active=jnp.asarray([True] * 6 + [False]))
    return icp, lps


@pytest.fixture(scope="module")
def win():
    world = SyntheticWorld(
        traj=SyntheticTrajectory(duration=8.0, w_amp=(0.9, 0.8, 1.0),
                                 w_freq=(0.5, 0.4, 0.6)),
        landmark_radius=8.0)
    s_true, feats, preints, imask, _ = build_window_problem(world)
    # a feature seen once and an empty slot among the valid ones
    mask = np.asarray(feats.mask).copy()
    mask[5] = False
    mask[5, int(feats.start[5])] = True
    feats = feats._replace(mask=jnp.asarray(mask))
    s0 = perturb_state(s_true, np.random.default_rng(3))
    s_ref = perturb_state(s_true, np.random.default_rng(5), keep_first=False)
    s0 = s0._replace(tic=jnp.asarray([0.02, -0.01, 0.03], jnp.float32),
                     qic=jlie.quat_exp(jnp.asarray([0.01, -0.02, 0.015],
                                                   jnp.float32)),
                     td=jnp.asarray(0.004, jnp.float32))
    rng = np.random.default_rng(1)
    feats = feats._replace(
        vel=jnp.asarray(rng.normal(scale=0.05, size=feats.vel.shape),
                        jnp.float32),
        td_ref=jnp.asarray(rng.normal(scale=0.002, size=feats.td_ref.shape),
                           jnp.float32))
    icp, lps = lidar_tables(np.asarray(s_true.p), np.asarray(s_true.q))
    return dict(
        j=dict(s_true=s_true, s0=s0, s_ref=s_ref, feats=feats, preints=preints,
               imask=imask, icp=icp, lps=lps),
        t=dict(s_true=tst.window_state_from_numpy(as_np(s_true), device=CPU),
               s0=tst.window_state_from_numpy(as_np(s0), device=CPU),
               s_ref=tst.window_state_from_numpy(as_np(s_ref), device=CPU),
               feats=tst.features_from_numpy(as_np(feats), device=CPU),
               preints=tpre.preintegrated_from_numpy(as_np(preints),
                                                     device=CPU),
               imask=torch.as_tensor(np.asarray(imask)),
               icp=tlf.icp_from_numpy(as_np(icp), device=CPU),
               lps=tlf.lps_from_numpy(as_np(lps), device=CPU)),
        gravity=np.asarray([0.0, 0.0, 9.795], np.float32))


def to64(tree):
    return type(tree)(*(to64(x) if isinstance(x, tuple) else
                        (x.double() if x.is_floating_point() else x)
                        for x in tree))


def fd_jacobian(fun, s, F=None, eps=1e-6, cols=None):
    """Central differences of fun(state) (a vector, float64) in the packed
    pose-side delta (the columns `cols`, default all; the others zero) and
    in the landmark delta where F is given."""
    D = tst.pose_dim(s.window)
    out = []
    for k in range(D):
        dx = torch.zeros(D, dtype=torch.float64)
        dx[k] = eps
        if cols is not None and k not in cols:
            out.append(torch.zeros_like(fun(s)))
            continue
        out.append((fun(tst.apply_delta(s, dx))
                    - fun(tst.apply_delta(s, -dx))) / (2 * eps))
    Jl = []
    for k in range(F or 0):
        dl = torch.zeros(F, dtype=torch.float64)
        dl[k] = eps
        zero = torch.zeros(D, dtype=torch.float64)
        Jl.append((fun(tst.apply_delta(s, zero, dl))
                   - fun(tst.apply_delta(s, zero, -dl))) / (2 * eps))
    return (torch.stack(out, -1),
            torch.stack(Jl, -1) if Jl else None)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def test_make_window_state_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present (tests/test_torch_cuda.py)")
    with pytest.raises(RuntimeError):
        tst.make_window_state(W, 256)
    s = tst.make_window_state(W, 256, device=CPU)
    sj = jst.make_window_state(W, 256)
    for a, b in zip(s, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert s.window == W and s.num_features == 256


def test_from_numpy_round_trip(win):
    for name, cls in (("s0", tst.WindowState), ("feats", tst.Features)):
        t, j = win["t"][name], as_np(win["j"][name])
        assert isinstance(t, cls)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), b)
    assert win["t"]["feats"].start.dtype == torch.int64
    for a, b in zip(win["t"]["preints"], as_np(win["j"]["preints"])):
        np.testing.assert_array_equal(a.numpy(), b)


def test_apply_delta_and_boxminus(win):
    rng = np.random.default_rng(2)
    D = tst.pose_dim(W)
    dx = rng.normal(scale=0.05, size=D).astype(np.float32)
    dl = rng.normal(scale=0.05, size=64).astype(np.float32)
    sj = jst.apply_delta(win["j"]["s0"], jnp.asarray(dx), jnp.asarray(dl))
    st = tst.apply_delta(win["t"]["s0"], torch.as_tensor(dx),
                         torch.as_tensor(dl))
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    bj = jst.state_boxminus(sj, win["j"]["s0"])
    bt = tst.state_boxminus(st, win["t"]["s0"])
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=1e-6)
    # and boxminus undoes boxplus
    np.testing.assert_allclose(bt.numpy(), dx, rtol=0, atol=1e-5)


def test_gauge_fix(win):
    sj, st = win["j"]["s0"], win["t"]["s0"]
    p0, q0 = win["j"]["s_true"].p[0], win["j"]["s_true"].q[0]
    fj = jst.gauge_fix(sj, p0, q0)
    ft = tst.gauge_fix(st, torch.as_tensor(np.asarray(p0)),
                       torch.as_tensor(np.asarray(q0)))
    for a, b in zip(ft, fj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# vision
# ---------------------------------------------------------------------------

def test_vision_system_matches_reference(win):
    vj = _jvision(win["j"]["s0"], win["j"]["feats"], FOCAL)
    vt = tfac.vision_system(win["t"]["s0"], win["t"]["feats"], FOCAL)
    np.testing.assert_array_equal(vt.w.numpy() > 0, np.asarray(vj.w) > 0)
    np.testing.assert_array_equal(vt.fidx.numpy(), np.asarray(vj.fidx))
    assert (np.asarray(vj.w) > 0).sum() > 200
    # the residual rows before the Cauchy weight (which bounds the weighted
    # rows by 1 px, below fp32's rounding of a 230-px whitening)
    on = np.asarray(vj.w) > 0
    unweighted = lambda v: np.asarray(v.r)[on] / np.sqrt(  # noqa: E731
        np.asarray(v.w)[on, None])
    assert rel_err(unweighted(vt), unweighted(vj)) < 1e-5
    np.testing.assert_array_equal(vt.r.numpy()[~on], 0.0)
    # w = 1 / (1 + |r|²) doubles the residual's relative error at most
    assert rel_err(vt.w.numpy(), vj.w) < 2e-5
    assert rel_err(vt.cost.numpy(), vj.cost) < 1e-5
    assert rel_err(vt.Jg.numpy(), vj.Jg) < 1e-4
    assert rel_err(vt.Jl.numpy(), vj.Jl) < 1e-4
    assert rel_err(tfac.vision_cost(win["t"]["s0"], win["t"]["feats"],
                                    FOCAL).numpy(), vj.cost) < 1e-5


def test_vision_jacobians_match_finite_differences(win):
    s = to64(win["t"]["s0"])
    f = to64(win["t"]["feats"])
    # a Cauchy scale far above the residuals: weights of 1, so the rows are
    # the whitened residual and its Jacobian
    vs = tfac.vision_system(s, f, FOCAL, cauchy_c=1e6)

    def whitened(x):
        _, _, _, active, per = tfac._vision_inputs(x, f)
        r = tfac.proj_residual(per[0], per[1], per[2], per[3], x.tic, x.qic,
                               per[4], x.td, *per[5:]) * (FOCAL / 2.0)
        return (r * active[:, None]).reshape(-1)

    Jg, Jl = fd_jacobian(whitened, s, F=64)
    N = vs.r.shape[0]
    Jl_dense = torch.zeros(N, 2, 64, dtype=torch.float64)
    Jl_dense[torch.arange(N), :, vs.fidx] = vs.Jl
    assert rel_err(vs.Jg.reshape(N * 2, -1).numpy(), Jg.numpy()) < 1e-6
    assert rel_err(Jl_dense.reshape(N * 2, -1).numpy(), Jl.numpy()) < 1e-6


# ---------------------------------------------------------------------------
# IMU, prior, anchor
# ---------------------------------------------------------------------------

def test_imu_system_matches_reference_and_finite_differences(win):
    g = win["gravity"]
    ij = _jimu(win["j"]["s0"], win["j"]["preints"],
                         win["j"]["imask"], jnp.asarray(g))
    imask = win["t"]["imask"].clone()
    imask[2] = False                              # one interval off
    it = tfac.imu_system(win["t"]["s0"], win["t"]["preints"],
                         win["t"]["imask"], torch.as_tensor(g))
    assert rel_err(it.r.numpy(), ij.r) < 1e-5
    assert rel_err(it.cost.numpy(), ij.cost) < 1e-5
    assert rel_err(it.J.numpy(), ij.J) < 1e-4
    assert rel_err(tfac.imu_cost(win["t"]["s0"], win["t"]["preints"],
                                 win["t"]["imask"], torch.as_tensor(g)),
                   ij.cost) < 1e-5
    ij2 = _jimu(win["j"]["s0"], win["j"]["preints"],
                          jnp.asarray(imask.numpy()), jnp.asarray(g))
    it2 = tfac.imu_system(win["t"]["s0"], win["t"]["preints"], imask,
                          torch.as_tensor(g))
    assert not it2.r[30:45].any() and not it2.J[30:45].any()
    assert rel_err(it2.J.numpy(), ij2.J) < 1e-4

    s64 = to64(win["t"]["s0"])
    pre64 = to64(win["t"]["preints"])
    g64 = torch.as_tensor(g, dtype=torch.float64)
    it64 = tfac.imu_system(s64, pre64, win["t"]["imask"], g64)
    si = tpre.sqrt_information(pre64)

    def whitened(x):
        r = tpre.imu_residual(pre64, *tfac._imu_inputs(x), g64)
        return ((si @ r[..., None])[..., 0]
                * win["t"]["imask"][:, None]).reshape(-1)

    Jfd, _ = fd_jacobian(whitened, s64)
    assert rel_err(it64.J.numpy(), Jfd.numpy()) < 1e-6


def random_prior(win, valid):
    rng = np.random.default_rng(4)
    D = tst.pose_dim(W)
    x0 = perturb_state(win["j"]["s_true"], rng)
    return jfac.Prior(J=jnp.asarray(rng.normal(size=(D, D)), jnp.float32),
                      r0=jnp.asarray(rng.normal(size=D), jnp.float32),
                      x0=x0, valid=jnp.asarray(valid))


@pytest.mark.parametrize("valid", [True, False])
def test_prior_system_matches_reference(win, valid):
    pj = random_prior(win, valid)
    pt = tfac.prior_from_numpy(as_np(pj), device=CPU)
    sj = _jprior(pj, win["j"]["s0"])
    stt = tfac.prior_system(pt, win["t"]["s0"])
    if valid:
        assert rel_err(stt.r.numpy(), sj.r) < 1e-5
        assert rel_err(stt.J.numpy(), sj.J) < 1e-6
        assert rel_err(stt.cost.numpy(), sj.cost) < 1e-5
    else:
        assert not stt.r.any() and not stt.J.any() and stt.cost == 0
    assert rel_err(tfac.prior_cost(pt, win["t"]["s0"]).numpy(),
                   stt.cost.numpy()) < 1e-6
    e = tfac.empty_prior(W, 64, device=CPU)
    for a, b in zip(e[:2] + (e.valid,),
                    jfac.empty_prior(W, 64)[:2] + (jfac.empty_prior(W, 64)
                                                    .valid,)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("active", [True, False])
def test_anchor_system_matches_reference(win, active):
    aj = _janchor(win["j"]["s0"], win["j"]["s_ref"], 1e3,
                            jnp.asarray(active))
    at = tfac.anchor_system(win["t"]["s0"], win["t"]["s_ref"], 1e3,
                            torch.as_tensor(active))
    at2 = tfac.anchor_system(win["t"]["s0"], win["t"]["s_ref"], 1e3, active)
    for a, b in ((at.r, aj.r), (at.J, aj.J), (at.cost, aj.cost)):
        if active:
            assert rel_err(a.numpy(), b) < 1e-5
        else:
            assert not a.any()
    for a, b in zip(at, at2):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert rel_err(tfac.anchor_cost(win["t"]["s0"], win["t"]["s_ref"], 1e3,
                                    active).numpy(), at.cost.numpy()) < 1e-6
    if active:
        s64 = to64(win["t"]["s0"])
        ref64 = to64(win["t"]["s_ref"])
        Jfd, _ = fd_jacobian(lambda x: tfac.anchor_system(
            x, ref64, 1e3, True).r, s64)
        J64 = tfac.anchor_system(s64, ref64, 1e3, True).J
        assert rel_err(J64.numpy(), Jfd.numpy()) < 1e-6


# ---------------------------------------------------------------------------
# LiDAR factors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state", ["s0", "s_true"])
def test_icp_and_lps_systems_match_reference(win, state):
    Jj, rj = _jicp(win["j"][state], win["j"]["icp"])
    Jt, rt = tlf.icp_system(win["t"][state], win["t"]["icp"])
    assert Jt.shape == (3 * tlf.MAX_ICP, tst.pose_dim(W))
    np.testing.assert_array_equal(Jt.abs().amax(1).numpy() > 0,
                                  np.abs(np.asarray(Jj)).max(1) > 0)
    if state == "s0":
        assert rel_err(rt.numpy(), rj) < 1e-5
    else:                   # measured from the truth: zero there
        assert np.abs(rt.numpy()).max() < 1e-4
    assert rel_err(Jt.numpy(), Jj) < 1e-4
    Jj, rj = _jlps(win["j"][state], win["j"]["lps"])
    Jt, rt = tlf.lps_system(win["t"][state], win["t"]["lps"])
    assert Jt.shape == (3 * tlf.MAX_LPS, tst.pose_dim(W))
    if state == "s0":
        assert rel_err(rt.numpy(), rj) < 1e-5
    else:
        assert np.abs(rt.numpy()).max() < 1e-2
    assert rel_err(Jt.numpy(), Jj) < 1e-4


def lidar_rows(x, icp, lps):
    """The weighted ICP and LPS residual rows of state x, without the
    Jacobians: the port's per-constraint residuals under vmap."""
    from torch.func import vmap
    value = lambda f: lambda *a: f(*a)[0]  # noqa: E731
    poses = []
    for k in range(4):
        poses += [x.p[icp.ids[:, k]], x.q[icp.ids[:, k]]]
    r_icp = vmap(value(tlf._icp_local), in_dims=(None,) + (0,) * 12)(
        x.p.new_zeros(24), *poses, icp.alpha_i, icp.alpha_j, icp.trans_p,
        icp.weight)
    r_lps = vmap(value(tlf._lps_local), in_dims=(None, 0, 0, 0, 0, None))(
        x.p.new_zeros(6), x.q[lps.ids[:, 0]], x.q[lps.ids[:, 1]], lps.alpha,
        lps.q_meas, 0.01)
    out = []
    for r, act in ((r_icp, icp.active), (r_lps, lps.active)):
        w = torch.sqrt(1.0 / (1.0 + torch.sum(r * r, -1) / 2.3849 ** 2))
        out.append((r * (act.to(r.dtype) * w)[:, None]).reshape(-1))
    return torch.cat(out)


def test_lidar_jacobians_match_finite_differences(win):
    """At the truth, where the residuals vanish and the Cauchy weights are
    1 to second order."""
    s64 = to64(win["t"]["s_true"])
    icp, lps = to64(win["t"]["icp"]), to64(win["t"]["lps"])
    J = torch.cat([tlf.icp_system(s64, icp)[0], tlf.lps_system(s64, lps)[0]])
    r = torch.cat([tlf.icp_system(s64, icp)[1], tlf.lps_system(s64, lps)[1]])
    np.testing.assert_allclose(lidar_rows(s64, icp, lps).numpy(), r.numpy(),
                               rtol=0, atol=1e-12)
    Jfd, _ = fd_jacobian(lambda x: lidar_rows(x, icp, lps), s64,
                         cols=POSE_COLS)
    assert J.abs().max() > 1.0
    assert rel_err(J.numpy(), Jfd.numpy()) < 1e-6


@pytest.mark.parametrize("active", [True, False])
def test_zero_velocity_system_matches_reference(win, active):
    Jj, rj = jlf.zero_velocity_system(win["j"]["s0"], jnp.asarray(active))
    Jt, rt = tlf.zero_velocity_system(win["t"]["s0"], active)
    np.testing.assert_array_equal(Jt.numpy(), np.asarray(Jj))
    assert rel_err(rt.numpy(), rj) < 1e-6 if active else not rt.any()


def test_empty_lidar_tables_match_reference():
    for t, j in ((tlf.empty_icp(device=CPU), jlf.empty_icp()),
                 (tlf.empty_lps(device=CPU), jlf.empty_lps())):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
