"""The port's IMU preintegration against the JAX package's
(``ops/preintegration.py``) on seeded streams of the synthetic trajectory
(200 Hz, with biases), padded to a fixed capacity with garbage behind the
mask.

Tolerances.  `dp`, `dq`, `dv`, `sum_dt` within 1e-5 absolute (1e-7 seen);
`J` and `P` within 1e-4 of their largest entry (5e-7 seen): the port sums
Δv and Δp as running sums and takes F and V analytically where the
reference scans and differentiates, so only rounding differs.  F and V of
one step within 1e-5 of the reference's `jax.jacfwd` matrices and of the
forward-AD matrices of the port's own `_midpoint_step`
(`torch.func.jacfwd`), at a usual, a long and a zero step.  Padding is an
exact no-op; a batch equals its intervals one by one.  The residual, the
bias correction, the sqrt information and the propagation within 1e-5
(sqrt information 1e-4 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu.ops import preintegration as jpre
from mvil_fusion_tpu.io.synthetic import SyntheticTrajectory
from mvil_fusion_torch.ops import preintegration as tpre
from mvil_fusion_torch.utils import lie as tlie
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

NOISE = (0.02065, 0.00519, 0.00667, 0.00088056)
BA_TRUE = np.asarray([0.05, -0.02, 0.03])
BG_TRUE = np.asarray([0.01, 0.0, -0.02])
CAP = 24
T = torch.as_tensor

_jbatch = jax.jit(jpre.preintegrate_batch)


@pytest.fixture(scope="module")
def traj():
    return SyntheticTrajectory(duration=3.0)


@pytest.fixture(scope="module")
def streams(traj):
    """Three intervals of 21, 17 and 21 samples in CAP slots, garbage in
    the padding: dict of numpy arrays, plus the interval bounds."""
    rng = np.random.default_rng(0)
    B = 3
    acc = np.zeros((B, CAP, 3), np.float32)
    gyr = np.zeros((B, CAP, 3), np.float32)
    dt = np.zeros((B, CAP), np.float32)
    mask = np.zeros((B, CAP), bool)
    bounds = [(0.5, 0.6), (0.6, 0.68), (0.7, 0.8)]
    for b, (t0, t1) in enumerate(bounds):
        a, g, d, ts = traj.imu_sequence(t0, t1, 200.0, ba=BA_TRUE,
                                        bg=BG_TRUE)
        n = len(ts)
        acc[b, :n], gyr[b, :n], dt[b, :n], mask[b, :n] = a, g, d, True
        acc[b, n:] = 1e3 * rng.normal(size=(CAP - n, 3))
        gyr[b, n:] = 1e3 * rng.normal(size=(CAP - n, 3))
        dt[b, n:] = 0.7
    ba = (BA_TRUE + rng.normal(scale=0.01, size=(B, 3))).astype(np.float32)
    bg = (BG_TRUE + rng.normal(scale=0.002, size=(B, 3))).astype(np.float32)
    return dict(acc=acc, gyr=gyr, dt=dt, ba=ba, bg=bg, mask=mask), bounds


def _run_both(s):
    names = ("acc", "gyr", "dt", "ba", "bg")
    pj = _jbatch(*(jnp.asarray(s[k]) for k in names),
                 jpre.noise_covariance(*NOISE), jnp.asarray(s["mask"]))
    pt = tpre.preintegrate_batch(*(T(s[k]) for k in names),
                                 tpre.noise_covariance(*NOISE), T(s["mask"]))
    return pj, pt


def _to_jax(pre, i=None):
    take = (lambda f: f.numpy()) if i is None else (lambda f: f[i].numpy())
    return jpre.Preintegrated(*(jnp.asarray(take(f)) for f in pre))


def test_noise_covariance_matches_reference():
    np.testing.assert_array_equal(
        tpre.noise_covariance(*NOISE).numpy(),
        np.asarray(jpre.noise_covariance(*NOISE)))


def test_batch_matches_reference(streams):
    s, _ = streams
    pj, pt = _run_both(s)
    assert pt._fields == pj._fields
    for name in ("dp", "dq", "dv", "sum_dt", "ba", "bg"):
        np.testing.assert_allclose(getattr(pt, name).numpy(),
                                   np.asarray(getattr(pj, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    for name in ("J", "P"):
        ref = np.asarray(getattr(pj, name))
        np.testing.assert_allclose(getattr(pt, name).numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)
    P = pt.P.numpy().astype(np.float64)
    assert np.abs(P - P.transpose(0, 2, 1)).max() < 1e-6 * np.abs(P).max()
    # the bias states' own covariance is a random walk; the rest is
    # positive definite
    assert np.linalg.eigvalsh(P[:, :9, :9]).min() > 0


def test_padding_is_an_exact_no_op(streams):
    s, _ = streams
    _, full = _run_both(s)
    for b in range(3):
        n = int(s["mask"][b].sum())
        cut = tpre.preintegrate(T(s["acc"][b, :n]), T(s["gyr"][b, :n]),
                                T(s["dt"][b, :n]), T(s["ba"][b]),
                                T(s["bg"][b]), tpre.noise_covariance(*NOISE))
        for name, a in zip(full._fields, full):
            assert torch.equal(a[b], getattr(cut, name)), (b, name)


def test_batch_equals_loop(streams):
    s, _ = streams
    _, full = _run_both(s)
    for b in range(3):
        one = tpre.preintegrate(T(s["acc"][b]), T(s["gyr"][b]), T(s["dt"][b]),
                                T(s["ba"][b]), T(s["bg"][b]),
                                tpre.noise_covariance(*NOISE),
                                T(s["mask"][b]))
        for name, a in zip(full._fields, full):
            torch.testing.assert_close(a[b], getattr(one, name), rtol=1e-6,
                                       atol=1e-9, msg=f"{b} {name}")
    # an interior gap in the mask skips the two steps that touch it
    mask = s["mask"][0].copy()
    mask[7] = False
    gap = tpre.preintegrate(T(s["acc"][0]), T(s["gyr"][0]), T(s["dt"][0]),
                            T(s["ba"][0]), T(s["bg"][0]),
                            tpre.noise_covariance(*NOISE), T(mask))
    ref = jpre.preintegrate(*(jnp.asarray(s[k][0]) for k in
                              ("acc", "gyr", "dt", "ba", "bg")),
                            jpre.noise_covariance(*NOISE), jnp.asarray(mask))
    np.testing.assert_allclose(gap.dp.numpy(), np.asarray(ref.dp), atol=1e-6)
    np.testing.assert_allclose(gap.sum_dt.numpy(), np.asarray(ref.sum_dt),
                               atol=1e-7)


def _torch_ad_jacobians(dp, dq, dv, ba, bg, acc0, gyr0, acc1, gyr1, h):
    """F and V by forward AD of the port's `_midpoint_step` in local
    coordinates: the reference's `_step_jacobians`, line for line."""
    def local_step(delta, noise):
        q = tlie.quat_mul(dq, tlie.quat_exp(delta[3:6]))
        p2, q2, v2, a2, g2 = tpre._midpoint_step(
            dp + delta[0:3], q, dv + delta[6:9], ba + delta[9:12],
            bg + delta[12:15], acc0, gyr0, acc1, gyr1, h, noise)
        p0, q0, v0, a0, g0 = tpre._midpoint_step(
            dp, dq, dv, ba, bg, acc0, gyr0, acc1, gyr1, h,
            torch.zeros(tpre.NOISE_DIM))
        dth = tlie.quat_log(tlie.quat_mul(tlie.quat_conj(q0), q2))
        return torch.cat([p2 - p0, dth, v2 - v0, a2 - a0, g2 - g0])

    zd, zn = torch.zeros(tpre.STATE_DIM), torch.zeros(tpre.NOISE_DIM)
    return (torch.func.jacfwd(local_step, argnums=0)(zd, zn),
            torch.func.jacfwd(local_step, argnums=1)(zd, zn))


@pytest.mark.parametrize("h", [0.005, 0.05, 0.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_step_jacobians_match_forward_ad(h, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    dp, dv = f32(rng.normal(size=3)), f32(rng.normal(size=3))
    dq = rng.normal(size=4)
    dq = f32(dq / np.linalg.norm(dq))
    ba, bg = f32(rng.normal(scale=0.05, size=3)), f32(
        rng.normal(scale=0.01, size=3))
    acc0, gyr0 = f32(9 * rng.normal(size=3)), f32(rng.normal(size=3))
    acc1, gyr1 = f32(acc0 + 0.1), f32(gyr0 + 0.05)
    if seed == 1:
        gyr0, gyr1 = bg.copy(), bg.copy()       # no rotation at all
    args = (dp, dq, dv, ba, bg, acc0, gyr0, acc1, gyr1)
    Fj, Vj = jpre._step_jacobians(*(jnp.asarray(a) for a in args),
                                  jnp.float32(h))
    w = (0.5 * (T(gyr0) + T(gyr1)) - T(bg)) * h
    q1 = tlie.quat_normalize(tlie.quat_mul(T(dq), tlie.quat_exp(w)))
    Ft, Vt = tpre._step_jacobians(
        tlie.quat_to_mat(T(dq)), tlie.quat_to_mat(q1), w, T(acc0) - T(ba),
        T(acc1) - T(ba), torch.tensor(h))
    Fa, Va = _torch_ad_jacobians(*(T(a) for a in args), torch.tensor(h))
    assert Ft.shape == (15, 15) and Vt.shape == (15, 18)
    for ours, theirs in ((Ft, Fj), (Vt, Vj), (Ft, Fa), (Vt, Va)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                                   atol=1e-5)
    if h == 0.0:
        assert torch.equal(Ft, torch.eye(15)) and not Vt.any()


def test_residual_and_bias_correction_match_reference(streams, traj):
    s, bounds = streams
    _, pt = _run_both(s)
    rng = np.random.default_rng(2)
    g = np.asarray([0.0, 0.0, traj.g_norm], np.float32)
    f32 = lambda a: np.asarray(a, np.float32)
    states = []
    for t0, t1 in bounds:
        pi, qi, vi = traj.state_at(t0)
        pj, qj, vj = traj.state_at(t1)
        states.append([f32(x) for x in (
            pi, qi, vi, BA_TRUE + 0.02 * rng.normal(size=3),
            BG_TRUE + 0.004 * rng.normal(size=3), pj, qj, vj, BA_TRUE,
            BG_TRUE)])
    batched = [T(np.stack(col)) for col in zip(*states)]
    r_t = tpre.imu_residual(pt, *batched, T(g))
    assert r_t.shape == (3, 15)
    for b in range(3):
        pre_j = _to_jax(pt, b)
        r_j = jpre.imu_residual(pre_j, *(jnp.asarray(x) for x in states[b]),
                                jnp.asarray(g))
        np.testing.assert_allclose(r_t[b].numpy(), np.asarray(r_j), rtol=0,
                                   atol=1e-5)
        one = tpre.imu_residual(tpre.Preintegrated(*(f[b] for f in pt)),
                                *(T(x) for x in states[b]), T(g))
        np.testing.assert_allclose(one.numpy(), r_t[b].numpy(), atol=1e-6)
        d_j = jpre.bias_corrected_delta(pre_j, jnp.asarray(states[b][3]),
                                        jnp.asarray(states[b][4]))
        d_t = tpre.bias_corrected_delta(
            tpre.Preintegrated(*(f[b] for f in pt)), T(states[b][3]),
            T(states[b][4]))
        for a, c in zip(d_t, d_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                       atol=1e-6)
    # near the truth the residual is small: integration error and the
    # first-order bias correction
    assert np.abs(r_t.numpy()[:, :9]).max() < 5e-3


def test_sqrt_information_matches_reference(streams):
    s, _ = streams
    _, pt = _run_both(s)
    L_t = tpre.sqrt_information(pt).numpy()
    assert L_t.shape == (3, 15, 15) and np.isfinite(L_t).all()
    for b in range(3):
        L_j = np.asarray(jpre.sqrt_information(_to_jax(pt, b)))
        np.testing.assert_allclose(L_t[b], L_j, rtol=0,
                                   atol=1e-4 * np.abs(L_j).max())
        assert np.abs(np.triu(L_t[b], 1)).max() == 0
        P = pt.P[b].numpy().astype(np.float64) + 1e-8 * np.eye(15)
        info = L_t[b].astype(np.float64).T @ L_t[b].astype(np.float64)
        assert np.abs(info @ P - np.eye(15)).max() < 2e-2


def test_propagate_state_matches_reference(traj):
    rng = np.random.default_rng(3)
    f32 = lambda a: np.asarray(a, np.float32)
    p, q, v = (f32(x) for x in traj.state_at(0.5))
    a0, g0 = (f32(x) for x in traj.imu_at(0.5))
    a1, g1 = (f32(x) for x in traj.imu_at(0.505))
    ba, bg = f32(0.01 * rng.normal(size=3)), f32(0.01 * rng.normal(size=3))
    g = f32([0, 0, traj.g_norm])
    args = (p, q, v, ba, bg, a0, g0, a1, g1)
    out_j = jpre.propagate_state(*(jnp.asarray(x) for x in args),
                                 jnp.float32(0.005), jnp.asarray(g))
    out_t = tpre.propagate_state(*(T(x) for x in args), 0.005, T(g))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
