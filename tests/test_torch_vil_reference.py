"""The plain float64 reference of the VIL window problem
(``slambench/reference/vio_window.py``, the one copy, with which the VIL
odometry cell judges its window solves) against the port's window
solve, on the CPU.

- The port's ``frame_step`` on a seeded 7-frame window (chip_smoke's
  phase-10 window: 40 landmarks, two of the LiDAR rows active, a prior)
  reaches the reference's optimum: the reference's LM, started from the
  port's answer, moves no window position by more than 2e-3 m, the fp32
  floor of an LM step at damping 1e-4 (4e-4–2e-3 m from float64, ROADMAP's
  hazards).  The port runs 30 iterations here, so that its answer is
  converged rather than cut at the estimator's 8.
- The same solve by the reference in bfloat16 (its LM from the same
  start, the normal equations factored in float32) moves positions by
  more than that: the comparison tells the precisions apart.
- The reference loads nothing of the port and no JAX, in a process of
  its own.
- The reference's preintegration of a constant body rate and body
  acceleration matches the closed form within 2e-6 (midpoint integration
  at 200 Hz errs by (ω h)² / 12 of the increment, here ~1e-7 relative;
  the bound leaves room for float64 accumulation).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mvil_fusion_torch.config import ImuConfig
from mvil_fusion_torch.estimator import ba, factors as fac
from mvil_fusion_torch.estimator import vio
from slambench.reference import vio_window as ref
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

CPU = "cpu"
FLOOR_M = 2e-3
STATE = ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth")


def _np(s):
    return {k: getattr(s, k).detach().cpu().numpy() for k in STATE}


@pytest.fixture(scope="module")
def window():
    """(tables, start state, prior, spec, the port's answer)."""
    torch.manual_seed(0)
    world = chip_smoke.vio_world(200)
    win = chip_smoke.VioWindow(torch, world, 2.0, 40, CPU, 5)
    W = win.truth.window
    D = 15 * W + 7
    fix = ba.make_fix_mask(W, fix_ext=True, fix_td=True, device=CPU)
    # two of the LiDAR rows, measured from the truth
    icp = win.icp._replace(active=torch.tensor([True, False, True, False,
                                                False]))
    # a prior about the truth: a random well-conditioned square root
    rng = np.random.default_rng(3)
    Jp = (np.eye(D) * 3.0 + rng.normal(scale=0.3, size=(D, D))).astype(
        np.float32)
    prior = fac.Prior(J=torch.as_tensor(Jp), r0=torch.zeros(D),
                      x0=win.truth, valid=torch.ones((), dtype=torch.bool))
    args = (win.start, win.feats, win.need_depth, *win.imu, prior,
            win.gravity, win.noise, icp, win.no_lps, False, fix)
    answer = vio.frame_step(*args, win.focal, 30, True)[0]
    f = {k: getattr(win.feats, k).numpy() for k in win.feats._fields}
    acc, gyr, dts, imask = (x.numpy() for x in win.imu)
    tables = dict(
        obs=f["obs"], vel=f["vel"], td_ref=f["td_ref"], mask=f["mask"],
        start=f["start"], valid=f["valid"], depth_fixed=f["depth_fixed"],
        accs=acc, gyrs=gyr, dts=dts, imu_masks=imask,
        icp_ids=icp.ids.numpy(), icp_ai=icp.alpha_i.numpy(),
        icp_aj=icp.alpha_j.numpy(), icp_tp=icp.trans_p.numpy(),
        icp_w=icp.weight.numpy(), icp_act=icp.active.numpy(),
        lps_ids=win.no_lps.ids.numpy(), lps_alpha=win.no_lps.alpha.numpy(),
        lps_qm=win.no_lps.q_meas.numpy(),
        lps_act=win.no_lps.active.numpy(), zero_vel=np.zeros(1, bool))
    imu = ImuConfig()
    spec = dict(g_norm=float(win.gravity[2]), acc_n=imu.acc_n,
                gyr_n=imu.gyr_n, acc_w=imu.acc_w, gyr_w=imu.gyr_w,
                focal_length=win.focal, estimate_extrinsic=0,
                estimate_td=False)
    prior_np = dict(J=Jp, r0=np.zeros(D, np.float32), x0=_np(win.truth),
                    valid=True)
    return tables, _np(win.start), prior_np, spec, _np(answer)


def test_the_port_reaches_the_references_optimum(window):
    tables, start, prior, spec, answer = window
    problem = ref.WindowProblem(tables, start, prior, spec, CPU)
    move, _, iters = ref.window_move(
        problem, ref.state_from(answer, torch.float64, CPU))
    assert np.isfinite(move) and move < FLOOR_M, (move, iters)


def test_bfloat16_misses_the_optimum(window):
    tables, start, prior, spec, answer = window
    problem = ref.WindowProblem(tables, start, prior, spec, CPU)
    low = ref.WindowProblem(tables, start, prior, spec, CPU,
                            dtype=torch.bfloat16)
    s = ref.state_from(start, torch.bfloat16, CPU)
    s = dict(s, inv_depth=torch.as_tensor(answer["inv_depth"]).to(
        torch.bfloat16))
    control, _ = low.solve(s, s, iters=30, solve_dtype=torch.float32)
    control = {k: v.to(torch.float64) for k, v in control.items()}
    move, _, _ = ref.window_move(problem, control)
    assert move > FLOOR_M, move


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]); "
            "import slambench.reference.vio_window; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    here = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code, str(here)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "mvil_fusion_tpu",
                         "mvil_fusion_torch"}, loaded


def test_preintegration_matches_a_constant_rate_in_closed_form():
    f64 = torch.float64
    w = torch.tensor([0.4, -0.7, 1.1], dtype=f64)
    a = torch.tensor([0.8, 0.3, 9.6], dtype=f64)
    n, h = 21, 0.005
    acc = a.expand(1, n, 3).clone()
    gyr = w.expand(1, n, 3).clone()
    dt = torch.full((1, n), h, dtype=f64)
    dt[0, -1] = 0.0
    mask = torch.ones((1, n), dtype=torch.bool)
    z = torch.zeros((1, 3), dtype=f64)
    pre = ref.preintegrate(acc, gyr, dt, mask, z, z,
                           ref.noise_covariance(0.1, 0.01, 1e-3, 1e-4))
    T = h * (n - 1)
    th = float(torch.linalg.vector_norm(w))
    K = torch.tensor([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                      [-w[1], w[0], 0.0]], dtype=f64)
    eye = torch.eye(3, dtype=f64)
    s, c = np.sin(th * T), np.cos(th * T)
    int1 = T * eye + (1 - c) / th ** 2 * K + (th * T - s) / th ** 3 * K @ K
    int2 = (T * T / 2 * eye + (th * T - s) / th ** 3 * K
            + (th * th * T * T / 2 - 1 + c) / th ** 4 * K @ K)
    assert torch.allclose(pre["dv"][0], int1 @ a, atol=2e-6)
    assert torch.allclose(pre["dp"][0], int2 @ a, atol=2e-6)
    q = ref.qexp(w * T)
    assert torch.allclose(ref.qlog(ref.qmul(ref.qconj(q), pre["dq"][0])),
                          torch.zeros(3, dtype=f64), atol=2e-6)
    assert float(pre["sum_dt"][0]) == pytest.approx(T)
    # the bias Jacobian's Δv / δba block is −∫R dt
    assert torch.allclose(pre["J"][0, 6:9, 9:12], -int1, atol=2e-6)


def test_a_failed_eigh_is_nan_as_in_the_reference(monkeypatch, window):
    """A marginalization whose eigh does not converge gives a NaN prior
    (the reference's ``jnp.linalg.eigh`` answers NaN) instead of raising
    out of the frame step.  The port raised ``LinAlgError`` on a VIL
    stream whose window the JAX package's estimator kept (the indoor
    rig's published widths on a 20 s orbit of a 24 × 20 × 8 m room, on
    the CPU)."""
    def fails(A, *a, **k):
        raise torch.linalg.LinAlgError("linalg.eigh: failed to converge")
    s = ref.state_from(window[4], torch.float32, CPU)
    from mvil_fusion_torch.estimator import state as st
    state = st.WindowState(**s)
    W = state.window
    D = st.pose_dim(W)
    prior = fac.Prior(J=torch.eye(D), r0=torch.zeros(D), x0=state,
                      valid=torch.ones((), dtype=torch.bool))
    prob = ba.BAProblem(
        feats=None, preints=None, interval_mask=None, prior=prior,
        gravity=None, anchor_ref=state, extra_J=None, extra_r=None,
        extra_x0=state, fix_mask=None)
    monkeypatch.setattr(torch.linalg, "eigh", fails)
    out = ba.marginalize_second_new(state, prob)
    kept = D - 15                   # the rows of the frames kept
    assert torch.isnan(out.r0[:kept]).all()
    assert torch.isnan(out.J[:kept, :15]).all()


def test_a_nan_prior_reboots_the_estimator(monkeypatch):
    """A solve whose marginalization leaves a NaN prior fails the frame
    step's finite check, so the estimator reboots (and initializes
    again) rather than keep a prior that rejects every later LM step and
    publish a frozen pose.  chip_smoke's VIO stream on the CPU: the eigh
    of the third solve after initialization does not converge."""
    cfg = chip_smoke.sequence_config(64)
    frames = chip_smoke.vio_sequence(chip_smoke.sequence_world(), cfg,
                                     t_end=2.6)
    est = vio.VIOEstimator(cfg, device=CPU)
    eigh = torch.linalg.eigh
    calls = [0]

    def fails_once(A, *a, **k):
        if est.solves == 3:
            calls[0] += 1
            raise torch.linalg.LinAlgError("linalg.eigh: failed to converge")
        return eigh(A, *a, **k)
    monkeypatch.setattr(torch.linalg, "eigh", fails_once)
    published = []
    for f in frames:
        chip_smoke.feed(est, f)
        if est.solves == 3 and est.failures == 0:
            published = list(est.trajectory)
    assert calls[0] > 0
    assert est.failures == est.reboots == 1
    failure = est.solve_info["failure"]
    assert failure["finite"] == 0.0
    # the failed solve published nothing, and the estimator went on
    assert all(np.isfinite(p).all() and np.isfinite(q).all()
               for _, p, q, *_ in est.trajectory)
    assert len(est.trajectory) > len(published)
