"""VIL odometry on the port: ``VIOEstimator``'s LiDAR side
(``enable_lidar``, ``process_lidar``, ``process_lps``, the ICP and
zero-velocity rows of each solve, the LiDAR-IMU row of ``ex_results``,
``_reboot``'s carry-over) against the JAX package's, and
tests/test_vil_e2e.py's two end-to-end tests on the port (``slow``, as the
reference's are).

The ICP tables are compared on one stream through both estimators
(chip_smoke.vil_sequence at 128 feature slots, sweeps of 16 × 360 points,
hash tables of 2^14): the JAX estimator starts from the true window (its
initialization skipped: the window's states set to the truth before its
first solve) and runs 6 more frames alone, for its prior to build up;
the port takes over its state (``load_reference_state``), and both run
the next 5 frames and their sweeps.  Both front ends start with the same
drift-correcting (mode 3) record in their constraint list, so that the
solves carry an active ICP row.  (The stream's own sweeps agree with the
VIO: their L1 disagreement is 0.02–0.05 m, far from the 0.1 m of the
drift-correcting mode.  A pose pushed off to force one lands the
disagreement of the next two sweeps at 0.09–0.22 m in either package,
and their `converged` flags, a GN step below 5e-4, at the step's
rounding.)  Equal: every sweep's mode and every solve's ICP and
zero-velocity rows.  Poses within 1e-2 m and 1e-2 rad (measured 8.2e-3 m
and 7.5e-3 rad, growing from 6.6e-5 m at the first frame: LM trials
decided at the cost's rounding, see tests/test_torch_vio_estimator.py;
taken over right after the first solve, before a prior has built up,
the two part by 1.5e-2 m over 7 frames, with or without the ICP row).  ``process_lps``, the
``ex_results`` row and the reboot's carry-over within 1e-6.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mvil_fusion_tpu import config as jconfig
from mvil_fusion_tpu.estimator import vio as jvio
from mvil_fusion_torch.config import LidarConfig, SystemConfig
from mvil_fusion_torch.estimator import vio as tvio
from mvil_fusion_torch.estimator.vio import VIOEstimator
from mvil_fusion_torch.utils import lie as tlie
from test_torch_vio_estimator import jax_snapshot
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

CPU = "cpu"
TABLE = 1 << 14
ICP_KEYS = ("icp_ids", "icp_ai", "icp_aj", "icp_w", "icp_act", "zero_vel")


def jax_config(cfg: SystemConfig) -> jconfig.SystemConfig:
    """The JAX package's SystemConfig with the port config's estimator,
    IMU and LiDAR fields."""
    sec = lambda name, cls: dataclasses.replace(  # noqa: E731
        cls(), **dataclasses.asdict(getattr(cfg, name)))
    return jconfig.SystemConfig(
        estimator=sec("estimator", jconfig.EstimatorConfig),
        imu=sec("imu", jconfig.ImuConfig),
        lidar=sec("lidar", jconfig.LidarConfig))


def lidar_pair(cfg=None):
    cfg = cfg or SystemConfig()
    jest = jvio.VIOEstimator(jax_config(cfg))
    test = tvio.VIOEstimator(cfg, device=CPU)
    jest.enable_lidar()
    test.enable_lidar()
    return jest, test


def test_process_lps_matches_reference():
    jest, test = lidar_pair()        # the default, non-identity extrinsic
    rng = np.random.default_rng(4)
    for k in range(9):               # more than MAX_LPS messages
        p = rng.normal(size=3).astype(np.float32)
        q = rng.normal(size=4).astype(np.float32)
        q /= np.linalg.norm(q)
        jest.process_lps(0.1 * k, p, q)
        test.process_lps(0.1 * k, p, q)
    assert len(test.lps_list) == len(jest.lps_list) == 7
    assert test._lps_fresh and jest._lps_fresh
    for (tt, pt, qt), (tj, pj, qj) in zip(test.lps_list, jest.lps_list):
        assert tt == tj
        np.testing.assert_allclose(pt, np.asarray(pj), rtol=0, atol=1e-6)
        np.testing.assert_allclose(qt, np.asarray(qj), rtol=0, atol=1e-6)


def test_ex_results_lidar_row_matches_reference():
    jest, test = lidar_pair()
    for est in (jest, test):
        est._record_ex_results(1.0, np.zeros(3, np.float32),
                               np.asarray([1.0, 0, 0, 0], np.float32), 0.0)
        # an extrinsic as a calibration leaves it
        est.lidar.rlb = tlie.quat_to_mat(tlie.quat_exp(torch.tensor(
            [0.02, -0.01, 0.03]))).numpy()
        est.lidar.tlb = np.asarray([0.1, 0.02, -0.12], np.float32)
        est._record_ex_results(1.1, np.zeros(3, np.float32),
                               np.asarray([1.0, 0, 0, 0], np.float32), 0.0)
    assert len(test.ex_results) == len(jest.ex_results) == 2
    for rt, rj in zip(test.ex_results, jest.ex_results):
        assert rt[0] == rj[0] and rt[5] == rj[5]
        for a, b in zip(rt[1:5], rj[1:5]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    assert np.abs(test.ex_results[1][3]).max() > 0.01


def test_reboot_carries_the_lidar_state():
    jest, test = lidar_pair()
    for est in (jest, test):
        lid = est.lidar
        lid.rlb = np.eye(3, dtype=np.float32)
        lid.tlb = np.asarray([0.1, 0.0, -0.1], np.float32)
        lid.q_lb = np.asarray([1.0, 0, 0, 0], np.float32)
        lid.calibrated = False
        lid.defer_pack = True
        lid.mode_counts = [1, 2, 3, 4, 5, 6]
        lid.constraints.append("a record")
        est.defer_readback = True
        est._reboot()
    for a, b in ((test, jest), (test.lidar, jest.lidar)):
        for name in ("rlb", "tlb", "q_lb"):
            if hasattr(a, name):
                np.testing.assert_array_equal(getattr(a, name),
                                              np.asarray(getattr(b, name)))
    for name in ("calibrated", "defer_pack", "mode_counts", "constraints",
                 "prev", "first_zv"):
        assert getattr(test.lidar, name) == getattr(jest.lidar, name), name
    assert test.failures == jest.failures == 1
    assert test.defer_readback and jest.defer_readback
    assert test.lidar.device == test.device


# ---------------------------------------------------------------------------
# one stream through both estimators
# ---------------------------------------------------------------------------

N_SETTLE = 6         # frames the JAX estimator runs alone after its first
#                      solve, for a prior to build up
N_AFTER = 5          # frames after the port takes over


def force_true_window(jest, frames):
    """Into the JAX estimator: the first W-1 frames, then the window's
    states set to the truth and the status to NON_LINEAR, then frame W-1,
    whose solve starts from the truth."""
    W = jest.W
    for f in frames[:W - 1]:
        chip_smoke.feed(jest, f)
    truth = [f["truth"] for f in frames[:W]]
    jest.status = jest.NON_LINEAR
    jest.state = jest.state._replace(
        p=jnp.asarray(np.asarray([t[0] for t in truth], np.float32)),
        q=jnp.asarray(np.asarray([t[1] for t in truth], np.float32)),
        v=jnp.asarray(np.asarray([t[2] for t in truth], np.float32)))
    chip_smoke.feed(jest, frames[W - 1])


def tables(est):
    src = est._tables if isinstance(est, VIOEstimator) else est._hp
    return {k: np.asarray(src[k]).copy() for k in ICP_KEYS + ("icp_tp",)}


@pytest.fixture(scope="module")
def stream_run():
    cfg = chip_smoke.vil_config(max_features=128, vgicp_table_size=TABLE,
                                downsample_table_size=TABLE)
    world = chip_smoke.sequence_world(chip_smoke.VIL_DURATION)
    W = cfg.estimator.window_size + 1
    t_take = chip_smoke.SEQ_T0 + 0.1 * (W - 1 + N_SETTLE)
    frames, sweeps = chip_smoke.vil_sequence(
        world, cfg, t_end=t_take + 0.1 * N_AFTER + 0.05,
        lidar_times=t_take - 0.15 + 0.1 * np.arange(N_AFTER),
        n_azimuth=360)
    jest = jvio.VIOEstimator(jax_config(cfg))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        force_true_window(jest, frames)
        for f in frames[W:W + N_SETTLE]:
            chip_smoke.feed(jest, f)
        test = tvio.VIOEstimator(cfg, device=CPU)
        test.load_reference_state(jax_snapshot(jest))
        runs = []
        drift = chip_smoke.drift_record(test, world.traj)
        for est in (jest, test):
            est.enable_lidar()
            est.lidar.constraints.append(dataclasses.replace(drift))
            rec = dict(modes=[], tables=[])

            def on_frame(fn, est=est, rec=rec):
                n = est._solves
                fn()
                if est._solves > n:
                    rec["tables"].append(tables(est))

            def on_sweep(s, est=est, rec=rec):
                out = est.process_lidar(s["t_start"], s["pts"],
                                        s["rel_time"], s["mask"])
                rec["modes"].append(None if out is None else out["mode"])
            chip_smoke.run_stream(est, frames[W + N_SETTLE:], sweeps,
                                  on_sweep, on_frame)
            rec["trajectory"] = list(est.trajectory)
            runs.append(rec)
    return dict(jest=jest, test=test, runs=runs, frames=frames)


def test_icp_tables_match_reference(stream_run):
    rj, rt = stream_run["runs"]
    assert rt["modes"] == rj["modes"]
    assert rt["modes"][0] == 0 and set(rt["modes"][1:]) == {2}
    assert len(rt["tables"]) == len(rj["tables"]) == N_AFTER
    active = 0
    for tt, tj in zip(rt["tables"], rj["tables"]):
        for k in ICP_KEYS + ("icp_tp",):
            np.testing.assert_array_equal(tt[k], tj[k], err_msg=k)
        active += int(tt["icp_act"].any())
    assert active >= 3
    jl, tl = stream_run["jest"].lidar, stream_run["test"].lidar
    assert tl.mode_counts == jl.mode_counts
    assert [(r.mode, r.t_i, r.t_j, r.ta, r.tb, r.tc, r.td, r.weight)
            for r in tl.constraints] == \
        [(r.mode, r.t_i, r.t_j, r.ta, r.tb, r.tc, r.td, r.weight)
         for r in jl.constraints]


def test_vil_poses_match_reference(stream_run):
    rj, rt = stream_run["runs"]
    jtraj = rj["trajectory"][-N_AFTER:]
    ttraj = rt["trajectory"]
    assert len(ttraj) == N_AFTER
    for (ta, pa, qa, _), (tb, pb, qb, _) in zip(ttraj, jtraj):
        assert ta == tb
        np.testing.assert_allclose(pa, np.asarray(pb), rtol=0, atol=1e-2)
        dq = tlie.quat_boxminus(torch.as_tensor(qa),
                                torch.as_tensor(np.asarray(qb)))
        assert float(dq.norm()) < 1e-2
    assert stream_run["test"].failures == stream_run["jest"].failures == 0


# ---------------------------------------------------------------------------
# tests/test_vil_e2e.py on the port
# ---------------------------------------------------------------------------

def run_vil(t_end=4.0, lidar_hz=5.0):
    """tests/test_vil_e2e.py::run_vil on the port, on the CPU:
    (estimator, frames, modes)."""
    cfg = chip_smoke.vil_config(max_features=128, vgicp_iters=8)
    frames, sweeps = chip_smoke.vil_sequence(
        chip_smoke.sequence_world(chip_smoke.VIL_DURATION), cfg, t_end,
        lidar_times=np.arange(chip_smoke.SEQ_T0 + 0.85, t_end - 0.15,
                              1.0 / lidar_hz), n_azimuth=360)
    est = VIOEstimator(cfg, device=CPU)
    est.enable_lidar()
    modes = []

    def on_sweep(s):
        out = est.process_lidar(s["t_start"], s["pts"], s["rel_time"],
                                s["mask"])
        if out is not None:
            modes.append(out["mode"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        chip_smoke.run_stream(est, frames, sweeps, on_sweep)
    return est, frames, modes


@pytest.mark.slow
def test_vil_e2e_runs_with_lidar_constraints():
    est, frames, modes = run_vil()
    assert est.status == VIOEstimator.NON_LINEAR
    assert est.failures == 0
    assert len(modes) >= 8, modes
    assert all(m in (0, 1, 2, 3) for m in modes), modes
    assert modes.count(2) + modes.count(3) >= 6, modes
    assert chip_smoke.ate_4dof(est.trajectory, frames) < 0.3


@pytest.mark.slow
def test_vil_zero_velocity_mode_on_stationary():
    from mvil_fusion_torch.io.synthetic import SyntheticTrajectory
    from mvil_fusion_torch.io.synthetic_lidar import BoxWorld, simulate_sweep
    traj = SyntheticTrajectory(duration=6.0, w_amp=(0.0, 0.0, 0.0),
                               p_amp=(0.0, 0.0, 0.0), lin_vel=(0.0, 0.0, 0.0))
    cfg = dataclasses.replace(SystemConfig(), lidar=LidarConfig(
        rlb=chip_smoke.IDENTITY, tlb=(0.0, 0.0, 0.0), vgicp_iters=8))
    est = VIOEstimator(cfg, device=CPU)
    est.enable_lidar()
    est.status = VIOEstimator.NON_LINEAR
    est.times = [0.5 + 0.1 * k for k in range(est.W)]
    modes = []
    for tl in (0.62, 0.82):
        sweep = simulate_sweep(BoxWorld(), traj, tl, n_azimuth=360)
        out = est.process_lidar(sweep["t_start"], sweep["pts"],
                                sweep["rel_time"], sweep["mask"])
        if out is not None:
            modes.append(out["mode"])
    assert modes and modes[-1] == 4, modes
