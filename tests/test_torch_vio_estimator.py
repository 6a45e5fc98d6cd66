"""The port's VIO estimator host class (``VIOEstimator`` in
``mvil_fusion_torch/estimator/vio.py``): the estimator tests of
``tests/test_new_features.py`` and ``tests/test_robustness.py`` on the
port, the LPS table against the JAX package's, and the estimator against
the JAX package's on one sensor stream (``chip_smoke.vio_sequence``: the
with-bias stream of ``tests/test_vio_e2e.py``, 128 feature slots).  The
JAX estimator is given the port's start-frame rule
(``JaxWithStartFrameRule``), which the JAX package lacks.

* Initialization: both estimators take the stream until they initialize
  (the 7th frame), the port's essential-matrix hypotheses replayed from
  JAX's key chain.  Equal: the anchor frame l, the path and the stage-A
  decision; per-frame scale within 1e-3 relative; the initialized state
  within 1e-3 m, 1e-3 rad, 1e-3 m/s, biases 1e-3, inverse depths of the
  triangulated slots 1e-3 relative.
* Steady state: the port takes over a snapshot of the JAX estimator right
  after its first solve (``load_reference_state``) and both run the next
  5 frames: equal slots, keyframe decisions, failure counts, trajectory
  lengths and feature tables (start, mask, valid, need_depth, fixed);
  gyro biases within 1e-3; poses within 1e-2 m and 5e-3 rad.  The pose
  tolerance is the frame step's, not the host class's: the port's tables
  of the first of those frames, put through the JAX package's own step,
  give the JAX estimator's pose bit for bit.  Both estimators run 4
  solver iterations here: at 8, the two steps on the same tables differ
  by 2.0e-3 m (an LM trial decided at the rounding of the cost of this
  just-initialized, flat window), and with the start-frame rule that
  grows to 1.1e-2 m over the 5 frames with equal tables; at 4 the steps
  differ by 3.3e-5 m and the trajectories by at most 1.3e-3 m.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mvil_fusion_tpu import config as jconfig
from mvil_fusion_tpu.estimator import vio as jvio
from mvil_fusion_torch.config import EstimatorConfig, ImuConfig, SystemConfig
from mvil_fusion_torch.estimator import vio as tvio
from mvil_fusion_torch.utils import lie as tlie
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

CPU = "cpu"
N_INIT = 7            # the window fills, initializes and solves at frame 7
N_STEADY = 5
# the feature tables that the port's and the JAX package's host classes
# must fill alike, frame by frame
TABLES = ("start", "mask", "valid", "need_depth", "depth_fixed")
T_END = chip_smoke.SEQ_T0 + 0.1 * (N_INIT + N_STEADY) - 0.05


def jax_config(cfg: SystemConfig) -> jconfig.SystemConfig:
    """The JAX package's SystemConfig with the port config's estimator and
    IMU fields."""
    e = dataclasses.asdict(cfg.estimator)
    return jconfig.SystemConfig(
        estimator=dataclasses.replace(jconfig.EstimatorConfig(), **e),
        imu=dataclasses.replace(jconfig.ImuConfig(),
                                **dataclasses.asdict(cfg.imu)))


def jax_snapshot(est) -> dict:
    """A JAX VIOEstimator's state as numpy arrays and Python values, in the
    form `VIOEstimator.load_reference_state` takes."""
    def interval(iv):
        return dict(acc=list(iv.acc), gyr=list(iv.gyr), t=list(iv.t))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(
        status=est.status, frame_count=est.frame_count,
        times=list(est.times),
        tracks={fid: dict(
            obs={k: dict(norm=o.norm, vel=o.vel, td_ref=o.td_ref,
                         depth=o.depth) for k, o in tr.obs.items()},
            inv_depth=tr.inv_depth, depth_fixed=tr.depth_fixed,
            slot=tr.slot) for fid, tr in est.tracks.items()},
        slots=list(est.slots),
        intervals=[interval(iv) for iv in est.intervals],
        pending=interval(est._pending), last_imu=est.last_imu,
        marg_old=est.marg_old, prior_valid=est._prior_valid,
        td_host=est.td_host, bg_host=np.asarray(est.bg_host),
        qic_host=np.asarray(est.qic_host), state=to_np(est.state),
        prior=to_np(est.prior), failures=est.failures,
        iters_current=est._iters_current, headroom=est._headroom,
        solves=est._solves)


def replay_jax_keys():
    """A hypothesis_source for the port that draws what the JAX estimator
    draws: PRNGKey(7), split once per essential-matrix candidate."""
    key = [jax.random.PRNGKey(7)]

    def draw(valid):
        key[0], sub = jax.random.split(key[0])
        p = jnp.asarray(valid.cpu().numpy()).astype(jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        return np.asarray(jax.random.choice(sub, p.shape[0], shape=(256, 8),
                                            replace=True, p=p))
    return draw


def state_np(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


class JaxWithStartFrameRule(jvio.VIOEstimator):
    """The JAX package's estimator given the port's start-frame rule, a
    deliberate divergence of the port (``tvio.VIOEstimator.
    _fill_feature_tables``): a track first seen in the window's newest
    two frames stays out of the solve and of triangulation, and every
    track kept out of the solve keeps its host depth (the JAX package
    lets such tracks in and writes the solve's depth back to all)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._held = {}
        self.tables_seen = []

    def _fill_feature_tables(self, start, obs, vel, td_ref, mask, fixed,
                             valid, ov_val, ov_mask, need_depth=None):
        super()._fill_feature_tables(start, obs, vel, td_ref, mask, fixed,
                                     valid, ov_val, ov_mask, need_depth)
        lag = self.W - 2
        for s, fid in enumerate(self.slots):
            if fid is None:
                continue
            tr = self.tracks[fid]
            if tr.start >= lag:
                valid[s] = False
                if need_depth is not None:
                    need_depth[s] = False
            if not valid[s]:
                self._held[fid] = tr.inv_depth

    def _solve_and_slide(self):
        self._held = {}
        super()._solve_and_slide()
        for fid, depth in self._held.items():
            if fid in self.tracks:
                self.tracks[fid].inv_depth = depth

    def _fill_imu_tables(self, *args):
        # the feature tables are filled by now: keep what the solve gets
        super()._fill_imu_tables(*args)
        self.tables_seen.append({k: np.array(self._hp[k]) for k in TABLES})


def capture_init(est, method):
    """Record est's state right after a successful initialization, before
    its first solve."""
    inner = getattr(est, method)
    seen = {}

    def wrapped():
        ok = inner()
        if ok:
            seen.update(state_np(jax.tree.map(
                lambda x: x.cpu() if isinstance(x, torch.Tensor) else x,
                est.state)))
        return ok
    setattr(est, method, wrapped)
    return seen


@pytest.fixture(scope="module")
def stream_run():
    """Both estimators on the stream: through initialization and its first
    solve, then a snapshot of the JAX one, then its next N_STEADY frames."""
    cfg = chip_smoke.sequence_config(max_features=128)
    cfg = dataclasses.replace(cfg, estimator=dataclasses.replace(
        cfg.estimator, max_solver_iters=4))
    frames = chip_smoke.vio_sequence(chip_smoke.sequence_world(), cfg,
                                     t_end=T_END)
    assert len(frames) == N_INIT + N_STEADY
    jest = JaxWithStartFrameRule(jax_config(cfg))
    test = tvio.VIOEstimator(cfg, device=CPU)
    test.hypothesis_source = replay_jax_keys()
    init_j = capture_init(jest, "_try_initialize_impl")
    init_t = capture_init(test, "_try_initialize")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # a repeated stamp
        for f in frames[:N_INIT]:
            chip_smoke.feed(jest, f)
            chip_smoke.feed(test, f)
        snap = jax_snapshot(jest)
        jest.tables_seen.clear()
        steady_j = []
        for f in frames[N_INIT:]:
            chip_smoke.feed(jest, f)
            steady_j.append((jest.marg_old, list(jest.slots), jest.failures,
                             np.asarray(jest.state.bg[-1])))
    return dict(cfg=cfg, frames=frames, jest=jest, test=test, init_j=init_j,
                init_t=init_t, snap=snap, steady_j=steady_j)


def test_initialization_matches_reference(stream_run):
    jest, test = stream_run["jest"], stream_run["test"]
    assert jest.status == test.status == tvio.VIOEstimator.NON_LINEAR
    ij, it = jest.solve_info["init"], test.solve_info["init"]
    assert it["l"] == ij["l"] and it["path"] == ij["path"] == "novel_stage_b"
    np.testing.assert_allclose(it["scale"], ij["scale"], rtol=1e-3)
    sj, st_ = stream_run["init_j"], stream_run["init_t"]
    np.testing.assert_allclose(st_["p"], sj["p"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(st_["v"], sj["v"], rtol=0, atol=1e-3)
    for b in ("ba", "bg"):
        np.testing.assert_allclose(st_[b], sj[b], rtol=0, atol=1e-3)
    dq = tlie.quat_boxminus(torch.as_tensor(st_["q"]),
                            torch.as_tensor(sj["q"])).norm(dim=-1)
    assert float(dq.max()) < 1e-3
    assert (st_["inv_depth"] != 1.0).sum() > 40      # slots triangulated
    np.testing.assert_allclose(st_["inv_depth"], sj["inv_depth"], rtol=1e-3)
    # the first solve after initialization
    assert len(test.trajectory) == 1
    np.testing.assert_allclose(test.trajectory[0][1], jest.trajectory[0][1],
                               rtol=0, atol=1e-3)


def test_steady_state_matches_reference(stream_run):
    cfg, frames = stream_run["cfg"], stream_run["frames"]
    jest, snap = stream_run["jest"], stream_run["snap"]
    est = tvio.VIOEstimator(cfg, device=CPU)
    est.load_reference_state(snap)
    tables = []
    step = est._frame_step

    def keep_tables(d):
        tables.append({k: v.numpy().copy() for k, v in d.items()})
        return step(d)
    est._frame_step = keep_tables
    jax_tables = jest.tables_seen
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for f, (marg_old, slots, failures, bg) in zip(
                frames[N_INIT:], stream_run["steady_j"]):
            chip_smoke.feed(est, f)
            assert est.marg_old == marg_old
            assert est.slots == slots
            assert est.failures == failures == 0
            np.testing.assert_allclose(est.state.bg[-1].numpy(), bg, rtol=0,
                                       atol=1e-3)
    assert len(est.trajectory) == N_STEADY == len(jest.trajectory) - 1
    # each frame's feature tables are the JAX host class's (the rule too)
    assert len(tables) == len(jax_tables) == N_STEADY
    for ours, theirs in zip(tables, jax_tables):
        for name in TABLES:
            np.testing.assert_array_equal(ours[name], theirs[name])
    for (tp, pp, qp, _), (tj, pj, qj, _) in zip(est.trajectory,
                                                jest.trajectory[1:]):
        assert tp == tj
        np.testing.assert_allclose(pp, pj, rtol=0, atol=1e-2)
        dq = tlie.quat_boxminus(torch.as_tensor(qp), torch.as_tensor(qj))
        assert float(dq.norm()) < 5e-3

    # the host class's tables are the reference's: its first keyframe's
    # tables through the JAX package's packed step reproduce the JAX
    # estimator's own step bit for bit
    hp = jest._hp
    hp.zero()
    for name, a in tables[0].items():
        hp[name][...] = a
    state = jax.tree.map(jnp.asarray, snap["state"])
    prior = jax.tree.map(jnp.asarray, snap["prior"])
    out = jvio._frame_step_packed(
        state, prior, jest.gravity, jest.noise_cov, jest._fix_mask,
        *hp.buffers(), layout=hp.layout, focal=cfg.estimator.focal_length,
        iters=cfg.estimator.max_solver_iters,
        marg_old=stream_run["steady_j"][0][0])
    pack = np.asarray(out[4])
    _, p_j, q_j, v_j = jest.trajectory[1]
    np.testing.assert_array_equal(pack[6:9], p_j)
    np.testing.assert_array_equal(pack[9:13], q_j)
    np.testing.assert_array_equal(pack[13:16], v_j)


# ---------------------------------------------------------------------------
# tests/test_new_features.py and tests/test_robustness.py on the port
# ---------------------------------------------------------------------------

def test_estimator_decimates_oversized_interval():
    """Merged non-keyframe intervals past the device capacity are decimated
    (bounded error), never silently truncated."""
    cfg = SystemConfig(imu=ImuConfig(max_imu_per_frame=32))
    est = tvio.VIOEstimator(cfg, device=CPU)
    assert est.imu_nmax == 32
    for k in range(200):
        est.process_imu(k * 0.005, np.asarray([0, 0, 9.795]), np.zeros(3))
    est.process_features(0.0, np.asarray([0]), np.zeros((1, 2), np.float32),
                         np.zeros((1, 2), np.float32))
    for k in range(200):
        est.process_imu(1.0 + k * 0.005, np.asarray([0, 0, 9.795]),
                        np.zeros(3))
    est.process_features(1.999, np.asarray([0]),
                         np.zeros((1, 2), np.float32),
                         np.zeros((1, 2), np.float32))
    accs, gyrs, dts, masks = est._imu_buffers()
    assert est.imu_decimations >= 1
    assert int(masks[0].sum()) <= 32
    assert abs(float(dts[0].sum()) - 1.995) < 0.02


def test_ex_results_row_shape():
    est = tvio.VIOEstimator(SystemConfig(), device=CPU)
    est._record_ex_results(1.25)
    t, vi_ypr, vi_t, li_ypr, li_t, td = est.ex_results[0]
    assert t == 1.25
    assert vi_ypr.shape == (3,) and li_t.shape == (3,)
    assert isinstance(td, float)


def _feed_rotation_only(est, w_z=0.6, n_frames=6, n_feats=60, fps=10.0):
    """Pure-rotation camera stream: features move in the image purely from
    yaw rotation; gyro reports the same rotation."""
    rng = np.random.default_rng(3)
    ang = rng.uniform(-0.5, 0.5, n_feats)
    h = rng.uniform(-0.3, 0.3, n_feats)
    for k in range(n_frames):
        t = k / fps
        yaw = w_z * t
        if k > 0:
            for i in range(10):
                est.process_imu((k - 1) / fps + (i + 1) * 0.01,
                                np.asarray([0, 0, 9.795]),
                                np.asarray([0.0, w_z, 0.0]))
        a = ang - yaw
        norm = np.stack([np.tan(a), h], axis=1).astype(np.float32)
        vis = np.abs(a) < 0.45
        est.process_features(t, np.nonzero(vis)[0],
                             norm[vis], np.zeros((vis.sum(), 2), np.float32))
    return est


def test_pure_rotation_yields_second_new_marginalization():
    """Under pure rotation the compensated parallax stays ~0, so the
    keyframe decision flips to marginalize-second-new."""
    cfg = SystemConfig(estimator=EstimatorConfig(
        ric=(1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0), tic=(0.0, 0.0, 0.0),
        td_init=0.0, estimate_extrinsic=0, estimate_td=False))
    est = _feed_rotation_only(tvio.VIOEstimator(cfg, device=CPU))
    k = est.frame_count
    tr = next(t for t in est.tracks.values()
              if k - 1 in t.obs and k - 2 in t.obs)
    assert np.linalg.norm(tr.obs[k - 1].norm - tr.obs[k - 2].norm) > 0.02
    assert est.marg_old is False


def test_imu_disorder_rejected():
    """Out-of-order IMU samples are dropped with one warning — no negative
    dt may reach preintegration."""
    est = tvio.VIOEstimator(SystemConfig(), device=CPU)
    est.process_imu(0.00, np.zeros(3), np.zeros(3))
    est.process_imu(0.01, np.zeros(3), np.zeros(3))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        est.process_imu(0.005, np.ones(3), np.ones(3))   # disordered
        est.process_imu(0.010, np.ones(3), np.ones(3))   # duplicate stamp
    assert est.imu_disorder == 2
    assert len([x for x in w if "disorder" in str(x.message)]) == 1
    est.process_imu(0.02, np.zeros(3), np.zeros(3))
    ts = np.asarray(est._pending.t)
    assert np.all(np.diff(ts) > 0), ts
    assert len(est._pending.t) == 3


def test_imu_disorder_no_nan_in_window():
    est = tvio.VIOEstimator(SystemConfig(), device=CPU)
    rng = np.random.default_rng(3)
    ts = np.sort(rng.uniform(0, 1.0, 200))
    shuffled = ts.copy()
    shuffled[50:60] = shuffled[50:60][::-1]           # a disordered burst
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for t in shuffled:
            est.process_imu(t, rng.normal(0, 1, 3), rng.normal(0, 0.1, 3))
    assert np.all(np.diff(np.asarray(est._pending.t)) > 0)
    assert est.imu_disorder > 0


def test_solver_budget_adapts_iterations():
    """Overrunning the wall-clock budget halves the LM iteration count for
    subsequent frames; sustained headroom steps back up."""
    cfg = SystemConfig()
    cfg = dataclasses.replace(cfg, estimator=dataclasses.replace(
        cfg.estimator, max_solver_iters=8, min_solver_iters=4,
        solver_time_budget_s=0.05))
    est = tvio.VIOEstimator(cfg, device=CPU)
    est.enforce_budget = True             # real-time mode
    est._solves = 10
    assert est._iters_current == 8
    est._update_iter_budget(0.2)          # overrun
    assert est._iters_current == 4
    assert est.budget_overruns == 1
    est._update_iter_budget(9.0)          # hiccup: ignored
    assert est.budget_overruns == 1
    for _ in range(20):                   # sustained headroom: step up
        est._update_iter_budget(0.01)
    assert est._iters_current == 8
    assert est.solve_info["solver_iters"] == 8
    cfg2 = dataclasses.replace(cfg, estimator=dataclasses.replace(
        cfg.estimator, solver_time_budget_s=0.0))
    est2 = tvio.VIOEstimator(cfg2, device=CPU)
    est2.enforce_budget = True
    est2._solves = 10
    est2._update_iter_budget(1.0)
    assert est2._iters_current == 8 and est2.budget_overruns == 0
    est3 = tvio.VIOEstimator(cfg, device=CPU)
    est3._solves = 10
    est3._update_iter_budget(1.0)
    assert est3._iters_current == 8 and est3.budget_overruns == 0
    assert est3.solve_info["solve_block_s"] == 1.0


# ---------------------------------------------------------------------------
# LPS table and LiDAR hooks
# ---------------------------------------------------------------------------

def test_lps_table_matches_reference():
    """The same localizer messages and window times give the same LPS
    rows; a message arms exactly one solve."""
    times = [0.0, 0.1, 0.2, 0.45, 0.55, 0.6, 0.7]
    rng = np.random.default_rng(5)
    msgs = []
    for t in (0.05, 0.15, 0.3, 0.5, 0.58, 0.58, 0.69, 0.9):
        q = rng.normal(size=4).astype(np.float32)
        msgs.append((t, rng.normal(size=3).astype(np.float32),
                     q / np.linalg.norm(q)))
    jest = jvio.VIOEstimator(jconfig.SystemConfig())
    test = tvio.VIOEstimator(SystemConfig(), device=CPU)
    for e in (jest, test):
        e.times = list(times)
        e.lps_list = list(msgs[-7:])
        e._lps_fresh = True
    tj = jax.tree.map(np.asarray, jest._build_lps_table())
    tt = test._build_lps_table()
    for name in ("ids", "alpha", "q_meas", "active"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      getattr(tj, name), err_msg=name)
    assert int(tt.active.sum()) == 5
    again = test._build_lps_table()      # not fresh: nothing armed
    assert not bool(again.active.any())
    np.testing.assert_array_equal(again.q_meas[:, 0].numpy(), 1.0)


def test_lidar_waits_for_slice_four():
    """Without a LiDAR front end a sweep gives None and a localizer message
    is dropped; enable_lidar (slice 4) builds one, once, on the
    estimator's device, and sweeps still wait for NON_LINEAR."""
    est = tvio.VIOEstimator(SystemConfig(), device=CPU)
    assert est.process_lidar(0.0, np.zeros((4, 3)), np.zeros(4),
                             np.ones(4, bool)) is None
    est.process_lps(0.0, np.zeros(3), np.array([1.0, 0, 0, 0]))
    assert est.lps_list == []
    est.enable_lidar()
    first = est.lidar
    est.enable_lidar()
    assert est.lidar is first and first.device.type == "cpu"
    assert est.process_lidar(0.0, np.zeros((4, 3)), np.zeros(4),
                             np.ones(4, bool)) is None
    est.process_lps(0.0, np.zeros(3), np.array([1.0, 0, 0, 0]))
    assert len(est.lps_list) == 1


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        assert tvio.VIOEstimator(SystemConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tvio.VIOEstimator(SystemConfig())
    assert tvio.VIOEstimator(SystemConfig(),
                             device=CPU).state.p.device.type == "cpu"
