"""The port's LiDAR front end of the estimator
(``mvil_fusion_torch/estimator/lidar_frontend.py``) against the JAX
package's: ``sweep_full`` against ``_sweep_full_jit`` on three sweeps of
16 × 360 points (hash tables of 2^14) of tests/test_vil_e2e.py's excited
trajectory, expressed in the frame of the default LiDAR-IMU extrinsic;
``lidar_align`` on tests/test_li_calibration.py's 40 pairs and on pairs
that no extrinsic fits; the host bookkeeping (``_apply_sweep_pack``,
``fill_constraint_tables``) fed the same packs; and
tests/test_vil_e2e.py's stationary two-sweep case on both estimators.

Tolerances, set from measurement.  The deskewed points agree within 1e-5
m (measured 6.2e-6: rounding of the interpolated poses), the downsample
masks exactly (measured 0 flips; up to 0.5 % allowed, the share of points
that sit within 1e-5 m of a voxel face), their centroids within 1e-5 m.
The pack's entries that do not come from the registration (relative VIO
motions, sweep-end poses) agree within 1e-5.  The registration block
(pose, fitness, correspondences, and the body-frame measurement derived
from it) is held two ways: on the same voxel maps (the JAX package's,
handed to the port) within 1e-5 and with equal correspondence counts
(measured 6e-8 m); on each package's own maps within 2.5 cm, 0.3° and 1 %
of the correspondences (measured up to 1.2 cm): the Gaussian maps' plane
normals are rounding noise on flat voxels (see tests/test_torch_vgicp.py),
and a few correspondences change with them.  The constraint modes are
equal.  ``lidar_align`` within 1e-4 in the extrinsic; where no extrinsic
fits the data, the rotation within 1e-3 rad (measured 3.9e-4: the cost
is flat about its minimum).  The host bookkeeping exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu import config as jconfig
from mvil_fusion_tpu.estimator import lidar_frontend as jlf
from mvil_fusion_tpu.estimator import vio as jvio
from mvil_fusion_tpu.io.synthetic import SyntheticTrajectory
from mvil_fusion_tpu.io.synthetic_lidar import BoxWorld, simulate_sweep
from mvil_fusion_tpu.utils import lie as jlie
from mvil_fusion_torch.config import LidarConfig, SystemConfig
from mvil_fusion_torch.estimator import lidar_frontend as tlf
from mvil_fusion_torch.estimator import vio as tvio
from mvil_fusion_torch.ops import voxel as tvox
from mvil_fusion_torch.utils import lie as tlie
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

CPU = "cpu"
N_AZ = 360
TABLE = 1 << 14
LC = LidarConfig(rlb=(1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0), tlb=(0.0, 0.0, 0.0),
                 vgicp_iters=8, vgicp_table_size=TABLE,
                 downsample_table_size=TABLE)
STATIC = dict(scan_period=0.1, leaf_size=LC.leaf_size,
              vgicp_resolution=LC.vgicp_resolution, iters=LC.vgicp_iters,
              max_corr_dist=LC.max_corr_dist, ds_table=TABLE, vg_table=TABLE)
TRAJ = SyntheticTrajectory(duration=6.0, w_amp=(0.5, 0.45, 0.55),
                           w_freq=(0.4, 0.33, 0.47), p_amp=(1.2, 1.0, 0.4),
                           p_freq=(0.33, 0.41, 0.23))
TIMES = [1.0 + 0.1 * k for k in range(7)]
SWEEPS = (1.12, 1.32, 1.42)
# the default extrinsic of LidarConfig, in which the sweeps are expressed
RLB = np.asarray(jconfig.LidarConfig().rlb, np.float32).reshape(3, 3)
TLB = np.asarray(jconfig.LidarConfig().tlb, np.float32)


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def jax_config(cfg: SystemConfig) -> jconfig.SystemConfig:
    """The JAX package's SystemConfig with the port config's estimator,
    IMU and LiDAR fields."""
    sec = lambda name, cls: dataclasses.replace(  # noqa: E731
        cls(), **dataclasses.asdict(getattr(cfg, name)))
    return jconfig.SystemConfig(
        estimator=sec("estimator", jconfig.EstimatorConfig),
        imu=sec("imu", jconfig.ImuConfig),
        lidar=sec("lidar", jconfig.LidarConfig))


def to_torch_map(m) -> tvox.GaussianVoxelMap:
    return tvox.GaussianVoxelMap(
        mean=T(m.mean), cov=T(m.cov), count=T(m.count),
        coords=T(m.coords, torch.int32), leaf=float(m.leaf),
        table_size=int(m.table_size))


def brackets(t_start, prev):
    """idx (3,2) and alphas (3,) of a sweep on the window TIMES."""
    def br(t):
        i = int((t - TIMES[0]) / 0.1 + 1e-6)
        return (i, i + 1), (t - TIMES[i]) / 0.1
    (bs, a_s), (be, a_e) = br(t_start), br(t_start + 0.1)
    bp, a_p = br(prev) if prev is not None else ((0, 1), 0.0)
    return (np.asarray([bs, be, bp], np.int32),
            np.asarray([a_s, a_e, a_p], np.float32))


@pytest.fixture(scope="module")
def runs():
    """The three sweeps through both packages' sweep_full in turn, each
    against its own previous map; and the port's sweep_full again on the
    JAX package's maps."""
    P = np.asarray([TRAJ.pose_at(t)[0] for t in TIMES], np.float32)
    Q = np.asarray([TRAJ.pose_at(t)[1] for t in TIMES], np.float32)
    q_lb = np.asarray(jlie.mat_to_quat(jnp.asarray(RLB)))
    empty = jlf.LidarFrontend(jax_config(SystemConfig(lidar=LC)))._empty_vmap()
    out, prev_t, prev_j, prev_end = [], None, None, None
    for t0 in SWEEPS:
        s = simulate_sweep(BoxWorld(), TRAJ, t0, n_azimuth=N_AZ)
        pts = ((s["pts"] - TLB) @ RLB).astype(np.float32)   # lidar frame
        idx, al = brackets(t0, prev_end)
        has = prev_j is not None
        rj = jlf._sweep_full_jit(
            jnp.asarray(pts), jnp.asarray(s["rel_time"]),
            jnp.asarray(s["mask"]), jnp.asarray(P), jnp.asarray(Q),
            jnp.asarray(idx), jnp.asarray(al), jnp.zeros(3),
            jnp.asarray([1.0, 0, 0, 0]), jnp.asarray(has), jnp.asarray(has),
            prev_j[3] if has else empty, jnp.asarray(q_lb),
            jnp.asarray(TLB), jnp.asarray(RLB), **STATIC)
        rj = [x if isinstance(x, jlf.voxel.GaussianVoxelMap)
              else np.asarray(x) for x in rj]
        args = (T(pts), T(s["rel_time"]), T(s["mask"], torch.bool), T(P),
                T(Q), idx, T(al), None, None, has, has)
        ext = (T(q_lb), T(TLB), T(RLB))
        rt = tlf.sweep_full(*args, prev_t[3] if has else None, *ext,
                            **STATIC)
        same = None
        if has:
            real = tvox.build_gaussian_voxel_map
            tvox.build_gaussian_voxel_map = \
                lambda *a, **k: to_torch_map(rj[3])
            try:
                same = tlf.sweep_full(*args, to_torch_map(prev_j[3]), *ext,
                                      **STATIC)
            finally:
                tvox.build_gaussian_voxel_map = real
        out.append((rj, rt, same, s["mask"]))
        prev_t, prev_j, prev_end = rt, rj, t0 + 0.1
    return out


def test_sweep_full_first_sweep(runs):
    rj, rt, _, mask = runs[0]
    assert mask.sum() > 0.9 * mask.size
    np.testing.assert_allclose(rt[0].numpy(), rj[0], rtol=0, atol=1e-5)
    for k in (1, 4):                  # the 8192 and the 4096 downsample
        mj, mt = rj[k + 1], rt[k + 1].numpy()
        assert (mj != mt).mean() <= 5e-3 and mj.sum() > 1000
        both = mj & mt
        np.testing.assert_allclose(rt[k].numpy()[both], rj[k][both],
                                   rtol=0, atol=1e-5)
    for k in range(6, 10):            # pl_e, ql_e, p_be, q_be
        np.testing.assert_allclose(rt[k].numpy(), rj[k], rtol=0, atol=1e-5)
    assert not rt[10].any() and not rj[10].any()


ICP = np.r_[0:11, 18:25]               # the registration block of the pack
VIO = np.r_[11:18, 25:46]              # VIO motions and sweep-end poses


@pytest.mark.parametrize("k", [1, 2])
def test_sweep_full_registers_against_the_previous_sweep(runs, k):
    rj, rt, same, _ = runs[k]
    np.testing.assert_allclose(rt[0].numpy(), rj[0], rtol=0, atol=1e-5)
    pj, pt, ps = rj[10], rt[10].numpy(), same[10].numpy()
    np.testing.assert_allclose(pt[VIO], pj[VIO], rtol=0, atol=1e-5)
    # on the same maps: the whole pack
    np.testing.assert_allclose(ps[ICP], pj[ICP], rtol=0, atol=1e-5)
    assert ps[8] == pj[8] and ps[46] == pj[46]
    # on each package's own maps
    np.testing.assert_allclose(pt[0:3], pj[0:3], rtol=0, atol=2.5e-2)
    np.testing.assert_allclose(pt[18:21], pj[18:21], rtol=0, atol=2.5e-2)
    for a, b in ((3, 7), (21, 25)):
        ang = tlie.quat_boxminus(T(pt[a:b]), T(pj[a:b])).norm()
        assert float(ang) < np.radians(0.3)
    assert abs(pt[8] - pj[8]) <= 0.01 * pj[8]
    assert pt[9] == pj[9] and abs(pt[7] - pj[7]) < 5e-3
    # the same decisions: mode 2 for both (an agreeing registration)
    modes = []
    for pack in (pj, pt):
        fe = tlf.LidarFrontend(SystemConfig(lidar=LC), device=CPU)
        prev = cur = tlf.KeySweep(0.0, None, None, None, None, None,
                                  (1.0, 1.1), None, None)
        modes.append(fe._apply_sweep_pack(pack, prev, cur))
    assert modes == [2, 2]


# ---------------------------------------------------------------------------
# lidar_align
# ---------------------------------------------------------------------------

def calibration_pairs(seed=0, n=40):
    """tests/test_li_calibration.py's pairs: (q_l, t_l, t_b, q_b) of n
    relative motions under the extrinsic q_lb_true, t_lb_true."""
    rng = np.random.default_rng(seed)
    q_lb_true = jlie.quat_exp(jnp.asarray([0.03, -0.02, 0.05], jnp.float32))
    t_lb_true = np.asarray([0.12, -0.01, -0.13], np.float32)
    R_lb = np.asarray(jlie.quat_to_mat(q_lb_true))
    q_b, t_b, q_l, t_l = [], [], [], []
    for _ in range(n):
        phi = rng.normal(scale=0.3, size=3).astype(np.float32)
        tb = rng.normal(scale=0.4, size=3).astype(np.float32)
        qb = jlie.quat_exp(jnp.asarray(phi))
        Rb = np.asarray(jlie.quat_to_mat(qb))
        Rl = R_lb.T @ Rb @ R_lb
        tl = R_lb.T @ (Rb @ t_lb_true + tb - t_lb_true)
        q_b.append(np.asarray(qb))
        t_b.append(tb)
        q_l.append(np.asarray(jlie.mat_to_quat(jnp.asarray(Rl, jnp.float32))))
        t_l.append(tl.astype(np.float32))
    return [np.asarray(a, np.float32) for a in (q_l, t_l, t_b, q_b)]


@pytest.mark.parametrize("case", ["consistent", "no extrinsic fits"])
def test_lidar_align_matches_reference(case):
    q_l, t_l, t_b, q_b = calibration_pairs()
    if case == "no extrinsic fits":
        t_l = t_l + np.random.default_rng(1).normal(
            scale=1.0, size=t_l.shape).astype(np.float32)
    lo, hi = [-0.3, -0.3, -0.3], [0.3, 0.3, 0.3]
    qj, tj, okj = jlf.lidar_align(
        jnp.asarray(q_l), jnp.asarray(t_l), jnp.asarray(t_b),
        jnp.asarray(q_b), jlie.quat_identity(), jnp.asarray(lo),
        jnp.asarray(hi))
    qt, tt, okt = tlf.lidar_align(T(q_l), T(t_l), T(t_b), T(q_b),
                                  tlie.quat_identity(), lo, hi)
    assert okt == okj == (case == "consistent")
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-4)
    ang = tlie.quat_boxminus(qt, T(np.asarray(qj))).norm()
    assert float(ang) < (1e-4 if okt else 1e-3)
    if okt:
        # tests/test_li_calibration.py's gate, on the port
        R = tlie.quat_to_mat(qt).numpy()
        Rl = tlie.quat_to_mat(T(q_l)).numpy()
        pred = (np.eye(3) - Rl) @ tt.numpy() + t_b @ R.T
        assert np.linalg.norm(pred - t_l, axis=1).mean() < 0.02


# ---------------------------------------------------------------------------
# the host bookkeeping on the same packs
# ---------------------------------------------------------------------------

# (mode the pack is made for) per sweep: agreeing, drift-correcting, failed,
# zero-velocity and pure-rotation registrations; 35 of the 41 classified
# ones agree or drift-correct, so calibration runs at the 30th pair
PLAN = ([2, 3, 1, 2, 4, 2, 3, 5, 2, 2, 3, 4, 2, 1]
        + [2, 3] * 12 + [2, 4, 3, 2])


def make_packs():
    """One (47,) pack per PLAN entry, from calibration_pairs' motions."""
    q_l, t_l, t_b, q_b = calibration_pairs(n=len(PLAN))
    rng = np.random.default_rng(2)
    packs = []
    for k, mode in enumerate(PLAN):
        hp = np.zeros(47, np.float32)
        t_icp = t_l[k] if mode in (1, 2, 3) else t_l[k] * 1e-3
        hp[0:3], hp[3:7] = t_icp, q_l[k]
        hp[7] = 2.0 if mode == 1 else 0.02 + 0.05 * rng.uniform()
        hp[8], hp[9] = 900, 1500
        hp[10] = 2.0 if mode == 5 else 0.1
        hp[11:14] = t_icp + (0.2 if mode == 3 else 0.01)
        hp[18:21] = rng.normal(scale=0.3, size=3)
        hp[21:25] = q_b[k]
        hp[25:29], hp[29:32] = q_b[k], t_b[k]
        hp[46] = 1.0
        packs.append(hp)
    return packs


def feed_packs(fe, packs, pose):
    """The packs into a front end through _apply_sweep_pack, sweep k
    ending at 0.55 + 0.1 k between frames 0.5 + 0.1 k and 0.6 + 0.1 k."""
    modes, sweeps = [], []
    for k, hp in enumerate(packs):
        t_end = 0.55 + 0.1 * k
        sweeps.append(tlf.KeySweep(
            t_end, None, None, None, None, None,
            (0.5 + 0.1 * k, 0.6 + 0.1 * k), *pose(k)))
        if k:
            modes.append(fe._apply_sweep_pack(hp.copy(), sweeps[k - 1],
                                              sweeps[k]))
    return modes


def test_sweep_bookkeeping_matches_reference():
    cfg = SystemConfig(lidar=dataclasses.replace(
        LidarConfig(), use_estimated_extrinsic=True))
    packs = make_packs()
    fj = jlf.LidarFrontend(jax_config(cfg))
    ft = tlf.LidarFrontend(cfg, device=CPU)
    assert not fj.calibrated and not ft.calibrated
    poses = [(np.asarray([0.1 * k, 0.0, 0.0], np.float32),
              np.asarray([1.0, 0, 0, 0], np.float32))
             for k in range(len(packs))]
    mj = feed_packs(fj, packs, lambda k: tuple(jnp.asarray(a)
                                               for a in poses[k]))
    mt = feed_packs(ft, packs, lambda k: tuple(T(a) for a in poses[k]))
    assert mj == mt == PLAN[1:]
    assert fj.mode_counts == ft.mode_counts
    assert fj.first_zv == ft.first_zv and fj.last_mode == ft.last_mode
    for a, b in zip(fj.zv_pose, ft.zv_pose):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert [dataclasses.astuple(r)[:7] for r in fj.constraints] == \
        [dataclasses.astuple(r)[:7] for r in ft.constraints]
    for rj, rt in zip(fj.constraints, ft.constraints):
        np.testing.assert_array_equal(rt.trans_p, rj.trans_p)
        np.testing.assert_array_equal(rt.trans_q, rj.trans_q)
        assert rt.weight == rj.weight
    # calibration ran at the 30th pair, with the same result.  (Not the
    # extrinsic the pairs were made with, in either package: the hand-eye
    # rotation solves q_b ⊗ q_lb = q_lb ⊗ q_l, while lidar_align's rotation
    # rows take R_l = R_lb R_b R_lbᵀ, so the chained solve ends at the
    # box bounds of the translation.)
    assert fj.calibrated and ft.calibrated
    assert len(ft.calib_q_b) == len(fj.calib_q_b) == 30
    np.testing.assert_allclose(ft.tlb, np.asarray(fj.tlb), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ft.rlb, np.asarray(fj.rlb), rtol=0,
                               atol=1e-4)
    # the constraint tables on two windows, one that drops old brackets
    for t0 in (0.5 + 0.1 * (len(PLAN) - 7), 0.5 + 0.1 * (len(PLAN) - 4)):
        window = [t0 + 0.1 * k for k in range(7)]
        tabs = []
        for fe in (fj, ft):
            ids = np.zeros((5, 4), np.int64)
            a_i, a_j, w = (np.zeros(5, np.float32) for _ in range(3))
            tp = np.zeros((5, 3), np.float32)
            act = np.zeros(5, bool)
            zv = fe.fill_constraint_tables(window, ids, a_i, a_j, tp, w, act)
            tabs.append((zv, ids, a_i, a_j, tp, w, act))
        assert tabs[0][0] == tabs[1][0]
        for x, y in zip(tabs[0][1:], tabs[1][1:]):
            np.testing.assert_array_equal(x, y)
        # the same rows as device tables
        (icp_j, zv_j), (icp_t, zv_t) = (fe.build_constraints(window)
                                        for fe in (fj, ft))
        assert zv_j == zv_t == tabs[1][0]
        for name in icp_t._fields:
            np.testing.assert_array_equal(getattr(icp_t, name).numpy(),
                                          np.asarray(getattr(icp_j, name)))
    assert tabs[1][6].any()


def test_stationary_sweeps_give_zero_velocity_like_reference():
    """tests/test_vil_e2e.py::test_vil_zero_velocity_mode_on_stationary on
    both estimators: a hand-built stationary window, two sweeps."""
    traj = SyntheticTrajectory(duration=6.0, w_amp=(0.0, 0.0, 0.0),
                               p_amp=(0.0, 0.0, 0.0),
                               lin_vel=(0.0, 0.0, 0.0))
    cfg = SystemConfig(lidar=LC)
    jest = jvio.VIOEstimator(jax_config(cfg))
    test = tvio.VIOEstimator(cfg, device=CPU)
    packs = []
    for est in (jest, test):
        est.enable_lidar()
        est.status = est.NON_LINEAR
        est.times = [0.5 + 0.1 * k for k in range(est.W)]
        apply = est.lidar._apply_sweep_pack

        def keep(hp, prev, cur, apply=apply):
            packs.append(np.asarray(hp).copy())
            return apply(hp, prev, cur)
        est.lidar._apply_sweep_pack = keep
        modes = []
        for tl in (0.62, 0.82):
            s = simulate_sweep(BoxWorld(), traj, tl, n_azimuth=N_AZ)
            out = est.process_lidar(s["t_start"], s["pts"], s["rel_time"],
                                    s["mask"])
            modes.append(out["mode"])
        assert modes == [0, 4], modes
    pj, pt = packs
    np.testing.assert_allclose(pt[VIO], pj[VIO], rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt[0:3], pj[0:3], rtol=0, atol=2.5e-2)
    assert jest.lidar.first_zv == test.lidar.first_zv is False
    assert len(test.lidar.constraints) == 1
    assert test.lidar.constraints[0].mode == 4
