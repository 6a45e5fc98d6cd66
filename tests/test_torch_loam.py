"""Parity of the port's LOAM ops with the JAX reference on synthetic
sweeps of 16 × 480 points (the size tests/test_local_mapping.py uses).
Each test feeds the same seeded numpy inputs to both packages.

Tolerances, and why:
* integer results (ring ids, voxel bucket ids, grid layout, feature
  masks) are held exactly;
* elementwise fp32 math (deskew, rel_time, eigenvalues) within 1e-5 of
  the values' scale: the two frameworks round transcendental functions
  and short sums differently in the last bits;
* correspondences: a single sweep's map is scan lines, so most 5-point
  plane clusters are near-collinear and their 3×3 fits have condition
  numbers of 1e3–1e4.  The frameworks sum the small contractions in
  another order (XLA on the CPU chains FMAs), and the fit amplifies that:
  normals are held to 200·cond·ε₃₂ (the solve's forward-error bound;
  observed ≤ 100·cond·ε), and the plane gates (`dist_nb < 0.2`,
  `λ1 > 10 λ0`) may flip on ≤ 3 % of rows, the count tolerance of the
  slice test;
* scan_to_map: the reference itself moves by up to 1.9 mm (default path)
  and 5.7 mm (intensity path) when the map is scaled by one ulp, and the
  port by as much; poses are held within 5e-3 m (default) and 1.5e-2 m
  (intensity), 2e-3 rad, counts within 3 %.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu.config import SystemConfig
from mvil_fusion_tpu.frontend import lidar_compensator as jcomp
from mvil_fusion_tpu.io.synthetic import SyntheticTrajectory, _quat_to_mat
from mvil_fusion_tpu.io.synthetic_lidar import BoxWorld, simulate_sweep
from mvil_fusion_tpu.ops import deskew as jdsk
from mvil_fusion_tpu.ops import loam_features as jlf
from mvil_fusion_tpu.ops import loam_icp as jicp
from mvil_fusion_tpu.ops import voxel as jvox
from mvil_fusion_tpu.utils import lie as jlie
from mvil_fusion_torch import config as tconfig
from mvil_fusion_torch.frontend import lidar_compensator as tcomp
from mvil_fusion_torch.ops import deskew as tdsk
from mvil_fusion_torch.ops import loam_features as tlf
from mvil_fusion_torch.ops import loam_icp as ticp
from mvil_fusion_torch.ops import voxel as tvox
from mvil_fusion_torch.utils import lie as tlie
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401


TRAJ = SyntheticTrajectory(duration=8.0, w_amp=(0.2, 0.15, 0.4),
                           w_freq=(0.2, 0.15, 0.25),
                           p_amp=(1.5, 1.2, 0.3), p_freq=(0.2, 0.25, 0.15),
                           lin_vel=(0.5, 0.25, 0.0))
N_AZ = 480


def _j(x, dtype=None):
    return jnp.asarray(np.asarray(x) if dtype is None
                       else np.asarray(x, dtype))


def _t(x, dtype=None):
    a = np.array(x) if dtype is None else np.array(x, dtype)
    return torch.as_tensor(a)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_sweeps():
    """Two raw sweeps and the JAX package's deskewed points and features,
    which the scan-to-map tests feed to both packages."""
    out = []
    for t0 in (1.0, 1.6):
        s = simulate_sweep(BoxWorld(), TRAJ, t0, n_azimuth=N_AZ)
        p0, q0 = TRAJ.pose_at(t0)
        p1, q1 = TRAJ.pose_at(t0 + 0.1)
        poses = [np.asarray(v, np.float32) for v in (p0, q0, p1, q1)]
        pts = jdsk.deskew_to_end(_j(s["pts"]), _j(s["rel_time"]),
                                 *[_j(v) for v in poses], 0.1)
        grid, occ, ig = jlf.organize_grid(pts, _j(s["ring"]),
                                          _j(s["rel_time"]), _j(s["mask"]),
                                          16, N_AZ, 0.1,
                                          intensity=_j(s["rel_time"]))
        feats = jlf.extract(grid, occ, ig)
        out.append(dict(raw=s, poses=poses, pts=np.asarray(pts),
                        feats=[np.asarray(f) for f in feats]))
    return out


@pytest.fixture(scope="module")
def sweeps():
    return make_sweeps()


# ---------------------------------------------------------------- deskew

def test_deskew_to_end_matches_jax(sweeps):
    s, poses = sweeps[1]["raw"], sweeps[1]["poses"]
    pj = jdsk.deskew_to_end(_j(s["pts"]), _j(s["rel_time"]),
                            *[_j(v) for v in poses], 0.1)
    pt = tdsk.deskew_to_end(_t(s["pts"]), _t(s["rel_time"]),
                            *[_t(v) for v in poses], 0.1)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=1e-5 * np.abs(s["pts"]).max())
    # and the motion is undone: points land on the true end-frame cloud
    # (to ~1 cm: the interpolation is linear in time, the path is curved)
    m = s["mask"]
    assert np.abs(pt.numpy()[m] - s["pts_true_end"][m]).max() < 0.02


@pytest.mark.parametrize("table", [False, True])
def test_ring_and_time_matches_jax(rng, table):
    pts = rng.normal(size=(4000, 3)).astype(np.float32) * [20, 20, 3]
    pts = pts.astype(np.float32)
    tab = jcomp.SENSOR_ELEV_TABLES["hdl64"] if table else None
    n_rings = 64 if table else 16
    rj, tj, okj = jdsk.ring_and_time(_j(pts), n_rings, 0.1,
                                     start_azimuth=0.3,
                                     elev_table_deg=None if tab is None
                                     else _j(tab))
    rt, tt, okt = tdsk.ring_and_time(_t(pts), n_rings, 0.1,
                                     start_azimuth=0.3,
                                     elev_table_deg=None if tab is None
                                     else _t(tab))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("sensor,infer_start", [("leishen_c16", False),
                                                ("leishen_c16", True),
                                                ("hdl64", False)])
def test_lidar_compensator_matches_jax(sweeps, sensor, infer_start):
    cfg = SystemConfig()
    cfg = dataclasses.replace(cfg, lidar=dataclasses.replace(
        cfg.lidar, infer_start_ori=infer_start))
    tcfg = tconfig.SystemConfig(lidar=tconfig.LidarConfig(
        infer_start_ori=infer_start))
    cj = jcomp.LidarCompensator(cfg, sensor=sensor)
    ct = tcomp.LidarCompensator(tcfg, sensor=sensor, device="cpu")
    for sw in sweeps:
        s = sw["raw"]
        oj = cj.process(1.0, s["pts"], s["mask"])
        ot = ct.process(1.0, s["pts"], s["mask"])
        np.testing.assert_array_equal(ot.ring.numpy(), np.asarray(oj.ring))
        np.testing.assert_array_equal(ot.mask.numpy(), np.asarray(oj.mask))
        np.testing.assert_allclose(ot.rel_time.numpy(),
                                   np.asarray(oj.rel_time), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(ot.intensity.numpy(),
                                   np.asarray(oj.intensity), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(ot.pts.numpy(), np.asarray(oj.pts))
    assert ct._start_hist == cj._start_hist


# ----------------------------------------------------------------- voxel

@pytest.mark.parametrize("table_size", [1 << 17, 1000003, 4096])
def test_hash_coords_exact(rng, table_size):
    """Bucket ids equal bit for bit, including int32 products that wrap
    and a hash of exactly INT_MIN (|INT_MIN| stays INT_MIN)."""
    c = rng.integers(-200000, 200000, (5000, 3)).astype(np.int32)
    c[:10] = rng.integers(-300, 300, (10, 3))
    c[10] = [np.iinfo(np.int32).min, 0, 0]    # hashes to INT_MIN
    c[11] = [np.iinfo(np.int32).max, -1, 7]
    hj = np.asarray(jvox.hash_coords(_j(c), table_size))
    assert hj.min() >= 0 and hj.max() < table_size
    ht = tvox.hash_coords(_t(c), table_size).numpy()
    np.testing.assert_array_equal(ht, hj)


def test_voxel_coords_exact(rng):
    pts = rng.uniform(-60, 60, (5000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tvox.voxel_coords(_t(pts), 0.4).numpy(),
        np.asarray(jvox.voxel_coords(_j(pts), 0.4)))


@pytest.mark.parametrize("channels,max_out,table_size", [
    (3, 4096, 1 << 17),        # rolling-map insert shape
    (4, 4096, 1 << 17),        # surf map + intensity channel
    (3, 300, 1 << 10),         # overflow + bucket collisions
])
def test_voxel_downsample_matches_jax(rng, channels, max_out, table_size):
    pts = rng.uniform(-12, 12, (6000, channels)).astype(np.float32)
    mask = rng.uniform(size=6000) > 0.3
    dj = jvox.voxel_downsample(_j(pts), _j(mask), 0.4, max_out,
                               table_size=table_size)
    dt = tvox.voxel_downsample(_t(pts), _t(mask), 0.4, max_out,
                               table_size=table_size)
    np.testing.assert_array_equal(dt.mask.numpy(), np.asarray(dj.mask))
    # centroid sums may be taken in another order: last-bit differences
    np.testing.assert_allclose(dt.pts.numpy(), np.asarray(dj.pts), rtol=0,
                               atol=1e-5)


def _sym3(rng, n):
    a = rng.normal(size=(n, 5, 3)).astype(np.float32) * [1.0, 0.3, 0.05]
    a = a.astype(np.float32)
    c = a - a.mean(axis=1, keepdims=True)
    return np.einsum("nki,nkj->nij", c, c).astype(np.float32) / 5


def test_sym3_eigvals_matches_jax(rng):
    A = _sym3(rng, 2000)
    lj = [np.asarray(x) for x in jvox.sym3_eigvals(_j(A))]
    lt = [x.numpy() for x in tvox.sym3_eigvals(_t(A))]
    scale = np.abs(lj[2]).max()
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)
    # ordering and agreement with a float64 eigen solver
    ev = np.linalg.eigvalsh(A.astype(np.float64))
    np.testing.assert_allclose(np.stack(lt, -1), ev, rtol=0,
                               atol=1e-4 * scale)


def test_sym3_eigvec_matches_jax(rng):
    A = _sym3(rng, 2000)
    l0j, l1j, _ = jvox.sym3_eigvals(_j(A))
    vj = np.asarray(jvox.sym3_eigvec(_j(A), l0j, l1j, [1.0, 0.0, 0.0]))
    l0t, l1t, _ = tvox.sym3_eigvals(_t(A))
    vt = tvox.sym3_eigvec(_t(A), l0t, l1t, [1.0, 0.0, 0.0]).numpy()
    # an eigenvector's sign is arbitrary; compare up to sign
    sgn = np.sign(np.sum(vt * vj, axis=1, keepdims=True))
    np.testing.assert_allclose(vt * sgn, vj, rtol=0, atol=1e-4)


# ---------------------------------------------------------- LOAM features

def test_organize_grid_exact(sweeps):
    for sw in sweeps:
        s = sw["raw"]
        inten = np.arange(len(s["mask"]), dtype=np.float32) * 1e-3
        gj = jlf.organize_grid(_j(sw["pts"]), _j(s["ring"]),
                               _j(s["rel_time"]), _j(s["mask"]), 16, N_AZ,
                               0.1, intensity=_j(inten))
        gt = tlf.organize_grid(_t(sw["pts"]), _t(s["ring"]),
                               _t(s["rel_time"]), _t(s["mask"]), 16, N_AZ,
                               0.1, intensity=_t(inten))
        for a, b in zip(gt, gj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # grid narrower than the sweep: overflow points drop the same way
    gj = jlf.organize_grid(_j(sw["pts"]), _j(s["ring"]), _j(s["rel_time"]),
                           _j(s["mask"]), 16, 256, 0.1)
    gt = tlf.organize_grid(_t(sw["pts"]), _t(s["ring"]), _t(s["rel_time"]),
                           _t(s["mask"]), 16, 256, 0.1)
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("use_i", [False, True])
def test_extract_matches_jax(sweeps, use_i):
    sw = sweeps[0]
    s = sw["raw"]
    inten = (s["ring"] + s["rel_time"]).astype(np.float32)
    gj = jlf.organize_grid(_j(sw["pts"]), _j(s["ring"]), _j(s["rel_time"]),
                           _j(s["mask"]), 16, N_AZ, 0.1,
                           intensity=_j(inten))
    fj = jlf.extract(*gj, use_intensity_mask=use_i)
    ft = tlf.extract(*[_t(np.asarray(g)) for g in gj],
                     use_intensity_mask=use_i)
    for name in ("sharp", "less_sharp", "flat", "less_flat"):
        mj = np.asarray(getattr(fj, name + "_mask"))
        mt = getattr(ft, name + "_mask").numpy()
        np.testing.assert_array_equal(mt, mj, err_msg=name)
        assert mj.sum() > 0, name
        # masked picks may differ among ties; held points are the same
        np.testing.assert_array_equal(getattr(ft, name).numpy()[mt],
                                      np.asarray(getattr(fj, name))[mj])
    np.testing.assert_array_equal(ft.less_flat_i.numpy(),
                                  np.asarray(fj.less_flat_i))


# --------------------------------------------------------- scan-to-map

def _map_and_source(sweeps, perturb=True):
    """Map = sweep-0 less-sharp/less-flat features in the world frame;
    source = sweep-1 features; initial pose = truth, perturbed."""
    f0, f1 = sweeps[0]["feats"], sweeps[1]["feats"]
    p0, q0 = sweeps[0]["poses"][2:]
    p1, q1 = sweeps[1]["poses"][2:]
    R0 = _quat_to_mat(q0)
    cmap = (f0[2] @ R0.T + p0).astype(np.float32)
    smap = (f0[6] @ R0.T + p0).astype(np.float32)
    q_init, p_init = q1, p1
    if perturb:
        q_init = np.asarray(jlie.quat_boxplus(_j(q1), _j([0.02, -0.03,
                                                          0.04], np.float32)))
        p_init = (p1 + np.float32([0.15, -0.1, 0.08])).astype(np.float32)
    smap_i = np.linalg.norm(smap, axis=1).astype(np.float32) % 3.0
    flat_i = np.linalg.norm(f1[6], axis=1).astype(np.float32) % 3.0
    args = [f1[0], f1[1], f1[6], f1[7], cmap, f0[3], smap, f0[7],
            np.asarray(p_init, np.float32), np.asarray(q_init, np.float32)]
    return args, (p1, q1), (flat_i, smap_i)


def _fit_condition(sw_j, smap, smap_mask, k=5):
    """fp64 condition number of each plane fit's ridge-regularized normal
    equations, from the reference's own 5 nearest map points."""
    idx, _ = jicp.knn(sw_j, _j(smap), _j(smap_mask), k)
    nb = smap[np.asarray(idx)].astype(np.float64)
    AtA = np.einsum("nki,nkj->nij", nb, nb)
    tr = np.trace(AtA, axis1=1, axis2=2)
    return np.linalg.cond(AtA + (1e-5 * tr + 1e-6)[:, None, None]
                          * np.eye(3))


@pytest.mark.parametrize("use_i", [False, True])
def test_find_correspondences_matches_jax(sweeps, use_i):
    args, _, (fi, mi) = _map_and_source(sweeps, perturb=False)
    kw_j = dict(surf_i=_j(fi), surf_map_i=_j(mi)) if use_i else {}
    kw_t = dict(surf_i=_t(fi), surf_map_i=_t(mi)) if use_i else {}
    cj = jicp.find_correspondences(*[_j(a) for a in args], **kw_j)
    ct = ticp.find_correspondences(*[_t(a) for a in args], **kw_t)
    for kind, n_min in (("edge", 20), ("plane", 300)):
        okj = np.asarray(getattr(cj, kind + "_ok"))
        okt = getattr(ct, kind + "_ok").numpy()
        assert okj.sum() > n_min, (kind, okj.sum())
        assert (okj != okt).mean() <= 0.03, kind
    both = np.asarray(cj.edge_ok) & ct.edge_ok.numpy()
    for f in ("edge_a", "edge_b"):
        np.testing.assert_allclose(getattr(ct, f).numpy()[both],
                                   np.asarray(getattr(cj, f))[both],
                                   rtol=0, atol=1e-4)
    if not use_i:
        both = np.asarray(cj.plane_ok) & ct.plane_ok.numpy()
        sw = jlie.quat_rotate(_j(args[9])[None], _j(args[2])) + _j(args[8])
        cond = _fit_condition(sw, args[6], args[7])[both]
        dn = np.abs(ct.plane_n.numpy() - np.asarray(cj.plane_n))[both]
        assert np.all(dn.max(axis=1) <= 200 * cond * np.finfo(np.float32).eps)


@pytest.mark.parametrize("use_i,tol", [(False, 5e-3), (True, 1.5e-2)])
def test_scan_to_map_matches_jax(sweeps, use_i, tol):
    args, (p1, q1), (fi, mi) = _map_and_source(sweeps)
    kw_j = dict(surf_i=_j(fi), surf_map_i=_j(mi)) if use_i else {}
    kw_t = dict(surf_i=_t(fi), surf_map_i=_t(mi)) if use_i else {}
    rj = jicp.scan_to_map(*[_j(a) for a in args], outer_iters=3, gn_iters=4,
                          **kw_j)
    rt = ticp.scan_to_map(*[_t(a) for a in args], outer_iters=3, gn_iters=4,
                          **kw_t)
    pj, qj, pt, qt = (_np(x) for x in (rj[0], rj[1], rt[0], rt[1]))
    assert np.linalg.norm(pt - pj) < tol
    dq = _np(tlie.quat_boxminus(_t(qt), _t(qj)))
    assert np.linalg.norm(dq) < 2e-3
    for a, b in ((rt[2], rj[2]), (rt[3], rj[3])):
        assert abs(int(a) - int(b)) <= 0.03 * int(b)
    # and the port itself recovers the true pose, as the reference does
    assert np.linalg.norm(pt - p1) < 0.05
