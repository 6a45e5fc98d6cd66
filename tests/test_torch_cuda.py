"""Tests of the port that need a CUDA card (marker ``cuda``; each skips
where ``torch.cuda.is_available()`` is false).  They import neither JAX
nor the JAX package and use no fixture of tests/conftest.py, so that they
run on a machine with the card but without JAX:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py

The kernel is held to its plain version with the tolerance of
tests/test_pallas_knn.py (d2 rtol 1e-4 / atol 1e-3 where finite, index
agreement ≥ 0.99 where finite); the slice on the card to the slice on the
CPU within 1e-2 m (float atomics and FMA contraction on the card sum in
another order, and the LOAM plane gates amplify that to mm-level pose
differences).  The global-mapping stage on the card is held to the stage
on the CPU: the same decisions, horizontal position within 2 cm, height
within 0.4 m, rotation within 4°.  Height, roll and pitch of that loop
hang on plane normals that are rounding noise (see
tests/test_torch_global_mapping.py): runs of the same code on an H100
differed by 2–7 mm horizontally and 3–20 cm in height.  The feature
tracker on the card is held to the tracker on the CPU step by step, each
step from the CPU's state and with the CPU's RANSAC samples: pixels within
0.05 px, at most 2 of the 256 slots differing in validity (a threshold
crossed by the card's fused multiply-adds); preintegration on the card to
the CPU's within 1e-5, J and P within 1e-4 of their largest entry.  The
frame step of mono VIO on the card (F = 64, chip_smoke.py's phase-10
window) is held to the step on the CPU with tests/test_torch_frame_step.py's
tolerances, and waits for the card three times: its two eigh and the
readback; triangulation alone never waits.
"""

import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.estimator import state as est_state
from mvil_fusion_torch.estimator import vio
from mvil_fusion_torch.frontend.feature_tracker import FeatureTracker
from mvil_fusion_torch.frontend.lidar_compensator import LidarCompensator
from mvil_fusion_torch.io.synthetic import SyntheticTrajectory
from mvil_fusion_torch.io.synthetic_lidar import BoxWorld, simulate_sweep
from mvil_fusion_torch.mapping.global_mapping import GlobalMapper
from mvil_fusion_torch.mapping.local_mapping import LocalMapper
from mvil_fusion_torch.ops import deskew
from mvil_fusion_torch.ops import knn_topk as K
from mvil_fusion_torch.ops import preintegration as pre
from mvil_fusion_torch.ops import ransac, scancontext, triangulate, voxel
from mvil_fusion_torch.utils import nplie

pytestmark = pytest.mark.cuda

SHAPES = [(100, 1000, 5), (256, 4096, 10), (37, 513, 3), (256, 16384, 5),
          (4096, 32768, 10), (256, 4096, 128), (1, 1, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _inputs(nq, nr, device, masked=0.2, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-60, 60, (nq, 3)).astype(np.float32)
    r = rng.uniform(-60, 60, (nr, 3)).astype(np.float32)
    m = rng.uniform(size=nr) >= masked
    return tuple(torch.as_tensor(a, device=device) for a in (q, r, m))


@pytest.mark.parametrize("nq,nr,k", SHAPES)
def test_kernel_matches_plain(cuda, nq, nr, k):
    q, r, m = _inputs(nq, nr, cuda)
    before = K.knn_topk_cuda.launches
    idx_c, d2_c = K.knn_topk_cuda(q, r, m, k)
    torch.cuda.synchronize()
    assert K.knn_topk_cuda.launches == before + 1
    idx_p, d2_p = K.knn_topk_plain(q, r, m, k)
    fin = torch.isfinite(d2_p)
    torch.testing.assert_close(d2_c[fin], d2_p[fin], rtol=1e-4, atol=1e-3)
    assert bool((d2_c[~fin] > 1e20).all())
    assert float((idx_c == idx_p)[fin].float().mean()) >= 0.99


def test_kernel_all_masked_and_short_reference(cuda):
    q, r, m = _inputs(64, 1024, cuda, masked=1.0)
    idx, d2 = K.knn_topk_cuda(q, r, m, 5)
    assert bool(torch.isinf(d2).all()) and bool((idx == 0).all())
    q, r, _ = _inputs(8, 3, cuda)
    m = torch.tensor([True, False, True], device=cuda)
    idx, d2 = K.knn_topk_cuda(q, r, m, 4)
    assert bool(torch.isfinite(d2[:, :2]).all())
    assert bool(torch.isinf(d2[:, 2:]).all()) and bool((idx[:, 2:] == 0).all())
    assert set(idx[:, :2].flatten().tolist()) <= {0, 2}


def test_kernel_breaks_ties_toward_lower_index(cuda):
    """Exact duplicates: the lower reference index comes first, as
    lax.top_k orders them."""
    base = torch.tensor([[1.0, 2.0, 3.0], [5.0, 5.0, 5.0], [1.0, 2.0, 3.0],
                         [9.0, 9.0, 9.0], [1.0, 2.0, 3.0]], device=cuda)
    ref = torch.cat([base, base]).contiguous()            # 10 refs
    mask = torch.ones(10, dtype=torch.bool, device=cuda)
    mask[0] = False
    q = torch.tensor([[1.0, 2.0, 3.0]], device=cuda)
    idx, d2 = K.knn_topk_cuda(q, ref, mask, 6)
    assert idx[0].tolist() == [2, 4, 5, 7, 9, 1]
    assert d2[0, :5].tolist() == [0.0] * 5


def _grid_inputs(nq, nr, device, masked=0.2, seed=0):
    """Points on a small integer grid: distances are exact in fp32 and
    mostly tied, so the kernel must equal the plain version exactly."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-4, 5, (nq, 3)).astype(np.float32)
    r = rng.integers(-4, 5, (nr, 3)).astype(np.float32)
    m = rng.uniform(size=nr) >= masked
    return tuple(torch.as_tensor(a, device=device) for a in (q, r, m))


@pytest.mark.parametrize("splits", [1, 2, 7, 64])
@pytest.mark.parametrize("nq,nr,k", [(256, 16384, 5), (37, 513, 3),
                                     (64, 4096, 10), (16, 2100, 40)])
def test_kernel_matches_plain_at_forced_splits(cuda, nq, nr, k, splits):
    q, r, m = _inputs(nq, nr, cuda)
    idx_c, d2_c = K.knn_topk_cuda(q, r, m, k, _splits=splits)
    torch.cuda.synchronize()
    idx_p, d2_p = K.knn_topk_plain(q, r, m, k)
    fin = torch.isfinite(d2_p)
    torch.testing.assert_close(d2_c[fin], d2_p[fin], rtol=1e-4, atol=1e-3)
    assert float((idx_c == idx_p)[fin].float().mean()) >= 0.99
    q, r, m = _grid_inputs(nq, nr, cuda)
    idx_c, d2_c = K.knn_topk_cuda(q, r, m, k, _splits=splits)
    idx_p, d2_p = K.knn_topk_plain(q, r, m, k)
    assert torch.equal(d2_c, d2_p) and torch.equal(idx_c, idx_p)


@pytest.mark.parametrize("case", ["ties across a boundary", "a masked slice",
                                  "fewer than k live refs in a slice",
                                  "live at the front only"])
def test_kernel_merges_slices_exactly(cuda, case):
    if case == "ties across a boundary":
        q, r, m = _grid_inputs(9, 64, cuda, masked=0.0)
        used, length = K.split_geometry(64, 2)
        r[length - 3:length + 3] = q[0]       # three on each side
        k, splits = 4, 2
        idx, d2 = K.knn_topk_cuda(q, r, m, k, _splits=splits)
        dup = torch.nonzero((r == q[0]).all(dim=1)).flatten()[:k]
        assert used == 2 and int(dup[0]) < length <= int(dup[-1])
        assert idx[0].tolist() == dup.tolist()
        assert d2[0].tolist() == [0.0] * k
    elif case == "a masked slice":
        q, r, m = _grid_inputs(16, 96, cuda)
        m[32:64] = False
        k, splits = 5, 3
    elif case == "fewer than k live refs in a slice":
        q, r, m = _grid_inputs(16, 128, cuda)
        m[:] = False
        m[[3, 40, 41, 70, 127]] = True
        k, splits = 4, 4
    else:
        q, r, m = _grid_inputs(24, 1000, cuda)
        m[150:] = False
        k, splits = 5, 6
    idx_c, d2_c = K.knn_topk_cuda(q, r, m, k, _splits=splits)
    idx_p, d2_p = K.knn_topk_plain(q, r, m, k)
    assert torch.equal(d2_c, d2_p) and torch.equal(idx_c, idx_p)
    assert bool((idx_c[torch.isinf(d2_c)] == 0).all())


def test_kernel_takes_a_view_off_the_copy_grid(cuda):
    """A reference that starts 12 bytes into a buffer is not 16-byte
    aligned; the wrapper realigns it."""
    q, r, m = _inputs(50, 1001, cuda)
    idx_v, d2_v = K.knn_topk_cuda(q, r[1:], m[1:], 4)
    idx_c, d2_c = K.knn_topk_cuda(q, r[1:].clone(), m[1:].clone(), 4)
    assert torch.equal(idx_v, idx_c) and torch.equal(d2_v, d2_c)


def test_default_device_is_the_card(cuda):
    cfg = SystemConfig()
    assert LocalMapper(cfg).device.type == "cuda"
    assert LidarCompensator(cfg).device.type == "cuda"
    assert LocalMapper(cfg).corner_map.is_cuda


def test_kernel_rejects_mixed_devices(cuda):
    q, r, m = _inputs(4, 16, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        K.knn_topk_cuda(q, r.cpu(), m, 3)


TRAJ = SyntheticTrajectory(duration=8.0, w_amp=(0.2, 0.15, 0.4),
                           w_freq=(0.2, 0.15, 0.25),
                           p_amp=(1.5, 1.2, 0.3), p_freq=(0.2, 0.25, 0.15),
                           lin_vel=(0.5, 0.25, 0.0))


def _drive(device, n=4, defer=False):
    """n sweeps of 16 × 480 points with drifting odometry through the
    slice on `device`; returns (mapped positions, submap flags, kernel
    launches)."""
    cfg = SystemConfig()
    comp = LidarCompensator(cfg, device=device)
    mapper = LocalMapper(cfg, device=device)
    mapper.defer_pack = defer
    rng = np.random.default_rng(0)
    drift = np.zeros(3)
    subs = []
    before = K.knn_topk_cuda.launches
    for i in range(n):
        t0 = 0.8 + 0.1 * i
        s = simulate_sweep(BoxWorld(), TRAJ, t0, n_azimuth=480)
        drift += rng.normal(scale=0.01, size=3)
        p0, q0 = TRAJ.pose_at(t0)
        p1, q1 = TRAJ.pose_at(t0 + 0.1)
        odom = [np.asarray(v, np.float32) for v in (p0 + drift, q0,
                                                    p1 + drift, q1)]
        sw = comp.process(t0, s["pts"], s["mask"])
        pts = deskew.deskew_to_end(
            sw.pts, sw.rel_time,
            *[torch.as_tensor(v, device=device) for v in odom], 0.1)
        subs.append(mapper.process_full(
            t0 + 0.1, pts, sw.ring, sw.rel_time, sw.mask, None, odom[2],
            odom[3], n_rings=16, n_azimuth=480, scan_period=0.1))
    if defer:
        subs = subs[1:] + [mapper.flush()]
    pos = np.array([p for _, p, _ in mapper.trajectory])
    return pos, [s is not None for s in subs], \
        K.knn_topk_cuda.launches - before


def test_slice_on_card_matches_cpu(cuda):
    pos_c, subs_c, launches = _drive(cuda)
    pos_h, subs_h, launches_h = _drive("cpu")
    assert launches == 6 * 4 and launches_h == 0
    assert subs_c == subs_h
    assert np.isfinite(pos_c).all()
    assert np.abs(pos_c - pos_h).max() < 1e-2


def test_deferred_sweep_queues_without_host_sync(cuda):
    """With its inputs on the card and the readback deferred, a sweep's
    deskew + process_full makes no host sync (torch.cuda's sync debug mode
    raises on one), so the host can queue a sweep while the card runs the
    last."""
    cfg = SystemConfig()
    comp = LidarCompensator(cfg, device=cuda)
    mapper = LocalMapper(cfg, device=cuda)
    mapper.defer_pack = True
    for i in range(3):
        t0 = 0.8 + 0.1 * i
        s = simulate_sweep(BoxWorld(), TRAJ, t0, n_azimuth=480)
        sw = comp.process(t0, s["pts"], s["mask"])
        odom = [torch.as_tensor(np.asarray(v, np.float32), device=cuda)
                for v in (*TRAJ.pose_at(t0), *TRAJ.pose_at(t0 + 0.1))]
        mapper.flush()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pts = deskew.deskew_to_end(sw.pts, sw.rel_time, *odom, 0.1)
            mapper.process_full(t0 + 0.1, pts, sw.ring, sw.rel_time, sw.mask,
                                None, odom[2], odom[3], n_rings=16,
                                n_azimuth=480, scan_period=0.1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    mapper.flush()
    assert len(mapper.trajectory) == 3


def test_deferred_mode_on_card(cuda):
    """Deferred readback through pinned memory and a CUDA event gives the
    sync run's rows (not bit-equal: the card's atomics vary)."""
    pos_s, subs_s, _ = _drive(cuda)
    pos_d, subs_d, _ = _drive(cuda, defer=True)
    assert subs_d == subs_s
    assert np.abs(pos_d - pos_s).max() < 1e-2


# ---------------------------------------------------------------------------
# global mapping
# ---------------------------------------------------------------------------

def _loop(n=16):
    """(config, keyed scans) of chip_smoke.py's square loop, one lap."""
    return chip_smoke.loop_config(), chip_smoke.make_loop_submaps(n=n)[0]


def _run_loop(device, cfg, subs):
    gm = GlobalMapper(cfg, device=device)
    infos = [gm.add_submap(sm) for sm in subs]
    return gm, infos


def test_global_stage_on_card_matches_cpu(cuda):
    cfg, subs = _loop()
    gc, ic = _run_loop(cuda, cfg, subs)
    gh, ih = _run_loop("cpu", cfg, subs)
    assert gc.scans.is_cuda and gc.graph.p.is_cuda and gc.sc_desc.is_cuda
    assert gc.mapping_stats() == gh.mapping_stats()
    assert gc.loops_closed >= 1 and gc.loop_pairs == gh.loop_pairs
    assert gc.floor_ids == gh.floor_ids
    for a, b in zip(ic, ih):
        assert (a["node"], a["floor"], a["closed_loop"]) == \
            (b["node"], b["floor"], b["closed_loop"])
        d = np.asarray(a["p"], np.float64) - np.asarray(b["p"], np.float64)
        dq = nplie.quat_mul(nplie.quat_conj(b["q"]), a["q"])
        assert np.linalg.norm(d[:2]) < 2e-2 and abs(d[2]) < 0.4
        assert 2 * np.linalg.norm(dq[1:]) < np.radians(4.0)
    # descriptors are a max: the card's equal the CPU's bit for bit
    assert torch.equal(gc.sc_desc.cpu(), gh.sc_desc)
    assert np.array_equal(gc.p_host, gc.graph.p.cpu().numpy())


def test_readbacks_per_submap_on_card(cuda):
    """The host syncs of an add_submap, as torch.cuda's sync debug mode
    sees them, are the readbacks the mapper counts: none for the first
    submap, one (the registration result) for each later one without a
    loop; uploads do not wait."""
    cfg, subs = _loop(n=8)
    gm = GlobalMapper(cfg, device=cuda)
    seen = []
    for sm in subs:
        before = gm.readbacks
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                info = gm.add_submap(sm)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert not info["closed_loop"]
        syncs = sum("called a synchronizing" in str(w.message)
                    for w in caught)
        seen.append((syncs, gm.readbacks - before))
    assert seen == [(0, 0)] + [(1, 1)] * 7


def test_descriptor_and_voxel_owners_are_the_same_every_run(cuda):
    """A float max and an index max do not depend on the order of their
    writers: two runs on the card give the same bits.  The means and
    covariances, summed with float atomics, need not: on an H100 the
    mapper's 5-scan reference map built twice had means within 4e-6 m and
    a different plane normal in 2.5–2.8 % of its voxels."""
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(-20, 20, (40960, 3)).astype(
        np.float32), device=cuda)
    pts[:, 2] *= 0.1
    mask = torch.as_tensor(rng.uniform(size=40960) > 0.3, device=cuda)
    # a table this small is contested: owners are decided by index
    maps = [voxel.build_gaussian_voxel_map(pts, mask, 0.5, table_size=1 << 12)
            for _ in range(2)]
    assert torch.equal(maps[0].coords, maps[1].coords)
    assert torch.equal(maps[0].count, maps[1].count)
    host = voxel.build_gaussian_voxel_map(pts.cpu(), mask.cpu(), 0.5,
                                          table_size=1 << 12)
    assert torch.equal(maps[0].coords.cpu(), host.coords)
    assert torch.equal(maps[0].count.cpu(), host.count)
    torch.testing.assert_close(maps[0].mean.cpu(), host.mean, rtol=0,
                               atol=1e-4)
    descs = [scancontext.make_descriptor(pts, mask) for _ in range(2)]
    assert torch.equal(descs[0], descs[1])
    assert torch.equal(descs[0].cpu(),
                       scancontext.make_descriptor(pts.cpu(), mask.cpu()))


def test_global_mapper_defaults_to_the_card(cuda):
    gm = GlobalMapper(SystemConfig())
    assert gm.device.type == "cuda" and gm.graph.e_i.is_cuda


# ---------------------------------------------------------------------------
# the sensor front ends of mono VIO
# ---------------------------------------------------------------------------

def _tracker_state(tr):
    """A tracker's state as numpy arrays and host values."""
    host = lambda t: t.cpu().numpy()
    return dict(
        pts=host(tr.pts), valid=host(tr.valid), track_cnt=host(tr.track_cnt),
        norm=host(tr.norm), ids=host(tr.ids), next_id=host(tr.next_id),
        prev_pyr=None if tr.prev_pyr is None else [host(p)
                                                   for p in tr.prev_pyr],
        prev_t=tr.prev_t, first_image_time=tr.first_image_time,
        pub_count=tr.pub_count)


def test_tracker_on_card_matches_cpu_step_by_step(cuda):
    """5 images of chip_smoke.py's tracker run at the default SystemConfig:
    before each, the card's tracker takes over the CPU tracker's state;
    both draw the CPU generator's RANSAC samples."""
    cfg = SystemConfig()
    world, view = chip_smoke.make_camera_world()
    frames = chip_smoke.make_track_images(world, view, 5)
    host = FeatureTracker(cfg, device="cpu")
    card = FeatureTracker(cfg)
    assert card.device.type == "cuda" and card.pts.is_cuda
    drawn = []

    def draw(ok):
        drawn.append(ransac.sample_hypotheses(ok, cfg.tracker.ransac_iters,
                                              host.generator))
        return drawn[-1]

    host.hypothesis_source = draw
    card.hypothesis_source = lambda ok: drawn[-1]
    for k, (t, img, _, _) in enumerate(frames):
        card.load_reference_state(_tracker_state(host))
        _, out_h = host.process_device(t, img)
        _, out_c = card.process_device(t, img)
        fh = host.publish_from_packed(t, out_h.packed.numpy())
        fc = card.publish_from_packed(t, out_c.packed.cpu().numpy())
        differ = np.nonzero(fh.valid != fc.valid)[0]
        assert len(differ) <= 2, (k, differ, fh.uv[differ], fc.uv[differ])
        both = fh.valid & fc.valid
        assert both.sum() >= 60
        assert np.abs(fh.uv[both] - fc.uv[both]).max() < 0.05, k
        np.testing.assert_array_equal(fh.track_cnt[both], fc.track_cnt[both])
        if not len(differ):
            np.testing.assert_array_equal(fh.ids, fc.ids)
    assert len(drawn) == len(frames) - 1


def test_tracker_syncs_once_per_published_image(cuda):
    """An unpublished image makes no host sync, a published one exactly
    one (the packed readback), as torch.cuda's sync debug mode sees it."""
    cfg = SystemConfig()
    world, view = chip_smoke.make_camera_world()
    frames = chip_smoke.make_track_images(world, view, 7)
    tr = FeatureTracker(cfg)
    seen = []
    for t, img, _, _ in frames:
        frame, syncs = chip_smoke.count_syncs(torch,
                                              lambda: tr.process(t, img))
        seen.append((frame is not None, syncs))
    assert [s for _, s in seen] == [int(p) for p, _ in seen], seen
    assert seen[0][0] and 2 <= sum(p for p, _ in seen) <= 4, seen
    # a float32 image and an image already on the card go the same way
    t = frames[-1][0]
    for k, img in enumerate((frames[0][1].astype(np.float32),
                             torch.as_tensor(frames[0][1]).cuda())):
        _, syncs = chip_smoke.count_syncs(
            torch, lambda: tr.process_device(t + 0.01 * (k + 1), img))
        assert syncs == 0


def test_preintegration_on_card_matches_cpu(cuda):
    world, _ = chip_smoke.make_camera_world()
    imu = SystemConfig().imu
    out = {}
    for dev in ("cpu", cuda):
        streams, mask, _ = chip_smoke.make_imu_window(torch, world, dev)
        noise = pre.noise_covariance(imu.acc_n, imu.gyr_n, imu.acc_w,
                                     imu.gyr_w, device=dev)
        fn = lambda: pre.preintegrate_batch(*streams, noise, mask)
        out[str(dev)], syncs = chip_smoke.count_syncs(torch, fn)
        assert syncs == 0
    on_card, on_host = out[str(cuda)], out["cpu"]
    assert on_card.J.is_cuda and on_card.dq.shape == (6, 4)
    for name in ("dp", "dq", "dv", "sum_dt"):
        torch.testing.assert_close(getattr(on_card, name).cpu(),
                                   getattr(on_host, name), rtol=0, atol=1e-5)
    for name in ("J", "P"):
        ref = getattr(on_host, name)
        torch.testing.assert_close(getattr(on_card, name).cpu(), ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))
    L, syncs = chip_smoke.count_syncs(torch,
                                      lambda: pre.sqrt_information(on_card))
    assert syncs == 0 and bool(torch.isfinite(L).all())


def small_window(device, noise_px=chip_smoke.VIO_NOISE_PX):
    """chip_smoke.py's phase-10 window at 64 slots."""
    return chip_smoke.VioWindow(torch, chip_smoke.vio_world(1200),
                                chip_smoke.VIO_T0, 64, device, seed=3,
                                noise_px=noise_px)


def test_window_state_defaults_to_the_card(cuda):
    s = est_state.make_window_state(7, 256)
    assert s.p.is_cuda and s.inv_depth.shape == (256,)


def test_frame_step_on_card_matches_cpu(cuda):
    out = {}
    for dev in ("cpu", cuda):
        win = small_window(dev)
        for marg_old in (True, False):
            out[str(dev), marg_old] = win.step(win.step_args(lidar=True), 8,
                                               marg_old)
    for marg_old in (True, False):
        card, host = out[str(cuda), marg_old], out["cpu", marg_old]
        hc, hh = vio.read_host_pack(card[4]), host[4].numpy()
        np.testing.assert_allclose(hc[6:9], hh[6:9], rtol=0, atol=1e-3)
        np.testing.assert_allclose(hc[13:16], hh[13:16], rtol=0, atol=5e-3)
        np.testing.assert_allclose(hc[27:], hh[27:], rtol=1e-3)
        assert abs(hc[5] - hh[5]) <= 1e-3 * abs(hh[5])
        J = card[1].J.double().cpu()
        Jh = host[1].J.double()
        H, Hh = J.T @ J, Jh.T @ Jh
        assert float((H - Hh).abs().max()) <= 1e-3 * float(Hh.abs().max())


def test_frame_step_waits_three_times(cuda):
    """The two eigh of the marginalization and the readback; nothing else
    in the step waits for the card."""
    win = small_window(cuda)
    args = win.step_args(lidar=True)
    for marg_old in (True, False):
        win.step(args, 4, marg_old)
        _, syncs = chip_smoke.count_syncs(torch, lambda: vio.read_host_pack(
            win.step(args, 4, marg_old)[4]))
        assert syncs == 3


def test_triangulation_does_not_wait(cuda):
    win = small_window(cuda, noise_px=0.0)
    s = win.truth
    fn = lambda: triangulate.triangulate_window(  # noqa: E731
        *triangulate.camera_poses_from_body(s.p, s.q, s.tic, s.qic),
        win.feats.obs, win.feats.mask, win.feats.start)
    (inv, good), syncs = chip_smoke.count_syncs(torch, fn)
    assert syncs == 0
    ok = good & win.feats.valid
    rel = ((inv - s.inv_depth).abs() / s.inv_depth)[ok]
    assert int(ok.sum()) > 40 and float(rel.max()) < 1e-3
