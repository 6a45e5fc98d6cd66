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
readback; triangulation alone never waits.  Mono VIO end to end
(``VIOEstimator`` on chip_smoke.py's phase-11 stream at 128 feature slots)
on the card is held to the same estimator on the CPU: both pass the ATE
gate of tests/test_vio_e2e.py and their trajectories stay within 2e-2 m
of each other (LM trials decided at the cost's rounding go either way
under the card's float atomics; see tests/test_torch_vio_estimator.py);
it waits three times per steady-state keyframe, deferred readback gives
the sync run's trajectory within 1e-4 m, and the pinned tables are never
refilled while their copy is in flight.  VIL odometry
(tests/test_vil_e2e.py's stream at 128 slots, sweeps of 16 x 360 points
at 5 Hz) on the card against the CPU with the same hypotheses: the same
modes, poses within 3e-2 m (measured 2.3e-2 m on an NVIDIA H100).  Every
sweep of that stream agrees with the VIO, so no ICP row enters a solve,
and on each device the VIL trajectory equals mono VIO's on the same
stream: the gap is mono VIO's own on this stream, which has no IMU
biases.  With one drift record handed to both, the solves that carry its
ICP rows get equal tables on the card and on the CPU, and the poses stay
within the same 3e-2 m (measured 2.5e-2 m); a classified sweep waits once (its pack), a
deferred one not at dispatch, and deferred packs equal the sync ones
(the VIO entries within 1e-4, the registration within 5 cm and 1 % of
its correspondences, its `converged` flag free: each run builds its voxel
maps with float atomics,
and their rounding moves a registration by up to 2.65 cm between two
runs on an NVIDIA H100, as it moves one by up to 1.2 cm between the two
packages; see tests/test_torch_lidar_frontend.py).  The depth register on the card
within 1e-4 m of the CPU's, one wait per lookup.
"""

import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.estimator import state as est_state
from mvil_fusion_torch.estimator import vio
from mvil_fusion_torch.estimator.vio import VIOEstimator
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


# ---------------------------------------------------------------------------
# mono VIO end to end
# ---------------------------------------------------------------------------

def run_vio(device, t_end, defer=False, hypotheses=None):
    """VIOEstimator on `device` (None: its default) over chip_smoke.py's
    phase-11 stream up to t_end at 128 feature slots: (estimator, frames,
    host syncs of each steady-state keyframe).  Where `hypotheses` is a
    list, the estimator takes its essential-matrix hypotheses from it in
    turn, or, if it is empty, appends those its generator draws."""
    cfg = chip_smoke.sequence_config(max_features=128)
    frames = chip_smoke.vio_sequence(chip_smoke.sequence_world(), cfg,
                                     t_end=t_end)
    est = VIOEstimator(cfg, device=device)
    est.defer_readback = defer
    if hypotheses == []:
        def draw(valid):
            hypotheses.append(ransac.sample_hypotheses(valid, 256,
                                                       est.generator))
            return hypotheses[-1]
        est.hypothesis_source = draw
    elif hypotheses is not None:
        replay = iter(hypotheses)
        est.hypothesis_source = lambda valid: next(replay)
    syncs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # a repeated stamp
        for f in frames:
            steady = est.status == est.NON_LINEAR
            if est.device.type != "cuda":
                chip_smoke.feed(est, f)
                continue
            _, n = chip_smoke.count_syncs(torch,
                                          lambda: chip_smoke.feed(est, f))
            if steady:
                syncs.append(n)
    est.flush()
    return est, frames, syncs


def test_vio_on_card_matches_cpu(cuda):
    """Both draw the CPU generator's essential-matrix hypotheses: a CPU
    and a CUDA generator draw different ones, and another anchor pose
    moves the whole trajectory by centimetres."""
    drawn = []
    host, _, _ = run_vio("cpu", 4.5, hypotheses=drawn)
    card, frames, _ = run_vio(None, 4.5, hypotheses=drawn)
    assert len(drawn) >= 1
    assert card.device.type == "cuda" and card.state.p.is_cuda
    for est in (card, host):
        assert est.status == est.NON_LINEAR and est.failures == 0
        assert chip_smoke.ate_4dof(est.trajectory, frames) < 0.35
    assert card.solve_info["init"]["l"] == host.solve_info["init"]["l"]
    assert len(card.trajectory) == len(host.trajectory) > 30
    gap = max(np.abs(a[1] - b[1]).max()
              for a, b in zip(card.trajectory, host.trajectory))
    assert gap < 2e-2, gap


def test_vio_waits_three_times_per_keyframe(cuda):
    est, _, syncs = run_vio(cuda, 1.45)
    assert est.status == est.NON_LINEAR and len(syncs) == 3
    assert syncs == [3, 3, 3]
    assert est._tables.waits == 0


def test_vio_deferred_readback_on_card(cuda):
    sync, _, _ = run_vio(cuda, 1.95)
    dfr, _, syncs = run_vio(cuda, 1.95, defer=True)
    assert len(sync.trajectory) == len(dfr.trajectory) == 9
    gap = max(np.abs(a[1] - b[1]).max()
              for a, b in zip(sync.trajectory, dfr.trajectory))
    assert gap < 1e-4, gap
    # the two eigh; the harvest waits on the copy's event, which sync
    # debug mode does not count
    assert set(syncs) == {2}
    assert dfr.solve_info["harvests"] == 9


def test_pinned_tables_wait_for_their_copy(cuda):
    """A copy from pinned memory reads its source when the stream gets to
    it.  With the stream held busy, FrameTables.zero must wait for the
    previous copy before the host refills the buffer; a refill that skips
    the wait (the event dropped) hands the device the refilled values."""
    tab = vio.FrameTables([("x", (1 << 20,), torch.float32)], cuda)

    def cycle(skip_wait):
        tab.zero()
        tab["x"][:] = 1.0
        torch.cuda._sleep(400_000_000)       # ~0.2 s of device time first
        seen = tab.upload()["x"].clone()     # queued after the copy
        if skip_wait:
            tab._copied = None
        tab.zero()
        tab["x"][:] = 2.0
        torch.cuda.synchronize()
        return seen

    assert bool((cycle(False) == 1.0).all())
    assert tab.waits == 1
    assert not bool((cycle(True) == 1.0).all())


def test_vio_estimator_defaults_to_the_card(cuda):
    est = VIOEstimator(SystemConfig())
    assert est.device.type == "cuda"
    assert est.state.p.is_cuda and est.prior.J.is_cuda
    assert est._tables.host["obs"].is_pinned()
    assert est._tables.dev["obs"].is_cuda


# ---------------------------------------------------------------------------
# VIL odometry and the whole system
# ---------------------------------------------------------------------------

VIL_VIO = np.r_[11:18, 25:46]         # a pack's VIO motions and poses
ICP_ROWS = ("icp_act", "icp_ids", "icp_ai", "icp_aj", "icp_tp", "icp_w",
            "zero_vel")


def run_vil(device, t_end=2.4, defer=False, hypotheses=None, lidar=True,
            drift_at=None):
    """VIOEstimator on `device` (None: its default) with its LiDAR front
    end over tests/test_vil_e2e.py's stream (chip_smoke.vil_sequence,
    128 feature slots, sweeps of 16 x 360 points at 5 Hz) up to t_end:
    (estimator, frames, per sweep (mode, host syncs), the packs, per
    steady-state solve its ICP and zero-velocity tables).  Up to 2.4 s
    every sweep is far from the drift-correcting mode's 0.1 m (its
    disagreement with the VIO 0.017-0.021 m on the CPU); later ones come
    within 0.01 m of it.  `hypotheses` as in run_vio.  Without `lidar`
    the same stream runs through mono VIO (its sweeps are dropped); after
    frame `drift_at` the front end takes chip_smoke.drift_record of the
    stream's trajectory."""
    cfg = chip_smoke.vil_config(max_features=128, vgicp_iters=8)
    world = chip_smoke.sequence_world(chip_smoke.VIL_DURATION)
    frames, sweeps = chip_smoke.vil_sequence(
        world, cfg, t_end,
        lidar_times=np.arange(chip_smoke.SEQ_T0 + 0.85, t_end - 0.15, 0.2),
        n_azimuth=360)
    est = VIOEstimator(cfg, device=device)
    if lidar:
        est.enable_lidar()
        est.lidar.defer_pack = defer
    est.defer_readback = defer
    if hypotheses == []:
        def draw(valid):
            hypotheses.append(ransac.sample_hypotheses(valid, 256,
                                                       est.generator))
            return hypotheses[-1]
        est.hypothesis_source = draw
    elif hypotheses is not None:
        replay = iter(hypotheses)
        est.hypothesis_source = lambda valid: next(replay)
    packs, recs, icp = [], [], []
    if lidar:
        apply = est.lidar._apply_sweep_pack

        def keep(hp, prev, cur):
            packs.append(np.asarray(hp).copy())
            return apply(hp, prev, cur)
        est.lidar._apply_sweep_pack = keep

    fed = []

    def on_frame(fn):
        steady, n = est.status == est.NON_LINEAR, est._solves
        fn()
        fed.append(steady and est._solves > n)
        if fed[-1]:
            icp.append({k: np.array(est._tables[k]) for k in ICP_ROWS})
        if len(fed) == drift_at:
            est.lidar.constraints.append(
                chip_smoke.drift_record(est, world.traj))

    def on_sweep(s):
        def fn():
            return est.process_lidar(s["t_start"], s["pts"], s["rel_time"],
                                     s["mask"])
        if est.device.type == "cuda":
            out, n = chip_smoke.count_syncs(torch, fn)
        else:
            out, n = fn(), None
        recs.append(("none" if out is None else out["mode"], n))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # a repeated stamp
        chip_smoke.run_stream(est, frames, sweeps, on_sweep, on_frame)
    if lidar:
        est.lidar._harvest_pack()
    est.flush()
    return est, frames, recs, packs, icp


def trajectory_gap(a, b):
    assert len(a.trajectory) == len(b.trajectory) > 10
    return max(float(np.abs(x[1] - y[1]).max())
               for x, y in zip(a.trajectory, b.trajectory))


def test_vil_on_card_matches_cpu(cuda):
    """Both draw the CPU generator's essential-matrix hypotheses.  No sweep
    of this stream disagrees with the VIO, so no solve carries an ICP row,
    and on each device the VIL trajectory is the trajectory of mono VIO
    (no enable_lidar) on the same stream: the gap between card and CPU is
    mono VIO's own."""
    drawn = []
    host, _, recs_h, _, icp_h = run_vil("cpu", hypotheses=drawn)
    card, frames, recs_c, _, icp_c = run_vil(None, hypotheses=drawn)
    assert card.lidar.device.type == "cuda"
    for est in (card, host):
        assert est.status == est.NON_LINEAR and est.failures == 0
        assert chip_smoke.ate_4dof(est.trajectory, frames) < 0.3
    assert [m for m, _ in recs_c] == [m for m, _ in recs_h]
    assert card.lidar.mode_counts == host.lidar.mode_counts
    assert len(icp_c) == len(icp_h) > 5
    assert not any(t["icp_act"].any() or t["zero_vel"].any()
                   for t in icp_c + icp_h)
    for device, vil in (("cpu", host), (None, card)):
        mono = run_vil(device, hypotheses=drawn, lidar=False)[0]
        assert mono.lidar is None
        same = trajectory_gap(vil, mono)
        print(f"VIL against mono VIO on {vil.device}: {same:.3e} m")
        assert same == 0.0, (vil.device, same)
    gap = trajectory_gap(card, host)
    print(f"VIL on the card against the CPU: {gap:.3e} m")
    assert gap < 3e-2, gap


def test_vil_icp_rows_on_card_match_cpu(cuda):
    """One drift record (chip_smoke.drift_record) handed to both after
    frame 12: the solves that carry its ICP rows get the same tables on
    the card and on the CPU, the modes are equal, and the poses stay
    within mono VIO's gap on this stream."""
    drawn = []
    host, _, recs_h, _, icp_h = run_vil("cpu", hypotheses=drawn,
                                        drift_at=12)
    card, frames, recs_c, _, icp_c = run_vil(None, hypotheses=drawn,
                                             drift_at=12)
    assert [m for m, _ in recs_c] == [m for m, _ in recs_h]
    assert len(icp_c) == len(icp_h) > 5
    assert sum(bool(t["icp_act"].any()) for t in icp_c) >= 3
    for tc, th in zip(icp_c, icp_h):
        for k in ICP_ROWS:
            np.testing.assert_array_equal(tc[k], th[k], err_msg=k)
    for est in (card, host):
        assert est.status == est.NON_LINEAR and est.failures == 0
        assert chip_smoke.ate_4dof(est.trajectory, frames) < 0.3
    gap = trajectory_gap(card, host)
    print(f"VIL with ICP rows on the card against the CPU: {gap:.3e} m")
    assert gap < 3e-2, gap


def test_vil_sweep_waits_once_and_deferred_packs_match(cuda):
    """Sync: one counted wait per classified sweep (its pack), none for the
    first or an unbracketed one; deferred: none at dispatch, and the same
    packs, classified one sweep later."""
    sync, _, recs_s, packs_s, _ = run_vil(cuda)
    dfr, _, recs_d, packs_d, _ = run_vil(cuda, defer=True)
    classified = [n for m, n in recs_s if m not in ("none", 0)]
    assert len(classified) >= 4 and set(classified) == {1}
    assert {n for m, n in recs_s if m in ("none", 0)} <= {0}
    assert {n for _, n in recs_d} == {0}
    assert [m for m, _ in recs_d].count(None) == len(classified)
    assert sync.lidar.mode_counts == dfr.lidar.mode_counts
    assert len(packs_s) == len(packs_d) == len(classified)
    for a, b in zip(packs_s, packs_d):
        np.testing.assert_allclose(a[VIL_VIO], b[VIL_VIO], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(a[0:3], b[0:3], rtol=0, atol=5e-2)
        assert abs(a[8] - b[8]) <= 0.01 * a[8]


def test_depth_register_on_card_matches_cpu(cuda):
    from mvil_fusion_torch.frontend.depth_register import DepthRegister
    clouds, norm, fr = chip_smoke.depth_scene()
    out = []
    for device in (None, "cpu"):
        reg = DepthRegister(SystemConfig(), device=device)
        for k, c in enumerate(clouds):
            reg.add_cloud(0.1 * k, c)
        out.append(reg.get_depth(0.75, norm, np.ones(len(norm), bool),
                                 np.zeros(3), np.asarray([1.0, 0, 0, 0])))
        if device is None:
            assert reg.device.type == "cuda" and reg._snap[0].is_cuda
            _, n = chip_smoke.count_syncs(torch, lambda: reg.get_depth(
                0.75, norm, np.ones(len(norm), bool), np.zeros(3),
                np.asarray([1.0, 0, 0, 0])))
            assert n == 1
    card, host = out
    both = (card > 0) & (host > 0)
    assert both.sum() > 120 and ((card > 0) != (host > 0)).sum() <= 2
    np.testing.assert_allclose(card[both], host[both], rtol=0, atol=1e-4)
    assert np.median(np.abs(card[both] - fr[both])) < 0.2


def test_vil_system_and_lidar_frontend_default_to_the_card(cuda):
    from mvil_fusion_torch.estimator.lidar_frontend import LidarFrontend
    from mvil_fusion_torch.pipeline.system import VilSystem
    assert LidarFrontend(SystemConfig()).device.type == "cuda"
    sys_ = VilSystem(SystemConfig())
    assert sys_.device.type == "cuda"
    for part in (sys_.estimator, sys_.estimator.lidar, sys_.compensator,
                 sys_.depth_register, sys_.local_mapper, sys_.global_mapper):
        assert part.device.type == "cuda", part


# ---------------------------------------------------------------------------
# the threaded pipeline and checkpoint/resume (slice 5).  The hand-built
# NON_LINEAR window below (a stationary scene, no JAX) is shared with the
# CPU tests of tests/test_torch_{system,pipeline,checkpoint}.py.
# ---------------------------------------------------------------------------

TABLE = 1 << 14
STILL = SyntheticTrajectory(duration=6.0, w_amp=(0.0, 0.0, 0.0),
                            p_amp=(0.0, 0.0, 0.0), lin_vel=(0.0, 0.0, 0.0))
IMU = (np.asarray([0.0, 0.0, 9.795]), np.zeros(3))
SWEEP_TIMES = (0.3, 0.55, 0.65, 0.75, 0.85, 1.05, 1.2)


def small_cfg():
    import dataclasses
    from mvil_fusion_torch.config import LidarConfig
    return dataclasses.replace(SystemConfig(), lidar=LidarConfig(
        rlb=chip_smoke.IDENTITY, tlb=(0.0, 0.0, 0.0), vgicp_iters=8,
        vgicp_table_size=TABLE, downsample_table_size=TABLE))


def window(sys_, t0):
    """A NON_LINEAR window of W frames 0.1 s apart from t0."""
    est = sys_.estimator
    est.status = est.NON_LINEAR
    est.times = [t0 + 0.1 * k for k in range(est.W)]


def sweep(t):
    s = simulate_sweep(BoxWorld(), STILL, t, n_azimuth=360)
    return s["t_start"], s["pts"], s["mask"]


def stream(sweep_times=SWEEP_TIMES):
    """IMU at 200 Hz over [0.5, 1.3] with sweeps starting at sweep_times
    among them (stale, inside the window [0.5, 1.1], past it), then the
    flush."""
    msgs = [("imu", t, IMU) for t in np.arange(0.5, 1.3, 0.005)]
    for ts in sweep_times:
        t0, pts, _ = sweep(ts)
        msgs.append(("lidar", t0, (pts, None)))
    msgs.sort(key=lambda m: m[1])
    return msgs + [("flush", 1.3, ())]


def feed_system(sys_, msgs):
    """A stream of stream()'s messages into a synchronous VilSystem."""
    for kind, t, payload in msgs:
        if kind == "imu":
            sys_.process_imu(t, *payload)
        elif kind == "lidar":
            sys_.process_lidar(t, payload[0], reflectivity=payload[1])
    sys_.flush()


def comparable(x):
    """x as nested plain values; tensors and arrays as dtype, shape and
    bytes."""
    import dataclasses
    if isinstance(x, torch.Tensor):
        return ("tensor", str(x.dtype), tuple(x.shape),
                x.cpu().numpy().tobytes())
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return ("scalar", x.dtype.str, x.tobytes())
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, {f.name: comparable(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__, [comparable(v) for v in x])
    if isinstance(x, (list, tuple)):
        return [comparable(v) for v in x]
    if isinstance(x, dict):
        return {k: comparable(v) for k, v in x.items()}
    return x


def saved_state(sys_):
    """Everything utils/checkpoint.save_system writes of a VilSystem,
    comparable."""
    from mvil_fusion_torch.utils import checkpoint as ck
    est = sys_.estimator
    return comparable(dict(
        estimator=ck._take(est, ck.ESTIMATOR),
        lidar=ck._take(est.lidar, ck.LIDAR),
        local=ck._take(sys_.local_mapper, ck.LOCAL),
        glob=ck._take(sys_.global_mapper, ck.GLOBAL),
        system=ck._take(sys_, ck.SYSTEM),
        ring=sys_.depth_register._snap[:3]))


def test_deterministic_pipeline_on_card_matches_sync(cuda):
    """Phase 14's hand-off check at test size: a short stretch of phase
    13's stream (128 slots, sweeps of 16 x 360 points) through a
    synchronous VilSystem on the card and through the deterministic
    pipeline, whose stages run on three streams of their own: the same
    keyframe, classified, mapped and submap counts, and the pipeline's
    trajectory within the phase's gates (1e-4 m up to the first solve with
    an ICP or LPS row, whose inputs float atomics move from run to run;
    5e-2 m over all)."""
    import dataclasses
    from mvil_fusion_torch.config import LocalMappingConfig
    from mvil_fusion_torch.pipeline.system import VilSystem
    cfg = dataclasses.replace(
        chip_smoke.system_config(max_features=128),
        local_mapping=LocalMappingConfig(submap_trigger_dist=1.0,
                                         submap_trigger_frames=3))
    frames, sweeps = chip_smoke.vil_sequence(
        chip_smoke.sequence_world(chip_smoke.SYS_DURATION), cfg, 2.6,
        lidar_times=np.arange(1.35, 2.4, 0.1), n_azimuth=360)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        sync = VilSystem(cfg)
        rows = chip_smoke.solve_rows(sync)
        chip_smoke.run_stream(sync, frames, sweeps, lambda s: sync.process_lidar(
            *chip_smoke.bag_sweep(s)))
        sync.flush()
        det = VilSystem(cfg)
        rows_det = chip_smoke.solve_rows(det)
        pipe = chip_smoke.run_pipeline_stream(torch, det, frames, sweeps)
    assert len({id(st.stream) for st in pipe.stages}) == 3
    counts = [chip_smoke.system_counts(x) for x in (sync, det)]
    assert counts[0] == counts[1]
    assert counts[0]["mapped"] >= 3 and counts[0]["submaps"] >= 1
    tight, loose, n = chip_smoke.handoff_gaps(sync, rows, det, rows_det)
    assert n > 0 and tight <= chip_smoke.HANDOFF_TIGHT, (tight, n)
    assert loose <= chip_smoke.HANDOFF_LOOSE, loose


def test_flush_sentinel_through_threaded_pipeline_on_card(cuda):
    from mvil_fusion_torch.io.fixture import fixture_config
    from mvil_fusion_torch.pipeline.async_system import build_pipeline
    from mvil_fusion_torch.pipeline.system import VilSystem
    system = VilSystem(fixture_config())
    pipe = build_pipeline(system, deterministic=False)
    assert system.estimator.defer_readback
    assert all(s is not None for s in pipe.streams.values())
    pipe.start()
    try:
        for k in range(20):
            pipe.feed(("imu", k * 0.005, IMU))
        pipe.feed(("flush", 0.1, ()))
        assert pipe.quiesce(timeout=60.0)
    finally:
        pipe.stop(timeout=30.0)
    for st in pipe.stages:
        assert not st.errors, st.errors[:1]
        assert not st.thread.is_alive()
    assert [st.processed for st in pipe.stages] == [21, 21, 1]


def test_checkpoint_from_card_resumes_on_cpu(cuda, tmp_path):
    """A VilSystem on the card, on the hand-built window with a mapped
    sweep and a sweep waiting, saved and loaded into a VilSystem on the
    CPU: every saved tensor and host field equal."""
    from mvil_fusion_torch.config import LocalMappingConfig
    from mvil_fusion_torch.pipeline.system import VilSystem
    from mvil_fusion_torch.utils import checkpoint
    cfg = small_cfg().replace(local_mapping=LocalMappingConfig(
        submap_trigger_frames=1))
    msgs = [m for m in stream((0.3, 0.55, 0.65, 1.05))[:-1]]
    card = VilSystem(cfg)
    window(card, 0.5)
    feed_system(card, msgs)
    path = str(tmp_path / "ckpt.pkl")
    checkpoint.save_system(card, path)
    assert card.global_mapper.n_nodes == 2 and card._pending_sweeps
    host = VilSystem(cfg, device="cpu")
    checkpoint.load_system(host, path)
    assert host.estimator.state.p.device.type == "cpu"
    assert host.depth_register._snap[0].device.type == "cpu"
    assert saved_state(host) == saved_state(card)
