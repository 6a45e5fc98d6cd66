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
differed by 2–7 mm horizontally and 3–20 cm in height.
"""

import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.frontend.lidar_compensator import LidarCompensator
from mvil_fusion_torch.io.synthetic import SyntheticTrajectory
from mvil_fusion_torch.io.synthetic_lidar import BoxWorld, simulate_sweep
from mvil_fusion_torch.mapping.global_mapping import GlobalMapper
from mvil_fusion_torch.mapping.local_mapping import LocalMapper
from mvil_fusion_torch.ops import deskew
from mvil_fusion_torch.ops import knn_topk as K
from mvil_fusion_torch.ops import scancontext, voxel
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
