"""Scan-to-map as CUDA graphs (``loam_icp.ScanToMapGraphs``), on the CPU.

The graphs replay on a card only (tests/test_torch_cuda.py holds them to
the eager path there).  Here: the rule that engages them, the eager path
that CPU tensors take, and the three graph bodies (``_Segments``) run in
the call's order, which must give the eager call's numbers to the bit:
they are the same arithmetic, split at the k-NN calls.
"""

import numpy as np
import pytest
import torch

from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.frontend.lidar_compensator import LidarCompensator
from mvil_fusion_torch.io.synthetic import SyntheticTrajectory
from mvil_fusion_torch.io.synthetic_lidar import BoxWorld, simulate_sweep
from mvil_fusion_torch.mapping import local_mapping as lm
from mvil_fusion_torch.ops import deskew
from mvil_fusion_torch.ops import loam_icp
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

TRAJ = SyntheticTrajectory(duration=8.0, w_amp=(0.2, 0.15, 0.4),
                           w_freq=(0.2, 0.15, 0.25),
                           p_amp=(1.5, 1.2, 0.3), p_freq=(0.2, 0.25, 0.15),
                           lin_vel=(0.5, 0.25, 0.0))
SWEEPS = 2


@pytest.fixture(scope="module")
def run():
    """SWEEPS sweeps of 16 × 480 points through a CPU mapper; each
    scan-to-map call's arguments are kept."""
    cfg = SystemConfig()
    comp = LidarCompensator(cfg, device="cpu")
    mapper = lm.LocalMapper(cfg, device="cpu")
    graphs, calls = mapper.scan_graphs, []

    def kept(*args, **kw):
        calls.append((tuple(a.clone() for a in args), dict(kw)))
        return graphs(*args, **kw)

    mapper.scan_graphs = kept
    for i in range(SWEEPS):
        t0 = 0.8 + 0.1 * i
        s = simulate_sweep(BoxWorld(), TRAJ, t0, n_azimuth=480)
        odom = [np.asarray(v, np.float32)
                for v in (*TRAJ.pose_at(t0), *TRAJ.pose_at(t0 + 0.1))]
        sw = comp.process(t0, s["pts"], s["mask"])
        pts = deskew.deskew_to_end(sw.pts, sw.rel_time,
                                   *[torch.as_tensor(v) for v in odom], 0.1)
        mapper.process_full(t0 + 0.1, pts, sw.ring, sw.rel_time, sw.mask,
                            None, odom[2], odom[3], n_rings=16,
                            n_azimuth=480, scan_period=0.1)
    return graphs, calls


@pytest.mark.parametrize("n_blocks,on_cuda,capturing,engaged", [
    (1, True, False, True),
    (2, True, False, False),
    (4, True, False, False),
    (1, True, True, False),
    (1, False, False, False),
    (2, False, True, False),
])
def test_graphs_engage_rule(n_blocks, on_cuda, capturing, engaged):
    assert loam_icp.graphs_engage(n_blocks, on_cuda, capturing) is engaged


def test_cpu_calls_run_eager(run):
    graphs, calls = run
    assert len(calls) == SWEEPS
    assert (graphs.eager, graphs.captures, graphs.replays) == (SWEEPS, 0, 0)


def _tensors(args, kw, use_i):
    """A kept call's tensors in ``_Segments``'s order; with `use_i`, seeded
    reflectivities for the sweep's and the map's surf points."""
    si, smi = kw["surf_i"], kw["surf_map_i"]
    if use_i:
        g = torch.Generator().manual_seed(7)
        si = torch.rand(args[2].shape[0], generator=g)
        smi = torch.rand(args[6].shape[0], generator=g)
    return (*args[:8], si, smi, *args[8:10], *kw["finish_args"])


@pytest.mark.parametrize("use_i", [False, True])
def test_segments_in_order_equal_the_eager_call(run, use_i, monkeypatch):
    """The bodies of the three graphs, run directly in the call's order on
    copies of its tensors, give the eager call's tensors bit for bit, on
    a sweep whose maps hold the sweep before; and they look the k-NN up as
    ``loam_icp.knn`` at each call, as the eager path does, so a wrapper
    put there sees the same six calls."""
    _, calls = run
    args, kw = calls[-1]
    tensors = _tensors(args, kw, use_i)
    it = (kw["outer_iters"], kw["gn_iters"], 1.0, lm._gate)
    seen, knn = [], loam_icp.knn

    def counted(query, ref, ref_mask, k):
        seen.append((query.shape[0], ref.shape[0], k, int(ref_mask.sum())))
        return knn(query, ref, ref_mask, k)

    monkeypatch.setattr(loam_icp, "knn", counted)
    want = loam_icp._eager(tensors, *it)
    eager, seen[:] = list(seen), []
    seg = loam_icp._Segments(tensors, *it)
    seg.load(tensors)
    got = seg.run(seg.start, seg.solve, seg.finish)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert len(eager) == 2 * (kw["outer_iters"] + 1) == 6
    assert seen == eager
    # the association found enough to pass the count gate, so the test has
    # teeth: (n_edge, n_plane) are the pack's entries 7 and 8
    assert float(want[4][7] + want[4][8]) >= 50
