#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the script exits non-zero):

1. device: needs a CUDA card; prints the card's name and power limit as
   nvidia-smi reports them, and sets the fp32 policy (no TF32);
2. build: builds (or loads) the hand-written CUDA kernel from
   mvil_fusion_torch/csrc into build/kernels/;
3. kernel: the k-NN kernel against its plain PyTorch version, on the card,
   at the LOAM path's shapes and at edge cases, with its time and the
   plain version's (CUDA events, median of 20 after 3 warm-ups) and, at
   the path's shapes, the least time the card could take and the share of
   it reached; then the kernel's split-and-merge at forced numbers of
   reference slices (ties across a slice boundary, a slice masked whole),
   where it must equal the plain version exactly; then the kernel's time
   on the tensors of one edge call and one plane call taken from sweep 16
   of the run below (maps populated).  A kernel's time is its time on the
   device (10 calls replayed as a CUDA graph); beside it stands the time
   of a call from the host, which for so short a kernel is the wrapper's;
4. slice: the LOAM local-mapping stage at the reference sensor's full size
   (16 rings × 900 azimuth steps, 14,400 points per sweep; the default
   SystemConfig's map capacities) for 40 sweeps of a synthetic box room
   with drifting odometry: LidarCompensator.process → deskew_to_end →
   LocalMapper.process_full on cuda:0.  Gates: mean mapped position error
   below half the odometry's, maximum below 0.06 m, 2 submaps, and exactly
   6 k-NN kernel launches per sweep;
5. chained: the 2 submaps of phase 4 through GlobalMapper.add_submap at
   the default SystemConfig on cuda:0, the second registered against the
   first.  Gates: 2 nodes, ≥ 1 edge, the registration accepted, node 1
   within 0.10 m of the truth at its sweep;
6. loop: two laps (32 keyed scans of 5000 rays, 2.8 m apart) of a square
   in a 40 × 34 × 8 m box room, odometry drifting by N(0, 0.04) +
   (0.01, 0.008, 0) m per step, through GlobalMapper at the default
   capacities (512 nodes, 2048 edges, 512 z priors, 8192 points a scan,
   hash tables of 2^17 and 2^15) with loop gates cut to the path's length
   (skip 6 recent poses, 4 poses before reclosing, 4 m proximity, fitness
   below 0.6).  Gates: 32 nodes, ≥ 1 loop closed, every pose finite, the
   last lap's mean position error below the odometry's, a global map of
   more than 1000 finite points.  Prints ms per add_submap (median, and
   the maximum, a loop-closing one) and the host readbacks per add_submap;
7. solver: solve_cg on a 512-node, 2048-edge helix (a drifted chain
   cross-braced with true relative positions): the maximum error must
   fall below a fifth; ms per solve (CUDA events, median of 5), LM and CG
   iterations taken and host syncs per solve.  Then vgicp_align and
   build_gaussian_voxel_map alone at the mapper's shapes (an 8192-point
   scan, a 5 × 8192-point reference, 12 iterations): ms each.

The second-to-last line is the kernel table as JSON, the last line
{"ok": true, "device": {...}}.  Neither JAX nor the JAX package is
imported: the configuration and the synthetic sweeps come from the port.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_SWEEPS = 40
KNN_SHAPES = [  # (nq, nr, k, what)
    (256, 16384, 5, "edges"),
    (4096, 32768, 5, "planes"),
    (4096, 32768, 10, "planes, intensity"),
    (37, 513, 3, "ragged"),
    (1, 1, 1, "single"),
    (256, 4096, 128, "k=128"),
    (64, 1024, 5, "all masked"),
]
MAIN_SHAPE = (4096, 32768, 5)
EDGE_SHAPE = (256, 16384, 5)
PATH_SHAPES = (EDGE_SHAPE, MAIN_SHAPE, (4096, 32768, 10))
FORCED_SPLITS = (1, 2, 7, 64)
CAPTURE_SWEEP = 15          # path data: the k-NN calls of sweep 16
# NVIDIA's data sheet for the H100 SXM: HBM3 bytes/s, fp32 FLOP/s outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, calls=10, reps=20, warmup=3) -> float:
    """Median milliseconds of one fn() on the card with the host out of
    the way: `calls` of them captured as one CUDA graph, the replay timed
    by CUDA events.  For work shorter than the host takes to queue it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(torch, graph.replay, reps, warmup) / calls


def time_ms(torch, fn, reps=20, warmup=3) -> float:
    """Median milliseconds of fn() as the host calls it, by CUDA events
    around the call: the device time, or the host's time to queue the
    work where that is longer."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def knn_bound_ms(nq: int, nr: int, k: int, live: int):
    """(ms, "bytes" or "operations"): the least time the card could take
    for one k-NN call.  Bytes: query, reference and mask read once, idx
    and d2 written once.  Operations: 8 fp32 (3 subtract, 3 multiply,
    2 add) for each pair of a query and one of the `live` unmasked refs."""
    by = (12 * nq + 13 * nr + 8 * nq * k) / PEAK_BYTES_S
    op = 8 * nq * live / PEAK_FP32_S
    return 1e3 * max(by, op), "bytes" if by > op else "operations"


def random_case(torch, rng, nq, nr, masked=0.2):
    """Uniform points in ±60 m on the card, a share `masked` of the refs
    masked."""
    q = rng.uniform(-60, 60, (nq, 3)).astype(np.float32)
    r = rng.uniform(-60, 60, (nr, 3)).astype(np.float32)
    m = rng.uniform(size=nr) >= masked
    return tuple(torch.as_tensor(a).cuda() for a in (q, r, m))


def grid_case(torch, rng, nq, nr, masked=0.2):
    """Points on a small integer grid: every distance is exact in fp32 in
    either form, and most are tied."""
    q = rng.integers(-4, 5, (nq, 3)).astype(np.float32)
    r = rng.integers(-4, 5, (nr, 3)).astype(np.float32)
    m = rng.uniform(size=nr) >= masked
    return tuple(torch.as_tensor(a).cuda() for a in (q, r, m))


def compare_with_plain(torch, K, q, r, m, k, what, splits=None):
    """The kernel against its plain version within d2 1e-3 + 1e-4·d2 and
    index agreement ≥ 0.99; returns (max |d2 error|, agreement)."""
    idx_k, d2_k = K.knn_topk_cuda(q, r, m, k, _splits=splits)
    torch.cuda.synchronize()
    idx_p, d2_p = K.knn_topk_plain(q, r, m, k)
    fin = torch.isfinite(d2_p)
    check(bool((d2_k[~fin] > 1e20).all()), f"{what}: masked slot won")
    check(bool((idx_k[~fin] == 0).all()), f"{what}: empty slot has an index")
    check(bool(torch.isfinite(d2_k[fin]).all()), f"{what}: lost slot")
    err, agree = 0.0, 1.0
    if bool(fin.any()):
        diff = (d2_k[fin] - d2_p[fin]).abs()
        err = float(diff.max())
        check(bool((diff <= 1e-3 + 1e-4 * d2_p[fin].abs()).all()),
              f"{what}: d2 differs by {err}")
        agree = float((idx_k == idx_p)[fin].float().mean())
        check(agree >= 0.99, f"{what}: index agreement {agree}")
    return err, agree


def knn_times(torch, K, q, r, m, k):
    """(kernel ms on the device, kernel ms a call from the host, plain ms
    a call from the host)."""
    return (device_ms(torch, lambda: K.knn_topk_cuda(q, r, m, k)),
            time_ms(torch, lambda: K.knn_topk_cuda(q, r, m, k)),
            time_ms(torch, lambda: K.knn_topk_plain(q, r, m, k)))


def phase_kernel(torch, K, card):
    """Kernel vs plain at KNN_SHAPES on random points; returns (max |d2
    error|, {path shape: (kernel device ms, kernel call ms, plain ms,
    bound ms, bound by)})."""
    rng = np.random.default_rng(SEED)
    max_err, path = 0.0, {}
    for nq, nr, k, what in KNN_SHAPES:
        q, r, m = random_case(torch, rng, nq, nr,
                              masked=1.0 if what == "all masked" else 0.2)
        err, agree = compare_with_plain(torch, K, q, r, m, k, what)
        max_err = max(max_err, err)
        ms, call_ms, plain_ms = knn_times(torch, K, q, r, m, k)
        line = (f"kernel: knn_topk ({nq}, {nr}, k={k}) {what}: ok, max|d2 "
                f"err| {err:.3g}, idx agree {agree:.5f}; kernel {ms:.4f} ms "
                f"on the device, {call_ms:.4f} ms a call, plain "
                f"{plain_ms:.4f} ms")
        if (nq, nr, k) in PATH_SHAPES:
            bound, by = knn_bound_ms(nq, nr, k, int(m.sum()))
            path[(nq, nr, k)] = (ms, call_ms, plain_ms, bound, by)
            line += (f", bound {bound:.5f} ms ({by}), share of bound "
                     f"{bound / ms:.4f}")
        print(f"{line} [{card}]", flush=True)
    return max_err, path


def phase_splits(torch, K):
    """Split-and-merge at forced numbers of slices.  On random points the
    kernel is held to the plain version as above; on the integer grid,
    where nothing rounds, idx and d2 must equal it exactly, ties
    included."""
    rng = np.random.default_rng(SEED + 1)
    cases = 0
    for nq, nr, k in ((256, 16384, 5), (37, 513, 3), (64, 4096, 10)):
        q, r, m = random_case(torch, rng, nq, nr)
        for s in FORCED_SPLITS:
            compare_with_plain(torch, K, q, r, m, k,
                               f"({nq}, {nr}, k={k}) in {s} slices", s)
            cases += 1

    def exact(q, r, m, k, s, what):
        idx_k, d2_k = K.knn_topk_cuda(q, r, m, k, _splits=s)
        torch.cuda.synchronize()
        idx_p, d2_p = K.knn_topk_plain(q, r, m, k)
        check(torch.equal(d2_k, d2_p), f"{what}: d2 not equal to plain")
        check(torch.equal(idx_k, idx_p), f"{what}: idx not equal to plain")

    for nq, nr, k in ((33, 700, 4), (256, 4096, 10), (16, 2100, 40)):
        q, r, m = grid_case(torch, rng, nq, nr)
        for s in FORCED_SPLITS:
            exact(q, r, m, k, s, f"grid ({nq}, {nr}, k={k}) in {s} slices")
            cases += 1
    # duplicates of a query on both sides of the boundary of 2 slices
    q, r, m = grid_case(torch, rng, 9, 64, masked=0.0)
    _, length = K.split_geometry(64, 2)
    r[length - 3:length + 3] = q[0]
    idx, d2 = K.knn_topk_cuda(q, r, m, 4, _splits=2)
    torch.cuda.synchronize()
    dup = torch.nonzero((r == q[0]).all(dim=1)).flatten()[:4]
    check(idx[0].tolist() == dup.tolist() and d2[0].tolist() == [0.0] * 4,
          f"ties across a slice boundary: {idx[0].tolist()}")
    check(int(dup[0]) < length <= int(dup[-1]), "ties not across a boundary")
    exact(q, r, m, 4, 2, "ties across a slice boundary")
    # one slice of three masked whole; at most 2 live refs in a slice of 4
    q, r, m = grid_case(torch, rng, 16, 96)
    m[32:64] = False
    exact(q, r, m, 5, 3, "a masked slice")
    q, r, m = grid_case(torch, rng, 16, 128)
    m[:] = False
    m[[3, 40, 41, 70, 127]] = True
    exact(q, r, m, 4, 4, "fewer than k live refs in a slice")
    print(f"splits: kernel = plain at forced slices {FORCED_SPLITS} "
          f"({cases} cases), ties across a boundary, a masked slice, fewer "
          f"than k live refs in a slice: ok", flush=True)


def capture_knn_calls(torch, sweeps, device):
    """The tensors (query, ref, mask, k) of the first edge call and the
    first plane call of sweep CAPTURE_SWEEP + 1, after the sweeps before
    it have filled the maps."""
    from mvil_fusion_torch.ops import loam_icp
    comp, mapper = make_stage(device)
    for s in sweeps[:CAPTURE_SWEEP]:
        map_sweep(mapper, s, *stage_inputs(torch, comp, s))
    calls, real = [], loam_icp.knn_topk

    def record(q, r, m, k):
        calls.append((q.clone(), r.clone(), m.clone(), k))
        return real(q, r, m, k)

    s = sweeps[CAPTURE_SWEEP]
    staged = stage_inputs(torch, comp, s)
    loam_icp.knn_topk = record
    try:
        map_sweep(mapper, s, *staged)
    finally:
        loam_icp.knn_topk = real
    torch.cuda.synchronize()
    edge = next(c for c in calls if c[1].shape[0] == EDGE_SHAPE[1])
    plane = next(c for c in calls if c[1].shape[0] == MAIN_SHAPE[1])
    return {"edges": edge, "planes": plane}


def phase_path_data(torch, K, sweeps, card):
    """The kernel on the path's own tensors: against plain, and timed;
    returns {call: kernel ms}."""
    out = {}
    for what, (q, r, m, k) in capture_knn_calls(torch, sweeps,
                                                "cuda:0").items():
        nq, nr, live = q.shape[0], r.shape[0], int(m.sum())
        err, agree = compare_with_plain(torch, K, q, r, m, k,
                                        f"path data, {what}")
        check(live > 0, f"path data, {what}: the map is empty")
        ms, call_ms, plain_ms = knn_times(torch, K, q, r, m, k)
        bound, by = knn_bound_ms(nq, nr, k, live)
        print(f"path data: knn_topk ({nq}, {nr}, k={k}) {what} of sweep "
              f"{CAPTURE_SWEEP + 1}, {live} live refs: ok, max|d2 err| "
              f"{err:.3g}, idx agree {agree:.5f}; kernel {ms:.4f} ms on the "
              f"device, {call_ms:.4f} ms a call, plain {plain_ms:.4f} ms, "
              f"bound {bound:.5f} ms ({by}), share of bound "
              f"{bound / ms:.4f} [{card}]", flush=True)
        out[what] = ms
    return out


def make_sweeps():
    """40 synthetic sweeps with truth and drifting odometry: the truth plus
    a random walk of N(0, 0.01) m per sweep per axis, true rotation."""
    from mvil_fusion_torch.io.synthetic import SyntheticTrajectory
    from mvil_fusion_torch.io.synthetic_lidar import BoxWorld, simulate_sweep
    traj = SyntheticTrajectory(duration=8.0, w_amp=(0.2, 0.15, 0.4),
                               w_freq=(0.2, 0.15, 0.25),
                               p_amp=(1.5, 1.2, 0.3),
                               p_freq=(0.2, 0.25, 0.15),
                               lin_vel=(0.5, 0.25, 0.0))
    rng = np.random.default_rng(SEED)
    drift = np.zeros(3)
    sweeps = []
    for i in range(N_SWEEPS):
        t0 = 0.8 + 0.1 * i
        s = simulate_sweep(BoxWorld(), traj, t0, n_azimuth=900)
        drift += rng.normal(scale=0.01, size=3)
        p0, q0 = traj.pose_at(t0)
        p1, q1 = traj.pose_at(t0 + 0.1)
        f32 = np.float32
        sweeps.append(dict(t0=t0, pts=s["pts"], mask=s["mask"],
                           truth=p1, odom=((p0 + drift).astype(f32),
                                           q0.astype(f32),
                                           (p1 + drift).astype(f32),
                                           q1.astype(f32))))
    return sweeps


def make_stage(device):
    """The stage's compensator and mapper on `device`, at the default
    SystemConfig."""
    from mvil_fusion_torch.config import SystemConfig
    from mvil_fusion_torch.frontend.lidar_compensator import LidarCompensator
    from mvil_fusion_torch.mapping.local_mapping import LocalMapper
    cfg = SystemConfig()
    return LidarCompensator(cfg, device=device), LocalMapper(cfg,
                                                             device=device)


def stage_inputs(torch, comp, s):
    """A raw host sweep and its odometry onto the device: the compensated
    sweep and the odometry poses as tensors."""
    sw = comp.process(s["t0"], s["pts"], s["mask"])
    return sw, [torch.as_tensor(v, device=comp.device) for v in s["odom"]]


def map_sweep(mapper, s, sw, odom):
    """deskew_to_end between the odometry poses, then process_full."""
    from mvil_fusion_torch.ops import deskew
    period = mapper.cfg.lidar.scan_period
    pts = deskew.deskew_to_end(sw.pts, sw.rel_time, *odom, period)
    return mapper.process_full(s["t0"] + period, pts, sw.ring, sw.rel_time,
                               sw.mask, None, odom[2], odom[3], n_rings=16,
                               n_azimuth=1024, scan_period=period)


def run_slice(torch, sweeps, device):
    """The mapping stage, sweep by sweep; returns (mapper, seconds per
    sweep, the submaps it emitted).  Each sweep ends in process_full's
    pack readback."""
    comp, mapper = make_stage(device)
    secs, subs = [], []
    for s in sweeps:
        t = time.perf_counter()
        sm = map_sweep(mapper, s, *stage_inputs(torch, comp, s))
        secs.append(time.perf_counter() - t)
        if sm is not None:
            subs.append(sm)
    return mapper, secs, subs


LOOP_SCANS = 32
LOOP_SIDE = 4


def loop_config():
    """The default SystemConfig with the loop gates cut to a 16-scan lap."""
    from mvil_fusion_torch.config import GlobalMappingConfig, SystemConfig
    return SystemConfig(global_mapping=GlobalMappingConfig(
        skip_recent_poses=6, poses_before_reclosing=4,
        proximity_threshold=4.0, max_tolerable_fitness=0.6))


def make_loop_submaps(n=LOOP_SCANS, side=LOOP_SIDE):
    """Keyed scans along a square path (`side` steps of 2.8 m a side) in a
    40 × 34 × 8 m box room, 5000 rays each, with odometry that drifts by
    N(0, 0.04) + (0.01, 0.008, 0) m per step: (submaps, true positions)."""
    from mvil_fusion_torch.io.synthetic_lidar import BoxWorld
    from mvil_fusion_torch.mapping.local_mapping import Submap
    from mvil_fusion_torch.utils import nplie
    rng = np.random.default_rng(SEED)
    box = BoxWorld(room=(40.0, 34.0, 8.0))
    p, yaw, drift = np.zeros(3), 0.0, np.zeros(3)
    subs, truth = [], []
    for k in range(n):
        if k and k % side == 0:
            yaw += np.pi / 2
        if k:
            p = p + 2.8 * np.asarray([np.cos(yaw), np.sin(yaw), 0.0])
        q = np.asarray([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])
        dirs = rng.normal(size=(5000, 3))
        dirs[:, 2] *= 0.25
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        rr = box.ray_range(p, dirs @ nplie.quat_to_mat(q).T)
        pts_b = (dirs * rr[:, None])[rr < 60.0].astype(np.float32)
        drift += rng.normal(scale=0.04, size=3) + np.asarray([0.01, 0.008,
                                                              0])
        f32 = np.float32
        subs.append(Submap(t=float(k), p_w=(p + drift).astype(f32),
                           q_w=q.astype(f32), pts=pts_b,
                           odom_p=(p + drift).astype(f32),
                           odom_q=q.astype(f32)))
        truth.append(p.copy())
    return subs, np.array(truth)


def make_helix_graph(n=512, e=2048):
    """A 512-node, 2048-edge pose graph as numpy arrays: a helix whose
    chain drifts by N(0, 0.03) m per step, cross-braced up to the edge
    budget with true relative positions; (arrays, true positions)."""
    rng = np.random.default_rng(SEED + 5)
    ident = np.asarray([1, 0, 0, 0], np.float32)
    th = np.linspace(0, 8 * np.pi, n)
    p_true = np.stack([10 * np.cos(th), 10 * np.sin(th),
                       np.linspace(0, 12, n)], 1).astype(np.float32)
    steps = np.diff(p_true, axis=0) + rng.normal(scale=0.03, size=(n - 1, 3))
    p_est = np.concatenate([p_true[:1], p_true[0] + np.cumsum(steps, 0)])
    e_i = np.concatenate([np.arange(n - 1), np.zeros(e - n + 1, int)])
    e_j = np.concatenate([np.arange(1, n), np.zeros(e - n + 1, int)])
    k = n - 1
    while k < e:
        i, j = sorted(rng.integers(0, n, 2).tolist())
        if i != j:
            e_i[k], e_j[k] = i, j
            k += 1
    e_w = np.where(np.arange(e) < n - 1, 10.0, 5.0).astype(np.float32)
    arrays = dict(
        p=p_est.astype(np.float32), q=np.tile(ident, (n, 1)),
        node_mask=np.ones(n, bool), e_i=e_i, e_j=e_j,
        e_dp=p_true[e_j] - p_true[e_i], e_dq=np.tile(ident, (e, 1)),
        e_w=e_w, e_mask=np.ones(e, bool), z_node=np.zeros(64, int),
        z_val=np.zeros(64, np.float32), z_w=np.zeros(64, np.float32),
        z_mask=np.zeros(64, bool))
    return arrays, p_true


def timed_add(torch, gm, sm):
    """add_submap with everything it queued finished: (info, ms, host
    readbacks it made)."""
    before = gm.readbacks
    t = time.perf_counter()
    info = gm.add_submap(sm)
    torch.cuda.synchronize()
    return info, 1e3 * (time.perf_counter() - t), gm.readbacks - before


def phase_chained(torch, subs, sweeps, card):
    """The local mapper's submaps through the global mapper."""
    from mvil_fusion_torch.config import SystemConfig
    from mvil_fusion_torch.mapping.global_mapping import GlobalMapper
    gm = GlobalMapper(SystemConfig())
    check(gm.device.type == "cuda" and gm.scans.is_cuda,
          "the global mapper is not on the card")
    runs = [timed_add(torch, gm, sm) for sm in subs]
    reg, g = gm.last_registration, gm.cfg.global_mapping
    period = gm.cfg.lidar.scan_period
    at = min(range(len(sweeps)),
             key=lambda i: abs(sweeps[i]["t0"] + period - subs[1].t))
    err = float(np.linalg.norm(runs[1][0]["p"] - sweeps[at]["truth"]))
    print(f"chained: {len(subs)} submaps of {[len(sm.pts) for sm in subs]} "
          f"points: nodes {gm.n_nodes}, edges {gm.n_edges}; registration "
          f"of node 1: fitness {reg['fitness']:.4f}, n_corr "
          f"{reg['n_corr']}; node 1 is {err:.4f} m from the truth at sweep "
          f"{at + 1}; add_submap {runs[0][1]:.2f} and {runs[1][1]:.2f} ms, "
          f"readbacks {[r[2] for r in runs]} [{card}]", flush=True)
    check(gm.n_nodes == 2 and gm.n_edges >= 1,
          f"{gm.n_nodes} nodes, {gm.n_edges} edges")
    check(reg["node"] == 1 and reg["fitness"] < g.max_tolerable_fitness
          and reg["n_corr"] > 100, f"registration rejected: {reg}")
    check(bool(np.isfinite(runs[1][0]["p"]).all()) and err < 0.10,
          f"node 1 is {err} m from the truth")


def phase_loop(torch, card):
    """Two laps of the square loop at the default capacities; returns the
    mapper."""
    from mvil_fusion_torch.mapping import global_mapping as G
    subs, truth = make_loop_submaps()
    gm = G.GlobalMapper(loop_config())
    check((gm.n_max, gm.e_max, gm.z_max) == (512, 2048, 512)
          and gm.scans.shape == (512, 8192, 3), "not the default capacities")
    runs = [timed_add(torch, gm, sm) for sm in subs]
    est = np.array([p for _, p, _ in gm.trajectory()])
    odom = np.array([sm.p_w for sm in subs])
    lap = slice(LOOP_SCANS - 4 * LOOP_SIDE, LOOP_SCANS)
    err = np.linalg.norm(est - truth, axis=1)[lap].mean()
    odom_err = np.linalg.norm(odom - truth, axis=1)[lap].mean()
    cloud = gm.global_map()
    ms = [r[1] for r in runs]
    closing = [k for k, r in enumerate(runs) if r[0]["closed_loop"]]
    plain = sorted({r[2] for r in runs[1:] if not r[0]["closed_loop"]})
    print(f"loop: {LOOP_SCANS} keyed scans, two laps: nodes {gm.n_nodes}, "
          f"edges {gm.n_edges}, loops closed {gm.loops_closed} at scans "
          f"{closing} {gm.loop_pairs}; last-lap mean position error "
          f"{err:.4f} m (odometry {odom_err:.4f} m); global map "
          f"{len(cloud)} points; add_submap median "
          f"{statistics.median(ms[1:]):.2f} ms, max {max(ms[1:]):.2f} ms "
          f"(scan {int(np.argmax(ms[1:])) + 1}); readbacks per add_submap: "
          f"first 0, without a loop {plain}, loop-closing "
          f"{[runs[k][2] for k in closing]} [{card}]", flush=True)
    check(gm.n_nodes == LOOP_SCANS, f"{gm.n_nodes} nodes")
    check(gm.loops_closed >= 1, "no loop closed")
    check(bool(np.isfinite(est).all()) and bool(
        np.isfinite(gm.q_host).all()), "a pose is not finite")
    check(err < odom_err, f"last-lap error {err} not below the odometry's "
                          f"{odom_err}")
    check(len(cloud) > 1000 and bool(np.isfinite(cloud).all()),
          f"global map of {len(cloud)} points")
    check(runs[0][2] == 0 and plain == [1],
          f"readbacks without a loop: first {runs[0][2]}, later {plain}")
    return gm


def phase_solver(torch, gm, card):
    """solve_cg at capacity, then the registration's two parts alone on
    the loop run's scans."""
    from mvil_fusion_torch.mapping import global_mapping as G
    from mvil_fusion_torch.mapping import pose_graph as pg
    from mvil_fusion_torch.ops import vgicp, voxel
    arrays, p_true = make_helix_graph()
    graph = pg.graph_from_numpy(arrays)
    check(graph.p.is_cuda, "the graph is not on the card")
    kw = dict(iters=8, cg_iters=64)
    stats, exact = {}, {}
    out = pg.solve_cg(graph, stats=stats, **kw)
    pg.solve_cg(graph, check_every=1, stats=exact, **kw)
    err0 = np.linalg.norm(arrays["p"] - p_true, axis=1).max()
    err1 = np.linalg.norm(out.p.cpu().numpy() - p_true, axis=1).max()
    ms = time_ms(torch, lambda: pg.solve_cg(graph, **kw), reps=5, warmup=1)
    print(f"solver: solve_cg at 512 nodes, 2048 edges: max error "
          f"{err0:.4f} -> {err1:.4f} m; {ms:.2f} ms per solve; "
          f"{exact['lm_queued']} LM and {exact['cg_queued']} CG iterations "
          f"taken ({stats['cg_queued']} queued), {stats['syncs']} host "
          f"syncs per solve [{card}]", flush=True)
    check(bool(np.isfinite(err1)) and err1 < 0.2 * err0,
          f"solve_cg: max error {err0} -> {err1}")

    leaf, lid = gm.cfg.lidar.vgicp_resolution, gm.cfg.lidar
    ref_pts, ref_mask = gm._world_scans(range(5))
    ref_pts, ref_mask = ref_pts.reshape(-1, 3), ref_mask.reshape(-1)
    scan, scan_mask = gm.scans[5], gm.scan_masks[5]

    def build_ref():
        return voxel.build_gaussian_voxel_map(ref_pts, ref_mask, leaf,
                                              table_size=G.REF_TABLE)

    ref_map = build_ref()
    src_map = voxel.build_gaussian_voxel_map(scan, scan_mask, leaf,
                                             table_size=G.SCAN_TABLE)
    reg = voxel.voxel_downsample(scan, scan_mask, leaf, G.REG_POINTS,
                                 table_size=G.SCAN_TABLE)
    p0 = torch.as_tensor(gm.p_host[5]).to(gm.device)
    q0 = torch.as_tensor(gm.q_host[5]).to(gm.device)

    def align():
        return vgicp.vgicp_align(reg.pts, reg.mask, ref_map, src_map, p0, q0,
                                 iters=lid.vgicp_iters,
                                 max_corr_dist=lid.max_corr_dist)

    res = align()
    n_corr, fitness = int(res.n_corr), float(res.fitness)
    build_ms = time_ms(torch, build_ref, reps=10, warmup=2)
    align_ms = time_ms(torch, align, reps=10, warmup=2)
    print(f"solver: build_gaussian_voxel_map of {int(ref_mask.sum())} live "
          f"points in {ref_pts.shape[0]} (table 2^17): {build_ms:.3f} ms; "
          f"vgicp_align of {int(reg.mask.sum())} points in "
          f"{G.REG_POINTS}, {lid.vgicp_iters} iterations: {align_ms:.3f} ms "
          f"(n_corr {n_corr}, fitness {fitness:.4f}) [{card}]", flush=True)
    check(n_corr > 100 and fitness < 0.6,
          f"vgicp_align alone: n_corr {n_corr}, fitness {fitness}")


def main() -> int:
    import torch
    check(torch.cuda.is_available(),
          "no CUDA device (torch.cuda.is_available() is False)")

    # 1. device
    card = card_line()
    from mvil_fusion_torch.utils.precision import set_fp32_policy
    set_fp32_policy()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"device: {kind}, {torch.cuda.device_count()} card(s); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build
    from mvil_fusion_torch import _build
    from mvil_fusion_torch.ops import knn_topk as K
    lib = _build.library_path("knn_topk")
    existed = lib.exists()
    t = time.perf_counter()
    K._launcher()
    print(f"build: knn_topk {'loaded' if existed else 'built'} in "
          f"{time.perf_counter() - t:.2f} s: {lib.parent.name}/{lib.name}",
          flush=True)

    # 3. kernel vs plain
    max_err, path = phase_kernel(torch, K, card)
    main_ms, main_call_ms, main_plain_ms, main_bound_ms, main_bound_by = \
        path[MAIN_SHAPE]
    phase_splits(torch, K)
    sweeps = make_sweeps()
    path_ms = phase_path_data(torch, K, sweeps, card)

    # 4. the slice on the card
    K.knn_topk_cuda.launches = 0
    mapper, secs, subs = run_slice(torch, sweeps, "cuda:0")
    launches = K.knn_topk_cuda.launches
    torch.cuda.synchronize()
    est = np.array([p for _, p, _ in mapper.trajectory])
    truth = np.array([s["truth"] for s in sweeps])
    odom = np.array([s["odom"][2] for s in sweeps])
    check(est.shape == (N_SWEEPS, 3) and bool(np.isfinite(est).all()),
          "mapped poses missing or not finite")
    err = np.linalg.norm(est - truth, axis=1)
    odom_err = np.linalg.norm(odom - truth, axis=1)
    ms_sweep = 1e3 * statistics.median(secs[1:])
    print(f"slice: {N_SWEEPS} sweeps of 16x900 points: mapped error mean "
          f"{err.mean():.4f} m, max {err.max():.4f} m, end {err[-1]:.4f} m "
          f"(odometry mean {odom_err.mean():.4f} m); submaps "
          f"{mapper.submaps_emitted}; knn launches {launches}; median "
          f"{ms_sweep:.2f} ms per sweep [{card}]", flush=True)
    check(err.mean() < 0.5 * odom_err.mean(),
          f"mean error {err.mean()} not below half the odometry's")
    check(err.max() < 0.06, f"max error {err.max()}")
    check(mapper.submaps_emitted == 2,
          f"{mapper.submaps_emitted} submaps, expected 2")
    check(launches == 6 * N_SWEEPS,
          f"{launches} knn launches, expected {6 * N_SWEEPS}")

    # 5-7. the global-mapping stage on the card
    phase_chained(torch, subs, sweeps, card)
    phase_solver(torch, phase_loop(torch, card), card)

    print(json.dumps({"kernels": [{
        "name": "knn_topk", "route": "cuda",
        "source": "mvil_fusion_torch/csrc/knn_topk.cu",
        "replaces": "mvil_fusion_tpu/ops/pallas_knn.py:145",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_ms, "call_ms": main_call_ms, "plain_ms": main_plain_ms,
        "bound_ms": main_bound_ms, "bound_by": main_bound_by,
        "library_ms": None, "edge_ms": path[EDGE_SHAPE][0],
        "path_data_ms": path_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
