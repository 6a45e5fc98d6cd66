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
   scan, a 5 × 8192-point reference, 12 iterations): ms each;
8. tracker: the KLT front end at the default SystemConfig (640×480,
   CLAHE, 3 pyramid levels, 21×21 window, 10 iterations, 256 slots for 150
   features, min_dist 30, 256 RANSAC hypotheses, the pinhole-radtan
   camera, publishing at 10 Hz) on 60 images at 30 Hz rendered by
   SyntheticWorld.render_image (1800 landmarks on a shell 14 to 40 m away,
   seed 0, 190–240 dots in view) along the default SyntheticTrajectory,
   through FeatureTracker.process on cuda:0.  One pass counts the host
   syncs of every image (torch.cuda's sync debug mode) and times it (host
   clock, device drained); a second, on the same images, reads every
   image's table back and holds it against the landmarks' true
   projections.  Gates: 17–23 of the 60 images publish;
   every published frame after the first has ≥ 60 valid features; of the
   features alive for ≥ 5 images, ≥ 80 % stay within 1.5 px of the
   projection of the landmark they started on, taken at the offset from
   its centre at which they started (a dot's corner response peaks on its
   flank); a feature that survives
   from one published frame to the next keeps its id and a new one gets a
   higher id than any before; an image 2 s after the last restarts every
   track with new ids; no host sync on an unpublished image, one on a
   published one.  Prints ms per image (median, maximum), and kernel
   launches and device busy ms per image (torch.profiler over 10 images);
9. imu: preintegrate_batch on 6 intervals of 0.3 s of the same
   trajectory's ideal 200 Hz stream in 64 slots each: imu_residual against
   the true states below 1e-3 in every component, P symmetric and positive
   definite; triangulate_window at 256 features × 7 frames on the true
   camera poses and the landmarks' true normalized projections: depth
   within 2 % for every feature seen with ≥ 1.5° of parallax, and no host
   sync in triangulation.  Prints ms per call, kernel launches and host
   syncs of each;
10. window: the window solve of mono VIO at the default SystemConfig's
   width (W = 7, 256 feature slots, D = 112, 64 IMU slots an interval, 5
   ICP and 7 LPS rows) on a window that this script builds as
   tests/helpers.py::build_window_problem does, on tests/test_ba.py's
   strongly excited trajectory with 3000 landmarks (231 of the 256 slots
   hold a landmark seen in ≥ 3 of the 7 frames; 400 fill 39) and 0.5 px
   of observation noise.  Gates:
   (a) ba.solve, 20 iterations from perturb_state's perturbation: cost1
   below 1e-2 of cost0, position within 0.02 m, angle 0.01 rad, velocity
   0.05 m/s of the truth; (b) vio.frame_step with marginalize-old, then
   the window one frame later started from the solved frames with the new
   prior (anchor off): both within 0.05 m; (c) frame_step with
   marginalize-second-new: the prior's columns of slot W-2's pose below
   1e-6; (d) the LiDAR rows from the truth: within 0.02 m and 0.01 rad;
   with zero velocity slot W-2's speed below 1e-2 m/s and, in ba.solve,
   its position pinned within 1e-3 m; (e) the card against the port on
   the CPU on (b)'s inputs: position 1e-3 m, angle 1e-3 rad, velocity
   5e-3 m/s, inverse depth 1e-3 relative, cost1 1e-3 relative,
   the new prior's JᵀJ 1e-3 and its cost change over 1 cm / 0.01 rad
   steps 1e-3; (f) 3 host waits per step and readback (the two eigh of
   the marginalization, the readback).  Prints ms per frame_step (median
   of 20 after 3 warm-ups; host clock, device drained) at iters 8 and 4
   with either marginalization, kernel launches, device ms and busy share
   per step; the same at F = 1024 (13000 landmarks; 10 after 2), timed
   but not gated.

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
import warnings

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


# ---------------------------------------------------------------------------
# the sensor front ends of mono VIO: phases 8 and 9
# ---------------------------------------------------------------------------

TRACK_IMAGES = 60
TRACK_RATE = 30.0
TRACK_T0 = 1.0
TRACK_LANDMARKS = 1800
TRACK_RADIUS = 40.0      # landmarks on a shell 14 to 40 m away
# camera in the body frame: looking along the body's x axis, y to the right
RIC = np.asarray([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
TIC = np.asarray([0.05, -0.02, 0.01])
IMU_INTERVALS = 6
IMU_INTERVAL_S = 0.3


def count_syncs(torch, fn):
    """(fn's result, the host syncs it made) by torch.cuda's sync debug
    mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message)
                    for w in caught)


def profile_device(torch, fn):
    """fn() under torch.profiler: (kernel launches, device ms, {kernel
    name: [count, device ms]})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, kernels = 0, {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            kernels[ev.key] = [ev.count, ev.device_time_total / 1e3]
        if ev.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches += ev.count
    return launches, sum(ms for _, ms in kernels.values()), kernels


def make_camera_world():
    """The default trajectory with TRACK_LANDMARKS landmarks around it, and
    the default camera's pinhole parameters for project/render_image."""
    from mvil_fusion_torch.config import SystemConfig
    from mvil_fusion_torch.io.synthetic import (SyntheticTrajectory,
                                                SyntheticWorld)
    cam = SystemConfig().camera
    world = SyntheticWorld(traj=SyntheticTrajectory(duration=8.0),
                           n_landmarks=TRACK_LANDMARKS,
                           landmark_radius=TRACK_RADIUS, seed=SEED)
    view = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
                height=cam.height)
    return world, view


def make_track_images(world, view, n=TRACK_IMAGES):
    """[(t, uint8 image, true pixel of every landmark, its visibility)]."""
    frames = []
    for k in range(n):
        t = TRACK_T0 + k / TRACK_RATE
        uv, _, _, vis = world.project(t, RIC, TIC, **view)
        img = world.render_image(t, RIC, TIC, **view)
        frames.append((t, np.round(img).astype(np.uint8), uv, vis))
    return frames


def track_accuracy(frames, tables, min_age=5, radius=1.5):
    """Features against the truth.  `tables` holds every image's (ids, uv,
    valid).  A feature starts on the visible landmark nearest to where it
    was born, at some offset from its centre (the Shi-Tomasi response of a
    dot peaks on its flank, up to 3 px out; a feature born farther from
    any dot counts as wrong from the start).  Each later sighting at an
    age ≥ min_age is right if it lies within `radius` of that landmark's
    projection carrying the same offset.  Returns (sightings, share
    right)."""
    born = {}
    right = total = 0
    for (_, _, uv, vis), (ids, pts, valid) in zip(frames, tables):
        for i, p in zip(ids[valid], pts[valid]):
            if i not in born:
                d = np.linalg.norm(uv - p, axis=1)
                d[~vis] = np.inf
                j = int(np.argmin(d))
                born[i] = [j if d[j] < 3.0 else None, p - uv[j], 0]
            lm, offset, age = born[i]
            born[i][2] = age + 1
            if age + 1 >= min_age:
                total += 1
                right += lm is not None and bool(
                    np.linalg.norm(p - uv[lm] - offset) < radius)
    return total, right / max(total, 1)


def phase_tracker(torch, card):
    """The KLT front end on rendered images; see the module docstring."""
    from mvil_fusion_torch.config import SystemConfig
    from mvil_fusion_torch.frontend.feature_tracker import FeatureTracker
    cfg = SystemConfig()
    tk = cfg.tracker
    world, view = make_camera_world()
    frames = make_track_images(world, view)
    in_view = [int(f[3].sum()) for f in frames]
    check(min(in_view) >= tk.max_cnt, f"only {min(in_view)} dots in view")

    # pass 1: as a user runs it; syncs and time of every image
    tr = FeatureTracker(cfg)
    check(tr.device.type == "cuda" and tr.pts.is_cuda,
          "the tracker is not on the card")
    published, ms, syncs = [], [], []
    for t, img, _, _ in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame, n_sync = count_syncs(torch, lambda: tr.process(t, img))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        published.append(frame)
        syncs.append(n_sync)
    pubs = [f for f in published if f is not None]
    n_valid = [int(f.valid.sum()) for f in pubs]
    for prev, cur in zip(pubs, pubs[1:]):
        gap = round((cur.t - prev.t) * TRACK_RATE)
        kept = cur.valid & prev.valid & (cur.track_cnt == prev.track_cnt + gap)
        check(kept.sum() >= 30, f"{kept.sum()} survivors at t={cur.t:.3f}")
        check(bool((cur.ids[kept] == prev.ids[kept]).all()),
              f"a survivor changed its id at t={cur.t:.3f}")
        fresh = cur.valid & (cur.track_cnt <= gap)
        check(bool((cur.ids[fresh] > prev.ids[prev.valid].max()).all()),
              f"a new feature reuses an id at t={cur.t:.3f}")
    # a stream gap restarts every track
    t_gap = frames[-1][0] + 2.0
    after = tr.process(t_gap, frames[-1][1])
    check(after is not None and bool(
        (after.track_cnt[after.valid] == 1).all()) and bool(
        (after.ids[after.valid] > pubs[-1].ids.max()).all()),
        "the stream gap did not restart the tracks")

    # pass 2: the same images, every image's table read back
    tr2 = FeatureTracker(cfg)
    tables = []
    for t, img, _, _ in frames:
        _, out = tr2.process_device(t, img)
        f = tr2.publish_from_packed(t, out.packed.cpu().numpy())
        tables.append((f.ids, f.uv, f.valid))
    sightings, share = track_accuracy(frames, tables)
    ages = tr2.track_cnt.cpu().numpy()

    def ten():
        for k, (_, img, _, _) in enumerate(frames[:10]):
            tr2.process_device(t_gap + 1.0 + k / TRACK_RATE, img)

    n_launch, dev_ms, _ = profile_device(torch, ten)
    launches, busy = n_launch / 10, dev_ms / 10
    n_pub = len(pubs)
    med, worst = statistics.median(ms[1:]), max(ms[1:])
    unpub = sorted({s for s, f in zip(syncs, published) if f is None})
    pub = sorted({s for s, f in zip(syncs, published) if f is not None})
    print(f"tracker: {len(frames)} images of {view['width']}x"
          f"{view['height']} at {TRACK_RATE:.0f} Hz, {min(in_view)}-"
          f"{max(in_view)} dots in view: published {n_pub}; valid features "
          f"per published frame {min(n_valid[1:])}-{max(n_valid[1:])} "
          f"(first {n_valid[0]}); {sightings} sightings at age >= 5, "
          f"{share:.4f} within 1.5 px of their landmark; longest track "
          f"{int(ages.max())} images; ids kept by survivors, restart after a "
          f"gap: ok; host syncs per image: unpublished {unpub}, published "
          f"{pub}; {med:.2f} ms per image (median), max {worst:.2f} ms, "
          f"budget {1e3 / TRACK_RATE:.1f} ms; {launches:.0f} kernel launches "
          f"and {busy:.3f} ms of device time per image (busy share "
          f"{busy / med:.3f}) [{card}]", flush=True)
    lo, hi = round(0.283 * len(frames)), round(0.383 * len(frames))
    check(lo <= n_pub <= hi, f"{n_pub} of {len(frames)} images published")
    check(min(n_valid[1:]) >= 60, f"only {min(n_valid[1:])} valid features")
    check(sightings > 20 * len(frames) and share >= 0.80,
          f"{sightings} sightings, {share} on their landmark")
    check(unpub == [0] and pub == [1],
          f"host syncs: unpublished {unpub}, published {pub}")
    return world, view


def make_imu_window(torch, world, device):
    """IMU_INTERVALS + 1 keyframes IMU_INTERVAL_S apart with the ideal
    200 Hz samples between them in 64 slots an interval: (tensors for
    preintegrate_batch, keyframe times)."""
    from mvil_fusion_torch.config import SystemConfig
    imu = SystemConfig().imu
    cap = imu.max_imu_per_frame
    times = TRACK_T0 + IMU_INTERVAL_S * np.arange(IMU_INTERVALS + 1)
    acc = np.zeros((IMU_INTERVALS, cap, 3), np.float32)
    gyr = np.zeros((IMU_INTERVALS, cap, 3), np.float32)
    dt = np.zeros((IMU_INTERVALS, cap), np.float32)
    mask = np.zeros((IMU_INTERVALS, cap), bool)
    for b in range(IMU_INTERVALS):
        a, g, d, ts = world.traj.imu_sequence(times[b], times[b + 1],
                                              imu.rate_hz)
        n = len(ts)
        check(n <= cap, f"{n} samples in {cap} slots")
        acc[b, :n], gyr[b, :n], dt[b, :n], mask[b, :n] = a, g, d, True
    zero = np.zeros((IMU_INTERVALS, 3), np.float32)
    up = lambda a: torch.as_tensor(a).to(device)
    return [up(a) for a in (acc, gyr, dt, zero, zero)], up(mask), times


def phase_imu(torch, world, view, card):
    """preintegrate_batch and triangulate_window at the window's size; see
    the module docstring."""
    from mvil_fusion_torch.config import SystemConfig
    from mvil_fusion_torch.ops import preintegration as pre
    from mvil_fusion_torch.ops import triangulate as tri
    from mvil_fusion_torch.utils import lie
    cfg = SystemConfig()
    device = "cuda:0"
    up = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(device)
    streams, mask, times = make_imu_window(torch, world, device)
    noise = pre.noise_covariance(cfg.imu.acc_n, cfg.imu.gyr_n, cfg.imu.acc_w,
                                 cfg.imu.gyr_w, device=device)

    def integrate():
        return pre.preintegrate_batch(*streams, noise, mask)

    def timed(fn):
        """(ms a call, kernel launches, host syncs) of fn."""
        _, n_sync = count_syncs(torch, fn)
        return (time_ms(torch, fn, reps=10, warmup=2),
                profile_device(torch, fn)[0], n_sync)

    out = integrate()
    states = [world.traj.state_at(t) for t in times]
    p, q, v = (up(np.stack(col)) for col in zip(*states))
    zero = torch.zeros((IMU_INTERVALS, 3), device=device)
    res = pre.imu_residual(out, p[:-1], q[:-1], v[:-1], zero, zero, p[1:],
                           q[1:], v[1:], zero, zero,
                           up(world.traj.gravity)).cpu().numpy()
    P = out.P.double().cpu()
    asym = float((P - P.transpose(1, 2)).abs().max() / P.abs().max())
    _, info = torch.linalg.cholesky_ex(0.5 * (P + P.transpose(1, 2)))
    pre_ms, pre_launches, pre_syncs = timed(integrate)
    n_steps = int(mask.sum()) - IMU_INTERVALS
    print(f"imu: preintegrate_batch of {IMU_INTERVALS} intervals x "
          f"{mask.shape[1]} slots ({n_steps} steps): max |residual| against "
          f"the true states p {np.abs(res[:, 0:3]).max():.2e}, q "
          f"{np.abs(res[:, 3:6]).max():.2e}, v "
          f"{np.abs(res[:, 6:9]).max():.2e}; P asymmetry {asym:.1e}, "
          f"positive definite {bool((info == 0).all())}; {pre_ms:.2f} ms a "
          f"call, {pre_launches} kernel launches, {pre_syncs} host syncs "
          f"[{card}]", flush=True)
    check(bool(np.isfinite(res).all()) and np.abs(res).max() < 1e-3,
          f"imu residual {np.abs(res).max()}")
    check(asym < 1e-5 and bool((info == 0).all()),
          "P is not symmetric positive definite")
    check(abs(float(out.sum_dt[0]) - IMU_INTERVAL_S) < 1e-5, "sum_dt")

    # the window's cameras and 256 landmarks seen from them
    n_feat, W = cfg.tracker.max_features_pad, IMU_INTERVALS + 1
    R_wb = lie.quat_to_mat(q.double().cpu())
    p_wc = (R_wb @ torch.as_tensor(TIC) + p.double().cpu()).numpy()
    q_wc = lie.mat_to_quat(R_wb @ torch.as_tensor(RIC))
    proj = [world.project(t, RIC, TIC, **view) for t in times]
    vis = np.stack([pr[3] for pr in proj], axis=1)               # (L,W)
    pick = np.argsort(-vis.sum(1), kind="stable")[:n_feat]
    obs = np.stack([pr[1][pick] for pr in proj], axis=1)         # (F,W,2)
    seen = vis[pick]
    start = np.argmax(seen, axis=1)
    depth = np.stack([pr[2][pick] for pr in proj], axis=1)[
        np.arange(n_feat), start]
    rays = world.landmarks[pick][:, None, :] - p_wc[None]        # (F,W,3)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    cosang = np.einsum("fwi,fvi->fwv", rays, rays)
    cosang[~(seen[:, :, None] & seen[:, None, :])] = 1.0
    parallax = np.degrees(np.arccos(np.clip(cosang.min((1, 2)), -1, 1)))
    args = (up(p_wc), up(q_wc.numpy()), up(obs),
            torch.as_tensor(seen).to(device),
            torch.as_tensor(start).to(device))

    def triangulate():
        return tri.triangulate_window(*args)

    inv, good = (a.cpu().numpy() for a in triangulate())
    wide = (parallax >= 1.5) & (seen.sum(1) >= 2)
    rel = np.abs(1.0 / inv[wide] - depth[wide]) / depth[wide]
    tri_ms, tri_launches, tri_syncs = timed(triangulate)
    print(f"imu: triangulate_window of {n_feat} features x {W} frames: "
          f"{int(good.sum())} good, {int(wide.sum())} with >= 1.5 deg of "
          f"parallax, their depth error median {np.median(rel):.2e}, max "
          f"{rel.max():.2e}; {tri_ms:.3f} ms a call, {tri_launches} kernel "
          f"launches, {tri_syncs} host syncs [{card}]", flush=True)
    check(wide.sum() >= 100 and bool(good[wide].all()),
          f"{wide.sum()} features with parallax, {good[wide].sum()} good")
    check(rel.max() < 0.02, f"depth error {rel.max()}")
    check(tri_syncs == 0, f"triangulate_window waited {tri_syncs} times")


# ---------------------------------------------------------------------------
# the window solve of mono VIO: phase 10
# ---------------------------------------------------------------------------

VIO_TRAJ = dict(duration=8.0, w_amp=(0.9, 0.8, 1.0), w_freq=(0.5, 0.4, 0.6))
VIO_RADIUS = 8.0
VIO_T0 = 1.0
VIO_DT = 0.1               # keyframes 0.1 s apart, 21 samples at 200 Hz
VIO_LANDMARKS = {256: 3000, 1024: 13000}   # ≥ 200 of 256 slots filled
VIO_NOISE_PX = 0.5         # observation noise, as tests/test_torch_frame_step
STEP_REPS = 20
STEP_WARMUP = 3


def vio_world(n_landmarks):
    """tests/test_ba.py's strongly excited trajectory with n landmarks."""
    from mvil_fusion_torch.io.synthetic import (SyntheticTrajectory,
                                                SyntheticWorld)
    return SyntheticWorld(traj=SyntheticTrajectory(**VIO_TRAJ),
                          landmark_radius=VIO_RADIUS,
                          n_landmarks=n_landmarks, seed=SEED)


def vio_window(world, t0, n_feat, noise_px, seed, W=7):
    """The counterpart of tests/helpers.py::build_window_problem on the
    port's synthetic world, in numpy: (true state, features, raw IMU
    buffers (acc, gyr, dt, mask) in imu.max_imu_per_frame slots, times).
    Identity extrinsics; up to n_feat landmarks seen in ≥ 3 frames, the
    most seen first, with their true inverse depth in the start frame;
    observations with noise_px of Gaussian noise drawn from seed."""
    from mvil_fusion_torch.config import SystemConfig
    cfg = SystemConfig()
    imu = cfg.imu
    times = t0 + VIO_DT * np.arange(W)
    p, q, v = (np.stack(c) for c in zip(*(world.traj.state_at(t)
                                          for t in times)))
    proj = [world.project(t, np.eye(3), np.zeros(3)) for t in times]
    obs_all = np.stack([pr[1] for pr in proj])             # (W,L,2)
    vis = np.stack([pr[3] for pr in proj])                 # (W,L)
    z = np.stack([pr[2] for pr in proj])
    counts = vis.sum(0)
    order = np.argsort(-counts, kind="stable")
    chosen = order[counts[order] >= 3][:n_feat]
    n = len(chosen)
    start = np.zeros(n_feat, np.int64)
    obs = np.zeros((n_feat, W, 2), np.float32)
    mask = np.zeros((n_feat, W), bool)
    inv_depth = np.ones(n_feat, np.float32)
    valid = np.zeros(n_feat, bool)
    mask[:n] = vis[:, chosen].T
    start[:n] = np.argmax(mask[:n], axis=1)
    obs[:n] = obs_all[:, chosen].transpose(1, 0, 2) + np.random.default_rng(
        seed).normal(scale=noise_px / cfg.estimator.focal_length,
                     size=(n, W, 2))
    inv_depth[:n] = 1.0 / z[start[:n], chosen]
    valid[:n] = True
    feats = dict(start=start, obs=obs,
                 vel=np.zeros((n_feat, W, 2), np.float32),
                 td_ref=np.zeros((n_feat, W), np.float32), mask=mask,
                 depth_fixed=np.zeros(n_feat, bool), valid=valid)
    cap = imu.max_imu_per_frame
    acc = np.zeros((W - 1, cap, 3), np.float32)
    gyr = np.zeros((W - 1, cap, 3), np.float32)
    dt = np.zeros((W - 1, cap), np.float32)
    imask = np.zeros((W - 1, cap), bool)
    for k in range(W - 1):
        a, g, d, ts = world.traj.imu_sequence(times[k], times[k + 1],
                                              imu.rate_hz)
        check(len(ts) <= cap, f"{len(ts)} IMU samples in {cap} slots")
        m = len(ts)
        acc[k, :m], gyr[k, :m], dt[k, :m], imask[k, :m] = a, g, d, True
    state = dict(p=p, q=q, v=v, ba=np.zeros((W, 3)), bg=np.zeros((W, 3)),
                 tic=np.zeros(3), qic=np.array([1.0, 0, 0, 0]),
                 td=np.zeros(()), inv_depth=inv_depth)
    return state, feats, (acc, gyr, dt, imask), times


def perturb(torch, s, seed, dp=0.05, dth=0.02, dv=0.05, dbias=0.005,
            dlam=0.05, keep_first=True):
    """tests/helpers.py::perturb_state on a port state."""
    from mvil_fusion_torch.estimator import state as st
    rng = np.random.default_rng(seed)
    W, F = s.window, s.num_features
    dx = np.zeros(st.pose_dim(W), np.float32)
    for k in range(1 if keep_first else 0, W):
        dx[15 * k:15 * k + 3] = rng.normal(scale=dp, size=3)
        dx[15 * k + 3:15 * k + 6] = rng.normal(scale=dth, size=3)
        dx[15 * k + 6:15 * k + 9] = rng.normal(scale=dv, size=3)
        dx[15 * k + 9:15 * k + 15] = rng.normal(scale=dbias, size=6)
    dl = rng.normal(scale=dlam, size=F).astype(np.float32)
    dev = s.p.device
    return st.apply_delta(s, torch.as_tensor(dx).to(dev),
                          torch.as_tensor(dl).to(dev))


def lidar_tables(torch, p, q, device):
    """MAX_ICP ICP constraints measured from the true poses p, q and
    MAX_LPS LPS constraints from the true orientations, all active."""
    from mvil_fusion_torch.estimator import lidar_factors as lfac
    from mvil_fusion_torch.utils import lie
    P, Q = torch.as_tensor(p), torch.as_tensor(q)
    ids = np.array([[0, 1, 2, 3], [1, 2, 4, 5], [2, 3, 5, 6], [0, 1, 5, 6],
                    [3, 4, 4, 5]])
    ai = torch.tensor([0.3, 0.5, 0.7, 0.2, 0.9], dtype=P.dtype)
    aj = torch.tensor([0.6, 0.1, 0.4, 0.8, 0.5], dtype=P.dtype)
    a, b, c, d = (torch.as_tensor(ids[:, k]) for k in range(4))
    Qi = lie.quat_slerp(Q[a], Q[b], ai)
    Pi = P[a] + (P[b] - P[a]) * ai[:, None]
    Pj = P[c] + (P[d] - P[c]) * aj[:, None]
    icp = lfac.icp_from_numpy(dict(
        ids=ids, alpha_i=ai.numpy(), alpha_j=aj.numpy(),
        trans_p=lie.quat_rotate_inv(Qi, Pj - Pi).numpy(),
        weight=np.full(lfac.MAX_ICP, 20.0), active=np.ones(lfac.MAX_ICP,
                                                            bool)),
        device=device)
    lids = np.array([[k, k + 1] for k in range(6)] + [[5, 6]])
    la = torch.linspace(0.1, 0.9, lfac.MAX_LPS, dtype=P.dtype)
    qm = lie.quat_slerp(Q[torch.as_tensor(lids[:, 0])],
                        Q[torch.as_tensor(lids[:, 1])], la)
    lps = lfac.lps_from_numpy(dict(ids=lids, alpha=la.numpy(),
                                   q_meas=qm.numpy(),
                                   active=np.ones(lfac.MAX_LPS, bool)),
                              device=device)
    return icp, lps


class VioWindow:
    """One window of phase 10 on `device`: the true state, a state
    perturbed as tests/helpers.py::perturb_state does and observations
    with noise_px of noise (both drawn from seed), and the frame step's
    other arguments."""

    def __init__(self, torch, world, t0, n_feat, device, seed,
                 noise_px=VIO_NOISE_PX):
        from mvil_fusion_torch.config import SystemConfig
        from mvil_fusion_torch.estimator import ba, factors as fac
        from mvil_fusion_torch.estimator import lidar_factors as lfac
        from mvil_fusion_torch.estimator import state as st
        from mvil_fusion_torch.ops import preintegration as pre
        cfg = SystemConfig()
        self.torch, self.device = torch, device
        state, feats, imu, self.times = vio_window(world, t0, n_feat,
                                                   noise_px, seed)
        self.np_state = state
        self.n_filled = int(feats["valid"].sum())
        W = len(self.times)
        up = lambda a, t=torch.float32: torch.as_tensor(  # noqa: E731
            np.asarray(a)).to(device=device, dtype=t)
        self.truth = st.window_state_from_numpy(state, device=device)
        self.feats = st.features_from_numpy(feats, device=device)
        self.imu = (up(imu[0]), up(imu[1]), up(imu[2]),
                    up(imu[3], torch.bool))
        self.gravity = up([0.0, 0.0, cfg.imu.g_norm])
        self.noise = pre.noise_covariance(cfg.imu.acc_n, cfg.imu.gyr_n,
                                          cfg.imu.acc_w, cfg.imu.gyr_w,
                                          device=device)
        self.focal = cfg.estimator.focal_length
        self.fix_mask = ba.make_fix_mask(W, device=device)
        self.empty_prior = fac.empty_prior(W, n_feat, device=device)
        self.icp, self.lps = lidar_tables(torch, state["p"], state["q"],
                                          device)
        self.no_icp = lfac.empty_icp(device=device)
        self.no_lps = lfac.empty_lps(device=device)
        need = np.zeros(n_feat, bool)
        need[:self.n_filled:3] = True
        self.need_depth = up(need, torch.bool)
        self.start = perturb(torch, self.truth, seed)

    def problem(self):
        """ba.BAProblem of the window with no prior and no extras."""
        from mvil_fusion_torch.estimator import ba
        from mvil_fusion_torch.ops import preintegration as pre
        W = self.truth.window
        preints = pre.preintegrate_batch(
            *self.imu[:3], self.truth.ba[:-1], self.truth.bg[:-1],
            self.noise, self.imu[3])
        eJ, er = ba.empty_extra(W, device=self.device)
        return ba.BAProblem(
            feats=self.feats, preints=preints,
            interval_mask=self.imu[3].any(dim=1), prior=self.empty_prior,
            gravity=self.gravity, anchor_ref=self.truth, extra_J=eJ,
            extra_r=er, extra_x0=self.truth, fix_mask=self.fix_mask)

    def step_args(self, state=None, prior=None, lidar=False,
                  zero_vel=False):
        """The arguments of vio.frame_step before focal, iters and
        marg_old."""
        return (self.start if state is None else state, self.feats,
                self.need_depth, *self.imu,
                self.empty_prior if prior is None else prior, self.gravity,
                self.noise, self.icp if lidar else self.no_icp,
                self.lps if lidar else self.no_lps, zero_vel, self.fix_mask)

    def step(self, args, iters, marg_old):
        from mvil_fusion_torch.estimator import vio
        return vio.frame_step(*args, self.focal, iters, marg_old)


def to_cpu(torch, args):
    """frame_step's arguments copied to the CPU."""
    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if isinstance(x, tuple):
            return type(x)(*(cpu(y) for y in x))
        return x
    return tuple(cpu(a) for a in args)


def errors(torch, s, truth):
    """(max position error m, max angle error rad, max velocity error)."""
    from mvil_fusion_torch.utils import lie
    ang = lie.quat_boxminus(s.q, truth.q).norm(dim=-1).max()
    return (float((s.p - truth.p).abs().max()), float(ang),
            float((s.v - truth.v).abs().max()))


def information(torch, prior):
    J = prior.J.double().cpu()
    return J.T @ J, J.T @ prior.r0.double().cpu()


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def prior_agreement(torch, prior, ref, n=8, scale=1e-2):
    """How far two priors of the same window disagree, as the change of
    their cost over n displacements dx of `scale` (m, rad) from ref's
    linearization point: max |Δc − Δc_ref| / max |Δc_ref|, in float64.
    Each prior is linearized at its own solved state, δ apart.  Jᵀr0 alone
    is no measure at a solved state: it is a difference of terms 10⁴ times
    larger, a one-ulp change of the state moves it by 1e-2 of itself, and
    it enters the cost of a realistic step below the quadratic term."""
    from mvil_fusion_torch.estimator import state as st
    cpu = lambda x0: type(x0)(*(x.cpu() for x in x0))  # noqa: E731
    delta = st.state_boxminus(cpu(prior.x0), cpu(ref.x0)).double()
    J, r0 = prior.J.double().cpu(), prior.r0.double().cpu()
    Jr, r0r = ref.J.double().cpu(), ref.r0.double().cpu()
    gen = torch.Generator().manual_seed(SEED)
    dx = scale * torch.randn((n, J.shape[1]), generator=gen,
                             dtype=torch.float64)
    base = r0 - J @ delta

    def change(J_, r_, d):
        return 0.5 * ((r_ + d @ J_.T) ** 2).sum(-1) - 0.5 * (r_ ** 2).sum()
    got, want = change(J, base, dx), change(Jr, r0r, dx)
    return float((got - want).abs().max() / want.abs().max())


def time_steps(torch, win, args, iters, marg_old, reps, warmup):
    """ms of one frame step and its readback, host clock, device drained:
    the median over `reps` after `warmup`."""
    from mvil_fusion_torch.estimator import vio
    ms = []
    for k in range(warmup + reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        vio.read_host_pack(win.step(args, iters, marg_old)[4])
        torch.cuda.synchronize()
        if k >= warmup:
            ms.append(1e3 * (time.perf_counter() - t))
    return statistics.median(ms)


def phase_window(torch, card):
    """The window solve of mono VIO at full width; see the module
    docstring."""
    from mvil_fusion_torch.estimator import ba, state as st, vio
    from mvil_fusion_torch.utils import lie
    dev = "cuda:0"
    F, W = 256, 7
    world = vio_world(VIO_LANDMARKS[F])
    win = VioWindow(torch, world, VIO_T0, F, dev, seed=3)
    check(win.n_filled >= 200, f"only {win.n_filled} of {F} slots filled")
    check(win.truth.p.is_cuda and st.make_window_state(W, F).p.is_cuda,
          "the window is not on the card")

    # (a) ba.solve from perturb_state's perturbation, 20 iterations
    prob = win.problem()
    c0 = float(ba.evaluate_cost(win.start, prob, win.focal))
    res = ba.solve(win.start, prob, win.focal, iters=20)
    e_p, e_th, e_v = errors(torch, res.state, win.truth)
    c1 = float(res.cost1)
    print(f"window: {F} slots, {win.n_filled} filled from "
          f"{VIO_LANDMARKS[F]} landmarks, W {W}, D {st.pose_dim(W)}; "
          f"ba.solve x20 from a perturbed state: cost {c0:.1f} -> {c1:.4g}, "
          f"{int(res.n_accepted)} steps accepted; error p {e_p:.4f} m, "
          f"angle {e_th:.4f} rad, v {e_v:.4f} m/s", flush=True)
    check(c1 < 1e-2 * c0, f"cost {c0} -> {c1}")
    check(e_p < 0.02 and e_th < 0.01 and e_v < 0.05,
          f"solve errors {e_p} {e_th} {e_v}")

    # (b) frame_step(marg_old=True), then the window one frame later with
    # the new prior (anchor off)
    args_b = win.step_args()
    s_new, prior, metrics, cost1, pack = win.step(args_b, 8, True)
    host = vio.read_host_pack(pack)
    e1 = errors(torch, s_new, win.truth)
    # the slid window as the host would start it: frames 0..W-2 are the
    # solved frames 1..W-1 (the prior's x0), the new frame and the depths
    # of the new window's features perturbed from the truth
    win2 = VioWindow(torch, world, VIO_T0 + VIO_DT, F, dev, seed=8)
    new = perturb(torch, win2.truth, 8, dp=0.02, dth=0.01, dv=0.02,
                  keep_first=False)
    start2 = new._replace(tic=prior.x0.tic, qic=prior.x0.qic,
                          td=prior.x0.td, **{
                              f: torch.cat([getattr(prior.x0, f)[:-1],
                                            getattr(new, f)[-1:]])
                              for f in ("p", "q", "v", "ba", "bg")})
    s2 = win2.step(win2.step_args(state=start2, prior=prior), 8, True)[0]
    e2 = errors(torch, s2, win2.truth)
    print(f"window: frame_step(marg_old) x8: cost1 {float(cost1):.4g}, "
          f"metrics {np.round(host[:5], 4).tolist()}, error p {e1[0]:.4f} "
          f"m; the next window with its prior (anchor off): error p "
          f"{e2[0]:.4f} m, angle {e2[1]:.4f} rad", flush=True)
    check(bool(np.isfinite(host).all()) and host[4] == 1.0,
          "host_pack not finite")
    check(e1[0] < 0.05 and e2[0] < 0.05, f"position errors {e1} {e2}")

    # (c) frame_step(marg_old=False) drops slot W-2 from the prior
    prior2 = win2.step(win2.step_args(state=start2, prior=prior), 8,
                       False)[1]
    k = W - 2
    left = float(prior2.J[:, 15 * k:15 * k + 6].abs().max())
    print(f"window: frame_step(marg_second_new): largest prior entry on "
          f"slot {k}'s pose {left:.2e} (of {float(prior2.J.abs().max()):.1f}"
          f")", flush=True)
    check(left < 1e-6 and float(prior2.J.abs().max()) > 1e-3,
          f"prior on slot {k}: {left}")

    # (d) the LiDAR rows: ICP and LPS from the truth, then zero velocity
    s_l = win.step(win.step_args(lidar=True), 8, True)[0]
    e_l = errors(torch, s_l, win.truth)
    s_z = win.step(win.step_args(lidar=True, zero_vel=True), 8, True)[0]
    v_z = float(s_z.v[k].norm())
    eJ, er = vio._extras_body(win.start, win.icp, win.lps, True)
    prob_z = prob._replace(extra_J=eJ, extra_r=er, extra_x0=win.start)
    s_pin = ba.solve(win.start, prob_z, win.focal, iters=8).state
    pin = float((s_pin.p[k] - win.start.p[k]).abs().max())
    print(f"window: with {len(win.icp.ids)} ICP and {len(win.lps.ids)} LPS "
          f"rows from the truth: error p {e_l[0]:.4f} m, angle "
          f"{e_l[1]:.4f} rad, v {e_l[2]:.4f} m/s; with zero velocity: "
          f"|v| of slot {k} {v_z:.2e} m/s, its position moved {pin:.2e} m "
          f"in the solve", flush=True)
    check(e_l[0] < 0.02 and e_l[1] < 0.01, f"lidar-row errors {e_l}")
    check(v_z < 1e-2 and pin < 1e-3, f"zero velocity: |v| {v_z}, {pin}")

    # (e) the card against the port on the CPU, same inputs as (b)
    cpu = win.step(to_cpu(torch, args_b), 8, True)
    hc = cpu[4].numpy()
    dq = float(lie.quat_boxminus(torch.as_tensor(host[9:13]),
                                 torch.as_tensor(hc[9:13])).norm())
    par = dict(p=float(np.abs(host[6:9] - hc[6:9]).max()), q=dq,
               v=float(np.abs(host[13:16] - hc[13:16]).max()),
               inv=float((np.abs(host[27:] - hc[27:])
                          / np.abs(hc[27:])).max()),
               cost=abs(host[5] - hc[5]) / abs(hc[5]),
               H=rel(*(information(torch, pr)[0] for pr in (prior, cpu[1]))),
               prior=prior_agreement(torch, prior, cpu[1]))
    print("window: card against CPU, same inputs: " + ", ".join(
        f"{k_} {v_:.2e}" for k_, v_ in par.items()), flush=True)
    check(par["p"] < 1e-3 and par["q"] < 1e-3 and par["v"] < 5e-3
          and par["inv"] < 1e-3 and par["cost"] < 1e-3 and par["H"] < 1e-3
          and par["prior"] < 1e-3, f"card against CPU: {par}")

    # (f) waits per step: the two eigh of the marginalization and the
    # readback
    waits = {}
    for marg_old in (True, False):
        _, waits[marg_old] = count_syncs(torch, lambda: vio.read_host_pack(
            win.step(args_b, 8, marg_old)[4]))
    print(f"window: host syncs per frame_step and readback: marg_old "
          f"{waits[True]}, marg_second_new {waits[False]} (expected 3)",
          flush=True)
    check(waits == {True: 3, False: 3}, f"waits per step {waits}")

    # times, launches and device ms
    for n_feat in (F, 1024):
        wt = win if n_feat == F else VioWindow(
            torch, vio_world(VIO_LANDMARKS[n_feat]), VIO_T0, n_feat, dev,
            seed=3)
        args = wt.step_args(lidar=True)
        ms = {}
        reps, warmup = (STEP_REPS, STEP_WARMUP) if n_feat == F else (10, 2)
        for iters in (8, 4):
            for marg_old in (True, False):
                ms[iters, marg_old] = time_steps(
                    torch, wt, args, iters, marg_old, reps, warmup)
        launches, dev_ms, _ = profile_device(
            torch, lambda: vio.read_host_pack(wt.step(args, 8, True)[4]))
        print(f"window: frame_step at F {n_feat} ({wt.n_filled} filled), "
              f"ms (median of {reps} after {warmup}, host clock, "
              f"device drained): iters 8 marg_old {ms[8, True]:.1f}, "
              f"marg_second_new {ms[8, False]:.1f}; iters 4 marg_old "
              f"{ms[4, True]:.1f}, marg_second_new {ms[4, False]:.1f}; "
              f"budget 50 ms; iters 8 marg_old: {launches} kernel launches, "
              f"{dev_ms:.3f} ms of device time, busy share "
              f"{dev_ms / ms[8, True]:.3f} [{card}]", flush=True)


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

    # 8-9. the sensor front ends of mono VIO on the card
    world, view = phase_tracker(torch, card)
    phase_imu(torch, world, view, card)

    # 10. the window solve of mono VIO on the card
    phase_window(torch, card)

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
