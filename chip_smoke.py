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
   plain version's (CUDA events, median of 20 after 3 warm-ups);
4. slice: the LOAM local-mapping stage at the reference sensor's full size
   (16 rings × 900 azimuth steps, 14,400 points per sweep; the default
   SystemConfig's map capacities) for 40 sweeps of a synthetic box room
   with drifting odometry: LidarCompensator.process → deskew_to_end →
   LocalMapper.process_full on cuda:0.  Gates: mean mapped position error
   below half the odometry's, maximum below 0.06 m, 2 submaps, and exactly
   6 k-NN kernel launches per sweep.

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


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=20, warmup=3) -> float:
    """Median milliseconds of fn() on the card, by CUDA events."""
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


def phase_kernel(torch, K, card):
    rng = np.random.default_rng(SEED)
    max_err, main = 0.0, None
    for nq, nr, k, what in KNN_SHAPES:
        q = rng.uniform(-60, 60, (nq, 3)).astype(np.float32)
        r = rng.uniform(-60, 60, (nr, 3)).astype(np.float32)
        m = rng.uniform(size=nr) >= 0.2
        if what == "all masked":
            m[:] = False
        q, r, m = (torch.as_tensor(a).cuda() for a in (q, r, m))
        idx_k, d2_k = K.knn_topk_cuda(q, r, m, k)
        torch.cuda.synchronize()
        idx_p, d2_p = K.knn_topk_plain(q, r, m, k)
        fin = torch.isfinite(d2_p)
        check(bool((d2_k[~fin] > 1e20).all()), f"{what}: masked slot won")
        check(bool(torch.isfinite(d2_k[fin]).all()), f"{what}: lost slot")
        err, agree = 0.0, 1.0
        if bool(fin.any()):
            diff = (d2_k[fin] - d2_p[fin]).abs()
            err = float(diff.max())
            check(bool((diff <= 1e-3 + 1e-4 * d2_p[fin].abs()).all()),
                  f"{what}: d2 differs by {err}")
            agree = float((idx_k == idx_p)[fin].float().mean())
            check(agree >= 0.99, f"{what}: index agreement {agree}")
        max_err = max(max_err, err)
        ms = time_ms(torch, lambda: K.knn_topk_cuda(q, r, m, k))
        plain_ms = time_ms(torch, lambda: K.knn_topk_plain(q, r, m, k))
        print(f"kernel: knn_topk ({nq}, {nr}, k={k}) {what}: ok, max|d2 "
              f"err| {err:.3g}, idx agree {agree:.5f}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms [{card}]", flush=True)
        if (nq, nr, k) == MAIN_SHAPE:
            main = (ms, plain_ms)
    return max_err, main


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
    sweep).  Each sweep ends in process_full's pack readback."""
    comp, mapper = make_stage(device)
    secs = []
    for s in sweeps:
        t = time.perf_counter()
        map_sweep(mapper, s, *stage_inputs(torch, comp, s))
        secs.append(time.perf_counter() - t)
    return mapper, secs


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
    max_err, (main_ms, main_plain_ms) = phase_kernel(torch, K, card)

    # 4. the slice on the card
    sweeps = make_sweeps()
    K.knn_topk_cuda.launches = 0
    mapper, secs = run_slice(torch, sweeps, "cuda:0")
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

    print(json.dumps({"kernels": [{
        "name": "knn_topk", "route": "cuda",
        "source": "mvil_fusion_torch/csrc/knn_topk.cu",
        "replaces": "mvil_fusion_tpu/ops/pallas_knn.py:145",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_ms, "plain_ms": main_plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
