#!/usr/bin/env python3
"""Where the LOAM mapping stage's time goes on one CUDA card.

    python3 profile_slice.py [--trace-dir build/profile]
    python3 profile_slice.py --knn [--splits 1,8,16,64] [--package-root DIR]
    python3 profile_slice.py --drift-runs N [--package-root DIR]

Drives the drift run of chip_smoke.py (40 sweeps of 16 × 900 points at the
default SystemConfig) on cuda:0, each phase on a fresh mapper:

0. syncs: the host syncs that one sweep's deskew + process_full makes with
   its inputs on the card and its readback deferred, by caller line, from
   torch.cuda's sync debug mode.  There should be none;
1. wall: as chip_smoke.py runs it, unprofiled: host ms per sweep, each
   sweep ending in process_full's pack readback;
2. busy: the device work of one sweep without the host in its way and
   without a profiler.  Sweep 6's deskew + process_full (deferred
   readback; sweeps 1–5 fill the map first) is captured as a CUDA graph
   and replayed, so its kernels run back to back; CUDA events time the
   replays (median of 20 after 3 warm-ups).  The stage's shapes are
   static, so every sweep queues the same device work.  It leaves out the
   compensator's upload and ring/time kernels.  The busy share is busy ms
   over the wall ms of phase 1, in the same run;
3. profile: torch.profiler over sweeps 5–14: device ms per sweep by kernel
   group, and kernel launches per sweep.  The key_averages table and a
   chrome trace go to --trace-dir.

Medians leave out the first sweep.  Prints the card's name and power
limit beside the numbers.  Needs the kernel build of chip_smoke.py (it
builds at first use).

With --knn it times the k-NN kernel alone instead: what ``nvcc -Xptxas -v``
says of it, then at the path's three shapes its time on the device, the
time of a call from the host and the plain version's, on uniform random
points and on the tensors of sweep 16's calls.  --package-root DIR takes
``mvil_fusion_torch`` from another checkout (for example the parent
commit, unpacked with git archive into a directory that git ignores), so
that two versions of the kernel can be timed in turns within one job on
one card:

    for d in build/parent . . build/parent; do
        python3 profile_slice.py --knn --package-root $d; done

With --drift-runs N it repeats the drift run N times instead and prints
each run's mapped error: the card's float atomics make the maps, and so
the poses, vary from run to run of the same code.
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import re
import statistics
import sys
import warnings

import chip_smoke as smoke

PROFILED = range(4, 14)        # sweeps 5–14
GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("knn_topk", ("knn_topk",)),
    ("gemm/gemv", ("gemm", "gemv", "cutlass", "sm90_xmma")),
    ("lu/solve", ("getrf", "getrs", "trsm", "lu_", "batch_lu")),
    ("sort/topk", ("sort", "radix", "topk", "bitonic")),
    ("scatter/index_add", ("index", "scatter", "indexing")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("memcpy/memset", ("memcpy", "memset")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def sync_sites(torch, sweeps):
    """{caller file:line: count} of the host syncs in one deferred sweep
    (the third; the first two warm the mapper) with its inputs staged."""
    comp, mapper = smoke.make_stage("cuda:0")
    mapper.defer_pack = True
    for s in sweeps[:2]:
        smoke.map_sweep(mapper, s, *smoke.stage_inputs(torch, comp, s))
    mapper.flush()
    staged = smoke.stage_inputs(torch, comp, sweeps[2])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            smoke.map_sweep(mapper, sweeps[2], *staged)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    mapper.flush()
    root = pathlib.Path(__file__).resolve().parent
    sites = collections.Counter()
    for w in caught:
        if "called a synchronizing" not in str(w.message):
            continue                  # e.g. the mode's own prototype notice
        f = pathlib.Path(w.filename).resolve()
        sites[f"{f.relative_to(root) if f.is_relative_to(root) else f}"
              f":{w.lineno}"] += 1
    return sites


def busy_ms(torch, sweeps, reps: int = 20) -> float:
    """Device ms of sweep 6's deskew + process_full, replayed as a CUDA
    graph (median of `reps` replays after 3 warm-ups)."""
    from mvil_fusion_torch.mapping.local_mapping import DEVICE_STATE
    comp, mapper = smoke.make_stage("cuda:0")
    mapper.defer_pack = True
    for s in sweeps[:5]:
        smoke.map_sweep(mapper, s, *smoke.stage_inputs(torch, comp, s))
    mapper.flush()
    staged = smoke.stage_inputs(torch, comp, sweeps[5])
    # the graph reads the state the sweep starts from: keep it alive, since
    # the capture rebinds the mapper's attributes to the graph's outputs
    state = [getattr(mapper, n) for n in DEVICE_STATE]
    graph = torch.cuda.CUDAGraph()
    # relaxed: the pinned-memory allocator of the deferred readback queries
    # its events while the stream is capturing
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        smoke.map_sweep(mapper, sweeps[5], *staged)
    times = []
    for i in range(3 + reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        if i >= 3:
            times.append(a.elapsed_time(b))
    del graph, state
    return statistics.median(times)


def profile(torch, sweeps, trace_dir: pathlib.Path):
    """Device ms per sweep by kernel group, kernels and runtime launches
    per sweep, over the PROFILED sweeps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    comp, mapper = smoke.make_stage("cuda:0")
    for s in sweeps[:PROFILED.start]:
        smoke.map_sweep(mapper, s, *smoke.stage_inputs(torch, comp, s))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        for s in sweeps[PROFILED.start:PROFILED.stop]:
            smoke.map_sweep(mapper, s, *smoke.stage_inputs(torch, comp, s))
        torch.cuda.synchronize()
    n = len(PROFILED)
    groups: dict[str, float] = {}
    kernels = launches = 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:      # kernels, copies, sets
            g = _group(ev.key)
            groups[g] = groups.get(g, 0.0) + ev.device_time_total  # µs
            kernels += ev.count
        if ev.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches += ev.count
    trace_dir.mkdir(parents=True, exist_ok=True)
    (trace_dir / "key_averages.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))
    prof.export_chrome_trace(str(trace_dir / "slice_trace.json"))
    per_sweep = {g: us / 1e3 / n for g, us in sorted(
        groups.items(), key=lambda kv: -kv[1])}
    return per_sweep, kernels / n, launches / n


def knn_alone(torch, sweeps, card, splits=()) -> None:
    """The k-NN kernel of the package in use, alone: its resources, then
    its times at the path's shapes on random points and on path data, and
    its device time at each forced number of slices in `splits`."""
    import numpy as np
    from mvil_fusion_torch import _build
    from mvil_fusion_torch.ops import knn_topk as K
    if hasattr(_build, "resource_usage"):
        for line in _build.resource_usage("knn_topk").splitlines():
            if "Compiling entry" in line:
                print("ptxas:", line.split("'")[1], flush=True)
            elif "registers" in line or "spill" in line:
                print("ptxas:  ", line.replace("ptxas info    :", "").strip(),
                      flush=True)
    rng = np.random.default_rng(smoke.SEED)
    cases = []
    for nq, nr, k in smoke.PATH_SHAPES:
        cases.append(("random", *smoke.random_case(torch, rng, nq, nr), k))
    for what, (q, r, m, k) in smoke.capture_knn_calls(torch, sweeps,
                                                      "cuda:0").items():
        cases.append((f"sweep {smoke.CAPTURE_SWEEP + 1} {what}", q, r, m, k))
        if what == "planes":
            cases.append((f"sweep {smoke.CAPTURE_SWEEP + 1} {what}, "
                          "intensity", q, r, m, 10))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    for what, q, r, m, k in cases:
        ms, call_ms, plain_ms = smoke.knn_times(torch, K, q, r, m, k)
        # the call's device kernels one by one, mean µs over 20 calls
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                K.knn_topk_cuda(q, r, m, k)
            torch.cuda.synchronize()
        parts = ", ".join(
            f"{re.search(r'knn_topk_[a-z_]+', ev.key).group(0)} "
            f"{ev.device_time_total / ev.count:.2f} µs"
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and "knn_topk_" in ev.key)
        print(f"knn: ({q.shape[0]}, {r.shape[0]}, k={k}) {what}, "
              f"{int(m.sum())} live refs: kernel {ms:.4f} ms on the device "
              f"({parts}), {call_ms:.4f} ms a call, plain {plain_ms:.4f} ms "
              f"[{card}]", flush=True)
        if splits:
            forced = ", ".join(
                f"S={n} " + format(smoke.device_ms(
                    torch, lambda: K.knn_topk_cuda(q, r, m, k, _splits=n)),
                    ".4f") for n in splits)
            print(f"knn:   device ms at forced slices: {forced}", flush=True)


def drift_spread(torch, sweeps, runs: int, card) -> None:
    """Mean and maximum mapped position error of `runs` drift runs."""
    import numpy as np
    truth = np.array([s["truth"] for s in sweeps])
    for i in range(runs):
        mapper, _ = smoke.run_slice(torch, sweeps, "cuda:0")
        est = np.array([p for _, p, _ in mapper.trajectory])
        err = np.linalg.norm(est - truth, axis=1)
        print(f"drift run {i + 1}: mapped error mean {err.mean():.4f} m, "
              f"max {err.max():.4f} m; submaps {mapper.submaps_emitted} "
              f"[{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace-dir", default="build/profile",
                    help="where the profiler's table and trace go")
    ap.add_argument("--knn", action="store_true",
                    help="time the k-NN kernel alone and stop")
    ap.add_argument("--splits", default="", metavar="S,S,...",
                    help="with --knn: also time the kernel at these forced "
                         "numbers of reference slices")
    ap.add_argument("--drift-runs", type=int, default=0, metavar="N",
                    help="repeat the drift run N times, print each run's "
                         "mapped error and stop")
    ap.add_argument("--package-root", default=None,
                    help="take mvil_fusion_torch from this checkout")
    args = ap.parse_args()
    if args.package_root is not None:
        sys.path.insert(0, str(pathlib.Path(args.package_root).resolve()))
    import torch
    smoke.check(torch.cuda.is_available(), "no CUDA device")
    card = smoke.card_line()
    print(card, flush=True)
    import mvil_fusion_torch
    from mvil_fusion_torch.ops import knn_topk as K
    from mvil_fusion_torch.utils.precision import set_fp32_policy
    print(f"package: {pathlib.Path(mvil_fusion_torch.__file__).parent}",
          flush=True)
    set_fp32_policy()
    K._launcher()
    sweeps = smoke.make_sweeps()
    if args.knn:
        knn_alone(torch, sweeps, card,
                  [int(n) for n in args.splits.split(",") if n])
        return 0
    if args.drift_runs:
        drift_spread(torch, sweeps, args.drift_runs, card)
        return 0

    sites = sync_sites(torch, sweeps)
    print(f"syncs: {sum(sites.values())} host syncs in one deferred sweep"
          + "".join(f"; {k} x{n}" for k, n in sites.most_common()),
          flush=True)

    _, secs = smoke.run_slice(torch, sweeps, "cuda:0")
    wall = 1e3 * statistics.median(secs[1:])
    print(f"wall: {wall:.3f} ms per sweep (median of sweeps 2-"
          f"{len(sweeps)}) [{card}]", flush=True)

    b = busy_ms(torch, sweeps)
    print(f"busy: {b:.3f} ms of device work per sweep (sweep 6 as a CUDA "
          f"graph, median of 20 replays); busy share {b / wall:.3f}, idle "
          f"share {1 - b / wall:.3f} [{card}]", flush=True)

    groups, kernels, launches = profile(torch, sweeps,
                                        pathlib.Path(args.trace_dir))
    total = sum(groups.values())
    print(f"profile: sweeps {PROFILED.start + 1}-{PROFILED.stop}: "
          f"{total:.3f} ms of device time per sweep, {kernels:.0f} device "
          f"kernels/copies and {launches:.0f} kernel launches per sweep "
          f"[{card}]", flush=True)
    for g, ms in groups.items():
        print(f"  {g:<18} {ms:8.3f} ms per sweep ({ms / total:.1%})",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
