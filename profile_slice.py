#!/usr/bin/env python3
"""Where the LOAM mapping stage's time goes on one CUDA card.

    python3 profile_slice.py [--trace-dir build/profile]
    python3 profile_slice.py --knn [--splits 1,8,16,64] [--package-root DIR]
    python3 profile_slice.py --drift-runs N [--package-root DIR]
    python3 profile_slice.py --global [--trace-dir build/profile]
    python3 profile_slice.py --frontend
    python3 profile_slice.py --frame-step
    python3 profile_slice.py --count-ops

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

With --global it profiles the global-mapping stage instead, on the loop
run of chip_smoke.py (two laps, 32 keyed scans, default capacities), each
pass on a fresh GlobalMapper:

1. wall: ms per add_submap, everything it queued finished, split into
   registration (reference map + VGICP of the new scan), descriptor,
   loop search (candidates and their verification by registration), solve
   (solve_cg and the pose refresh) and the rest; medians over the
   add_submaps without a loop and over the loop-closing ones;
2. profile: torch.profiler over scans 2–14 (no loop) and over scan 15
   alone (the first loop-closing one): device ms and kernel launches per
   add_submap, the device's busy share of the wall, device ms by kernel
   group (tables to --trace-dir);
3. syncs: the host syncs of each add_submap of the first lap, counted by
   torch.cuda's sync debug mode, beside the mapper's own count of its
   readbacks;
4. spread: how far the card's float atomics move the results from run to
   run of the same code: the 5-scan reference voxel map built twice
   (means, plane normals, owners and counts), and the whole loop run
   three times (decisions, last-lap error, largest pose difference from
   the first run).

With --frontend it profiles the sensor front ends of mono VIO instead, on
the tracker run of chip_smoke.py (640×480 images at 30 Hz, the default
SystemConfig):

1. wall: ms per image as a user runs it (host clock, device drained),
   median over images 2–30, published and unpublished apart;
2. image: torch.profiler over images 13–22: kernel launches and device ms
   per image, the busy share of the wall;
3. stages: the step's parts called alone on the state and image of image
   13 (upload, CLAHE, pyramid, KLT level by level, the two lifts to the
   normalized plane, RANSAC, corner detection): launches, device ms and
   ms a call from the host, each; "rest" is the step less these (the
   min-distance mask, the refill scatter, ids, velocity, the pack);
4. imu: one preintegrate_batch (6 intervals × 64 slots) and one
   triangulate_window (256 × 7): launches, device ms by kernel group, ms a
   call.

With --frame-step it profiles the window solve of mono VIO instead, on the
F = 256 window of chip_smoke.py's phase 10 (W = 7, 64 IMU slots an
interval, 5 ICP and 7 LPS rows, 8 LM iterations, marginalize-old):

1. step: ms per vio.frame_step and its readback (host clock, device
   drained, median of 10), kernel launches, device ms and busy share from
   torch.profiler, host syncs, device ms by kernel group;
2. parts: each part of the step called alone on the step's inputs, with
   how often a step runs it: preintegration, triangulation, the extras,
   assemble (and within it the vision, IMU, prior + anchor systems), the
   Schur complement and Cholesky solve, the step and its selection,
   evaluate_cost, _gauge_fix, both marginalizations and their two eigh
   (15 × 15 and 97 × 97) alone: launches, device ms, ms a call, host
   syncs.

With --count-ops it runs on the CPU and needs no card: the aten operations
(views left out) that one frame step of that window dispatches, at iters 8
and 4 with either marginalization, and each part's.
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import re
import statistics
import sys
import time
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
        mapper, _, _ = smoke.run_slice(torch, sweeps, "cuda:0")
        est = np.array([p for _, p, _ in mapper.trajectory])
        err = np.linalg.norm(est - truth, axis=1)
        print(f"drift run {i + 1}: mapped error mean {err.mean():.4f} m, "
              f"max {err.max():.4f} m; submaps {mapper.submaps_emitted} "
              f"[{card}]", flush=True)


def _split_timers(torch, gm):
    """Wrap the mapper's parts so that each call adds its ms, with the
    device drained before and after, to the returned dict."""
    acc = collections.Counter()
    state = {"in_loop": False}

    def wrap(name, part, is_loop=False):
        inner = getattr(gm, name)

        def timed(*a, **kw):
            if state["in_loop"] and not is_loop:
                return inner(*a, **kw)      # a verification: loop search
            torch.cuda.synchronize()
            t = time.perf_counter()
            state["in_loop"] = state["in_loop"] or is_loop
            try:
                return inner(*a, **kw)
            finally:
                torch.cuda.synchronize()
                if is_loop:
                    state["in_loop"] = False
                acc[part] += 1e3 * (time.perf_counter() - t)

        setattr(gm, name, timed)

    wrap("_reference_map", "registration")
    wrap("_register", "registration")
    wrap("_store_descriptor", "descriptor")
    wrap("_try_radius_loop", "loop search", is_loop=True)
    wrap("_try_sc_loop", "loop search", is_loop=True)
    wrap("_solve", "solve")
    return acc


def global_wall(torch, subs, card) -> None:
    """Pass 1 of --global: wall ms per add_submap, split by part."""
    from mvil_fusion_torch.mapping.global_mapping import GlobalMapper
    parts = ("registration", "descriptor", "loop search", "solve", "rest")
    gm = GlobalMapper(smoke.loop_config())
    acc = _split_timers(torch, gm)
    rows = []
    for sm in subs:
        acc.clear()
        info, ms, reads = smoke.timed_add(torch, gm, sm)
        row = dict(acc, total=ms, closed=info["closed_loop"], reads=reads)
        row["rest"] = ms - sum(acc.values())
        rows.append(row)
    for what, sel in (("without a loop", [r for r in rows[1:]
                                          if not r["closed"]]),
                      ("loop-closing", [r for r in rows if r["closed"]])):
        med = lambda key: statistics.median(r.get(key, 0.0) for r in sel)
        print(f"wall: {len(sel)} add_submaps {what}: median "
              f"{med('total'):.2f} ms = " + ", ".join(
                  f"{p} {med(p):.2f}" for p in parts)
              + f"; readbacks {sorted({r['reads'] for r in sel})} [{card}]",
              flush=True)


def global_profile(torch, subs, card, trace_dir: pathlib.Path) -> None:
    """Pass 2 of --global: torch.profiler over scans 2-14, which close no
    loop, and over scan 15, which closes the first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from mvil_fusion_torch.mapping.global_mapping import GlobalMapper
    gm = GlobalMapper(smoke.loop_config())
    gm.add_submap(subs[0])
    trace_dir.mkdir(parents=True, exist_ok=True)
    for what, batch in (("without a loop", subs[1:14]),
                        ("loop-closing", subs[14:15])):
        torch.cuda.synchronize()
        closed_before = gm.loops_closed
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with torch_profile(activities=acts) as prof:
            t = time.perf_counter()
            for sm in batch:
                gm.add_submap(sm)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t)
        smoke.check(gm.loops_closed - closed_before
                    == (what == "loop-closing"), f"{what}: loops closed")
        groups: dict[str, float] = {}
        launches = 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                g = _group(ev.key)
                groups[g] = groups.get(g, 0.0) + ev.device_time_total / 1e3
            if ev.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
                launches += ev.count
        (trace_dir / f"global_key_averages_{what.split()[0]}.txt").write_text(
            prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=60))
        n, busy = len(batch), sum(groups.values())
        print(f"profile: {n} add_submap(s) {what}, under torch.profiler: "
              f"wall {wall / n:.2f} ms, device {busy / n:.3f} ms and "
              f"{launches / n:.0f} kernel launches per add_submap; busy "
              f"share {busy / wall:.3f}, idle share {1 - busy / wall:.3f}; "
              "device ms by group: " + ", ".join(
                  f"{g} {ms / n:.3f}" for g, ms in sorted(
                      groups.items(), key=lambda kv: -kv[1]))
              + f" [{card}]", flush=True)


def global_syncs(torch, subs, card) -> None:
    """Pass 3 of --global: host syncs per add_submap of the first lap."""
    from mvil_fusion_torch.mapping.global_mapping import GlobalMapper
    gm = GlobalMapper(smoke.loop_config())
    counts = []
    for sm in subs[:16]:
        before = gm.readbacks
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                info = gm.add_submap(sm)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("called a synchronizing" in str(w.message)
                    for w in caught)
        counts.append((syncs, gm.readbacks - before, info["closed_loop"]))
    print("syncs: per add_submap of the first lap, (syncs seen by the debug "
          "mode, readbacks the mapper counted): "
          + ", ".join(f"{'loop ' if c else ''}({s}, {r})"
                      for s, r, c in counts) + f" [{card}]", flush=True)


def global_spread(torch, subs, truth, card, runs: int = 3) -> None:
    """Pass 4 of --global: run-to-run spread on the card."""
    import numpy as np
    from mvil_fusion_torch.mapping import global_mapping as G
    from mvil_fusion_torch.ops import voxel
    results = []
    for _ in range(runs):
        gm = G.GlobalMapper(smoke.loop_config())
        for sm in subs:
            gm.add_submap(sm)
        results.append((gm.p_host[:len(subs)].copy(), gm.mapping_stats(),
                        list(gm.loop_pairs)))
    pts, mask = gm._world_scans(range(5))
    maps = [voxel.build_gaussian_voxel_map(
        pts.reshape(-1, 3), mask.reshape(-1), gm.cfg.lidar.vgicp_resolution,
        table_size=G.REF_TABLE) for _ in range(2)]
    occ = maps[0].count > 0
    dcov = (maps[0].cov - maps[1].cov).abs().flatten(1).amax(1)[occ]
    print(f"spread: the reference voxel map built twice ({int(occ.sum())} "
          f"voxels): owners and counts equal "
          f"{torch.equal(maps[0].coords, maps[1].coords)} and "
          f"{torch.equal(maps[0].count, maps[1].count)}; max |mean "
          f"difference| {float((maps[0].mean - maps[1].mean).abs().max()):.3g}"
          f" m; share of voxels whose regularized covariance differs by "
          f"more than 1e-2: {float((dcov > 1e-2).float().mean()):.3f} "
          f"[{card}]", flush=True)
    lap = slice(len(subs) - 16, len(subs))
    for i, (p, stats, pairs) in enumerate(results):
        err = np.linalg.norm(p - truth, axis=1)[lap].mean()
        d = np.abs(p - results[0][0])
        print(f"spread: loop run {i + 1}: {stats['loops_closed']} loops "
              f"{pairs}, {stats['edges']} edges; last-lap mean error "
              f"{err:.4f} m; from run 1: max |dxy| {d[:, :2].max():.4f} m, "
              f"max |dz| {d[:, 2].max():.4f} m [{card}]", flush=True)


def frontend_profile(torch, card) -> None:
    """--frontend: the tracker's step by stage, then the IMU window."""
    import numpy as np
    from mvil_fusion_torch.config import SystemConfig
    from mvil_fusion_torch.frontend.feature_tracker import (VIRTUAL_FOCAL,
                                                            FeatureTracker)
    from mvil_fusion_torch.ops import corners, image as im, klt, ransac
    from mvil_fusion_torch.ops import preintegration as pre
    from mvil_fusion_torch.ops import triangulate as tri
    cfg = SystemConfig()
    tk = cfg.tracker
    world, view = smoke.make_camera_world()
    frames = smoke.make_track_images(world, view, 30)

    # 1. wall
    tr = FeatureTracker(cfg)
    rows = []
    for t, img, _, _ in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = tr.process(t, img)
        torch.cuda.synchronize()
        rows.append((1e3 * (time.perf_counter() - t0), frame is not None))
    med = lambda pub: statistics.median(ms for ms, p in rows[1:] if p == pub)
    wall = statistics.median(ms for ms, _ in rows[1:])
    print(f"wall: {wall:.2f} ms per image (median of images 2-30): "
          f"{med(True):.2f} published, {med(False):.2f} unpublished; max "
          f"{max(ms for ms, _ in rows[1:]):.2f} ms [{card}]", flush=True)

    # 2. image
    tr = FeatureTracker(cfg)
    for t, img, _, _ in frames[:12]:
        tr.process_device(t, img)
    state = (tr.prev_pyr, tr.pts, tr.valid, tr.norm)
    n_launch, dev_ms, kernels = smoke.profile_device(torch, lambda: [
        tr.process_device(t, img) for t, img, _, _ in frames[12:22]])
    groups = collections.Counter()
    for name, (_, ms) in kernels.items():
        groups[_group(name)] += ms / 10
    print(f"image: {n_launch / 10:.0f} kernel launches and {dev_ms / 10:.3f} "
          f"ms of device time per image; busy share {dev_ms / 10 / wall:.3f}, "
          f"idle share {1 - dev_ms / 10 / wall:.3f}; device ms by kernel "
          "group: " + ", ".join(f"{g} {ms:.3f}"
                                for g, ms in groups.most_common())
          + f" [{card}]", flush=True)

    # 3. stages, alone, on image 13's inputs
    prev_pyr, pts, valid, prev_norm = state
    raw = frames[12][1]
    img = tr._upload(raw)
    eq = im.clahe(img)
    pyr = im.build_pyramid(eq, tk.pyramid_levels)
    stages = [("upload", lambda: tr._upload(raw)),
              ("clahe", lambda: im.clahe(img)),
              ("pyramid", lambda: im.build_pyramid(eq, tk.pyramid_levels))]
    d = torch.zeros_like(pts)
    for lvl in range(tk.pyramid_levels, -1, -1):
        def level(lvl=lvl, d=d):
            return klt._track_level(prev_pyr[lvl], pyr[lvl], pts / 2.0 ** lvl,
                                    d, tk.window_size, tk.max_iters,
                                    tk.min_eig_threshold)
        stages.append((f"klt level {lvl}", level))
        d = level()[0] * 2.0
    res = klt.track(prev_pyr, pyr, pts, valid, win=tk.window_size,
                    iters=tk.max_iters, min_eig_thr=tk.min_eig_threshold)
    x1 = prev_norm * VIRTUAL_FOCAL
    x2 = tr.camera.lift_projective(res.pts) * VIRTUAL_FOCAL
    stages += [
        ("lift x2", lambda: [tr.camera.lift_projective(res.pts)
                             for _ in range(2)]),
        ("ransac", lambda: ransac.fundamental_ransac(
            x1, x2, res.ok, threshold=tk.f_threshold, n_hyp=tk.ransac_iters,
            generator=tr.generator)),
        ("corners", lambda: corners.detect(eq, res.pts, res.ok,
                                           max_new=tk.max_cnt,
                                           min_dist=tk.min_dist))]
    total_l = total_d = 0.0
    for name, fn in stages:
        launches, ms, _ = smoke.profile_device(
            torch, lambda: [fn() for _ in range(5)])
        call_ms = smoke.time_ms(torch, fn, reps=10, warmup=2)
        total_l += launches / 5
        total_d += ms / 5
        print(f"stage: {name:<12} {launches / 5:7.0f} launches, "
              f"{ms / 5:7.3f} ms on the device, {call_ms:7.3f} ms a call "
              f"[{card}]", flush=True)
    print(f"stage: {'rest':<12} {n_launch / 10 - total_l:7.0f} launches, "
          f"{dev_ms / 10 - total_d:7.3f} ms on the device (the step less "
          f"the stages above) [{card}]", flush=True)

    # 4. the IMU window
    streams, mask, _ = smoke.make_imu_window(torch, world, "cuda:0")
    noise = pre.noise_covariance(cfg.imu.acc_n, cfg.imu.gyr_n, cfg.imu.acc_w,
                                 cfg.imu.gyr_w, device="cuda:0")
    rng = np.random.default_rng(smoke.SEED)
    n_feat, W = tk.max_features_pad, smoke.IMU_INTERVALS + 1
    q = rng.normal(size=(W, 4))
    cams = [torch.as_tensor(a.astype(np.float32)).cuda() for a in (
        rng.normal(size=(W, 3)), q / np.linalg.norm(q, axis=1, keepdims=True),
        rng.normal(scale=0.3, size=(n_feat, W, 2)))]
    seen = torch.ones((n_feat, W), dtype=torch.bool, device="cuda:0")
    start = torch.zeros((n_feat,), dtype=torch.int64, device="cuda:0")
    for name, fn in (
            ("preintegrate_batch", lambda: pre.preintegrate_batch(
                *streams, noise, mask)),
            ("triangulate_window", lambda: tri.triangulate_window(
                *cams, seen, start))):
        fn()
        launches, ms, kernels = smoke.profile_device(torch, fn)
        call_ms = smoke.time_ms(torch, fn, reps=10, warmup=2)
        _, syncs = smoke.count_syncs(torch, fn)
        groups = collections.Counter()
        for kname, (_, kms) in kernels.items():
            groups[_group(kname)] += kms
        print(f"imu: {name}: {launches} launches, {ms:.3f} ms on the device, "
              f"{call_ms:.3f} ms a call, {syncs} host syncs; device ms by "
              "kernel group: " + ", ".join(
                  f"{g} {v:.3f}" for g, v in groups.most_common())
              + f" [{card}]", flush=True)


def frame_step_parts(torch, device, iters=8):
    """The F = 256 window of chip_smoke.py's phase 10 on `device`, the
    frame step's arguments (LiDAR rows on) and its parts, each as (name,
    how often a step runs it, a call on the step's inputs); names that
    start with a blank are inside the part above them."""
    from mvil_fusion_torch.estimator import ba, factors as fac
    from mvil_fusion_torch.estimator import state as st, vio
    from mvil_fusion_torch.ops import preintegration as pre
    from mvil_fusion_torch.ops import triangulate as tri
    F = 256
    win = smoke.VioWindow(torch, smoke.vio_world(smoke.VIO_LANDMARKS[F]),
                          smoke.VIO_T0, F, device, seed=3)
    s = win.start
    eJ, er = vio._extras_body(s, win.icp, win.lps, False)
    prob = win.problem()._replace(extra_J=eJ, extra_r=er, extra_x0=s,
                                  anchor_ref=s)
    a = ba.assemble(s, prob, win.focal)
    mu = torch.full((), 1e-4, device=device)
    dx, dl, _ = ba.lm_step(a, mu, win.fix_mask)
    s_try = st.apply_delta(s, dx, dl)
    s_new = vio._gauge_fix(s, s_try)
    prob_p = prob._replace(prior=ba.marginalize_old(s_new, prob, win.focal))
    A = torch.randn(112, 112, device=device)
    parts = [
        ("preintegrate_batch", 1, lambda: pre.preintegrate_batch(
            *win.imu[:3], s.ba[:-1], s.bg[:-1], win.noise, win.imu[3])),
        ("triangulation", 1, lambda: tri.triangulate_window(
            *tri.camera_poses_from_body(s.p, s.q, s.tic, s.qic),
            win.feats.obs, win.feats.mask, win.feats.start)),
        ("extras (ICP, LPS, zero vel.)", 1, lambda: vio._extras_body(
            s, win.icp, win.lps, False)),
        ("assemble", iters, lambda: ba.assemble(s, prob, win.focal)),
        ("  vision_system", iters, lambda: fac.vision_system(
            s, win.feats, win.focal)),
        ("  imu_system", iters, lambda: fac.imu_system(
            s, prob.preints, prob.interval_mask, win.gravity)),
        ("  prior + anchor", iters, lambda: (
            fac.prior_system(prob_p.prior, s),
            fac.anchor_system(s, s, 1e3, True))),
        ("Schur + Cholesky solve", iters, lambda: ba.lm_step(
            a, mu, win.fix_mask)),
        ("apply_delta + select", iters, lambda: st.WindowState(*(
            torch.where(mu > 0, x, y) for x, y in zip(
                st.apply_delta(s, dx, dl), s)))),
        ("evaluate_cost", iters + 1, lambda: ba.evaluate_cost(
            s_try, prob, win.focal)),
        ("_gauge_fix", 1, lambda: vio._gauge_fix(s, s_try)),
        ("marginalize_old", 1, lambda: ba.marginalize_old(
            s_new, prob, win.focal)),
        ("marginalize_second_new", 0, lambda: ba.marginalize_second_new(
            s_new, prob_p)),
        ("  eigh 15x15", 0, lambda: torch.linalg.eigh(
            A[:15, :15] @ A[:15, :15].T)),
        ("  eigh 97x97", 0, lambda: torch.linalg.eigh(
            A[:97, :97] @ A[:97, :97].T)),
    ]
    return win, win.step_args(lidar=True), parts


def frame_step_profile(torch, card) -> None:
    """--frame-step: the window solve of mono VIO by part."""
    from mvil_fusion_torch.estimator import vio
    iters = 8
    win, args, parts = frame_step_parts(torch, "cuda:0", iters)

    def step():
        return vio.read_host_pack(win.step(args, iters, True)[4])

    # 1. the whole step
    wall = smoke.time_steps(torch, win, args, iters, True, 10, 3)
    launches, dev_ms, kernels = smoke.profile_device(torch, step)
    _, syncs = smoke.count_syncs(torch, step)
    groups = collections.Counter()
    for name, (_, ms) in kernels.items():
        groups[_group(name)] += ms
    print(f"step: F {win.feats.start.shape[0]}, iters {iters}, marg_old, "
          f"LiDAR rows: {wall:.1f} ms (median of 10, host clock, device "
          f"drained), {launches} kernel launches, {dev_ms:.3f} ms of device "
          f"time, busy share {dev_ms / wall:.3f}, {syncs} host syncs; "
          "device ms by kernel group: " + ", ".join(
              f"{g} {ms:.3f}" for g, ms in groups.most_common())
          + f" [{card}]", flush=True)

    # 2. its parts, alone, on the step's inputs
    total_l = total_d = 0.0
    for name, per_step, fn in parts:
        fn()
        n_l, ms, _ = smoke.profile_device(torch, fn)
        call_ms = smoke.time_ms(torch, fn, reps=10, warmup=2)
        _, n_sync = smoke.count_syncs(torch, fn)
        if not name.startswith(" "):
            total_l += per_step * n_l
            total_d += per_step * ms
        print(f"part: {name:<30} x{per_step:<2} {n_l:6d} launches, "
              f"{ms:7.3f} ms on the device, {call_ms:8.3f} ms a call, "
              f"{n_sync} host syncs [{card}]", flush=True)
    print(f"part: sum of the parts times their count per step: "
          f"{total_l:.0f} launches, {total_d:.3f} ms on the device "
          f"(the step: {launches}, {dev_ms:.3f})", flush=True)


def count_ops() -> None:
    """--count-ops: the aten operations (views left out) that one frame
    step and each of its parts dispatch, on the CPU, with no card: what
    the card would be handed kernel by kernel."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += not func.is_view
            return func(*args, **(kwargs or {}))

    def count(fn):
        with Count() as c:
            fn()
        return c.n

    win, args, parts = frame_step_parts(torch, "cpu")
    win.step(args, 8, True)
    for iters in (8, 4):
        for marg_old in (True, False):
            n = count(lambda: win.step(args, iters, marg_old))
            print(f"ops: frame_step F {win.feats.start.shape[0]} iters "
                  f"{iters} {'marg_old' if marg_old else 'marg_second_new'}"
                  f": {n}", flush=True)
    for name, per_step, fn in parts:
        print(f"ops: {name:<30} x{per_step:<2} {count(fn)}", flush=True)

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
    ap.add_argument("--global", dest="global_stage", action="store_true",
                    help="profile the global-mapping stage on the loop run "
                         "and stop")
    ap.add_argument("--frontend", action="store_true",
                    help="profile the tracker's step by stage and the IMU "
                         "window and stop")
    ap.add_argument("--frame-step", action="store_true",
                    help="profile the window solve of mono VIO by part "
                         "and stop")
    ap.add_argument("--count-ops", action="store_true",
                    help="count the operations a frame step dispatches, on "
                         "the CPU (no card needed), and stop")
    ap.add_argument("--package-root", default=None,
                    help="take mvil_fusion_torch from this checkout")
    args = ap.parse_args()
    if args.package_root is not None:
        sys.path.insert(0, str(pathlib.Path(args.package_root).resolve()))
    if args.count_ops:
        count_ops()
        return 0
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
    if args.frame_step:
        frame_step_profile(torch, card)
        return 0
    if args.frontend:
        frontend_profile(torch, card)
        return 0
    if args.global_stage:
        subs, truth = smoke.make_loop_submaps()
        global_wall(torch, subs, card)
        global_profile(torch, subs, card, pathlib.Path(args.trace_dir))
        global_syncs(torch, subs, card)
        global_spread(torch, subs, truth, card)
        return 0
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

    _, secs, _ = smoke.run_slice(torch, sweeps, "cuda:0")
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
