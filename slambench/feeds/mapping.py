"""The mapping stream: what the ``lidar_mapping`` nodes receive.

Each sweep goes through ``LidarCompensator.process`` →
``deskew_to_end`` → ``LocalMapper.process_full`` and, when the local
mapper hands over a submap, ``GlobalMapper.add_submap``: the chain of
``VilSystem._map_lidar``, at the grid width the system passes
(``pipeline/system.py::GRID_AZ``).  One lap of noiseless sweeps is cast in
set-up; every sweep that is sent gets fresh range noise from the seed
(each lap of the orbit repeats the first), and one odometry pose: the
truth plus a random walk.

The answers judged (``reference/``): the local mapper's pose of each
sweep (a sample of consecutive pairs from the window), the global
mapper's keyed poses at the close (a sample of pairs of keyed sweeps a
lap or more apart at the same place, the later in the window, which only
a closed loop keeps consistent), the deskewed points of a sample of the
window's sweeps, and that every sweep of the window has a finite pose.
"""

from __future__ import annotations

import time

import numpy as np

from slambench import generator as gen
from slambench.harness import record
from slambench.reference.compensate import (HISTORY, deskew_gap, deskewed,
                                            first_azimuth, start_azimuth)
from slambench.reference.scan_judge import Judge


class MappingStream:
    """Sweeps of the orbit, made from the seed: sweep s starts at
    ``t0 + s · period``."""

    def __init__(self, conf: dict, traffic: dict, seed: int):
        lid = conf["sensor"]["lidar"]
        self.period = 1.0 / lid["rate_hz"]
        sys_lid = conf["system"]["lidar"]
        # what the compensator is configured with, for the reference
        self.compensator = dict(
            n_rings=lid["n_rings"], fov_down_deg=lid["fov_down_deg"],
            fov_up_deg=lid["fov_up_deg"], period=sys_lid["scan_period"],
            infer_start=sys_lid["infer_start_ori"],
            min_range_m=sys_lid["min_distance"],
            max_range_m=sys_lid["max_distance"])
        self.lidar = gen.Lidar(
            lid["n_rings"], lid["n_azimuth"], lid["fov_down_deg"],
            lid["fov_up_deg"], self.period, lid["min_range_m"],
            lid["max_range_m"], np.asarray([1.0, 0, 0, 0]), np.zeros(3))
        self.noise = lid["range_noise_m"]
        self.room = gen.make_room(traffic["room"])
        self.traj = gen.make_trajectory(traffic["trajectory"], 0.0)
        self.t0 = traffic["first_sweep_s"]
        self.n_lap = int(round(traffic["trajectory"]["period_s"]
                               / self.period))
        self.n_stream = int(round(traffic["stream_s"] / self.period))
        self.seed = seed
        self.walk = traffic["odometry_walk_m"]
        self.dirs, _ = self.lidar.directions()
        self.lap = [gen.sweep_ranges(self.room, self.traj, self.lidar,
                                     self.t0 + s * self.period)
                    for s in range(self.n_lap)]
        self._drift = [np.zeros(3)]
        self._drift_rng = np.random.default_rng([seed, 1])

    def t_start(self, s):
        return self.t0 + s * self.period

    def truth(self, s):
        """The true LiDAR pose at the end of sweep s."""
        p, q = self.traj.pose_at(self.t_start(s % self.n_lap + 1))
        return p, q

    def drift(self, s):
        while len(self._drift) <= s + 1:
            self._drift.append(self._drift[-1] + self._drift_rng.normal(
                scale=self.walk, size=3))
        return self._drift[s + 1]

    def sweep(self, s):
        """(pts (N,3) float32, rel_time (N,), valid (N,)) of sweep s."""
        ranges, valid, rel = self.lap[s % self.n_lap]
        pts = gen.sweep_points(self.dirs, ranges, valid,
                               np.random.default_rng([self.seed, 0, s]),
                               self.noise)
        return pts, rel, valid

    def odometry(self, s):
        """(p_start, q_start, p_end, q_end) float32: the truth at the
        sweep's start and end plus the walk's position at sweep s."""
        d = self.drift(s)
        k = s % self.n_lap
        p0, q0 = self.traj.pose_at(self.t_start(k))
        p1, q1 = self.traj.pose_at(self.t_start(k + 1))
        f = np.float32
        return ((p0 + d).astype(f), q0.astype(f), (p1 + d).astype(f),
                q1.astype(f))


class Sample:
    """`k` items drawn evenly from a stream of unknown length (reservoir
    sampling, algorithm R) by a seeded generator."""

    def __init__(self, k, rng):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def offer(self, item):
        if self.n < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.n + 1))
            if j < self.k:
                self.items[j] = item
        self.n += 1


def run(ctx):
    """Set-up, the window and the judging of one run; returns the run's
    record (see ``run.py``)."""
    import torch
    from mvil_fusion_torch.frontend.lidar_compensator import \
        LidarCompensator
    from mvil_fusion_torch.mapping.global_mapping import GlobalMapper
    from mvil_fusion_torch.mapping.local_mapping import LocalMapper
    from mvil_fusion_torch.ops import deskew, loam_icp
    from mvil_fusion_torch.pipeline.system import GRID_AZ

    cfg, traffic, rec, dev = ctx.cfg, ctx.traffic, ctx.rec, ctx.device
    stream = MappingStream(ctx.conf, traffic, ctx.seed)
    period = stream.period
    n_rings = stream.lidar.n_rings
    comp = LidarCompensator(cfg, device=dev)
    mapper = LocalMapper(cfg, device=dev)
    gm = GlobalMapper(cfg, device=dev)
    # the deskewed sweeps judged: a sample of the window's, drawn from
    # the seed; the program's tensors are kept as they are, not copied
    kept = Sample(traffic["judge"]["deskew_sweeps"],
                  np.random.default_rng([ctx.seed, 3]))

    def step(s, keep=False):
        pts, _, valid = stream.sweep(s)
        odom_np = stream.odometry(s)
        with rec.span("local_map.sweep", sweep=s):
            sw = comp.process(stream.t_start(s), pts, valid)
            odom = [torch.as_tensor(v, device=dev) for v in odom_np]
            full = deskew.deskew_to_end(sw.pts, sw.rel_time, *odom, period)
            sm = mapper.process_full(
                stream.t_start(s) + period, full, sw.ring, sw.rel_time,
                sw.mask, None, odom[2], odom[3], n_rings=n_rings,
                n_azimuth=GRID_AZ, scan_period=period)
        if keep:
            kept.offer((s, full, sw.mask))
        if sm is not None:
            with rec.span("global_map.add_submap", sweep=s):
                gm.add_submap(sm)

    # set-up: the stream from its start until a loop has closed, so that
    # every path of the window (k-NN builds, loop registration, the pose
    # graph's solve) has run once
    warm = traffic["warm"]
    s = 0
    while s < warm["max_sweeps"] and not (
            s >= warm["min_sweeps"] and gm.loops_closed >= 1):
        step(s)
        s += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    warm_sweeps, warm_loops = s, gm.loops_closed
    rec.spans.clear()

    # in a traced run, each k-NN call of the profiled part is counted
    # with its live references (the roofline's work depends on them)
    knn, calls = loam_icp.knn, []

    def counted_knn(query, ref, ref_mask, k):
        if rec.profiling:
            calls.append((query.shape[0], ref.shape[0], k, ref_mask.sum()))
        return knn(query, ref, ref_mask, k)

    if rec.trace:
        loam_icp.knn = counted_knn
    rec.start_profile()
    t_w0 = time.perf_counter()
    setup_s = t_w0 - ctx.t_process
    ended = False
    while True:
        if s >= stream.n_stream:
            ended = True
            break
        step(s, keep=True)
        s += 1
        now = time.perf_counter()
        if rec.profiling and \
                now - rec.profile_start >= traffic["profile_s"]:
            rec.stop_profile()
        if now - t_w0 >= ctx.seconds:
            break
    sm = mapper.flush()
    if sm is not None:
        with rec.span("global_map.add_submap", sweep=s - 1):
            gm.add_submap(sm)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_w1 = time.perf_counter()
    rec.stop_profile()
    loam_icp.knn = knn
    rec.counters["knn_calls"] = [(nq, nr, k, int(live))
                                 for nq, nr, k, live in calls]
    window = (warm_sweeps, s)
    memory_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0

    midend = [(np.asarray(p, np.float64), np.asarray(q, np.float64))
              for _, p, q in mapper.trajectory]
    nodes = [(int(round((t - stream.t0) / period)) - 1,
              np.asarray(p, np.float64), np.asarray(q, np.float64))
             for t, p, q in gm.trajectory()]
    counts = dict(warm_sweeps=warm_sweeps, warm_loops=warm_loops,
                  sweeps=s - warm_sweeps, submaps=mapper.submaps_emitted,
                  nodes=gm.n_nodes, loops_closed=gm.loops_closed,
                  loop_pairs=len(gm.loop_pairs),
                  map_refreshes=gm.map_refreshes, stream_end=ended,
                  stream_sweeps=stream.n_stream)
    for name in ("local_map.sweep", "global_map.add_submap"):
        d = [sp.t1 - sp.t0 for sp in rec.spans if sp.name == name]
        counts[f"{name}_spans"] = (len(d), round(sum(d), 4),
                                   round(max(d), 4) if d else None)
    rec.counters.update(counts)
    failed = sum(1 for k in range(*window) if k < len(midend) and not (
        np.isfinite(midend[k][0]).all() and np.isfinite(midend[k][1]).all()))
    deskewed = [(k, full.cpu(), mask.cpu())
                 for k, full, mask in sorted(kept.items,
                                             key=lambda it: it[0])]
    del comp, mapper, gm, kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_j = time.perf_counter()
    answers = dict(midend=midend, nodes=nodes, deskewed=deskewed,
                   nonfinite=failed)
    compared = judge(stream, answers, window, ctx.seed, dev,
                     traffic["judge"], ctx.limits, info=counts,
                     faults=ctx.read_faults)
    counts["judge_s"] = time.perf_counter() - t_j
    counts["window_s"] = t_w1 - t_w0
    counts["setup_s"] = setup_s
    return dict(attempted=s - warm_sweeps, failed=failed,
                sensor_s=(s - warm_sweeps) * period,
                window_s=t_w1 - t_w0, setup_s=setup_s,
                memory_peak=memory_peak, compared=compared,
                info=counts)


def _start_from(end, prev_mid, cur_mid):
    """The pose at a sweep's start, from its end pose and the relative
    motion of the local mapper's poses across the sweep."""
    Rp = gen.quat_to_mat(prev_mid[1])
    Rc = gen.quat_to_mat(cur_mid[1])
    R_rel = Rc.T @ Rp
    t_rel = Rc.T @ (prev_mid[0] - cur_mid[0])
    Re = gen.quat_to_mat(end[1])
    return end[0] + Re @ t_rel, gen.mat_to_quat(Re @ R_rel)


def loop_candidates(stream, keyed, min_apart, max_dist, max_angle_deg,
                    first=0):
    """Pairs (i, j) of keyed sweeps, j at least `min_apart` sweeps after
    i and no earlier than sweep `first`, whose true poses lie within
    `max_dist` m and `max_angle_deg`."""
    out = []
    cos_max = np.cos(np.radians(max_angle_deg) / 2)
    for a in range(len(keyed)):
        for b in range(a + 1, len(keyed)):
            i, j = keyed[a], keyed[b]
            if j - i < min_apart or j < first:
                continue
            (pi, qi), (pj, qj) = stream.truth(i), stream.truth(j)
            if (np.linalg.norm(pi - pj) < max_dist
                    and abs(float(qi @ qj)) > cos_max):
                out.append((i, j))
    return out


def _draw(rng, cands, n):
    return sorted(rng.choice(len(cands), min(n, len(cands)),
                             replace=False).tolist()) if cands else []


def judge(stream, answers, window, seed, dev, spec, limits, info=None,
          faults=False):
    """The reference's judgement of one run's answers (``answers``: the
    local mapper's pose of each sweep, ``midend``; the global mapper's
    keyed poses at the close, ``nodes``; a sample of the window's
    deskewed sweeps, ``deskewed``; the window's sweeps whose pose is not
    finite, ``nonfinite``):

    - for each baseline L of the traffic's `baselines`, a sample of the
      window's sweeps s, each judged by sweep s - L against sweep s with
      the local mapper's poses;
    - a sample of pairs of keyed sweeps a lap or more apart at one place,
      the later in the window, judged with the global mapper's poses;
    - the deskewed sweeps against the reference's compensator and deskew.

    With `faults`, the same pairs are judged again as three faults would
    answer them (into `info`): the local mapper's state left unchanged
    (every pose the one before the pair), the odometry passed through,
    and the loops left open (the local mapper's poses at the loop pairs).
    Returns (name, value, limit) of each number that the cell's limits
    name; the rest go to `info`."""
    midend, nodes = answers["midend"], answers["nodes"]
    j = Judge(stream.sweep, stream.period, stream.lidar.n_rings, dev)
    rng = np.random.default_rng([seed, 2])
    lo, hi = window
    numbers = {"missing_answers": max(0, hi - len(midend)),
               "nonfinite_poses": answers["nonfinite"]}
    odo = [stream.odometry(k)[2:] for k in range(hi)] if faults else None

    def pairs_gap(what, pick, L, poses_of):
        gaps, errs = [], []
        for s in pick:
            a, poses = s - L, poses_of(s)
            gaps.append(j.gap(a, poses[a - 1], poses[a],
                              s, poses[s - 1], poses[s]))
            errs.append(j.error(a, poses[a - 1], poses[a], poses[s],
                                stream.truth(a), stream.truth(s)))
        record(numbers, info, what, pick, gaps, errs)

    baselines = spec["baselines"] + (spec["fault_baselines"] if faults
                                     else [])
    for L in sorted(set(baselines)):
        cands = list(range(max(lo, L + 1), min(hi, len(midend))))
        pick = [cands[i] for i in _draw(rng, cands, spec["pairs"])]
        pairs_gap(f"sweep_b{L}", pick, L, lambda s: midend)
        if faults:
            pairs_gap(f"fault_odometry_b{L}", pick, L, lambda s: odo)
            pairs_gap(f"fault_unchanged_b{L}", pick, L, lambda s: {
                k: midend[s - L - 1] for k in range(s - L - 1, s + 1)})

    keyed = {k: (p, q) for k, p, q in nodes if 1 <= k < len(midend)}
    pairs = loop_candidates(stream, sorted(keyed), stream.n_lap // 2,
                            spec["loop_max_dist_m"],
                            spec["loop_max_angle_deg"], first=lo)
    lp = [pairs[i] for i in _draw(rng, pairs, spec["loop_pairs"])]

    def loop_gaps(what, ends):
        gaps, errs = [], []
        for a, b in lp:
            ea, eb = ends[a], ends[b]
            sa = _start_from(ea, midend[a - 1], midend[a])
            sb = _start_from(eb, midend[b - 1], midend[b])
            gaps.append(j.gap(a, sa, ea, b, sb, eb))
            errs.append(j.error(a, sa, ea, eb, stream.truth(a),
                                stream.truth(b)))
        record(numbers, info, what, lp, gaps, errs)

    loop_gaps("loop", keyed)
    if faults:
        loop_gaps("fault_open_loops_loop", midend)

    hist, gaps = {}, []
    for k, full, mask in answers["deskewed"]:
        ref = _reference_deskew(stream, k, hist, dev)
        gaps.append(deskew_gap((full, mask, None), ref))
    numbers["deskew_gap_max_m"] = max(gaps) if gaps else float("inf")
    if info is not None:
        info["deskew_judged"] = [k for k, _, _ in answers["deskewed"]]
        info["deskew_gap_m"] = gaps
    return [(n, numbers[n], lim) for n, lim in limits.items()]


def _reference_deskew(stream, k, hist, dev, dtype=None):
    """The reference's compensator and deskew of sweep k with the
    odometry the program was given.  Where the compensator infers the
    start azimuth, it is worked out from the first-point azimuths of the
    sweeps up to k (cached in `hist`); otherwise it is 0."""
    import torch
    comp = stream.compensator
    firsts = []
    if comp["infer_start"]:
        for i in range(max(0, k - HISTORY + 1), k + 1):
            if i not in hist:
                pts, _, valid = stream.sweep(i)
                hist[i] = first_azimuth(pts, valid)
            if hist[i] is not None:
                firsts.append(hist[i])
    pts, _, valid = stream.sweep(k)
    start = start_azimuth(firsts) if firsts else 0.0
    return deskewed(pts, valid, start, stream.odometry(k), comp,
                    dtype=torch.float64 if dtype is None else dtype,
                    device=dev)


def control(ctx, n_sweeps, info=None):
    """The reference in the program's place, in bfloat16: the
    compensator and deskew of a sample of `n_sweeps` sweeps after the
    traffic's warm-up minimum (as many as a run judges), judged by the
    float64 reference as a run's deskewed sweeps are.  Returns the cell's
    numbers that it answers, each with its limit."""
    import torch
    stream = MappingStream(ctx.conf, ctx.traffic, ctx.seed)
    spec, lo = ctx.traffic["judge"], ctx.traffic["warm"]["min_sweeps"]
    rng = np.random.default_rng([ctx.seed, 3])
    pick = sorted(rng.choice(np.arange(lo, lo + n_sweeps),
                             spec["deskew_sweeps"], replace=False).tolist())
    hist, gaps = {}, []
    for k in pick:
        low = _reference_deskew(stream, k, hist, ctx.device,
                                torch.bfloat16)
        ref = _reference_deskew(stream, k, hist, ctx.device)
        gaps.append(deskew_gap(low, ref))
    if info is not None:
        info["deskew_judged"], info["deskew_gap_m"] = pick, gaps
    name = "deskew_gap_max_m"
    return [(name, max(gaps), ctx.limits[name])]
