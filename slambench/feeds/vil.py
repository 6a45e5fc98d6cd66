"""The VIL odometry stream: what the ``vils_estimator`` node receives.

Every message of ``vil_stream.VilStream`` (200 Hz IMU, 10 Hz feature
tracks, 10 Hz sweeps) goes in arrival order through
``VilSystem(cfg, use_tracker=False, enable_mapping=False)``'s
``process_imu``, ``process_features`` and ``process_lidar``, each when
the previous call has returned.  A program that reads the
configuration's LiDAR-IMU extrinsic as the LiDAR in the body (before
``lidar_frontend.lidar_in_body``) would see the stream's C16 on its
side: the feed stops at once there, before any work.  Set-up casts a lap
of sweeps, builds the system and sends the stream from its start until
the estimator has initialized and published `warm.min_solves` poses; the
window sends the rest until ``--seconds`` have passed, ending after a
frame, then flushes.

The answers judged (``reference/``), once the program is freed; the
cell's limits name the numbers compared, the others go to the report:

- the window solves of 12 frames drawn from the seed (each solve's
  tables, its starting state and prior, and its solved state, held as
  the program left them; the host tables copied, as the program reuses
  their buffers): for each, the widest distance that the float64
  reference's Levenberg-Marquardt on the same problem, started from the
  program's solved state with frame 0's position and yaw held there
  (the four directions that the program's re-anchoring sets, and to
  which the prior is not invariant), moves any window position;
  ``window_move_median_m`` is their median and ``window_move_max_m``
  their widest.  The median is compared: 8 iterations a frame leave a
  few windows short of the optimum along weakly observed directions
  (tens of mm), as one iteration leaves many;
- the published pose of every window frame: the error of consecutive
  poses' relative translation (in the earlier pose's body frame) against
  the truth, its median ``frame_gap_median_m`` (a solve skipped or a
  lost scale leaves the whole motion of a frame) and its widest
  ``frame_gap_max_m`` (a jump); ``missing_answers`` and
  ``nonfinite_poses``;
- ``lidar_gap_max_m``: ``scan_judge.py`` on 12 consecutive sweep pairs
  of the window, each sweep deskewed with the LiDAR poses that the
  published poses give at its start and end (interpolated between the
  bracketing frames, through the configuration's mounting);
- ``reboots``: the estimator's reboots in the window.

With `faults`, the windows are judged again as four faulty programs
would answer (into the report): the solve skipped (the starting state),
the LM cut to one iteration, the LiDAR rows dropped (each the reference's
own answer from the starting state), and the reference itself in
bfloat16 in the program's place (its LM at the program's iteration
count; the normal equations factored in float32, as no bfloat16
factorization exists); and the frame gaps as a skipped solve would leave
the published poses.

In a traced run the program's tracer is on over the window: its records
and counters go to the readers under ``metrics/`` through
``rec.counters``, found by ``getattr`` so that a program without them
runs the cell too.
"""

from __future__ import annotations

import importlib
import time

import numpy as np

from slambench import generator as gen
from slambench.feeds.mapping import Sample
from slambench.harness import record
from slambench.reference import vio_window as ref
from slambench.reference.scan_judge import Judge
from slambench.vil_stream import VilStream

TABLES = ("obs", "vel", "td_ref", "ov_val", "accs", "gyrs", "dts", "icp_ai",
          "icp_aj", "icp_tp", "icp_w", "lps_alpha", "lps_qm", "start",
          "icp_ids", "lps_ids", "mask", "depth_fixed", "valid", "need_depth",
          "ov_mask", "imu_masks", "icp_act", "lps_act", "zero_vel")
STATE = ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth")
# the reference's LM stops once an accepted step moves no position by this
TOL_M = 1e-6


def _host(state):
    """A window state (NamedTuple of tensors) as a dict of numpy."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in STATE}


def run(ctx):
    """Set-up, the window and the judging of one run; returns the run's
    record (see ``run.py``)."""
    import torch
    from mvil_fusion_torch.pipeline.system import VilSystem

    cfg, traffic, rec, dev = ctx.cfg, ctx.traffic, ctx.rec, ctx.device
    lidar_frontend = importlib.import_module(
        "mvil_fusion_torch.estimator.lidar_frontend")
    if not hasattr(lidar_frontend, "lidar_in_body"):
        raise SystemExit("slambench: this program reads the configuration's "
                         "LiDAR-IMU extrinsic as the LiDAR in the body; the "
                         "cell's stream mounts the C16 as the yaml names it")
    system = VilSystem(cfg, use_tracker=False, enable_mapping=False,
                       device=dev)
    est = system.estimator
    stream = VilStream(ctx.conf, traffic, ctx.seed)
    stream.cast_lap()

    # each window solve is offered to a sample drawn from the seed
    kept = Sample(traffic["judge"]["windows"],
                  np.random.default_rng([ctx.seed, 20]))
    capturing = [False]
    frame_step = est._frame_step

    def captured(d):
        out = frame_step(d)
        if capturing[0]:
            kept.offer(dict(
                t=est.times[-1], iters=est._iters_current,
                tables={n: np.array(est._tables[n]) for n in TABLES},
                start=est.state, prior=est.prior, answer=out[0]))
        return out
    est._frame_step = captured

    msgs = stream.messages()
    sent = dict(t=0.0, frames=[])

    def send(msg):
        t, kind, payload = msg
        if kind == "imu":
            system.process_imu(*payload)
        elif kind == "frame":
            stamp, ids, norm, vel, _ = stream.frame(payload)
            system.process_features(stamp, ids, norm, vel)
            sent["frames"].append(payload)
        else:
            pts, _, valid = stream.sweep(payload)
            system.process_lidar(stream.sweep_start(payload), pts, valid)
        sent["t"] = t
        return kind

    # set-up: from the stream's start until the estimator tracks
    warm = traffic["warm"]
    for msg in msgs:
        if send(msg) == "frame" and (
                len(sent["frames"]) >= warm["max_frames"]
                or (est.status == est.NON_LINEAR
                    and len(est.trajectory) >= warm["min_solves"])):
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    warm_frames, t_warm = len(sent["frames"]), sent["t"]
    n_traj0, failures0 = len(est.trajectory), est.failures
    counted = _counted(est, system.depth_register)
    counters0 = {n: getattr(o, a, None) for n, (o, a) in counted.items()}

    timing = importlib.import_module("mvil_fusion_torch.utils.timing")
    tracer = getattr(timing, "TRACER", None) if rec.trace else None
    rec.start_profile()
    profiled = [time.perf_counter_ns(), None]
    if tracer is not None:
        tracer.drain()
        tracer.enable()
    capturing[0] = True
    t_w0 = time.perf_counter()
    setup_s = t_w0 - ctx.t_process
    ended = True
    for msg in msgs:
        kind = send(msg)
        if kind != "frame":
            continue
        now = time.perf_counter()
        if rec.profiling and \
                now - rec.profile_start >= traffic["profile_s"]:
            rec.stop_profile()
            profiled[1] = time.perf_counter_ns()
        if now - t_w0 >= ctx.seconds:
            ended = False
            break
    system.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_w1 = time.perf_counter()
    capturing[0] = False
    if rec.profiling:
        profiled[1] = time.perf_counter_ns()
    rec.stop_profile()
    if tracer is not None:
        tracer.disable()
        rec.counters["program_records"] = tracer.drain()
        rec.counters["profiled_ns"] = tuple(profiled)
    counters = {n: (None if counters0[n] is None
                    else getattr(o, a) - counters0[n])
                for n, (o, a) in counted.items()}
    rec.counters.update(counters)
    window_frames = sent["frames"][warm_frames:]
    memory_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0

    published = {int(round(t * 1e6)): (np.asarray(p, np.float64),
                                       np.asarray(q, np.float64))
                 for t, p, q, *_ in est.trajectory[n_traj0:]}
    poses = {k: published.get(int(round(stream.frame_time(k) * 1e6)))
             for k in window_frames}
    solves = [dict(s, start=_host(s["start"]), answer=_host(s["answer"]),
                   prior=dict(J=s["prior"].J.cpu().numpy(),
                              r0=s["prior"].r0.cpu().numpy(),
                              x0=_host(s["prior"].x0),
                              valid=bool(s["prior"].valid)))
              for s in sorted(kept.items, key=lambda s: s["t"])]
    reboots = est.failures - failures0
    info = dict(warm_frames=warm_frames, frames=len(window_frames),
                solves_judged=[round(s["t"], 3) for s in solves],
                stream_end=ended, lidar_modes=list(
                    est.lidar.mode_counts) if est.lidar else None,
                **{k: v for k, v in counters.items() if v is not None})
    if counters.get("depth_lookups"):
        info["depth_share"] = counters["features_with_depth"] / \
            counters["depth_lookups"]
    del system, est, kept, captured, counted
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_j = time.perf_counter()
    compared = judge(stream, ctx.conf, window_frames, poses, solves,
                     reboots, ctx.seed, dev, traffic["judge"], ctx.limits,
                     info=info, faults=ctx.read_faults)
    info["judge_s"] = time.perf_counter() - t_j
    info["window_s"] = t_w1 - t_w0
    info["setup_s"] = setup_s
    missing = sum(1 for k in window_frames if poses[k] is None)
    nonfinite = sum(1 for k in window_frames if poses[k] is not None
                    and not all(np.isfinite(x).all() for x in poses[k]))
    return dict(attempted=len(window_frames), failed=missing + nonfinite,
                sensor_s=sent["t"] - t_warm, window_s=t_w1 - t_w0,
                setup_s=setup_s, memory_peak=memory_peak,
                compared=compared, info=info)


def _counted(est, depth_register):
    """{name: (object, attribute)} of the program's counters that a run
    reads as their change over the window."""
    return dict(vio_solves=(est, "solves"), vio_lm_iters=(est, "lm_iters"),
                depth_lookups=(depth_register, "lookups"),
                features_with_depth=(depth_register, "features_with_depth"))


def _spec(conf):
    e, imu = conf["system"]["estimator"], conf["system"]["imu"]
    return dict(g_norm=imu["g_norm"], acc_n=imu["acc_n"], gyr_n=imu["gyr_n"],
                acc_w=imu["acc_w"], gyr_w=imu["gyr_w"],
                focal_length=e["focal_length"],
                estimate_extrinsic=e["estimate_extrinsic"],
                estimate_td=e["estimate_td"])


def _start(solve):
    """The state the program's solve started from: its window state with
    the host-known inverse depths written over it, as ``_frame_step``
    does."""
    tab, s = solve["tables"], dict(solve["start"])
    s["inv_depth"] = np.where(tab["ov_mask"], tab["ov_val"], s["inv_depth"])
    return s


def window_moves(solves, conf, dev, faults=False, info=None):
    """The reference's judgement of each solve: the widest move of the
    program's answer; with `faults`, of the four faulty answers too.
    Returns {name: [move of each solve]}."""
    import torch
    spec = _spec(conf)
    f64 = torch.float64
    out: dict = {"window_move": []}
    iters_ref = []
    for sv in solves:
        problem = ref.WindowProblem(sv["tables"], _start(sv), sv["prior"],
                                    spec, dev)
        answer = ref.state_from(sv["answer"], f64, dev)
        move, _, it = ref.window_move(problem, answer, hold_gauge=True,
                                      tol=TOL_M)
        out["window_move"].append(move)
        iters_ref.append(it)
        if not faults:
            continue
        start = ref.state_from(_start(sv), f64, dev)
        # the landmarks of a faulty answer start where the program's were
        # solved: the move judged is the poses'
        unchanged = dict(start, inv_depth=answer["inv_depth"])
        one, _ = problem.solve(unchanged, unchanged, iters=1)
        no_lidar = ref.WindowProblem(sv["tables"], _start(sv), sv["prior"],
                                     spec, dev, lidar=False)
        dropped, _ = no_lidar.solve(unchanged, unchanged)
        low = ref.WindowProblem(sv["tables"], _start(sv), sv["prior"], spec,
                                dev, dtype=torch.bfloat16)
        bf = ref.state_from(_start(sv), torch.bfloat16, dev)
        bf = dict(bf, inv_depth=answer["inv_depth"].to(torch.bfloat16))
        control, _ = low.solve(bf, bf, iters=sv["iters"],
                               solve_dtype=torch.float32)
        control = {k: v.to(f64) for k, v in control.items()}
        for name, ans in (("fault_unchanged", unchanged),
                          ("fault_one_iteration", one),
                          ("fault_no_lidar", dropped),
                          ("control_bfloat16", control)):
            out.setdefault(name, []).append(ref.window_move(
                problem, ans, hold_gauge=True, tol=TOL_M)[0])
        out.setdefault("icp_rows", []).append(
            int(np.count_nonzero(sv["tables"]["icp_act"])))
    if info is not None:
        info["reference_lm_iters"] = iters_ref
    return out


def _median(vals):
    return float(np.median(vals)) if len(vals) else float("inf")


def frame_gaps(stream, frames, poses):
    """Each consecutive pair of window frames with both poses published:
    the error of their relative translation in the earlier body frame
    against the truth (m), and the truth's length."""
    gaps, lengths = [], []
    for a, b in zip(frames, frames[1:]):
        if poses[a] is None or poses[b] is None:
            continue
        (pa, qa), (pb, qb) = poses[a], poses[b]
        ta, tb = stream.frame_time(a), stream.frame_time(b)
        (Pa, Qa), (Pb, _) = stream.body_pose(ta), stream.body_pose(tb)
        est = gen.quat_to_mat(qa).T @ (pb - pa)
        true = gen.quat_to_mat(Qa).T @ (Pb - Pa)
        gaps.append(float(np.linalg.norm(est - true)))
        lengths.append(float(np.linalg.norm(true)))
    return gaps, lengths


def _interp(stream, poses, frames, t):
    """The published body pose at IMU-clock time t, interpolated between
    the bracketing window frames (lerp, slerp), or None."""
    times = [stream.frame_time(k) for k in frames]
    for (a, ta), (b, tb) in zip(zip(frames, times),
                                zip(frames[1:], times[1:])):
        if ta <= t <= tb and poses[a] is not None and poses[b] is not None:
            s = (t - ta) / (tb - ta)
            (pa, qa), (pb, qb) = poses[a], poses[b]
            qb = qb if float(qa @ qb) >= 0 else -qb
            th = np.arccos(min(1.0, abs(float(qa @ qb))))
            if th < 1e-9:
                q = qa
            else:
                q = (np.sin((1 - s) * th) * qa + np.sin(s * th) * qb) \
                    / np.sin(th)
            return pa + s * (pb - pa), q / np.linalg.norm(q)
    return None


def lidar_pairs(stream, frames, poses, n, rng):
    """`n` consecutive sweep pairs (s - 1, s) of the window, the first
    drawn from `rng`: [(a, a_start, a_end, b, b_start, b_end)] of LiDAR
    poses from the published ones."""
    if not frames:
        return []
    lo, hi = stream.frame_time(frames[0]), stream.frame_time(frames[-1])
    ends = {}
    s = 0
    while stream.sweep_start(s) + stream.period <= hi:
        t0 = stream.sweep_start(s)
        if t0 >= lo:
            a = _interp(stream, poses, frames, t0)
            b = _interp(stream, poses, frames, t0 + stream.period)
            if a is not None and b is not None:
                ends[s] = (stream.lidar_pose(*a), stream.lidar_pose(*b))
        s += 1
    cands = [s for s in sorted(ends) if s - 1 in ends]
    runs = [s for s in cands if all(s + i in ends for i in range(n))]
    if not runs:
        runs = cands[:1]
    if not runs:
        return []
    first = runs[int(rng.integers(len(runs)))]
    return [(s - 1, *ends[s - 1], s, *ends[s])
            for s in range(first, first + n) if s in ends and s - 1 in ends]


def judge(stream, conf, frames, poses, solves, reboots, seed, dev, spec,
          limits, info=None, faults=False):
    """The reference's judgement of one run's answers; returns (name,
    value, limit) of each number that the cell's limits name, the rest
    into `info`."""
    inf = float("inf")
    numbers = {"missing_answers": sum(1 for k in frames if poses[k] is None),
               "nonfinite_poses": sum(
                   1 for k in frames if poses[k] is not None and not all(
                       np.isfinite(x).all() for x in poses[k])),
               "reboots": reboots}
    gaps, lengths = frame_gaps(stream, frames, poses)
    numbers["frame_gap_max_m"] = max(gaps) if gaps else inf
    numbers["frame_gap_median_m"] = _median(gaps)
    if info is not None:
        info["frame_gap_m"] = [round(g, 6) for g in gaps]
    if faults:
        # a skipped solve publishes the pose before it again
        numbers["fault_unchanged_frame_gap_max_m"] = max(lengths) \
            if lengths else inf
        numbers["fault_unchanged_frame_gap_median_m"] = _median(lengths)

    moves = window_moves(solves, conf, dev, faults, info)
    for name, vals in moves.items():
        if name == "icp_rows":
            if info is not None:
                info["icp_rows"] = vals
            continue
        numbers[f"{name}_max_m"] = max(vals) if vals else inf
        numbers[f"{name}_median_m"] = _median(vals)
        if info is not None:
            info[f"{name}_m"] = [float(f"{v:.6g}") for v in vals]

    j = Judge(stream.sweep, stream.period, stream.lidar.n_rings, dev)
    pairs = lidar_pairs(stream, frames, poses, spec["sweep_pairs"],
                        np.random.default_rng([seed, 21]))
    found, errs = [], []
    for a, a0, a1, b, b0, b1 in pairs:
        found.append(j.gap(a, a0, a1, b, b0, b1))
        ta = stream.sweep_start(a) + stream.period
        tb = stream.sweep_start(b) + stream.period
        errs.append(j.error(a, a0, a1, b1,
                            stream.lidar_pose(*stream.body_pose(ta)),
                            stream.lidar_pose(*stream.body_pose(tb))))
    record(numbers, info, "lidar", [p[0] for p in pairs], found, errs)
    if info is not None:
        info.update((n, v) for n, v in numbers.items() if n not in limits)
    return [(n, numbers[n], lim) for n, lim in limits.items()]
