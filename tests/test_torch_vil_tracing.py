"""The estimator's spans and counters (``utils/timing.py::TRACER``) on a
short CPU stream through ``VilSystem(enable_mapping=False)``.

chip_smoke's VIL stream (the phase-12 world: IMU and features at 10 Hz,
16 × 180 sweeps of the box world from 0.9 s) to 2.0 s: the estimator
initializes at its 7th frame and solves the rest, its LiDAR front end
classifies the sweeps the window covers, and every second drained sweep
goes to the depth register, whose lookups then serve each frame.  Every
``vio.*``, ``lidar_odom.*`` and ``depth.*`` span is recorded (with the
compensator's and the deskew's, which the VIL path shares with local
mapping: the deskew inside ``lidar_odom.sweep``), each child
inside its parent and with its parent's request; the roots carry the
frame's, the sweep's end or the image's time.  The counters equal what
the estimator did: a solve and ``max_solver_iters`` LM iterations per
``vio.frame``, no reboot, and the depth register's lookups the valid
features handed to ``get_depth`` (counted here by a spy).
"""

import numpy as np

import chip_smoke
from mvil_fusion_torch.frontend.depth_register import DepthRegister
from mvil_fusion_torch.pipeline.system import VilSystem
from mvil_fusion_torch.utils.timing import TRACER
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

VIL_SPANS = {
    "vio.init", "vio.parallax", "vio.frame", "vio.tables", "vio.upload",
    "vio.step", "vio.assemble",
    "vio.lm_step", "vio.marginalize", "vio.readback", "vio.slide",
    "lidar_odom.sweep", "lidar_odom.harvest", "depth.lookup",
    "depth.add_cloud", "local_map.compensate", "local_map.deskew"}
PARENTS = {
    "vio.tables": "vio.frame", "vio.upload": "vio.tables",
    "vio.step": "vio.frame",
    "vio.readback": "vio.frame", "vio.slide": "vio.frame",
    "vio.assemble": "vio.step", "vio.lm_step": "vio.step",
    "vio.marginalize": "vio.step", "lidar_odom.harvest": "lidar_odom.sweep",
    "local_map.deskew": "lidar_odom.sweep"}


def test_vil_stream_records_every_span_and_counter(monkeypatch):
    cfg = chip_smoke.vil_config()
    frames, sweeps = chip_smoke.vil_sequence(
        chip_smoke.sequence_world(), cfg, t_end=2.0,
        lidar_times=np.arange(0.9, 1.85, 0.1), n_azimuth=180)
    sys_ = VilSystem(cfg, enable_mapping=False, device="cpu")
    looked_up = [0]
    get_depth = DepthRegister.get_depth

    def spy(self, t, norm, valid, *a):
        looked_up[0] += int(np.count_nonzero(valid))
        return get_depth(self, t, norm, valid, *a)
    monkeypatch.setattr(DepthRegister, "get_depth", spy)
    TRACER.enable()
    try:
        chip_smoke.run_stream(sys_, frames, sweeps, lambda s: (
            sys_.process_lidar(s["t_start"], s["pts"], s["mask"])))
        sys_.flush()
    finally:
        TRACER.disable()
        recs = TRACER.drain()
    est = sys_.estimator
    assert est.status == est.NON_LINEAR and est.failures == 0
    assert {r.name for r in recs} == VIL_SPANS

    for r in recs:
        want = PARENTS.get(r.name)
        if want is None:
            assert r.parent is None, r.name
            assert r.rid is not None
            continue
        p = recs[r.parent]
        assert p.name == want and r.rid == p.rid
        assert p.t0_ns <= r.t0_ns <= r.t1_ns <= p.t1_ns
    solves = [r for r in recs if r.name == "vio.frame"]
    times = {round(t, 6) for t, *_ in est.trajectory}
    assert {round(r.rid, 6) for r in solves} == times
    period = cfg.lidar.scan_period
    ends = {round(s["t_start"] + period, 6) for s in sweeps}
    assert {round(r.rid, 6) for r in recs
            if r.name == "lidar_odom.sweep"} <= ends
    assert est.solves == len(solves) == len(est.trajectory)
    assert est.lm_iters == est.solves * cfg.estimator.max_solver_iters
    assert est.reboots == est.failures == 0
    n_steps = sum(1 for r in recs if r.name == "vio.step")
    assert n_steps == len(solves)
    assert sum(1 for r in recs if r.name == "vio.lm_step") == \
        est.lm_iters
    dr = sys_.depth_register
    lookups = [r for r in recs if r.name == "depth.lookup"]
    assert lookups and dr.lookups == looked_up[0] > 0
    # the synthetic world's camera looks along +z, the rings lie about
    # x-y: no feature gets a depth (ROADMAP's hazards)
    assert dr.features_with_depth == 0
