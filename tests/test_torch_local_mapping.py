"""The ported LOAM local-mapping slice against the JAX reference:
compensator → deskew → LocalMapper.process_full, 5 sweeps of 16 × 480
points with drifting odometry, in both packages, at the reference's map
capacities.

Tolerances: per sweep, position within 5e-3 m and rotation within
2e-3 rad; edge and plane counts within 3 %; submaps at the same sweeps.
The reference's own pose moves by 1–2 mm when its map changes in the last
bit (see tests/test_torch_loam.py), and the plane gates flip on a few
percent of rows, so the two chains are not bit-identical.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu.config import SystemConfig
from mvil_fusion_tpu.frontend.lidar_compensator import \
    LidarCompensator as JaxCompensator
from mvil_fusion_tpu.io.synthetic import SyntheticTrajectory
from mvil_fusion_tpu.io.synthetic_lidar import BoxWorld, simulate_sweep
from mvil_fusion_tpu.mapping import local_mapping as jlm
from mvil_fusion_tpu.ops import deskew as jdsk
from mvil_fusion_tpu.ops import loam_features as jlf
from mvil_fusion_torch import config as tconfig
from mvil_fusion_torch.frontend.lidar_compensator import LidarCompensator
from mvil_fusion_torch.mapping import local_mapping as tlm
from mvil_fusion_torch.ops import deskew as tdsk
from mvil_fusion_torch.utils import lie as tlie
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401


TRAJ = SyntheticTrajectory(duration=8.0, w_amp=(0.2, 0.15, 0.4),
                           w_freq=(0.2, 0.15, 0.25),
                           p_amp=(1.5, 1.2, 0.3), p_freq=(0.2, 0.25, 0.15),
                           lin_vel=(0.5, 0.25, 0.0))
N_AZ = 480
N_SWEEPS = 5
# a submap every 3 frames, so that 5 sweeps cover an emission, the map
# reset and re-registration against a fresh map
CFG = dataclasses.replace(SystemConfig(), local_mapping=dataclasses.replace(
    SystemConfig().local_mapping, submap_trigger_frames=3))
TCFG = tconfig.SystemConfig(local_mapping=tconfig.LocalMappingConfig(
    submap_trigger_frames=3))
GRID = dict(n_rings=16, n_azimuth=N_AZ, scan_period=0.1)


def _make_inputs():
    """Raw sweeps with truth + drifting odometry (drift N(0, 0.01) per
    sweep per axis, seed 0; true rotation)."""
    rng = np.random.default_rng(0)
    drift = np.zeros(3)
    out = []
    for i in range(N_SWEEPS):
        t0 = 0.8 + 0.1 * i
        s = simulate_sweep(BoxWorld(), TRAJ, t0, n_azimuth=N_AZ)
        drift += rng.normal(scale=0.01, size=3)
        p0, q0 = TRAJ.pose_at(t0)
        p1, q1 = TRAJ.pose_at(t0 + 0.1)
        f32 = np.float32
        out.append(dict(t0=t0, s=s, truth=(p1, q1),
                        odom=((p0 + drift).astype(f32), q0.astype(f32),
                              (p1 + drift).astype(f32), q1.astype(f32))))
    return out


def _record_packs(mapper):
    """Log every sweep pack that reaches the mapper's host bookkeeping."""
    log = []
    orig = mapper._after_step

    def after_step(t, hp, p_dev, q_dev):
        log.append(np.array(hp, copy=True))
        return orig(t, hp, p_dev, q_dev)

    mapper._after_step = after_step
    return log


def _jax_state(m):
    arrays = {name: np.asarray(getattr(m, name)) for name in tlm.DEVICE_STATE}
    host = {name: getattr(m, name) for name in tlm.HOST_STATE}
    return arrays, host


def _run_jax(inputs):
    comp, mapper = JaxCompensator(CFG), jlm.LocalMapper(CFG)
    packs = _record_packs(mapper)
    states, subs = [], []
    for x in inputs:
        states.append(_jax_state(mapper))
        sw = comp.process(x["t0"], x["s"]["pts"], x["s"]["mask"])
        pts = jdsk.deskew_to_end(sw.pts, sw.rel_time,
                                 *[jnp.asarray(v) for v in x["odom"]], 0.1)
        sm = mapper.process_full(x["t0"] + 0.1, pts, sw.ring, sw.rel_time,
                                 sw.mask, None, x["odom"][2], x["odom"][3],
                                 **GRID)
        subs.append(sm)
    return dict(mapper=mapper, packs=packs, states=states, subs=subs)


def _torch_sweep(comp, mapper, x):
    sw = comp.process(x["t0"], x["s"]["pts"], x["s"]["mask"])
    pts = tdsk.deskew_to_end(sw.pts, sw.rel_time,
                             *[torch.as_tensor(v) for v in x["odom"]], 0.1)
    return mapper.process_full(x["t0"] + 0.1, pts, sw.ring, sw.rel_time,
                               sw.mask, None, x["odom"][2], x["odom"][3],
                               **GRID)


def _run_torch(inputs, defer=False):
    comp = LidarCompensator(TCFG, device="cpu")
    mapper = tlm.LocalMapper(TCFG, device="cpu")
    mapper.defer_pack = defer
    packs = _record_packs(mapper)
    subs = [_torch_sweep(comp, mapper, x) for x in inputs]
    if defer:
        subs = subs[1:] + [mapper.flush()]
    return dict(mapper=mapper, packs=packs, subs=subs)


@pytest.fixture(scope="module")
def runs():
    inputs = _make_inputs()
    return dict(inputs=inputs, jax=_run_jax(inputs),
                torch=_run_torch(inputs))


def _assert_pack_close(pt, pj):
    assert np.linalg.norm(pt[0:3] - pj[0:3]) < 5e-3
    dq = tlie.quat_boxminus(torch.as_tensor(pt[3:7]),
                            torch.as_tensor(pj[3:7])).numpy()
    assert np.linalg.norm(dq) < 2e-3
    for c in (7, 8):                    # edge, plane counts
        assert abs(pt[c] - pj[c]) <= 0.03 * max(pj[c], 1.0), (c, pt[c], pj[c])
    np.testing.assert_array_equal(pt[10:17], pj[10:17])   # odometry in


def test_slice_matches_jax(runs):
    rj, rt = runs["jax"], runs["torch"]
    assert len(rt["packs"]) == len(rj["packs"]) == N_SWEEPS
    for pt, pj in zip(rt["packs"], rj["packs"]):
        _assert_pack_close(pt, pj)
    emitted_j = [sm is not None for sm in rj["subs"]]
    emitted_t = [sm is not None for sm in rt["subs"]]
    assert emitted_t == emitted_j and any(emitted_j)
    assert rt["mapper"].submaps_emitted == rj["mapper"].submaps_emitted
    for smt, smj in zip(rt["subs"], rj["subs"]):
        if smj is None:
            continue
        assert abs(len(smt.pts) - len(smj.pts)) <= 0.03 * len(smj.pts)
        np.testing.assert_allclose(smt.p_w, smj.p_w, rtol=0, atol=5e-3)
        np.testing.assert_array_equal(smt.odom_p, smj.odom_p)
    # and the port's mapped poses are as close to the truth
    def err(packs):
        return np.mean([np.linalg.norm(p[0:3] - x["truth"][0])
                        for p, x in zip(packs, runs["inputs"])])

    assert err(rt["packs"]) <= err(rj["packs"]) + 5e-3


@pytest.mark.parametrize("sweep", [1, 4])
def test_load_reference_state(runs, sweep):
    """From the JAX mapper's state before `sweep`, one sweep of each
    package lands on the same pose."""
    arrays, host = runs["jax"]["states"][sweep]
    comp = LidarCompensator(TCFG, device="cpu")
    mapper = tlm.LocalMapper(TCFG, device="cpu")
    mapper.load_reference_state(arrays, host)
    for name in tlm.DEVICE_STATE:
        np.testing.assert_array_equal(getattr(mapper, name).numpy(),
                                      arrays[name])
    assert mapper.initialized == host["initialized"]
    assert mapper.frames_since_submap == host["frames_since_submap"]
    packs = _record_packs(mapper)
    sm = _torch_sweep(comp, mapper, runs["inputs"][sweep])
    _assert_pack_close(packs[0], runs["jax"]["packs"][sweep])
    assert (sm is None) == (runs["jax"]["subs"][sweep] is None)
    assert mapper.submaps_emitted == \
        runs["jax"]["mapper"].submaps_emitted - sum(
            s is not None for s in runs["jax"]["subs"][sweep + 1:])


def test_load_reference_state_rejects_wrong_shape(runs):
    arrays, host = runs["jax"]["states"][0]
    bad = dict(arrays, surf_map=arrays["surf_map"][:100])
    with pytest.raises(ValueError, match="surf_map"):
        tlm.LocalMapper(TCFG, device="cpu").load_reference_state(bad, host)


def test_deferred_mode_equals_sync_mode(runs):
    """Deferred readback gives the same trajectory rows and submaps, one
    call later, with flush() draining the last sweep."""
    rs, rd = runs["torch"], _run_torch(runs["inputs"], defer=True)
    assert len(rd["packs"]) == len(rs["packs"])
    for a, b in zip(rd["packs"], rs["packs"]):
        np.testing.assert_array_equal(a, b)
    assert [s is None for s in rd["subs"]] == [s is None for s in rs["subs"]]
    for a, b in zip(rd["subs"], rs["subs"]):
        if b is not None:
            np.testing.assert_array_equal(a.pts, b.pts)
    assert rd["mapper"].submaps_emitted == rs["mapper"].submaps_emitted
    assert [r[0] for r in rd["mapper"].trajectory] == \
        [r[0] for r in rs["mapper"].trajectory]


def test_process_feature_frames_matches_jax(runs):
    """The feature-frame entry (LocalMapper.process), fed the JAX
    package's features of the first three sweeps."""
    mj, mt = jlm.LocalMapper(CFG), tlm.LocalMapper(TCFG, device="cpu")
    pj_log, pt_log = _record_packs(mj), _record_packs(mt)
    for x in runs["inputs"][:3]:
        s = x["s"]
        pts = jdsk.deskew_to_end(jnp.asarray(s["pts"]),
                                 jnp.asarray(s["rel_time"]),
                                 *[jnp.asarray(v) for v in x["odom"]], 0.1)
        grid, occ, ig = jlf.organize_grid(
            pts, jnp.asarray(s["ring"]), jnp.asarray(s["rel_time"]),
            jnp.asarray(s["mask"]), 16, N_AZ, 0.1)
        f = [np.asarray(v) for v in jlf.extract(grid, occ, ig)]
        args = (f[0], f[1], f[6], f[7], x["odom"][2], x["odom"][3])
        smj = mj.process(x["t0"], *args)
        smt = mt.process(x["t0"], *args)
        assert (smj is None) == (smt is None)
    for pt, pj in zip(pt_log, pj_log):
        _assert_pack_close(pt, pj)
    assert mt.submaps_emitted == mj.submaps_emitted == 1


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mvil_fusion_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import mvil_fusion_torch.mapping.local_mapping\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'mvil_fusion_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('mvil_fusion_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 18
