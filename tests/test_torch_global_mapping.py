"""The port's global-mapping stage against the JAX package's
(``mapping/global_mapping.py``), on the CPU: the 16-submap square loop of
tests/test_global_mapping.py through both mappers, the JAX mapper's state
carried over mid-run, eviction and the z-jump refresh of
tests/test_new_features.py, and the port's LocalMapper feeding its
GlobalMapper.

Tolerances.  Decisions are held exactly: nodes, edges, loop pairs, floors,
`closed_loop` flags, refreshes, evictions.  Poses: horizontal position
within 2 cm, height within 0.15 m, rotation within 1.5°.  The loop's
scans see floor and ceiling only far away, through voxels of two or
three points, so height, roll and pitch hang on plane normals that are
rounding noise in both packages (see tests/test_torch_vgicp.py).  The
JAX mapper alone moves by up to 1 cm horizontally and 8.5 cm in height
when its scans are scaled by one ulp
(`test_reference_moves_as_far_under_one_ulp` measures it); the port
stays 3 mm and 9 cm from it.  After `load_reference_state` one submap
lands within the same bounds.
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mvil_fusion_tpu import config as jconfig
from mvil_fusion_tpu.mapping import global_mapping as jgm
from mvil_fusion_tpu.mapping.local_mapping import Submap as JaxSubmap
from mvil_fusion_torch import config as tconfig
from mvil_fusion_torch.frontend.lidar_compensator import LidarCompensator
from mvil_fusion_torch.io.synthetic import SyntheticTrajectory
from mvil_fusion_torch.io.synthetic_lidar import BoxWorld, simulate_sweep
from mvil_fusion_torch.mapping import global_mapping as tgm
from mvil_fusion_torch.mapping import pose_graph as tpg
from mvil_fusion_torch.mapping.local_mapping import LocalMapper, Submap
from mvil_fusion_torch.ops import deskew
from mvil_fusion_torch.utils import nplie

LOOP_KW = dict(skip_recent_poses=6, poses_before_reclosing=4,
               proximity_threshold=4.0, max_tolerable_fitness=0.6,
               pg_n_max=64, pg_e_max=128, pg_z_max=64)
N_LOOP = 16
CARRY_AT = (5, 14)      # submap 14 closes the loop


def _cfgs(**kw):
    return (jconfig.SystemConfig(
                global_mapping=jconfig.GlobalMappingConfig(**kw)),
            tconfig.SystemConfig(
                global_mapping=tconfig.GlobalMappingConfig(**kw)))


def _loop_submaps():
    """The first lap of chip_smoke.py's square loop (the scenario of
    tests/test_global_mapping.py): [(fields of a Submap, true position)]."""
    subs, truth = chip_smoke.make_loop_submaps(n=N_LOOP)
    return [(dict(vars(sm)), p) for sm, p in zip(subs, truth)]


def _simple_submap(k, z=0.0, n_pts=800, seed=0):
    """A ring of points around a pose 2 m further along x, as
    tests/test_new_features.py makes them."""
    rng = np.random.default_rng(seed + k)
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    r = rng.uniform(3.0, 12.0, n_pts)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang),
                    rng.uniform(-1, 1, n_pts)], axis=1).astype(np.float32)
    p = np.asarray([2.0 * k, 0.0, z], np.float32)
    q = np.asarray([1.0, 0, 0, 0], np.float32)
    return dict(t=float(k), p_w=p, q_w=q, pts=pts, odom_p=p, odom_q=q)


def _jax_state(gm):
    """The JAX mapper's state as numpy, in the form that the port's
    load_reference_state takes."""
    st = {name: np.array(getattr(gm.graph, name))
          for name in tpg.PoseGraph._fields}
    n = gm.n_nodes
    st["scans"] = np.stack(gm.scans) if n else np.zeros((0, jgm.SCAN_CAP, 3))
    st["scan_masks"] = np.stack(gm.scan_masks) if n else np.zeros(
        (0, jgm.SCAN_CAP), bool)
    for name in tgm.STATE_ARRAYS[2:]:
        st[name] = np.array(getattr(gm, name))
    st["last_odom"] = None if gm.last_odom is None else tuple(
        np.array(v) for v in gm.last_odom)
    for name in tgm.STATE_LISTS[:3]:
        st[name] = list(getattr(gm, name))
    for name in tgm.STATE_COUNTERS:
        st[name] = getattr(gm, name)
    assert set(st) == set(tpg.PoseGraph._fields + tgm.STATE_ARRAYS
                          + tgm.STATE_LISTS + tgm.STATE_COUNTERS)
    return st


def _decisions(gm):
    return dict(n_nodes=gm.n_nodes, n_edges=gm.n_edges, n_z=gm.n_z,
                loop_pairs=[tuple(map(int, lp)) for lp in gm.loop_pairs],
                floor_ids=list(gm.floor_ids), times=list(gm.times),
                **gm.mapping_stats())


def _pose_gap(p_a, q_a, p_b, q_b):
    """(horizontal m, height m, rotation rad) between two poses."""
    d = np.asarray(p_a, np.float64) - np.asarray(p_b, np.float64)
    dq = nplie.quat_mul(nplie.quat_conj(q_b), q_a)
    return np.linalg.norm(d[:2]), abs(d[2]), 2 * np.linalg.norm(dq[1:])


def _assert_pose_close(p_t, q_t, p_j, q_j):
    xy, z, rot = _pose_gap(p_t, q_t, p_j, q_j)
    assert xy < 2e-2 and z < 0.15 and rot < np.radians(1.5), (xy, z, rot)


def _assert_info_equal(it, ij):
    assert (it["node"], it["floor"], it["closed_loop"], it["t"]) == \
        (ij["node"], ij["floor"], ij["closed_loop"], ij["t"])
    _assert_pose_close(it["p"], it["q"], ij["p"], ij["q"])


@pytest.fixture(scope="module")
def loop_runs():
    subs = _loop_submaps()
    jcfg, tcfg = _cfgs(**LOOP_KW)
    gj, gt = jgm.GlobalMapper(jcfg), tgm.GlobalMapper(tcfg, device="cpu")
    states, infos_j, infos_t = {}, [], []
    for k, (fields, _) in enumerate(subs):
        if k in CARRY_AT:
            states[k] = _jax_state(gj)
        infos_j.append(gj.add_submap(JaxSubmap(**fields)))
        infos_t.append(gt.add_submap(Submap(**fields)))
    return dict(subs=subs, gj=gj, gt=gt, states=states, infos_j=infos_j,
                infos_t=infos_t, tcfg=tcfg)


def test_loop_decisions_and_poses_match_jax(loop_runs):
    gj, gt = loop_runs["gj"], loop_runs["gt"]
    assert _decisions(gt) == _decisions(gj)
    assert gt.n_nodes == N_LOOP and gt.loops_closed >= 1 and gt.loop_pairs
    for it, ij in zip(loop_runs["infos_t"], loop_runs["infos_j"]):
        _assert_info_equal(it, ij)
    for (tt, pt, qt), (tj, pj, qj) in zip(gt.trajectory(), gj.trajectory()):
        assert tt == tj
        _assert_pose_close(pt, qt, pj, qj)
    # the stores: descriptors exact, graph edges as the poses
    n = gt.n_nodes
    np.testing.assert_array_equal(gt.sc_desc.numpy(), np.asarray(gj.sc_desc))
    np.testing.assert_array_equal(gt.scans[:n].numpy(), np.stack(gj.scans))
    g_t, g_j = tpg.graph_to_numpy(gt.graph), gj.graph
    for name in ("e_i", "e_j", "e_mask", "e_w", "z_node", "z_val", "z_w",
                 "z_mask", "node_mask"):
        np.testing.assert_array_equal(g_t[name],
                                      np.asarray(getattr(g_j, name)), name)
    np.testing.assert_allclose(g_t["e_dp"][:, :2],
                               np.asarray(g_j.e_dp)[:, :2], atol=3e-2)
    np.testing.assert_allclose(g_t["e_dp"][:, 2], np.asarray(g_j.e_dp)[:, 2],
                               atol=0.15)
    # the host mirror is the device graph
    np.testing.assert_array_equal(gt.p_host, g_t["p"])
    np.testing.assert_array_equal(gt.q_host, g_t["q"])


def test_loop_closure_beats_the_odometry(loop_runs):
    gt, subs = loop_runs["gt"], loop_runs["subs"]
    est = np.array([p for _, p, _ in gt.trajectory()])
    truth = np.array([p for _, p in subs])
    odom = np.array([f["p_w"] for f, _ in subs])
    # node 0 is pinned at its odometry pose: compare in its frame
    err = np.linalg.norm(est - est[0] - (truth - truth[0]), axis=1)
    odom_err = np.linalg.norm(odom - odom[0] - (truth - truth[0]), axis=1)
    assert np.isfinite(est).all()
    assert err[-4:].mean() < 0.5 * odom_err[-4:].mean()
    mp = gt.global_map()
    assert len(mp) > 1000 and np.isfinite(mp).all()
    mj = loop_runs["gj"].global_map()
    assert abs(len(mp) - len(mj)) <= 0.05 * len(mj)


def test_reference_moves_as_far_under_one_ulp(loop_runs):
    """Why heights are held to 0.15 m only: the JAX mapper, fed the same
    loop with its scans scaled by 1 − 2⁻²³, moves its own poses by
    centimetres in height (and keeps its decisions)."""
    gj = jgm.GlobalMapper(_cfgs(**LOOP_KW)[0])
    for fields, _ in loop_runs["subs"]:
        pts = (fields["pts"] * np.float32(1 - 2.0 ** -23)).astype(np.float32)
        gj.add_submap(JaxSubmap(**dict(fields, pts=pts)))
    ref = loop_runs["gj"]
    assert _decisions(gj) == _decisions(ref)
    gaps = np.array([_pose_gap(pa, qa, pb, qb) for (_, pa, qa), (_, pb, qb)
                     in zip(gj.trajectory(), ref.trajectory())])
    port = np.array([_pose_gap(pa, qa, pb, qb) for (_, pa, qa), (_, pb, qb)
                     in zip(loop_runs["gt"].trajectory(), ref.trajectory())])
    assert gaps[:, 1].max() > 0.02          # the hazard is there
    # the port is no further from JAX than a few times that
    assert (port.max(axis=0) < 3 * gaps.max(axis=0) + [5e-3, 0, 0]).all()


def test_readbacks_per_submap(loop_runs):
    """One fetch per decision: none for the first submap, one
    registration for each later one; a closed loop adds its verification,
    the solver's looks and the pose refresh."""
    gt = tgm.GlobalMapper(loop_runs["tcfg"], device="cpu")
    counts = []
    for fields, _ in loop_runs["subs"][:6]:
        before = gt.readbacks
        gt.add_submap(Submap(**fields))
        counts.append(gt.readbacks - before)
    assert counts == [0, 1, 1, 1, 1, 1]


@pytest.mark.parametrize("k", CARRY_AT)
def test_load_reference_state_then_one_submap(loop_runs, k):
    """From the JAX mapper's state after k submaps, submap k+1 alone
    lands where JAX's did, with the same decisions."""
    state = loop_runs["states"][k]
    gt = tgm.GlobalMapper(loop_runs["tcfg"], device="cpu")
    gt.load_reference_state(state)
    assert gt.n_nodes == k and len(gt.times) == k
    for name in tpg.PoseGraph._fields:
        np.testing.assert_array_equal(tpg.graph_to_numpy(gt.graph)[name],
                                      state[name], name)
    np.testing.assert_array_equal(gt.scans[:k].numpy(), state["scans"])
    assert not gt.scans[k:].any() and not gt.scan_masks[k:].any()
    info = gt.add_submap(Submap(**loop_runs["subs"][k][0]))
    ij = loop_runs["infos_j"][k]
    _assert_info_equal(info, ij)
    assert info["closed_loop"] == (k == 14)
    assert gt.n_nodes == k + 1
    if info["closed_loop"]:
        assert gt.loop_pairs == [tuple(map(int, lp)) for lp in
                                 loop_runs["gj"].loop_pairs]
        assert gt._since_last_close == 0
    # the state that was handed over is not aliased
    assert state["n_nodes"] == k and state["p_host"][k].tolist() == [0, 0, 0]


def test_load_reference_state_rejects_wrong_shape(loop_runs):
    state = dict(loop_runs["states"][5])
    gt = tgm.GlobalMapper(loop_runs["tcfg"], device="cpu")
    with pytest.raises(ValueError, match="scans"):
        gt.load_reference_state(dict(state, scans=state["scans"][:, :100]))
    with pytest.raises(ValueError, match="e_dp"):
        gt.load_reference_state(dict(state, e_dp=state["e_dp"][:7]))
    with pytest.raises(ValueError, match="n_nodes"):
        gt.load_reference_state(dict(state, n_nodes=65))


def test_capacity_evicts_as_jax_does():
    """At n_max = 8 over 12 submaps both mappers evict the oldest quarter
    twice; indices, edges and ScanContext slots stay aligned."""
    jcfg, tcfg = _cfgs(check_loop_closure=False, pg_n_max=8, pg_e_max=32,
                       pg_z_max=32)
    gj, gt = jgm.GlobalMapper(jcfg), tgm.GlobalMapper(tcfg, device="cpu")
    for k in range(12):
        fields = _simple_submap(k)
        ij = gj.add_submap(JaxSubmap(**fields))
        it = gt.add_submap(Submap(**fields))
        _assert_info_equal(it, ij)
    assert _decisions(gt) == _decisions(gj)
    assert gt.evictions == 2 and gt.n_nodes == 8
    assert gt.times == [float(k) for k in range(4, 12)]
    assert gt.n_edges >= gt.n_nodes - 1 - 2
    g_t = tpg.graph_to_numpy(gt.graph)
    for name in ("e_i", "e_j", "e_mask", "z_node", "z_mask", "node_mask"):
        np.testing.assert_array_equal(g_t[name],
                                      np.asarray(getattr(gj.graph, name)))
    np.testing.assert_array_equal(gt.sc_desc.numpy(), np.asarray(gj.sc_desc))
    np.testing.assert_array_equal(gt.scans[:8].numpy(), np.stack(gj.scans))
    np.testing.assert_array_equal(gt.p_host, g_t["p"])


def test_z_jump_triggers_graph_refresh_as_in_jax():
    jcfg, tcfg = _cfgs(check_loop_closure=False, pg_n_max=16, pg_e_max=32,
                       pg_z_max=16)
    gj, gt = jgm.GlobalMapper(jcfg), tgm.GlobalMapper(tcfg, device="cpu")
    for k in range(3):
        gj.add_submap(JaxSubmap(**_simple_submap(k)))
        gt.add_submap(Submap(**_simple_submap(k)))
    assert gt.map_refreshes == gj.map_refreshes == 0
    fields = _simple_submap(3, z=3.0)       # floor transition
    ij, it = gj.add_submap(JaxSubmap(**fields)), gt.add_submap(
        Submap(**fields))
    assert gt.map_refreshes == gj.map_refreshes == 1
    _assert_info_equal(it, ij)
    assert it["floor"] == 1
    np.testing.assert_allclose(gt.p_host, gj.p_host, atol=2e-2)


def test_capacities_are_configurable_and_default():
    _, tcfg = _cfgs(pg_n_max=64, pg_e_max=128, pg_z_max=32,
                    check_loop_closure=False)
    gm = tgm.GlobalMapper(tcfg, device="cpu")
    assert gm.graph.p.shape[0] == 64 and gm.graph.e_i.shape[0] == 128
    assert gm.graph.z_node.shape[0] == 32 and gm.sc_desc.shape[0] == 64
    assert gm.scans.shape == (64, tgm.SCAN_CAP, 3)
    assert (tgm.N_MAX, tgm.E_MAX, tgm.Z_MAX, tgm.SCAN_CAP) == \
        (jgm.N_MAX, jgm.E_MAX, jgm.Z_MAX, jgm.SCAN_CAP)
    assert (tgm.REF_TABLE, tgm.SCAN_TABLE, tgm.REG_POINTS) == \
        (1 << 17, 1 << 15, 4096)


def test_mapper_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("has a CUDA card: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgm.GlobalMapper(tconfig.SystemConfig())


def test_outputs(tmp_path, loop_runs):
    gt = loop_runs["gt"]
    path = tmp_path / "Backend.txt"
    gt.save_trajectory(str(path))
    rows = np.loadtxt(path)
    assert rows.shape == (N_LOOP, 8)
    np.testing.assert_allclose(rows[:, 1:4], gt.p_host[:N_LOOP], atol=1e-6)
    np.testing.assert_allclose(rows[:, 7], gt.q_host[:N_LOOP, 0], atol=1e-6)
    assert tgm.GlobalMapper(loop_runs["tcfg"],
                            device="cpu").global_map().shape == (0, 3)
    # a descriptor lost in a restore is made again
    want = gt.sc_desc[3].clone()
    gt.sc_desc[3] = 0.0
    gt.sc_keys[3] = 0.0
    gt.ensure_descriptor(3)
    assert torch.equal(gt.sc_desc[3], want)


def test_local_mapper_submaps_feed_the_global_mapper():
    """Six sweeps of 16 × 480 points through the port's LocalMapper (a
    submap every 3 frames), its two submaps through the port's
    GlobalMapper: the second is registered against the first."""
    tcfg = tconfig.SystemConfig(local_mapping=tconfig.LocalMappingConfig(
        submap_trigger_frames=3))
    traj = SyntheticTrajectory(duration=8.0, w_amp=(0.2, 0.15, 0.4),
                               w_freq=(0.2, 0.15, 0.25),
                               p_amp=(1.5, 1.2, 0.3),
                               p_freq=(0.2, 0.25, 0.15),
                               lin_vel=(0.5, 0.25, 0.0))
    comp = LidarCompensator(tcfg, device="cpu")
    lm = LocalMapper(tcfg, device="cpu")
    gm = tgm.GlobalMapper(tcfg, device="cpu")
    infos, truth = [], []
    for i in range(6):
        t0 = 0.8 + 0.1 * i
        s = simulate_sweep(BoxWorld(), traj, t0, n_azimuth=480)
        odom = [torch.as_tensor(np.asarray(v, np.float32))
                for v in (*traj.pose_at(t0), *traj.pose_at(t0 + 0.1))]
        sw = comp.process(t0, s["pts"], s["mask"])
        pts = deskew.deskew_to_end(sw.pts, sw.rel_time, *odom, 0.1)
        sm = lm.process_full(t0 + 0.1, pts, sw.ring, sw.rel_time, sw.mask,
                             None, odom[2], odom[3], n_rings=16,
                             n_azimuth=480, scan_period=0.1)
        if sm is not None:
            infos.append(gm.add_submap(sm))
            truth.append(traj.pose_at(t0 + 0.1)[0])
    assert len(infos) == 2 and gm.n_nodes == 2 and gm.n_edges == 1
    assert gm.readbacks == 1
    for info, p_true in zip(infos, truth):
        assert np.isfinite(info["p"]).all()
        assert np.linalg.norm(info["p"] - p_true) < 0.10


def test_new_modules_and_scripts_import_no_jax():
    """In a fresh interpreter: the stage's modules, chip_smoke.py and
    profile_slice.py load neither JAX nor the JAX package."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "import chip_smoke, profile_slice\n"
        "import mvil_fusion_torch.mapping.global_mapping\n"
        "import mvil_fusion_torch.mapping.pose_graph\n"
        "import mvil_fusion_torch.ops.vgicp, mvil_fusion_torch.ops.voxel\n"
        "import mvil_fusion_torch.ops.scancontext\n"
        "import mvil_fusion_torch.utils.nplie, mvil_fusion_torch.config\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'mvil_fusion_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
