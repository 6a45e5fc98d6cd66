"""The port's pose-graph solvers against the JAX package's
(``mapping/pose_graph.py``), on graphs made with numpy from a seed, on
the CPU.

Tolerances: per-edge residual within 1e-5 and the analytic Jacobian
within 1e-5 of JAX's forward-mode one per unit of edge weight; `solve`
and `solve_cg` node positions within 5 mm and quaternions within 1e-3 of
JAX's on the 40-node loop, with and without z priors; the port's CG
within 0.05 m of its own dense solve (the reference's bound for its
pair); at 512 nodes and 2048 edges (chip_smoke.py's helix, the graph of
tests/test_global_mapping.py) the port alone, by the reference's gate
(maximum error below a fifth of the drifted chain's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mvil_fusion_tpu.mapping import pose_graph as jpg
from mvil_fusion_tpu.utils import lie as jlie
from mvil_fusion_torch.mapping import pose_graph as tpg

_jsolve = jax.jit(jpg.solve, static_argnames=("iters",))
_jsolve_cg = jax.jit(jpg.solve_cg, static_argnames=("iters", "cg_iters"))


def _empty(n, e, z):
    ident = np.asarray([1, 0, 0, 0], np.float32)
    f32 = np.float32
    return dict(
        p=np.zeros((n, 3), f32), q=np.tile(ident, (n, 1)),
        node_mask=np.zeros(n, bool),
        e_i=np.zeros(e, np.int32), e_j=np.zeros(e, np.int32),
        e_dp=np.zeros((e, 3), f32), e_dq=np.tile(ident, (e, 1)),
        e_w=np.zeros(e, f32), e_mask=np.zeros(e, bool),
        z_node=np.zeros(z, np.int32), z_val=np.zeros(z, f32),
        z_w=np.zeros(z, f32), z_mask=np.zeros(z, bool))


def _quat_z(yaw):
    return np.asarray([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])


def _rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def make_loop_graph(n=40, drift=0.03, seed=0, z_priors=False):
    """Square loop with odometry drift + one loop-closure edge holding the
    true relative pose: the scenario of tests/test_global_mapping.py, as
    numpy arrays.  Returns (arrays, true positions, n)."""
    rng = np.random.default_rng(seed)
    g = _empty(64, 128, 64)
    side = n // 4
    p_true, yaws = [], []
    p, yaw = np.zeros(3), 0.0
    for k in range(n):
        if k and k % side == 0:
            yaw += np.pi / 2
        p = p + np.asarray([np.cos(yaw), np.sin(yaw), 0.0])
        p_true.append(p.copy())
        yaws.append(yaw)
    p_est = [p_true[0]]

    def edge(e, i, j, dp, w):
        g["e_i"][e], g["e_j"][e], g["e_dp"][e] = i, j, dp
        g["e_dq"][e] = _quat_z(yaws[j] - yaws[i])
        g["e_w"][e], g["e_mask"][e] = w, True

    for k in range(1, n):
        R = _rot_z(yaws[k - 1])
        dp = R.T @ (p_true[k] - p_true[k - 1]) + rng.normal(scale=drift,
                                                            size=3)
        p_est.append(p_est[-1] + R @ dp)
        edge(k - 1, k - 1, k, dp, 10.0)
    edge(n - 1, 0, n - 1, _rot_z(yaws[0]).T @ (p_true[n - 1] - p_true[0]),
         20.0)
    g["p"][:n] = np.asarray(p_est)
    g["q"][:n] = np.asarray([_quat_z(y) for y in yaws])
    g["node_mask"][:n] = True
    if z_priors:
        for k in range(0, n, 3):
            g["z_node"][k // 3], g["z_val"][k // 3] = k, p_true[k][2]
            g["z_w"][k // 3], g["z_mask"][k // 3] = 1.5, True
    return g, np.asarray(p_true), n


def _jax_graph(arrays):
    return jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _torch_graph(arrays):
    return tpg.graph_from_numpy(arrays, device="cpu")


@jax.jit
def _jax_edge_system(g):
    """Per-edge masked residual and forward-mode Jacobian, as the
    reference's solvers form them."""
    def per_edge(pi, qi, pj, qj, dp, dq, w, m):
        def local(delta):
            pi_ = pi + delta[0:3]
            qi_ = jlie.quat_mul(qi, jlie.quat_exp(delta[3:6]))
            pj_ = pj + delta[6:9]
            qj_ = jlie.quat_mul(qj, jlie.quat_exp(delta[9:12]))
            return jpg._between_residual(pi_, qi_, pj_, qj_, dp, dq) * w

        zeros = jnp.zeros((12,), pi.dtype)
        mm = m.astype(pi.dtype)
        return local(zeros) * mm, jax.jacfwd(local)(zeros) * mm

    return jax.vmap(per_edge)(g.p[g.e_i], g.q[g.e_i], g.p[g.e_j],
                              g.q[g.e_j], g.e_dp, g.e_dq, g.e_w, g.e_mask)


def _random_graph(seed, max_angle, n=24, e=96):
    """Random 3-D poses; each edge measures the true relative pose turned
    by up to `max_angle` rad and moved by up to 0.3 m; a quarter of the
    edges masked."""
    rng = np.random.default_rng(seed)
    g = _empty(n, e, 4)

    def rand_quat(scale, size):
        v = rng.normal(size=(size, 3))
        v *= (rng.uniform(0, scale, size) / np.linalg.norm(v, axis=1))[:,
                                                                       None]
        return np.asarray(jlie.quat_exp(jnp.asarray(v, jnp.float32)))

    g["p"] = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    g["q"] = rand_quat(np.pi, n)
    g["node_mask"][:] = True
    g["e_i"] = rng.integers(0, n, e).astype(np.int32)
    g["e_j"] = ((g["e_i"] + rng.integers(1, n, e)) % n).astype(np.int32)
    f = lambda a: jnp.asarray(a)
    dp, dq = jlie.pose_between(f(g["p"][g["e_i"]]), f(g["q"][g["e_i"]]),
                               f(g["p"][g["e_j"]]), f(g["q"][g["e_j"]]))
    g["e_dp"] = np.asarray(dp) + rng.uniform(-0.3, 0.3, (e, 3)).astype(
        np.float32)
    g["e_dq"] = np.asarray(jlie.quat_normalize(jlie.quat_mul(
        dq, f(rand_quat(max_angle, e)))))
    g["e_w"] = rng.uniform(0.5, 20.0, e).astype(np.float32)
    g["e_mask"] = rng.uniform(size=e) > 0.25
    return g


@pytest.mark.parametrize("seed,max_angle", [(0, 1e-4), (1, 0.04), (2, 0.5),
                                            (3, 2.5)])
def test_edge_residual_and_jacobian_match_jax(seed, max_angle):
    g = _random_graph(seed, max_angle)
    r_j, J_j = _jax_edge_system(_jax_graph(g))
    gt = _torch_graph(g)
    r_t, J_t = tpg.edge_system(gt, gt.p, gt.q)
    w = np.maximum(g["e_w"], 1.0)
    assert np.abs(r_t.numpy() - np.asarray(r_j)).max() < 1e-5 * w.max()
    err = np.abs(J_t.numpy() - np.asarray(J_j)) / w[:, None, None]
    # lever arms reach 35 m: the bound is relative to the entries' size
    assert err.max() < 1e-5 * max(1.0, np.abs(np.asarray(J_j)).max()
                                  / w.max())
    masked = ~g["e_mask"]
    assert masked.any() and not J_t.numpy()[masked].any()
    assert np.abs(J_t.numpy()[~masked]).min(axis=(1, 2)).max() == 0.0


@pytest.fixture(scope="module", params=[False, True],
                ids=["no_z_priors", "z_priors"])
def loop(request):
    arrays, p_true, n = make_loop_graph(z_priors=request.param)
    return arrays, p_true, n


@pytest.mark.parametrize("solver", ["solve", "solve_cg"])
def test_solvers_match_jax_on_loop_graph(loop, solver):
    arrays, p_true, n = loop
    gj = _jax_graph(arrays)
    if solver == "solve":
        out_j = _jsolve(gj, iters=15)
        out_t = tpg.solve(_torch_graph(arrays), iters=15)
    else:
        out_j = _jsolve_cg(gj, iters=15, cg_iters=64)
        out_t = tpg.solve_cg(_torch_graph(arrays), iters=15, cg_iters=64)
    assert np.abs(out_t.p.numpy() - np.asarray(out_j.p)).max() < 5e-3
    assert np.abs(out_t.q.numpy() - np.asarray(out_j.q)).max() < 1e-3
    err_before = np.linalg.norm(arrays["p"][:n] - p_true, axis=1)
    err_after = np.linalg.norm(out_t.p.numpy()[:n] - p_true, axis=1)
    assert err_after.max() < 0.55 * err_before.max()
    assert err_after.max() < 0.25
    # the input graph is left as it was, and only p and q are new
    for name in tpg.PoseGraph._fields[2:]:
        assert getattr(out_t, name).numpy().tolist() == \
            np.asarray(arrays[name]).tolist()


def test_z_priors_flatten_as_in_jax():
    arrays, _, n = make_loop_graph()
    arrays["p"][:n, 2] += np.linspace(0, 1.5, n).astype(np.float32)
    arrays["z_node"][:n] = np.arange(n)
    arrays["z_w"][:n], arrays["z_mask"][:n] = 2.0, True
    out_j = _jsolve(_jax_graph(arrays), iters=15)
    out_t = tpg.solve(_torch_graph(arrays), iters=15)
    assert np.abs(out_t.p.numpy()[:n, 2]).max() < 0.15
    assert np.abs(out_t.p.numpy() - np.asarray(out_j.p)).max() < 5e-3


def test_cg_matches_own_dense_solve(loop):
    arrays, p_true, n = loop
    g = _torch_graph(arrays)
    dense = tpg.solve(g, iters=15)
    cg = tpg.solve_cg(g, iters=15, cg_iters=64)
    assert np.linalg.norm(cg.p.numpy()[:n] - p_true, axis=1).max() < 0.25
    np.testing.assert_allclose(cg.p.numpy()[:n], dense.p.numpy()[:n],
                               atol=0.05)


def test_cg_result_does_not_depend_on_the_check_cadence(loop):
    """The stopping rules act on the device (frozen carries); how often
    the host looks only decides how much it queues in vain."""
    g = _torch_graph(loop[0])
    outs, stats = [], []
    for every in (1, 16, 0):
        st = {}
        outs.append(tpg.solve_cg(g, iters=6, cg_iters=32, check_every=every,
                                 stats=st))
        stats.append(st)
    for o in outs[1:]:
        assert torch.equal(o.p, outs[0].p) and torch.equal(o.q, outs[0].q)
    assert stats[2] == dict(syncs=0, lm_queued=6, cg_queued=6 * 32)
    assert stats[1]["syncs"] <= 6 * 2 and stats[0]["syncs"] <= 6 * 32
    assert stats[0]["cg_queued"] <= stats[1]["cg_queued"] <= 6 * 32


def test_cg_stops_at_once_on_a_consistent_graph():
    """Integer positions and identity rotations: every residual is exactly
    0, so rz₀ = 0, no CG iteration is queued and each LM step costs the
    one look that finds PCG already stopped."""
    g = _empty(16, 32, 4)
    n = 10
    g["p"][:n] = np.random.default_rng(0).integers(-9, 9, (n, 3))
    g["node_mask"][:n] = True
    g["e_i"][:n - 1], g["e_j"][:n - 1] = np.arange(n - 1), np.arange(1, n)
    g["e_dp"][:n - 1] = g["p"][1:n] - g["p"][:n - 1]
    g["e_w"][:n - 1], g["e_mask"][:n - 1] = 10.0, True
    st = {}
    out = tpg.solve_cg(_torch_graph(g), iters=7, check_every=1, stats=st)
    assert st == dict(syncs=7, lm_queued=7, cg_queued=0)
    np.testing.assert_array_equal(out.p.numpy(), g["p"])


def test_cg_at_capacity_512():
    """The CG solver at full capacity (512 nodes, 2048 edges): memory
    linear in the capacities, no (E,6,6N) intermediate."""
    arrays, p_true = chip_smoke.make_helix_graph()
    g2 = tpg.solve_cg(_torch_graph(arrays), iters=8, cg_iters=64)
    err_before = np.linalg.norm(arrays["p"] - p_true, axis=1)
    err_after = np.linalg.norm(g2.p.numpy() - p_true, axis=1)
    assert np.isfinite(err_after).all()
    assert err_after.max() < 0.2 * err_before.max(), (
        err_before.max(), err_after.max())


def test_graph_numpy_round_trip_and_empty_graph():
    arrays, _, _ = make_loop_graph(z_priors=True)
    g = _torch_graph(arrays)
    assert g.e_i.dtype == torch.int64 and g.e_mask.dtype == torch.bool
    back = tpg.graph_to_numpy(g)
    assert list(back) == list(tpg.PoseGraph._fields)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)
        assert back[name].dtype == a.dtype, name
    # a copy: the source arrays are not aliased
    g.p[0, 0] = 99.0
    assert arrays["p"][0, 0] != 99.0
    e = tpg.empty_graph(8, 16, 4, device="cpu")
    ej = jpg.empty_graph(8, 16, 4)
    for name in tpg.PoseGraph._fields:
        np.testing.assert_array_equal(
            tpg.graph_to_numpy(e)[name], np.asarray(getattr(ej, name)))


def test_graph_factories_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("has a CUDA card: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpg.empty_graph(8, 16, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpg.graph_from_numpy(make_loop_graph()[0])
