"""The port's window triangulation against the JAX package's
(``ops/triangulate.py``): landmarks of the synthetic world seen from a
window of true camera poses, with observation noise, features seen once
and empty slots.

Tolerance: `good` identical; inverse depth within 1e-4 relative where
good (the port's float64 inverse iteration and the reference's fp32
`eigh` differ in the eigenvector's sign, which cancels, and in rounding;
at low parallax see the test); camera poses from body poses within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu.io.synthetic import SyntheticTrajectory, SyntheticWorld
from mvil_fusion_tpu.ops import triangulate as jtri
from mvil_fusion_torch.ops import triangulate as ttri
from mvil_fusion_torch.utils import lie as tlie
from mvil_fusion_torch.utils import nplie
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

RIC = np.asarray([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
TIC = np.asarray([0.05, -0.02, 0.01])
F_SLOTS, WINDOW = 64, 7
T = torch.as_tensor


def mat_to_quat(R):
    return tlie.mat_to_quat(T(np.asarray(R, np.float64))).numpy()

_jtriangulate = jax.jit(jtri.triangulate_window)


@pytest.fixture(scope="module")
def window():
    """(p_wc, q_wc, obs, mask, start, true depth in the start frame)."""
    world = SyntheticWorld(traj=SyntheticTrajectory(duration=4.0),
                           n_landmarks=1500, seed=1)
    times = 0.5 + 0.25 * np.arange(WINDOW)
    rng = np.random.default_rng(0)
    obs = np.zeros((F_SLOTS, WINDOW, 2), np.float32)
    mask = np.zeros((F_SLOTS, WINDOW), bool)
    depth = np.zeros((F_SLOTS, WINDOW))
    vis_all = np.stack([world.project(t, RIC, TIC)[3] for t in times])
    seen = np.nonzero(vis_all.sum(0) >= 3)[0][:F_SLOTS - 8]
    p_wc, q_wc = [], []
    for w, t in enumerate(times):
        _, norm, z, vis = world.project(t, RIC, TIC)
        obs[:len(seen), w] = norm[seen] + rng.normal(scale=1e-4,
                                                     size=(len(seen), 2))
        mask[:len(seen), w] = vis[seen]
        depth[:len(seen), w] = z[seen]
        p_wb, q_wb = world.traj.pose_at(t)
        R_wb = nplie.quat_to_mat(q_wb)
        p_wc.append(R_wb @ TIC + p_wb)
        q_wc.append(mat_to_quat(R_wb @ RIC))
    mask[3, 1:] = False                       # a single view
    mask[4] = False                           # no view
    start = np.argmax(mask, axis=1)
    true_depth = depth[np.arange(F_SLOTS), start]
    f32 = np.float32
    return (np.asarray(p_wc, f32), np.asarray(q_wc, f32), obs, mask,
            start.astype(np.int32), true_depth)


def test_triangulation_matches_reference(window):
    p_wc, q_wc, obs, mask, start, true_depth = window
    inv_j, good_j = _jtriangulate(*(jnp.asarray(a) for a in
                                    (p_wc, q_wc, obs, mask, start)))
    inv_t, good_t = ttri.triangulate_window(
        T(p_wc), T(q_wc), T(obs), T(mask), T(start).to(torch.int64))
    good = np.asarray(good_j)
    np.testing.assert_array_equal(good_t.numpy(), good)
    assert good.sum() > 40 and not good[3] and not good[4]
    np.testing.assert_allclose(inv_t.numpy()[good], np.asarray(inv_j)[good],
                               rtol=1e-4)
    assert (inv_t.numpy()[~good] == 1.0).all()
    # and both are right: depth within 2 % of the truth
    rel = np.abs(1.0 / inv_t.numpy()[good] - true_depth[good]) \
        / true_depth[good]
    assert np.median(rel) < 5e-3 and rel.max() < 0.02


def test_two_views_suffice_and_one_does_not(window):
    p_wc, q_wc, obs, mask, start, _ = window
    two = mask.copy()
    two[:, 1:-1] = False                      # the first and the last view
    both = two[:, 0] & two[:, -1]
    inv_j, good_j = _jtriangulate(*(jnp.asarray(a) for a in
                                    (p_wc, q_wc, obs, two, start)))
    inv_t, good_t = ttri.triangulate_window(
        T(p_wc), T(q_wc), T(obs), T(two), T(start).to(torch.int64))
    np.testing.assert_array_equal(good_t.numpy(), np.asarray(good_j))
    assert not good_t.numpy()[~both].any() and good_t.numpy()[both].sum() > 10
    g = good_t.numpy()
    np.testing.assert_allclose(inv_t.numpy()[g], np.asarray(inv_j)[g],
                               rtol=1e-4)


def test_camera_poses_from_body_match_reference(window):
    rng = np.random.default_rng(1)
    p_wb = rng.normal(size=(WINDOW, 3)).astype(np.float32)
    q_wb = rng.normal(size=(WINDOW, 4)).astype(np.float32)
    q_wb /= np.linalg.norm(q_wb, axis=1, keepdims=True)
    tic = TIC.astype(np.float32)
    qic = mat_to_quat(RIC).astype(np.float32)
    pj, qj = jtri.camera_poses_from_body(*(jnp.asarray(a) for a in
                                           (p_wb, q_wb, tic, qic)))
    pt, qt = ttri.camera_poses_from_body(T(p_wb), T(q_wb), T(tic), T(qic))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-6)


def low_parallax_window(spacing, noise_px=0.0):
    """Seven frames `spacing` s apart, landmarks seen in all of them:
    (triangulate_window's arguments, true inverse depth in frame 0)."""
    world = SyntheticWorld(traj=SyntheticTrajectory(duration=4.0),
                           n_landmarks=1500, seed=2)
    times = 1.0 + spacing * np.arange(WINDOW)
    vis = np.stack([world.project(t, RIC, TIC)[3] for t in times])
    seen = np.nonzero(vis.all(0))[0][:F_SLOTS]
    n = len(seen)
    rng = np.random.default_rng(3)
    obs = np.zeros((F_SLOTS, WINDOW, 2), np.float32)
    mask = np.zeros((F_SLOTS, WINDOW), bool)
    mask[:n] = True
    p_wc, q_wc = [], []
    for w, t in enumerate(times):
        obs[:n, w] = world.project(t, RIC, TIC)[1][seen] + rng.normal(
            scale=noise_px / 460.0, size=(n, 2))
        p_wb, q_wb = world.traj.pose_at(t)
        R_wb = nplie.quat_to_mat(q_wb)
        p_wc.append(R_wb @ TIC + p_wb)
        q_wc.append(mat_to_quat(R_wb @ RIC))
    truth = np.ones(F_SLOTS)
    truth[:n] = 1.0 / world.project(times[0], RIC, TIC)[2][seen]
    f32 = np.float32
    return (np.asarray(p_wc, f32), np.asarray(q_wc, f32), obs, mask,
            np.zeros(F_SLOTS, np.int32)), truth


def both_packages(args):
    """(inverse depth of JAX, of the port, good) where both say good,
    after checking that they agree on good."""
    inv_j, good_j = _jtriangulate(*(jnp.asarray(a) for a in args))
    inv_t, good_t = ttri.triangulate_window(
        *(T(a) for a in args[:4]), T(args[4]).to(torch.int64))
    good = np.asarray(good_j)
    np.testing.assert_array_equal(good_t.numpy(), good)
    assert good.sum() > 40
    return np.asarray(inv_j)[good], inv_t.numpy()[good], good


@pytest.mark.parametrize("spacing", [0.05, 0.02, 0.005])
def test_low_parallax_matches_reference(spacing):
    """Seven frames `spacing` s apart (0.3, 0.12 and 0.03 s in all), exact
    projections: rays within a few degrees, down to a tenth of one.  The
    port forms AᵀA and takes its smallest eigenvector in float64, the
    reference in fp32, whose error grows as the parallax shrinks (up to
    2e-4, 2.3e-3 and 0.13 of the inverse depth here).  `good` identical;
    the port within 1e-4 relative of the true inverse depth, and of the
    reference's within the reference's own distance from the truth plus
    1e-4 (all relative to the truth)."""
    args, truth = low_parallax_window(spacing)
    inv_j, inv_t, good = both_packages(args)
    err_j = np.abs(inv_j - truth[good]) / truth[good]
    np.testing.assert_allclose(inv_t, truth[good], rtol=1e-4)
    assert (np.abs(inv_t - inv_j) / truth[good] <= err_j + 1e-4).all()


@pytest.mark.parametrize("spacing", [0.02, 0.005])
def test_low_parallax_with_noise_matches_reference(spacing):
    """As above with 0.5 px of observation noise: the smallest eigenvalue
    of AᵀA is no longer near zero, and the gap to the next one shrinks
    (their ratio reaches 2e-3 and 8e-2 here), which slows the port's
    inverse iteration.  The exact answer is now the least-squares one,
    the smallest eigenvector of the same AᵀA by float64 `eigh`.  `good`
    identical; the port within 1e-4 relative of that answer, and of the
    reference's within the reference's own distance from it plus 1e-4."""
    args, _ = low_parallax_window(spacing, noise_px=0.5)
    inv_j, inv_t, good = both_packages(args)
    p_wc, q_wc, obs = (np.asarray(a, np.float64) for a in args[:3])
    R_cw = np.stack([nplie.quat_to_mat(q).T for q in q_wc])
    P = np.concatenate([R_cw, -R_cw @ p_wc[..., None]], axis=-1)
    A = np.concatenate([obs[..., 0:1] * P[None, :, 2] - P[None, :, 0],
                        obs[..., 1:2] * P[None, :, 2] - P[None, :, 1]], 1)
    lam, V = np.linalg.eigh(A.transpose(0, 2, 1) @ A)
    X = V[..., 0]
    exact = (X[:, 3] / (X @ P[0, 2]))[good]
    assert (lam[good, 0] / lam[good, 1]).max() > {0.02: 1e-3,
                                                 0.005: 5e-2}[spacing]
    err_j = np.abs(inv_j - exact) / np.abs(exact)
    np.testing.assert_allclose(inv_t, exact, rtol=1e-4)
    assert (np.abs(inv_t - inv_j) / np.abs(exact) <= err_j + 1e-4).all()
