"""The port's window triangulation against the JAX package's
(``ops/triangulate.py``): landmarks of the synthetic world seen from a
window of true camera poses, with observation noise, features seen once
and empty slots.

Tolerance: `good` identical; inverse depth within 1e-4 relative where
good (the two `eigh` differ in the eigenvector's sign, which cancels, and
in rounding); camera poses from body poses within 1e-6.
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

RIC = np.asarray([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
TIC = np.asarray([0.05, -0.02, 0.01])
F_SLOTS, WINDOW = 64, 7
T = torch.as_tensor


def mat_to_quat(R):
    return tlie.mat_to_quat(T(np.asarray(R, np.float64))).numpy()

_jtriangulate = jax.jit(jtri.triangulate_window)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and several test processes that each spin up a thread pool per op
    slow one another down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
