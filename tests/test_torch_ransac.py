"""The port's fundamental-matrix RANSAC against the JAX package's
(``ops/ransac.py``) on the two-view scene of tests/test_vision_ops.py.

No generator of PyTorch reproduces `jax.random.choice`, so the hypotheses'
sample indices are drawn with JAX and handed to both.  Tolerance: identical
inlier masks and counts; the best F equal up to sign after scaling to unit
norm, within 1e-4 (2e-5 seen); null vectors within 1e-5 up to sign; every
hypothesis of 8 distinct points equal up to sign within 1e-3 of its norm (a sample
that repeats a point is rank-deficient and its null vector arbitrary).
The port's own sampler is checked for what it promises: valid slots only,
all of them reachable, the last slot when none is valid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu.ops import ransac as jran
from mvil_fusion_torch.ops import ransac as tran
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

N, N_OUT, FOCAL, N_HYP = 120, 25, 460.0, 128

_jransac = jax.jit(jran.fundamental_ransac,
                   static_argnames=("threshold", "n_hyp"))
_jeight = jax.jit(jax.vmap(jran._eight_point))


@pytest.fixture(scope="module")
def scene():
    """(x1, x2 with outliers, valid, outlier flags, sample indices)."""
    rng = np.random.default_rng(0)
    pts3 = rng.uniform([-2, -2, 4], [2, 2, 10], size=(N, 3)).astype(
        np.float32)
    R = np.asarray([[0.9950042, 0.0, 0.0998334], [0.0, 1.0, 0.0],
                    [-0.0998334, 0.0, 0.9950042]], np.float32)
    t = np.asarray([0.3, 0.05, 0.02], np.float32)
    x1 = pts3[:, :2] / pts3[:, 2:3] * FOCAL
    p2 = pts3 @ R.T + t
    x2 = p2[:, :2] / p2[:, 2:3] * FOCAL
    out_idx = rng.choice(N, N_OUT, replace=False)
    x2[out_idx] += rng.uniform(15, 60, size=(N_OUT, 2)) * rng.choice(
        [-1, 1], size=(N_OUT, 2))
    is_out = np.zeros(N, bool)
    is_out[out_idx] = True
    valid = np.ones(N, bool)
    valid[::7] = False
    return x1, x2, valid, is_out


def _jax_indices(key, valid, n_hyp):
    p = jnp.asarray(valid, jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    return np.array(jax.random.choice(key, len(valid), shape=(n_hyp, 8),
                                      replace=True, p=p))


def _unit_up_to_sign(a, b):
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


@pytest.mark.parametrize("seed,all_valid", [(0, True), (1, False),
                                            (2, False)])
def test_ransac_matches_reference_on_shared_hypotheses(scene, seed,
                                                       all_valid):
    x1, x2, valid, is_out = scene
    n_hyp = N_HYP
    if all_valid:
        valid = np.ones(N, bool)
    key = jax.random.PRNGKey(seed)
    idx = _jax_indices(key, valid, n_hyp)
    rj = _jransac(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
                  threshold=1.0, n_hyp=n_hyp)
    rt = tran.fundamental_ransac(torch.as_tensor(x1), torch.as_tensor(x2),
                                 torch.as_tensor(valid), threshold=1.0,
                                 n_hyp=n_hyp, idx=torch.as_tensor(idx))
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    assert _unit_up_to_sign(rt.F.numpy(), np.asarray(rj.F)) < 1e-4
    inl = rt.inliers.numpy()
    assert not (inl & is_out).any() and not (inl & ~valid).any()
    assert inl[~is_out & valid].mean() > 0.85


def test_eight_point_and_sampson_match_reference(scene):
    x1, x2, valid, _ = scene
    idx = _jax_indices(jax.random.PRNGKey(3), valid, 128)
    j1, j2 = jnp.asarray(x1), jnp.asarray(x2)
    Fj = np.asarray(_jeight(j1[idx], j2[idx]))
    ti = torch.as_tensor(idx)
    Ft = tran._eight_point(torch.as_tensor(x1)[ti], torch.as_tensor(x2)[ti])
    distinct = np.asarray([len(set(row)) == 8 for row in idx])
    assert distinct.sum() > 64
    for k in np.nonzero(distinct)[0]:
        assert _unit_up_to_sign(Ft[k].numpy(), Fj[k]) < 1e-3, k
    dj = np.asarray(jax.vmap(lambda F: jran._sampson(F, j1, j2))(
        jnp.asarray(Fj)))
    dt = tran._sampson(torch.as_tensor(Fj), torch.as_tensor(x1),
                       torch.as_tensor(x2)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-3, atol=1e-6)


def test_nullvec9_matches_reference():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(32, 8, 9)).astype(np.float32)
    qj = np.asarray(jax.jit(jax.vmap(jran._nullvec9))(jnp.asarray(A)))
    qt = tran._nullvec9(torch.as_tensor(A)).numpy()
    for a, b in zip(qt, qj):
        assert _unit_up_to_sign(a, b) < 1e-5
    np.testing.assert_allclose(np.linalg.norm(qt, axis=1), 1.0, atol=1e-5)
    assert np.abs(np.einsum("bij,bj->bi", A, qt)).max() < 1e-4


def test_sampler_draws_valid_slots_only(scene):
    _, _, valid, _ = scene
    g = torch.Generator().manual_seed(7)
    idx = tran.sample_hypotheses(torch.as_tensor(valid), 512, g).numpy()
    assert idx.shape == (512, 8) and valid[idx].all()
    assert set(np.unique(idx)) == set(np.nonzero(valid)[0])
    again = tran.sample_hypotheses(torch.as_tensor(valid), 512,
                                   torch.Generator().manual_seed(7)).numpy()
    np.testing.assert_array_equal(idx, again)
    none = tran.sample_hypotheses(torch.zeros(10, dtype=torch.bool), 4, g)
    assert (none == 9).all()


def test_ransac_with_its_own_generator(scene):
    x1, x2, valid, is_out = scene
    g = torch.Generator().manual_seed(11)
    res = tran.fundamental_ransac(torch.as_tensor(x1), torch.as_tensor(x2),
                                  torch.as_tensor(valid), generator=g)
    inl = res.inliers.numpy()
    assert not (inl & is_out).any()
    assert inl[~is_out & valid].mean() > 0.85
    # no valid slot: no inlier, and no error
    res = tran.fundamental_ransac(torch.as_tensor(x1), torch.as_tensor(x2),
                                  torch.zeros(N, dtype=torch.bool),
                                  generator=g)
    assert int(res.n_inliers) == 0 and not res.inliers.any()
