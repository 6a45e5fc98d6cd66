"""The port's Gaussian voxel map and its lookups against the JAX package's
(``ops/voxel.py``), on seeded numpy clouds, on the CPU.

Tolerances: `coords` and `count` exact (the bucket's owner is the voxel of
the highest-indexed point in both packages); `mean` within 1e-5; the
regularized `cov` through its plane normal v₀ up to sign, within 1e-3, on
voxels that hold a plane (cov = E[xxᵀ] − mean·meanᵀ cancels in fp32, so a
voxel without a clear normal is not compared); `lookup` and `lookup7` hit
masks identical and values equal to the rows they gather.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu.ops import voxel as jvox
from mvil_fusion_torch.ops import voxel as tvox

TABLE = 1 << 12
LEAF = 0.5

_jbuild = jax.jit(jvox.build_gaussian_voxel_map,
                  static_argnames=("leaf", "table_size", "min_points",
                                   "plane_eps"))


def _planes_cloud(seed, n=6000, masked=0.1):
    """Points on three noisy planes of a 6 m room corner, plus a mask."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 6.0, (n, 3))
    wall = rng.integers(0, 3, n)
    pts[np.arange(n), wall] = rng.normal(scale=0.01, size=n)
    pts += np.asarray([3.0, -7.0, 1.0])
    return pts.astype(np.float32), rng.uniform(size=n) >= masked


def _both(pts, mask, table_size=TABLE, **kw):
    vj = _jbuild(jnp.asarray(pts), jnp.asarray(mask), leaf=LEAF,
                 table_size=table_size, **kw)
    vt = tvox.build_gaussian_voxel_map(torch.as_tensor(pts),
                                       torch.as_tensor(mask), LEAF,
                                       table_size=table_size, **kw)
    return vj, vt


def _normal(cov, plane_eps=1e-3):
    """v₀v₀ᵀ back out of cov = I − (1−eps)·v₀v₀ᵀ."""
    return (np.eye(3) - cov) / (1.0 - plane_eps)


@pytest.mark.parametrize("seed,table_size,min_points", [
    (0, TABLE, 2), (1, TABLE, 2), (2, 1 << 9, 2), (3, TABLE, 5)])
def test_voxel_map_matches_jax(seed, table_size, min_points):
    pts, mask = _planes_cloud(seed)
    vj, vt = _both(pts, mask, table_size, min_points=min_points)
    np.testing.assert_array_equal(vt.coords.numpy(), np.asarray(vj.coords))
    np.testing.assert_array_equal(vt.count.numpy(), np.asarray(vj.count))
    assert vt.coords.dtype == torch.int32
    np.testing.assert_allclose(vt.mean.numpy(), np.asarray(vj.mean),
                               rtol=0, atol=1e-5)
    assert (vt.leaf, vt.table_size) == (vj.leaf, vj.table_size)
    # plane voxels: enough points, and a normal along an axis in JAX's map
    vvj = _normal(np.asarray(vj.cov))
    planar = (np.asarray(vj.count) >= 8) & \
        (np.abs(vvj).reshape(-1, 9).max(axis=1) > 0.98)
    assert planar.sum() > 50
    np.testing.assert_allclose(_normal(vt.cov.numpy())[planar], vvj[planar],
                               rtol=0, atol=1e-3)
    if table_size < TABLE:      # the small table is contested
        n_vox = len(np.unique(np.floor(pts[mask] / LEAF), axis=0))
        assert n_vox > int((vt.count > 0).sum())


def test_voxel_map_collision_keeps_highest_index():
    """Two voxels forced into one bucket: the one whose point comes last
    owns it, in both packages, whichever is the more populous; and a
    masked point claims nothing."""
    table_size = 64
    cells = np.stack(np.meshgrid(*[np.arange(-6, 6)] * 3,
                                 indexing="ij"), -1).reshape(-1, 3)
    h = tvox.hash_coords(torch.as_tensor(cells, dtype=torch.int32),
                         table_size).numpy()
    a, b = cells[h == h[0]][:2]
    rng = np.random.default_rng(0)
    in_a = (a + rng.uniform(0.1, 0.9, (5, 3))) * LEAF
    in_b = (b + rng.uniform(0.1, 0.9, (3, 3))) * LEAF
    for first, last, owner in ((in_a, in_b, b), (in_b, in_a, a)):
        pts = np.concatenate([first, last, first[:1]]).astype(np.float32)
        mask = np.ones(len(pts), bool)
        mask[-1] = False        # the highest index of all, but masked
        vj, vt = _both(pts, mask, table_size)
        for vm in (vj, vt):
            np.testing.assert_array_equal(np.asarray(vm.coords)[h[0]], owner)
            assert float(np.asarray(vm.count)[h[0]]) == len(last)
        np.testing.assert_array_equal(vt.coords.numpy(),
                                      np.asarray(vj.coords))
        np.testing.assert_array_equal(vt.count.numpy(), np.asarray(vj.count))
        # the loser's points find no voxel, the winner's do
        _, _, hit = tvox.lookup(vt, torch.as_tensor(pts))
        want = np.concatenate([np.zeros(len(first), bool),
                               np.ones(len(last), bool), [False]])
        np.testing.assert_array_equal(hit.numpy(), want)


def test_voxel_map_all_masked_is_empty():
    pts, mask = _planes_cloud(4, n=500)
    vj, vt = _both(pts, np.zeros_like(mask))
    assert float(vt.count.sum()) == 0.0
    np.testing.assert_array_equal(vt.coords.numpy(), np.asarray(vj.coords))
    assert int(vt.coords[0, 0]) == np.iinfo(np.int32).min


@pytest.mark.parametrize("fn", ["lookup", "lookup7"])
def test_lookups_match_jax(fn):
    pts, mask = _planes_cloud(5)
    vj, vt = _both(pts, mask)
    rng = np.random.default_rng(6)
    # queries: points of the cloud moved by up to a voxel, and far misses
    qry = np.concatenate([pts[:1500] + rng.uniform(-0.6, 0.6, (1500, 3)),
                          rng.uniform(50, 60, (50, 3))]).astype(np.float32)
    # the JAX functions on the port's map values, so that the comparison
    # is of the lookups alone
    vjt = jvox.GaussianVoxelMap(
        mean=jnp.asarray(vt.mean.numpy()), cov=jnp.asarray(vt.cov.numpy()),
        count=jnp.asarray(vt.count.numpy()),
        coords=jnp.asarray(vt.coords.numpy()), leaf=LEAF, table_size=TABLE)
    mj, cj, hj = getattr(jvox, fn)(vjt, jnp.asarray(qry))
    mt, ct, ht = getattr(tvox, fn)(vt, torch.as_tensor(qry))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert 0.3 < ht.float().mean() < 0.99 and not ht[-50:].any()
    hit = ht.numpy()
    np.testing.assert_array_equal(mt.numpy()[hit], np.asarray(mj)[hit])
    np.testing.assert_array_equal(ct.numpy()[hit], np.asarray(cj)[hit])
    # each value is a row of the table
    rows = {tuple(r) for r in vt.mean.numpy()[vt.count.numpy() > 0]}
    assert all(tuple(r) in rows for r in mt.numpy()[hit])


def test_lookup7_takes_the_nearest_of_seven():
    """A point just inside an empty voxel finds the neighbour's mean, which
    the single-voxel lookup misses."""
    pts = (np.asarray([[2.2, 2.2, 2.2]]) + np.random.default_rng(0).uniform(
        -0.05, 0.05, (20, 3))).astype(np.float32)
    vt = tvox.build_gaussian_voxel_map(torch.as_tensor(pts),
                                       torch.ones(20, dtype=torch.bool),
                                       LEAF, table_size=TABLE)
    q = torch.tensor([[2.55, 2.2, 2.2], [2.2, 1.95, 2.2], [3.2, 2.2, 2.2]])
    _, _, hit1 = tvox.lookup(vt, q)
    mean7, _, hit7 = tvox.lookup7(vt, q)
    assert hit1.tolist() == [False, False, False]
    assert hit7.tolist() == [True, True, False]
    np.testing.assert_allclose(mean7[:2].numpy(),
                               np.tile(pts.mean(0), (2, 1)), atol=1e-5)
    assert tvox._neighbor7("cpu").tolist() == [
        [0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
        [0, 0, -1]]
