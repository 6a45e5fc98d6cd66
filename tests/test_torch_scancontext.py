"""The port's ScanContext descriptors and loop search against the JAX
package's (``ops/scancontext.py``), on seeded numpy clouds, on the CPU.

Tolerances: `make_descriptor` exact (a max of the inputs' own z values);
`ring_key` within 1e-6; `sc_distance` within 1e-5 with the same shift;
`detect_loop` the same finite candidates in the same order, their
distances within 1e-5 and the same shifts, infinite distance at the same
slots (the indices at masked slots are left free: they tie at infinity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu.io.synthetic_lidar import BoxWorld
from mvil_fusion_tpu.ops import scancontext as jsc
from mvil_fusion_torch.ops import scancontext as tsc

_jdesc = jax.jit(jsc.make_descriptor,
                 static_argnames=("n_ring", "n_sector", "max_radius"))
_jdist = jax.jit(jsc.sc_distance)
_jdetect = jax.jit(jsc.detect_loop, static_argnames=("n_candidates",))


def room_cloud(rng, n=4000):
    """Asymmetric structured cloud (box walls + interior boxes)."""
    box = BoxWorld()
    dirs = rng.normal(size=(n, 3))
    dirs[:, 2] *= 0.3
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = box.ray_range(np.zeros(3), dirs)
    return (dirs * r[:, None]).astype(np.float32)


def _rot_z(ang):
    return np.asarray([[np.cos(ang), -np.sin(ang), 0],
                       [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)


def _desc_both(pts, mask=None, **kw):
    mask = np.ones(len(pts), bool) if mask is None else mask
    dj = np.array(_jdesc(jnp.asarray(pts), jnp.asarray(mask), **kw))
    dt = tsc.make_descriptor(torch.as_tensor(pts), torch.as_tensor(mask),
                             **kw)
    return dj, dt


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {}), (2, dict(n_ring=8, n_sector=24, max_radius=9.0))])
def test_descriptor_and_ring_key_match_jax(seed, kw):
    rng = np.random.default_rng(seed)
    pts = room_cloud(rng)
    mask = rng.uniform(size=len(pts)) > 0.2
    dj, dt = _desc_both(pts, mask, **kw)
    np.testing.assert_array_equal(dt.numpy(), dj)
    assert (dt != 0).float().mean() > 0.05
    np.testing.assert_allclose(tsc.ring_key(dt).numpy(),
                               np.asarray(jsc.ring_key(jnp.asarray(dj))),
                               rtol=0, atol=1e-6)
    if kw:      # points beyond max_radius and masked points leave no trace
        far = np.linalg.norm(pts[:, :2], axis=1) >= kw["max_radius"]
        assert far.any()
        _, dt_near = _desc_both(pts[~far & mask], **kw)
        np.testing.assert_array_equal(dt.numpy(), dt_near.numpy())


def test_descriptor_of_nothing_is_zero():
    pts = room_cloud(np.random.default_rng(0), n=100)
    dj, dt = _desc_both(pts, np.zeros(100, bool))
    assert not dt.any() and not dj.any()


def test_sc_descriptor_rotation_shift():
    """A cloud turned by 90° about z shifts its descriptor by S/4 sectors;
    distance, shift and ring keys as JAX gives them."""
    pts = room_cloud(np.random.default_rng(0))
    (d0j, d0), (d1j, d1) = _desc_both(pts), _desc_both(
        pts @ _rot_z(np.pi / 2).T)
    dist, shift = tsc.sc_distance(d0, d1)
    dist_j, shift_j = _jdist(jnp.asarray(d0j), jnp.asarray(d1j))
    assert abs(float(dist) - float(dist_j)) < 1e-5
    assert int(shift) == int(shift_j)
    assert float(dist) < 0.05
    assert int(shift) in (14, 15, 16, 44, 45, 46)
    np.testing.assert_allclose(tsc.ring_key(d0).numpy(),
                               tsc.ring_key(d1).numpy(), atol=0.3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sc_distance_matches_jax(seed):
    """Unrelated places, and descriptors with empty columns on either
    side; one call over a batch equals the calls one by one."""
    rng = np.random.default_rng(seed)
    d1 = _desc_both(room_cloud(rng, 1500))[1]
    others = []
    for k in range(3):
        pts = room_cloud(rng, 1500) + np.asarray([4.0 * k, -3.0, 0.0],
                                                 np.float32)
        d = _desc_both(pts)[1]
        d[:, 10 * k:10 * k + 7] = 0.0           # empty columns
        others.append(d)
    batch = tsc.sc_distance(d1, torch.stack(others))
    for k, d2 in enumerate(others):
        dist, shift = tsc.sc_distance(d1, d2)
        dist_j, shift_j = _jdist(jnp.asarray(d1.numpy()),
                                 jnp.asarray(d2.numpy()))
        assert abs(float(dist) - float(dist_j)) < 1e-5
        assert int(shift) == int(shift_j)
        assert float(batch[0][k]) == float(dist)
        assert int(batch[1][k]) == int(shift)


def _database(n_slots=64):
    """24 other places and the query's own place, turned, at slot 17."""
    pts = room_cloud(np.random.default_rng(0))
    db = np.zeros((n_slots, 20, 60), np.float32)
    mask = np.zeros(n_slots, bool)
    for k in range(24):
        other = room_cloud(np.random.default_rng(100 + k)) + \
            np.asarray([6.0, -4.0, 0.0], np.float32) * (1 + k % 3)
        db[k] = _desc_both(other)[0]
        mask[k] = True
    db[17] = _desc_both(pts @ _rot_z(0.6).T)[0]
    keys = db.mean(axis=-1)
    return _desc_both(pts)[0], db, keys, mask


@pytest.mark.parametrize("n_live,n_candidates", [(25, 10), (6, 10), (0, 4)])
def test_detect_loop_matches_jax(n_live, n_candidates):
    """The same-place case of tests/test_global_mapping.py, then with
    fewer live entries than candidates (the rest tie at infinity), then
    with none."""
    q_desc, db, keys, mask = _database()
    live = np.nonzero(mask)[0]
    keep = live[np.argsort(np.abs(live - 17), kind="stable")][:n_live]
    mask = np.zeros_like(mask)
    mask[keep] = True
    q_key = q_desc.mean(axis=-1)
    cj = _jdetect(jnp.asarray(q_desc), jnp.asarray(q_key), jnp.asarray(db),
                  jnp.asarray(keys), jnp.asarray(mask),
                  n_candidates=n_candidates)
    ct = tsc.detect_loop(*[torch.as_tensor(a) for a in
                           (q_desc, q_key, db, keys, mask)],
                         n_candidates=n_candidates)
    fin = np.isfinite(np.asarray(cj.dist))
    assert fin.sum() == min(n_live, n_candidates)
    np.testing.assert_array_equal(np.isfinite(ct.dist.numpy()), fin)
    np.testing.assert_array_equal(ct.idx.numpy()[fin],
                                  np.asarray(cj.idx)[fin])
    np.testing.assert_array_equal(ct.shift.numpy()[fin],
                                  np.asarray(cj.shift)[fin])
    np.testing.assert_allclose(ct.dist.numpy()[fin],
                               np.asarray(cj.dist)[fin], rtol=0, atol=1e-5)
    if n_live:
        best = int(np.argmin(ct.dist.numpy()))
        assert int(ct.idx[best]) == 17
        assert float(ct.dist[best]) < 0.15


def test_detect_loop_takes_lower_index_among_equal_keys():
    """Equal ring keys: the lower index comes first, as lax.top_k orders
    them."""
    q_desc, db, keys, mask = _database(n_slots=32)
    db[20:26] = db[3]
    keys[20:26] = keys[3]
    mask[20:26] = True
    args = (q_desc, keys[3], db, keys, mask)
    cj = _jdetect(*[jnp.asarray(a) for a in args], n_candidates=4)
    ct = tsc.detect_loop(*[torch.as_tensor(a) for a in args],
                         n_candidates=4)
    assert ct.idx.tolist() == [3, 20, 21, 22] == np.asarray(cj.idx).tolist()
