"""The port's LiDAR-aided feature depth
(``mvil_fusion_torch/frontend/depth_register.py``): the two tests of
tests/test_depth_register.py on the port, and ``_register_depth`` against
the JAX package's on the same ring (tests/test_depth_register.py's scene:
20,000 rays cast in the box room, chunked over three slots of 8192
points, and 256 forward features).

Tolerances, set from measurement: where both packages give a depth, the
depths agree within 1e-4 m (measured 9.5e-7: the same three neighbours,
their ranges rounded apart); the valid masks differ in at most 1 % of the
features (measured 0): a feature flips only where its third neighbour's
cosine sits within an fp32 rounding of the 1.5° gate, or the neighbours'
spread or mean within one of 2 m or 3 m.  Ties among equally near cloud
points keep the lower index, as ``jax.lax.top_k`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu.config import SystemConfig as JSystemConfig
from mvil_fusion_tpu.frontend import depth_register as jdr
from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.frontend import depth_register as tdr
from mvil_fusion_torch.io.synthetic_lidar import BoxWorld
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

CPU = "cpu"


def box_scene(rng, n_rays=20000, n_feat=64):
    """tests/test_depth_register.py's scene: a world cloud from rays cast
    at the origin, and forward features with their true ranges."""
    box = BoxWorld()
    p_wc = np.zeros(3)
    dirs = rng.normal(size=(n_rays, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = box.ray_range(p_wc, dirs)
    cloud = (dirs * r[:, None])[r < 60]
    fd = rng.normal(size=(n_feat, 3))
    fd[:, 2] = np.abs(fd[:, 2]) + 1.0
    fd /= np.linalg.norm(fd, axis=1, keepdims=True)
    fr = box.ray_range(p_wc, fd)
    pts = fd * fr[:, None]
    norm = (pts[:, :2] / pts[:, 2:3]).astype(np.float32)
    return cloud, norm, fr


def test_depth_register_recovers_feature_depth(rng):
    reg = tdr.DepthRegister(SystemConfig(), device=CPU)
    p_wc, q_wc = np.zeros(3), np.asarray([1.0, 0, 0, 0])
    cloud, norm, fr = box_scene(rng)
    reg.add_cloud(0.0, cloud)
    depth = reg.get_depth(0.05, norm, np.ones(len(norm), bool), p_wc, q_wc)
    got = depth > 0
    assert got.sum() > 30, got.sum()
    # registered depth (range) matches the true ray range
    err = np.abs(depth[got] - fr[got])
    assert np.median(err) < 0.2, np.median(err)
    # depths below the 3 m gate are rejected
    near = fr < 3.0
    if near.any():
        assert (depth[near] < 0).all()


def test_depth_register_empty_and_expiry(rng):
    reg = tdr.DepthRegister(SystemConfig(), window_sec=1.0, device=CPU)
    norm = rng.normal(size=(8, 2)).astype(np.float32) * 0.1
    d = reg.get_depth(0.0, norm, np.ones(8, bool), np.zeros(3),
                      np.asarray([1.0, 0, 0, 0]))
    assert (d < 0).all()
    reg.add_cloud(0.0, rng.uniform(3, 10, size=(100, 3)).astype(np.float32))
    reg.add_cloud(5.0, rng.uniform(3, 10, size=(100, 3)).astype(np.float32))
    assert len(reg.clouds) == 1  # old cloud expired


@pytest.mark.parametrize("pose", ["origin", "moved"])
def test_register_depth_matches_reference(pose):
    rng = np.random.default_rng(3)
    cloud, norm, _ = box_scene(rng, n_feat=256)
    if pose == "origin":
        p_wc, q_wc = np.zeros(3), np.asarray([1.0, 0, 0, 0])
    else:   # the camera 0.3 m off the rays' origin, turned by 0.2 rad
        p_wc = np.asarray([0.3, -0.2, 0.1])
        q_wc = np.asarray([np.cos(0.1), 0.0, np.sin(0.1), 0.0])
    valid = rng.uniform(size=len(norm)) > 0.1
    jreg = jdr.DepthRegister(JSystemConfig())
    treg = tdr.DepthRegister(SystemConfig(), device=CPU)
    for reg in (jreg, treg):
        reg.add_cloud(0.0, cloud)
        reg.add_cloud(0.1, cloud[::3] + 0.01)
    assert len(treg.clouds) == len(jreg.clouds) == 4
    bj, mj, sj = jreg._snap
    bt, mt, st_, _ = treg._snap
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(st_, sj)
    dj = jreg.get_depth(0.15, norm, valid, p_wc, q_wc)
    dt = treg.get_depth(0.15, norm, valid, p_wc, q_wc)
    okj, okt = dj > 0, dt > 0
    assert okj.sum() > 100
    assert (okj != okt).mean() <= 0.01
    both = okj & okt
    np.testing.assert_allclose(dt[both], dj[both], rtol=0, atol=1e-4)


def test_top3_keeps_the_lower_index_on_ties():
    sim = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9, 0.9],
                        [-2.0, -2.0, -2.0, -2.0, 0.3, -2.0]])
    vals, idx = tdr._top3_lower_first(sim)
    assert idx.tolist() == [[1, 2, 4], [4, 0, 1]]
    assert vals.tolist() == [[pytest.approx(0.9)] * 3, [pytest.approx(0.3),
                                                        -2.0, -2.0]]
    _, ji = jax.lax.top_k(jnp.asarray(sim.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
