"""The port's camera models against the JAX package's
(``frontend/camera.py``): the same seeded points through `space_to_plane`
and `lift_projective` of all four models, built by `from_config` from each
package's own CameraConfig.  Pixels within 1e-4 px (an ulp at 500 px is
3e-5), normalized coordinates within 1e-6; and each model's round trip on
the port alone with the bounds of tests/test_vision_ops.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu import config as jconfig
from mvil_fusion_tpu.frontend import camera as jcam
from mvil_fusion_torch import config as tconfig
from mvil_fusion_torch.frontend import camera as tcam
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401


MODELS = {
    "pinhole": dict(),
    "mei": dict(xi=0.8, fx=400.0, fy=400.0, cx=320.0, cy=240.0, k1=-0.1,
                k2=0.02, p1=0.0, p2=0.0),
    "equidistant": dict(fx=300.0, fy=300.0, cx=320.0, cy=240.0, k2=0.01,
                        k3=-0.002, k4=0.0005, k5=0.0),
    "scaramuzza": dict(cx=320.0, cy=240.0, aff_c=1.01, aff_d=0.002,
                       aff_e=-0.001),
}
CLASSES = {"pinhole": "PinholeRadtan", "mei": "Mei",
           "equidistant": "Equidistant", "scaramuzza": "Scaramuzza"}


def _points(model, n=200):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(1.0, 8.0, size=n)
    if model == "scaramuzza":
        # the default polynomial (a0 = -200) images the forward half space
        # within ~100 px of the centre; spread the points so that the
        # Newton solve is exercised away from it too
        pts[:, :2] *= 2.0
    return pts


def _both(model):
    kw = MODELS[model]
    return (jcam.from_config(jconfig.CameraConfig(model=model, **kw)),
            tcam.from_config(tconfig.CameraConfig(model=model, **kw)))


@pytest.mark.parametrize("model", list(MODELS))
def test_camera_matches_reference(model):
    cj, ct = _both(model)
    assert type(ct).__name__ == type(cj).__name__ == CLASSES[model]
    assert tuple(ct) == tuple(cj)
    pts = _points(model)
    uv_j = np.asarray(cj.space_to_plane(jnp.asarray(pts)))
    uv_t = ct.space_to_plane(torch.as_tensor(pts)).numpy()
    assert np.isfinite(uv_j).all() and np.ptp(uv_j, axis=0).min() > 50.0
    np.testing.assert_allclose(uv_t, uv_j, rtol=0, atol=1e-4)
    xy_j = np.asarray(cj.lift_projective(jnp.asarray(uv_j)))
    xy_t = ct.lift_projective(torch.as_tensor(uv_j)).numpy()
    np.testing.assert_allclose(xy_t, xy_j, rtol=0, atol=1e-6)
    # batched over leading dimensions
    uv3 = torch.as_tensor(uv_j).reshape(4, 50, 2)
    assert torch.equal(ct.lift_projective(uv3).reshape(-1, 2),
                       torch.as_tensor(xy_t))


@pytest.mark.parametrize("model,bound,radius", [
    ("pinhole", 1e-4, 0.5), ("mei", 2e-3, 0.4), ("equidistant", 1e-3, 2.0),
    ("scaramuzza", 1e-3, 2.0)])
def test_camera_round_trip(model, bound, radius):
    _, ct = _both(model)
    pts = _points(model)
    xy_true = pts[:, :2] / pts[:, 2:3]
    keep = np.linalg.norm(xy_true, axis=-1) < radius
    assert keep.sum() > 20
    xy = ct.lift_projective(ct.space_to_plane(torch.as_tensor(pts))).numpy()
    np.testing.assert_allclose(xy[keep], xy_true[keep], atol=bound)


def test_pixel_velocity_and_unknown_model():
    _, ct = _both("pinhole")
    cj, _ = _both("pinhole")
    vel = np.asarray([[35.6, -3.5], [0.0, 71.0]], np.float32)
    np.testing.assert_allclose(
        ct.pixel_velocity_to_normalized(torch.as_tensor(vel)).numpy(),
        np.asarray(cj.pixel_velocity_to_normalized(jnp.asarray(vel))),
        rtol=1e-7)
    with pytest.raises(NotImplementedError):
        tcam.from_config(tconfig.CameraConfig(model="fisheye9"))
