"""The port's image ops against the JAX package's (``ops/image.py``) on the
same seeded numpy images.

Tolerances.  CLAHE: the per-pixel bins and the per-tile histograms are
integers and must be equal; the LUTs differ by the order of the cumulative
sum (XLA scans in a tree, PyTorch in sequence) and are held to 1e-3 grey
levels, as is the equalized image.  The JAX CLAHE builds an H×W×256
indicator, so the images stay at 160×120.  The pyramid's four-term mean
is held to 1e-5 + 3e-7 relative (on a cropped image XLA sums the four
terms in another order, an ulp per level) and the bilinear samples to
2e-5, one ulp of a grey level above 128; the Sobel taps are exact in
fp32: within 1e-5.  The Scharr weights (3/32, 10/32) round in every
product, and XLA contracts the products into its sums: within 5e-5
(3 ulp of a gradient of 100 grey levels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import convolve2d

from mvil_fusion_tpu.ops import image as jim
from mvil_fusion_torch.ops import image as tim
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401


def texture(seed, H=120, W=160, lo=0.0, hi=255.0):
    """Smooth random texture with strong gradients, grey levels lo..hi."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(lo, hi, size=(H // 8, W // 8))
    img = np.kron(base, np.ones((8, 8)))
    return convolve2d(img, np.ones((5, 5)) / 25, mode="same",
                      boundary="symm").astype(np.float32)


def dots(seed, H=120, W=160):
    """Bright Gaussian dots on a flat background, some pixels clipped at
    255 and some below 0 and above 255 before the bin truncation."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.full((H, W), 24.0)
    for _ in range(40):
        u, v = rng.uniform(0, W), rng.uniform(0, H)
        img += rng.uniform(100, 300) * np.exp(
            -((xx - u) ** 2 + (yy - v) ** 2) / (2 * 1.8 ** 2))
    img[:3] = -5.0
    return img.astype(np.float32)


IMAGES = {"texture": texture(0), "low contrast": texture(1, lo=100, hi=140),
          "dots": dots(2), "odd size": texture(3, 104, 136)[:101, :131]}

_jclahe = jax.jit(jim.clahe)


def _jax_clahe_parts(img, tiles=(8, 8), n_bins=256, clip_limit=3.0):
    """The reference's bins, histograms and LUTs, by its own lines."""
    H, W = img.shape
    ty, tx = tiles
    th, tw = H // ty, W // tx
    pix = jnp.clip(img, 0, n_bins - 1).astype(jnp.int32)
    onehot = pix[..., None] == jnp.arange(n_bins)
    t = onehot[: ty * th, : tx * tw].astype(jnp.bfloat16)
    t = t.reshape(ty, th, tx, tw, n_bins)
    hists = jnp.einsum("ahbwc->abc", t, preferred_element_type=jnp.float32)
    hists = hists.reshape(ty * tx, n_bins)
    clip = jnp.maximum(clip_limit * th * tw / n_bins, 1.0)
    clipped = jnp.minimum(hists, clip)
    excess = jnp.sum(hists - clipped, axis=1, keepdims=True)
    clipped = clipped + excess / n_bins
    cdf = jnp.cumsum(clipped, axis=1)
    cdf_min = cdf[:, :1]
    denom = jnp.maximum(th * tw - cdf_min, 1.0)
    luts = (cdf - cdf_min) / denom * (n_bins - 1)
    return pix, hists, luts.reshape(ty, tx, n_bins)


@pytest.mark.parametrize("name", list(IMAGES))
def test_clahe_histograms_and_bins_equal_luts_close(name):
    img = IMAGES[name]
    pj, hj, lj = _jax_clahe_parts(jnp.asarray(img))
    pt, ht, lt = tim.clahe_luts(torch.as_tensor(img))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert ht.sum() == (img.shape[0] // 8 * 8) * (img.shape[1] // 8 * 8)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", list(IMAGES))
def test_clahe_matches_reference(name):
    img = IMAGES[name]
    out = tim.clahe(torch.as_tensor(img)).numpy()
    ref = np.asarray(_jclahe(jnp.asarray(img)))
    assert out.shape == img.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    assert out.min() >= 0.0 and out.max() <= 255.0


def test_clahe_improves_contrast():
    img = IMAGES["low contrast"]
    out = tim.clahe(torch.as_tensor(img)).numpy()
    assert out.std() > 1.5 * img.std()


@pytest.mark.parametrize("name", list(IMAGES))
def test_pyramid_matches_reference(name):
    img = IMAGES[name]
    pj = jim.build_pyramid(jnp.asarray(img), 3)
    pt = tim.build_pyramid(torch.as_tensor(img), 3)
    assert len(pt) == len(pj) == 4
    for a, b in zip(pt, pj):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-7,
                                   atol=1e-5)


@pytest.mark.parametrize("name,atol", [("sobel_gradients", 1e-5),
                                       ("scharr_gradients", 5e-5)])
@pytest.mark.parametrize("image", ["texture", "dots"])
def test_gradients_match_reference(name, atol, image):
    img = IMAGES[image]
    gj = getattr(jim, name)(jnp.asarray(img))
    gt = getattr(tim, name)(torch.as_tensor(img))
    for a, b in zip(gt, gj):
        assert np.abs(np.asarray(b)).max() > 10.0
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol)


def test_bilinear_sample_matches_reference_and_clamps():
    img = IMAGES["texture"]
    rng = np.random.default_rng(5)
    xy = rng.uniform(-6.0, 170.0, size=(7, 40, 2)).astype(np.float32)
    xy[0, 0] = (0.0, 0.0)
    xy[0, 1] = (159.0, 119.0)
    out = tim.bilinear_sample(torch.as_tensor(img), torch.as_tensor(xy))
    ref = jim.bilinear_sample(jnp.asarray(img), jnp.asarray(xy))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)
    assert out[0, 0] == img[0, 0]
