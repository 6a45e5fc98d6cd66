"""The port's pyramidal LK against the JAX package's (``ops/klt.py``).

Both get the same numpy images and points: the three inputs of
tests/test_vision_ops.py (integer shift, sub-pixel shift, flat image),
points up to 2 px from the image border, and a run at the coarsest level
alone, where the 40×30 image is smaller than the 43×43 patch and every
patch clamps at the image's edge; and one level with a motion beyond the
patch's margin, which only the re-extraction of the target patch between
the iteration halves can follow.  Tolerance: tracked points within 0.02 px
where either package says `ok`, identical `ok` masks, residuals within
0.01 grey levels.  The port samples by gather where the reference
multiplies by tent matrices; the two agree to ~2e-5 px here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import convolve2d

from mvil_fusion_tpu.ops import image as jim
from mvil_fusion_tpu.ops import klt as jklt
from mvil_fusion_torch.ops import image as tim
from mvil_fusion_torch.ops import klt as tklt
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

H, W = 240, 320


def make_texture(seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(H // 8, W // 8))
    img = np.kron(base, np.ones((8, 8)))
    return convolve2d(img, np.ones((5, 5)) / 25, mode="same",
                      boundary="symm").astype(np.float32)


def shift_image(img, dx, dy):
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    pos = np.stack([xx - dx, yy - dy], axis=-1)
    return np.array(jim.bilinear_sample(jnp.asarray(img), jnp.asarray(pos)))


IMG0 = make_texture(0)


def _points(lo, hi, n=64, seed=1):
    return np.random.default_rng(seed).uniform(lo, hi, size=(n, 2)).astype(
        np.float32)


CASES = {
    # name: (second image, points, shift)
    "integer shift": (np.roll(np.roll(IMG0, -4, axis=0), 6, axis=1),
                      _points([40, 40], [280, 200], 50), (6.0, -4.0)),
    "sub-pixel shift": (shift_image(IMG0, 2.3, -1.7),
                        _points([40, 40], [280, 200], 40), (2.3, -1.7)),
    "flat": (None, np.asarray([[100.0, 100.0], [200.0, 150.0]], np.float32),
             None),
    "near the border": (shift_image(IMG0, 5.0, 3.0),
                        _points([2, 2], [W - 2, H - 2], 96), (5.0, 3.0)),
    "fast, near the border": (shift_image(IMG0, -11.0, 8.5),
                              _points([2, 2], [W - 2, H - 2], 96),
                              (-11.0, 8.5)),
}

_jtrack = jax.jit(jklt.track, static_argnames=("win", "iters"))


def _images(name):
    img1, pts, shift = CASES[name]
    if name == "flat":
        flat = np.full((H, W), 128.0, np.float32)
        return flat, flat.copy(), pts, shift
    return IMG0, img1, pts, shift


@pytest.mark.parametrize("name", list(CASES))
def test_track_matches_reference(name):
    img0, img1, pts, shift = _images(name)
    n = len(pts)
    valid = np.ones(n, bool)
    valid[n // 2] = False
    rj = _jtrack(jim.build_pyramid(jnp.asarray(img0), 3),
                 jim.build_pyramid(jnp.asarray(img1), 3), jnp.asarray(pts),
                 jnp.asarray(valid))
    rt = tklt.track(tim.build_pyramid(torch.as_tensor(img0), 3),
                    tim.build_pyramid(torch.as_tensor(img1), 3),
                    torch.as_tensor(pts), torch.as_tensor(valid))
    ok_j, ok_t = np.asarray(rj.ok), rt.ok.numpy()
    np.testing.assert_array_equal(ok_t, ok_j)
    assert not ok_t[n // 2]
    if shift is None:
        assert not ok_t.any()
        return
    assert ok_t.sum() > 0.5 * n
    np.testing.assert_allclose(rt.pts.numpy()[ok_j], np.asarray(rj.pts)[ok_j],
                               rtol=0, atol=0.02)
    np.testing.assert_allclose(rt.err.numpy()[ok_j], np.asarray(rj.err)[ok_j],
                               rtol=0, atol=0.01)
    d = rt.pts.numpy()[ok_t] - pts[ok_t]
    np.testing.assert_allclose(np.median(d, axis=0), shift, atol=0.2)


def test_coarsest_level_smaller_than_the_patch():
    """One level of 40×30 pixels: the patch base clips to 0 and the patch's
    rows and columns beyond the image repeat its edge."""
    img0, img1, pts, _ = _images("near the border")
    p0 = jim.build_pyramid(jnp.asarray(img0), 3)[3]
    p1 = jim.build_pyramid(jnp.asarray(img1), 3)[3]
    assert p0.shape == (30, 40)
    lvl = pts / 8.0
    guess = np.zeros_like(lvl)
    dj, okj, ej = jklt._track_level(p0, p1, jnp.asarray(lvl),
                                    jnp.asarray(guess), 21, 10, 1e-4)
    dt, okt, et = tklt._track_level(
        torch.as_tensor(np.array(p0)), torch.as_tensor(np.array(p1)),
        torch.as_tensor(lvl), torch.as_tensor(guess), 21, 10, 1e-4)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.sum() > 0.5 * len(pts)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=0.02 / 8)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0, atol=0.01)


def test_target_patch_is_cut_again_between_the_iteration_halves():
    """A 13 px motion at one level leaves the first target patch's 10 px
    margin: the samples clamp at that patch's edge until the patch is cut
    again around the iterate, half way through the iterations."""
    img1 = shift_image(IMG0, 13.0, -12.0)
    pts = _points([60, 60], [W - 60, H - 60], 64, seed=5)
    guess = np.zeros_like(pts)
    dj, okj, ej = jklt._track_level(jnp.asarray(IMG0), jnp.asarray(img1),
                                    jnp.asarray(pts), jnp.asarray(guess),
                                    21, 10, 1e-4)
    dt, okt, et = tklt._track_level(
        torch.as_tensor(IMG0), torch.as_tensor(img1), torch.as_tensor(pts),
        torch.as_tensor(guess), 21, 10, 1e-4)
    moved = np.abs(np.asarray(dj)).max(axis=1) > 10.0
    assert moved.sum() > 10
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=0.02)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0, atol=0.01)


def test_extract_repeats_the_image_edge():
    img = torch.arange(12.0).reshape(3, 4)
    bx = torch.tensor([0, 2])
    by = torch.tensor([1, 0])
    p = tklt._extract(img, bx, by, 5)
    ref = jklt._extract(jnp.asarray(img.numpy()), jnp.asarray(bx.numpy()),
                        jnp.asarray(by.numpy()), 5)
    np.testing.assert_array_equal(p.numpy(), np.asarray(ref))
    assert p[1, 4, 4] == img[2, 3] and p[0, 0, 0] == img[1, 0]


def test_sample_clamps_at_the_patch_edge():
    """Samples outside the patch take its edge values, not the image's."""
    rng = np.random.default_rng(3)
    patch = torch.as_tensor(rng.uniform(0, 255, (2, 1, 7, 7)).astype(
        np.float32))
    cy = torch.tensor([[-3.0, 0.0, 2.5, 6.0, 9.0]]).repeat(2, 1)
    cx = torch.tensor([[-1.0, 0.25, 3.0, 5.75, 8.0]]).repeat(2, 1)
    out = tklt._sample(patch, cy, cx)
    Ty = np.asarray(jklt._tent(jnp.asarray(cy.numpy()), 7))
    Tx = np.asarray(jklt._tent(jnp.asarray(cx.numpy()), 7))
    ref = np.einsum("nys,nst,nxt->nyx", Ty, patch[:, 0].numpy(), Tx)
    np.testing.assert_allclose(out[:, 0].numpy(), ref, rtol=1e-6, atol=1e-4)
    assert out[0, 0, 0, 0] == patch[0, 0, 0, 0]
    assert out[1, 0, 4, 4] == patch[1, 0, 6, 6]
