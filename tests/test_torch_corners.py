"""The port's Shi-Tomasi detector against the JAX package's
(``ops/corners.py``) on the inputs of tests/test_vision_ops.py (a smooth
texture, white squares) and on images made of ties: a flat image, and a
pattern repeated in every cell so that cells tie in score.

Tolerance: the response within 1e-4 relative to its maximum; the winning
cells, points and `ok` flags identical, with features already present and
without; scores within 1e-6 relative.  A tie goes to the row-major first
pixel of a cell and to the lower cell in the top-k, as in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import convolve2d

from mvil_fusion_tpu.ops import corners as jcor
from mvil_fusion_torch.ops import corners as tcor
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

H, W = 240, 320


def make_texture(seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(H // 8, W // 8))
    img = np.kron(base, np.ones((8, 8)))
    return convolve2d(img, np.ones((5, 5)) / 25, mode="same",
                      boundary="symm").astype(np.float32)


def squares():
    img = np.zeros((H, W), np.float32)
    for (y, x) in [(60, 80), (60, 200), (150, 80), (150, 200), (100, 140)]:
        img[y:y + 30, x:x + 30] = 200.0
    return img


def tiled():
    """The same two blobs in every 20×20 cell: equal cell scores, and two
    equal maxima within a cell."""
    cell = np.zeros((20, 20), np.float32)
    cell[4:8, 4:8] = 180.0
    cell[12:16, 12:16] = 180.0
    return np.tile(cell, (H // 20, W // 20))


IMAGES = {"texture": make_texture(0), "squares": squares(),
          "flat": np.full((H, W), 7.0, np.float32), "tiled": tiled()}

_jdetect = jax.jit(jcor.detect,
                   static_argnames=("max_new", "min_dist", "quality",
                                    "border"))


def _compare(img, existing, valid, max_new, min_dist):
    dj = _jdetect(jnp.asarray(img), jnp.asarray(existing), jnp.asarray(valid),
                  max_new=max_new, min_dist=min_dist)
    dt = tcor.detect(torch.as_tensor(img), torch.as_tensor(existing),
                     torch.as_tensor(valid), max_new=max_new,
                     min_dist=min_dist)
    np.testing.assert_array_equal(dt.ok.numpy(), np.asarray(dj.ok))
    np.testing.assert_array_equal(dt.pts.numpy(), np.asarray(dj.pts))
    np.testing.assert_allclose(dt.score.numpy(), np.asarray(dj.score),
                               rtol=1e-6)
    return dt


@pytest.mark.parametrize("name", list(IMAGES))
def test_response_matches_reference(name):
    img = IMAGES[name]
    rj = np.asarray(jcor.shi_tomasi_response(jnp.asarray(img)))
    rt = tcor.shi_tomasi_response(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=0,
                               atol=1e-4 * max(rj.max(), 1.0))


@pytest.mark.parametrize("name,min_dist,max_new", [
    ("texture", 20, 60), ("texture", 30, 50), ("squares", 15, 40),
    ("flat", 30, 20), ("tiled", 20, 100), ("tiled", 30, 40)])
def test_detect_matches_reference(name, min_dist, max_new):
    img = IMAGES[name]
    none = np.zeros((0, 2), np.float32), np.zeros((0,), bool)
    first = _compare(img, *none, max_new, min_dist)
    pts = first.pts.numpy()[first.ok.numpy()]
    if name == "flat":
        assert len(pts) == 0
        return
    assert len(pts) >= 9
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    np.fill_diagonal(d, 1e9)
    assert d.min() >= min_dist
    # a second pass around half of the first's corners, some of them
    # invalid, one outside the image
    n = max_new // 2
    existing = first.pts.numpy()[:n].copy()
    valid = first.ok.numpy()[:n].copy()
    valid[::3] = False
    existing[1] = (-40.0, 1e4)
    second = _compare(img, existing, valid, max_new, min_dist)
    p2 = second.pts.numpy()[second.ok.numpy()]
    kept = existing[valid][2:]
    if len(p2) and len(kept):
        assert np.linalg.norm(p2[:, None] - kept[None, :],
                              axis=-1).min() >= min_dist


def test_ties_go_to_the_first_pixel_and_the_lower_cell():
    img, md = IMAGES["tiled"], 20
    det = tcor.detect(torch.as_tensor(img), torch.zeros((0, 2)),
                      torch.zeros((0,), dtype=torch.bool), max_new=100,
                      min_dist=md)
    ok = det.ok.numpy()
    pts, score = det.pts.numpy()[ok].astype(int), det.score.numpy()[ok]
    assert len(pts) > 50
    # equal scores are listed in the order of their cells
    flat = pts[:, 1] * W + pts[:, 0]
    for s in np.unique(score):
        assert (np.diff(flat[score == s]) > 0).all()
    # within a cell the row-major first of the equal maxima wins
    resp = tcor.shi_tomasi_response(torch.as_tensor(img)).numpy()
    resp[:10] = resp[-10:] = -1.0
    resp[:, :10] = resp[:, -10:] = -1.0
    tied = 0
    for (x, y), sc in zip(pts, score):
        cy, cx = y // md * md, x // md * md
        block = resp[cy:cy + md, cx:cx + md]
        first = np.unravel_index(np.argmax(block), block.shape)
        assert (y - cy, x - cx) == first and block.max() == sc
        tied += (block == block.max()).sum() > 1
    assert tied > 20
