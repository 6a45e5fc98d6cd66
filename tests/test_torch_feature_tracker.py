"""The port's FeatureTracker against the JAX package's
(``frontend/feature_tracker.py``).

Step after hand-over: the JAX tracker runs k images, its state goes across
through `load_reference_state`, and both take the next image.  The RANSAC
hypotheses of that step are drawn as the JAX tracker draws them (its key
chain split once, `jax.random.choice` over the slots its KLT accepted) and
handed to the port.  Tolerance: valid masks, ids, track counts and the id
counter equal; pixels within 0.05 px, normalized coordinates within 0.05 /
fx, velocities within 0.05 / (fx·dt).  Comparing one step, not two
trajectories, keeps a flipped threshold from growing into a different
track table.

Then the five scenarios of tests/test_feature_tracker.py on the port
alone, at the same small size (320×240, 2 levels, 128 slots, CLAHE off),
the reset and the publish gate against the reference's host logic, and the
default device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import convolve2d

from mvil_fusion_tpu import config as jconfig
from mvil_fusion_tpu.frontend.feature_tracker import \
    FeatureTracker as JaxTracker
from mvil_fusion_tpu.ops import image as jim
from mvil_fusion_tpu.ops import klt as jklt
from mvil_fusion_torch import config as tconfig
from mvil_fusion_torch.frontend.feature_tracker import FeatureTracker
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

H, W = 240, 320
CAMERA = dict(width=W, height=H, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
              k1=0, k2=0, p1=0, p2=0)


def make_cfg(module, camera=CAMERA, **tk):
    base = dict(max_cnt=80, min_dist=16, freq=0, equalize=False,
                pyramid_levels=2, max_iters=8, ransac_iters=64,
                max_features_pad=128)
    base.update(tk)
    return module.SystemConfig(camera=module.CameraConfig(**camera),
                               tracker=module.TrackerConfig(**base))


def texture(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(h // 8, w // 8))
    img = np.kron(base, np.ones((8, 8)))
    return convolve2d(img, np.ones((5, 5)) / 25, mode="same",
                      boundary="symm").astype(np.float32)


def shift_img(img, dx, dy):
    h, w = img.shape
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    pos = np.stack([xx - dx, yy - dy], axis=-1)
    return np.array(jim.bilinear_sample(jnp.asarray(img), jnp.asarray(pos)))


def reference_state(jt):
    """The JAX tracker's state as numpy arrays and host values."""
    return dict(
        pts=np.asarray(jt.pts), valid=np.asarray(jt.valid),
        track_cnt=np.asarray(jt.track_cnt), norm=np.asarray(jt.norm),
        ids=np.asarray(jt.ids), next_id=np.asarray(jt.next_id),
        prev_pyr=None if jt.prev_pyr is None else [np.asarray(p)
                                                   for p in jt.prev_pyr],
        prev_t=jt.prev_t, first_image_time=jt.first_image_time,
        pub_count=jt.pub_count)


def next_hypotheses(jt, img):
    """The sample indices the JAX tracker will draw on its next image."""
    tk = jt.cfg.tracker
    _, sub = jax.random.split(jt._key)
    x = jnp.asarray(img, jnp.float32)
    if tk.equalize:
        x = jim.clahe(x)
    pyr = tuple(jim.build_pyramid(x, tk.pyramid_levels))
    res = jklt.track(jt.prev_pyr, pyr, jt.pts, jt.valid, win=tk.window_size,
                     iters=tk.max_iters, min_eig_thr=tk.min_eig_threshold)
    p = res.ok.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    return np.array(jax.random.choice(sub, jt.N, shape=(tk.ransac_iters, 8),
                                      replace=True, p=p))


def assert_frames_agree(ft, fj, fx, dt):
    np.testing.assert_array_equal(ft.valid, fj.valid)
    np.testing.assert_array_equal(ft.ids, fj.ids)
    np.testing.assert_array_equal(ft.track_cnt, fj.track_cnt)
    v = fj.valid
    np.testing.assert_allclose(ft.uv[v], fj.uv[v], rtol=0, atol=0.05)
    np.testing.assert_allclose(ft.norm[v], fj.norm[v], rtol=0,
                               atol=0.05 / fx)
    np.testing.assert_allclose(ft.vel[v], fj.vel[v], rtol=0,
                               atol=0.05 / (fx * dt))
    np.testing.assert_array_equal(ft.depth, fj.depth)
    assert ft.ids.dtype == fj.ids.dtype and ft.t == fj.t


HANDOVER = {
    # name: (tracker overrides, camera, shifts of the images after the first)
    "plain": (dict(), CAMERA, [(3.0, -2.0), (5.0, -1.0), (6.5, 1.5)]),
    "distorted camera, 3 levels": (
        dict(pyramid_levels=3, max_iters=10),
        dict(CAMERA, k1=-0.29, k2=0.075, p1=2.8e-4, p2=-2.7e-4),
        [(-4.0, 2.5), (-9.0, 6.0), (-12.5, 9.0)]),
    "clahe at 160x120": (
        dict(equalize=True, max_cnt=40, min_dist=12, max_features_pad=64,
             pyramid_levels=1),
        dict(CAMERA, width=160, height=120, cx=80.0, cy=60.0),
        [(1.5, -1.0), (3.0, -2.5), (4.0, -2.0)]),
}


@pytest.mark.parametrize("name", list(HANDOVER))
def test_step_after_handover_matches_reference(name):
    tk, camera, shifts = HANDOVER[name]
    jt = JaxTracker(make_cfg(jconfig, camera, **tk))
    tt = FeatureTracker(make_cfg(tconfig, camera, **tk), device="cpu")
    img0 = texture(0, camera["height"], camera["width"])
    imgs = [img0] + [shift_img(img0, *s) for s in shifts]
    for k, img in enumerate(imgs[:-1]):
        assert jt.process(0.1 * k, img) is not None
    tt.load_reference_state(reference_state(jt))
    idx = next_hypotheses(jt, imgs[-1])
    tt.hypothesis_source = lambda ok: idx
    t = 0.1 * (len(imgs) - 1)
    fj = jt.process(t, imgs[-1])
    ft = tt.process(t, imgs[-1])
    assert fj.valid.sum() >= 0.5 * jt.cfg.tracker.max_cnt
    assert (fj.track_cnt[fj.valid] > 1).sum() > 10
    assert_frames_agree(ft, fj, camera["fx"], 0.1)
    assert int(tt.next_id) == int(jt.next_id)
    assert tt.prev_t == jt.prev_t and tt.pub_count == jt.pub_count
    for a, b in zip(tt.prev_pyr, jt.prev_pyr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-7,
                                   atol=1e-3)


def test_min_distance_mask_follows_suppression_chains():
    """Three tracks in a row, 10 px apart at min_dist 16, the longest
    first: the middle one falls to the first, and the last one stays
    because what would have suppressed it is gone.  One round of the
    parallel mask would drop it; the fixed point keeps it, as the
    reference's does."""
    jt = JaxTracker(make_cfg(jconfig))
    tt = FeatureTracker(make_cfg(tconfig), device="cpu")
    img0 = texture(0)
    imgs = [img0, shift_img(img0, 2.0, 1.0), shift_img(img0, 4.0, 2.0)]
    for k, img in enumerate(imgs[:2]):
        jt.process(0.1 * k, img)
    pts, cnt = np.array(jt.pts), np.array(jt.track_cnt)
    valid = np.asarray(jt.valid)
    inner = valid & (np.abs(pts - [160, 120]).max(axis=1) < 60)
    a, b, c = np.nonzero(inner)[0][:3]
    pts[b], pts[c] = pts[a] + (10.0, 0.0), pts[a] + (20.0, 0.0)
    cnt[a], cnt[b], cnt[c] = 9, 5, 2
    # no other track near the three
    far = np.linalg.norm(pts - pts[b], axis=1) > 40
    far[[a, b, c]] = True
    jt.pts, jt.track_cnt = jnp.asarray(pts), jnp.asarray(cnt)
    jt.valid = jnp.asarray(valid & far)
    jt.norm = jnp.asarray((pts - [160.0, 120.0]) / 200.0, jnp.float32)
    tt.load_reference_state(reference_state(jt))
    idx = next_hypotheses(jt, imgs[2])
    tt.hypothesis_source = lambda ok: idx
    fj, ft = jt.process(0.2, imgs[2]), tt.process(0.2, imgs[2])
    assert_frames_agree(ft, fj, 200.0, 0.1)
    assert ft.valid[a] and ft.track_cnt[a] == 10
    assert ft.valid[c] and ft.track_cnt[c] == 3
    # the middle slot lost its track (a new corner may have taken the slot)
    assert not ft.valid[b] or ft.track_cnt[b] == 1


@pytest.mark.parametrize("n_tracks,culls", [(11, False), (12, True)])
def test_ransac_needs_twelve_tracks(n_tracks, culls):
    """Four tracks whose previous normalized positions are off by 10 to
    30 px: RANSAC culls among them when 12 tracks came through KLT, and
    does not run on 11 (the count is a device value: the port computes
    RANSAC always and selects).  Four, because the flow of a shifted
    image is a homography, and the family of F that fits one absorbs up
    to three outliers.  Which of the four fall is decided among tied
    hypotheses by rounding, so the two packages are held to the same
    decision to cull, not to the same slots."""
    jt = JaxTracker(make_cfg(jconfig))
    tt = FeatureTracker(make_cfg(tconfig), device="cpu")
    img0 = texture(0)
    imgs = [img0, shift_img(img0, 2.0, 1.0), shift_img(img0, 4.0, 2.0)]
    for k, img in enumerate(imgs[:2]):
        jt.process(0.1 * k, img)
    pts, valid = np.asarray(jt.pts), np.asarray(jt.valid)
    inner = valid & (np.abs(pts - [160, 120]).max(axis=1) < 90)
    keep = np.nonzero(inner)[0][:n_tracks]
    only = np.zeros_like(valid)
    only[keep] = True
    norm = np.array(jt.norm)
    norm[keep[[1, 3, 6, 8]]] += [(0.0, 0.1), (0.15, 0.0), (-0.05, 0.1),
                                 (0.1, -0.12)]
    jt.valid, jt.norm = jnp.asarray(only), jnp.asarray(norm)
    tt.load_reference_state(reference_state(jt))
    idx = next_hypotheses(jt, imgs[2])
    tt.hypothesis_source = lambda ok: idx
    for f in (jt.process(0.2, imgs[2]), tt.process(0.2, imgs[2])):
        tracked = f.valid & (f.track_cnt > 1)
        assert not tracked[~only].any()
        if culls:
            assert 8 <= tracked.sum() < n_tracks
        else:
            assert tracked.sum() == n_tracks


def test_first_image_matches_reference():
    """No previous image: no tracking, no RANSAC, detection fills the
    table; ids start at 0 in slot order."""
    jt = JaxTracker(make_cfg(jconfig))
    tt = FeatureTracker(make_cfg(tconfig), device="cpu")
    img = texture(0)
    fj, ft = jt.process(0.0, img), tt.process(0.0, img)
    assert_frames_agree(ft, fj, 200.0, 1.0)
    assert (ft.vel == 0).all() and (ft.track_cnt[ft.valid] == 1).all()
    n = int(ft.valid.sum())
    np.testing.assert_array_equal(np.sort(ft.ids[ft.valid]), np.arange(n))


def test_handover_rejects_wrong_shapes():
    tt = FeatureTracker(make_cfg(tconfig), device="cpu")
    state = reference_state(JaxTracker(make_cfg(jconfig)))
    tt.load_reference_state(state)
    assert tt.prev_pyr is None and tt.prev_t is None
    with pytest.raises(ValueError, match="pts"):
        tt.load_reference_state(dict(state, pts=np.zeros((5, 2))))
    with pytest.raises(ValueError, match="prev_pyr"):
        tt.load_reference_state(dict(state, prev_pyr=[np.zeros((H, W))]))


# ---------------------------------------------------------------------------
# the scenarios of tests/test_feature_tracker.py, on the port alone
# ---------------------------------------------------------------------------

def make_tracker(**tk):
    return FeatureTracker(make_cfg(tconfig, **tk), device="cpu")


def test_tracker_initializes_and_tracks():
    tr = make_tracker()
    img0 = texture(0)
    f0 = tr.process(0.0, img0)
    assert f0 is not None
    n0 = int(f0.valid.sum())
    assert 40 <= n0 <= tr.cfg.tracker.max_cnt

    f1 = tr.process(0.1, shift_img(img0, 3.0, -2.0))
    survived = (f1.track_cnt > 1) & f1.valid
    assert survived.sum() > 0.7 * n0
    # ids stable for survivors, positions shifted by (3,-2)
    common = np.intersect1d(f0.ids[f0.valid], f1.ids[survived])
    assert len(common) > 0.6 * n0
    d = np.asarray([f1.uv[f1.ids == i][0] - f0.uv[f0.ids == i][0]
                    for i in common[:30]])
    np.testing.assert_allclose(d.mean(axis=0), [3.0, -2.0], atol=0.3)


def test_tracker_velocity():
    tr = make_tracker()
    img0 = texture(0)
    tr.process(0.0, img0)
    f1 = tr.process(0.1, shift_img(img0, 2.0, 0.0))
    sur = f1.valid & (f1.track_cnt > 1)
    # dx=2px over 0.1s at fx=200 → normalized vx ≈ 0.1
    np.testing.assert_allclose(f1.vel[sur, 0].mean(), 0.1, atol=0.02)
    assert (f1.vel[f1.valid & (f1.track_cnt == 1)] == 0).all()


def test_tracker_restart_on_gap():
    tr = make_tracker()
    img0 = texture(0)
    f0 = tr.process(0.0, img0)
    f1 = tr.process(5.0, img0)  # 5 s gap → restart
    assert f1 is not None
    assert (f1.track_cnt[f1.valid] == 1).all()
    # ids were re-issued
    assert len(np.intersect1d(f0.ids[f0.valid], f1.ids[f1.valid])) == 0
    # a timestamp that runs backwards restarts too
    f2 = tr.process(4.0, img0)
    assert (f2.track_cnt[f2.valid] == 1).all()
    assert len(np.intersect1d(f1.ids[f1.valid], f2.ids[f2.valid])) == 0


def test_tracker_freq_gating():
    tr = make_tracker(freq=10)
    jt = JaxTracker(make_cfg(jconfig, freq=10))
    img = texture(0)
    published = []
    for k in range(30):  # 30 Hz input for 1 s
        published.append(tr.process(k / 30.0, img) is not None)
        # the gate is host logic on timestamps: the reference's decisions
        assert published[-1] == jt._should_publish(k / 30.0)
        jt.pub_count += published[-1]
    assert 8 <= sum(published) <= 13, published
    # tracking went on through the unpublished images
    assert int(tr.track_cnt.max()) == 30


def test_tracker_refills_after_loss():
    tr = make_tracker()
    f0 = tr.process(0.0, texture(0))
    # radically different image → most tracks lost, refill happens
    f2 = tr.process(0.1, texture(99))
    assert int(f2.valid.sum()) >= 0.5 * tr.cfg.tracker.max_cnt
    fresh = f2.valid & (f2.track_cnt == 1)
    assert fresh.sum() > 0.5 * f2.valid.sum()
    assert f2.ids[fresh].min() > f0.ids[f0.valid].max()
    # no two features of the table closer than min_dist
    p = f2.uv[f2.valid]
    d = np.linalg.norm(p[:, None] - p[None, :], axis=-1)
    np.fill_diagonal(d, 1e9)
    assert d.min() >= tr.cfg.tracker.min_dist - 1e-3


def test_uint8_and_tensor_images_track_alike():
    img0 = np.round(texture(0))
    img1 = np.round(shift_img(img0, 2.0, 1.0))
    frames = []
    for conv in (lambda a: a.astype(np.float32),
                 lambda a: a.astype(np.uint8),
                 lambda a: torch.as_tensor(a.astype(np.uint8))):
        tr = make_tracker()
        tr.process(0.0, conv(img0))
        frames.append(tr.process(0.1, conv(img1)))
    for f in frames[1:]:
        np.testing.assert_array_equal(f.valid, frames[0].valid)
        np.testing.assert_array_equal(f.uv, frames[0].uv)
        np.testing.assert_array_equal(f.ids, frames[0].ids)


def test_ids_survive_the_float_pack_beyond_2_pow_24():
    tr = make_tracker()
    tr.next_id = torch.tensor((1 << 24) + 1, dtype=torch.int32)
    f = tr.process(0.0, texture(0))
    ids = np.sort(f.ids[f.valid])
    np.testing.assert_array_equal(ids, (1 << 24) + 1 + np.arange(len(ids)))
    assert (f.ids[~f.valid] == -1).all()


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        assert FeatureTracker(make_cfg(tconfig)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            FeatureTracker(make_cfg(tconfig))
    assert make_tracker().device.type == "cpu"
