"""KLT feature-tracking front end.

Counterpart of ``mvil_fusion_tpu/frontend/feature_tracker.py`` (the
reference's feature_tracker_ node: readImage, rejectWithF, setMask /
addPoints, undistortedPoints, and the node's publish gating).

Design: one fixed-capacity slot table (N = max_features_pad) for tracked
features, resident on the device; the whole per-image update (CLAHE →
pyramid → LK → RANSAC cull → corner refill → undistort + velocity) is
queued on the device without waiting for it.  The host manages only the
frequency gating and the stream restart, which depend on timestamps
alone.  Ids live on the device too: an unpublished image costs no
readback, a published one exactly one (the packed (N,9) frame).

What the host knows it branches on in Python (is there a previous image,
the time step); what only the device knows (are there enough tracks for
RANSAC, which slots are empty) is computed always and selected with
`torch.where`, so that no step waits for a value.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch

from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.frontend import camera as cam
from mvil_fusion_torch.ops import corners, image as im, klt, ransac
from mvil_fusion_torch.utils.device import resolve_device
from mvil_fusion_torch.utils.precision import set_fp32_policy

# virtual focal length of the plane RANSAC runs on (reference rejectWithF)
VIRTUAL_FOCAL = 460.0


class FeatureFrame(NamedTuple):
    """Packed feature message: the engine's equivalent of the reference's
    PointCloud msg with [id, u, v, vx, vy, depth] channels."""

    t: float
    ids: np.ndarray        # (N,) int64, -1 for empty slots
    norm: np.ndarray       # (N,2) normalized undistorted coords
    vel: np.ndarray        # (N,2) normalized-plane velocity
    uv: np.ndarray         # (N,2) raw pixel coords
    depth: np.ndarray      # (N,) lidar depth (-1 unknown)
    valid: np.ndarray      # (N,) bool
    track_cnt: np.ndarray  # (N,)


class _StepOut(NamedTuple):
    pts: torch.Tensor
    valid: torch.Tensor
    track_cnt: torch.Tensor
    norm: torch.Tensor
    ids: torch.Tensor        # (N,) int32 slot ids, -1 empty (device-owned)
    next_id: torch.Tensor    # () int32
    packed: torch.Tensor     # (N,9) f32 [u v nx ny vx vy id valid cnt]
    pyr: tuple


class FeatureTracker:
    def __init__(self, config: SystemConfig,
                 device: torch.device | str | None = None,
                 generator: Optional[torch.Generator] = None):
        """`device` None is the current CUDA device (a RuntimeError where
        there is no card); a CPU caller passes ``device="cpu"``.
        `generator` draws the RANSAC hypotheses and must live on that
        device; the default is a new one seeded with
        ``tracker.ransac_iters``."""
        set_fp32_policy()
        self.cfg = config
        self.device = dev = resolve_device(device)
        self.camera = cam.from_config(config.camera)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(config.tracker.ransac_iters)
        self.generator = generator
        # where set, called once per tracked image with the (N,) mask of
        # the slots KLT accepted, for the (ransac_iters, 8) slot indices of
        # the RANSAC hypotheses, in place of the generator (a comparison
        # with the reference, or of two devices, passes the samples in)
        self.hypothesis_source: Optional[
            Callable[[torch.Tensor], torch.Tensor]] = None
        N = config.tracker.max_features_pad
        self.N = N
        self.pts = torch.zeros((N, 2), dtype=torch.float32, device=dev)
        self.valid = torch.zeros((N,), dtype=torch.bool, device=dev)
        self.track_cnt = torch.zeros((N,), dtype=torch.int32, device=dev)
        self.norm = torch.zeros((N, 2), dtype=torch.float32, device=dev)
        self.ids = torch.full((N,), -1, dtype=torch.int32, device=dev)
        self.next_id = torch.zeros((), dtype=torch.int32, device=dev)
        self.prev_pyr: Optional[tuple] = None
        self.prev_t: Optional[float] = None
        self._slot = torch.arange(N, device=dev)
        # frequency control (feature_tracker_node.cpp:61-72)
        self.first_image_time: Optional[float] = None
        self.pub_count = 0

    def reset(self):
        """Stream-gap restart (feature_tracker_node.cpp:48-58)."""
        self.valid = torch.zeros_like(self.valid)
        self.track_cnt = torch.zeros_like(self.track_cnt)
        self.ids = torch.full_like(self.ids, -1)
        self.prev_pyr = None
        self.prev_t = None
        self.first_image_time = None
        self.pub_count = 0

    def load_reference_state(self, state: Mapping) -> None:
        """Take over a tracker state given as numpy arrays and host values
        (e.g. the JAX tracker's): `pts`, `valid`, `track_cnt`, `norm`,
        `ids` per slot, `next_id`, `prev_pyr` (the previous image's
        pyramid, full resolution first, or None), `prev_t`,
        `first_image_time` and `pub_count`."""
        N = self.N
        want = dict(pts=((N, 2), torch.float32), valid=((N,), torch.bool),
                    track_cnt=((N,), torch.int32),
                    norm=((N, 2), torch.float32), ids=((N,), torch.int32),
                    next_id=((), torch.int32))
        for name, (shape, dtype) in want.items():
            a = np.array(state[name], copy=True)
            if a.shape != shape:
                raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
            setattr(self, name, torch.as_tensor(a).to(
                device=self.device, dtype=dtype))
        pyr = state["prev_pyr"]
        if pyr is not None:
            levels = self.cfg.tracker.pyramid_levels + 1
            if len(pyr) != levels:
                raise ValueError(f"prev_pyr: {len(pyr)} levels, expected "
                                 f"{levels}")
            pyr = tuple(torch.as_tensor(np.array(p, copy=True)).to(
                device=self.device, dtype=torch.float32) for p in pyr)
        self.prev_pyr = pyr
        opt = lambda v: None if v is None else float(v)
        self.prev_t = opt(state["prev_t"])
        self.first_image_time = opt(state["first_image_time"])
        self.pub_count = int(state["pub_count"])

    def _should_publish(self, t: float) -> bool:
        freq = self.cfg.tracker.freq
        if freq <= 0:
            return True
        if self.first_image_time is None:
            self.first_image_time = t
            return True
        elapsed = t - self.first_image_time
        if elapsed <= 0:
            return True
        if self.pub_count / elapsed <= freq:
            # reset window when the realized rate drifts (reference :66-71)
            if abs(self.pub_count / elapsed - freq) < 0.01 * freq:
                self.first_image_time = t
                self.pub_count = 0
            return True
        return False

    def process(self, t: float, img) -> FeatureFrame | None:
        """Track one image; returns a FeatureFrame when freq-gated to
        publish, else None (tracking state still updates)."""
        publish, out = self.process_device(t, img)
        if not publish:
            return None
        # ONE packed readback per published frame
        return self.publish_from_packed(t, out.packed.cpu().numpy())

    def _upload(self, img) -> torch.Tensor:
        """The image as float32 on the device, without waiting for it: a
        host array (uint8 or float32) goes through pinned memory."""
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.ascontiguousarray(img))
            if self.device.type == "cuda":
                img = img.pin_memory()
        return img.to(self.device, non_blocking=True).to(torch.float32)

    def process_device(self, t: float, img):
        """No-fetch tracking step: updates the device state and returns
        (should_publish, _StepOut).  The packed readback is the caller's
        choice."""
        # stream discontinuity -> restart (reference: >1s gap)
        if self.prev_t is not None and (t - self.prev_t > 1.0
                                        or t < self.prev_t):
            self.reset()
        # the publish decision is pure host state (freq gate on t), made
        # before anything is queued.  RANSAC, the mask and the refill run
        # on every image, as in the JAX package, not only on published ones
        publish = self._should_publish(t)
        dt = (t - self.prev_t) if self.prev_t is not None else 0.0
        out = self._step(self._upload(img), float(np.float32(dt)))

        # all state stays device-resident: no blocking fetch here
        self.pts = out.pts
        self.valid = out.valid
        self.track_cnt = out.track_cnt
        self.norm = out.norm
        self.ids = out.ids
        self.next_id = out.next_id
        self.prev_pyr = out.pyr
        self.prev_t = t
        if publish:
            self.pub_count += 1
        return publish, out

    def _step(self, img: torch.Tensor, dt: float) -> _StepOut:
        """The whole per-image device program."""
        tk = self.cfg.tracker
        N, slot = self.N, self._slot
        pts, valid, track_cnt = self.pts, self.valid, self.track_cnt
        prev_norm, ids, next_id = self.norm, self.ids, self.next_id
        do_track = self.prev_pyr is not None

        if tk.equalize:
            img = im.clahe(img)
        pyr = tuple(im.build_pyramid(img, tk.pyramid_levels))

        # --- LK track from the previous frame, RANSAC cull ----------------
        if do_track:
            res = klt.track(self.prev_pyr, pyr, pts, valid,
                            win=tk.window_size, iters=tk.max_iters,
                            min_eig_thr=tk.min_eig_threshold)
            pts1, ok = res.pts, res.ok
            # fundamental RANSAC on the virtual-focal plane; computed
            # always, used where there are enough tracks
            x1 = prev_norm * VIRTUAL_FOCAL
            x2 = self.camera.lift_projective(pts1) * VIRTUAL_FOCAL
            idx = None
            if self.hypothesis_source is not None:
                idx = torch.as_tensor(self.hypothesis_source(ok)).to(
                    self.device, non_blocking=True)
            rr = ransac.fundamental_ransac(
                x1, x2, ok, threshold=tk.f_threshold, n_hyp=tk.ransac_iters,
                generator=self.generator, idx=idx)
            enough = torch.sum(ok) >= 12
            ok2 = ok & (rr.inliers | ~enough)
        else:
            pts1, ok = pts, torch.zeros_like(valid)
            ok2 = ok
        track_cnt1 = torch.where(ok, track_cnt + 1, 0)

        # --- setMask: track-count-ranked min-dist suppression -------------
        # Features are ranked longest track first; a feature within
        # min_dist of a kept one of higher rank is dropped.  A parallel
        # fixed point in place of the reference's sequential visit:
        # kept[i] iff no higher-priority KEPT feature lies within
        # min_dist; iterating from all-in converges to the greedy solution
        # level by level.
        pri = torch.where(ok2, track_cnt1 * N - slot.to(torch.int32), -1)
        d2m = torch.sum((pts1[:, None, :] - pts1[None, :, :]) ** 2, dim=-1)
        sup = ((d2m < float(tk.min_dist) ** 2)
               & (pri[None, :] > pri[:, None]) & ok2[None, :])
        kept = ok2
        for _ in range(6):
            kept = ok2 & ~torch.any(sup & kept[None, :], dim=1)
        ok2 = ok2 & kept

        # --- refill with new corners --------------------------------------
        n_missing = tk.max_cnt - torch.sum(ok2)
        det = corners.detect(img, pts1, ok2, max_new=tk.max_cnt,
                             min_dist=tk.min_dist)
        K = det.pts.shape[0]
        want_new = det.ok & (slot[:K] < n_missing)
        # corner j goes to the (rank of j among the accepted)-th empty
        # slot.  A stable sort lists the empty slots first, in order; a
        # corner without an empty slot goes to a spare row N that is cut
        # off afterwards.
        corner_rank = torch.cumsum(want_new, dim=0) - 1
        empty_slots = torch.sort(ok2.to(torch.uint8), stable=True).indices
        has_slot = want_new & (corner_rank < N - torch.sum(ok2))
        target = torch.where(has_slot,
                             empty_slots[corner_rank.clamp(0, N - 1)], N)
        pts2 = torch.cat([pts1, pts1.new_zeros((1, 2))])
        pts2[target] = det.pts
        pts2 = pts2[:N]
        new_mask = torch.zeros((N + 1,), dtype=torch.bool,
                               device=self.device).index_fill_(
                                   0, target, True)[:N]

        valid2 = ok2 | new_mask
        track_cnt2 = torch.where(new_mask, 1, track_cnt1)
        norm2 = self.camera.lift_projective(pts2)

        # --- id management (reference: the n_id counter) -------------------
        ids1 = torch.where(ok2, ids, -1)
        spawn_rank = (torch.cumsum(new_mask, dim=0) - 1).to(torch.int32)
        ids2 = torch.where(new_mask, next_id + spawn_rank, ids1)
        next_id2 = next_id + torch.sum(new_mask).to(torch.int32)

        # --- normalized-plane velocity (undistortedPoints) -----------------
        if dt > 0:
            # ok2: tracked from the previous frame, not newly spawned
            vel = torch.where(ok2[:, None],
                              (norm2 - prev_norm) / max(dt, 1e-6), 0.0)
        else:
            vel = torch.zeros_like(norm2)

        # ids are BITCAST (not value-cast) into the f32 pack: float32 is
        # only exact to 2^24, so long runs would silently collide cast
        # ids; the bitcast round-trips all 32 bits through the one fetch
        packed = torch.cat([
            pts2, norm2, vel,
            ids2.view(torch.float32)[:, None],
            valid2[:, None].to(torch.float32),
            track_cnt2[:, None].to(torch.float32)], dim=1)
        return _StepOut(pts=pts2, valid=valid2, track_cnt=track_cnt2,
                        norm=norm2, ids=ids2, next_id=next_id2,
                        packed=packed, pyr=pyr)

    def publish_from_packed(self, t: float,
                            packed: np.ndarray) -> FeatureFrame:
        """Host-side FeatureFrame assembly from the fetched (N,9) pack."""
        return FeatureFrame(
            t=t,
            ids=packed[:, 6].copy().view(np.int32).astype(np.int64),
            norm=packed[:, 2:4].copy(), vel=packed[:, 4:6].copy(),
            uv=packed[:, 0:2].copy(),
            depth=np.full(self.N, -1.0, np.float32),
            valid=packed[:, 7] > 0.5,
            track_cnt=packed[:, 8].astype(np.int32))
