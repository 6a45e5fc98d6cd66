"""What surrounds the port's k-NN kernel in Python
(mvil_fusion_torch/ops/knn_topk.py), on the CPU:

(a) the split planner: how many slices the kernel's blocks scan side by
    side, and how the live part of the reference (up to its last unmasked
    point) is cut into them;
(b) split-and-merge itself, emulated with the plain version: the top-k of
    every slice of the live part, merged by the kernel's rule (order by
    d2, then by position in the slice-major scratch), equals the plain
    top-k of the whole reference exactly in idx and d2.  Coordinates are small integers, so
    every distance is exact in fp32 and full of ties;
(c) the default-device rule of the port's constructors: the card unless
    the caller passes ``device="cpu"``, and no fallback.
"""

import numpy as np
import pytest
import torch

from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.frontend.lidar_compensator import LidarCompensator
from mvil_fusion_torch.mapping.local_mapping import LocalMapper
from mvil_fusion_torch.ops import knn_topk as K
from mvil_fusion_torch.utils.device import resolve_device

H100_SMS = 132
PLAN_SHAPES = [(256, 16384, 5), (4096, 32768, 5), (4096, 32768, 10),
               (37, 513, 3), (1, 1, 1), (256, 4096, 128), (64, 1024, 5),
               (1, 100000, 1), (100000, 7, 3), (8, 0, 2)]


def _slices(extent, splits, length):
    return [(min(extent, s * length), min(extent, (s + 1) * length))
            for s in range(splits)]


def _extent(mask):
    """The live part's end as the kernel finds it: one past the last
    unmasked point, rounded up to SPLIT_ALIGN, at most the length."""
    live = np.nonzero(np.asarray(mask))[0]
    if len(live) == 0:
        return 0
    a = K.SPLIT_ALIGN
    return min(len(mask), -(-(int(live[-1]) + 1) // a) * a)


@pytest.mark.parametrize("sms", [1, 16, H100_SMS])
@pytest.mark.parametrize("nq,nr,k", PLAN_SHAPES)
def test_plan_covers_reference(nq, nr, k, sms):
    """S >= 1 and S <= Nr; the same for the same arguments; and for any
    live part the S slices are contiguous, cover it, and are aligned."""
    splits = K.plan_splits(nq, nr, k, sms)
    assert 1 <= splits <= max(nr, 1) and splits <= K.MAX_SPLITS
    assert splits == K.plan_splits(nq, nr, k, sms)
    if splits > 1:
        assert nr // splits >= max(K.MIN_SPLIT, K.MIN_SPLIT_PER_K * k)
    for extent in sorted({nr, nr // 7, min(nr, 16), 0}):
        used, length = K.split_geometry(extent, splits)
        assert 0 <= used <= splits and length % K.SPLIT_ALIGN == 0
        sl = _slices(extent, splits, length)
        assert sl[0][0] == 0 and sl[-1][1] == extent
        assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
        assert [hi > lo for lo, hi in sl] == [s < used for s in
                                              range(splits)]


@pytest.mark.parametrize("nq,nr,k,expected", [
    (256, 16384, 5, 64),         # edges: few queries, many slices
    (4096, 32768, 5, 16),        # planes: 32 query tiles x 16 slices
    (4096, 32768, 10, 16),
    (1, 1, 1, 1),
    (64, 255, 5, 1),             # a reference under MIN_SPLIT
    (256, 4096, 128, 2),         # large k: long slices
])
def test_plan_on_h100(nq, nr, k, expected):
    assert K.plan_splits(nq, nr, k, H100_SMS) == expected


@pytest.mark.parametrize("extent,splits,expected", [
    (64, 2, (2, 32)), (513, 7, (7, 80)), (513, 64, (33, 16)),
    (10, 4, (1, 16)), (17, 2, (2, 16)), (100, 1, (1, 112)), (0, 3, (0, 0)),
    (4723, 16, (16, 304)), (368, 64, (23, 16)),
])
def test_split_geometry(extent, splits, expected):
    assert K.split_geometry(extent, splits) == expected


def test_split_geometry_rejects_zero():
    with pytest.raises(ValueError, match="at least 1"):
        K.split_geometry(100, 0)


def _split_and_merge(query, ref, mask, k, splits):
    """The kernel's scheme with the plain version in each slice of the
    live part; returns (idx, d2, slices that were not empty)."""
    extent = _extent(mask.numpy())
    used, length = K.split_geometry(extent, splits)
    nq = query.shape[0]
    part_idx, part_d2 = [], []
    for lo, hi in _slices(extent, splits, length):
        if hi == lo:                     # an empty slice: k empty slots
            idx = torch.zeros((nq, k), dtype=torch.int32)
            d2 = torch.full((nq, k), float("inf"))
        else:
            idx, d2 = K.knn_topk_plain(query, ref[lo:hi], mask[lo:hi], k)
        part_idx.append(torch.where(torch.isfinite(d2), idx + lo, 0))
        part_d2.append(d2)
    part_idx, part_d2 = torch.cat(part_idx, 1), torch.cat(part_d2, 1)
    # the merge: by d2, equal d2 by scratch position (a stable sort)
    d2, order = torch.sort(part_d2, dim=1, stable=True)
    idx = torch.gather(part_idx, 1, order)
    return idx[:, :k].to(torch.int32), d2[:, :k], used


def _grid_case(seed, nq, nr, masked=0.2):
    rng = np.random.default_rng(seed)
    q = rng.integers(-4, 5, (nq, 3)).astype(np.float32)
    r = rng.integers(-4, 5, (nr, 3)).astype(np.float32)
    m = rng.uniform(size=nr) >= masked
    return q, r, m


def _case(name):
    """(query, ref, mask, k, splits asked)"""
    if name == "duplicates-across-boundary":
        q, r, m = _grid_case(1, 9, 64, masked=0.0)
        r[29:35] = q[0]                  # boundary at 32: three on each side
        return q, r, m, 4, 2
    if name == "masked-split":
        q, r, m = _grid_case(2, 16, 96)
        m[32:64] = False
        return q, r, m, 5, 3
    if name == "fewer-than-k-per-split":
        q, r, m = _grid_case(3, 16, 128)
        m[:] = False
        m[[3, 40, 41, 70, 127]] = True   # at most 2 live refs in a slice
        return q, r, m, 4, 4
    if name == "ragged":
        q, r, m = _grid_case(4, 37, 513)
        return q, r, m, 3, 7
    if name == "nr-below-k":
        q, r, m = _grid_case(5, 8, 40)
        return q, r, m, 64, 2
    if name == "k-1":
        q, r, m = _grid_case(6, 50, 300)
        return q, r, m, 1, 5
    if name == "k-128":
        q, r, m = _grid_case(7, 20, 700)
        return q, r, m, 128, 4
    if name == "all-masked":
        q, r, m = _grid_case(8, 8, 64, masked=1.0)
        return q, r, m, 3, 2
    if name == "live-prefix":            # a map: live at the front only
        q, r, m = _grid_case(9, 24, 1000)
        m[150:] = False
        return q, r, m, 5, 6
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "duplicates-across-boundary", "masked-split", "fewer-than-k-per-split",
    "ragged", "nr-below-k", "k-1", "k-128", "all-masked", "live-prefix"])
def test_split_and_merge_equals_whole(name):
    q, r, m, k, asked = _case(name)
    q, r, m = (torch.as_tensor(a) for a in (q, r, m))
    idx_w, d2_w = K.knn_topk_plain(q, r, m, k)
    idx_s, d2_s, used = _split_and_merge(q, r, m, k, asked)
    assert used > 1 or name == "all-masked"
    assert torch.equal(d2_s, d2_w)
    assert torch.equal(idx_s, idx_w)
    empty = torch.isinf(d2_w)
    assert bool((idx_s[empty] == 0).all())


def test_duplicates_keep_lower_index_across_boundary():
    q, r, m, k, asked = _case("duplicates-across-boundary")
    q, r, m = (torch.as_tensor(a) for a in (q, r, m))
    idx, d2, _ = _split_and_merge(q, r, m, k, asked)
    dup = torch.nonzero((r == q[0]).all(dim=1)).flatten()[:k]
    assert idx[0].tolist() == dup.tolist() and d2[0].tolist() == [0.0] * k
    assert dup[0] < 32 <= dup[-1]


@pytest.mark.parametrize("make", [
    pytest.param(lambda cfg, **kw: LocalMapper(cfg, **kw), id="LocalMapper"),
    pytest.param(lambda cfg, **kw: LidarCompensator(cfg, **kw),
                 id="LidarCompensator")])
def test_default_device_is_the_card(make):
    """Without a card the default raises and names what is missing; it
    never falls back to the CPU.  With one, the default is that card."""
    cfg = SystemConfig()
    assert make(cfg, device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert make(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make(cfg)


@pytest.mark.parametrize("given,expected", [
    ("cpu", torch.device("cpu")), (torch.device("cpu"), torch.device("cpu")),
    ("cuda:0", torch.device("cuda:0"))])
def test_resolve_device_keeps_what_it_is_given(given, expected):
    assert resolve_device(given) == expected
