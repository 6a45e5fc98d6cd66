"""Brute-force k-NN of queries against a masked reference.

Counterpart of ``mvil_fusion_tpu/ops/pallas_knn.py`` (``knn_topk``).  It
holds the wrapper of the hand-written CUDA kernel
(``csrc/knn_topk.cu``), its plain PyTorch version and the kernel's launch
counter.  Both return ``(idx (Nq,k) int32, d2 (Nq,k) f32)``: the k
smallest squared distances in ascending order and their reference
indices.  Masked refs never win; slots left empty (fewer than k unmasked
refs) hold d2 = +inf and idx = 0.

``knn_topk`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no fallback from one to the other.

On the card a first small kernel finds the live part of the reference (up
to its last unmasked point: the LOAM maps keep their points at the front of
a buffer that is mostly empty), the scan cuts it into S contiguous slices
that blocks scan side by side, and a last small kernel merges the S partial
lists of every query.  ``plan_splits`` picks S from the shapes and the
card's SM count; ``split_geometry`` is the layout the kernel derives from S
and the live part.  Both are plain Python, so the CPU tests hold them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mvil_fusion_torch import _build

K_MAX = 128
_PLAIN_CHUNK = 512     # query rows per distance block of the plain version

BLOCK_QUERIES = 128    # queries per block, as csrc/knn_topk.cu has it
SPLIT_ALIGN = 16       # slices start at multiples of this many points
BLOCKS_PER_SM = 4      # blocks a call should put on every SM
MIN_SPLIT = 256        # shortest slice worth a block of its own ...
MIN_SPLIT_PER_K = 16   # ... and at least this many points per neighbour
MAX_SPLITS = 64

_sm_counts: dict[int, int] = {}


def _check_k(k: int) -> None:
    if not isinstance(k, int) or not 1 <= k <= K_MAX:
        raise ValueError(f"k must be an int in [1, {K_MAX}], got {k!r}")


def knn_topk_plain(query: torch.Tensor, ref: torch.Tensor,
                   ref_mask: torch.Tensor, k: int):
    """The plain version: ranks by d2 = q² + r² − 2 q·rᵀ from an fp32
    matmul (TF32 off, see utils/precision.py) with masked entries +inf and
    ``torch.topk``, in blocks of query rows so that 4096 × 32768 never
    allocates the whole distance matrix at once.

    The expanded form loses ~1e-3 of d2 to cancellation at map scale
    (coordinates ~60 m, q² + r² ~ 7e3), so the k winners' d2 are then
    recomputed directly as (q − r)·(q − r), as the kernel computes them,
    and the k are re-sorted (stably) by that exact value.  Equal distances
    keep the lower index first."""
    _check_k(k)
    q = query.to(torch.float32)
    r = ref.to(torch.float32)
    nq, nr = q.shape[0], r.shape[0]
    r2 = torch.sum(r * r, dim=-1)
    idx = torch.zeros((nq, k), dtype=torch.int32, device=q.device)
    d2 = torch.full((nq, k), float("inf"), device=q.device)
    if nr == 0:
        return idx, d2
    for s in range(0, nq, _PLAIN_CHUNK):
        qc = q[s:s + _PLAIN_CHUNK]
        q2 = torch.sum(qc * qc, dim=-1, keepdim=True)
        dc = q2 + r2[None, :] - 2.0 * (qc @ r.T)
        dc = torch.where(ref_mask[None, :], dc, float("inf"))
        if nr < k:
            dc = F.pad(dc, (0, k - nr), value=float("inf"))
        # torch.topk leaves the order of equal values open, so it only finds
        # the k-th value; the k winners are then everything below it and the
        # lowest indices at it, taken by a second topk over keys that are
        # unique: the lower index first, as the kernel and lax.top_k have it
        kth = torch.topk(dc, k, dim=1, largest=False).values[:, -1:]
        ncols = dc.shape[1]
        rank = torch.arange(ncols, 0, -1, dtype=torch.int32, device=q.device)
        key = torch.where(dc < kth, rank + ncols,
                          torch.where(dc == kth, rank, 0))
        i = torch.topk(key, k, dim=1).indices
        found = torch.isfinite(torch.gather(dc, 1, i))
        i = torch.where(found, i, 0)
        diff = qc[:, None, :] - r[i]
        exact = torch.where(found, torch.sum(diff * diff, dim=-1),
                            float("inf"))
        exact, order = torch.sort(exact, dim=1, stable=True)
        d2[s:s + _PLAIN_CHUNK] = exact
        idx[s:s + _PLAIN_CHUNK] = torch.gather(i, 1, order)
    return idx, d2


def split_geometry(extent: int, splits: int) -> tuple[int, int]:
    """(used, length): how the kernel cuts the live part [0, extent) of the
    reference into `splits` slices.  Slice s is [s * length, min(extent,
    (s + 1) * length)); length is a multiple of SPLIT_ALIGN; the first
    `used` slices are not empty, the rest are.  extent is one past the
    last unmasked point, which the kernel finds on the card."""
    if splits < 1:
        raise ValueError(f"splits must be at least 1, got {splits}")
    length = -(-max(extent, 0) // splits)
    length = -(-length // SPLIT_ALIGN) * SPLIT_ALIGN
    used = -(-extent // length) if length else 0
    return used, length


def plan_splits(nq: int, nr: int, k: int, sm_count: int) -> int:
    """The number of slices S for a call: as many as put BLOCKS_PER_SM
    blocks on every SM, but none shorter than MIN_SPLIT points or
    MIN_SPLIT_PER_K * k if the whole reference is live (each slice pays its
    own first insertions, and the merge reads S * k entries per query),
    and at most MAX_SPLITS."""
    tiles = max(1, -(-nq // BLOCK_QUERIES))
    want = max(1, (BLOCKS_PER_SM * sm_count) // tiles)
    most = max(1, nr // max(MIN_SPLIT, MIN_SPLIT_PER_K * k))
    return min(want, most, MAX_SPLITS)


def _sm_count(dev: torch.device) -> int:
    """SMs of the card, read once per device (the first call of a run, so
    never during a graph capture)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def _check_cuda_args(query, ref, ref_mask):
    for name, t, dtype, ndim in (("query", query, torch.float32, 2),
                                 ("ref", ref, torch.float32, 2),
                                 ("ref_mask", ref_mask, torch.bool, 1)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.ndim != ndim or (ndim == 2 and t.shape[1] != 3):
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ref_mask.shape[0] != ref.shape[0]:
        raise ValueError(f"ref_mask has {ref_mask.shape[0]} rows, ref "
                         f"{ref.shape[0]}")
    for name, t in (("query", query), ("ref", ref), ("ref_mask", ref_mask)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != query.device:
            raise ValueError(f"{name} is on {t.device}, query on "
                             f"{query.device}")


def _launcher():
    lib = _build.load_library("knn_topk")
    fn = lib.knn_topk_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp]
        fn.restype = ci
    return fn


def knn_topk_cuda(query: torch.Tensor, ref: torch.Tensor,
                  ref_mask: torch.Tensor, k: int, _splits: int | None = None):
    """Launch the hand-written kernel (the live extent, the scan and, with
    more than one slice, the merge) on the current stream; one call counts
    as one launch.
    Raises on CPU tensors, wrong dtypes or shapes, non-contiguous input,
    k outside [1, 128], and a launch error.  `_splits` forces the number of
    slices instead of the planner's; the tests use it."""
    _check_k(k)
    _check_cuda_args(query, ref, ref_mask)
    nq, nr = query.shape[0], ref.shape[0]
    dev = query.device
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((nq, k), dtype=torch.float32, device=dev)
    if nq == 0:
        return idx, d2
    splits = plan_splits(nq, nr, k, _sm_count(dev)) if _splits is None \
        else _splits
    if not 1 <= splits <= 65535:
        raise ValueError(f"splits must be in [1, 65535], got {splits}")
    # the kernel copies 16 bytes at a time: a view that starts off that
    # grid is copied onto it
    if ref.data_ptr() % 16:
        ref = ref.clone()
    if ref_mask.data_ptr() % 16:
        ref_mask = ref_mask.clone()
    # one scratch for the kernel: the live extent (one int), then, with
    # more than one slice, the partial d2 and idx, each (nq, splits, k)
    part = nq * splits * k if splits > 1 else 0
    scratch = torch.empty((4 + 2 * part,), dtype=torch.int32, device=dev)
    part_d2 = scratch.data_ptr() + 16
    part_idx = part_d2 + 4 * part
    fn = _launcher()
    with torch.cuda.device(dev):
        err = fn(query.data_ptr(), ref.data_ptr(), ref_mask.data_ptr(),
                 nq, nr, k, splits, scratch.data_ptr(),
                 part_d2, part_idx, d2.data_ptr(), idx.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_topk kernel launch failed: CUDA error {err}")
    knn_topk_cuda.launches += 1
    return idx, d2


knn_topk_cuda.launches = 0


def knn_topk(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor,
             k: int):
    """(idx (Nq,k), d2 (Nq,k)): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if query.is_cuda:
        return knn_topk_cuda(query, ref, ref_mask, k)
    return knn_topk_plain(query, ref, ref_mask, k)
