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
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mvil_fusion_torch import _build

K_MAX = 128
_PLAIN_CHUNK = 512     # query rows per distance block of the plain version


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
    and the k are re-sorted (stably) by that exact value."""
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
        v, i = torch.topk(dc, k, dim=1, largest=False, sorted=True)
        found = torch.isfinite(v)
        i = torch.where(found, i, 0)
        diff = qc[:, None, :] - r[i]
        exact = torch.where(found, torch.sum(diff * diff, dim=-1),
                            float("inf"))
        exact, order = torch.sort(exact, dim=1, stable=True)
        d2[s:s + _PLAIN_CHUNK] = exact
        idx[s:s + _PLAIN_CHUNK] = torch.gather(i, 1, order)
    return idx, d2


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
        fn.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, vp]
        fn.restype = ci
    return fn


def knn_topk_cuda(query: torch.Tensor, ref: torch.Tensor,
                  ref_mask: torch.Tensor, k: int):
    """Launch the hand-written kernel on the current stream.  Raises on
    CPU tensors, wrong dtypes or shapes, non-contiguous input, k outside
    [1, 128], and a launch error."""
    _check_k(k)
    _check_cuda_args(query, ref, ref_mask)
    nq, nr = query.shape[0], ref.shape[0]
    dev = query.device
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((nq, k), dtype=torch.float32, device=dev)
    if nq == 0:
        return idx, d2
    fn = _launcher()
    with torch.cuda.device(dev):
        err = fn(query.data_ptr(), ref.data_ptr(), ref_mask.data_ptr(),
                 nq, nr, k, d2.data_ptr(), idx.data_ptr(),
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
