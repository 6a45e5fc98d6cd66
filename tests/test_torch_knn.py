"""The port's k-NN (mvil_fusion_torch/ops/knn_topk.py) against the JAX
reference: the plain version vs ``loam_icp.knn`` (the XLA path on the CPU)
and vs the Pallas kernel ``knn_topk(..., interpret=True)``, on the shapes
of tests/test_pallas_knn.py.  Tolerance as there: d2 within rtol 1e-4 /
atol 1e-3 where finite, index agreement ≥ 0.99 where finite (near-equal
distances may rank differently in fp32), masked slots > 1e20 or +inf.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py);
here its wrapper's argument checks are exercised."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mvil_fusion_tpu.ops import loam_icp as jicp
from mvil_fusion_tpu.ops.pallas_knn import knn_topk as pallas_knn_topk
from mvil_fusion_torch.ops import knn_topk as K
from mvil_fusion_torch.ops import loam_icp as ticp
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401


SHAPES = [(100, 1000, 5), (256, 4096, 10), (37, 513, 3)]


def _inputs(rng, nq, nr, scale=10.0):
    query = rng.uniform(-scale, scale, (nq, 3)).astype(np.float32)
    ref = rng.uniform(-scale, scale, (nr, 3)).astype(np.float32)
    mask = rng.uniform(size=nr) > 0.2
    return query, ref, mask


def _assert_knn_close(idx_a, d2_a, idx_b, d2_b):
    d2_a, d2_b = np.asarray(d2_a), np.asarray(d2_b)
    finite = np.isfinite(d2_b)
    np.testing.assert_allclose(d2_a[finite], d2_b[finite], rtol=1e-4,
                               atol=1e-3)
    assert np.all(d2_a[~finite] > 1e20)
    same = np.asarray(idx_a) == np.asarray(idx_b)
    assert same[finite].mean() > 0.99


def _plain(query, ref, mask, k):
    idx, d2 = K.knn_topk_plain(torch.as_tensor(query), torch.as_tensor(ref),
                               torch.as_tensor(mask), k)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    assert idx.shape == d2.shape == (query.shape[0], k)
    return idx.numpy(), d2.numpy()


@pytest.mark.parametrize("nq,nr,k,scale", [
    pytest.param(*s, 10.0, id="-".join(map(str, s))) for s in SHAPES] + [
    pytest.param(256, 16384, 5, 60.0, id="map-scale-256-16384-5")])
def test_plain_knn_matches_xla_path(rng, nq, nr, k, scale):
    """At map scale (±60 m, the edge call's shape) the reference's d2 come
    from the expanded form q² + r² − 2 q·r, whose rounding error grows with
    q² + r² (~2e4 m²), while the port returns the winners' direct (q−r)².
    There d2 are held within 1e-3 + 4 ε₃₂ (q² + r²) of the reference's
    (observed ≤ 1.7 ε₃₂ (q² + r²), ~2e-3 m²); the indices as elsewhere."""
    query, ref, mask = _inputs(rng, nq, nr, scale)
    idx_j, d2_j = jicp.knn(jnp.asarray(query), jnp.asarray(ref),
                           jnp.asarray(mask), k)
    idx_t, d2_t = _plain(query, ref, mask, k)
    if scale <= 10.0:
        _assert_knn_close(idx_t, d2_t, idx_j, d2_j)
    else:
        norm2 = (query ** 2).sum(1)[:, None] + (ref[idx_t] ** 2).sum(-1)
        tol = 1e-3 + 4 * np.finfo(np.float32).eps * norm2
        assert np.all(np.abs(d2_t - np.asarray(d2_j)) <= tol)
        assert (idx_t == np.asarray(idx_j)).mean() > 0.99
    assert np.all(np.diff(d2_t, axis=1) >= 0)


@pytest.mark.parametrize("nq,nr,k", SHAPES)
def test_plain_knn_matches_pallas_interpret(rng, nq, nr, k):
    query, ref, mask = _inputs(rng, nq, nr)
    idx_p, d2_p = pallas_knn_topk(jnp.asarray(query), jnp.asarray(ref),
                                  jnp.asarray(mask), k, interpret=True)
    idx_t, d2_t = _plain(query, ref, mask, k)
    _assert_knn_close(idx_t, d2_t, idx_p, d2_p)


def test_plain_knn_exact_at_map_scale(rng):
    """At ±60 m the expanded form loses ~1e-3 of d2; the returned d2 are
    the direct (q−r)² of the winners, held here against fp64."""
    query, ref, mask = _inputs(rng, 64, 4096, scale=60.0)
    idx, d2 = _plain(query, ref, mask, 5)
    q64, r64 = query.astype(np.float64), ref.astype(np.float64)
    full = ((q64[:, None, :] - r64[None, :, :]) ** 2).sum(-1)
    full[:, ~mask] = np.inf
    truth = np.sort(full, axis=1)[:, :5]
    np.testing.assert_allclose(d2, truth, rtol=1e-6, atol=1e-5)
    got = np.take_along_axis(full, idx.astype(np.int64), axis=1)
    np.testing.assert_allclose(got, truth, rtol=1e-6, atol=1e-5)


def test_plain_knn_all_masked(rng):
    query, ref, _ = _inputs(rng, 16, 64, scale=1.0)
    idx, d2 = _plain(query, ref, np.zeros(64, bool), 5)
    assert np.all(np.isinf(d2)) and np.all(idx == 0)
    idx_p, d2_p = pallas_knn_topk(jnp.asarray(query), jnp.asarray(ref),
                                  jnp.zeros(64, bool), 5, interpret=True)
    assert np.all(np.asarray(d2_p) > 1e20)


def test_plain_knn_fewer_refs_than_k(rng):
    """Empty slots (fewer unmasked refs than k) hold +inf and index 0."""
    query, ref, _ = _inputs(rng, 8, 3)
    idx, d2 = _plain(query, ref, np.array([True, False, True]), 4)
    assert np.isfinite(d2[:, :2]).all() and np.isinf(d2[:, 2:]).all()
    assert set(np.unique(idx[:, :2])) <= {0, 2} and np.all(idx[:, 2:] == 0)


@pytest.mark.parametrize("k", [0, 129])
def test_k_out_of_range_raises(rng, k):
    query, ref, mask = (torch.as_tensor(a) for a in _inputs(rng, 4, 16))
    with pytest.raises(ValueError):
        K.knn_topk(query, ref, mask, k)
    with pytest.raises(ValueError):
        K.knn_topk_cuda(query, ref, mask, k)


def test_cuda_wrapper_argument_checks(rng):
    query, ref, mask = (torch.as_tensor(a) for a in _inputs(rng, 4, 16))
    before = K.knn_topk_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        K.knn_topk_cuda(query, ref, mask, 3)            # CPU tensors
    with pytest.raises(TypeError):
        K.knn_topk_cuda(query.double(), ref, mask, 3)
    with pytest.raises(TypeError):
        K.knn_topk_cuda(query, ref, mask.to(torch.uint8), 3)
    with pytest.raises(ValueError, match="contiguous"):
        K.knn_topk_cuda(torch.as_tensor(np.asfortranarray(query.numpy())),
                        ref, mask, 3)
    with pytest.raises(ValueError, match="shape"):
        K.knn_topk_cuda(query[:, :2].contiguous(), ref, mask, 3)
    with pytest.raises(ValueError, match="rows"):
        K.knn_topk_cuda(query, ref, mask[:8], 3)
    assert K.knn_topk_cuda.launches == before


def test_cpu_dispatch_uses_plain_version(rng):
    query, ref, mask = (torch.as_tensor(a) for a in _inputs(rng, 32, 256))
    before = K.knn_topk_cuda.launches
    idx, d2 = ticp.knn(query, ref, mask, 5)
    idx_p, d2_p = K.knn_topk_plain(query, ref, mask, 5)
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)
    assert K.knn_topk_cuda.launches == before
