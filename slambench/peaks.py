"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit) and the least time of the k-NN kernel.

``knn_bound_s`` is ``chip_smoke.py::knn_bound_ms``'s arithmetic: the
larger of the bytes over the memory's rate and the operations over the
float32 rate outside the tensor cores."""

PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12


def knn_bound_s(nq: int, nr: int, k: int, live: int) -> float:
    """The least seconds one k-NN call could take.  Bytes: query,
    reference and mask read once, index and d2 written once.  Operations:
    8 float32 (3 subtract, 3 multiply, 2 add) for each pair of a query and
    one of the `live` unmasked references, as the work depends on the
    data."""
    by = (12 * nq + 13 * nr + 8 * nq * k) / PEAK_BYTES_S
    op = 8 * nq * live / PEAK_FP32_S
    return max(by, op)
