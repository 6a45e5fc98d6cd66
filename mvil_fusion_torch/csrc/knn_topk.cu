// Brute-force k-nearest-neighbour search for the LOAM correspondence step.
//
// Replaces: mvil_fusion_tpu/ops/pallas_knn.py::knn_topk (kernel body
// _knn_kernel, pl.pallas_call at :145).  Same contract: for each of Nq
// queries, the k smallest squared distances to a masked (Nr,3) reference
// and their reference indices; masked refs never enter the result, empty
// slots return d2 = +inf and idx = 0; equal distances keep the lower index
// first (as lax.top_k does).  1 <= k <= 128.
//
// What bounds it on an H100: not bytes.  A 4096 x 32768 call reads 0.5 MB
// of reference per query block (from L2 after the first block) and writes
// 4096*k results, but does 134 M distance evaluations and, for each, a
// compare against the running k-th best.  The work is selection per query
// times Nr, done in fp32 on the CUDA cores.
//
// What the design does about that: one thread owns one query and keeps
// its sorted top-k list in registers (the insertion loop is unrolled over
// a compile-time bound K_MAX, so the list is never indexed dynamically).
// A block of 128 queries streams the reference through shared memory in
// tiles of 1024 float4 = (x, y, z, valid); every thread of the block reads
// the same tile element at once, which shared memory broadcasts.  The
// common case, a candidate farther than the current k-th best, costs a
// distance and one compare.  The distance is (q-r).(q-r) in fp32, with no
// tensor cores: the TPU kernel's homogeneous-coordinate matmul, its 128-lane
// padding, pooled score concatenation and arithmetic index recovery exist
// only for the TPU's matrix unit and Mosaic compiler, and are not carried
// over.  Known limits, left for later work: Nq/128 blocks fill only 32 of
// 132 SMs at 4096 queries (2 at 256), and K_MAX = 128 spills the list to
// local memory.
//
// Built by mvil_fusion_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes: a plain C entry point that launches on the
// given stream and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockQueries = 128;
constexpr int kTile = 1024;

template <int K_MAX>
__global__ void __launch_bounds__(kBlockQueries)
knn_topk_kernel(const float* __restrict__ query,
                const float* __restrict__ ref,
                const uint8_t* __restrict__ ref_mask,
                int nq, int nr, int k,
                float* __restrict__ out_d2,
                int* __restrict__ out_idx) {
  __shared__ float4 tile[kTile];

  const int qi = blockIdx.x * kBlockQueries + threadIdx.x;
  const bool active = qi < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[3 * qi + 0];
    qy = query[3 * qi + 1];
    qz = query[3 * qi + 2];
  }

  float bd[K_MAX];
  int bi[K_MAX];
#pragma unroll
  for (int j = 0; j < K_MAX; ++j) {
    bd[j] = CUDART_INF_F;
    bi[j] = 0;
  }
  float worst = CUDART_INF_F;  // bd[k-1], kept apart to avoid a dynamic index

  for (int base = 0; base < nr; base += kTile) {
    const int n_here = min(kTile, nr - base);
    for (int t = threadIdx.x; t < kTile; t += kBlockQueries) {
      const int r = base + t;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < n_here) {
        v.x = ref[3 * r + 0];
        v.y = ref[3 * r + 1];
        v.z = ref[3 * r + 2];
        v.w = ref_mask[r] ? 1.f : 0.f;
      }
      tile[t] = v;
    }
    __syncthreads();

    if (active) {
      for (int t = 0; t < n_here; ++t) {
        const float4 r = tile[t];
        const float dx = qx - r.x;
        const float dy = qy - r.y;
        const float dz = qz - r.z;
        const float d = dx * dx + dy * dy + dz * dz;
        // strict <: on equal distances the earlier (lower) index stays
        if (r.w != 0.f && d < worst) {
          // insert before the first strictly larger entry, then shift the
          // rest right by one (a carried entry never overtakes an equal one)
          float cd = d;
          int ci = base + t;
          bool shifting = false;
#pragma unroll
          for (int j = 0; j < K_MAX; ++j) {
            if (j < k && (shifting || cd < bd[j])) {
              shifting = true;
              const float td = bd[j];
              const int ti = bi[j];
              bd[j] = cd;
              bi[j] = ci;
              cd = td;
              ci = ti;
            }
            if (j == k - 1) worst = bd[j];
          }
        }
      }
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int j = 0; j < K_MAX; ++j) {
      if (j < k) {
        out_d2[(size_t)qi * k + j] = bd[j];
        out_idx[(size_t)qi * k + j] = bi[j];
      }
    }
  }
}

template <int K_MAX>
void launch(const float* query, const float* ref, const uint8_t* ref_mask,
            int nq, int nr, int k, float* out_d2, int* out_idx,
            cudaStream_t stream) {
  const int blocks = (nq + kBlockQueries - 1) / kBlockQueries;
  knn_topk_kernel<K_MAX><<<blocks, kBlockQueries, 0, stream>>>(
      query, ref, ref_mask, nq, nr, k, out_d2, out_idx);
}

}  // namespace

// query (nq,3) f32, ref (nr,3) f32, ref_mask (nr,) bool as bytes, all
// contiguous on the device; out_d2 (nq,k) f32 and out_idx (nq,k) int32.
// Returns 0 or the cudaError_t of the launch.
extern "C" int knn_topk_launch(const float* query, const float* ref,
                               const uint8_t* ref_mask, int nq, int nr, int k,
                               float* out_d2, int* out_idx, void* stream) {
  if (k < 1 || k > 128 || nq < 0 || nr < 0) return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8) {
    launch<8>(query, ref, ref_mask, nq, nr, k, out_d2, out_idx, s);
  } else if (k <= 16) {
    launch<16>(query, ref, ref_mask, nq, nr, k, out_d2, out_idx, s);
  } else if (k <= 32) {
    launch<32>(query, ref, ref_mask, nq, nr, k, out_d2, out_idx, s);
  } else {
    launch<128>(query, ref, ref_mask, nq, nr, k, out_d2, out_idx, s);
  }
  return (int)cudaGetLastError();
}
