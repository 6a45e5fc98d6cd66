// Brute-force k-nearest-neighbour search for the LOAM correspondence step.
//
// Replaces: mvil_fusion_tpu/ops/pallas_knn.py::knn_topk (kernel body
// _knn_kernel, pl.pallas_call at :145).  Same contract: for each of Nq
// queries, the k smallest squared distances to a masked (Nr,3) reference
// and their reference indices, ascending; masked refs never enter the
// result, empty slots return d2 = +inf and idx = 0; equal distances keep
// the lower index first (as lax.top_k does).  1 <= k <= 128.
//
// What bounds it on an H100: operations, not bytes.  The LOAM plane call
// (4096 queries x 32768 refs, k = 5) reads 48 KB + 384 KB + 32 KB and
// writes 160 KB, 0.19 us at 3.35 TB/s, but with every ref live it evaluates
// 134.2 M pairs of 8 fp32 operations each (3 subtract, 3 multiply, 2 add):
// 16.0 us at the card's 67 TFLOP/s of fp32 outside the tensor cores.  The
// edge call (256 x 16384) is 4.19 M pairs, 0.5 us.  On top of the distances
// comes the selection, which is not arithmetic but compares and moves.
// Masked refs need no distance at all, and the LOAM maps are mostly masked:
// a voxel-downsampled map keeps its live points at the front of its buffer
// (some 5,000 of 32768 surfels, 400 of 16384 corners between two submaps).
//
// No tensor cores, and why.  The matrix form d2 = q.q + r.r - 2 q.r would
// run on wgmma only in TF32 or bf16 (10 or 7 mantissa bits).  At map scale
// (coordinates up to 60 m, q.q + r.r ~ 7e3 m2) even full fp32 loses ~1e-3 m2
// of d2 to cancellation in that form, and TF32 about 4 m2: neighbours that
// differ by centimetres cannot be ranked.  So d2 is (q-r).(q-r) in fp32 on
// the CUDA cores.  A prefilter in the expanded form (3 FFMA per pair) ahead
// of the exact form was left out too: it saves at most 3 of ~9 instructions
// per pair, and its margin would have to be proven conservative for every
// input the contract allows.
//
// The design, three kernels on one stream, and what each part is for:
//
// * Skip what is masked (knn_topk_extent_kernel).  One block reads the mask
//   and writes the end of the live part of the reference, one past the last
//   unmasked point, to a scratch int.  Only [0, extent) is scanned; for a
//   reference that is live to its end nothing changes.  The host never
//   learns the extent, so nothing waits for the card.
// * Fill the card (knn_topk_scan_kernel).  The grid is (query tiles) x
//   (S slices): a block holds up to 128 queries, one per thread, and scans
//   one of S contiguous, equally long slices of the live part, which it
//   derives from the extent.  The caller picks S so that a call puts about
//   four blocks on every SM: 32 x 16 for the plane call, 2 x 64 for the
//   edge call.  A block writes its sorted partial top-k to a scratch
//   (Nq, S, k) that the caller allocates; with S = 1 it writes the result
//   itself.  More slices are not better: every slice starts with an empty
//   list and pays the k (1 + ln(n/k)) insertions of a fresh start again.
// * Merge in a last small kernel (knn_topk_merge_kernel), one warp per
//   query.  It selects k times the smallest of the query's S*k scratch
//   entries that lies after the last winner in the order (d2, scratch
//   position).  Slices are ascending index ranges and a partial list is
//   stable, so scratch position orders equal distances by reference index:
//   the merge keeps the lower index first.  It is a kernel and not a
//   thread-block cluster whose blocks read each other's shared memory:
//   a portable cluster has at most 8 blocks, the path wants 16 and 64
//   slices, and the merge kernel takes 4 to 12 us of device time (PERF.md
//   has the measurement), so a cluster could save little.
// * Break the per-candidate latency chain.  The scan takes four candidates
//   at a time: three broadcast 16-byte loads from shared memory bring four
//   points (stored as they lie in the reference, 12 bytes each), four
//   independent distances are computed branch-free, and one compare of the
//   smallest against the thread's k-th best decides whether the insertion
//   is entered at all.  The loop has no mask test: after a tile arrives,
//   one pass writes x = +inf into every masked or padding slot, so that
//   its d2 is +inf (dx = -inf, dx*dx = +inf, no NaN for a finite query)
//   and never beats the k-th best.  A NaN distance (a masked slot holding
//   NaN in y or z) compares false and is dropped likewise.
//   Two queries per thread would halve the shared-memory loads, but these
//   are 3 of ~35 instructions per group already; at the same number of
//   blocks the slices would be half as long, and a warp enters the
//   insertion whenever any of its lists takes a candidate, so twice the
//   lists per warp cost more insertions than the loads save.  Left out.
// * The list lives in registers, descending from slot 0 (the k-th best,
//   so the threshold is a fixed register) to slot k-1 (the best); slots
//   from k on hold -inf and stop the bubble.  An insertion overwrites
//   slot 0 and bubbles the new entry up while it is strictly smaller, so a
//   later candidate never overtakes an equal earlier one.  The loop is
//   unrolled over a compile-time K in {5, 10, 32}: the path's k = 5 and
//   k = 10 get lists of exactly their size.  For k > 32 (K = 128, not on
//   the path) registers do not hold the list: it is a max-heap on
//   (d2, index) in local memory, indexed dynamically.
// * Keep loads in flight.  Reference tiles of 512 points are double
//   buffered in shared memory: cp.async copies tile i+1 (16 bytes a
//   thread, coalesced; points and mask bytes) while the block scans
//   tile i.  Slices start at multiples of 16 points, which keeps every
//   16-byte copy aligned.
//
// Built by mvil_fusion_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes: a plain C entry point that launches on the
// given stream, never synchronises, allocates nothing, and returns the
// cudaError_t of its launches.

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockQueries = 128; // queries per block, one per thread
constexpr int kTile = 512;         // reference points per shared-memory tile
constexpr int kExtentThreads = 1024;
constexpr int kAlign = 16;         // slices start at multiples of this
constexpr int kRegisterK = 32;     // lists up to this size live in registers
constexpr unsigned kFullWarp = 0xffffffffu;

struct __align__(16) Tile {
  float xyz[3 * kTile];     // points as in the reference, 12 bytes each
  uint8_t valid[kTile];     // the mask bytes of the same points
};

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start the copy of reference points [base, base + n) and their mask bytes
// into `tile`.  base is a multiple of 16 and both pointers are 16-byte
// aligned, so the 16-byte copies are aligned; what is left of the last
// tile of the reference (under 16 bytes of each) goes by plain loads.
__device__ __forceinline__ void start_tile_copy(Tile& tile,
                                           const float* __restrict__ ref,
                                           const uint8_t* __restrict__ mask,
                                           int base, int n) {
  const int tid = threadIdx.x, nthreads = kBlockQueries;
  const float* gx = ref + 3 * static_cast<size_t>(base);
  const int xchunks = (3 * n) >> 2;            // 16-byte chunks of 4 floats
  for (int c = tid; c < xchunks; c += nthreads)
    cp_async_16(tile.xyz + 4 * c, gx + 4 * c);
  for (int w = 4 * xchunks + tid; w < 3 * n; w += nthreads)
    tile.xyz[w] = gx[w];
  const uint8_t* gm = mask + base;
  const int mchunks = n >> 4;
  for (int c = tid; c < mchunks; c += nthreads)
    cp_async_16(tile.valid + 16 * c, gm + 16 * c);
  for (int b = 16 * mchunks + tid; b < n; b += nthreads)
    tile.valid[b] = gm[b];
}

__device__ __forceinline__ float dist2(float qx, float qy, float qz,
                                       float rx, float ry, float rz) {
  const float dx = qx - rx, dy = qy - ry, dz = qz - rz;
  return dx * dx + dy * dy + dz * dz;
}

// The k best so far; slot 0 is the k-th best, the threshold.  Up to
// kRegisterK entries it is a list in registers, descending from slot 0 to
// the best in slot k-1.  Above that it is a max-heap in local memory on
// the order (d2, index): its root is the k-th best too, an insertion takes
// log2(k) steps instead of k, and the order being total, equal distances
// leave the heap by index.
template <int K>
struct TopK {
  float d[K];
  int i[K];

  __device__ __forceinline__ void init(int k, bool active) {
    if constexpr (K <= kRegisterK) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        d[j] = (active && j < k) ? CUDART_INF_F : -CUDART_INF_F;
        i[j] = 0;
      }
    } else {
      for (int j = 0; j < k; ++j) {
        d[j] = active ? CUDART_INF_F : -CUDART_INF_F;
        i[j] = 0;
      }
    }
  }

  // Heap only: put (cd, ci) in place of the root of the first n slots and
  // let it sink below every larger child.
  __device__ __forceinline__ void sink(float cd, int ci, int n) {
    int j = 0;
    for (int c = 1; c < n; c = 2 * j + 1) {
      if (c + 1 < n && (d[c + 1] > d[c] ||
                        (d[c + 1] == d[c] && i[c + 1] > i[c])))
        ++c;
      if (!(d[c] > cd || (d[c] == cd && i[c] > ci))) break;
      d[j] = d[c];
      i[j] = i[c];
      j = c;
    }
    d[j] = cd;
    i[j] = ci;
  }

  // Requires cd < d[0]: the new entry replaces the k-th best.  In the list
  // it bubbles towards the best while it is strictly smaller, so a later
  // candidate never overtakes an equal earlier one.
  __device__ __forceinline__ void insert(float cd, int ci, int k) {
    if constexpr (K <= kRegisterK) {
      d[0] = cd;
      i[0] = ci;
#pragma unroll
      for (int j = 0; j + 1 < K; ++j) {
        const bool up = d[j] < d[j + 1];   // never true into a -inf slot
        const float dlo = up ? d[j] : d[j + 1];
        const float dhi = up ? d[j + 1] : d[j];
        const int ilo = up ? i[j] : i[j + 1];
        const int ihi = up ? i[j + 1] : i[j];
        d[j] = dhi;
        i[j] = ihi;
        d[j + 1] = dlo;
        i[j + 1] = ilo;
      }
    } else {
      sink(cd, ci, k);
    }
  }

  // Ascending into out_*[0..k).  Empties the heap.
  __device__ __forceinline__ void store(float* out_d2, int* out_idx, int k) {
    if constexpr (K <= kRegisterK) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (j < k) {
          out_d2[k - 1 - j] = d[j];
          out_idx[k - 1 - j] = i[j];
        }
      }
    } else {
      for (int n = k - 1; n >= 0; --n) {   // the largest of n + 1 leaves
        out_d2[n] = d[0];
        out_idx[n] = i[0];
        sink(d[n], i[n], n);
      }
    }
  }
};

// One block: *extent = the end of the live part of the reference, that is
// one past the last unmasked point, rounded up to a multiple of 16 (0 if
// every point is masked).  mask is 16-byte aligned.
__global__ void __launch_bounds__(kExtentThreads)
knn_topk_extent_kernel(const uint8_t* __restrict__ mask, int nr,
                       int* __restrict__ extent) {
  __shared__ int warp_end[kExtentThreads / 32];
  const int tid = threadIdx.x;
  const int nchunks = nr >> 4;
  const uint4* chunks = reinterpret_cast<const uint4*>(mask);
  int end = 0;
  for (int c = tid; c < nchunks; c += kExtentThreads) {
    const uint4 v = chunks[c];
    if (v.x | v.y | v.z | v.w) end = 16 * c + 16;
  }
  for (int b = 16 * nchunks + tid; b < nr; b += kExtentThreads)
    if (mask[b]) end = 16 * nchunks + 16;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    end = max(end, __shfl_xor_sync(kFullWarp, end, off));
  if ((tid & 31) == 0) warp_end[tid >> 5] = end;
  __syncthreads();
  if (tid < 32) {
    end = warp_end[tid];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      end = max(end, __shfl_xor_sync(kFullWarp, end, off));
    if (tid == 0) *extent = end;
  }
}

// Block (x, y) scans slice y of the live part of the reference for the
// queries of tile x and writes each query's sorted partial top-k to
// part_*[(q * S + y) * k ...].  The live part [0, *extent) is cut into S
// slices of equal length, a multiple of 16; the last ones may be empty.
template <int K>
__global__ void __launch_bounds__(kBlockQueries)
knn_topk_scan_kernel(const float* __restrict__ query,
                     const float* __restrict__ ref,
                     const uint8_t* __restrict__ ref_mask,
                     const int* __restrict__ extent,
                     int nq, int nr, int k,
                     float* __restrict__ part_d2,
                     int* __restrict__ part_idx) {
  __shared__ Tile tiles[2];

  const int tid = threadIdx.x, nthreads = kBlockQueries;
  const int split = blockIdx.y, nsplits = gridDim.y;
  const int live_end = min(nr, *extent);
  const int split_len =
      (((live_end + nsplits - 1) / nsplits + kAlign - 1) / kAlign) * kAlign;
  const int lo = split * split_len;
  const int len = max(0, min(live_end, lo + split_len) - lo);
  const int ntiles = (len + kTile - 1) / kTile;

  const int qi = blockIdx.x * nthreads + tid;
  const bool active = qi < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[3 * static_cast<size_t>(qi) + 0];
    qy = query[3 * static_cast<size_t>(qi) + 1];
    qz = query[3 * static_cast<size_t>(qi) + 2];
  }
  TopK<K> best;
  best.init(k, active);      // an idle thread's list is -inf: nothing enters

  if (ntiles > 0) start_tile_copy(tiles[0], ref, ref_mask, lo, min(kTile, len));
  cp_async_commit();

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int off = (t + 1) * kTile;
      start_tile_copy(tiles[(t + 1) & 1], ref, ref_mask, lo + off,
                 min(kTile, len - off));
    }
    cp_async_commit();       // one group per turn, empty at the last
    cp_async_wait<1>();      // all but the newest group: tile t is here
    __syncthreads();

    Tile& tile = tiles[t & 1];
    const int n = min(kTile, len - t * kTile);
    const int ngroups = (n + 3) >> 2;
    // masked points and the padding of the last group of four: x = +inf
    for (int p = tid; p < 4 * ngroups; p += nthreads) {
      if (p >= n) {
        tile.xyz[3 * p + 0] = CUDART_INF_F;
        tile.xyz[3 * p + 1] = 0.f;
        tile.xyz[3 * p + 2] = 0.f;
      } else if (!tile.valid[p]) {
        tile.xyz[3 * p + 0] = CUDART_INF_F;
      }
    }
    __syncthreads();

    const float4* pts = reinterpret_cast<const float4*>(tile.xyz);
    const int cbase = lo + t * kTile;
#pragma unroll 2
    for (int g = 0; g < ngroups; ++g) {
      const float4 a = pts[3 * g + 0];
      const float4 b = pts[3 * g + 1];
      const float4 c = pts[3 * g + 2];
      const float d0 = dist2(qx, qy, qz, a.x, a.y, a.z);
      const float d1 = dist2(qx, qy, qz, a.w, b.x, b.y);
      const float d2 = dist2(qx, qy, qz, b.z, b.w, c.x);
      const float d3 = dist2(qx, qy, qz, c.y, c.z, c.w);
      const float nearest = fminf(fminf(d0, d1), fminf(d2, d3));
      if (nearest < best.d[0]) {
        // strict <: on equal distances the earlier (lower) index stays
        const int c0 = cbase + 4 * g;
        if (d0 < best.d[0]) best.insert(d0, c0 + 0, k);
        if (d1 < best.d[0]) best.insert(d1, c0 + 1, k);
        if (d2 < best.d[0]) best.insert(d2, c0 + 2, k);
        if (d3 < best.d[0]) best.insert(d3, c0 + 3, k);
      }
    }
    __syncthreads();         // tile t's buffer is free for tile t + 2
  }

  if (active) {
    const size_t at = (static_cast<size_t>(qi) * nsplits + split) * k;
    best.store(part_d2 + at, part_idx + at, k);
  }
}

// One warp per query: the k first of its n = S*k scratch entries in the
// order (d2, scratch position).  Round r takes the smallest entry that
// lies after round r-1's winner; nothing is stored between rounds but the
// winners, which lane r % 32 keeps until 32 of them are written at once.
__global__ void __launch_bounds__(kBlockQueries)
knn_topk_merge_kernel(const float* __restrict__ part_d2,
                      const int* __restrict__ part_idx,
                      int nq, int n, int k,
                      float* __restrict__ out_d2,
                      int* __restrict__ out_idx) {
  const int lane = threadIdx.x & 31;
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (q >= nq) return;       // the whole warp leaves together
  const float* pd = part_d2 + static_cast<size_t>(q) * n;
  const int* pi = part_idx + static_cast<size_t>(q) * n;

  float last_d = -CUDART_INF_F, keep_d = CUDART_INF_F;
  int last_p = -1, keep_p = INT_MAX;
  for (int r = 0; r < k; ++r) {
    float best_d = CUDART_INF_F;
    int best_p = INT_MAX;
    for (int p = lane; p < n; p += 32) {
      const float d = pd[p];
      const bool after = d > last_d || (d == last_d && p > last_p);
      const bool better = d < best_d || (d == best_d && p < best_p);
      if (after && better) {
        best_d = d;
        best_p = p;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFullWarp, best_d, off);
      const int op = __shfl_xor_sync(kFullWarp, best_p, off);
      if (od < best_d || (od == best_d && op < best_p)) {
        best_d = od;
        best_p = op;
      }
    }
    if (lane == (r & 31)) {
      keep_d = best_d;
      keep_p = best_p;
    }
    last_d = best_d;
    last_p = best_p;
    if ((r & 31) == 31 || r == k - 1) {
      const int slot = (r & ~31) + lane;     // this lane's round
      if (slot <= r) {
        const bool found = keep_p < n && keep_d < CUDART_INF_F;
        const size_t at = static_cast<size_t>(q) * k + slot;
        out_d2[at] = found ? keep_d : CUDART_INF_F;
        out_idx[at] = found ? pi[keep_p] : 0;
      }
    }
  }
}

template <int K>
void launch_scan(const float* query, const float* ref,
                 const uint8_t* ref_mask, const int* extent, int nq, int nr,
                 int k, int nsplits, float* part_d2, int* part_idx,
                 cudaStream_t stream) {
  const dim3 grid((nq + kBlockQueries - 1) / kBlockQueries, nsplits);
  knn_topk_scan_kernel<K><<<grid, kBlockQueries, 0, stream>>>(
      query, ref, ref_mask, extent, nq, nr, k, part_d2, part_idx);
}

}  // namespace

// query (nq,3) f32, ref (nr,3) f32, ref_mask (nr,) bool as bytes, all
// contiguous on the device, ref and ref_mask 16-byte aligned; out_d2 (nq,k)
// f32 and out_idx (nq,k) int32.  The live part of the reference is cut into
// nsplits slices.  extent is scratch of one int; with nsplits > 1, part_d2
// and part_idx are scratch of nq * nsplits * k elements, with nsplits = 1
// they are not read.  Returns 0 or the cudaError_t of the launch that failed.
extern "C" int knn_topk_launch(const float* query, const float* ref,
                               const uint8_t* ref_mask, int nq, int nr, int k,
                               int nsplits, int* extent,
                               float* part_d2, int* part_idx, float* out_d2,
                               int* out_idx, void* stream) {
  if (k < 1 || k > 128 || nq < 0 || nr < 0 || nsplits < 1 || nsplits > 65535)
    return (int)cudaErrorInvalidValue;
  if (nr > 0 && ((reinterpret_cast<uintptr_t>(ref) & 15) ||
                 (reinterpret_cast<uintptr_t>(ref_mask) & 15)))
    return (int)cudaErrorMisalignedAddress;
  if (nq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  knn_topk_extent_kernel<<<1, kExtentThreads, 0, s>>>(ref_mask, nr, extent);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* pd = nsplits > 1 ? part_d2 : out_d2;
  int* pi = nsplits > 1 ? part_idx : out_idx;
  if (k <= 5) {
    launch_scan<5>(query, ref, ref_mask, extent, nq, nr, k, nsplits, pd, pi,
                   s);
  } else if (k <= 10) {
    launch_scan<10>(query, ref, ref_mask, extent, nq, nr, k, nsplits, pd, pi,
                    s);
  } else if (k <= kRegisterK) {
    launch_scan<kRegisterK>(query, ref, ref_mask, extent, nq, nr, k, nsplits,
                            pd, pi, s);
  } else {
    launch_scan<128>(query, ref, ref_mask, extent, nq, nr, k, nsplits, pd,
                     pi, s);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplits == 1) return (int)err;
  const int warps_per_block = kBlockQueries / 32;
  const int blocks = (nq + warps_per_block - 1) / warps_per_block;
  knn_topk_merge_kernel<<<blocks, kBlockQueries, 0, s>>>(
      part_d2, part_idx, nq, nsplits * k, k, out_d2, out_idx);
  return (int)cudaGetLastError();
}
