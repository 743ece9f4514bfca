// Brute-force Hamming kNN-2 (best, d1, d2) for Hopper (sm_90a).
//
// Replaces: orbslam3lib_tpu/ops/pallas_matcher.py::knn_match_fused (Pallas
// body _knn2_kernel), reached on the tracker's reference-keyframe fallback
// (tracking/reloc.py track_reference_kf -> tracking/matching.py
// match_descriptors_ratio) and, off this slice, from loop closing and
// relocalisation.
//
// Contract (oracle: ops/matcher.py knn_match), bit-exact: for 0/1 bit rows
// a (Na, 256) and b (Nb, 256), d[i, j] = popcount(a_i ^ b_j) + BIG where
// b_j is invalid; per row best = argmin_j d (lowest j on ties), d1 = d[best],
// d2 = min(min_{j != best} d[i, j], d1 + BIG); invalid a rows get BIG added
// to d1 and d2 afterwards. Everything is integer, returned as f32.
//
// The TPU kernel computes popcount as the int8 MXU product sa + sb - 2 a.b.
// Hopper has a popcount instruction, so the natural form here packs each
// 256-bit descriptor into 8 uint32 words (knn_pack_kernel) and sums
// __popc(a ^ b) over the words: 8 XOR + 8 POPC per pair instead of a
// 256-deep product. The TPU's packed (dist << 14 | col) argmin key, and its
// nb < 2^14 limit, are not needed: the running minimum keeps the column.
//
// What bounds it on the card: at the main-path shape (512 x 512) the whole
// problem is 2 M popcounts on 32 KB of packed descriptors; it is latency-
// bound (launch, one pass over B per row group), not bandwidth- or
// compute-bound.
//
// What the design does about it: each block owns ROWS A rows, one per warp,
// held in registers; B streams through shared memory in CHUNK-column
// chunks (16-byte loads); each lane keeps a running (d1, best, d2) over its
// columns, in increasing column order, and a warp shuffle reduction merges
// the lanes with the lower column winning ties. The distance matrix never
// exists in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 8;         // 256 bits = 8 x uint32
constexpr int ROWS = 4;          // A rows per block (one per warp)
constexpr int CHUNK = 1024;      // B columns staged per pass (32 KB)
constexpr int BIGI = 4096;       // masks.BIG
constexpr int INF = 0x3fffffff;

// (N, 256) int8 0/1 -> (N, 8) uint32, bit i of word w = bit 32w + i
__global__ void knn_pack_kernel(const int8_t* __restrict__ bits,
                                uint32_t* __restrict__ packed, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * WORDS) return;
  const int8_t* p = bits + (size_t)t * 32;
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) w |= (uint32_t)(p[i] != 0) << i;
  packed[t] = w;
}

// keep (d1, best, d2) with d2 = min over columns other than best
__device__ __forceinline__ void merge(int& d1, int& best, int& d2,
                                      int o_d1, int o_best, int o_d2) {
  const bool other_wins = (o_d1 < d1) || (o_d1 == d1 && o_best < best);
  if (other_wins) {
    d2 = min(o_d2, d1);
    d1 = o_d1;
    best = o_best;
  } else {
    d2 = min(d2, o_d1);
  }
}

__global__ void __launch_bounds__(ROWS * 32)
knn2_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
            const uint8_t* __restrict__ a_valid,
            const uint8_t* __restrict__ b_valid, int na, int nb,
            int32_t* __restrict__ best_out, float* __restrict__ d1_out,
            float* __restrict__ d2_out) {
  __shared__ uint4 s_b[CHUNK][2];          // 8 words per column
  __shared__ uint8_t s_bv[CHUNK];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + warp;
  const bool live = row < na;

  uint32_t ar[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) ar[w] = live ? a[(size_t)row * WORDS + w] : 0u;

  int d1 = INF, best = INF, d2 = INF;
  for (int c0 = 0; c0 < nb; c0 += CHUNK) {
    const int n = min(CHUNK, nb - c0);
    const uint4* bsrc = reinterpret_cast<const uint4*>(b + (size_t)c0 * WORDS);
    for (int i = threadIdx.x; i < 2 * n; i += blockDim.x)
      s_b[i >> 1][i & 1] = bsrc[i];
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      s_bv[i] = b_valid ? b_valid[c0 + i] : (uint8_t)1;
    __syncthreads();
    if (live) {
      for (int j = lane; j < n; j += 32) {
        const uint4 lo = s_b[j][0], hi = s_b[j][1];
        int d = __popc(ar[0] ^ lo.x) + __popc(ar[1] ^ lo.y) +
                __popc(ar[2] ^ lo.z) + __popc(ar[3] ^ lo.w) +
                __popc(ar[4] ^ hi.x) + __popc(ar[5] ^ hi.y) +
                __popc(ar[6] ^ hi.z) + __popc(ar[7] ^ hi.w);
        if (!s_bv[j]) d += BIGI;
        // columns arrive in increasing order within a lane: a tie with d1
        // keeps the earlier column and only lowers d2
        if (d < d1) {
          d2 = d1;
          d1 = d;
          best = c0 + j;
        } else {
          d2 = min(d2, d);
        }
      }
    }
    __syncthreads();
  }

  // merge the 32 lanes' partial results, lower column winning ties
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int o_d1 = __shfl_down_sync(0xffffffffu, d1, off);
    const int o_best = __shfl_down_sync(0xffffffffu, best, off);
    const int o_d2 = __shfl_down_sync(0xffffffffu, d2, off);
    merge(d1, best, d2, o_d1, o_best, o_d2);
  }
  if (live && lane == 0) {
    d2 = min(d2, d1 + BIGI);     // a lone column: the plain version's d1 + BIG
    float f1 = (float)d1, f2 = (float)d2;
    if (a_valid && !a_valid[row]) {
      f1 += (float)BIGI;
      f2 += (float)BIGI;
    }
    best_out[row] = best;
    d1_out[row] = f1;
    d2_out[row] = f2;
  }
}

}  // namespace

// a_bits (na, 256) / b_bits (nb, 256) int8 0/1; a_valid / b_valid (n,) uint8
// or null; a_packed (na, 8) / b_packed (nb, 8) uint32 scratch (16-byte
// aligned); outputs best (na,) int32, d1/d2 (na,) f32. Requires na, nb >= 1.
// Returns the cudaError_t of the launches (0 = launched).
extern "C" int knn2_launch(const void* a_bits, const void* b_bits,
                           const void* a_valid, const void* b_valid,
                           void* a_packed, void* b_packed, int na, int nb,
                           void* best, void* d1, void* d2, void* stream) {
  if (na <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  knn_pack_kernel<<<(na * WORDS + threads - 1) / threads, threads, 0, s>>>(
      (const int8_t*)a_bits, (uint32_t*)a_packed, na);
  knn_pack_kernel<<<(nb * WORDS + threads - 1) / threads, threads, 0, s>>>(
      (const int8_t*)b_bits, (uint32_t*)b_packed, nb);
  knn2_kernel<<<(na + ROWS - 1) / ROWS, ROWS * 32, 0, s>>>(
      (const uint32_t*)a_packed, (const uint32_t*)b_packed,
      (const uint8_t*)a_valid, (const uint8_t*)b_valid, na, nb,
      (int32_t*)best, (float*)d1, (float*)d2);
  return (int)cudaGetLastError();
}
