// Brute-force Hamming kNN-2 (best, d1, d2) for Hopper (sm_90a), in one
// launch with no scratch memory.
//
// Replaces: orbslam3lib_tpu/ops/pallas_matcher.py::knn_match_fused (Pallas
// body _knn2_kernel), reached through tracking/matching.py
// match_descriptors_ratio: the loop probe's BoW-match count, loop
// verification, relocalisation and the tracker's reference-keyframe
// fallback.
//
// Contract (oracle: ops/matcher.py knn_match), bit-exact: for 0/1 bit rows
// a (Na, 256) and b (Nb, 256), d[i, j] = popcount(a_i ^ b_j) + BIG where
// b_j is invalid; per row best = argmin_j d (lowest j on ties), d1 = d[best],
// d2 = min(min_{j != best} d[i, j], d1 + BIG); invalid a rows get BIG added
// to d1 and d2 afterwards. Everything is integer, returned as f32. There is
// no limit on Nb (the TPU's packed (dist << 14 | col) key, and its
// nb < 2^14 limit, are not needed: the running minimum keeps the column).
//
// The TPU kernel computes popcount as the int8 MXU product sa + sb - 2 a.b.
// Hopper has a popcount instruction: each 256-bit descriptor becomes 8
// uint32 words and d = sum of __popc(a ^ b) over them.
//
// What bounds it on the card: at the main path's 512 x 512 the function is
// 262,144 pairs x 8 words (2.1 M XOR + POPC + ADD, ~26 integer operations
// per pair: 0.10 us at 67 TOP/s; POPC alone issues 16 per clock per SM,
// 0.5 us) on 262 KB of int8 bits (0.08 us at 3.35 TB/s). Both are below one
// launch's latency (a few microseconds), which is this kernel's floor.
//
// What the design does about it:
// - One launch per call, no scratch: the int8 bits are packed inside the
//   kernel, A rows into shared memory then registers, B in chunks of CHUNK
//   columns into shared memory. A lane loads 16 bytes (two rows per warp
//   instruction), folds them to a 16-bit mask with two carry-free integer
//   tricks, and one shuffle joins two lanes' masks into a word. A base
//   that is not 16-byte aligned takes byte loads instead.
// - Every block needs all of B, packed. Blocks run in clusters of CLUSTER
//   (Hopper's thread block clusters): each block packs 1/CLUSTER of a chunk
//   and copies the other slices from its peers' shared memory (distributed
//   shared memory), so a chunk's 128 KB of int8 bits are read from device
//   memory once per cluster instead of once per block, and packed once.
// - 8 A rows per block, 8 warps: 2 groups of 4 rows x 4 groups of columns.
//   Each warp holds its 4 rows (32 words) in registers, so every B column
//   read from shared memory is XORed against 4 rows; the 4 column groups
//   split each chunk, so 512 rows give 64 blocks of 8 warps across the card.
// - Each lane keeps a running (d1, best, d2) per row over its columns in
//   increasing order; lanes merge by shuffles and column groups through
//   shared memory, the lower column winning ties at every step. The
//   distance matrix never exists in device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BYTES = 256;                   // bits per descriptor, one byte each
constexpr int WORDS = 8;                     // 256 bits = 8 x uint32
constexpr int ROWS_PER_WARP = 4;             // A rows held in registers by a warp
constexpr int ROW_GROUPS = 2;                // warps over A rows
constexpr int COL_GROUPS = 4;                // warps over B columns
constexpr int WARPS = ROW_GROUPS * COL_GROUPS;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = ROW_GROUPS * ROWS_PER_WARP;   // A rows per block (8)
constexpr int CHUNK = 512;                   // B columns staged per pass (16 KB)
constexpr int CLUSTER = 8;                   // blocks that share a chunk's packing
constexpr int SLICE = CHUNK / CLUSTER;       // B columns packed by each block
constexpr int BIGI = 4096;                   // masks.BIG
constexpr int INF = 0x3fffffff;

// bit j of the result is set where byte j of w is non-zero
__device__ __forceinline__ uint32_t nonzero_nibble(uint32_t w) {
  // bit 7 of a byte set iff the byte is non-zero (no carry leaves a byte)
  const uint32_t t = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  // bits 7, 15, 23, 31 to bits 28..31: the partial products of the
  // multiplication land on distinct bits, so nothing carries into the top
  return (t * 0x00204081u) >> 28;
}

// 16 bytes of bits -> 16-bit mask, bit i = (byte i != 0)
__device__ __forceinline__ uint32_t mask16(const int8_t* p, bool aligned) {
  uint4 v;
  if (aligned) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    const uint8_t* q = reinterpret_cast<const uint8_t*>(p);
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (uint32_t)__ldg(q + 4 * k) | (uint32_t)__ldg(q + 4 * k + 1) << 8 |
             (uint32_t)__ldg(q + 4 * k + 2) << 16 | (uint32_t)__ldg(q + 4 * k + 3) << 24;
    v = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return nonzero_nibble(v.x) | nonzero_nibble(v.y) << 4 |
         nonzero_nibble(v.z) << 8 | nonzero_nibble(v.w) << 12;
}

// rows [0, n) of (., 256) int8 bits -> dst[r][w], bit i of word w = bit
// 32w + i. Called by every thread of the block: a warp packs two rows per
// step, a lane 16 bytes of one of them.
__device__ __forceinline__ void pack_rows(const int8_t* __restrict__ bits, int n,
                                          bool aligned, uint32_t (*dst)[WORDS]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = lane & 15;                  // 16-byte piece of the row
#pragma unroll 4
  for (int r0 = 2 * warp; r0 < n; r0 += 2 * WARPS) {
    const int r = r0 + (lane >> 4);
    const uint32_t m = r < n ? mask16(bits + (size_t)r * BYTES + part * 16, aligned) : 0u;
    const uint32_t hi = __shfl_down_sync(0xffffffffu, m, 1);
    if (r < n && !(part & 1)) dst[r][part >> 1] = m | (hi << 16);
  }
}

// keep (d1, best, d2) with d2 = min over columns other than best; the two
// sides hold disjoint columns, and the lower column wins a tie
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

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
knn2_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
            const uint8_t* __restrict__ a_valid,
            const uint8_t* __restrict__ b_valid, int na, int nb,
            bool a_aligned, bool b_aligned, int32_t* __restrict__ best_out,
            float* __restrict__ d1_out, float* __restrict__ d2_out) {
  __shared__ __align__(16) uint32_t s_a[ROWS][WORDS];
  __shared__ __align__(16) uint32_t s_b[CHUNK][WORDS];
  __shared__ uint8_t s_bv[CHUNK];
  __shared__ int s_part[ROWS][COL_GROUPS][3];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / COL_GROUPS, col_group = warp - rg * COL_GROUPS;
  const int row0 = blockIdx.x * ROWS;
  const int n_rows = max(0, min(ROWS, na - row0));   // 0 in a cluster's padding

  pack_rows(a + (size_t)row0 * BYTES, n_rows, a_aligned, s_a);

  uint32_t ar[ROWS_PER_WARP][WORDS];
  int d1[ROWS_PER_WARP], best[ROWS_PER_WARP], d2[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) d1[i] = best[i] = d2[i] = INF;

  for (int c0 = 0; c0 < nb; c0 += CHUNK) {
    const int n = min(CHUNK, nb - c0);
    // this block's slice of the chunk, then the peers' slices
    const int s0 = rank * SLICE;
    pack_rows(b + (size_t)(c0 + s0) * BYTES, max(0, min(SLICE, n - s0)), b_aligned,
              s_b + s0);
    for (int i = threadIdx.x; i < n; i += THREADS)
      s_bv[i] = b_valid ? b_valid[c0 + i] : (uint8_t)1;
    cluster.sync();                  // every slice of the chunk is packed
    constexpr int SLICE_U4 = SLICE * WORDS / 4;
    for (int i = threadIdx.x; i < (CLUSTER - 1) * SLICE_U4; i += THREADS) {
      const int peer = (rank + 1 + i / SLICE_U4) % CLUSTER;
      if (peer * SLICE >= n) continue;
      const uint4* src = reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(&s_b[peer * SLICE][0], peer));
      reinterpret_cast<uint4*>(&s_b[peer * SLICE][0])[i % SLICE_U4] = src[i % SLICE_U4];
    }
    cluster.sync();                  // copies done: a peer may repack its slice
    if (c0 == 0) {
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int r = rg * ROWS_PER_WARP + i;
#pragma unroll
        for (int w = 0; w < WORDS; ++w) ar[i][w] = r < n_rows ? s_a[r][w] : 0u;
      }
    }
    // columns in increasing order within a lane: a tie with d1 keeps the
    // earlier column and only lowers d2
    for (int j = col_group * 32 + lane; j < n; j += COL_GROUPS * 32) {
      const uint4 lo = reinterpret_cast<const uint4*>(s_b[j])[0];
      const uint4 hi = reinterpret_cast<const uint4*>(s_b[j])[1];
      const int big = s_bv[j] ? 0 : BIGI;
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int d = __popc(ar[i][0] ^ lo.x) + __popc(ar[i][1] ^ lo.y) +
                      __popc(ar[i][2] ^ lo.z) + __popc(ar[i][3] ^ lo.w) +
                      __popc(ar[i][4] ^ hi.x) + __popc(ar[i][5] ^ hi.y) +
                      __popc(ar[i][6] ^ hi.z) + __popc(ar[i][7] ^ hi.w) + big;
        if (d < d1[i]) {
          d2[i] = d1[i];
          d1[i] = d;
          best[i] = c0 + j;
        } else {
          d2[i] = min(d2[i], d);
        }
      }
    }
    __syncthreads();
  }

  // the 32 lanes of a warp, then the COL_GROUPS warps of a row group
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int o_d1 = __shfl_down_sync(0xffffffffu, d1[i], off);
      const int o_best = __shfl_down_sync(0xffffffffu, best[i], off);
      const int o_d2 = __shfl_down_sync(0xffffffffu, d2[i], off);
      merge(d1[i], best[i], d2[i], o_d1, o_best, o_d2);
    }
    if (lane == 0) {
      int* p = s_part[rg * ROWS_PER_WARP + i][col_group];
      p[0] = d1[i];
      p[1] = best[i];
      p[2] = d2[i];
    }
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r < n_rows) {
    int f_d1 = s_part[r][0][0], f_best = s_part[r][0][1], f_d2 = s_part[r][0][2];
    for (int g = 1; g < COL_GROUPS; ++g)
      merge(f_d1, f_best, f_d2, s_part[r][g][0], s_part[r][g][1], s_part[r][g][2]);
    f_d2 = min(f_d2, f_d1 + BIGI);     // a lone column: the plain version's d1 + BIG
    float f1 = (float)f_d1, f2 = (float)f_d2;
    const int row = row0 + r;
    if (a_valid && !a_valid[row]) {
      f1 += (float)BIGI;
      f2 += (float)BIGI;
    }
    best_out[row] = f_best;
    d1_out[row] = f1;
    d2_out[row] = f2;
  }
}

}  // namespace

// a_bits (na, 256) / b_bits (nb, 256) int8 0/1, contiguous; a_valid /
// b_valid (n,) uint8 or null; outputs best (na,) int32, d1/d2 (na,) f32.
// Requires na, nb >= 1. Returns the cudaError_t of the launch (0 = launched).
extern "C" int knn2_launch(const void* a_bits, const void* b_bits,
                           const void* a_valid, const void* b_valid, int na,
                           int nb, void* best, void* d1, void* d2, void* stream) {
  if (na <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  const bool a_al = ((uintptr_t)a_bits & 15) == 0;
  const bool b_al = ((uintptr_t)b_bits & 15) == 0;
  const int blocks = (na + ROWS - 1) / ROWS;
  // whole clusters: the padding blocks only pack their slices
  knn2_kernel<<<(blocks + CLUSTER - 1) / CLUSTER * CLUSTER, THREADS, 0,
                (cudaStream_t)stream>>>(
      (const int8_t*)a_bits, (const int8_t*)b_bits, (const uint8_t*)a_valid,
      (const uint8_t*)b_valid, na, nb, a_al, b_al, (int32_t*)best, (float*)d1,
      (float*)d2);
  return (int)cudaGetLastError();
}
