// Fused FAST-9/16 score + 3x3 non-maximum suppression over every level of an
// image pyramid, both eyes, in one launch, for Hopper (sm_90a).
//
// Replaces: orbslam3lib_tpu/ops/pallas_fast.py::fast_scores_nms (Pallas body
// _fast_nms_kernel), which the TPU runs once per pyramid level and eye.
//
// Contract, per level (oracle: ops/fast.py nms3x3(fast_scores(level,
// margin))), bit-exact: score = max over the 16 circular arcs of 9 ring
// samples of min(ring - c) [bright] or min(c - ring) [dark], floored at 0;
// pixels within `margin` of an edge are zeroed BEFORE the NMS, so they never
// suppress an interior pixel; the NMS keeps c where c >= max of its 3x3
// window (plateaus survive).
//
// Arithmetic (the monotone form). f32 rounding is monotone, so subtracting
// c commutes with min and max: min_j fl(r_j - c) = fl(min_j r_j - c) and
// min_j fl(c - r_j) = fl(c - max_j r_j). The kernel therefore runs one
// min-arc and one max-arc network on the raw ring values and subtracts
// twice: bright = max_k minarc_k - c, dark = c - min_k maxarc_k. That is
// the plain version's value bit for bit, with 2 subtractions per pixel
// instead of 32. Per interior pixel: 2 x 79 min/max in the networks, 2
// subtractions, 2 max for the floor, ~9 for the NMS: ~171 operations.
//
// What bounds it on the card, for one 640x400 stereo frame (8 levels, both
// eyes, 1,333,572 pixels): 8 bytes per pixel of device traffic (one f32
// read, one f32 write), 10.67 MB, 3.18 us at 3.35 TB/s; ~1.0 M interior
// pixels x ~171 operations, ~2.6 us at 67 TFLOP/s. Memory sets the bound;
// in practice the issue rate of the networks' min/max sets the time: ~1.0 M
// pixels x ~190 instructions is ~6 M warp instructions, ~6 us on 132 SMs at
// 4 per clock and twice that where FMNMX issues at half rate.
//
// What the design does about it:
// - One launch per frame. The grid is a flat list of 30x30 output tiles over
//   all levels and both eyes; a block finds its level from the prefix of
//   tile counts in a table passed by value, so no block is padding, and the
//   small levels share the card with the large ones instead of running on a
//   few SMs each in a launch of their own (1,630 blocks for a 640x400
//   stereo frame: 1.5 times what the card holds at once).
// - A tile's scores form a 32x32 region (its output plus a one-pixel NMS
//   ring): one column per lane, 8 rows per warp, 4 warps. Every lane of
//   every warp computes the same number of scores: one even pass, no
//   half-empty second round. Rows and columns outside the margin skip the
//   networks (a whole warp-row at the top and bottom margins).
// - The image tile plus a 3-pixel ring halo (38x38) is staged in shared
//   memory with coalesced, edge-clamped 4-byte loads (1.6 device reads per
//   pixel across tiles, mostly from L2). The staging is ~1% of a block's
//   instructions, and level rows of 203, 161, 127 or 314 floats start at
//   every alignment, so 16-byte loads or TMA would buy nothing here.
// - The scores stay in shared memory; the NMS walks each column strip with
//   the 3-wide row maxima of the rows above and below kept in registers:
//   3 shared loads per output pixel.
// - 128 threads, 9.9 KB of shared memory and 63 registers per thread (no
//   spills): 8 blocks (1,024 threads, 50% occupancy) fit on an SM.
//   Measured on an H100 against other shapes of the same kernel (tools/
//   kernel_ab.py times this one): 30x62 tiles of 16 rows per warp, a tree
//   instead of the 15-step max chain (fewer registers, more time), two rows
//   per iteration, and 8-warp blocks were all slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCORE_W = 32;                     // score columns per tile, one per lane
constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = 8;
constexpr int SCORE_H = WARPS * ROWS_PER_WARP;  // 32 score rows per tile
constexpr int OUT_W = SCORE_W - 2;              // 30 output columns per tile
constexpr int OUT_H = SCORE_H - 2;              // 30 output rows per tile
constexpr int RING_R = 3;                       // FAST ring radius
constexpr int IMG_W = SCORE_W + 2 * RING_R;     // 38 staged columns
constexpr int IMG_H = SCORE_H + 2 * RING_R;     // 38 staged rows
constexpr int THREADS = WARPS * 32;
constexpr int MAX_LEVELS = 16;

// One entry per level: its (batch, H, W) input, where its output starts in
// the flat output, its tile grid, and its first tile in the launch's grid.
struct LevelTable {
  const float* img[MAX_LEVELS];
  long long out_off[MAX_LEVELS];
  int h[MAX_LEVELS], w[MAX_LEVELS];
  int tiles_x[MAX_LEVELS], tiles_per_plane[MAX_LEVELS];
  int first_tile[MAX_LEVELS + 1];
  int n_levels;
  int margin;
};

// The 16 ring samples around (cy, cx) in the order of ops/fast.py RING.
#define RING_SAMPLES(s, cy, cx)                                              \
  {s[cy - 3][cx], s[cy - 3][cx + 1], s[cy - 2][cx + 2], s[cy - 1][cx + 3],   \
   s[cy][cx + 3], s[cy + 1][cx + 3], s[cy + 2][cx + 2], s[cy + 3][cx + 1],   \
   s[cy + 3][cx], s[cy + 3][cx - 1], s[cy + 2][cx - 2], s[cy + 1][cx - 3],   \
   s[cy][cx - 3], s[cy - 1][cx - 3], s[cy - 2][cx - 2], s[cy - 3][cx - 1]}

// max over k of min(v[k..k+8 mod 16]), by the reference's log-doubling
// network (min and max are exact, so the order is immaterial anyway)
__device__ __forceinline__ float max_of_arc_min(const float v[16]) {
  float m1[16], m2[16], m4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m1[k] = fminf(v[k], v[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m2[k] = fminf(m1[k], m1[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m4[k] = fminf(m2[k], m2[(k + 4) & 15]);
  float best = fminf(m4[0], v[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) best = fmaxf(best, fminf(m4[k], v[(k + 8) & 15]));
  return best;
}

// min over k of max(v[k..k+8 mod 16])
__device__ __forceinline__ float min_of_arc_max(const float v[16]) {
  float m1[16], m2[16], m4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m1[k] = fmaxf(v[k], v[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m2[k] = fmaxf(m1[k], m1[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m4[k] = fmaxf(m2[k], m2[(k + 4) & 15]);
  float best = fmaxf(m4[0], v[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) best = fminf(best, fmaxf(m4[k], v[(k + 8) & 15]));
  return best;
}

__global__ void __launch_bounds__(THREADS, 8)
fast_nms_levels_kernel(const LevelTable t, float* __restrict__ out) {
  __shared__ float s_img[IMG_H][IMG_W];
  __shared__ float s_score[SCORE_H][SCORE_W];

  // this block's level, image plane and tile
  const int tile = blockIdx.x;
  int l = 0;
  while (l + 1 < t.n_levels && tile >= t.first_tile[l + 1]) ++l;
  const int H = t.h[l], W = t.w[l], margin = t.margin;
  const int local = tile - t.first_tile[l];
  const int plane = local / t.tiles_per_plane[l];
  const int rem = local - plane * t.tiles_per_plane[l];
  const int ty = rem / t.tiles_x[l];
  const int tx = rem - ty * t.tiles_x[l];
  const int x0 = tx * OUT_W, y0 = ty * OUT_H;   // the tile's first output pixel
  const size_t plane_off = (size_t)plane * H * W;
  const float* __restrict__ src = t.img[l] + plane_off;
  float* __restrict__ dst = out + t.out_off[l] + plane_off;

  // stage the image from (y0 - 4, x0 - 4): score row/column r holds the
  // pixel (y0 - 1 + r, x0 - 1 + c); reads past an edge are clamped (every
  // pixel they could feed lies within margin >= 3 of that edge)
  for (int i = threadIdx.x; i < IMG_H * IMG_W; i += THREADS) {
    const int ly = i / IMG_W, lx = i - ly * IMG_W;
    const int gy = min(max(y0 - 1 - RING_R + ly, 0), H - 1);
    const int gx = min(max(x0 - 1 - RING_R + lx, 0), W - 1);
    s_img[ly][lx] = __ldg(src + (size_t)gy * W + gx);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gx = x0 - 1 + lane;
  const bool col_in = gx >= margin && gx < W - margin;

  // scores, margin-masked in global coordinates before the NMS
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    const int gy = y0 - 1 + r;
    float score = 0.0f;
    if (col_in && gy >= margin && gy < H - margin) {
      const int cy = r + RING_R, cx = lane + RING_R;
      const float c = s_img[cy][cx];
      const float v[16] = RING_SAMPLES(s_img, cy, cx);
      const float bright = max_of_arc_min(v) - c;
      const float dark = c - min_of_arc_max(v);
      score = fmaxf(fmaxf(bright, dark), 0.0f);
    }
    s_score[r][lane] = score;
  }
  __syncthreads();

  // 3x3 NMS down this warp's rows; lanes 0 and 31 are the tile's NMS ring
  // and store nothing (their clamped column only keeps the loads in bounds)
  const int sx = min(max(lane, 1), SCORE_W - 2);
  auto row_max = [&](int r) {
    return fmaxf(fmaxf(s_score[r][sx - 1], s_score[r][sx]), s_score[r][sx + 1]);
  };
  const int r_first = max(warp * ROWS_PER_WARP, 1);
  const int r_end = min(warp * ROWS_PER_WARP + ROWS_PER_WARP, SCORE_H - 1);
  const bool store_col = lane >= 1 && lane <= OUT_W && gx < W;
  float up = row_max(r_first - 1), mid = row_max(r_first);
  for (int r = r_first; r < r_end; ++r) {
    const float down = row_max(r + 1);
    const float c = s_score[r][sx];
    const float win = fmaxf(fmaxf(up, mid), down);   // includes c itself
    const int gy = y0 - 1 + r;
    if (store_col && gy < H) dst[(size_t)gy * W + gx] = (c >= win) ? c : 0.0f;
    up = mid;
    mid = down;
  }
}

}  // namespace

// table: n_levels rows of 7 int64 (input pointer, output offset in
// elements, H, W, tiles_x, tiles per image plane, first tile), then the
// total tile count; each input is (batch, H, W) contiguous f32 on the
// current device; out is the flat f32 output. Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int fast_nms_levels_launch(const long long* table, int n_levels,
                                      void* out, int margin, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || margin < RING_R)
    return (int)cudaErrorInvalidValue;
  LevelTable t;
  for (int l = 0; l < n_levels; ++l) {
    const long long* e = table + 7 * l;
    t.img[l] = (const float*)(uintptr_t)e[0];
    t.out_off[l] = e[1];
    t.h[l] = (int)e[2];
    t.w[l] = (int)e[3];
    t.tiles_x[l] = (int)e[4];
    t.tiles_per_plane[l] = (int)e[5];
    t.first_tile[l] = (int)e[6];
    if (t.h[l] <= 0 || t.w[l] <= 0 || t.tiles_x[l] <= 0 || t.tiles_per_plane[l] <= 0)
      return (int)cudaErrorInvalidValue;
  }
  const long long total = table[7 * n_levels];
  if (total <= 0 || total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  t.first_tile[n_levels] = (int)total;
  t.n_levels = n_levels;
  t.margin = margin;
  fast_nms_levels_kernel<<<(unsigned)total, THREADS, 0, (cudaStream_t)stream>>>(
      t, (float*)out);
  return (int)cudaGetLastError();
}
