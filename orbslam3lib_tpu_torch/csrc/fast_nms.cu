// Fused FAST-9/16 score + 3x3 non-maximum suppression for Hopper (sm_90a).
//
// Replaces: orbslam3lib_tpu/ops/pallas_fast.py::fast_scores_nms (Pallas body
// _fast_nms_kernel), the TPU kernel run on every pyramid level of both eyes
// of every frame.
//
// Contract (oracle: ops/fast.py nms3x3(fast_scores(img, margin))), bit-exact:
// score = max over the 16 circular arcs of 9 ring samples of
// min(ring - c) [bright] or min(c - ring) [dark], floored at 0; pixels within
// `margin` of an edge are zeroed BEFORE the NMS, so they never suppress an
// interior pixel; the NMS keeps c where c >= max of its 8 neighbours.
// Only f32 subtractions, min and max on the same values: no rounding choice
// is left to the compiler, so the result equals the plain version exactly.
//
// What bounds it on the card: per pixel 8 bytes of device traffic (one f32
// read, one f32 write) against ~140 min/max/sub operations, at level sizes
// of 400x640 down to 80x128. At these sizes a level is a few hundred KB:
// the kernel is launch- and latency-bound, then memory-bound, never
// compute-bound.
//
// What the design does about it: one block owns a 32x16 output tile of one
// image of the batch. It stages the tile plus a 4-pixel halo (3 for the
// FAST ring, 1 for the NMS) in shared memory with coalesced, edge-clamped
// loads, so each input pixel is read from device memory about 1.4 times
// instead of 25 times. Scores for the tile plus a one-pixel ring are kept in
// shared memory for the NMS, so the score map never goes to device memory.
// The batch (the two eyes of a stereo pair) is the grid's z dimension: one
// launch per pyramid level and frame. The 16-sample arc network runs in
// registers, fully unrolled.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;            // output tile width  (threads in x)
constexpr int TH = 16;            // output tile height (threads in y)
constexpr int HALO = 4;           // 3 for the ring + 1 for the NMS
constexpr int SW = TW + 2 * HALO; // staged width  (40)
constexpr int SH = TH + 2 * HALO; // staged height (24)
constexpr int CW = TW + 2;        // score width incl. NMS ring  (34)
constexpr int CH = TH + 2;        // score height incl. NMS ring (18)

// FAST-16 Bresenham ring of radius 3 (dy, dx), the order of ops/fast.py RING.
__constant__ int8_t RING_DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int8_t RING_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// max over k of min(d[k..k+8 mod 16]), by the same log-doubling network as
// the reference (min and max are exact, so the order is immaterial anyway).
__device__ __forceinline__ float arc_score(const float d[16]) {
  float m1[16], m2[16], m4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m1[k] = fminf(d[k], d[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m2[k] = fminf(m1[k], m1[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m4[k] = fminf(m2[k], m2[(k + 4) & 15]);
  float best = fminf(m4[0], d[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) best = fmaxf(best, fminf(m4[k], d[(k + 8) & 15]));
  return best;
}

__global__ void __launch_bounds__(TW * TH)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                int H, int W, int margin) {
  __shared__ float s_img[SH][SW];
  __shared__ float s_score[CH][CW];

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const size_t plane = (size_t)blockIdx.z * H * W;
  const float* src = img + plane;
  const int tid = threadIdx.y * TW + threadIdx.x;
  constexpr int NT = TW * TH;

  // stage the tile + halo; reads past an edge are clamped (every pixel they
  // could feed lies within margin >= 3 of that edge and is masked below)
  for (int i = tid; i < SH * SW; i += NT) {
    const int ly = i / SW, lx = i - ly * SW;
    const int gy = min(max(y0 - HALO + ly, 0), H - 1);
    const int gx = min(max(x0 - HALO + lx, 0), W - 1);
    s_img[ly][lx] = src[(size_t)gy * W + gx];
  }
  __syncthreads();

  // scores for the tile plus a one-pixel ring, margin-masked in global
  // coordinates before the NMS
  for (int i = tid; i < CH * CW; i += NT) {
    const int sy = i / CW, sx = i - sy * CW;
    const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
    float score = 0.0f;
    if (gy >= margin && gy < H - margin && gx >= margin && gx < W - margin) {
      const int cy = sy + HALO - 1, cx = sx + HALO - 1;
      const float c = s_img[cy][cx];
      float ring[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) ring[k] = s_img[cy + RING_DY[k]][cx + RING_DX[k]];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = ring[k] - c;
      const float bright = arc_score(d);
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = c - ring[k];
      const float dark = arc_score(d);
      score = fmaxf(fmaxf(bright, dark), 0.0f);
    }
    s_score[sy][sx] = score;
  }
  __syncthreads();

  const int gy = y0 + threadIdx.y, gx = x0 + threadIdx.x;
  if (gy < H && gx < W) {
    const int sy = threadIdx.y + 1, sx = threadIdx.x + 1;
    const float c = s_score[sy][sx];
    float nbr = s_score[sy - 1][sx - 1];
    nbr = fmaxf(nbr, s_score[sy - 1][sx]);
    nbr = fmaxf(nbr, s_score[sy - 1][sx + 1]);
    nbr = fmaxf(nbr, s_score[sy][sx - 1]);
    nbr = fmaxf(nbr, s_score[sy][sx + 1]);
    nbr = fmaxf(nbr, s_score[sy + 1][sx - 1]);
    nbr = fmaxf(nbr, s_score[sy + 1][sx]);
    nbr = fmaxf(nbr, s_score[sy + 1][sx + 1]);
    out[plane + (size_t)gy * W + gx] = (c >= nbr) ? c : 0.0f;
  }
}

}  // namespace

// img, out: (batch, H, W) contiguous f32 on the current device. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int fast_nms_launch(const void* img, void* out, int batch, int H,
                               int W, int margin, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  dim3 block(TW, TH);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, batch);
  fast_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)img, (float*)out, H, W, margin);
  return (int)cudaGetLastError();
}
