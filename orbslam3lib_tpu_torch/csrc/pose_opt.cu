// Motion-only pose solve (Gauss-Newton / LM on SE(3), pinhole camera) for
// Hopper (sm_90a): one launch per evaluation of the residuals and Jacobians,
// one launch per step.
//
// Replaces no TPU kernel: orbslam3lib_tpu/tracking/pose_opt.py leaves the
// solve to XLA, which fuses each iteration into a few programs. Run eagerly
// in PyTorch, the same iteration was ~105 ATen operations for the
// evaluation and ~300 for the step, each a host dispatch of ~13 us and a
// tiny kernel, ~400 launches an iteration, and the tracker's solve runs up
// to 88 evaluations a frame (2 stages x 4 rounds x 11).
//
// Contract (oracle: tracking/pose_opt.py, its torch path, cameras.PINHOLE).
// - pose_eval: per observation row i, p_c = R p_i + t, the pinhole
//   projection (|z| < 1e-9 taken as 1e-9), z_safe (|z| < 1e-6 taken as
//   1e-6), r = [u - u_obs, v - v_obs, stereo ? u - bf / z_safe - u_right : 0],
//   J = [Jproj; Jur] [I | -hat(p_c)] with Jur = Jproj row 0 + bf / z_safe^2
//   on z, zero where not stereo, chi2 = |r|^2 inv_sigma2, behind = z <= 0.05.
//   The operations keep the torch path's order and rounding on the card
//   (elementwise: no fused multiply-add, the __f*_rn intrinsics; its sums
//   of three in torch.sum's order), so that r and chi2, which the outlier
//   classification reads, agree to f32 rounding.
// - pose_step: w = inv_sigma2 huber(chi2, delta) inlier valid !behind (in
//   the torch path's order), H = sum_i J_i^T diag(w_i) J_i and
//   b = sum_i J_i^T diag(w_i) r_i, H += lm diag(H) + 1e-8 I, dx = -H^-1 b by
//   LU with partial pivoting in f32, then (R, t) <- normalize(exp(dx) (R, t))
//   through the quaternion, as utils/lie.py (series below theta^2 = 0.09,
//   branch-free Shepperd selection, w >= 0).
//   The products w J (f32, as the torch path rounds them) are summed in
//   f64 and rounded once: the torch path's f32 sum of ~3,600 terms is the
//   larger error of the two.
//
// What bounds it on the card: at the tracker's N = 1,200 rows the
// evaluation reads 29 B and writes 89 B a row (142 KB, 0.04 us at
// 3.35 TB/s) and computes ~70 operations a row; the step reads 105 B a
// row (126 KB) and does ~80 multiply-adds a row and a 6x6 solve on one
// thread. Both are far below one launch's latency (a few microseconds),
// which is the floor; the step's serial tail (the solve, exp, compose,
// normalize: a few hundred dependent operations on one thread) is the rest.
//
// What the design does about it:
// - One thread per row for the evaluation, 128 threads a block: 10 blocks
//   at N = 1,200, no shared memory, the pose and camera read through the
//   read-only cache.
// - One block of 512 threads for the step (a single solve has nothing to
//   spread across SMs): each thread accumulates its rows' 21 entries of H
//   and 6 of b, warps reduce by shuffles, 27 threads sum the 16 warps'
//   partials in a fixed order (the result does not change from run to run),
//   and one thread solves, exponentiates and composes.
// - Nothing is allocated or synchronised; both run on the caller's stream
//   and write fresh outputs, so a CUDA graph can capture them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EVAL_THREADS = 128;
constexpr int STEP_THREADS = 512;
constexpr int STEP_WARPS = STEP_THREADS / 32;
constexpr int NH = 21;                 // unique entries of the symmetric 6x6 H
constexpr int NACC = NH + 6;           // and the 6 of b

// elementwise operations rounded one at a time, as the torch path's
// separate kernels round them (no contraction into a fused multiply-add)
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
// torch.sum over a last dimension of 3 on the card: two threads share the
// row (block width 2, the largest power of 2 <= 3), the first sums elements
// 0 and 2, and a shuffle adds the second's element 1
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return add(add(a0, a2), a1);
}

__global__ void __launch_bounds__(EVAL_THREADS)
pose_eval_kernel(const float* __restrict__ R, const float* __restrict__ t,
                 const float* __restrict__ p_world, const float* __restrict__ uv,
                 const float* __restrict__ inv_sigma2,
                 const float* __restrict__ u_right, const bool* __restrict__ is_stereo,
                 const float* __restrict__ cam, float bf, int n,
                 float* __restrict__ r_out, float* __restrict__ J_out,
                 float* __restrict__ chi2_out, bool* __restrict__ behind_out) {
  const int i = blockIdx.x * EVAL_THREADS + threadIdx.x;
  if (i >= n) return;
  float Rm[9], tv[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) Rm[k] = __ldg(R + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) tv[k] = __ldg(t + k);
  const float fx = __ldg(cam), fy = __ldg(cam + 1), cx = __ldg(cam + 2), cy = __ldg(cam + 3);
  const float p0 = p_world[3 * i], p1 = p_world[3 * i + 1], p2 = p_world[3 * i + 2];

  // lie.se3_apply: sum over j of R[k, j] p[j], then + t
  float pc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    pc[k] = add(sum3(mul(Rm[3 * k], p0), mul(Rm[3 * k + 1], p1), mul(Rm[3 * k + 2], p2)),
                tv[k]);
  const float x = pc[0], y = pc[1], z = pc[2];

  // cameras.pinhole_project / pinhole_project_jac (_safe_inv: 1e-9)
  const float inv_z = rcp(fabsf(z) < 1e-9f ? 1e-9f : z);
  const float u = add(mul(mul(fx, x), inv_z), cx);
  const float v = add(mul(mul(fy, y), inv_z), cy);
  const float inv_z2 = mul(inv_z, inv_z);
  const float j00 = mul(fx, inv_z), j02 = mul(mul(-fx, x), inv_z2);
  const float j11 = mul(fy, inv_z), j12 = mul(mul(-fy, y), inv_z2);

  const float z_safe = fabsf(z) < 1e-6f ? 1e-6f : z;
  const bool st = is_stereo[i];
  const float r0 = sub(u, uv[2 * i]);
  const float r1 = sub(v, uv[2 * i + 1]);
  // bf / z_safe is the reciprocal times bf (a Python number over a tensor)
  const float r2 = st ? sub(sub(u, mul(rcp(z_safe), bf)), u_right[i]) : 0.0f;
  const float jr2 = st ? add(j02, mul(rcp(mul(z_safe, z_safe)), bf)) : 0.0f;

  // Jfull (3 x 3) @ [I | -hat(p_c)], as a matrix product accumulates: one
  // fused multiply-add per term, in order
  const float Jf[3][3] = {{j00, 0.0f, j02}, {0.0f, j11, j12}, {st ? j00 : 0.0f, 0.0f, jr2}};
  const float D[3][3] = {{0.0f, z, -y}, {-z, 0.0f, x}, {y, -x, 0.0f}};
  float* J = J_out + 18 * (size_t)i;
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    const float a = Jf[row][0], b = Jf[row][1], c = Jf[row][2];
    J[6 * row + 0] = a;
    J[6 * row + 1] = b;
    J[6 * row + 2] = c;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      J[6 * row + 3 + j] = __fmaf_rn(c, D[2][j], __fmaf_rn(b, D[1][j], mul(a, D[0][j])));
  }
  r_out[3 * i] = r0;
  r_out[3 * i + 1] = r1;
  r_out[3 * i + 2] = r2;
  chi2_out[i] = mul(sum3(mul(r0, r0), mul(r1, r1), mul(r2, r2)), inv_sigma2[i]);
  behind_out[i] = z <= 0.05f;
}

// lie._sin_cos_coeffs: (sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3)
__device__ void sin_cos_coeffs(float theta2, float& A, float& B, float& C) {
  if (theta2 < 0.09f) {
    A = 1.0f + theta2 * (-1.0f / 6.0f + theta2 * (1.0f / 120.0f - theta2 / 5040.0f));
    B = 0.5f + theta2 * (-1.0f / 24.0f + theta2 * (1.0f / 720.0f - theta2 / 40320.0f));
    C = 1.0f / 6.0f + theta2 * (-1.0f / 120.0f + theta2 * (1.0f / 5040.0f - theta2 / 362880.0f));
  } else {
    const float th = sqrtf(fmaxf(theta2, 1e-16f));
    const float s = sinf(th), c = cosf(th);
    A = s / th;
    B = (1.0f - c) / theta2;
    C = (th - s) / (theta2 * th);
  }
}

// lie.rotmat_to_quat then lie.quat_to_rotmat, in place on a row-major 3x3
__device__ void normalize_rotation(float* m) {
  const float m00 = m[0], m01 = m[1], m02 = m[2];
  const float m10 = m[3], m11 = m[4], m12 = m[5];
  const float m20 = m[6], m21 = m[7], m22 = m[8];
  const float tr = m00 + m11 + m22;
  const float cands[4] = {1.0f + tr, 1.0f + m00 - m11 - m22, 1.0f - m00 + m11 - m22,
                          1.0f - m00 - m11 + m22};
  int k = 0;                                     // argmax, the first on ties
#pragma unroll
  for (int j = 1; j < 4; ++j)
    if (cands[j] > cands[k]) k = j;
  const float sq = sqrtf(fmaxf(cands[k], 1e-8f)) * 2.0f;
  float q[4];
  if (k == 0) {
    q[0] = 0.25f * sq; q[1] = (m21 - m12) / sq; q[2] = (m02 - m20) / sq; q[3] = (m10 - m01) / sq;
  } else if (k == 1) {
    q[0] = (m21 - m12) / sq; q[1] = 0.25f * sq; q[2] = (m01 + m10) / sq; q[3] = (m02 + m20) / sq;
  } else if (k == 2) {
    q[0] = (m02 - m20) / sq; q[1] = (m01 + m10) / sq; q[2] = 0.25f * sq; q[3] = (m12 + m21) / sq;
  } else {
    q[0] = (m10 - m01) / sq; q[1] = (m02 + m20) / sq; q[2] = (m12 + m21) / sq; q[3] = 0.25f * sq;
  }
  const float sgn = q[0] < 0.0f ? -1.0f : 1.0f;
  const float nrm = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float w = sgn * q[0] / nrm, x = sgn * q[1] / nrm, y = sgn * q[2] / nrm,
              z = sgn * q[3] / nrm;
  m[0] = 1.0f - 2.0f * (y * y + z * z);
  m[1] = 2.0f * (x * y - w * z);
  m[2] = 2.0f * (x * z + w * y);
  m[3] = 2.0f * (x * y + w * z);
  m[4] = 1.0f - 2.0f * (x * x + z * z);
  m[5] = 2.0f * (y * z - w * x);
  m[6] = 2.0f * (x * z - w * y);
  m[7] = 2.0f * (y * z + w * x);
  m[8] = 1.0f - 2.0f * (x * x + y * y);
}

// A x = rhs for a 6x6 A (row-major, overwritten) by LU with partial
// pivoting (the first largest pivot, as LAPACK's getf2); rhs becomes x
__device__ void lu_solve6(float A[6][6], float rhs[6]) {
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    int p = j;
    for (int i = j + 1; i < 6; ++i)
      if (fabsf(A[i][j]) > fabsf(A[p][j])) p = i;
    if (p != j) {
      for (int k = 0; k < 6; ++k) {
        const float s = A[j][k]; A[j][k] = A[p][k]; A[p][k] = s;
      }
      const float s = rhs[j]; rhs[j] = rhs[p]; rhs[p] = s;
    }
    const float inv = 1.0f / A[j][j];
    for (int i = j + 1; i < 6; ++i) {
      const float l = A[i][j] * inv;
      for (int k = j + 1; k < 6; ++k) A[i][k] -= l * A[j][k];
      rhs[i] -= l * rhs[j];
    }
  }
  for (int j = 5; j >= 0; --j) {
    float s = rhs[j];
    for (int k = j + 1; k < 6; ++k) s -= A[j][k] * rhs[k];
    rhs[j] = s / A[j][j];
  }
}

__global__ void __launch_bounds__(STEP_THREADS)
pose_step_kernel(const float* __restrict__ R, const float* __restrict__ t,
                 const float* __restrict__ r, const float* __restrict__ J,
                 const float* __restrict__ chi2, const bool* __restrict__ behind,
                 const float* __restrict__ inv_sigma2, const float* __restrict__ delta,
                 const float* __restrict__ inlier, const float* __restrict__ valid,
                 float lm, int n, float* __restrict__ R_out, float* __restrict__ t_out) {
  __shared__ double s_part[STEP_WARPS][NACC];
  __shared__ double s_sum[NACC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  double acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.0;
  for (int i = threadIdx.x; i < n; i += STEP_THREADS) {
    // robust.huber_weight, then the torch path's product order
    const float e = sqrtf(fmaxf(chi2[i], 1e-12f));
    const float d = delta[i];
    const float hw = e <= d ? 1.0f : d / e;
    const float w = mul(mul(mul(mul(inv_sigma2[i], hw), inlier[i]), valid[i]),
                        behind[i] ? 0.0f : 1.0f);
    const float* Ji = J + 18 * (size_t)i;
#pragma unroll
    for (int row = 0; row < 3; ++row) {
      double jr[6], jw[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float j = Ji[6 * row + a];
        jr[a] = (double)j;
        jw[a] = (double)mul(j, w);             // J * w, rounded as the torch path
      }
      const double rr = (double)r[3 * i + row];
      int h = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) acc[h++] += jw[a] * jr[b];
        acc[NH + a] += jw[a] * rr;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    double v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NACC) {
    double v = 0.0;
    for (int w = 0; w < STEP_WARPS; ++w) v += s_part[w][threadIdx.x];
    s_sum[threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  // H + lm diag(H) + 1e-8 I, in f32 as the torch path
  float H[6][6], dx[6];
  int h = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) {
      const float v = (float)s_sum[h++];
      H[a][b] = v;
      H[b][a] = v;
    }
  for (int a = 0; a < 6; ++a) {
    H[a][a] = add(add(H[a][a], mul(lm, H[a][a])), 1e-8f);
    dx[a] = (float)s_sum[NH + a];
  }
  lu_solve6(H, dx);                          // dx = H^-1 b; the step is -dx
  const float rho[3] = {-dx[0], -dx[1], -dx[2]};
  const float phi[3] = {-dx[3], -dx[4], -dx[5]};

  // lie.se3_exp: dR = I + A W + B W^2, dt = (I + B W + C W^2) rho
  const float theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  float A, B, C;
  sin_cos_coeffs(theta2, A, B, C);
  const float W[3][3] = {{0.0f, -phi[2], phi[1]}, {phi[2], 0.0f, -phi[0]},
                         {-phi[1], phi[0], 0.0f}};
  float dR[3][3], dt[3];
  for (int a = 0; a < 3; ++a) {
    float jl[3];
    for (int b = 0; b < 3; ++b) {
      const float w2 = W[a][0] * W[0][b] + W[a][1] * W[1][b] + W[a][2] * W[2][b];
      const float id = a == b ? 1.0f : 0.0f;
      dR[a][b] = id + A * W[a][b] + B * w2;
      jl[b] = id + B * W[a][b] + C * w2;
    }
    dt[a] = jl[0] * rho[0] + jl[1] * rho[1] + jl[2] * rho[2];
  }

  // lie.se3_compose(dR, dt, R, t), then lie.normalize_rotation
  float Rn[9];
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b)
      Rn[3 * a + b] = dR[a][0] * R[b] + dR[a][1] * R[3 + b] + dR[a][2] * R[6 + b];
    t_out[a] = dR[a][0] * t[0] + dR[a][1] * t[1] + dR[a][2] * t[2] + dt[a];
  }
  normalize_rotation(Rn);
  for (int k = 0; k < 9; ++k) R_out[k] = Rn[k];
}

}  // namespace

// R (3, 3), t (3,), p_world (n, 3), uv (n, 2), inv_sigma2 (n,), u_right (n,)
// f32 and is_stereo (n,) bool, contiguous on the current device; cam the
// pinhole's [fx, fy, cx, cy] f32 on the device. Outputs r (n, 3), J (n, 3, 6),
// chi2 (n,) f32 and behind (n,) bool. Returns the cudaError_t of the launch
// (0 = launched; nothing to launch for n = 0).
extern "C" int pose_eval_launch(const void* R, const void* t, const void* p_world,
                                const void* uv, const void* inv_sigma2,
                                const void* u_right, const void* is_stereo,
                                const void* cam, float bf, int n, void* r, void* J,
                                void* chi2, void* behind, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  pose_eval_kernel<<<(n + EVAL_THREADS - 1) / EVAL_THREADS, EVAL_THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const float*)R, (const float*)t, (const float*)p_world, (const float*)uv,
      (const float*)inv_sigma2, (const float*)u_right, (const bool*)is_stereo,
      (const float*)cam, bf, n, (float*)r, (float*)J, (float*)chi2, (bool*)behind);
  return (int)cudaGetLastError();
}

// R (3, 3), t (3,), r (n, 3), J (n, 3, 6), chi2 (n,) f32, behind (n,) bool,
// inv_sigma2, delta (the Huber threshold), inlier and valid (n,) f32 (0 or
// 1), contiguous on the current device; lm the LM damping. Outputs the new
// R (3, 3) and t (3,). Returns the cudaError_t of the launch (0 = launched).
extern "C" int pose_step_launch(const void* R, const void* t, const void* r,
                                const void* J, const void* chi2, const void* behind,
                                const void* inv_sigma2, const void* delta,
                                const void* inlier, const void* valid, float lm, int n,
                                void* R_out, void* t_out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  pose_step_kernel<<<1, STEP_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)R, (const float*)t, (const float*)r, (const float*)J,
      (const float*)chi2, (const bool*)behind, (const float*)inv_sigma2,
      (const float*)delta, (const float*)inlier, (const float*)valid, lm, n,
      (float*)R_out, (float*)t_out);
  return (int)cudaGetLastError();
}
