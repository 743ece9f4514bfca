// The VI window's Gauss-Newton iterations (mapping/vi_ba.local_inertial_ba,
// the reference's LocalInertialBA, Optimizer.cc:2405) for Hopper (sm_90a):
// one launch per evaluation of the normal equations, one launch per step.
// Pinhole camera, a gyro and accel bias per keyframe (15 parameters a
// keyframe: [rho, phi, v, bg, ba], x measured from the window's start).
//
// Replaces no TPU kernel: orbslam3lib_tpu/mapping/vi_ba.py leaves the
// solve to XLA, which compiles the forward-mode Jacobian over all 15 C
// tangents into one program. Run eagerly in PyTorch that Jacobian is
// thousands of ATen operations an iteration over (15 C, C, F, 3) visual
// rows, although each visual row depends on 6 parameters (its keyframe's
// pose) and each inertial gap on 30; EuRoC's window (C = 9, F = 1,200)
// took 806 ms a keyframe on a card idle 94% of the time.
//
// Contract (oracle: mapping/vi_ba._normal_equations_torch, which the CPU
// tests hold to `jacobian_fwd` over vi_ba._residuals).
// - vi_eval: at x, each keyframe's state as vi_ba._unpack computes it
//   (R = normalize(exp(x[:6] fp) R0), t, v0 + x[6:9] fv, bg0 + x[9:12] fv,
//   ba0 + x[12:15] fv; float32, as the torch path) and each edge's
//   Jacobian in closed form: for a visual row, with respect to a left
//   se(3) perturbation [nu, omega] of its Tcw, [Jproj; Jur] [I | -hat(p_c)],
//   weighted by w = inv_sigma2 huber(chi2) (w = 0 for z <= 0.05 or an
//   unobserved slot), taken at x and not differentiated; for a gap, the
//   inertial edge [er, ev, ep] (EdgeInertial::linearizeOplus, G2oTypes.cc)
//   through T_bc (a left [nu, omega] on Tcw moves R_wb by exp(-R_bc omega)
//   on the right and p_wb by -R_wc nu - R_wb hat(t_bc) R_bc omega), whitened
//   by L9^T, and the two random walks; then each keyframe's columns times
//   its chart: fp M(x[:6] fp) on the pose (M the SE(3) left Jacobian, so
//   that exp(xi + d) = exp(M d) exp(xi) to first order), fv on the rest.
//   Each block reduces its rows' J^T W J and J^T W r (the visual chunk's
//   6x6 and 6, the gap's 30x30 and 30, the bias prior's 6 diagonal
//   entries and 6) in float64 and writes them to its own slot.
// - vi_step: sums the slots in a fixed order into the block-tridiagonal H
//   (15x15 diagonal and off-diagonal blocks) and g, adds 1e-5 I, solves
//   H dx = g by a block-tridiagonal Cholesky in float64, writes
//   x - dx (float32, as the torch path's x - solve(H, g)) and each
//   keyframe's state at it.
// The visual rows are computed in float32 as the torch path computes them,
// the gaps' terms in float64 from their float32 inputs; the sums and the
// solve in float64 (the torch path: an f32 matrix product of ~10^4 rows and
// an f32 LU). No float atomics: a sum's order does not change from run to
// run (local_ba.py's docstring: reordered sums flipped a keyframe decision).
//
// What bounds it on the card: at C = 9, F = 1,200 the evaluation reads
// 32 B a visual row (346 KB) and does ~250 operations a row, ~3 MFLOP;
// the step reads the slots (~40 KB) and runs a chain of C dependent 15x15
// factorizations. Both are far below a launch's latency (a few
// microseconds) except the step's serial chain.
//
// What the design does about it:
// - vi_eval: 128 threads a block, one visual row a thread, blocks over
//   (keyframe, chunk of 128 slots), then one block per gap (one thread
//   forms the gap's 9x30 Jacobian, the block whitens it and forms the Gram
//   matrix) and one block for the bias prior: C (ceil(F / 128) + 1) blocks.
// - vi_step: one block; all threads assemble H's blocks into shared memory
//   (480 C - 225 doubles: 90 KB at C = 24, dynamic shared memory beyond
//   48 KB; C <= 61 fits the 227 KB a block may use), then one warp factors
//   and solves them keyframe by keyframe (__syncwarp only), with one
//   reciprocal square root a column and no division.
// - Nothing is allocated or synchronised; both run on the caller's stream
//   and write outputs the wrapper allocates on every call.

#include <cuda_runtime.h>
#include <math.h>

#include "lie.cuh"

namespace {

constexpr int EVAL_THREADS = 128;     // and visual rows a block
constexpr int STEP_THREADS = 256;
constexpr int KF_STRIDE = 17;         // R0 (9), t0, v0, free_pose, free_vel
constexpr int OBS_STRIDE = 8;         // p_w (3), uv (2), u_right, inv_sigma2, kind
constexpr int NVIS = 27;              // a visual slot: H (21 of the 6x6), g (6)
constexpr int NGAP = 465 + 30;        // a gap slot: H (465 of the 30x30), g (30)
constexpr double GRAVITY = (double)9.81f;   // imu.gravity_w, float32

// offsets in a gap's row of the packed inputs (cuda_vi.GAP_FIELDS)
constexpr int G_DT = 0, G_DR = 1, G_DV = 10, G_DP = 13, G_JRG = 16, G_JVG = 25, G_JVA = 34,
              G_JPG = 43, G_JPA = 52, G_BG = 61, G_BA = 64, G_L9 = 67, G_LBG = 148,
              G_LBA = 157, G_OK = 166, GAP_STRIDE = 167;
// offsets in the constants: bg0, ba0, R_bc, t_bc, [fx, fy, cx, cy]
constexpr int C_BG0 = 0, C_BA0 = 3, C_RBC = 6, C_TBC = 15, C_CAM = 18;

__device__ __forceinline__ int tri6(int a, int b) { return a * 6 - a * (a - 1) / 2 + (b - a); }
__device__ __forceinline__ int tri30(int a, int b) { return a * 30 - a * (a - 1) / 2 + (b - a); }

// One keyframe's state at x (vi_ba._unpack, float32): R (row-major), t, v,
// bg, ba; and the tangent xi = x[:6] fp its chart is taken at.
struct KfState {
  float R[9], t[3], v[3], bg[3], ba[3], xi[6], fp, fv;
};

__device__ void kf_state(const float* x, const float* kf, const float* cst, KfState& s) {
  s.fp = kf[15];
  s.fv = kf[16];
  for (int i = 0; i < 6; ++i) s.xi[i] = x[i] * s.fp;
  const float* rho = s.xi;
  const float* phi = s.xi + 3;
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
  const float* R0 = kf;
  const float* t0 = kf + 9;
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b)
      s.R[3 * a + b] = dR[a][0] * R0[b] + dR[a][1] * R0[3 + b] + dR[a][2] * R0[6 + b];
    s.t[a] = dR[a][0] * t0[0] + dR[a][1] * t0[1] + dR[a][2] * t0[2] + dt[a];
  }
  normalize_rotation(s.R);
  for (int i = 0; i < 3; ++i) {
    s.v[i] = kf[12 + i] + x[6 + i] * s.fv;
    s.bg[i] = cst[C_BG0 + i] + x[9 + i] * s.fv;
    s.ba[i] = cst[C_BA0 + i] + x[12 + i] * s.fv;
  }
}

// -- float64 3x3 algebra, row-major --
__device__ __forceinline__ void mm3(const double* a, const double* b, double* c) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}
__device__ __forceinline__ void mtm3(const double* a, const double* b, double* c) {  // a^T b
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[i] * b[j] + a[3 + i] * b[3 + j] + a[6 + i] * b[6 + j];
}
__device__ __forceinline__ void mmt3(const double* a, const double* b, double* c) {  // a b^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[3 * j] + a[3 * i + 1] * b[3 * j + 1] + a[3 * i + 2] * b[3 * j + 2];
}
__device__ __forceinline__ void mv3(const double* a, const double* v, double* o) {
  for (int i = 0; i < 3; ++i) o[i] = a[3 * i] * v[0] + a[3 * i + 1] * v[1] + a[3 * i + 2] * v[2];
}
__device__ __forceinline__ void mtv3(const double* a, const double* v, double* o) {  // a^T v
  for (int i = 0; i < 3; ++i) o[i] = a[i] * v[0] + a[3 + i] * v[1] + a[6 + i] * v[2];
}
__device__ __forceinline__ void hat3(const double* w, double* W) {
  W[0] = 0.0;   W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.0;   W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0;
}
__device__ __forceinline__ void scale3(double* a, double s) {
  for (int i = 0; i < 9; ++i) a[i] *= s;
}

// lie._sin_cos_coeffs in float64, the same branches
__device__ void coeffs_d(double theta2, double& A, double& B, double& C) {
  if (theta2 < 0.09) {
    A = 1.0 + theta2 * (-1.0 / 6.0 + theta2 * (1.0 / 120.0 - theta2 / 5040.0));
    B = 0.5 + theta2 * (-1.0 / 24.0 + theta2 * (1.0 / 720.0 - theta2 / 40320.0));
    C = 1.0 / 6.0 + theta2 * (-1.0 / 120.0 + theta2 * (1.0 / 5040.0 - theta2 / 362880.0));
  } else {
    const double th = sqrt(theta2);
    const double s = sin(th), c = cos(th);
    A = s / th;
    B = (1.0 - c) / theta2;
    C = (th - s) / (theta2 * th);
  }
}

// I + a W + b W^2 for W = hat(w)
__device__ void so3_poly(const double* w, double a, double b, double* out) {
  double W[9], W2[9];
  hat3(w, W);
  mm3(W, W, W2);
  for (int i = 0; i < 9; ++i) out[i] = (i % 4 == 0 ? 1.0 : 0.0) + a * W[i] + b * W2[i];
}

// the SE(3) left Jacobian at xi = [rho, phi] (vi_ba._se3_left_jacobian):
// [[Jl, Q], [0, Jl]], Q = d(Jl rho)/d phi + hat(Jl rho) Jl
__device__ void se3_left_jacobian(const float* xi, double M[6][6]) {
  const double rho[3] = {xi[0], xi[1], xi[2]};
  const double phi[3] = {xi[3], xi[4], xi[5]};
  const double theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  double A, B, C, dB, dC;
  coeffs_d(theta2, A, B, C);
  if (theta2 < 0.09) {
    dB = -1.0 / 24.0 + theta2 * (2.0 / 720.0 - theta2 * 3.0 / 40320.0);
    dC = -1.0 / 120.0 + theta2 * (2.0 / 5040.0 - theta2 * 3.0 / 362880.0);
  } else {
    dB = (A - 2.0 * B) / (2.0 * theta2);
    dC = (B - 3.0 * C) / (2.0 * theta2);
  }
  double Jl[9], jr[3], pxr[3], ppr[3], Hr[9], Hj[9], HjJl[9];
  so3_poly(phi, B, C, Jl);
  mv3(Jl, rho, jr);
  pxr[0] = phi[1] * rho[2] - phi[2] * rho[1];
  pxr[1] = phi[2] * rho[0] - phi[0] * rho[2];
  pxr[2] = phi[0] * rho[1] - phi[1] * rho[0];
  ppr[0] = phi[1] * pxr[2] - phi[2] * pxr[1];
  ppr[1] = phi[2] * pxr[0] - phi[0] * pxr[2];
  ppr[2] = phi[0] * pxr[1] - phi[1] * pxr[0];
  const double pr = phi[0] * rho[0] + phi[1] * rho[1] + phi[2] * rho[2];
  hat3(rho, Hr);
  hat3(jr, Hj);
  mm3(Hj, Jl, HjJl);
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) M[i][j] = 0.0;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const double q = 2.0 * dB * pxr[i] * phi[j] - B * Hr[3 * i + j]
          + 2.0 * dC * ppr[i] * phi[j]
          + C * ((i == j ? pr : 0.0) + phi[i] * rho[j] - 2.0 * rho[i] * phi[j]);
      M[i][j] = Jl[3 * i + j];
      M[3 + i][3 + j] = Jl[3 * i + j];
      M[i][3 + j] = q + HjJl[3 * i + j];
    }
}

// lie.so3_log in float64: the quaternion route
__device__ void so3_log_d(const double* m, double* out) {
  const double tr = m[0] + m[4] + m[8];
  const double cands[4] = {1.0 + tr, 1.0 + m[0] - m[4] - m[8], 1.0 - m[0] + m[4] - m[8],
                           1.0 - m[0] - m[4] + m[8]};
  int k = 0;
  for (int j = 1; j < 4; ++j)
    if (cands[j] > cands[k]) k = j;
  const double sq = sqrt(fmax(cands[k], 1e-8)) * 2.0;
  const double m01 = m[1], m02 = m[2], m10 = m[3], m12 = m[5], m20 = m[6], m21 = m[7];
  double q[4];
  if (k == 0) {
    q[0] = 0.25 * sq; q[1] = (m21 - m12) / sq; q[2] = (m02 - m20) / sq; q[3] = (m10 - m01) / sq;
  } else if (k == 1) {
    q[0] = (m21 - m12) / sq; q[1] = 0.25 * sq; q[2] = (m01 + m10) / sq; q[3] = (m02 + m20) / sq;
  } else if (k == 2) {
    q[0] = (m02 - m20) / sq; q[1] = (m01 + m10) / sq; q[2] = 0.25 * sq; q[3] = (m12 + m21) / sq;
  } else {
    q[0] = (m10 - m01) / sq; q[1] = (m02 + m20) / sq; q[2] = (m12 + m21) / sq; q[3] = 0.25 * sq;
  }
  const double sgn = q[0] < 0.0 ? -1.0 : 1.0;
  const double nrm = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const double qw = sgn * q[0] / nrm;
  const double qv[3] = {sgn * q[1] / nrm, sgn * q[2] / nrm, sgn * q[3] / nrm};
  const double nv2 = qv[0] * qv[0] + qv[1] * qv[1] + qv[2] * qv[2];
  double scale;
  if (nv2 < 1e-12) {
    const double qs = fmax(qw, 1e-8);
    scale = 2.0 / qs - 2.0 * nv2 / (3.0 * qs * qs * qs);
  } else {
    const double nv = sqrt(nv2);
    scale = 2.0 * atan2(nv, qw) / nv;
  }
  for (int i = 0; i < 3; ++i) out[i] = scale * qv[i];
}

// Jr^-1(w) = I + W / 2 + coef W^2, the exact derivative of so3_log
// (vi_ba._so3_right_jacobian_inv)
__device__ void right_jac_inv(const double* w, double* out) {
  const double theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double coef;
  if (theta2 < 0.09) {
    coef = 1.0 / 12.0 + theta2 * (1.0 / 720.0 + theta2 * (1.0 / 30240.0 + theta2 / 1209600.0));
  } else {
    const double th = sqrt(theta2);
    coef = 1.0 / theta2 - (1.0 + cos(th)) / (2.0 * th * sin(th));
  }
  so3_poly(w, 0.5, coef, out);
}

// The body pose of a Tcw state (imu.body_from_cam), float64: R_wc, R_wb, p
__device__ void body_pose(const KfState& s, const double* Rbc, const double* tbc,
                          double* Rwc, double* Rwb, double* p) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rwc[3 * i + j] = s.R[3 * j + i];
  const double t[3] = {s.t[0], s.t[1], s.t[2]};
  double c[3], lt[3];
  mv3(Rwc, t, c);
  mmt3(Rwc, Rbc, Rwb);
  mv3(Rwb, tbc, lt);
  for (int i = 0; i < 3; ++i) p[i] = -c[i] - lt[i];
}

// dst[3x3 block at (r0, c0)] of a row-major matrix with `ld` columns
__device__ __forceinline__ void put3(double* dst, int ld, int r0, int c0, const double* a) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) dst[(r0 + i) * ld + c0 + j] = a[3 * i + j];
}

// One gap's raw inertial edge: r9 and its 9x30 Jacobian in the two
// keyframes' local perturbations [nu, omega, v, bg, ba] (columns 24-29,
// the second keyframe's biases, are zero)
__device__ void inertial_edge(const KfState& a, const KfState& b, const float* gp,
                              const float* cst, double* r9, double* J) {
  double Rbc[9], tbc[3];
  for (int i = 0; i < 9; ++i) Rbc[i] = cst[C_RBC + i];
  for (int i = 0; i < 3; ++i) tbc[i] = cst[C_TBC + i];
  double Rwc1[9], R1[9], p1[3], Rwc2[9], R2[9], p2[3];
  body_pose(a, Rbc, tbc, Rwc1, R1, p1);
  body_pose(b, Rbc, tbc, Rwc2, R2, p2);
  double preR[9], JRg[9], JVg[9], JVa[9], JPg[9], JPa[9];
  for (int i = 0; i < 9; ++i) {
    preR[i] = gp[G_DR + i];
    JRg[i] = gp[G_JRG + i];
    JVg[i] = gp[G_JVG + i];
    JVa[i] = gp[G_JVA + i];
    JPg[i] = gp[G_JPG + i];
    JPa[i] = gp[G_JPA + i];
  }
  // imu.corrected_deltas at the first keyframe's biases
  double dbg[3], dba[3], phib[3], dV[3], dP[3], t1[3], t2[3];
  for (int i = 0; i < 3; ++i) {
    dbg[i] = (double)a.bg[i] - gp[G_BG + i];
    dba[i] = (double)a.ba[i] - gp[G_BA + i];
  }
  mv3(JRg, dbg, phib);
  const double thb = phib[0] * phib[0] + phib[1] * phib[1] + phib[2] * phib[2];
  double A, B, C, expb[9], Jrb[9], dR[9];
  coeffs_d(thb, A, B, C);
  so3_poly(phib, A, B, expb);
  mm3(preR, expb, dR);
  const double mphib[3] = {-phib[0], -phib[1], -phib[2]};
  so3_poly(mphib, B, C, Jrb);                 // Jr(phib) = Jl(-phib)
  mv3(JVg, dbg, t1);
  mv3(JVa, dba, t2);
  for (int i = 0; i < 3; ++i) dV[i] = gp[G_DV + i] + t1[i] + t2[i];
  mv3(JPg, dbg, t1);
  mv3(JPa, dba, t2);
  for (int i = 0; i < 3; ++i) dP[i] = gp[G_DP + i] + t1[i] + t2[i];

  // imu.inertial_residual
  const double dt = gp[G_DT];
  const double gw[3] = {0.0, GRAVITY, 0.0};
  double R1tR2[9], E[9], er[3], Jri[9], av[3], ap[3], u[3];
  mtm3(R1, R2, R1tR2);
  mtm3(dR, R1tR2, E);
  so3_log_d(E, er);
  right_jac_inv(er, Jri);
  for (int i = 0; i < 3; ++i) u[i] = (double)b.v[i] - a.v[i] - gw[i] * dt;
  mtv3(R1, u, av);
  for (int i = 0; i < 3; ++i)
    u[i] = p2[i] - p1[i] - (double)a.v[i] * dt - 0.5 * gw[i] * dt * dt;
  mtv3(R1, u, ap);
  for (int i = 0; i < 3; ++i) {
    r9[i] = er[i];
    r9[3 + i] = av[i] - dV[i];
    r9[6 + i] = ap[i] - dP[i];
  }

  for (int i = 0; i < 9 * 30; ++i) J[i] = 0.0;
  double M1[9], M2[9], M3[9], R1t[9], lever1[9], lever2[9], Htb[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R1t[3 * i + j] = R1[3 * j + i];
  hat3(tbc, Htb);
  mm3(R1, Htb, M1);
  mm3(M1, Rbc, lever1);
  mm3(R2, Htb, M1);
  mm3(M1, Rbc, lever2);
  // er: d/d theta1 = -Jri R2^T R1, d/d theta2 = Jri, d/d bg = -Jri E^T Jr JRg;
  // omega enters theta as -R_bc omega
  mtm3(R2, R1, M1);
  mm3(Jri, M1, M2);
  mm3(M2, Rbc, M3);                           // (-Jri R2^T R1)(-R_bc)
  put3(J, 30, 0, 3, M3);
  mm3(Jri, Rbc, M3);
  scale3(M3, -1.0);
  put3(J, 30, 0, 18, M3);
  mtm3(E, Jrb, M1);
  mm3(M1, JRg, M2);
  mm3(Jri, M2, M3);
  scale3(M3, -1.0);
  put3(J, 30, 0, 9, M3);
  // ev: d/d theta1 = hat(av), d/d v1 = -R1^T, d/d v2 = R1^T, biases -JVg, -JVa
  hat3(av, M1);
  mm3(M1, Rbc, M3);
  scale3(M3, -1.0);
  put3(J, 30, 3, 3, M3);
  for (int i = 0; i < 9; ++i) M1[i] = -R1t[i];
  put3(J, 30, 3, 6, M1);
  put3(J, 30, 3, 21, R1t);
  for (int i = 0; i < 9; ++i) M1[i] = -JVg[i];
  put3(J, 30, 3, 9, M1);
  for (int i = 0; i < 9; ++i) M1[i] = -JVa[i];
  put3(J, 30, 3, 12, M1);
  // ep: d/d theta1 = hat(ap), d/d p1 = -R1^T, d/d p2 = R1^T, d/d v1 = -R1^T dt,
  // biases -JPg, -JPa; p moves by -R_wc nu - lever omega
  mm3(R1t, Rwc1, M1);                         // (-R1^T)(-R_wc1)
  put3(J, 30, 6, 0, M1);
  hat3(ap, M1);
  mm3(M1, Rbc, M2);
  mm3(R1t, lever1, M3);
  for (int i = 0; i < 9; ++i) M3[i] -= M2[i];  // hat(ap)(-R_bc) + (-R1^T)(-lever1)
  put3(J, 30, 6, 3, M3);
  for (int i = 0; i < 9; ++i) M1[i] = -R1t[i] * dt;
  put3(J, 30, 6, 6, M1);
  for (int i = 0; i < 9; ++i) M1[i] = -JPg[i];
  put3(J, 30, 6, 9, M1);
  for (int i = 0; i < 9; ++i) M1[i] = -JPa[i];
  put3(J, 30, 6, 12, M1);
  mm3(R1t, Rwc2, M1);
  scale3(M1, -1.0);                           // R1^T (-R_wc2)
  put3(J, 30, 6, 15, M1);
  mm3(R1t, lever2, M1);
  scale3(M1, -1.0);                           // R1^T (-lever2)
  put3(J, 30, 6, 18, M1);
}

__global__ void __launch_bounds__(EVAL_THREADS)
vi_eval_kernel(const float* __restrict__ kf, const float* __restrict__ gap,
               const float* __restrict__ obs, const float* __restrict__ cst,
               const float* __restrict__ x, float bf, float delta_mono, float delta_stereo,
               int C, int F, double* __restrict__ part) {
  __shared__ KfState s_st[2];
  __shared__ double s_M[2][6][6];
  __shared__ double s_J[15 * 30];        // a gap's rows: raw (9 x 30), then all 15
  __shared__ double s_Jt[9 * 30];        // the inertial rows in x-coordinates
  __shared__ double s_r[9], s_r15[15];
  __shared__ double s_part[EVAL_THREADS / 32][NVIS];
  __shared__ double s_sum[NVIS];
  const int tid = threadIdx.x;
  const int nch = (F + EVAL_THREADS - 1) / EVAL_THREADS;
  const int b = blockIdx.x;
  double* vis_part = part;
  double* gap_part = part + (size_t)C * nch * NVIS;
  double* prior_part = gap_part + (size_t)(C - 1) * NGAP;

  if (b < C * nch) {
    // -- a chunk of one keyframe's visual rows, one a thread --
    const int c = b / nch, ch = b % nch;
    if (tid == 0) {
      kf_state(x + 15 * c, kf + KF_STRIDE * c, cst, s_st[0]);
      se3_left_jacobian(s_st[0].xi, s_M[0]);
    }
    __syncthreads();
    const KfState& s = s_st[0];
    double acc[NVIS];
    for (int k = 0; k < NVIS; ++k) acc[k] = 0.0;
    const int f = ch * EVAL_THREADS + tid;
    const float* o = obs + ((size_t)c * F + (f < F ? f : 0)) * OBS_STRIDE;
    const float kind = f < F ? o[7] : 0.0f;     // 0 unobserved, 1 mono, 2 stereo
    if (kind > 0.0f) {
      const bool st = kind > 1.5f;
      const float fx = cst[C_CAM], fy = cst[C_CAM + 1], cx = cst[C_CAM + 2], cy = cst[C_CAM + 3];
      float pc[3];
      for (int k = 0; k < 3; ++k)
        pc[k] = s.R[3 * k] * o[0] + s.R[3 * k + 1] * o[1] + s.R[3 * k + 2] * o[2] + s.t[k];
      const float z = pc[2];
      // cameras.pinhole_project (_safe_inv: 1e-9) and the clamped depth
      const float inv_z = 1.0f / (fabsf(z) < 1e-9f ? 1e-9f : z);
      const float zs = fabsf(z) < 1e-6f ? 1e-6f : z;
      const float u = fx * pc[0] * inv_z + cx;
      const float v = fy * pc[1] * inv_z + cy;
      const float r0 = u - o[3], r1 = v - o[4];
      const float r2 = st ? u - bf / zs - o[5] : 0.0f;
      const float w_sig = o[6];
      // robust.huber_weight at chi2, zero behind the camera
      const float chi2 = (r0 * r0 + r1 * r1 + r2 * r2) * w_sig;
      const float e = sqrtf(fmaxf(chi2, 1e-12f));
      const float delta = st ? delta_stereo : delta_mono;
      const float w = z <= 0.05f ? 0.0f : w_sig * (e <= delta ? 1.0f : delta / e);
      if (w > 0.0f) {
        const float j00 = fx * inv_z, j02 = -fx * pc[0] * inv_z * inv_z;
        const float j11 = fy * inv_z, j12 = -fy * pc[1] * inv_z * inv_z;
        const float Jf[3][3] = {{j00, 0.0f, j02}, {0.0f, j11, j12},
                                {st ? j00 : 0.0f, 0.0f, st ? j02 + bf / (zs * zs) : 0.0f}};
        const float D[3][3] = {{0.0f, pc[2], -pc[1]}, {-pc[2], 0.0f, pc[0]},
                               {pc[1], -pc[0], 0.0f}};     // -hat(p_c)
        const float rr[3] = {r0, r1, r2};
        for (int row = 0; row < 3; ++row) {
          double j[6];
          for (int k = 0; k < 3; ++k) {
            j[k] = Jf[row][k];
            j[3 + k] = (double)Jf[row][0] * D[0][k] + (double)Jf[row][1] * D[1][k]
                + (double)Jf[row][2] * D[2][k];
          }
          int h = 0;
          for (int a2 = 0; a2 < 6; ++a2) {
            const double wa = w * j[a2];
            for (int b2 = a2; b2 < 6; ++b2) acc[h++] += wa * j[b2];
            acc[21 + a2] += wa * rr[row];
          }
        }
      }
    }
    // the block's sum in a fixed order: warp shuffles, then the warps in turn
    const int warp = tid >> 5, lane = tid & 31;
    for (int k = 0; k < NVIS; ++k) {
      double val = acc[k];
      for (int off = 16; off > 0; off >>= 1) val += __shfl_down_sync(0xffffffffu, val, off);
      if (lane == 0) s_part[warp][k] = val;
    }
    __syncthreads();
    if (tid < NVIS) {
      double val = 0.0;
      for (int w2 = 0; w2 < EVAL_THREADS / 32; ++w2) val += s_part[w2][tid];
      s_sum[tid] = val;
    }
    __syncthreads();
    if (tid >= 36) return;
    // the chart: H_x = fp^2 M^T H M, g_x = fp M^T g
    const int i = tid / 6, jj = tid % 6;
    double* out = vis_part + ((size_t)c * nch + ch) * NVIS;
    const double fp = s.fp;
    if (jj >= i) {
      double val = 0.0;
      for (int p = 0; p < 6; ++p)
        for (int q = 0; q < 6; ++q)
          val += s_M[0][p][i] * s_sum[p <= q ? tri6(p, q) : tri6(q, p)] * s_M[0][q][jj];
      out[tri6(i, jj)] = fp * fp * val;
    }
    if (tid < 6) {
      double val = 0.0;
      for (int p = 0; p < 6; ++p) val += s_M[0][p][tid] * s_sum[21 + p];
      out[21 + tid] = fp * val;
    }
    return;
  }

  if (b < C * nch + C - 1) {
    // -- one gap: the inertial edge and the two random walks --
    const int k = b - C * nch;
    const float* gp = gap + (size_t)GAP_STRIDE * k;
    if (tid < 2) {
      kf_state(x + 15 * (k + tid), kf + KF_STRIDE * (k + tid), cst, s_st[tid]);
      se3_left_jacobian(s_st[tid].xi, s_M[tid]);
    }
    __syncthreads();
    if (tid == 0) inertial_edge(s_st[0], s_st[1], gp, cst, s_r, s_J);
    __syncthreads();
    // the charts: pose columns times fp M, the others times fv
    for (int e = tid; e < 9 * 30; e += EVAL_THREADS) {
      const int i = e / 30, j = e % 30;
      const int side = j / 15, jl = j % 15;
      const KfState& s = s_st[side];
      double val;
      if (jl < 6) {
        val = 0.0;
        for (int m = 0; m < 6; ++m) val += s_J[30 * i + 15 * side + m] * s_M[side][m][jl];
        val *= s.fp;
      } else {
        val = s_J[e] * s.fv;
      }
      s_Jt[e] = val;
    }
    __syncthreads();
    // the 15 rows, gap_ok applied: L9^T of the inertial edge (whitening),
    // then Lbg^T (bg_b - bg_a) and Lba^T (ba_b - ba_a)
    const double ok = gp[G_OK];
    const double fva = s_st[0].fv, fvb = s_st[1].fv;
    for (int e = tid; e < 15 * 30; e += EVAL_THREADS) {
      const int i = e / 30, j = e % 30;
      double val = 0.0;
      if (i < 9) {
        for (int l = 0; l < 9; ++l) val += (double)gp[G_L9 + 9 * l + i] * s_Jt[30 * l + j];
      } else {
        const int ri = (i - 9) % 3, ca = i < 12 ? 9 : 12;
        const float* L = gp + (i < 12 ? G_LBG : G_LBA);
        if (j >= ca && j < ca + 3) val = -(double)L[3 * (j - ca) + ri] * fva;
        else if (j >= 15 + ca && j < 18 + ca) val = (double)L[3 * (j - 15 - ca) + ri] * fvb;
      }
      s_J[e] = ok * val;
    }
    if (tid < 15) {
      double val = 0.0;
      if (tid < 9) {
        for (int l = 0; l < 9; ++l) val += (double)gp[G_L9 + 9 * l + tid] * s_r[l];
      } else {
        const int ri = (tid - 9) % 3;
        const float* L = gp + (tid < 12 ? G_LBG : G_LBA);
        const float* va = tid < 12 ? s_st[0].bg : s_st[0].ba;
        const float* vb = tid < 12 ? s_st[1].bg : s_st[1].ba;
        for (int l = 0; l < 3; ++l) val += (double)L[3 * l + ri] * (double)(vb[l] - va[l]);
      }
      s_r15[tid] = ok * val;
    }
    __syncthreads();
    double* out = gap_part + (size_t)NGAP * k;
    for (int e = tid; e < 30 * 30; e += EVAL_THREADS) {
      const int a2 = e / 30, b2 = e % 30;
      if (b2 < a2) continue;
      double val = 0.0;
      for (int i = 0; i < 15; ++i) val += s_J[30 * i + a2] * s_J[30 * i + b2];
      out[tri30(a2, b2)] = val;
    }
    if (tid < 30) {
      double val = 0.0;
      for (int i = 0; i < 15; ++i) val += s_J[30 * i + tid] * s_r15[i];
      out[465 + tid] = val;
    }
    return;
  }

  // -- the first keyframe's bias prior: sqrt-information 10 (gyro), sqrt(10) --
  if (tid == 0) {
    KfState s;
    kf_state(x, kf, cst, s);
    const double sq[2] = {10.0, 3.1622776601683795};
    for (int i = 0; i < 6; ++i) {
      const double jp = sq[i / 3] * s.fv;
      const double r = i < 3 ? (double)(s.bg[i] - cst[C_BG0 + i]) * sq[0]
                             : (double)(s.ba[i - 3] - cst[C_BA0 + i - 3]) * sq[1];
      prior_part[i] = jp * jp;
      prior_part[6 + i] = jp * r;
    }
  }
}

constexpr size_t MAX_SMEM = 232448;    // the most a block may use (227 KB)
constexpr int MAX_DEVICES = 64;

// Shared memory of vi_step: H's diagonal and off-diagonal blocks and g
__host__ __device__ inline size_t step_smem(int C) {
  return sizeof(double) * ((size_t)225 * (2 * C - 1) + 30 * (size_t)C);
}

__global__ void __launch_bounds__(STEP_THREADS)
vi_step_kernel(const float* __restrict__ kf, const float* __restrict__ cst,
               const double* __restrict__ part, const float* __restrict__ x, int C, int F,
               float* __restrict__ x_out, float* __restrict__ R_out, float* __restrict__ t_out,
               float* __restrict__ v_out, float* __restrict__ bg_out,
               float* __restrict__ ba_out, double* __restrict__ blocks_out) {
  extern __shared__ double smem[];
  double* D = smem;                       // (C, 15, 15), row-major
  double* Bm = D + 225 * C;               // (C - 1, 15, 15): rows of k, columns of k + 1
  double* g = Bm + 225 * (C - 1);         // (C, 15)
  double* dinv = g + 15 * C;              // (C, 15): 1 / L_k's diagonal
  const int tid = threadIdx.x;
  const int nch = (F + EVAL_THREADS - 1) / EVAL_THREADS;
  const double* vis = part;
  const double* gp = part + (size_t)C * nch * NVIS;
  const double* prior = gp + (size_t)(C - 1) * NGAP;

  // the slots summed in a fixed order: visual chunks, the gap before, the
  // gap after, the prior; then 1e-5 on the diagonal
  for (int e = tid; e < 225 * C; e += STEP_THREADS) {
    const int k = e / 225, i = (e % 225) / 15, j = e % 15;
    const int lo = i < j ? i : j, hi = i < j ? j : i;
    double val = 0.0;
    if (hi < 6)
      for (int ch = 0; ch < nch; ++ch) val += vis[((size_t)k * nch + ch) * NVIS + tri6(lo, hi)];
    if (k > 0) val += gp[(size_t)NGAP * (k - 1) + tri30(15 + lo, 15 + hi)];
    if (k < C - 1) val += gp[(size_t)NGAP * k + tri30(lo, hi)];
    if (k == 0 && i == j && i >= 9) val += prior[i - 9];
    if (i == j) val += 1e-5;
    D[e] = val;
  }
  for (int e = tid; e < 225 * (C - 1); e += STEP_THREADS) {
    const int k = e / 225, i = (e % 225) / 15, j = e % 15;
    Bm[e] = gp[(size_t)NGAP * k + tri30(i, 15 + j)];
  }
  for (int e = tid; e < 15 * C; e += STEP_THREADS) {
    const int k = e / 15, i = e % 15;
    double val = 0.0;
    if (i < 6)
      for (int ch = 0; ch < nch; ++ch) val += vis[((size_t)k * nch + ch) * NVIS + 21 + i];
    if (k > 0) val += gp[(size_t)NGAP * (k - 1) + 465 + 15 + i];
    if (k < C - 1) val += gp[(size_t)NGAP * k + 465 + i];
    if (k == 0 && i >= 9) val += prior[6 + i - 9];
    g[e] = val;
  }
  __syncthreads();
  if (blocks_out != nullptr)
    for (int e = tid; e < 225 * (2 * C - 1) + 15 * C; e += STEP_THREADS) blocks_out[e] = smem[e];
  if (tid >= 32) return;

  // -- one warp: block-tridiagonal Cholesky, keyframe by keyframe --
  // D_k <- L_k (lower), B_k <- Y_k = L_k^-1 B_k, so that L_{k+1,k} = Y_k^T
  const int lane = tid;
  for (int k = 0; k < C; ++k) {
    double* A = D + 225 * k;
    if (k > 0) {
      const double* Y = Bm + 225 * (k - 1);
      for (int e = lane; e < 225; e += 32) {
        const int i = e / 15, j = e % 15;
        if (j > i) continue;
        double s = 0.0;
        for (int m = 0; m < 15; ++m) s += Y[15 * m + i] * Y[15 * m + j];
        A[e] -= s;
      }
      __syncwarp();
    }
    // (f64 division and square root are long sequences on the card: one
    // reciprocal square root a column, multiplications elsewhere)
    double* di = dinv + 15 * k;
    for (int j = 0; j < 15; ++j) {
      const double a = A[16 * j];
      const double inv = rsqrt(a);
      __syncwarp();
      if (lane > j && lane < 15) A[15 * lane + j] *= inv;
      if (lane == j) {
        A[16 * j] = a * inv;
        di[j] = inv;
      }
      __syncwarp();
      for (int e = lane; e < 225; e += 32) {
        const int i = e / 15, l = e % 15;
        if (l > j && l <= i) A[e] -= A[15 * i + j] * A[15 * l + j];
      }
      __syncwarp();
    }
    if (k < C - 1 && lane < 15) {
      double* Y = Bm + 225 * k;                 // column `lane` of L^-1 B
      for (int i = 0; i < 15; ++i) {
        double s = Y[15 * i + lane];
        for (int m = 0; m < i; ++m) s -= A[15 * i + m] * Y[15 * m + lane];
        Y[15 * i + lane] = s * di[i];
      }
    }
    __syncwarp();
  }
  // forward: z_k = L_k^-1 (g_k - Y_{k-1}^T z_{k-1}); lane i holds row i
  for (int k = 0; k < C; ++k) {
    const double* A = D + 225 * k;
    double* z = g + 15 * k;
    double rhs = lane < 15 ? z[lane] : 0.0;
    if (k > 0 && lane < 15) {
      const double* Y = Bm + 225 * (k - 1);
      const double* zp = g + 15 * (k - 1);
      for (int m = 0; m < 15; ++m) rhs -= Y[15 * m + lane] * zp[m];
    }
    const double inv = lane < 15 ? dinv[15 * k + lane] : 0.0;
    for (int j = 0; j < 15; ++j) {
      const double zj = __shfl_sync(0xffffffffu, rhs * inv, j);
      if (lane == j) rhs = zj;
      else if (lane > j && lane < 15) rhs -= A[15 * lane + j] * zj;
    }
    __syncwarp();
    if (lane < 15) z[lane] = rhs;
    __syncwarp();
  }
  // backward: s_k = L_k^-T (z_k - Y_k s_{k+1})
  for (int k = C - 1; k >= 0; --k) {
    const double* A = D + 225 * k;
    double* z = g + 15 * k;
    double rhs = lane < 15 ? z[lane] : 0.0;
    if (k < C - 1 && lane < 15) {
      const double* Y = Bm + 225 * k;
      const double* sn = g + 15 * (k + 1);
      for (int m = 0; m < 15; ++m) rhs -= Y[15 * lane + m] * sn[m];
    }
    const double inv = lane < 15 ? dinv[15 * k + lane] : 0.0;
    for (int j = 14; j >= 0; --j) {
      const double sj = __shfl_sync(0xffffffffu, rhs * inv, j);
      if (lane == j) rhs = sj;
      else if (lane < j) rhs -= A[15 * j + lane] * sj;
    }
    __syncwarp();
    if (lane < 15) z[lane] = rhs;
    __syncwarp();
  }
  // x - dx and each keyframe's state there
  for (int k = lane; k < C; k += 32) {
    float xn[15];
    for (int i = 0; i < 15; ++i) {
      xn[i] = x[15 * k + i] - (float)g[15 * k + i];
      x_out[15 * k + i] = xn[i];
    }
    KfState s;
    kf_state(xn, kf + KF_STRIDE * k, cst, s);
    for (int i = 0; i < 9; ++i) R_out[9 * k + i] = s.R[i];
    for (int i = 0; i < 3; ++i) {
      t_out[3 * k + i] = s.t[i];
      v_out[3 * k + i] = s.v[i];
      bg_out[3 * k + i] = s.bg[i];
      ba_out[3 * k + i] = s.ba[i];
    }
  }
}

}  // namespace

// kf (C, 17), gap (C - 1, 167), obs (C, F, 8), cst (22) and x (15 C) f32,
// contiguous on the current device (cuda_vi.pack's layouts); bf, the two
// Huber thresholds; part (C ceil(F / 128) 27 + (C - 1) 495 + 12) f64. Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int vi_eval_launch(const void* kf, const void* gap, const void* obs,
                              const void* cst, const void* x, float bf, float delta_mono,
                              float delta_stereo, int C, int F, void* part, void* stream) {
  if (C < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const int nch = (F + EVAL_THREADS - 1) / EVAL_THREADS;
  vi_eval_kernel<<<C * nch + C, EVAL_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)kf, (const float*)gap, (const float*)obs, (const float*)cst,
      (const float*)x, bf, delta_mono, delta_stereo, C, F, (double*)part);
  return (int)cudaGetLastError();
}

// kf (C, 17), cst (22), x (15 C) f32 and part (one vi_eval's) f64 on the
// current device; outputs x_out (15 C), R (C, 3, 3), t, v, bg, ba (C, 3)
// f32; blocks_out (C 225 + (C - 1) 225 + 15 C f64: D, B, g as summed,
// damping included) or null. Returns the cudaError_t of the launch.
extern "C" int vi_step_launch(const void* kf, const void* cst, const void* part,
                              const void* x, int C, int F, void* x_out, void* R, void* t,
                              void* v, void* bg, void* ba, void* blocks_out, void* stream) {
  if (C < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = step_smem(C);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // allow the most dynamic shared memory once per device, before any
  // capture into a CUDA graph could see the call
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= MAX_DEVICES || !opted_in[dev])) {
    err = cudaFuncSetAttribute(vi_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  vi_step_kernel<<<1, STEP_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)kf, (const float*)cst, (const double*)part, (const float*)x, C, F,
      (float*)x_out, (float*)R, (float*)t, (float*)v, (float*)bg, (float*)ba,
      (double*)blocks_out);
  return (int)cudaGetLastError();
}
