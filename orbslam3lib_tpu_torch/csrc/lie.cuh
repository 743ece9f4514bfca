// Lie-group helpers shared by the port's kernels, as utils/lie.py computes
// them in float32: the coefficients of the SO(3) exp map (their series
// below theta^2 = 0.09) and the projection of a near-rotation onto SO(3)
// through the quaternion (branch-free Shepperd selection, w >= 0).
#pragma once

namespace {

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

}  // namespace
