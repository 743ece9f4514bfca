"""Camera models (port of `orbslam3lib_tpu/utils/cameras.py`): pinhole,
pinhole with radial-tangential distortion (PINHOLE_RADTAN) and
Kannala-Brandt 8 (fisheye), as batched pure functions of a flat parameter
vector, plus the mapper's two-view triangulation (`cameras.py:292-331`).

Parameter layouts (float32 tensors):
  PINHOLE:         [fx, fy, cx, cy]
  PINHOLE_RADTAN:  [fx, fy, cx, cy, k1, k2, p1, p2, k3]
  KANNALA_BRANDT:  [fx, fy, cx, cy, k0, k1, k2, k3]

Each function keeps the reference's operation order, so the f32 values
agree to a few ulps; the iterative inverses run the reference's fixed step
counts (radtan 8 fixed-point steps, KB8 10 Newton steps).
"""
from __future__ import annotations

import torch

PINHOLE = 0
KANNALA_BRANDT = 1
PINHOLE_RADTAN = 2

_EPS = 1e-9


def _safe_inv(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) < _EPS, torch.full_like(x, _EPS), x)


def pinhole_project(params: torch.Tensor, p3d: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) pixels."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    inv_z = _safe_inv(p3d[..., 2])
    u = fx * p3d[..., 0] * inv_z + cx
    v = fy * p3d[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1)


def pinhole_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixels -> (..., 3) unit-depth rays (z = 1)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def pinhole_project_jac(params: torch.Tensor, p3d: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(p3d): (..., 2, 3) (reference Pinhole::projectJac)."""
    fx, fy = params[0], params[1]
    x, y = p3d[..., 0], p3d[..., 1]
    inv_z = _safe_inv(p3d[..., 2])
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(x)
    row0 = torch.stack([fx * inv_z, zeros, -fx * x * inv_z2], dim=-1)
    row1 = torch.stack([zeros, fy * inv_z, -fy * y * inv_z2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


# -- pinhole + radial-tangential distortion (reference :77-149) -------------

def _radtan_distort(k: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Radial-tangential distortion of normalised coordinates."""
    k1, k2, p1, p2, k3 = k[0], k[1], k[2], k[3], k[4]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def radtan_project(params: torch.Tensor, p3d: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) distorted pixels."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    inv_z = _safe_inv(p3d[..., 2])
    x = p3d[..., 0] * inv_z
    y = p3d[..., 1] * inv_z
    xd, yd = _radtan_distort(params[4:9], x, y)
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def radtan_unproject(params: torch.Tensor, uv: torch.Tensor,
                     n_iter: int = 8) -> torch.Tensor:
    """Distorted pixels -> z = 1 rays by the cv::undistortPoints fixed point
    x = (xd - dx(x)) / radial(x), n_iter steps."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, p1, p2, k3 = params[4], params[5], params[6], params[7], params[8]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(n_iter):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv = 1.0 / _nonzero(radial)
        x, y = (xd - dx) * inv, (yd - dy) * inv
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def radtan_project_jac(params: torch.Tensor, p3d: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(p3d): (..., 2, 3), closed form through the distortion."""
    fx, fy = params[0], params[1]
    k1, k2, p1, p2, k3 = params[4], params[5], params[6], params[7], params[8]
    X, Y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    inv_z = _safe_inv(z)
    x = X * inv_z
    y = Y * inv_z
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dradial = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)   # d(radial)/d(r2)
    dxd_dx = radial + x * dradial * 2.0 * x + 2.0 * p1 * y + 6.0 * p2 * x
    dxd_dy = x * dradial * 2.0 * y + 2.0 * p1 * x + 2.0 * p2 * y
    dyd_dx = y * dradial * 2.0 * x + 2.0 * p1 * x + 2.0 * p2 * y
    dyd_dy = radial + y * dradial * 2.0 * y + 6.0 * p1 * y + 2.0 * p2 * x
    inv_z2 = inv_z * inv_z
    du_dX = fx * dxd_dx * inv_z
    du_dY = fx * dxd_dy * inv_z
    du_dz = fx * (dxd_dx * (-X * inv_z2) + dxd_dy * (-Y * inv_z2))
    dv_dX = fy * dyd_dx * inv_z
    dv_dY = fy * dyd_dy * inv_z
    dv_dz = fy * (dyd_dx * (-X * inv_z2) + dyd_dy * (-Y * inv_z2))
    row0 = torch.stack([du_dX, du_dY, du_dz], dim=-1)
    row1 = torch.stack([dv_dX, dv_dY, dv_dz], dim=-1)
    return torch.stack([row0, row1], dim=-2)


# -- Kannala-Brandt 8 (reference :156-229, KannalaBrandt8.cpp) --------------

def _kb8_theta_poly(k: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    t2 = theta * theta
    return theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))


def _kb8_theta_poly_deriv(k: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    t2 = theta * theta
    return 1.0 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2] + t2 * 9 * k[3])))


def kb8_project(params: torch.Tensor, p3d: torch.Tensor) -> torch.Tensor:
    """Equidistant fisheye projection, d(theta) = theta + k0 theta^3 + k1
    theta^5 + k2 theta^7 + k3 theta^9; a point on the optical axis projects
    to the principal point."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=_EPS * _EPS))
    theta = torch.atan2(r, z)
    scale = _kb8_theta_poly(params[4:8], theta) / r
    scale = torch.where(r2 < _EPS, torch.zeros_like(scale), scale)
    u = fx * x * scale + cx
    v = fy * y * scale + cy
    return torch.stack([u, v], dim=-1)


def kb8_unproject(params: torch.Tensor, uv: torch.Tensor,
                  n_iter: int = 10) -> torch.Tensor:
    """Invert d(theta) by n_iter Newton steps (KannalaBrandt8::unproject);
    z = 1 rays. The principal point maps to the optical axis."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    d = torch.sqrt(mx * mx + my * my)
    theta = d
    for _ in range(n_iter):
        f = _kb8_theta_poly(k, theta) - d
        theta = theta - f / _nonzero(_kb8_theta_poly_deriv(k, theta))
    scale = torch.tan(theta) / torch.where(d < _EPS, torch.full_like(d, _EPS), d)
    scale = torch.where(d < _EPS, torch.ones_like(scale), scale)
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac(params: torch.Tensor, p3d: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(p3d) for KB8: (..., 2, 3), closed form
    (KannalaBrandt8::projectJac)."""
    fx, fy = params[0], params[1]
    k = params[4:8]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=_EPS * _EPS))
    r3 = r2 * r
    theta = torch.atan2(r, z)
    d = _kb8_theta_poly(k, theta)
    dp = _kb8_theta_poly_deriv(k, theta)
    l2 = r2 + z * z
    dd_dx = dp * (x * z / (l2 * r))
    dd_dy = dp * (y * z / (l2 * r))
    dd_dz = dp * (-r / l2)
    du_dx = fx * (dd_dx * x / r + d * (1.0 / r - x * x / r3))
    du_dy = fx * (dd_dy * x / r - d * x * y / r3)
    du_dz = fx * dd_dz * x / r
    dv_dx = fy * (dd_dx * y / r - d * x * y / r3)
    dv_dy = fy * (dd_dy * y / r + d * (1.0 / r - y * y / r3))
    dv_dz = fy * dd_dz * y / r
    row0 = torch.stack([du_dx, du_dy, du_dz], dim=-1)
    row1 = torch.stack([dv_dx, dv_dy, dv_dz], dim=-1)
    return torch.stack([row0, row1], dim=-2)


# -- dispatch on the model id (a Python int) --------------------------------

def project(model: int, params, p3d):
    if model == PINHOLE:
        return pinhole_project(params, p3d)
    if model == PINHOLE_RADTAN:
        return radtan_project(params, p3d)
    return kb8_project(params, p3d)


def unproject(model: int, params, uv):
    if model == PINHOLE:
        return pinhole_unproject(params, uv)
    if model == PINHOLE_RADTAN:
        return radtan_unproject(params, uv)
    return kb8_unproject(params, uv)


def project_jac(model: int, params, p3d):
    if model == PINHOLE:
        return pinhole_project_jac(params, p3d)
    if model == PINHOLE_RADTAN:
        return radtan_project_jac(params, p3d)
    return kb8_project_jac(params, p3d)


def triangulate_dlt(ray1, ray2, T1, T2):
    """DLT triangulation of two rays (..., 3) under two (..., 3, 4)
    world-to-camera projections; returns world points (..., 3). The null
    vector of the four cross-product rows is the smallest eigenvector of
    A^T A in closed form (`smallmat.smallest_eigvec4_psd`), the estimator
    of GeometricTools::Triangulate's SVD."""
    from .smallmat import smallest_eigvec4_psd
    x1, y1 = ray1[..., 0] / ray1[..., 2], ray1[..., 1] / ray1[..., 2]
    x2, y2 = ray2[..., 0] / ray2[..., 2], ray2[..., 1] / ray2[..., 2]
    A = torch.stack([x1[..., None] * T1[..., 2, :] - T1[..., 0, :],
                     y1[..., None] * T1[..., 2, :] - T1[..., 1, :],
                     x2[..., None] * T2[..., 2, :] - T2[..., 0, :],
                     y2[..., None] * T2[..., 2, :] - T2[..., 1, :]], dim=-2)
    X = smallest_eigvec4_psd(torch.einsum("...ki,...kj->...ij", A, A))
    w = X[..., 3]
    w = torch.where(torch.abs(w) < _EPS, torch.full_like(w, _EPS), w)
    return X[..., :3] / w[..., None]


def triangulate_two_view(ray1, ray2, R12, t12):
    """Triangulate in camera 1's frame given the pose of camera 2 in camera 1
    (x_1 = R12 x_2 + t12). ray1/ray2: (..., 3) bearings in each camera.
    Returns (p3d_c1, parallax_cos, z1, z2).

    Closed-form midpoint of the closest approach of the two unit rays, from
    the 2x2 Gram system. Its denominator 1 - cos^2 = sin^2 is computed as
    |r1 x r2|^2: the direct form cancels catastrophically for the near-
    parallel rays of neighbour keyframes centimetres apart, which is where
    the mapper triangulates.

    The returned parallax cosine is the plain sum of products, as the
    reference rounds it for the mapper (with the fused form, the
    triangulation and the kidnap-relocalisation parity tests fail). It is
    not the cosine to gate the fisheye stereo pairs on: the reference's
    fisheye graph fuses the products into the sum, and pairs of a real
    frame land at f32(0.9998) to the last ulp, so
    `matching.match_fisheye_stereo` computes its own fused cosine.
    """
    r1 = ray1 / torch.linalg.norm(ray1, dim=-1, keepdim=True)
    r2w = torch.einsum("...ij,...j->...i", R12, ray2)
    r2w = r2w / torch.linalg.norm(r2w, dim=-1, keepdim=True)
    cos_parallax = torch.sum(r1 * r2w, dim=-1)
    b = t12
    r1b = torch.sum(r1 * b, dim=-1)
    r2b = torch.sum(r2w * b, dim=-1)
    cr = torch.linalg.cross(r1, r2w, dim=-1)
    den = torch.clamp(torch.sum(cr * cr, dim=-1), min=1e-12)
    s = (r1b - cos_parallax * r2b) / den
    t = (cos_parallax * r1b - r2b) / den
    p3d = 0.5 * (s[..., None] * r1 + t[..., None] * r2w + b)
    z1 = p3d[..., 2]
    R21 = R12.transpose(-1, -2)
    t21 = -torch.einsum("...ij,...j->...i", R21, t12)
    p3d_c2 = torch.einsum("...ij,...j->...i", R21, p3d) + t21
    z2 = p3d_c2[..., 2]
    return p3d, cos_parallax, z1, z2
