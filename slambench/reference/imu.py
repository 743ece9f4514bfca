"""The preintegration's use in the inertial solves (port of the port's
`tracking/imu.py`: the bias-corrected deltas, the body pose through the
camera-IMU extrinsic and the 9-dim inertial residual), in the dtype of its
inputs. A preintegration is any object with the fields of `PRE_FIELDS`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie

GRAVITY = 9.81

PRE_FIELDS = ("dt", "dR", "dV", "dP", "cov", "cov_bias", "JRg", "JVg", "JVa",
              "JPg", "JPa", "bg", "ba")


class Pre(NamedTuple):
    """A preintegration between two frames or keyframes (or a stack of them
    along a leading dimension): cov (9, 9) over [phi, v, p], cov_bias (6, 6)
    the accumulated bias random walk, the bias Jacobians and the
    linearisation point bg, ba."""
    dt: torch.Tensor
    dR: torch.Tensor
    dV: torch.Tensor
    dP: torch.Tensor
    cov: torch.Tensor
    cov_bias: torch.Tensor
    JRg: torch.Tensor
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor


def _mv(M, v):
    return lie._matvec(M, v)


def corrected_deltas(pre: Pre, bg_new, ba_new):
    """First-order bias-corrected deltas (GetDeltaRotation / Velocity /
    Position, ImuTypes.cc)."""
    dbg = bg_new - pre.bg
    dba = ba_new - pre.ba
    dR = pre.dR @ lie.so3_exp(_mv(pre.JRg, dbg))
    dV = pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)
    dP = pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)
    return dR, dV, dP


def gravity_w(like: torch.Tensor) -> torch.Tensor:
    """The world's gravity (0, 9.81, 0), +y down, in like's dtype."""
    g = torch.zeros(3, dtype=like.dtype, device=like.device)
    g[1] = GRAVITY
    return g


def body_from_cam(Rcw, tcw, R_bc, t_bc):
    """Tcw camera pose -> (R_wb, p_wb) body pose through T_bc."""
    Rwc, c_w = lie.se3_inverse(Rcw, tcw)
    R_wb = Rwc @ R_bc.transpose(-1, -2)
    p_wb = c_w - _mv(R_wb, t_bc)
    return R_wb, p_wb


def inertial_residual(R1, v1, p1, R2, v2, p2, bg, ba, pre: Pre, g_w=None):
    """The 9-dim preintegration residual [er, ev, ep] (EdgeInertial; Forster
    eq. 45)."""
    if g_w is None:
        g_w = gravity_w(R1)
    dR, dV, dP = corrected_deltas(pre, bg, ba)
    dt = pre.dt[..., None]
    R1t = R1.transpose(-1, -2)
    er = lie.so3_log(dR.transpose(-1, -2) @ R1t @ R2)
    ev = _mv(R1t, v2 - v1 - g_w * dt) - dV
    ep = _mv(R1t, p2 - p1 - v1 * dt - 0.5 * g_w * dt * dt) - dP
    return torch.cat([er, ev, ep], dim=-1)
