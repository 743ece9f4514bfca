"""IMU preintegration on SO(3) and inertial state prediction (port of
`orbslam3lib_tpu/tracking/imu.py`; ORB-SLAM3's ImuTypes: Preintegrated with
its 15x15 covariance and the bias Jacobians JRg/JVg/JVa/JPg/JPa,
IntegrateNewMeasurement, after Forster et al.'s on-manifold
preintegration).

A `Preintegrated` is a dataclass of tensors with an optional leading batch
dimension: `Preintegrated.stack` stands in for the reference's
`tree_map(jnp.stack)`, `pre[i]` takes one out of a stack. Each also keeps
its total time on the host (`dt_host`): the host knows the sum of the `dts`
it fed, so reading `pre.dt` back from the card is never needed.

`integrate` runs a batch of preintegrations over the same samples at once
(the tracker's frame and keyframe preintegrations are one batch of two, with
their own starting states and biases): whatever does not depend on the
running state (the body rates and accelerations, each sample's rotation
increment, right Jacobian and noise) is computed for all samples in one go,
and the recurrence is a Python loop of small batched ops, in the reference's
order inside a step: position and velocity first, with the dR from before
the step, then the covariance, the bias Jacobians and the rotation.

State conventions as in the reference: R_wb (world-from-body), v_w, p_w;
gravity g_w points down, +y in the world (io/synthetic.py).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence, Union

import numpy as np
import torch

from ..device import to_device
from ..utils import lie

GRAVITY = 9.81

TENSOR_FIELDS = ("dt", "dR", "dV", "dP", "cov", "cov_bias", "JRg", "JVg", "JVa",
                  "JPg", "JPa", "bg", "ba")


@dataclass
class Preintegrated:
    """Preintegrated IMU measurements between two frames or keyframes.

    cov (9, 9) over [phi, v, p] and cov_bias (6, 6), the accumulated bias
    random walk: together the reference's 15x15 covariance, whose cross
    blocks stay zero. JRg = d dR / d bg, JVg, JVa, JPg, JPa likewise; bg, ba
    the linearisation point. Every tensor may carry one leading batch
    dimension; `dt_host` is the total time as a float (a tuple of floats for
    a batch)."""
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
    dt_host: Union[float, tuple] = 0.0

    @staticmethod
    def stack(pres: Sequence["Preintegrated"]) -> "Preintegrated":
        """A batch of single preintegrations along a new leading dimension."""
        return Preintegrated(**{f: torch.stack([getattr(p, f) for p in pres])
                                for f in TENSOR_FIELDS},
                             dt_host=tuple(float(p.dt_host) for p in pres))

    def __getitem__(self, i: int) -> "Preintegrated":
        return Preintegrated(**{f: getattr(self, f)[i] for f in TENSOR_FIELDS},
                             dt_host=float(self.dt_host[i]))

    def to(self, device) -> "Preintegrated":
        return replace(self, **{f: getattr(self, f).to(device) for f in TENSOR_FIELDS})

    @staticmethod
    def from_arrays(pre, device="cpu") -> "Preintegrated":
        """From anything with the reference's field names holding arrays
        (the JAX package's `Preintegrated`, as numpy): the state carried
        across packages. Batched when its `dt` has a dimension."""
        out = {f: torch.as_tensor(np.array(getattr(pre, f), np.float32), device=device)
               for f in TENSOR_FIELDS}
        dt = np.asarray(getattr(pre, "dt"), np.float64)
        dt_host = float(dt) if dt.ndim == 0 else tuple(float(x) for x in dt)
        return Preintegrated(**out, dt_host=dt_host)


def empty_preintegrated(bg=None, ba=None, device="cpu") -> Preintegrated:
    """A preintegration over no time, linearised at (bg, ba) (zeros when
    None; given tensors set the device)."""
    if isinstance(bg, torch.Tensor):
        device = bg.device
    f32 = dict(dtype=torch.float32, device=device)
    z3 = torch.zeros(3, **f32)
    eye = torch.eye(3, **f32)
    Z = torch.zeros(3, 3, **f32)
    return Preintegrated(
        dt=torch.zeros((), **f32), dR=eye, dV=z3, dP=z3.clone(),
        cov=torch.zeros(9, 9, **f32), cov_bias=torch.zeros(6, 6, **f32),
        JRg=Z, JVg=Z.clone(), JVa=Z.clone(), JPg=Z.clone(), JPa=Z.clone(),
        bg=z3.clone() if bg is None else bg.to(**f32),
        ba=z3.clone() if ba is None else ba.to(**f32), dt_host=0.0)


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr(w) = Jl(-w) (ImuTypes.h:193-199)."""
    return lie.so3_left_jacobian(-w)


def _mv(M, v):
    return lie._matvec(M, v)


def integrate(pre: Preintegrated, gyro, acc, dts, sigma_g: float, sigma_a: float,
              walk_g: float = 0.0, walk_a: float = 0.0) -> Preintegrated:
    """Integrate (N, 3) gyro / accel samples with per-sample dts (N,) into
    `pre` (single or batched; every batch entry takes the same samples from
    its own state and bias). sigma_g / sigma_a: discrete noise sigmas
    (density times sqrt(freq)); walk_g / walk_a: the bias random-walk
    densities, accumulated into cov_bias as walk^2 dt. Samples are tensors
    on pre's device or host arrays (uploaded here). `dt_host` grows by the
    sum of host dts; dts given as a tensor leave it to the caller (nothing
    is read back, so the call can be captured in a CUDA graph)."""
    dev = pre.dR.device
    f32 = dict(dtype=torch.float32, device=dev)
    host_dts = not isinstance(dts, torch.Tensor)

    def upload(x):
        # host arrays from pinned memory: a pageable copy would wait for the card
        if isinstance(x, torch.Tensor):
            return x.to(**f32)
        return to_device(np.asarray(x, np.float32), dev)

    g, a, d = upload(gyro), upload(acc), upload(dts)
    n = int(d.shape[0])
    if n == 0:
        return pre
    batched = pre.dR.dim() == 3
    lead = pre.dR.shape[:-2]
    # the state-independent parts of every step, for all samples at once
    w = g - pre.bg[..., None, :]                       # (..., N, 3)
    ah = a - pre.ba[..., None, :]
    wdt = w * d[:, None]
    dRi = lie.so3_exp(wdt)                             # (..., N, 3, 3)
    Jr = so3_right_jacobian(wdt)
    W = lie.hat(ah)
    dt_c = torch.clamp(d, min=1e-6)
    eye3 = torch.eye(3, **f32)
    eye9 = torch.eye(9, **f32)
    Z3 = torch.zeros(lead + (3, 3), **f32)
    # B N B^T's noise blocks: Ng / dt and Na / dt per sample
    sg, sa, wg, wa = (torch.full((), float(x), **f32) for x in (sigma_g, sigma_a, walk_g, walk_a))
    ng = (sg * sg) / dt_c                              # (N,), f32 as the reference
    na = (sa * sa) / dt_c
    walk = torch.diag(torch.cat([(wg * wg).expand(3), (wa * wa).expand(3)]))

    dR, dV, dP, cov, cov_bias = pre.dR, pre.dV, pre.dP, pre.cov, pre.cov_bias
    JRg, JVg, JVa, JPg, JPa = pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa
    dt_tot = pre.dt
    for k in range(n):
        dt = d[k]
        dt2 = dt * dt
        dRi_k, Jr_k, W_k, ah_k = dRi[..., k, :, :], Jr[..., k, :, :], W[..., k, :, :], ah[..., k, :]
        acc_w = _mv(dR, ah_k)                          # into frame i, pre-update dR
        dP = dP + dV * dt + 0.5 * acc_w * dt2
        dV = dV + acc_w * dt
        # covariance over [phi, v, p] (Forster A.7-A.9)
        dRW = dR @ W_k
        A = torch.cat([
            torch.cat([dRi_k.transpose(-1, -2), Z3, Z3], dim=-1),
            torch.cat([-dRW * dt, eye3.expand_as(dR), Z3], dim=-1),
            torch.cat([-0.5 * dRW * dt2, eye3.expand_as(dR) * dt, eye3.expand_as(dR)], dim=-1),
        ], dim=-2)
        Bg = Jr_k * dt                                 # the phi rows' gyro block
        Ba = torch.cat([dR * dt, 0.5 * dR * dt2], dim=-2)  # the v, p rows' accel block
        BNB = torch.zeros(lead + (9, 9), **f32)
        BNB[..., :3, :3] = Bg @ Bg.transpose(-1, -2) * ng[k]
        BNB[..., 3:, 3:] = Ba @ Ba.transpose(-1, -2) * na[k]
        cov = A @ cov @ A.transpose(-1, -2) + BNB
        cov_bias = cov_bias + walk * dt
        # bias Jacobians (position and velocity before the rotation)
        JPa = JPa + JVa * dt - 0.5 * dR * dt2
        JPg = JPg + JVg * dt - 0.5 * dRW @ JRg * dt2
        JVa = JVa - dR * dt
        JVg = JVg - dRW @ JRg * dt
        JRg = dRi_k.transpose(-1, -2) @ JRg - Jr_k * dt
        dR = lie.normalize_rotation(dR @ dRi_k)
        dt_tot = dt_tot + dt
    add = float(np.sum(np.asarray(dts, np.float32), dtype=np.float64)) if host_dts else 0.0
    dt_host = tuple(x + add for x in pre.dt_host) if batched else float(pre.dt_host) + add
    return Preintegrated(dt=dt_tot, dR=dR, dV=dV, dP=dP, cov=cov, cov_bias=cov_bias,
                         JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa, bg=pre.bg, ba=pre.ba,
                         dt_host=dt_host)


def corrected_deltas(pre: Preintegrated, bg_new, ba_new):
    """First-order bias-corrected deltas (GetDeltaRotation / Velocity /
    Position, ImuTypes.cc): the stored bias Jacobians applied to the bias
    change. Batched over pre's leading dimension."""
    dbg = bg_new - pre.bg
    dba = ba_new - pre.ba
    dR = pre.dR @ lie.so3_exp(_mv(pre.JRg, dbg))
    dV = pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)
    dP = pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)
    return dR, dV, dP


def gravity_w(like: torch.Tensor) -> torch.Tensor:
    """The world's gravity vector (0, 9.81, 0), +y down, on like's device
    (filled there: no copy from the host)."""
    g = torch.zeros(3, dtype=torch.float32, device=like.device)
    return g.index_fill_(0, torch.ones(1, dtype=torch.long, device=like.device), GRAVITY)


def predict_state(R_wb, v_w, p_w, pre: Preintegrated, bg, ba, g_w=None):
    """IMU dead reckoning (Tracking::PredictStateIMU, Tracking.cc:1791):
    (R, v, p) carried through the bias-corrected deltas."""
    if g_w is None:
        g_w = gravity_w(R_wb)
    dR, dV, dP = corrected_deltas(pre, bg, ba)
    dt = pre.dt
    R2 = lie.normalize_rotation(R_wb @ dR)
    v2 = v_w + g_w * dt + _mv(R_wb, dV)
    p2 = p_w + v_w * dt + 0.5 * g_w * dt * dt + _mv(R_wb, dP)
    return R2, v2, p2


def body_from_cam(Rcw, tcw, R_bc, t_bc):
    """Tcw camera pose -> (R_wb, p_wb) body pose through T_bc
    (p_b = R_bc p_c + t_bc; ImuCamPose, G2oTypes.h:74)."""
    Rwc, c_w = lie.se3_inverse(Rcw, tcw)
    R_wb = Rwc @ R_bc.transpose(-1, -2)
    p_wb = c_w - _mv(R_wb, t_bc)
    return R_wb, p_wb


def cam_from_body(R_wb, p_wb, R_bc, t_bc):
    """(R_wb, p_wb) body pose -> Tcw camera pose through T_bc."""
    R_wc = R_wb @ R_bc
    c_w = p_wb + _mv(R_wb, t_bc)
    Rcw = R_wc.transpose(-1, -2)
    return Rcw, -_mv(Rcw, c_w)


def inertial_residual(R1, v1, p1, R2, v2, p2, bg, ba, pre: Preintegrated, g_w=None):
    """The 9-dim preintegration residual [er, ev, ep] (EdgeInertial,
    G2oTypes.h:495; Forster eq. 45). Batched over leading dimensions."""
    if g_w is None:
        g_w = gravity_w(R1)
    dR, dV, dP = corrected_deltas(pre, bg, ba)
    dt = pre.dt[..., None]
    R1t = R1.transpose(-1, -2)
    er = lie.so3_log(dR.transpose(-1, -2) @ R1t @ R2)
    ev = _mv(R1t, v2 - v1 - g_w * dt) - dV
    ep = _mv(R1t, p2 - p1 - v1 * dt - 0.5 * g_w * dt * dt) - dP
    return torch.cat([er, ev, ep], dim=-1)
