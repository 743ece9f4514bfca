"""The VI window's two kernels (`csrc/vi_opt.cu`): one launch per evaluation
of the normal equations, one per Gauss-Newton step.

`vi_eval` reduces each edge's analytic J^T W J and J^T W r per keyframe
chunk and per gap, `vi_step` sums them into the block-tridiagonal H, solves
it and returns x - dx with each keyframe's state there: together one
iteration of `mapping.vi_ba.local_inertial_ba` on its pinhole, per-keyframe
bias layout. Their plain version is `vi_ba._normal_equations_torch`.

`pack` lays a `vi_ba.Window` out for them once per window; the calls take
float32 CUDA tensors and raise on anything else. Each call allocates its
outputs and launches once on the current stream: no sync, no buffer kept
from one call to the next, nothing read back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import cameras
from ..utils.robust import DELTA_MONO, DELTA_STEREO
from . import _cuda_lib

eval_launches = 0   # kernel launches made by this process
step_launches = 0

EVAL_ROWS = 128     # visual rows a block of vi_eval (EVAL_THREADS)
MAX_C = 61          # keyframes whose H fits a block's 227 KB of shared memory
# a gap's row of the packed inputs, in csrc/vi_opt.cu's order (G_* offsets):
# the preintegration's fields, then L9, Lbg_rw, Lba_rw and gap_ok
GAP_FIELDS = {"dt": (), "dR": (3, 3), "dV": (3,), "dP": (3,), "JRg": (3, 3), "JVg": (3, 3),
              "JVa": (3, 3), "JPg": (3, 3), "JPa": (3, 3), "bg": (3,), "ba": (3,)}
GAP_STRIDE = 167
NVIS, NGAP, NPRIOR = 27, 495, 12

_fns = None         # (vi_eval_launch, vi_step_launch), resolved once
_F32, _F64 = torch.float32, torch.float64


class Packed(NamedTuple):
    """A window laid out for the kernels (csrc/vi_opt.cu's strides)."""
    kf: torch.Tensor      # (C, 17): R0, t0, v0, free_pose, free_vel
    gap: torch.Tensor     # (C - 1, 167): GAP_FIELDS, L9, Lbg_rw, Lba_rw, gap_ok
    obs: torch.Tensor     # (C, F, 8): p_w, uv, u_right, inv_sigma2, kind (0, 1 mono, 2 stereo)
    cst: torch.Tensor     # (22,): bg0, ba0, R_bc, t_bc, [fx, fy, cx, cy]
    bf: float

    @property
    def C(self) -> int:
        return self.kf.shape[0]

    @property
    def F(self) -> int:
        return self.obs.shape[1]

    @property
    def part_size(self) -> int:
        nch = -(-self.F // EVAL_ROWS)
        return self.C * nch * NVIS + (self.C - 1) * NGAP + NPRIOR


def reset_count() -> None:
    global eval_launches, step_launches
    eval_launches = step_launches = 0


def _entry_points():
    global _fns
    if _fns is None:
        lib = _cuda_lib.library()
        _fns = (lib.vi_eval_launch, lib.vi_step_launch)
    return _fns


def _check(x: torch.Tensor, shape, dtype, idx: int, name: str) -> None:
    if (not x.is_cuda or x.get_device() != idx or tuple(x.shape) != tuple(shape)
            or x.dtype is not dtype):
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype} on cuda:{idx}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")


def pack(w) -> Packed:
    """Lay out a `vi_ba.Window` (pinhole, per-keyframe biases, float32 on
    one CUDA device) for the kernels: four concatenations."""
    C, F = w.C, w.p_w.shape[1]
    if not w.R0.is_cuda:
        raise ValueError(f"the VI kernels run on CUDA tensors, got {w.R0.device}")
    if not w.per_kf_bias or w.cam_model != cameras.PINHOLE:
        raise ValueError("the VI kernels take the pinhole camera and per-keyframe biases")
    if not 1 <= C <= MAX_C:
        raise ValueError(f"the VI kernels take 1 to {MAX_C} keyframes, got {C}")
    idx = w.R0.get_device()
    pre = w.pres
    G = C - 1
    checks = [(w.R0, (C, 3, 3), "R0"), (w.t0, (C, 3), "t0"), (w.v0, (C, 3), "v0"),
              (w.free_pose, (C, 1), "free_pose"), (w.free_vel, (C, 1), "free_vel"),
              (w.bg0, (3,), "bg0"), (w.ba0, (3,), "ba0"), (w.R_bc, (3, 3), "R_bc"),
              (w.t_bc, (3,), "t_bc"), (w.p_w, (C, F, 3), "p_w"), (w.uv, (C, F, 2), "uv"),
              (w.u_right, (C, F), "u_right"), (w.w_sig, (C, F), "w_sig"),
              (w.obs_f, (C, F), "obs_f"), (w.L9, (G, 9, 9), "L9"),
              (w.Lbg_rw, (G, 3, 3), "Lbg_rw"), (w.Lba_rw, (G, 3, 3), "Lba_rw"),
              (w.gap_ok, (G,), "gap_ok")]
    checks += [(getattr(pre, f), (G, *shape), f"pres.{f}") for f, shape in GAP_FIELDS.items()]
    for x, shape, name in checks:
        _check(x, shape, _F32, idx, name)
    _check(w.is_stereo, (C, F), torch.bool, idx, "is_stereo")
    if w.cam_params.numel() < 4:
        raise ValueError("cam_params: expected [fx, fy, cx, cy]")
    _check(w.cam_params[:4], (4,), _F32, idx, "cam_params")
    kf = torch.cat([w.R0.reshape(C, 9), w.t0, w.v0, w.free_pose, w.free_vel], dim=1)
    gap = torch.cat([getattr(pre, f).reshape(G, -1) for f in GAP_FIELDS]
                    + [w.L9.reshape(G, 81), w.Lbg_rw.reshape(G, 9), w.Lba_rw.reshape(G, 9),
                       w.gap_ok[:, None]], dim=1)
    assert gap.shape[1] == GAP_STRIDE
    kind = w.obs_f * (1.0 + w.is_stereo.to(_F32))
    obs = torch.cat([w.p_w, w.uv, w.u_right[..., None], w.w_sig[..., None], kind[..., None]],
                    dim=-1)
    cst = torch.cat([w.bg0, w.ba0, w.R_bc.reshape(9), w.t_bc, w.cam_params[:4]])
    return Packed(kf=kf, gap=gap, obs=obs, cst=cst, bf=float(w.bf))


def _launch(fn, name: str, idx: int, ins, args) -> None:
    """Launch `fn` on device idx's current stream with the pointers of `ins`
    (contiguous), then `args`."""
    ins = [x.contiguous() for x in ins]
    call = (*[x.data_ptr() for x in ins], *args, torch._C._cuda_getCurrentRawStream(idx))
    if torch.cuda.current_device() == idx:
        err = fn(*call)
    else:
        with torch.cuda.device(idx):
            err = fn(*call)
    _cuda_lib.check(err, name)


def vi_eval(p: Packed, x: torch.Tensor) -> torch.Tensor:
    """The normal equations' partial sums at x (15 C,): one float64 slot per
    visual chunk, per gap and for the bias prior (`vi_step` reads them)."""
    global eval_launches
    idx = p.kf.get_device()
    _check(x, (15 * p.C,), _F32, idx, "x")
    part = torch.empty(p.part_size, dtype=_F64, device=x.device)
    _launch(_entry_points()[0], "vi_eval_launch", idx, (p.kf, p.gap, p.obs, p.cst, x),
            (p.bf, DELTA_MONO, DELTA_STEREO, p.C, p.F, part.data_ptr()))
    eval_launches += 1
    return part


def vi_step(p: Packed, part: torch.Tensor, x: torch.Tensor, blocks: bool = False):
    """One Gauss-Newton step from x with one `vi_eval`'s slots: (x - dx,
    R (C, 3, 3), t, v, bg, ba (C, 3)), each a new tensor; with `blocks`
    also H's blocks and g as summed (float64: D (C, 15, 15) with the
    damping, B (C - 1, 15, 15) the blocks above the diagonal, g (C, 15))."""
    global step_launches
    idx = p.kf.get_device()
    C = p.C
    _check(x, (15 * C,), _F32, idx, "x")
    _check(part, (p.part_size,), _F64, idx, "part")
    dev = x.device
    outs = [torch.empty(15 * C, dtype=_F32, device=dev),
            torch.empty((C, 3, 3), dtype=_F32, device=dev)]
    outs += [torch.empty((C, 3), dtype=_F32, device=dev) for _ in range(4)]
    blk = torch.empty(225 * (2 * C - 1) + 15 * C, dtype=_F64, device=dev) if blocks else None
    _launch(_entry_points()[1], "vi_step_launch", idx, (p.kf, p.cst, part, x),
            (C, p.F, *[o.data_ptr() for o in outs], blk.data_ptr() if blocks else None))
    step_launches += 1
    if not blocks:
        return tuple(outs)
    D = blk[:225 * C].view(C, 15, 15)
    B = blk[225 * C:225 * (2 * C - 1)].view(C - 1, 15, 15)
    return tuple(outs) + (D, B, blk[225 * (2 * C - 1):].view(C, 15))


def normal_equations(p: Packed, x: torch.Tensor):
    """(H (15 C, 15 C), g (15 C,)) float64 as the kernels assemble them at x,
    dense: the contract of `vi_ba._normal_equations_torch` (two launches)."""
    *_, D, B, g = vi_step(p, vi_eval(p, x), x, blocks=True)
    C = p.C
    H = torch.zeros(15 * C, 15 * C, dtype=_F64, device=x.device)
    for k in range(C):
        s = slice(15 * k, 15 * k + 15)
        H[s, s] = D[k]
        if k < C - 1:
            n = slice(15 * k + 15, 15 * k + 30)
            H[s, n] = B[k]
            H[n, s] = B[k].T
    return H, g.reshape(-1)
