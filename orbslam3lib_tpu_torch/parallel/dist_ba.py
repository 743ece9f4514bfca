"""Landmark-sharded bundle adjustment with one Schur reduction per LM
iteration (port of `orbslam3lib_tpu/parallel/dist_ba.py`).

Landmarks, with the edges that observe them, are split into equal shards;
the cameras (tens) are replicated. Each shard builds, for its own landmarks,
the blocks H_pp, the couplings W, its part of the reduced camera system
S_loc = -W H_pp^-1 W^T, b_loc and H_cc, all with `local_ba`'s arithmetic.
Per iteration ONE reduction sums (S_loc, b_loc, H_cc) over the shards as one
flat buffer; shard 0 alone solves the 6C x 6C system, the step is broadcast,
and every shard back-substitutes its own landmarks with no further traffic.
From iteration `chi2_gate_after` on, edges failing the chi2 gate (or behind
the camera) after the update leave the next iterations, as in
`local_ba.bundle_adjust`.

The reference maps this onto a `shard_map` over a JAX device mesh. Here the
mesh has two forms with the same per-shard math:
- `DeviceMesh(devices)`: every shard in this process, shard s on
  `devices[s]`; the reduction gathers the buffers on `devices[0]`. A list
  may repeat a device (`["cuda:0"] * 2`, `["cpu"] * 4`): the shards then run
  one after another with the same arithmetic.
- `ProcessMesh(group)`: one shard per rank of a `torch.distributed` group
  (every rank holds the same problem, as the reference's processes do);
  per iteration one `all_reduce` and one `broadcast` from rank 0, and one
  `all_gather` of the landmarks at the end.

`partition_problem` sorts the edges by landmark and pads both axes, so that
the equal split of the edges is also the split by owning landmark. Only
edges of valid cameras and landmarks weigh, as in `local_ba` (the
reference's sharded BA also weighs an edge of an invalid landmark, so it
parts from its own plain solver on a real map: `_weighed_edges`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..mapping.local_ba import BAProblem, _build_normal_eq, _edge_terms
from ..utils import lie
from ..utils.robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight
from ..utils.smallmat import inv3


class DeviceMesh:
    """Shards on a list of devices of this process; sums on `devices[0]`."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a DeviceMesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def local_shards(self):
        """(shard index, device) of the shards this process runs."""
        return list(enumerate(self.devices))

    def camera_step(self, bufs, solve, shape):
        """The one reduction (every shard's buffer summed on `devices[0]`),
        then the solve there: `solve(sum)` -> the step of `shape`."""
        total = bufs[0].to(self.home)
        for b in bufs[1:]:
            total = total + b.to(self.home)
        return solve(total)

    def gather(self, parts):
        return torch.cat([p.to(self.home) for p in parts])


class ProcessMesh:
    """One shard per rank of a `torch.distributed` process group (the
    default group when None); this rank's shard lives on `device`."""

    def __init__(self, group=None, device: torch.device | str = "cpu"):
        import torch.distributed as dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.home = torch.device(device)

    def local_shards(self):
        return [(self.rank, self.home)]

    def camera_step(self, bufs, solve, shape):
        """One `all_reduce` of this rank's buffer, the solve on rank 0 and
        one `broadcast` of the step (of `shape`) from it."""
        import torch.distributed as dist
        buf, = bufs
        dist.all_reduce(buf, group=self.group)
        dx = solve(buf) if self.rank == 0 else \
            torch.empty(shape, dtype=buf.dtype, device=self.home)
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast(dx, src=src, group=self.group)
        return dx

    def gather(self, parts):
        """Every rank's part, in rank order (one `all_gather`)."""
        import torch.distributed as dist
        part, = parts
        out = [torch.empty_like(part) for _ in range(self.size)]
        dist.all_gather(out, part.contiguous(), group=self.group)
        return torch.cat(out)


def reduction_numel(n_cams: int) -> int:
    """Elements of the buffer reduced per iteration: S (6C x 6C), b (6C)
    and H_cc (C x 6 x 6), f32."""
    return 36 * n_cams * n_cams + 6 * n_cams + 36 * n_cams


def partition_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """The problem with its landmarks padded to a multiple of `n_shards`
    (zero points, invalid) and its edges sorted by landmark (stably) and
    regrouped into `n_shards` equal blocks, block s holding the edges of
    shard s's landmarks, padded with invalid edges of landmark 0 (reference
    :43-110; the same integer arrays)."""
    dev = prob.points.device
    P_ = prob.points.shape[0]
    P_pad = (-P_) % n_shards
    per = (P_ + P_pad) // n_shards

    def pad_pts(a, fill):
        return torch.cat([a, torch.full((P_pad,) + a.shape[1:], fill, dtype=a.dtype,
                                        device=dev)]) if P_pad else a

    e_pt = prob.e_pt.cpu().numpy()
    order = np.argsort(e_pt, kind="stable")
    shard_of = np.minimum(e_pt[order] // per, n_shards - 1)
    counts = np.bincount(shard_of, minlength=n_shards)
    E_shard = int(counts.max())
    # destination of each sorted edge in the regrouped layout
    dst = np.concatenate([s * E_shard + np.arange(counts[s]) for s in range(n_shards)])
    order_t = torch.as_tensor(order, device=dev)
    dst_t = torch.as_tensor(dst.astype(np.int64), device=dev)

    def regroup(a, fill=0):
        out = torch.full((E_shard * n_shards,) + a.shape[1:], fill, dtype=a.dtype,
                         device=dev)
        out[dst_t] = a[order_t]
        return out

    return BAProblem(
        cam_R=prob.cam_R, cam_t=prob.cam_t, cam_fixed=prob.cam_fixed,
        cam_valid=prob.cam_valid,
        points=pad_pts(prob.points, 0), pt_valid=pad_pts(prob.pt_valid, False),
        e_cam=regroup(prob.e_cam), e_pt=regroup(prob.e_pt), e_uv=regroup(prob.e_uv),
        e_inv_sigma2=regroup(prob.e_inv_sigma2), e_u_right=regroup(prob.e_u_right),
        e_stereo=regroup(prob.e_stereo, False), e_valid=regroup(prob.e_valid, False))


def _weighed_edges(e_valid, e_own, cam_ok, pt_ok):
    """The edges that weigh in a shard's normal equations: its own valid
    edges of valid cameras and landmarks, as `local_ba.bundle_adjust`'s.
    The reference's also weighs an edge of an invalid landmark (one the
    window gathered with a zero flag) into its camera, so its sharded
    global BA parts from its plain one on a real map (ROADMAP queue 3;
    `torch_parity.reference_dist_edges` puts that back)."""
    return e_valid & e_own & cam_ok & pt_ok


class _Shard:
    """Shard s of a partitioned problem on its device: its landmarks, its
    edges (indices local to the shard) and its per-iteration state."""

    def __init__(self, prob: BAProblem, s: int, n_shards: int, device, cam_params):
        per_pt = prob.points.shape[0] // n_shards
        per_e = prob.e_cam.shape[0] // n_shards
        pts, es = slice(s * per_pt, (s + 1) * per_pt), slice(s * per_e, (s + 1) * per_e)

        def on(x):
            return x.to(device)
        self.device = device
        self.cam_params = on(cam_params)
        self.cam_fixed, self.cam_valid = on(prob.cam_fixed), on(prob.cam_valid)
        self.points = on(prob.points[pts])
        self.pt_valid = on(prob.pt_valid[pts])
        e_pt = on(prob.e_pt[es]).long()
        off = s * per_pt
        self.e_own = (e_pt >= off) & (e_pt < off + per_pt)
        self.edges = dict(e_cam=on(prob.e_cam[es]), e_pt=torch.clamp(e_pt - off, 0, per_pt - 1),
                          e_uv=on(prob.e_uv[es]), e_inv_sigma2=on(prob.e_inv_sigma2[es]),
                          e_u_right=on(prob.e_u_right[es]), e_stereo=on(prob.e_stereo[es]))
        self.e_valid = _weighed_edges(on(prob.e_valid[es]), self.e_own,
                                      self.cam_valid[self.edges["e_cam"].long()],
                                      self.pt_valid[self.edges["e_pt"]])
        st = self.edges["e_stereo"]
        self.chi2_th = torch.where(st, CHI2_STEREO, CHI2_MONO)
        self.delta = torch.where(st, DELTA_STEREO, DELTA_MONO)
        self.inlier = torch.ones(self.e_valid.shape, dtype=self.points.dtype, device=device)
        self.free_pt = self.pt_valid.to(self.points.dtype)

    def problem(self, cam_R, cam_t, points) -> BAProblem:
        return BAProblem(cam_R=cam_R, cam_t=cam_t, cam_fixed=self.cam_fixed,
                         cam_valid=self.cam_valid, points=points, pt_valid=self.pt_valid,
                         e_valid=self.e_valid, **self.edges)

    def reduce_terms(self, cam_R, cam_t, free_cam, lm_lambda, cam_model, bf):
        """This shard's part of the camera system as one flat buffer
        [S_loc | b_loc | H_cc]; keeps H_pp^-1, W and b_p for the
        back-substitution."""
        p = self.problem(cam_R, cam_t, self.points)
        r, Jc, Jp, chi2, behind = _edge_terms(p, cam_model, self.cam_params, bf)
        w = (self.edges["e_inv_sigma2"] * huber_weight(chi2, self.delta) * self.inlier
             * self.e_valid * ~behind)
        Hcc, Hpp, W, b_c, b_p = _build_normal_eq(p, r, Jc, Jp, w)
        I3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
        fp = self.free_pt[:, None, None]
        Hpp = fp * Hpp + (1 - fp) * I3
        Hpp = Hpp + lm_lambda * Hpp * I3 + 1e-8 * I3
        self.W = W * free_cam[None, :, None, None] * self.free_pt[:, None, None, None]
        self.b_p = b_p * self.free_pt[:, None]
        self.Hpp_inv = inv3(Hpp)
        WHinv = torch.einsum("pcia,pab->pcib", self.W, self.Hpp_inv)
        S_loc = -torch.einsum("pcia,pdja->cidj", WHinv, self.W)
        b_loc = b_c - torch.einsum("pcia,pa->ci", WHinv, self.b_p)
        return torch.cat([S_loc.reshape(-1), b_loc.reshape(-1), Hcc.reshape(-1)])

    def back_substitute(self, dx_c):
        Wt_dxc = torch.einsum("pcia,ci->pa", self.W, dx_c)
        dx_p = -torch.einsum("pab,pb->pa", self.Hpp_inv, self.b_p + Wt_dxc)
        self.points = self.points + dx_p * self.free_pt[:, None]

    def gate(self, cam_R, cam_t, cam_model, bf):
        _, _, _, chi2n, behindn = _edge_terms(self.problem(cam_R, cam_t, self.points),
                                              cam_model, self.cam_params, bf)
        self.inlier = ((chi2n <= self.chi2_th) & ~behindn).to(self.points.dtype)


def _solve_camera_system(buf, C: int, free_cam, lm_lambda: float):
    """The summed buffer -> the camera step dx_c (C, 6) (shard 0's solve)."""
    n_S, n_b = 36 * C * C, 6 * C
    S = buf[:n_S].reshape(C, 6, C, 6).clone()
    b = buf[n_S:n_S + n_b].reshape(C, 6)
    Hcc = buf[n_S + n_b:].reshape(C, 6, 6)
    I6 = torch.eye(6, dtype=S.dtype, device=S.device)
    fc = free_cam[:, None, None]
    Hcc = fc * Hcc + (1 - fc) * I6
    Hcc = Hcc + lm_lambda * Hcc * I6 + 1e-8 * I6
    iiC = torch.arange(C, device=S.device)
    S[iiC, :, iiC, :] += Hcc
    b = b * free_cam[:, None]
    return -torch.linalg.solve_ex(S.reshape(C * 6, C * 6), b.reshape(-1))[0].reshape(C, 6)


def _update_cameras(cam_R, cam_t, dx_c):
    dR, dt = lie.se3_exp(dx_c)
    R2, t2 = lie.se3_compose(dR, dt, cam_R, cam_t)
    return lie.normalize_rotation(R2), t2


def dist_bundle_adjust(prob: BAProblem, cam_params, mesh, cam_model: int = 0,
                       bf: float = 0.0, n_iters: int = 10, lm_lambda: float = 1e-4,
                       chi2_gate_after: int = 5):
    """Distributed LM BA (reference :125-255) over a `DeviceMesh` or a
    `ProcessMesh`. `prob` comes from `partition_problem(prob, mesh.size)`.
    Returns (cam_R, cam_t, points, edge_inlier), all in the partitioned
    layout, on `mesh.home` (a DeviceMesh's `devices[0]`, a ProcessMesh's
    device; every rank the same)."""
    home = mesh.home
    shards = [_Shard(prob, s, mesh.size, d, cam_params) for s, d in mesh.local_shards()]
    cam_R, cam_t = prob.cam_R.to(home), prob.cam_t.to(home)
    C = cam_R.shape[0]
    free_cam = (prob.cam_valid & ~prob.cam_fixed).to(home).to(cam_R.dtype)

    def solve(buf):
        return _solve_camera_system(buf, C, free_cam, lm_lambda)
    for it in range(n_iters):
        bufs = [sh.reduce_terms(cam_R.to(sh.device), cam_t.to(sh.device),
                                free_cam.to(sh.device), lm_lambda, cam_model, bf)
                for sh in shards]
        dx_c = mesh.camera_step(bufs, solve, (C, 6)) * free_cam[:, None]
        cam_R, cam_t = _update_cameras(cam_R, cam_t, dx_c)
        for sh in shards:
            sh.back_substitute(dx_c.to(sh.device))
            if it >= chi2_gate_after:
                sh.gate(cam_R.to(sh.device), cam_t.to(sh.device), cam_model, bf)
    points = mesh.gather([sh.points for sh in shards])
    inlier = mesh.gather([((sh.inlier > 0) & sh.e_valid).to(torch.uint8) for sh in shards])
    return cam_R, cam_t, points, inlier.bool()
