"""The benchmark's scenes: a textured box world rendered on the card, the
camera trajectories through it, and the camera rays of each rig.

A plain-torch copy of the port's synthetic generator (`io/synthetic.py`:
`CorridorWorld`'s ray-plane renderer, its value-noise textures,
`orbit_pose_at` and `corridor_pose_at`), kept here so that a change to the
port cannot change the benchmark's inputs. Rays are computed once on the
host (numpy, with the radial-tangential unprojection for a raw rig); frames
are rendered on the card in batches, with image noise from a
`torch.Generator` seeded by the run's seed. The world, its textures and the
trajectories are fixed: the seed sets only the noise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

TEX_BASE_SCALE = 3.0
TEX_OCTAVES = 4
TEX_SIZE = 257
BACKGROUND = 90.0


def radtan_unproject(params, uv: np.ndarray, n_iter: int = 8) -> np.ndarray:
    """Distorted pixels -> z = 1 rays by the cv::undistortPoints fixed point,
    float32. params: fx, fy, cx, cy, k1, k2, p1, p2, k3."""
    p = np.asarray(params, np.float32)
    fx, fy, cx, cy = p[:4]
    k1, k2, p1, p2, k3 = p[4:9]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(n_iter):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv = 1.0 / np.where(np.abs(radial) < 1e-9, np.float32(1e-9), radial)
        x, y = (xd - dx) * inv, (yd - dy) * inv
    return np.stack([x, y, np.ones_like(x)], axis=-1)


@dataclass
class Rig:
    """One camera model shared by both eyes; the right eye sits `baseline`
    metres along the left camera's x axis."""
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)   # k1, k2, p1, p2, k3

    @classmethod
    def from_config(cls, cam: dict, baseline: float) -> "Rig":
        return cls(width=int(cam["width"]), height=int(cam["height"]),
                   fx=float(cam["fx"]), fy=float(cam["fy"]), cx=float(cam["cx"]),
                   cy=float(cam["cy"]), baseline=float(baseline),
                   dist=tuple(float(x) for x in cam.get("dist", (0.0,) * 5)))

    def rays(self) -> np.ndarray:
        """(H, W, 3) float32 z = 1 rays of every pixel."""
        u, v = np.meshgrid(np.arange(self.width, dtype=np.float32),
                           np.arange(self.height, dtype=np.float32))
        if any(d != 0.0 for d in self.dist):
            params = [self.fx, self.fy, self.cx, self.cy, *self.dist]
            uv = np.stack([u.reshape(-1), v.reshape(-1)], axis=-1)
            return radtan_unproject(params, uv).reshape(self.height, self.width, 3)
        return np.stack([(u - self.cx) / self.fx, (v - self.cy) / self.fy,
                         np.ones_like(u)], axis=-1).astype(np.float32)


def texture_tables(tex_seed: int, n_planes: int = 6) -> np.ndarray:
    """(planes, octaves, 257, 257) float32 value-noise lattices, plane i from
    `default_rng(tex_seed + i)`, as the port's generator draws them."""
    out = np.zeros((n_planes, TEX_OCTAVES, TEX_SIZE, TEX_SIZE), np.float32)
    for i in range(n_planes):
        rng = np.random.default_rng(tex_seed + i)
        for o in range(TEX_OCTAVES):
            out[i, o] = rng.uniform(0, 1, size=(TEX_SIZE, TEX_SIZE)).astype(np.float32)
    return out


class BoxWorld:
    """An axis-aligned box: x in [-half_w, half_w], y in [-half_h, half_h],
    z in [z0, z1]; x right, y down, z forward. Walls, floor, ceiling and the
    end wall at z1 are textured; with `back_wall` a sixth plane closes the
    box at z0 (a room)."""

    def __init__(self, half_w: float, half_h: float, z0: float, z1: float,
                 back_wall: bool, tex_seed: int, device: torch.device):
        self.half_w, self.half_h, self.z0, self.z1 = half_w, half_h, z0, z1
        self.back_wall = back_wall
        self.device = device
        self.tables = torch.from_numpy(texture_tables(tex_seed)).to(device)
        self.planes = [(0, -half_w, 0), (0, half_w, 1), (1, half_h, 2), (1, -half_h, 3),
                       (2, z1, 4)] + ([(2, z0, 5)] if back_wall else [])

    @classmethod
    def from_traffic(cls, w: dict, device) -> "BoxWorld":
        return cls(float(w["half_w"]), float(w["half_h"]), float(w["z0"]), float(w["z1"]),
                   bool(w.get("back_wall", False)), int(w["tex_seed"]), device)

    def _sample(self, plane: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(u)
        amp_sum = 0.0
        for o in range(TEX_OCTAVES):
            s = TEX_BASE_SCALE * (2.2 ** o)
            amp = 1.0 / (1.5 ** o)
            uu, vv = u * s, v * s
            fu0, fv0 = torch.floor(uu), torch.floor(vv)
            fu, fv = uu - fu0, vv - fv0
            iu0 = torch.remainder(fu0.to(torch.int64), 256)
            iv0 = torch.remainder(fv0.to(torch.int64), 256)
            T = self.tables[plane, o].reshape(-1)
            a = T[iv0 * TEX_SIZE + iu0]
            b = T[iv0 * TEX_SIZE + iu0 + 1]
            c = T[(iv0 + 1) * TEX_SIZE + iu0]
            d = T[(iv0 + 1) * TEX_SIZE + iu0 + 1]
            out = out + amp * (a * (1 - fu) * (1 - fv) + b * fu * (1 - fv)
                               + c * (1 - fu) * fv + d * fu * fv)
            amp_sum += amp
        return out / amp_sum

    def render(self, R_cw: torch.Tensor, c_w: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
        """Noise-free images (B, H, W) float32 of cameras with world-from-
        camera rotations R_cw (B, 3, 3) and centres c_w (B, 3)."""
        d_w = torch.einsum("hwk,bjk->bhwj", rays, R_cw)
        o = c_w[:, None, None, :]
        img = torch.full(d_w.shape[:-1], BACKGROUND, dtype=torch.float32, device=d_w.device)
        best = torch.full_like(img, math.inf)
        for axis, val, ti in self.planes:
            dn = d_w[..., axis]
            t = (val - o[..., axis]) / dn
            hit = (t > 0.05) & torch.isfinite(t)
            t_safe = torch.where(hit, t, torch.ones_like(t))
            p = o + t_safe[..., None] * d_w
            if axis == 0:
                in_b = (p[..., 1].abs() <= self.half_h) & (p[..., 2] >= self.z0) & \
                    (p[..., 2] <= self.z1)
                tu, tv = p[..., 2], p[..., 1]
            elif axis == 1:
                in_b = (p[..., 0].abs() <= self.half_w) & (p[..., 2] >= self.z0) & \
                    (p[..., 2] <= self.z1)
                tu, tv = p[..., 0], p[..., 2]
            else:
                in_b = (p[..., 0].abs() <= self.half_w) & (p[..., 1].abs() <= self.half_h)
                tu, tv = p[..., 0], p[..., 1]
            hit = hit & in_b & (t < best)
            tex = self._sample(ti, torch.where(hit, tu, torch.zeros_like(tu)),
                               torch.where(hit, tv, torch.zeros_like(tv)))
            img = torch.where(hit, 30.0 + 200.0 * tex, img)
            best = torch.where(hit, t, best)
        return img


def orbit_pose_at(ts, period: float, radius: float, bob: float, bob_cycles: float):
    """The camera circles the room's centre at `radius`, facing outwards, one
    revolution per `period` seconds, with a vertical bob of `bob` metres and
    `bob_cycles` cycles per revolution (a whole number closes the path on
    itself after one revolution). Returns (R_cw (T, 3, 3), c_w (T, 3)),
    float64."""
    ts = np.asarray(ts, np.float64)
    phi = 2.0 * np.pi * ts / period
    c_w = np.stack([radius * np.sin(phi), bob * np.sin(bob_cycles * phi),
                    radius * np.cos(phi)], axis=-1)
    fwd = np.stack([np.sin(phi), np.zeros_like(phi), np.cos(phi)], axis=-1)
    return _look(fwd), c_w


def corridor_pose_at(ts, speed: float, wiggle: float):
    """Down the corridor at `speed` m/s with a lateral sway of `wiggle`
    metres, looking along the velocity. Returns (R_cw, c_w), float64."""
    ts = np.asarray(ts, np.float64)
    z = speed * ts
    c_w = np.stack([wiggle * np.sin(0.35 * z), 0.4 * wiggle * np.sin(0.23 * z + 1.0), z],
                   axis=-1)
    fwd = np.stack([wiggle * 0.35 * np.cos(0.35 * z) * speed,
                    0.4 * wiggle * 0.23 * np.cos(0.23 * z + 1.0) * speed,
                    np.full_like(z, speed)], axis=-1)
    fwd /= np.linalg.norm(fwd, axis=-1, keepdims=True)
    return _look(fwd), c_w


def _look(fwd: np.ndarray) -> np.ndarray:
    right = np.cross(np.broadcast_to(np.array([0.0, 1.0, 0.0]), fwd.shape), fwd)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=-1)


def pose_at(traj: dict, ts):
    """The traffic file's trajectory at times `ts`: (R_cw, c_w) float64."""
    kind = traj["kind"]
    if kind == "orbit":
        return orbit_pose_at(ts, float(traj["period_s"]), float(traj["radius"]),
                             float(traj["bob"]), float(traj["bob_cycles"]))
    if kind == "corridor":
        return corridor_pose_at(ts, float(traj["speed"]), float(traj["wiggle"]))
    raise ValueError(f"unknown trajectory kind {kind!r}")


def render_stereo(world: BoxWorld, rig: Rig, R_cw: np.ndarray, c_w: np.ndarray,
                  noise_sigma: float, gen: torch.Generator, batch: int = 16) -> np.ndarray:
    """uint8 stereo pairs (T, 2, H, W) on the host, rendered on the card for
    left-camera poses (R_cw, c_w): the right eye `rig.baseline` along the
    camera's x axis, Gaussian image noise of `noise_sigma` grey levels drawn
    from `gen`, clipped to [0, 255] and truncated to uint8."""
    dev = world.device
    rays = torch.from_numpy(rig.rays()).to(dev)
    n = len(R_cw)
    out = torch.empty((n, 2, rig.height, rig.width), dtype=torch.uint8,
                      pin_memory=dev.type == "cuda")
    R_all = torch.from_numpy(np.asarray(R_cw, np.float32)).to(dev)
    c_all = torch.from_numpy(np.asarray(c_w, np.float32)).to(dev)
    base = torch.tensor([rig.baseline, 0.0, 0.0], dtype=torch.float32, device=dev)
    for s in range(0, n, batch):
        R, c = R_all[s:s + batch], c_all[s:s + batch]
        c_r = c + R @ base
        img = world.render(torch.cat([R, R]), torch.cat([c, c_r]), rays)
        img = img + noise_sigma * torch.randn(img.shape, generator=gen, device=dev)
        img = torch.clamp(img, 0.0, 255.0).to(torch.uint8)
        b = R.shape[0]
        out[s:s + b].copy_(torch.stack([img[:b], img[b:]], dim=1), non_blocking=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out.numpy()
