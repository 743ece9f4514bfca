"""Synthetic stereo sequence generator: a textured corridor world rendered
analytically, with exact ground-truth trajectory (numpy only).

A port of `orbslam3lib_tpu/io/synthetic.py` without its JAX use: the
distorted-camera unprojections that the reference renders through its jnp
camera models are numpy here. Given the same parameters and seed it renders
the same frames, so a machine without JAX renders the bench's own orbit
sequence, and `synth_imu` draws the same IMU samples as the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..config import SlamConfig


def _radtan_unproject(params: np.ndarray, uv: np.ndarray, n_iter: int = 8) -> np.ndarray:
    """Distorted pixels -> z=1 rays by the cv::undistortPoints fixed point
    (reference `utils/cameras.radtan_unproject`), in float32."""
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


def _kb8_unproject(params: np.ndarray, uv: np.ndarray, n_iter: int = 10) -> np.ndarray:
    """Kannala-Brandt pixels -> z=1 rays by Newton on d(theta) (reference
    `utils/cameras.kb8_unproject`), in float32."""
    p = np.asarray(params, np.float32)
    fx, fy, cx, cy = p[:4]
    k = p[4:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    d = np.sqrt(mx * mx + my * my)
    th = d
    for _ in range(n_iter):
        t2 = th * th
        f = th * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3])))) - d
        fp = 1.0 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2] + t2 * 9 * k[3])))
        th = th - f / np.where(np.abs(fp) < 1e-9, np.float32(1e-9), fp)
    scale = np.tan(th) / np.where(d < 1e-9, np.float32(1e-9), d)
    scale = np.where(d < 1e-9, np.ones_like(scale), scale)
    return np.stack([mx * scale, my * scale, np.ones_like(mx)], axis=-1)


@dataclass
class StereoRig:
    fx: float = 300.0
    fy: float = 300.0
    cx: float = 320.0
    cy: float = 200.0
    width: int = 640
    height: int = 400
    baseline: float = 0.11
    model: str = "pinhole"            # "pinhole" | "kannala_brandt8"
    k: tuple = (0.0, 0.0, 0.0, 0.0)   # KB8 theta-polynomial coefficients
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)  # pinhole radtan k1,k2,p1,p2,k3

    @property
    def params(self) -> np.ndarray:
        if self.model == "pinhole":
            if any(d != 0.0 for d in self.dist):
                return np.asarray([self.fx, self.fy, self.cx, self.cy,
                                   *self.dist], dtype=np.float32)
            return np.asarray([self.fx, self.fy, self.cx, self.cy], dtype=np.float32)
        return np.asarray([self.fx, self.fy, self.cx, self.cy, *self.k],
                          dtype=np.float32)

    @property
    def bf(self) -> float:
        return self.fx * self.baseline


class _NoiseTexture:
    """Multi-octave value noise over an integer lattice (tileable by hash)."""

    def __init__(self, seed: int, base_scale: float = 0.25, octaves: int = 4):
        rng = np.random.default_rng(seed)
        self.tables = [rng.uniform(0, 1, size=(257, 257)).astype(np.float32)
                       for _ in range(octaves)]
        self.base_scale = base_scale
        self.octaves = octaves

    def sample(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        out = np.zeros_like(u, dtype=np.float32)
        amp_sum = 0.0
        for o in range(self.octaves):
            s = self.base_scale * (2.2 ** o)
            amp = 1.0 / (1.5 ** o)
            uu, vv = u * s, v * s
            iu, iv = np.floor(uu).astype(np.int64), np.floor(vv).astype(np.int64)
            fu, fv = (uu - iu).astype(np.float32), (vv - iv).astype(np.float32)
            T = self.tables[o]
            iu0, iv0 = iu % 256, iv % 256
            a = T[iv0, iu0]
            b = T[iv0, iu0 + 1]
            c = T[iv0 + 1, iu0]
            d = T[iv0 + 1, iu0 + 1]
            val = (a * (1 - fu) * (1 - fv) + b * fu * (1 - fv)
                   + c * (1 - fu) * fv + d * fu * fv)
            out += amp * val
            amp_sum += amp
        return out / amp_sum


def ray_grid(rig: StereoRig) -> np.ndarray:
    """(H, W, 3) z = 1 camera rays of every pixel of the rig's camera."""
    H, W = rig.height, rig.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    if rig.model == "kannala_brandt8":
        uv = np.stack([u.reshape(-1), v.reshape(-1)], axis=-1)
        return _kb8_unproject(rig.params, uv).reshape(H, W, 3)
    if any(d != 0.0 for d in rig.dist):
        uv = np.stack([u.reshape(-1), v.reshape(-1)], axis=-1)
        return _radtan_unproject(rig.params, uv).reshape(H, W, 3)
    return np.stack([(u - rig.cx) / rig.fx, (v - rig.cy) / rig.fy,
                     np.ones_like(u)], axis=-1)


@dataclass
class CorridorWorld:
    """Axis-aligned corridor: x in [-hw, hw], y in [-hh, hh], z in [z0, z1].
    World frame: x right, y down, z forward. With `back_wall` a sixth
    textured plane closes the box at z0 (a room), enabling 360-degree
    orbit sequences for loop-closure benchmarks."""
    half_w: float = 2.0
    half_h: float = 1.5
    z0: float = -5.0
    z1: float = 60.0
    tex_seed: int = 42
    back_wall: bool = False

    def __post_init__(self):
        s = self.tex_seed
        # one texture per plane: left, right, floor, ceiling, end wall,
        # (optional) back wall
        self.tex = [_NoiseTexture(s + i, base_scale=3.0) for i in range(6)]

    def _trace(self, R_cw: np.ndarray, c_w: np.ndarray, rig: StereoRig, rays=None,
               img=None) -> np.ndarray:
        """The first plane each pixel's ray hits: returns the ray parameter
        of the hit, (H, W) float32, inf where no plane is hit; with `img`,
        each hit's texture value is written into it."""
        H, W = rig.height, rig.width
        d_c = ray_grid(rig) if rays is None else rays
        d_w = d_c @ R_cw.T
        o = c_w

        best_t = np.full((H, W), np.inf, dtype=np.float32)
        planes = [
            (0, -self.half_w, 0),   # left wall   x = -hw, tex coords (z, y)
            (0, self.half_w, 1),    # right wall
            (1, self.half_h, 2),    # floor       y = +hh, tex (x, z)
            (1, -self.half_h, 3),   # ceiling
            (2, self.z1, 4),        # end wall    z = z1, tex (x, y)
        ]
        if self.back_wall:
            planes.append((2, self.z0, 5))  # back wall z = z0 (room mode)
        for axis, val, ti in planes:
            dn = d_w[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (val - o[axis]) / dn
            hit = (t > 0.05) & np.isfinite(t)
            # mask non-intersecting rays BEFORE the multiply: inf * 0 = NaN
            # would flow through the texture lookup as a RuntimeWarning
            t_safe = np.where(hit, t, 1.0)
            p = o[None, None, :] + t_safe[..., None] * d_w
            if axis == 0:
                in_b = (np.abs(p[..., 1]) <= self.half_h) & \
                       (p[..., 2] >= self.z0) & (p[..., 2] <= self.z1)
                tu, tv = p[..., 2], p[..., 1]
            elif axis == 1:
                in_b = (np.abs(p[..., 0]) <= self.half_w) & \
                       (p[..., 2] >= self.z0) & (p[..., 2] <= self.z1)
                tu, tv = p[..., 0], p[..., 2]
            else:
                in_b = (np.abs(p[..., 0]) <= self.half_w) & \
                       (np.abs(p[..., 1]) <= self.half_h)
                tu, tv = p[..., 0], p[..., 1]
            hit &= in_b & (t < best_t)
            if img is not None:
                tex_val = self.tex[ti].sample(tu[hit], tv[hit])
                img[hit] = 30.0 + 200.0 * tex_val
            best_t[hit] = t[hit]
        return best_t

    def render(self, R_cw: np.ndarray, c_w: np.ndarray, rig: StereoRig,
               noise_sigma: float = 1.5, rng=None, rays=None) -> np.ndarray:
        """Render one grayscale image for camera with world-from-cam rotation
        R_cw (3,3) and center c_w (3,). `rays`: the rig's `ray_grid`, when the
        caller has it (it does not change between frames). Returns (H, W)
        float32 in [0, 255]."""
        img = np.full((rig.height, rig.width), 90.0, dtype=np.float32)
        self._trace(R_cw, c_w, rig, rays, img=img)
        if noise_sigma > 0:
            rng = rng or np.random.default_rng(0)
            img = img + rng.normal(0, noise_sigma, img.shape).astype(np.float32)
        return np.clip(img, 0, 255).astype(np.float32)

    def depth(self, R_cw: np.ndarray, c_w: np.ndarray, rig: StereoRig,
              rays=None) -> np.ndarray:
        """The z-depth of the surface `render` shows at each pixel, (H, W)
        float32, 0 where no plane is hit: the depth map of an RGB-D camera
        at this pose. The rays have z = 1 in the camera, so the ray
        parameter of the first hit is its z-depth."""
        t = self._trace(R_cw, c_w, rig, rays)
        return np.where(np.isfinite(t), t, np.float32(0.0)).astype(np.float32)


def corridor_pose_at(ts: np.ndarray, speed: float = 0.8, wiggle: float = 0.25):
    """Analytic pose at arbitrary times: returns (R_cw (T,3,3), c_w (T,3)).
    The camera looks along its velocity direction with slight lateral/vertical
    oscillation — smooth, differentiable (IMU-friendly)."""
    ts = np.asarray(ts, dtype=np.float64)
    z = speed * ts
    x = wiggle * np.sin(0.35 * z)
    y = 0.4 * wiggle * np.sin(0.23 * z + 1.0)
    dx = wiggle * 0.35 * np.cos(0.35 * z) * speed
    dy = 0.4 * wiggle * 0.23 * np.cos(0.23 * z + 1.0) * speed
    dz = np.full_like(z, speed)

    fwd = np.stack([dx, dy, dz], axis=-1)
    fwd /= np.linalg.norm(fwd, axis=-1, keepdims=True)
    up_hint = np.array([0.0, 1.0, 0.0])
    right = np.cross(np.broadcast_to(up_hint, fwd.shape), fwd)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    R_cw = np.stack([right, down, fwd], axis=-1)   # float64: finite
    c_w = np.stack([x, y, z], axis=-1)             # differences need f64
    return R_cw, c_w


def orbit_pose_at(ts: np.ndarray, period: float = 24.0, radius: float = 0.5,
                  wiggle: float = 0.08):
    """Analytic orbit pose inside a room (back_wall CorridorWorld): the
    camera circles the room center at `radius`, always facing radially
    outward at the walls, completing 360 degrees per `period` seconds —
    after one period it revisits its own earlier views exactly, the
    canonical loop-closure geometry. Slight vertical bob keeps the motion
    non-degenerate. Returns (R_cw (T,3,3), c_w (T,3))."""
    ts = np.asarray(ts, dtype=np.float64)
    phi = 2.0 * np.pi * ts / period
    x = radius * np.sin(phi)
    z = radius * np.cos(phi)
    y = wiggle * np.sin(3.1 * phi)
    fwd = np.stack([np.sin(phi), np.full_like(phi, 0.0), np.cos(phi)],
                   axis=-1)
    up_hint = np.array([0.0, 1.0, 0.0])
    right = np.cross(np.broadcast_to(up_hint, fwd.shape), fwd)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    R_cw = np.stack([right, down, fwd], axis=-1)
    c_w = np.stack([x, y, z], axis=-1)
    return R_cw, c_w


def orbit_trajectory(n_frames: int, dt: float = 1.0 / 15.0,
                     period: float = 24.0, radius: float = 0.5):
    """Ground-truth orbit trajectory (see orbit_pose_at)."""
    ts = np.arange(n_frames, dtype=np.float64) * dt
    R_cw, c_w = orbit_pose_at(ts, period, radius)
    return list(R_cw.astype(np.float32)), list(c_w.astype(np.float32)), ts


def corridor_trajectory(n_frames: int, dt: float = 1.0 / 15.0,
                        speed: float = 0.8, wiggle: float = 0.25):
    """Ground-truth camera trajectory down the corridor.

    Returns (R_cw_list, c_w_list, timestamps)."""
    ts = np.arange(n_frames, dtype=np.float64) * dt
    R_cw, c_w = corridor_pose_at(ts, speed, wiggle)
    return list(R_cw.astype(np.float32)), list(c_w.astype(np.float32)), ts


GRAVITY_W = np.array([0.0, 9.81, 0.0])  # world gravity acceleration (+y down)


def synth_imu(t0: float, t1: float, freq: float = 200.0,
              speed: float = 0.8, wiggle: float = 0.25,
              bg=np.zeros(3), ba=np.zeros(3),
              sigma_g: float = 0.0, sigma_a: float = 0.0, rng=None,
              R_bc=None, t_bc=None):
    """Body-frame IMU samples along the corridor trajectory
    (`corridor_pose_at`) in (t0, t1]: gyro (N, 3), specific-force accel
    (N, 3) and dts (N,), float32 (reference `io/synthetic.synth_imu`).

    R_bc / t_bc: the IMU-from-camera extrinsic (p_b = R_bc p_c + t_bc),
    identity by default; the body moves as R_wb = R_wc R_bc^T,
    p_b = c - R_wb t_bc. Rates and accelerations come from central finite
    differences of the analytic pose around each sample's midpoint; the
    accelerometer measures f = R_wb^T (a_w - g_w). Noise (sigma_g,
    sigma_a: discrete sigmas) and the constant biases bg, ba are added.
    With `rng=None` each call draws from a fresh `default_rng(0)`, as the
    reference does: pass one generator through a sequence's calls."""
    R_bc = np.eye(3) if R_bc is None else np.asarray(R_bc, np.float64)
    t_bc = np.zeros(3) if t_bc is None else np.asarray(t_bc, np.float64)
    dt = 1.0 / freq
    ts = np.arange(t0 + dt, t1 + dt * 0.5, dt)
    eps = 1e-4

    def body_pose(tq):
        R_wc, c = corridor_pose_at(tq, speed, wiggle)
        R_wb = R_wc.astype(np.float64) @ R_bc.T
        p_b = c.astype(np.float64) - np.einsum("tij,j->ti", R_wb, t_bc)
        return R_wb, p_b

    R0, p_m = body_pose(ts - dt * 0.5)                 # midpoints
    Ra, p_lo = body_pose(ts - dt * 0.5 - eps)
    Rb, p_hi = body_pose(ts - dt * 0.5 + eps)
    a_w = (p_hi - 2 * p_m + p_lo) / (eps * eps)
    # body rates from the rotation increment around the midpoint
    gyro = np.zeros((len(ts), 3), dtype=np.float64)
    for i in range(len(ts)):
        dRm = Ra[i].T @ Rb[i]
        w_hat = (dRm - dRm.T) / (2 * 2 * eps)   # log of a tiny rotation
        gyro[i] = [w_hat[2, 1], w_hat[0, 2], w_hat[1, 0]]
    f_b = np.einsum("tij,tj->ti", np.transpose(R0, (0, 2, 1)), a_w - GRAVITY_W)
    rng = rng or np.random.default_rng(0)
    gyro = gyro + bg + rng.normal(0, sigma_g, gyro.shape)
    f_b = f_b + ba + rng.normal(0, sigma_a, f_b.shape)
    dts = np.full(len(ts), dt, dtype=np.float32)
    return gyro.astype(np.float32), f_b.astype(np.float32), dts


def corridor_imu_stream(ts, noise_gyro: float, noise_acc: float, freq: float,
                        bg=(0.0, 0.0, 0.0), ba=(0.0, 0.0, 0.0), seed: int = 0,
                        speed: float = 0.8, wiggle: float = 0.25):
    """The IMU between consecutive frame stamps `ts` of the corridor
    (`corridor_pose_at(ts, speed, wiggle)`): a list with None for the first
    frame, then (gyro, acc, dts) per frame from `synth_imu` at `freq`, noise
    at the discrete sigmas (density times sqrt(freq)), constant biases
    bg / ba, all calls drawing from one `default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    sg, sa = noise_gyro * np.sqrt(freq), noise_acc * np.sqrt(freq)
    out = [None]
    for a, b in zip(ts[:-1], ts[1:]):
        out.append(synth_imu(float(a), float(b), freq=freq, speed=speed, wiggle=wiggle,
                             bg=np.asarray(bg, np.float64), ba=np.asarray(ba, np.float64),
                             sigma_g=sg, sigma_a=sa, rng=rng))
    return out


def render_corridor_mono(n_frames: int, rig: StereoRig | None = None,
                         world: CorridorWorld | None = None, dt: float = 1.0 / 15.0,
                         seed: int = 0, speed: float = 0.8, wiggle: float = 0.25):
    """The left camera of `render_stereo_sequence` on the corridor driven at
    `speed` (m/s) with lateral sway `wiggle` (m; `corridor_pose_at`). The
    right image is not rendered, but its noise is drawn, so at the default
    speed and wiggle the images are `render_stereo_sequence`'s left ones.

    Returns (f32 (n_frames, H, W) images, f64 timestamps, rig)."""
    rig = rig or StereoRig()
    world = world or CorridorWorld()
    ts = np.arange(n_frames, dtype=np.float64) * dt
    R_cw, c_w = corridor_pose_at(ts, speed, wiggle)
    R_cw, c_w = R_cw.astype(np.float32), c_w.astype(np.float32)
    rng = np.random.default_rng(seed)
    rays = ray_grid(rig)
    imgs = np.zeros((n_frames, rig.height, rig.width), np.float32)
    for i in range(n_frames):
        imgs[i] = world.render(R_cw[i], c_w[i], rig, rng=rng, rays=rays)
        rng.normal(0, 1.5, (rig.height, rig.width))   # the right image's noise
    return imgs, ts, rig


def _orbit_world(n_frames: int, period: float):
    """bench.py's closed room and the left camera's 15 FPS orbit of radius
    0.5 m in it: (world, R_cw list, c_w list, timestamps)."""
    world = CorridorWorld(half_w=4.0, half_h=1.5, z0=-4.0, z1=4.0, back_wall=True)
    return (world,) + orbit_trajectory(n_frames, dt=1.0 / 15.0, period=period, radius=0.5)


def render_orbit_sequence(n_frames: int, rig: StereoRig | None = None,
                          seed: int = 0, period: float = 24.0):
    """bench.py's room-orbit sequence (bench.py:50-73): the closed room, the
    15 FPS orbit of radius 0.5 m and period `period` (bench.py's: 24 s), and
    noise seed `seed`, rendered for `rig` (default: the 640x400 StereoRig).

    Returns (uint8 (n_frames, 2, H, W) stereo pairs, f64 timestamps, rig)."""
    rig = rig or StereoRig()
    world, R_l, c_l, ts = _orbit_world(n_frames, period)
    rng = np.random.default_rng(seed)
    rays = ray_grid(rig)
    imgs = np.zeros((n_frames, 2, rig.height, rig.width), np.uint8)
    for i in range(n_frames):
        c_r = c_l[i] + R_l[i] @ np.array([rig.baseline, 0, 0], np.float32)
        imgs[i, 0] = world.render(R_l[i], c_l[i], rig, rng=rng, rays=rays).astype(np.uint8)
        imgs[i, 1] = world.render(R_l[i], c_r, rig, rng=rng, rays=rays).astype(np.uint8)
    return imgs, ts, rig


def orbit_depth_maps(n_frames: int, rig: StereoRig | None = None,
                     period: float = 24.0) -> np.ndarray:
    """The depth maps of `render_orbit_sequence`'s left camera (an RGB-D
    camera on the same orbit): (n_frames, H, W) float32, 0 where no plane
    is hit."""
    rig = rig or StereoRig()
    world, R_l, c_l, _ = _orbit_world(n_frames, period)
    rays = ray_grid(rig)
    return np.stack([world.depth(R_l[i], c_l[i], rig, rays=rays) for i in range(n_frames)])


def orbit_tracking_config(rig: StereoRig):
    """bench.py's tracking configuration for the orbit (bench.py:300-315):
    the rig's camera, 512 keypoints, 8 levels, 2x2 pose iterations, and the
    default 256 KF / 16384 MP map."""
    cfg = SlamConfig()
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    cfg.orb.max_kp = 512
    cfg.orb.n_levels = 8
    cfg.tracker.pose_rounds = 2
    cfg.tracker.pose_iters = 2
    return cfg


def render_stereo_sequence(n_frames: int, rig: StereoRig | None = None,
                           world: CorridorWorld | None = None,
                           dt: float = 1.0 / 15.0, seed: int = 0):
    """Yield (img_pair (2,H,W) f32, Tcw_left (R, t), timestamp) per frame."""
    rig = rig or StereoRig()
    world = world or CorridorWorld()
    R_cw_list, c_w_list, ts = corridor_trajectory(n_frames, dt=dt)
    rng = np.random.default_rng(seed)
    rays = ray_grid(rig)
    frames = []
    for i in range(n_frames):
        R_cw, c_w = R_cw_list[i], c_w_list[i]
        c_right = c_w + R_cw @ np.array([rig.baseline, 0, 0], dtype=np.float32)
        img_l = world.render(R_cw, c_w, rig, rng=rng, rays=rays)
        img_r = world.render(R_cw, c_right, rig, rng=rng, rays=rays)
        # Tcw: p_c = R_wc^T p_w - R_wc^T c
        R = R_cw.T.astype(np.float32)
        t = (-R @ c_w).astype(np.float32)
        frames.append((np.stack([img_l, img_r]), (R, t), float(ts[i])))
    return frames, rig, world
