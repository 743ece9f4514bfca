"""Offline visualisation: frame overlays, map renders, PLY export and a
PNG writer (a copy of `orbslam3lib_tpu/viz.py`, which cannot be imported
without JAX; the maps are read through `map_state.to_numpy`).

The reference's Pangolin viewer (Viewer.cc, FrameDrawer.cc, MapDrawer.cc)
becomes files on a headless host: the tracked frame with its keypoints, a
top-down map render and a PLY point cloud with the keyframes and the
trajectory. numpy and the standard library only; matplotlib only inside
`render_map`, imported there.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np

from .models import map_state as ms


def _arrays(m):
    """A MapState as numpy arrays (a dict passes through)."""
    return m if isinstance(m, dict) else ms.to_numpy(m)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB, or (H, W) uint8 grayscale, to a PNG file."""
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if rgb.ndim == 3 else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


GREEN = np.array([30, 220, 60], np.uint8)     # tracked map point
BLUE = np.array([70, 130, 240], np.uint8)     # new/untracked feature
RED = np.array([230, 60, 50], np.uint8)       # outlier/lost


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def draw_frame(img, xy, valid, tracked=None, radius: int = 2) -> np.ndarray:
    """FrameDrawer::DrawFrame: the grayscale frame with a square around each
    valid keypoint, green where it tracks a map point, blue where it was
    only detected (reference :54-77). img (H, W) float or uint8; xy (N, 2);
    valid (N,) bool; tracked (N,) bool; tensors or arrays. Returns (H, W, 3)
    uint8."""
    g = np.clip(_host(img).astype(np.float32), 0, 255).astype(np.uint8)
    rgb = np.stack([g, g, g], axis=-1)
    h, w = g.shape
    xy = _host(xy)
    valid = _host(valid).astype(bool)
    tracked = np.zeros(len(xy), bool) if tracked is None else _host(tracked).astype(bool)
    for i in np.flatnonzero(valid):
        x, y = int(round(float(xy[i, 0]))), int(round(float(xy[i, 1])))
        if not (radius <= x < w - radius and radius <= y < h - radius):
            continue
        color = GREEN if tracked[i] else BLUE
        rgb[y - radius:y + radius + 1, x - radius] = color
        rgb[y - radius:y + radius + 1, x + radius] = color
        rgb[y - radius, x - radius:x + radius + 1] = color
        rgb[y + radius, x - radius:x + radius + 1] = color
    return rgb


def save_frame(path: str, img, xy, valid, tracked=None) -> None:
    """`draw_frame` written as a PNG."""
    write_png(path, draw_frame(img, xy, valid, tracked))


def kf_centers(m) -> np.ndarray:
    """Camera centres of the valid keyframes: c = -R^T t."""
    a = _arrays(m)
    c = -np.einsum("kij,kj->ki", a["kf_R"].transpose(0, 2, 1), a["kf_t"])
    return c[a["kf_valid"].astype(bool)]


def render_map(path: str, m, title: str = "map",
               trajectory: Optional[Sequence] = None) -> None:
    """MapDrawer: a top-down (x-z) scatter of the landmarks, the keyframe
    centres and, given, the frame trajectory, saved as a PNG by matplotlib
    (Agg backend)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a = _arrays(m)
    pts = a["mp_pos"][a["mp_valid"].astype(bool)]
    kfs = kf_centers(a)
    fig, ax = plt.subplots(figsize=(7, 7))
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=1.0, c="#777777", label="landmarks")
    if len(kfs):
        ax.plot(kfs[:, 0], kfs[:, 2], "o-", ms=3, c="#1f77b4", label="keyframes")
    if trajectory is not None and len(trajectory):
        c = np.asarray([-np.asarray(R).T @ np.asarray(t) for _, R, t in trajectory])
        ax.plot(c[:, 0], c[:, 2], "-", lw=0.8, c="#2ca02c", label="trajectory")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def export_ply(path: str, m, trajectory: Optional[Sequence] = None) -> None:
    """Landmarks (grey), keyframe centres (blue) and the trajectory (green)
    as an ASCII PLY point cloud."""
    a = _arrays(m)
    pts = a["mp_pos"][a["mp_valid"].astype(bool)]
    rows = [(p, (180, 180, 180)) for p in pts]
    rows += [(c, (40, 90, 230)) for c in kf_centers(a)]
    if trajectory is not None:
        for _, R, t in trajectory:
            rows.append((-np.asarray(R).T @ np.asarray(t), (40, 200, 70)))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(rows)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, (r, g, b) in rows:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {r} {g} {b}\n")
