"""Offline visualisation: map renders, PLY export and a PNG writer (a copy
of the map parts of `orbslam3lib_tpu/viz.py`, which cannot be imported
without JAX; the maps are read through `map_state.to_numpy`).

The reference's Pangolin viewer (Viewer.cc, MapDrawer.cc) becomes files on
a headless host: a top-down map render and a PLY point cloud with the
keyframes and the trajectory. numpy and the standard library only;
matplotlib only inside `render_map`, imported there.
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
