"""EuRoC MAV / TUM-VI sequences in the ASL folder format (port of
`orbslam3lib_tpu/io/euroc.py`, numpy only):

    <root>/mav0/cam0/data.csv          timestamp [ns], filename
    <root>/mav0/cam0/data/<stamp>.png  8-bit grayscale images
    <root>/mav0/cam1/...               the right / second camera
    <root>/mav0/imu0/data.csv          timestamp [ns], wx, wy, wz, ax, ay, az
    <root>/mav0/state_groundtruth_estimate0/data.csv   (EuRoC's ground truth)

`EurocSequence.frames()` yields each frame with the IMU samples in
(t_prev, t_cur], as `System.track_stereo(imgs, ts, imu=chunk)` takes them:

    seq = EurocSequence(root)
    sys_ = System(cfg, "imu_stereo")
    for imgs, ts, chunk in seq.frames():
        sys_.track_stereo(imgs, ts, imu=chunk)

The PNGs are read by a small zlib decoder of 8-bit grayscale / RGB / RGBA,
non-interlaced PNGs with all five scanline filters (and written by
`viz.write_png`), so the loader needs no imaging package.
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..viz import write_png

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}        # PNG colour type -> samples per pixel


def _read_csv(path: str) -> List[List[str]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([c.strip() for c in line.split(",")])
    return rows


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters (None, Sub, Up, Average, Paeth)."""
    stride = w * bpp
    raw = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:       # Sub: a running sum along each sample's column
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:       # Up
            cur = (line + prev) & 0xFF
        else:                  # Average, Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit grayscale, RGB or RGBA non-interlaced PNG as uint8
    (H, W) or (H, W, C)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(blob):
        n, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced grayscale, RGB or RGBA PNGs "
                         f"(depth {depth}, colour type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def load_image(path: str) -> np.ndarray:
    """A PNG as a float32 (H, W) grayscale image; colour through ITU-R 601-2
    luma in PIL's integer form, as the reference's `convert("L")`."""
    img = read_png(path)
    if img.ndim == 3:
        rgb = img[..., :3].astype(np.int64)
        img = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16
    return np.asarray(img, dtype=np.float32)


@dataclass
class EurocSequence:
    """An ASL folder: cam0 (and cam1 when `stereo` and present), the IMU and
    the ground truth when present, times in seconds."""
    root: str
    stereo: bool = True

    def __post_init__(self):
        mav = os.path.join(self.root, "mav0")
        self.cam0_rows = _read_csv(os.path.join(mav, "cam0", "data.csv"))
        self.cam1_rows = (_read_csv(os.path.join(mav, "cam1", "data.csv"))
                          if self.stereo and os.path.isdir(os.path.join(mav, "cam1")) else None)
        imu_path = os.path.join(mav, "imu0", "data.csv")
        self.imu = None
        if os.path.isfile(imu_path):
            self.imu = np.asarray([[float(c) for c in r] for r in _read_csv(imu_path)])
            self.imu[:, 0] *= 1e-9                      # ns -> s
        gt_path = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
        self.ground_truth = None
        if os.path.isfile(gt_path):
            g = np.asarray([[float(c) for c in r[:8]] for r in _read_csv(gt_path)])
            g[:, 0] *= 1e-9
            self.ground_truth = g                      # t, px, py, pz, qw, qx, qy, qz

    def __len__(self):
        return len(self.cam0_rows)

    def _img_path(self, cam: str, fname: str) -> str:
        return os.path.join(self.root, "mav0", cam, "data", fname)

    def frames(self, start: int = 0, end: Optional[int] = None
               ) -> Iterator[Tuple[np.ndarray, float, Optional[Tuple]]]:
        """(images, timestamp in s, imu chunk) per frame: images (2, H, W)
        for stereo, else (H, W); the chunk (gyro (N, 3), acc (N, 3), dts
        (N,)) of the samples in (t_prev, t_cur], each dt from the sample
        before it (the first from t_prev), or None."""
        prev_t = None
        for r in self.cam0_rows[start:end]:
            ts = float(r[0]) * 1e-9
            img0 = load_image(self._img_path("cam0", r[1]))
            imgs = (np.stack([img0, load_image(self._img_path("cam1", r[1]))])
                    if self.cam1_rows is not None else img0)
            chunk = None
            if self.imu is not None and prev_t is not None:
                s = self.imu[(self.imu[:, 0] > prev_t) & (self.imu[:, 0] <= ts)]
                if len(s):
                    dts = np.diff(np.concatenate([[prev_t], s[:, 0]])).astype(np.float32)
                    chunk = (s[:, 1:4].astype(np.float32), s[:, 4:7].astype(np.float32), dts)
            yield imgs, ts, chunk
            prev_t = ts

    def gt_centers_at(self, timestamps: np.ndarray) -> Optional[np.ndarray]:
        """The ground truth's positions interpolated at the stamps (ATE)."""
        if self.ground_truth is None:
            return None
        g = self.ground_truth
        return np.stack([np.interp(timestamps, g[:, 0], g[:, 1 + i]) for i in range(3)], axis=1)


def write_minimal_sequence(root: str, images: List[np.ndarray], timestamps: List[float],
                           images_right: Optional[List[np.ndarray]] = None,
                           imu: Optional[np.ndarray] = None, gt: Optional[np.ndarray] = None):
    """An ASL folder from arrays (a test fixture and an export): images
    clipped to uint8, imu rows (t, wx, wy, wz, ax, ay, az), ground-truth
    rows (t, px, py, pz, qw, qx, qy, qz), times in s."""
    cams = [("cam0", images)] + ([("cam1", images_right)] if images_right is not None else [])
    for cam, imgs in cams:
        os.makedirs(os.path.join(root, "mav0", cam, "data"), exist_ok=True)
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for img, ts in zip(imgs, timestamps):
                ns = int(round(ts * 1e9))
                fname = f"{ns}.png"
                write_png(os.path.join(root, "mav0", cam, "data", fname),
                          np.clip(img, 0, 255).astype(np.uint8))
                f.write(f"{ns},{fname}\n")
    for rows, sub, head, n in ((imu, "imu0", "#timestamp,wx,wy,wz,ax,ay,az", 7),
                               (gt, "state_groundtruth_estimate0",
                                "#timestamp,px,py,pz,qw,qx,qy,qz", 8)):
        if rows is None:
            continue
        os.makedirs(os.path.join(root, "mav0", sub), exist_ok=True)
        with open(os.path.join(root, "mav0", sub, "data.csv"), "w") as f:
            f.write(head + "\n")
            for row in rows:
                f.write(f"{int(round(row[0] * 1e9))}," +
                        ",".join(f"{v:.9f}" for v in row[1:n]) + "\n")
