"""Shape variants of the port's two CUDA kernels, on one CUDA card: each is
the committed source with its tiling or one code path replaced, built with
nvcc, checked bit-exact against the plain version and timed, all in one
process, so that the variants compare on one card.

    python3 tools/kernel_variants.py [--out FILE]

Kernel 1 (`csrc/fast_nms.cu`) on one rendered 640x400 frame's 8 levels,
both eyes in one launch: the committed 30x30 tiles; 30x62 tiles (16 rows
per warp); a tree instead of the 15-step max chain of the arc networks;
two rows per loop iteration; 8-warp blocks of 4 rows per warp. Kernel 2
(`csrc/knn2.cu`) at 512 x 512 and 3 x 16,500: clusters of 8 (committed),
4, 2 and 1 blocks. Device ms per launch from a CUDA graph of 200 launches
(`device.device_ms_per_launch`), twice each. One JSON object to stdout
(and --out).
"""
import argparse
import ctypes
import json
import os
import sys
import threading
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

CHAIN = {"min": ("fminf", "fmaxf"), "max": ("fmaxf", "fminf")}


def _chain(inner: str, outer: str) -> str:
    first = "v[8]"
    return (f"  float best = {inner}(m4[0], {first});\n#pragma unroll\n"
            f"  for (int k = 1; k < 16; ++k) best = {outer}(best, {inner}(m4[k], "
            "v[(k + 8) & 15]));\n  return best;")


def _tree(inner: str, outer: str) -> str:
    return ("#pragma unroll\n"
            f"  for (int k = 0; k < 16; ++k) m4[k] = {inner}(m4[k], v[(k + 8) & 15]);\n"
            "#pragma unroll\n  for (int w = 8; w > 0; w >>= 1)\n#pragma unroll\n"
            f"    for (int k = 0; k < w; ++k) m4[k] = {outer}(m4[k], m4[k + w]);\n"
            "  return m4[0];")


TWO_ROWS = '''  for (int i = 0; i < ROWS_PER_WARP; i += 2) {
    const int r = warp * ROWS_PER_WARP + i;
    const int gy = y0 - 1 + r;
    const bool in0 = gy >= margin && gy < H - margin;
    const bool in1 = gy + 1 >= margin && gy + 1 < H - margin;
    float s0 = 0.0f, s1 = 0.0f;
    if (in0 || in1) {
      const int cx = lane + RING_R;
      const float c0 = s_img[r + 3][cx], c1 = s_img[r + 4][cx];
      const float v0[16] = RING_SAMPLES(s_img, r + 3, cx);
      const float v1[16] = RING_SAMPLES(s_img, r + 4, cx);
      s0 = fmaxf(fmaxf(max_of_arc_min(v0) - c0, c0 - min_of_arc_max(v0)), 0.0f);
      s1 = fmaxf(fmaxf(max_of_arc_min(v1) - c1, c1 - min_of_arc_max(v1)), 0.0f);
      s0 = (col_in && in0) ? s0 : 0.0f;
      s1 = (col_in && in1) ? s1 : 0.0f;
    }
    s_score[r][lane] = s0;
    s_score[r + 1][lane] = s1;
  }
'''


def _replace(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise ValueError(f"the source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def fast_variants(src: str):
    """name -> (source, output tile height)."""
    loop = src[src.index("  // scores, margin-masked"):src.index("  __syncthreads();\n\n  // 3x3 NMS")]
    tree = [(_chain(*CHAIN[k]), _tree(*CHAIN[k])) for k in ("min", "max")]
    rows = "constexpr int ROWS_PER_WARP = 8;"
    return {
        "committed": (src, 30),
        "tiles_30x62": (_replace(src, [(rows, "constexpr int ROWS_PER_WARP = 16;")]), 62),
        "tree": (_replace(src, tree), 30),
        "two_rows": (_replace(src, [(loop, TWO_ROWS),
                                    ("__launch_bounds__(THREADS, 8)",
                                     "__launch_bounds__(THREADS, 4)")]), 30),
        "warps8": (_replace(src, [("constexpr int WARPS = 4;", "constexpr int WARPS = 8;"),
                                  (rows, "constexpr int ROWS_PER_WARP = 4;"),
                                  ("__launch_bounds__(THREADS, 8)",
                                   "__launch_bounds__(THREADS, 4)")]), 30),
    }


def knn_variants(src: str):
    key = "constexpr int CLUSTER = 8;"
    return {f"cluster{c}": _replace(src, [(key, f"constexpr int CLUSTER = {c};")])
            for c in (8, 4, 2, 1)}


def build_all(sources, root: Path):
    """name -> (ctypes library, ptxas lines), nvcc runs in parallel."""
    from orbslam3lib_tpu_torch.ops import _cuda_lib
    out, errors = {}, {}

    def work(name, src):
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "kernel.cu").write_text(src)
        try:
            _, log = _cuda_lib.compile_library([d / "kernel.cu"], d / "lib.so")
            out[name] = (ctypes.CDLL(str(d / "lib.so")),
                         [l.strip() for l in log.splitlines() if "Used" in l or "spill" in l])
        except RuntimeError as e:
            errors[name] = str(e)

    threads = [threading.Thread(target=work, args=kv) for kv in sources.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"variants failed to build: {errors}")
    return out


def fast_launch(lib, levels, out_h: int, margin: int):
    """(output views, launch) of a kernel-1 variant over (2, H, W) levels."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fast_nms_levels_launch.argtypes = [P, I, P, I, P]
    lib.fast_nms_levels_launch.restype = I
    rows, first, off = [], 0, 0
    for lvl in levels:
        b, h, w = lvl.shape
        tiles_x = -(-w // 30)
        per_plane = tiles_x * -(-h // out_h)
        rows.append((lvl.data_ptr(), off, h, w, tiles_x, per_plane, first))
        first += b * per_plane
        off += b * h * w
    out = torch.empty(off, device=levels[0].device)
    table = (ctypes.c_longlong * (7 * len(rows) + 1))(*[v for r in rows for v in r], first)
    views = [out[r[1]:r[1] + lvl.numel()].view(lvl.shape) for r, lvl in zip(rows, levels)]

    def launch():
        err = lib.fast_nms_levels_launch(ctypes.addressof(table), len(rows), out.data_ptr(),
                                         margin, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fast_nms_levels_launch: cudaError_t {err}")
    return views, launch


def knn_launch(lib, a, b, av, bv):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.knn2_launch.argtypes = [P, P, P, P, I, I, P, P, P, P]
    lib.knn2_launch.restype = I
    na = a.shape[0]
    outs = (torch.empty(na, dtype=torch.int32, device=a.device),
            torch.empty(na, device=a.device), torch.empty(na, device=a.device))

    def launch():
        err = lib.knn2_launch(a.data_ptr(), b.data_ptr(), av.data_ptr(), bv.data_ptr(), na,
                              b.shape[0], *[o.data_ptr() for o in outs],
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"knn2_launch: cudaError_t {err}")
    return outs, launch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="file for the JSON result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from orbslam3lib_tpu_torch.device import card_line, device_ms_per_launch
    from orbslam3lib_tpu_torch.io.synthetic import render_orbit_sequence
    from orbslam3lib_tpu_torch.ops import _cuda_lib, cuda_fast, matcher, pyramid
    from orbslam3lib_tpu_torch.ops.extractor import DETECT_MARGIN

    dev = torch.device("cuda:0")
    fast_v = fast_variants((_cuda_lib.CSRC / "fast_nms.cu").read_text())
    knn_v = knn_variants((_cuda_lib.CSRC / "knn2.cu").read_text())
    libs = build_all({**{"fast_" + k: v[0] for k, v in fast_v.items()},
                      **{"knn_" + k: v for k, v in knn_v.items()}},
                     _cuda_lib.BUILD_DIR / "variants")
    res = {"card": card_line(), "ptxas": {k: v[1] for k, v in libs.items()}}

    imgs, _, _ = render_orbit_sequence(1)
    levels = pyramid.build_pyramid(torch.as_tensor(imgs[0], device=dev), 8)
    want = cuda_fast.fast_scores_nms_levels_plain(levels, DETECT_MARGIN)
    for name, (_, out_h) in fast_v.items():
        views, launch = fast_launch(libs["fast_" + name][0], levels, out_h, DETECT_MARGIN)
        launch()
        torch.cuda.synchronize()
        res["fast_" + name] = {
            "equal": all(torch.equal(v, w) for v, w in zip(views, want)),
            "frame_ms": [device_ms_per_launch(launch, 200, graph=True) for _ in range(2)]}

    g = torch.Generator().manual_seed(0)
    cases = {}
    for na, nb in ((512, 512), (3, 16500)):
        a = (torch.rand((na, 256), generator=g) < 0.5).to(torch.int8).to(dev)
        b = (torch.rand((nb, 256), generator=g) < 0.5).to(torch.int8).to(dev)
        av = (torch.rand(na, generator=g) < 0.9).to(dev)
        bv = (torch.rand(nb, generator=g) < 0.9).to(dev)
        cases[f"{na}x{nb}"] = (a, b, av, bv, matcher.knn_match(a, b, av, bv))
    for name in knn_v:
        r = {"equal": True}
        for case, (a, b, av, bv, want) in cases.items():
            outs, launch = knn_launch(libs["knn_" + name][0], a, b, av.view(torch.uint8),
                                      bv.view(torch.uint8))
            launch()
            torch.cuda.synchronize()
            r["equal"] &= all(torch.equal(o, w) for o, w in zip(outs, want))
            r[case + "_ms"] = [device_ms_per_launch(launch, 200, graph=True) for _ in range(2)]
        res["knn_" + name] = r

    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    ok = all(v["equal"] for k, v in res.items() if k.startswith(("fast_", "knn_")))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
