"""The port's two CUDA kernels against an earlier version of their sources,
on one CUDA card, in turns (old, new, new, old).

    python3 tools/kernel_ab.py --old-csrc DIR [--out FILE]

DIR holds an earlier `fast_nms.cu` (C entry `fast_nms_launch`: one level of
(batch, H, W) per launch) and `knn2.cu` (C entry `knn2_launch` with two
packed-descriptor scratch buffers, three launches per call), for example
the `orbslam3lib_tpu_torch/csrc/` of an earlier commit unpacked with
`git archive`. Both versions are built with nvcc (ptxas's registers, shared
memory and spills printed), checked equal to each other and to the plain
versions on one rendered frame's pyramid and on 512 x 512 descriptors, and
timed at those shapes:
  * kernel 1 on a whole frame (8 levels, both eyes): the old kernel in 8
    launches, the new one in 1; and on level 0 alone;
  * kernel 2 at 512 x 512 (masked): the old call's 3 launches, the new 1.
Device ms per launch (or per frame) come from CUDA events around N
back-to-back launches captured in a CUDA graph (`device_ms_per_launch`),
and, for the same launches, from torch.profiler's device time by kernel
name. One JSON object goes to stdout (and to --out).
"""
import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

N = 200
OLD_SIGNATURES = {
    "fast_nms_launch": [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "knn2_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4,
}


def load_old(csrc: Path, build_dir: Path):
    from orbslam3lib_tpu_torch.ops import _cuda_lib
    seconds, log = _cuda_lib.compile_library(
        [csrc / "fast_nms.cu", csrc / "knn2.cu"], build_dir / "libkernels_old.so")
    lib = ctypes.CDLL(str(build_dir / "libkernels_old.so"))
    for name, argtypes in OLD_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib, seconds, log


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def profiled_ms(launch, names, n: int = 50):
    """Device ms per call of launch() by kernel name (torch.profiler)."""
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            launch()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in names:
            if name in e.key and e.device_type == torch.autograd.DeviceType.CUDA:
                out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / n
    return out


def in_turns(old, new):
    """old, new, new, old: device ms per call of each, twice."""
    from orbslam3lib_tpu_torch.device import device_ms_per_launch
    o1 = device_ms_per_launch(old, N, graph=True)
    n1 = device_ms_per_launch(new, N, graph=True)
    n2 = device_ms_per_launch(new, N, graph=True)
    o2 = device_ms_per_launch(old, N, graph=True)
    return {"old_ms": [o1, o2], "new_ms": [n1, n2]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True, help="directory of the earlier sources")
    ap.add_argument("--out", help="file for the JSON result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from orbslam3lib_tpu_torch.device import card_line
    from orbslam3lib_tpu_torch.io.synthetic import render_orbit_sequence
    from orbslam3lib_tpu_torch.ops import _cuda_lib, cuda_fast, cuda_matcher, matcher, pyramid
    from orbslam3lib_tpu_torch.ops.extractor import DETECT_MARGIN

    dev = torch.device("cuda:0")
    new_build_s = _cuda_lib.build()
    new_log = _cuda_lib.BUILD_LOG
    _cuda_lib.library()
    old, old_build_s, old_log = load_old(Path(args.old_csrc), _cuda_lib.BUILD_DIR)
    res = {"card": card_line(), "build_s": {"old": old_build_s, "new": new_build_s},
           "ptxas_old": old_log, "ptxas_new": new_log}

    # kernel 1 on one rendered frame's pyramid
    imgs, _, _ = render_orbit_sequence(1)
    levels = pyramid.build_pyramid(torch.as_tensor(imgs[0], device=dev), 8)
    old_out = [torch.empty_like(l) for l in levels]

    def old_launches(idx):
        def run():
            for i in idx:
                lvl = levels[i]
                err = old.fast_nms_launch(lvl.data_ptr(), old_out[i].data_ptr(), lvl.shape[0],
                                          lvl.shape[1], lvl.shape[2], DETECT_MARGIN, stream())
                _cuda_lib.check(err, "old fast_nms_launch")
        return run

    new_views, new_frame = cuda_fast.prepare_launch(levels, DETECT_MARGIN)
    _, new_level0 = cuda_fast.prepare_launch(levels[:1], DETECT_MARGIN)
    old_launches(range(8))()
    new_frame()
    want = cuda_fast.fast_scores_nms_levels_plain(levels, DETECT_MARGIN)
    torch.cuda.synchronize()
    res["fast_equal"] = all(torch.equal(a, w) and torch.equal(b, w)
                            for a, b, w in zip(old_out, new_views, want))
    res["fast_frame"] = in_turns(old_launches(range(8)), new_frame)
    res["fast_level0"] = in_turns(old_launches([0]), new_level0)
    names = ["fast_nms_kernel", "fast_nms_levels_kernel", "knn2_kernel", "knn_pack_kernel"]
    res["fast_frame_profiled"] = {"old": profiled_ms(old_launches(range(8)), names),
                                  "new": profiled_ms(new_frame, names)}

    # kernel 2 at 512 x 512, masked
    g = torch.Generator().manual_seed(0)
    a = (torch.rand((512, 256), generator=g) < 0.5).to(torch.int8).to(dev)
    b = (torch.rand((512, 256), generator=g) < 0.5).to(torch.int8).to(dev)
    av = (torch.rand(512, generator=g) < 0.9).to(dev)
    bv = (torch.rand(512, generator=g) < 0.9).to(dev)
    scratch = [torch.empty((512, 8), dtype=torch.int32, device=dev) for _ in range(2)]
    o_best = torch.empty(512, dtype=torch.int32, device=dev)
    o_d = [torch.empty(512, dtype=torch.float32, device=dev) for _ in range(2)]

    def old_knn():
        err = old.knn2_launch(a.data_ptr(), b.data_ptr(), av.data_ptr(), bv.data_ptr(),
                              scratch[0].data_ptr(), scratch[1].data_ptr(), 512, 512,
                              o_best.data_ptr(), o_d[0].data_ptr(), o_d[1].data_ptr(),
                              stream())
        _cuda_lib.check(err, "old knn2_launch")

    new_knn_out, new_knn = cuda_matcher.prepare_launch(a, b, av.view(torch.uint8),
                                                       bv.view(torch.uint8))
    old_knn()
    new_knn()
    want = matcher.knn_match(a, b, av, bv)
    torch.cuda.synchronize()
    res["knn_equal"] = all(torch.equal(x, w) and torch.equal(y, w)
                           for x, y, w in zip((o_best, *o_d), new_knn_out, want))
    res["knn_512"] = in_turns(old_knn, new_knn)
    res["knn_512_profiled"] = {"old": profiled_ms(old_knn, names),
                               "new": profiled_ms(new_knn, names)}

    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        Path(args.out).write_text(line + "\n")
    summary = {k: v for k, v in res.items() if not k.startswith("ptxas")}
    print(json.dumps(summary))
    return 0 if res["fast_equal"] and res["knn_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
