"""Where the card's result first leaves the CPU's, stage by stage, on the
same inputs and the same (host) RANSAC draws. Needs a CUDA card; imports
no JAX.

    python3 tools/card_divergence.py [--seeds 5,6,7,8] [--frames 20]
        [--skip-loop] [--skip-mono] [--loop-repeats N] [--device cpu]

Loop leg: the ring world of tests/torch_parity.py, as drawn and with its
revisit shrunk by 0.8 (tests/test_torch_loop_scale.py), through
`LoopCloser.on_probe_result`: scale fixed with the features' stereo
depths (the stereo tracker's setting), free with them, and free without
them (a monocular map). Per case it prints the largest card-CPU
difference of kf_R, kf_t and mp_pos after the correction (verification +
pose graph + landmark re-anchoring) and after the global BA (with
--loop-repeats N, after each of N runs of the whole leg on the card, so
that the card's own spread shows); the global BA alone, run on both devices from the CPU's corrected map (inputs
equal), on the CPU from the card's corrected map, and on the CPU from the
CPU's with every landmark moved by ~1e-6 of itself (how far the BA
carries a difference of rounding size, on one device); and the range of
the pose graph's keyframe scales.

Monocular initialisation: `System(cfg, "mono")` on the corridor of
tests/test_torch_mono.py (one render seed per run) on both devices; per
seed the initialisation frame, whether the initialisation matches are
equal, the two-view reconstruction's R, t, p3d and tri_ok, the initial
map before and after its 20-iteration BA (keyframe 1's translation, the
landmarks, the median depth of the landmarks in keyframe 0), that BA run
on both devices from the CPU's map, and the camera centres at the end,
unaligned and Sim(3)-aligned. One JSON line per case.
"""
import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

MAP_KEYS = ("kf_R", "kf_t", "mp_pos")


def _np(m):
    return {k: getattr(m, k).detach().cpu().numpy().copy() for k in MAP_KEYS}


def _diff(a, b):
    return {k: float(np.max(np.abs(a[k] - b[k]))) for k in MAP_KEYS}


def _to(x, dev):
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, tuple):
        return tuple(_to(v, dev) for v in x)
    return x


@contextlib.contextmanager
def _patched(mod, name, wrapper):
    real = getattr(mod, name)
    setattr(mod, name, wrapper(real))
    try:
        yield real
    finally:
        setattr(mod, name, real)


def loop_case(dev, shrink: float, fix_scale: bool, depth: bool = True, repeats: int = 1):
    from orbslam3lib_tpu_torch.config import SlamConfig
    from orbslam3lib_tpu_torch.mapping import loop_closing as lc
    from orbslam3lib_tpu_torch.models import map_state as ms
    from orbslam3lib_tpu_torch.models import vocabulary as vb
    from orbslam3lib_tpu_torch.tracking.reloc import PlaceRecognition
    from torch_parity import RING_CAM, host_ransac_draws, ring_world

    arrays, _, descs = ring_world()
    if shrink != 1.0:
        R, t = arrays["kf_R"][12], arrays["kf_t"][12]
        c = -R.T @ t
        own = arrays["mp_valid"] & (arrays["mp_first_kf"] == 12)
        arrays["mp_pos"][own] = c + shrink * (arrays["mp_pos"][own] - c)
        arrays["kf_depth"][12] *= shrink
    if not depth:
        # a monocular map: no feature carries a stereo depth
        arrays["kf_depth"][:] = 0.0
    out = {}
    for run, d in enumerate(["cpu"] + [dev] * repeats):
        voc = vb.train_vocabulary(descs, k=4, depth=3).to(d)
        m = ms.from_numpy(arrays, device=d)
        pr = PlaceRecognition(voc, m.max_kf)
        for i in range(13):
            pr.add(i, m.kf_desc[i], m.kf_feat_valid[i])
        cam = torch.from_numpy(RING_CAM).to(d)
        seen = {}

        def wrap_pg(real):
            def pg(*a, **k):
                out = real(*a, **k)
                s = out[2][a[3]]
                seen["pg_s"] = [float(torch.min(s)), float(torch.max(s))]
                return out
            return pg

        def wrap(real):
            def gba(m_in, *a, **k):
                seen["pre"] = ms.clone_map(m_in)
                seen["args"] = (a, {kk: v for kk, v in k.items() if kk != "should_abort"})
                return real(m_in, *a, **k)
            return gba

        with host_ransac_draws(), _patched(lc, "global_bundle_adjust", wrap), \
                _patched(lc.pose_graph, "optimize_pose_graph", wrap_pg):
            probe = lc.loop_probe(m, pr.bow_db, pr.active, voc.centroids, voc.idf, 12,
                                  k=voc.k, depth=voc.depth, prev_cand=-1).cpu().numpy()
            closer = lc.LoopCloser(SlamConfig(), pr, consistency_needed=1,
                                   fix_scale=fix_scale)
            m = closer.on_probe_result(m, 12, probe, cam)
        out[run] = dict(pack=closer.last_verification, pre=seen.get("pre"), post=_np(m),
                        args=seen.get("args"), n_loops=closer.n_loops, pg_s=seen.get("pg_s"))
    c, g = out[0], out[1]
    row = {"case": "loop", "shrink": shrink, "fix_scale": fix_scale, "depth": depth,
           "loops": [c["n_loops"], g["n_loops"]]}
    if c["pre"] is None or g["pre"] is None:
        row["verification"] = [None if r["pack"] is None else r["pack"][2][:5].tolist()
                               for r in (c, g)]
        return row
    pc, pg = c["pack"][2], g["pack"][2]
    pre_c, pre_g = _np(c["pre"]), _np(g["pre"])
    # the global BA alone: both devices from the CPU's corrected map, and
    # the CPU from each device's corrected map
    a, k = c["args"]
    gba_on = {}
    # the CPU's corrected map with each landmark moved by ~1e-6 of itself
    # (a few f32 ulps): how far the BA carries a difference of that size
    nudged = ms.clone_map(c["pre"])
    gen = torch.Generator().manual_seed(0)
    nudged.mp_pos = nudged.mp_pos * (1.0 + 1e-6 * torch.randn(nudged.mp_pos.shape,
                                                              generator=gen))
    for name, m_in, d in (("cpu<-cpu", c["pre"], "cpu"), ("card<-cpu", c["pre"], dev),
                          ("cpu<-card", g["pre"], "cpu"), ("cpu<-nudged", nudged, "cpu")):
        # (the BA works in place: a copy of the snapshot)
        m_in = ms.MapState(**{f: getattr(m_in, f).to(d).clone() for f in ms.FIELDS})
        gba_on[name] = _np(lc.global_bundle_adjust(m_in, *_to(a, d), **k))
    return dict(row, **{
        "s12": [float(pc[17]), float(pg[17])],
        "counts_equal": bool(np.array_equal(pc[:5], pg[:5])),
        "sim3_max_diff": float(np.max(np.abs(pc[5:] - pg[5:]))),
        "after_correction": _diff(pre_g, pre_c),
        "after_gba": _diff(g["post"], c["post"]),
        # the whole leg again on the card: how far its own runs spread
        "after_gba_each_run": [_diff(out[r]["post"], c["post"]) for r in range(1, repeats + 1)],
        "gba_alone_card_vs_cpu": _diff(gba_on["card<-cpu"], gba_on["cpu<-cpu"]),
        "gba_on_cpu_from_card_vs_cpu": _diff(gba_on["cpu<-card"], gba_on["cpu<-cpu"]),
        "gba_on_cpu_from_nudged_vs_cpu": _diff(gba_on["cpu<-nudged"], gba_on["cpu<-cpu"]),
        "pose_graph_s_range": c["pg_s"],
    })


def mono_case(dev, seed: int, n_frames: int):
    from orbslam3lib_tpu_torch.config import SlamConfig
    from orbslam3lib_tpu_torch.evaluation import ate_rmse, umeyama_alignment
    from orbslam3lib_tpu_torch.io.synthetic import render_stereo_sequence
    from orbslam3lib_tpu_torch.models import map_state as ms
    from orbslam3lib_tpu_torch.system import System
    from orbslam3lib_tpu_torch.tracking import matching
    from orbslam3lib_tpu_torch.tracking import tracker as ttr
    from torch_parity import host_ransac_draws

    frames, rig, _ = render_stereo_sequence(n_frames=n_frames, dt=1.0 / 15.0, seed=seed)
    cfg = SlamConfig()
    cfg.map.max_kf, cfg.map.max_mp = 64, 4096
    cfg.orb.max_kp, cfg.orb.target_features, cfg.orb.fast_threshold = 384, 300, 12.0
    cfg.tracker.min_init_features = 150
    cfg.ba.max_points, cfg.ba.window_size = 1024, 6
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    runs = {}
    for d in ("cpu", dev):
        rec = {}

        def w_match(real):
            def f(*a, **k):
                idx, ok = real(*a, **k)
                rec["match"] = (idx.cpu().numpy(), ok.cpu().numpy())
                return idx, ok
            return f

        def w_recon(real):
            def f(*a, **k):
                out = real(*a, **k)
                rec["recon"] = {kk: v.detach().cpu().numpy() for kk, v in out.items()}
                return out
            return f

        def w_init(real):
            def f(*a, **k):
                out = real(*a, **k)
                rec["pre"] = ms.clone_map(out[0])
                return out
            return f

        def w_ba(real):
            def f(m_in, *a, **k):
                take = "pre" in rec and "ba_args" not in rec
                out = real(m_in, *a, **k)
                if take:
                    rec["ba_args"] = (a, k)
                    rec["post"] = _np(out)
                    rec["post_valid"] = out.mp_valid.cpu().numpy()
                return out
            return f

        with host_ransac_draws(), \
                _patched(matching, "match_for_initialization", w_match), \
                _patched(ttr, "reconstruct_two_views", w_recon), \
                _patched(ttr, "_mono_init_map", w_init), _patched(ttr, "_local_ba", w_ba):
            s = System(cfg, "mono", device=d, enable_loop_closing=False)
            states = [int(s.track_monocular(pair[0], stamp)["state"])
                      for pair, _, stamp in frames]
        rec["states"] = states
        rec["n_kf"] = s.get_stats()["n_kf"]
        rec["centres"] = s.tracker.trajectory_centers()
        s.shutdown()
        runs[str(d)] = rec
    c, g = runs["cpu"], runs[str(dev)]
    row = {"case": "mono", "seed": seed, "frames": n_frames,
           "init_frame": [r["states"].index(1) if 1 in r["states"] else None
                          for r in (c, g)],
           "states_equal": c["states"] == g["states"], "n_kf": [c["n_kf"], g["n_kf"]]}
    if "post" not in c or "post" not in g:
        return row
    row["matches_equal"] = bool(all(np.array_equal(x, y)
                                    for x, y in zip(c["match"], g["match"])))
    rc, rg = c["recon"], g["recon"]
    tri = rc["tri_ok"] & rg["tri_ok"]
    row["recon"] = {
        "tri_ok_equal": bool(np.array_equal(rc["tri_ok"], rg["tri_ok"])),
        "n_good": [int(rc["n_good"]), int(rg["n_good"])],
        "R": float(np.max(np.abs(rc["R"] - rg["R"]))),
        "t": float(np.max(np.abs(rc["t"] - rg["t"]))),
        "p3d_rel": float(np.max(np.abs(rc["p3d"][tri] - rg["p3d"][tri])
                                / np.abs(rc["p3d"][tri][:, 2:3]))),
    }
    pre_c, pre_g = _np(c["pre"]), _np(g["pre"])
    v = c["post_valid"]
    med = {}
    for name, mp in (("pre_cpu", pre_c), ("pre_card", pre_g), ("post_cpu", c["post"]),
                     ("post_card", g["post"])):
        med[name] = float(np.median(mp["mp_pos"][v, 2]))
    row["init_map"] = {
        "pre_ba": {"kf1_t": float(np.max(np.abs(pre_c["kf_t"][1] - pre_g["kf_t"][1]))),
                   "mp_pos": float(np.max(np.abs(pre_c["mp_pos"][v] - pre_g["mp_pos"][v])))},
        "post_ba": {"kf1_t": float(np.max(np.abs(c["post"]["kf_t"][1]
                                                 - g["post"]["kf_t"][1]))),
                    "kf1_t_norm": [float(np.linalg.norm(c["post"]["kf_t"][1])),
                                   float(np.linalg.norm(g["post"]["kf_t"][1]))],
                    "mp_pos": float(np.max(np.abs(c["post"]["mp_pos"][v]
                                                  - g["post"]["mp_pos"][v])))},
        "median_depth": med,
    }
    a, k = c["ba_args"]
    on = {}
    for d in ("cpu", dev):
        m_in = ms.MapState(**{f: getattr(c["pre"], f).to(d).clone() for f in ms.FIELDS})
        on[str(d)] = _np(ttr._local_ba(m_in, *_to(a, d), **_to(k, d)))
    row["ba_alone_from_cpu_map"] = {
        "kf1_t": float(np.max(np.abs(on["cpu"]["kf_t"][1] - on[str(dev)]["kf_t"][1]))),
        "kf1_t_norm": [float(np.linalg.norm(on[x]["kf_t"][1])) for x in ("cpu", str(dev))],
        "mp_pos": float(np.max(np.abs(on["cpu"]["mp_pos"][v] - on[str(dev)]["mp_pos"][v]))),
    }
    ec, eg = c["centres"], g["centres"]
    n = min(len(ec), len(eg))
    ec, eg = ec[-n:], eg[-n:]
    dist = np.linalg.norm(eg - ec, axis=1)
    s, _, _ = umeyama_alignment(eg, ec, True)
    row["centres"] = {"n": n, "unaligned_max": float(dist.max()),
                      "unaligned_rms": float(np.sqrt((dist ** 2).mean())),
                      "sim3_ate": ate_rmse(eg, ec, with_scale=True), "sim3_scale": float(s)}
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="5,6,7,8")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--skip-mono", action="store_true")
    ap.add_argument("--skip-loop", action="store_true")
    ap.add_argument("--loop-repeats", type=int, default=1,
                    help="runs of the loop leg on the card against one on the CPU")
    ap.add_argument("--device", default="cuda:0",
                    help="the device held against the CPU (cpu: a dry run of the script)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("needs a CUDA card", file=sys.stderr)
            return 1
        from orbslam3lib_tpu_torch.ops import _cuda_lib
        _cuda_lib.build()
    if not args.skip_loop:
        for shrink in (1.0, 0.8):
            for fix_scale, depth in ((True, True), (False, True), (False, False)):
                print(json.dumps(loop_case(dev, shrink, fix_scale, depth, args.loop_repeats)),
                      flush=True)
    if not args.skip_mono:
        for seed in (int(x) for x in args.seeds.split(",")):
            print(json.dumps(mono_case(dev, seed, args.frames)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
