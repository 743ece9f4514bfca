"""chip_smoke.py's phase O configuration on the CPU over several seeds of
the two-view RANSAC's draws: how much the monocular path's outcome on the
orbit rests on the draws, and what a change to the initialiser does to it.

    python3 tools/mono_orbit_seeds.py [--variant repaired|repeats|distinct]
        [--seeds 0,1,2,3] [--threads 2]

Renders the pinhole orbit's first N_MONO left images (640x400), then per
seed runs `System(cfg, "mono", device="cpu")` over them with bench.py's
tracking configuration and phase O's wrong motion prior before
MONO_JOLT_FRAME, `reconstruct_two_views` drawing with that seed. Variants:
`repaired` is the port as it is (a sample that repeats a match never
wins); `repeats` lets such samples win, as the reference does; `distinct`
draws each sample's 8 matches without replacement. One JSON line per
seed: the initialisation frame, keyframes, failures, the final state and
the Sim(3)-aligned ATE against the analytic orbit. About 2 min a seed.
"""
import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def distinct_draws(valid, n_hyp, size, seed=0, hyp_idx=None):
    """Each row `size` distinct valid entries, every such set equally
    likely: the entries with the smallest of N uniform keys."""
    if hyp_idx is not None:
        return torch.as_tensor(hyp_idx, device=valid.device).long()
    gen = torch.Generator(device=valid.device).manual_seed(int(seed))
    keys = torch.rand((n_hyp, valid.shape[0]), generator=gen, device=valid.device)
    keys = torch.where(valid, keys, torch.full_like(keys, 2.0))
    return torch.topk(keys, size, dim=1, largest=False).indices


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", default="repaired", choices=("repaired", "repeats", "distinct"))
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    import chip_smoke as cs
    from orbslam3lib_tpu_torch.io.synthetic import orbit_tracking_config, render_orbit_sequence
    from orbslam3lib_tpu_torch.mapping import twoview as ttv
    from orbslam3lib_tpu_torch.system import System
    from orbslam3lib_tpu_torch.tracking import tracker as ttr

    if args.variant == "repeats":
        ttv._repeats = lambda idx: torch.zeros(idx.shape[0], dtype=torch.bool,
                                               device=idx.device)
    elif args.variant == "distinct":
        ttv.ransac_indices = distinct_draws
    imgs, ts, rig = render_orbit_sequence(cs.N_MONO)
    reconstruct = ttr.reconstruct_two_views
    cpu = torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        ttr.reconstruct_two_views = lambda *a, seed=seed, **k: reconstruct(*a, seed=seed, **k)
        s = System(orbit_tracking_config(rig), "mono", device=cpu)
        states = []
        for i in range(cs.N_MONO):
            if i == cs.MONO_JOLT_FRAME:
                s.tracker.vel = cs.jolt_prior(cpu)
            states.append(int(s.track_monocular(imgs[i, 0], float(ts[i]))["state"]))
        st = s.get_stats()
        s.shutdown()
        print(json.dumps({"variant": args.variant, "seed": seed,
                          "init_frame": states.index(1) if 1 in states else None,
                          "n_kf": st["n_kf"], "track_fail": st["track_fail"],
                          "final_state": states[-1],
                          "ate_sim3_m": cs.trajectory_ate(s.tracker, ts, with_scale=True)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
