"""The correctness check's control and its readings, on the card.

    python3 slambench/control.py --workload <name> --seeds <n> [<n> ...] --seconds <s>

For each seed, one run of the cell as the benchmark makes it (its set-up,
warm-up and a window of `--seconds` at the cell's own load) gives the
program's readings of every compared number (the lower readings), and from
the same sampled frames the control's: the reference put in the program's
place and computed in the precision below the configuration's float32 with
TF32 off, that is with TF32 matrix products (the front end, whose pyramid
resamples by matrix products; the pose solve; the preintegration; the
visual-inertial frame solve), and for the local BA and the VI window from
inputs held in bfloat16 (see BF16 below), against the same reference at
full precision. With `--tf32-program` a second run of
each seed flips the program itself to TF32 products (its own numerics
switch, `torch.backends.cuda.matmul.allow_tf32`), for the trajectory's
numbers. Prints one JSON line per seed; the benchmark's own runs never run
this.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from slambench.harness import check, runner, spec  # noqa: E402

TF32 = check.Precision(tf32=True)
# the window solves' results are set by elementwise float32 arithmetic (the
# residuals and the gradient J^T r, which TF32 does not reach: Gauss-Newton
# with a TF32 Hessian converges to the same point); their control holds the
# solve's floating inputs (the map's rows, poses, preintegrations) in
# bfloat16, the step below float32 there, and computes with TF32
BF16 = check.Precision(tf32=True, storage=torch.bfloat16)


def control_readings(kept: dict, device) -> dict:
    """The control's numbers from one run's sampled frames."""
    caps, seq, fe = kept["caps"], kept["seq"], kept["frontend"]
    out = {"frontend_mismatch": check.frontend_control(caps, seq.pair, fe, TF32),
           "pose_gap": check.pose_gap(caps, TF32, device=device, against_program=False)}
    back = kept["backend"]
    out["local_ba_gap"] = check.local_ba_gap(back["local_ba"], BF16, device=device)
    if seq.imu is not None:
        out["preint_gap"] = check.preint_gap(caps, seq.imu_of, TF32, device=device)
        out["inertial_gap"] = check.inertial_gap(caps, TF32, device=device)
        out["vi_window_gap"] = check.vi_window_gap(back["vi_window"], BF16, device=device)
    return out


def tf32_program(system) -> None:
    """A hook: the program's float32 matrix products in TF32 from here on."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tf32-program", action="store_true")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        res = runner.execute(cell, runner.Run(seed=seed, seconds=args.seconds, trace=False,
                                              keep=True))
        kept = res.pop("_kept")
        line = {"workload": cell.name, "seed": seed, "correct": res["correct"],
                "attempted": res["attempted"], "failed": res["failed"],
                "program": kept["numbers"], "control": control_readings(kept, "cuda")}
        if args.tf32_program:
            import torch
            res2 = runner.execute(cell, runner.Run(seed=seed, seconds=args.seconds, trace=False,
                                                   hooks=[tf32_program]))
            torch.backends.cuda.matmul.allow_tf32 = False
            line["tf32_program"] = {k: v["value"] for k, v in res2["checks"].items()}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
