"""Run one cell of the port's benchmark once.

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Drives `orbslam3lib_tpu_torch.system.System.track_stereo` on the cell's
configuration (`configs/`) and traffic mix (`traffic/`), as `BENCHMARK.json`
names them: set-up (frames rendered on the card from the seed, the warm-up
frames), then a window of `--seconds`, then the correctness check. The last
line of standard output is the result object; the check's numbers, each
beside its limit, are the last lines of standard error. With `--trace 1`
the metrics are the cell's per-layer metrics, read from a profiled slice of
the window and the stage timer. `--out DIR` also writes the frame log
there (default: $TMPDIR/slambench). Exits non-zero, printing no result,
without a CUDA card, when the port cannot be imported, or when JAX or the
JAX package was loaded.
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slambench.harness import runner, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "slambench"))
    args = ap.parse_args(argv)
    try:
        cell = spec.cell(args.workload)
        result = runner.execute(cell, runner.Run(seed=args.seed, seconds=args.seconds,
                                                 trace=bool(args.trace), out_dir=args.out))
    except runner.RunError as e:
        print(f"slambench: {e}", file=sys.stderr)
        return 2
    lines = result.pop("_lines")
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
