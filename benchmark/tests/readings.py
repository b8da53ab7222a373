"""
The readings that the limits of limits/<cell>.json are set from: runs of a
cell on several seeds in one process, as the program runs (the lower
readings), with the configuration's precision lowered (--precision, the
control: BF16_BF16_F32 for a configuration run at TF32) or with a fault
planted (--fault, faults.py). One JSON line per seed:

    python3 benchmark/tests/readings.py --workload <cell> --seeds 1 2 3 --seconds 3 [--precision P] [--fault F]
"""
import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--precision", default=None)
    parser.add_argument("--fault", default=None)
    args = parser.parse_args()
    from benchmark.harness import runner
    from benchmark.tests import faults

    planted = faults.FAULTS[args.fault]() if args.fault else contextlib.nullcontext()
    overrides = {"matmul_precision": args.precision} if args.precision else None
    with planted:
        for seed in args.seeds:
            numbers = {}
            line = runner.run(args.workload, seed, args.seconds, False, ROOT, overrides=overrides, readings=numbers)
            print(json.dumps({"workload": args.workload, "seed": seed, "precision": args.precision,
                              "fault": args.fault, "correct": line["correct"], "metrics": line["metrics"],
                              "readings": numbers, "failed": line["failed"]}), flush=True)


if __name__ == "__main__":
    main()
