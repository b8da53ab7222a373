"""
Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON object; the numbers
that decide `correct`, each beside its limit, are the last lines of
standard error. Exits non-zero, printing no result, without the GPUs the
cell asks for, or if JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from benchmark.harness import runner

    line = runner.run(args.workload, args.seed, args.seconds, bool(args.trace), Path.cwd(), t_start=T_START)
    if line is None:
        return 1
    sys.stdout.flush()
    print(runner.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
