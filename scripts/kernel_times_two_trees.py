#!/usr/bin/env python3
"""
chip_smoke.py's phase 2 (the attention kernels against their plain versions,
then device times of every instance in turns) of two checkouts of this
repository, in turns on one NVIDIA GPU: the other tree, this tree, this tree,
the other tree, each in a process of its own that builds its tree's kernels
(phases 0 and 1) into its own _build/.

Reads each run's "[2] time" lines: kernel, plain and library (SDPA, rel-off
only) ms per entry, instance, (B, L) and rel. Prints, per line, the two runs
of each tree and their means, and last a JSON object of every run's times
with the card's name and power limit. A run that fails (a kernel outside its
gate, a spill) stops the script with its output.

Usage: python3 scripts/kernel_times_two_trees.py OTHER_TREE
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TIME_LINE = re.compile(r"\[2\] time (v\d) (\w+) B=(\d+) H=\d+ L=(\d+) D=\d+ (rel-off|rel) .*?kernel ([\d.]+) ms, "
                       r"plain ([\d.]+) ms, library (?:([\d.]+) ms|none)")
PHASES = "import chip_smoke as cs; cs.phase_card(); cs.phase_build(); cs.phase_kernel()"


def times_of(output: str) -> dict:
    """{"v2 tf32 B=64 L=128 rel": {"kernel": ms, "plain": ms, "library": ms or None}} of a run's output."""
    times = {}
    for m in TIME_LINE.finditer(output):
        entry, instance, b, l, rel, kernel, plain, library = m.groups()
        times[f"{entry} {instance} B={b} L={l} {rel}"] = {
            "kernel": float(kernel), "plain": float(plain), "library": float(library) if library else None}
    return times


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    other = str(Path(sys.argv[1]).resolve())
    trees = (other, str(REPO), str(REPO), other)
    card, runs = None, []
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", PHASES], cwd=tree, capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"phase 2 in {tree} failed:\n{out.stdout[-20000:]}\n{out.stderr[-5000:]}")
        card = card or out.stdout.split("[0] card (nvidia-smi name, power.limit):\n", 1)[1].splitlines()[0]
        runs.append({"tree": tree, "times": times_of(out.stdout)})
        print(f"{tree}: {len(runs[-1]['times'])} timed lines", flush=True)
    print(f"card: {card}; each line: kernel ms of the other tree (run 1, run 4; mean) and of this tree "
          f"(runs 2, 3; mean), then this tree's plain and library ms")
    for key in runs[1]["times"]:
        o = [runs[i]["times"].get(key, {}).get("kernel") for i in (0, 3)]
        t = [runs[i]["times"][key]["kernel"] for i in (1, 2)]
        other_text = (f"{o[0]:.4f}, {o[1]:.4f}; {(o[0] + o[1]) / 2:.4f}" if None not in o else "not timed")
        lib = runs[1]["times"][key]["library"]
        print(f"{key}: other {other_text} | this {t[0]:.4f}, {t[1]:.4f}; {(t[0] + t[1]) / 2:.4f} | plain "
              f"{runs[1]['times'][key]['plain']:.4f}, library {'-' if lib is None else f'{lib:.4f}'}", flush=True)
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
