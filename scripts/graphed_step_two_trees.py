#!/usr/bin/env python3
"""
The graphed "pallas" DDPM step of two checkouts of this repository, timed in
turns on one NVIDIA GPU: the other tree, this tree, this tree, the other
tree, each in a process of its own (each builds its own kernels into its own
_build/).

Each process imports its tree's chip_smoke.py, sets TF32 for the process as
the command-line programs do (precision.set_process_default: a "default"
model runs TF32 GEMMs and the kernels' TF32 instances where its tree has
them), writes the flagship (12 x 384, 12 heads of 32, relative_key, M = 128)
with seeded random weights, loads it under attention_impl "pallas" (the v1
kernel on every layer) and times its DDPM step graph at B = 63, L = 128 (the
sweep's large chunk): wall per step of 10 synchronised replays, the median
of three windows, after the capture and two replays, beside the launches of
each v1 instance over the 3 + 30 steps.

Prints one line per run and, last, a JSON object of the runs with the card's
name and power limit.

Usage: python3 scripts/graphed_step_two_trees.py OTHER_TREE
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SHAPE = (63, 128)


def time_step(tree: str) -> dict:
    """In a process whose sys.path starts at `tree`: the step's timing and
    launches (see the module docstring)."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    card = cs.phase_card()
    cs.set_process_default()
    with tempfile.TemporaryDirectory() as tmp:
        weights = cs.model_io.init_random(cs.FLAGSHIP, torch.Generator().manual_seed(cs.SEED))
        cs.model_io.save_model_dir(tmp, cs.FLAGSHIP, weights.state_dict(), cs.FLAGSHIP_TRAIN_ARGS,
                                   cs.np.random.default_rng(cs.SEED).uniform(-cs.np.pi, cs.np.pi, 6))
        model, _ = cs.model_io.from_dir(tmp, device=cs.DEVICE, attention_impl="pallas")
    schedule = cs.DiffusionSchedule.create("cosine", 1000, device=cs.DEVICE)
    x, _, mask = cs.denoiser_inputs(*SHAPE)
    cs.reset_counts()
    run = cs.replayed_ddpm_steps(model, cs.sampling.ddpm_table(schedule, 1000), x, mask,
                                 torch.ones(6, dtype=torch.bool, device=cs.DEVICE))
    walls = cs.wall_ms_per_step(run)
    return {"tree": tree, "card": card, "ms": statistics.median(walls), "windows": walls,
            "v1_launches": dict(cs.V1.launches_by_instance)}


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(time_step(sys.argv[2])))
        return
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    other = str(Path(sys.argv[1]).resolve())
    runs = []
    for tree in (other, str(REPO), str(REPO), other):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", tree], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"the run in {tree} failed:\n{out.stdout}\n{out.stderr}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        r = runs[-1]
        print(f"{r['tree']} on {r['card']}: graphed 'pallas' DDPM step at {SHAPE[0]} x {SHAPE[1]} "
              f"{r['ms']:.4f} ms ({', '.join(f'{w:.4f}' for w in r['windows'])}); v1 launches {r['v1_launches']}",
              flush=True)
    print(json.dumps({"card": runs[0]["card"], "runs": runs}))


if __name__ == "__main__":
    main()
