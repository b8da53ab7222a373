#!/usr/bin/env python3
"""
The graphed DDPM step of two checkouts of this repository, timed in turns on
one NVIDIA GPU: the other tree, this tree, this tree, the other tree, each in
a process of its own (each builds its own kernels into its own _build/).

Each process imports its tree's chip_smoke.py, sets TF32 for the process as
the command-line programs do (precision.set_process_default: a "default"
model runs TF32 GEMMs and the kernels' TF32 instances where its tree has
them), writes the flagship (12 x 384, 12 heads of 32, relative_key, M = 128)
with seeded random weights and, for every attention route and matmul
precision asked for, loads it under that attention_impl ("auto": the v2
kernel on every layer; "pallas": v1) and matmul_precision ("default",
"BF16_BF16_F32": the kernels' bf16 instances, "TF32_TF32_F32_X3",
"BF16_BF16_F32_X3", "_X6" or "_X9": their tf32x3, bf16x3, bf16x6 or bf16x9
instances, "F64_F64_F64":
their f64 instances, "F16_F16_F32": their f16 instances, or "F16_F16_F16"
or "BF16_BF16_BF16": their f16f16 or bf16bf16 instances) and times its DDPM
step graph
at B = 63, L = 128 (the sweep's large chunk): wall per step of 10
synchronised replays, the median of three windows, after the capture and
two replays, beside the launches of each kernel instance over the 3 + 30
steps. With --sweep it also times chip_smoke.py's DDPM T = 1000 sweep (-n 1
-l 50 128 -b 64, 78 backbones, CUDA graphs) twice and reports the second
run's backbones per second (the first captures each chunk shape's graphs).

Prints one line per run and, last, a JSON object of the runs with the card's
name and power limit.

Usage: python3 scripts/graphed_step_two_trees.py OTHER_TREE [--attention-impl auto pallas]
           [--precision default BF16_BF16_F32 TF32_TF32_F32_X3 BF16_BF16_F32_X3 BF16_BF16_F32_X6
            BF16_BF16_F32_X9 F64_F64_F64 F16_F16_F32 F16_F16_F16 BF16_BF16_BF16] [--sweep]
(default: --attention-impl pallas --precision default)
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SHAPE = (63, 128)


def time_steps(tree: str, impls: list, precisions: list, sweep: bool) -> dict:
    """In a process whose sys.path starts at `tree`: the step's timing and
    launches per (route, precision), and the sweep's (see the module
    docstring)."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    card = cs.phase_card()
    cs.set_process_default()
    schedule = cs.DiffusionSchedule.create("cosine", 1000, device=cs.DEVICE)
    is_angular = torch.ones(6, dtype=torch.bool, device=cs.DEVICE)
    x, _, mask = cs.denoiser_inputs(*SHAPE)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        weights = cs.model_io.init_random(cs.FLAGSHIP, torch.Generator().manual_seed(cs.SEED))
        cs.model_io.save_model_dir(tmp, cs.FLAGSHIP, weights.state_dict(), cs.FLAGSHIP_TRAIN_ARGS,
                                   cs.np.random.default_rng(cs.SEED).uniform(-cs.np.pi, cs.np.pi, 6))
        empty = cs.AnglesEmptyDataset.from_dir(tmp)
        for impl in impls:
            for precision in precisions:
                model, _ = cs.model_io.from_dir(tmp, device=cs.DEVICE, attention_impl=impl,
                                                matmul_precision=precision)
                cs.reset_counts()
                run = cs.replayed_ddpm_steps(model, cs.sampling.ddpm_table(schedule, 1000), x, mask, is_angular)
                walls = cs.wall_ms_per_step(run)
                r = {"ms": statistics.median(walls), "windows": walls,
                     "launches": {lib.name: dict(lib.launches_by_instance) for lib in (cs.V1, cs.V2)}}
                if sweep:
                    sampler = cs.sampling.build_sampler(model, schedule, list(empty.feature_is_angular["angles"]),
                                                        gen_noise=True)
                    seconds = []
                    for _ in range(2):
                        torch.cuda.synchronize()
                        start = time.perf_counter()
                        cs.sampling.sample(model, schedule, is_angular=list(empty.feature_is_angular["angles"]),
                                           pad=empty.pad, n=1, sweep_lengths=cs.SWEEP, batch_size=cs.BATCH,
                                           bucket_multiple=cs.BUCKET, mean_offset=empty.get_masked_means(),
                                           seed=cs.SEED, sampler=sampler)
                        seconds.append(time.perf_counter() - start)
                    r["backbones_per_s"] = len(range(*cs.SWEEP)) / seconds[1]
                    del sampler
                runs[f"{impl} {precision}"] = r
                del model, run
    return {"tree": tree, "card": card, "runs": runs}


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        spec = json.loads(sys.argv[3])
        print(json.dumps(time_steps(sys.argv[2], spec["impls"], spec["precisions"], spec["sweep"])))
        return
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("other_tree")
    parser.add_argument("--attention-impl", nargs="+", choices=("auto", "pallas"), default=["pallas"])
    parser.add_argument("--precision", nargs="+",
                        choices=("default", "BF16_BF16_F32", "TF32_TF32_F32_X3", "BF16_BF16_F32_X3", "BF16_BF16_F32_X6",
                                 "BF16_BF16_F32_X9", "F64_F64_F64", "F16_F16_F32", "F16_F16_F16", "BF16_BF16_BF16"),
                        default=["default"])
    parser.add_argument("--sweep", action="store_true", help="also time the -n 1 DDPM sweep")
    args = parser.parse_args()
    other = str(Path(args.other_tree).resolve())
    spec = json.dumps({"impls": args.attention_impl, "precisions": args.precision, "sweep": args.sweep})
    results = []
    for tree in (other, str(REPO), str(REPO), other):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", tree, spec], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"the run in {tree} failed:\n{out.stdout}\n{out.stderr}")
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
        for key, r in results[-1]["runs"].items():
            sweep = f"; sweep {r['backbones_per_s']:.3f} backbones/s" if "backbones_per_s" in r else ""
            launches = {f"{lib} {i}": n for lib, by in r["launches"].items() for i, n in by.items() if n}
            print(f"{tree} on {results[-1]['card']}: graphed {key} DDPM step at {SHAPE[0]} x {SHAPE[1]} "
                  f"{r['ms']:.4f} ms ({', '.join(f'{w:.4f}' for w in r['windows'])}); launches {launches}{sweep}",
                  flush=True)
    print(json.dumps({"card": results[0]["card"], "runs": results}))


if __name__ == "__main__":
    main()
