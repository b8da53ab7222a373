#!/usr/bin/env python3
"""
Which operation of the port's train step is not bitwise reproducible on the
card, and whether the step's CUDA graph adds any difference of its own.

Runs the flagship train step (12 x 384, relative_key, dropout 0.1, B = 64,
L = 128, seeded random weights and batches) for a few steps, twice eagerly
and once as graph replays (Trainer.train_steps), from the same weights,
generator and dropout seed, and prints per step: whether the losses are
equal bit for bit and which parameters' gradients differ (eager against
eager at the first step names the nondeterministic operation's gradient).
With --deterministic it runs itself again in a child process under
torch.use_deterministic_algorithms(True, warn_only=True) and
CUBLAS_WORKSPACE_CONFIG=:4096:8, where every run must agree bit for bit.

Usage (on a machine with a CUDA card):
    python3 scripts/train_step_determinism.py [--steps 4] [--deterministic]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule  # noqa: E402
from foldingdiff_tpu_torch.models import io as model_io  # noqa: E402
from foldingdiff_tpu_torch.models.config import ModelConfig  # noqa: E402
from foldingdiff_tpu_torch.training.trainer import Trainer, TrainConfig  # noqa: E402

FLAGSHIP = ModelConfig(hidden_size=384, num_hidden_layers=12, num_attention_heads=12, intermediate_size=768,
                       max_position_embeddings=128, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def host_batches(n: int, b: int = 64, l: int = 128) -> list:
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        lengths = rng.integers(40, l + 1, b)
        out.append({"angles": rng.uniform(-np.pi, np.pi, (b, l, 6)).astype(np.float32),
                    "attn_mask": (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32),
                    "lengths": lengths.astype(np.int64)})
    return out


def run(mode: str, batches: list) -> list:
    """Per step: (the loss row, {name: gradient}) of the eager trainer's
    train_step calls (cuda_graphs=False) or of the graphed trainer's replays
    (the first step runs eagerly at capture); both have the same AdamW."""
    model = model_io.init_random(FLAGSHIP, torch.Generator().manual_seed(2)).to("cuda")
    schedule = DiffusionSchedule.create("cosine", 1000, device="cuda")
    trainer = Trainer(model, schedule, TrainConfig(lr=1e-4, batch_size=64, max_epochs=800,
                                                   lr_scheduler="OneCycleLR"), steps_per_epoch=300,
                      cuda_graphs=mode != "eager")
    torch.manual_seed(7)
    out = []
    for b in batches:
        if mode == "eager":
            loss, terms = trainer.train_step(trainer.to_device(b))
            row = torch.cat([loss[None], terms])
        else:
            row = trainer.train_steps([b])[0]
        torch.cuda.synchronize()
        out.append((row.clone(), {n: p.grad.clone() for n, p in trainer.model.named_parameters()}))
    return out


def compare(tag: str, a: list, b: list, first_graph_step: bool = False) -> None:
    for i, ((row_a, grads_a), (row_b, grads_b)) in enumerate(zip(a, b)):
        differ = [n for n in grads_a if not torch.equal(grads_a[n], grads_b[n])]
        note = " (the capture step: the graph's gradients are not its own yet)" if first_graph_step and i == 0 else ""
        print(f"{tag}, step {i}: losses bitwise equal {torch.equal(row_a, row_b)}; gradients differing "
              f"{len(differ)} of {len(grads_a)}{note}: {differ[:4]}{' ...' if len(differ) > 4 else ''}", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.fp32_precision = "ieee"  # a "default" model's GEMMs in IEEE float32
    if args.child:
        torch.use_deterministic_algorithms(True, warn_only=True)
    label = "deterministic algorithms" if args.child else "default algorithms"
    batches = host_batches(args.steps)
    eager, again, graphed = run("eager", batches), run("eager", batches), run("graphs", batches)
    compare(f"{label}: eager against eager", eager, again)
    compare(f"{label}: graphed against eager", graphed, eager, first_graph_step=True)
    if args.deterministic and not args.child:
        subprocess.run([sys.executable, __file__, "--child", "--steps", str(args.steps)], check=True,
                       env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})


if __name__ == "__main__":
    main()
