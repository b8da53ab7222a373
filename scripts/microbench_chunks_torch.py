#!/usr/bin/env python3
"""
Time the T = 1000 DDPM sampling chain per (chunk size, sequence bucket)
shape on the card, to pick how sample() cuts the 50..127 sweep into chunks:
the port's twin of scripts/microbench_chunks.py.

The flagship (12 x 384, 12 heads of 32, intermediate 768, M = 128,
relative_key; attention "auto") with seeded random weights, a cosine
schedule of MB_TIMESTEPS steps (default 1000), and build_sampler's
generating sampler over six angular features, called as
sampler(mask, 1, i) on an all-ones (B, L) mask. On the card the chains run
as CUDA graphs (MB_GRAPHS=1, the default; MB_GRAPHS=0 runs the eager loops).
As a program the process runs TF32 GEMMs, as the command-line programs do
(precision.set_process_default).

For each shape: three runs, each ending in a synchronise; the first captures
the shape's graphs. Prints a header line (T, graphs, the device, and the
card's name and power limit as nvidia-smi gives them), then one line per
shape in scripts/microbench_chunks.py's format: the best run's scan seconds,
ms per step and ms per item, then the capture: the first run's seconds over
the best run's.

Usage: python scripts/microbench_chunks_torch.py ["B,L" ...] [--device cpu]
(defaults to scripts/microbench_chunks.py's shapes: the chunks of the
780-structure sweep at bucket 16, batch 64). Without a card it exits unless
--device cpu is given, for a toy run: MB_TIMESTEPS=2 ... "2,16" --device cpu.
"""
import argparse
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from foldingdiff_tpu_torch.devices import require_device  # noqa: E402
from foldingdiff_tpu_torch.diffusion import sampling  # noqa: E402
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule  # noqa: E402
from foldingdiff_tpu_torch.models import io as model_io  # noqa: E402
from foldingdiff_tpu_torch.models.config import ModelConfig  # noqa: E402
from foldingdiff_tpu_torch.ops import attention  # noqa: E402
from foldingdiff_tpu_torch.precision import set_process_default  # noqa: E402

DEFAULT_SHAPES = [
    (64, 64), (22, 64),
    (64, 80), (32, 80),
    (64, 96), (32, 96),
    (64, 112), (32, 112),
    (64, 128), (22, 128),
]
SEED = 0


def shape(text: str) -> tuple:
    b, l = (int(x) for x in text.split(","))
    return b, l


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them, where it exists."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> list:
    """Run the shapes; returns [(B, L, best scan s, first run s), ...]."""
    parser = argparse.ArgumentParser(usage=__doc__)
    parser.add_argument("shapes", nargs="*", type=shape, help='"B,L" (default: the JAX script\'s shapes)')
    parser.add_argument("--device", default="cuda", help="the card unless cpu is asked for")
    args = parser.parse_args(argv)
    try:
        device = require_device(args.device, "--device")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    timesteps = int(os.environ.get("MB_TIMESTEPS", "1000"))
    graphs = int(os.environ.get("MB_GRAPHS", "1"))
    config = ModelConfig(
        hidden_size=384,
        num_hidden_layers=12,
        num_attention_heads=12,
        intermediate_size=768,
        max_position_embeddings=128,
        position_embedding_type="relative_key",
    )
    model = model_io.init_random(config, torch.Generator().manual_seed(SEED)).to(device)
    schedule = DiffusionSchedule.create("cosine", timesteps, device=device)
    sampler = sampling.build_sampler(model, schedule, [True] * 6, gen_noise=True, cuda_graphs=bool(graphs))
    on_card = device.type == "cuda"
    build = ""
    if on_card:
        start = time.perf_counter()
        attention.REL_ATTENTION.load()
        build = f", v2 kernel build {time.perf_counter() - start:.1f} s"
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"T={timesteps} graphs={graphs} device={name} ({card_line() if on_card else 'no card'}){build}",
          flush=True)

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(device)

    results = []
    for b, l in args.shapes or DEFAULT_SHAPES:
        mask = torch.ones(b, l, device=device)
        times = []
        for i in range(3):
            sync()
            t0 = time.perf_counter()
            sampler(mask, 1, i)
            sync()
            times.append(time.perf_counter() - t0)
        total = min(times)
        print(
            f"B={b:4d} L={l:4d}: scan {total:7.3f} s"
            f"  step {total / timesteps * 1e3:6.3f} ms"
            f"  per-item {total / b * 1e3:7.1f} ms"
            f"  capture {times[0] - total:6.3f} s",
            flush=True,
        )
        results.append((b, l, total, times[0]))
    return results


if __name__ == "__main__":
    set_process_default()  # a "default" model's GEMMs in TF32, as XLA:GPU's
    main()
