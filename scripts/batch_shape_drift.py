#!/usr/bin/env python3
"""
How far a DDPM chain of the port moves when the same rows run at another
batch shape, on one NVIDIA GPU: the question behind chip_smoke.py phase 10
(b), where two ranks each run half of every sampling chunk.

The flagship denoiser (12 x 384, relative_key, chip_smoke.py's seeded random
weights) samples the sweep's small chunk (lengths 50..64, bucket 64) by DDPM
T = 1000 cosine, once whole (B = 15) and once as the two ranks of a 2-rank
mesh run it (B = 8 each, the second padded; the same chunk draws), all in
this process. Prints the largest circular difference of the valid
positions after reverse steps 1, 2, ... 1000, then one denoiser call at
t = 999 on rows 0-7 at B = 8 against B = 15 and its Linear layers alone,
beside the card's name and power limit.

Usage: python3 scripts/batch_shape_drift.py
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from foldingdiff_tpu_torch.diffusion import sampling  # noqa: E402
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule  # noqa: E402
from foldingdiff_tpu_torch.models import io as model_io  # noqa: E402
from foldingdiff_tpu_torch.parallel.mesh import Mesh, shard_batch  # noqa: E402

STEPS = [1, 2, 3, 5, 10, 20, 50, 100, 200, 500, 1000]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("batch_shape_drift: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    model = model_io.init_random(cs.FLAGSHIP, torch.Generator().manual_seed(cs.SEED)).to("cuda").eval()
    schedule = DiffusionSchedule.create("cosine", 1000, device="cuda")
    lengths = np.arange(cs.SWEEP[0], cs.BUCKET + 1)
    mask = torch.from_numpy((np.arange(cs.BUCKET)[None] < lengths[:, None]).astype(np.float32)).cuda()
    n = len(lengths)

    def chain(mesh):
        return sampling.build_sampler(model, schedule, [True] * 6, gen_noise=True, return_history=True,
                                      mesh=mesh)(mask, cs.SEED, 0)

    whole = chain(None)
    halves = torch.cat([chain(Mesh(None, rank=r, size=2)) for r in range(2)], dim=1)[:, :n]
    diff = (torch.remainder(halves - whole + np.pi, 2 * np.pi) - np.pi).abs() * mask[None, :, :, None]
    print("max circular difference after reverse step:",
          ", ".join(f"{s}: {diff[s - 1].max().item():.2e}" for s in STEPS))

    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    x = torch.randn(n, cs.BUCKET, 6, generator=g, device="cuda")
    t = torch.full((n,), 999, device="cuda")
    h = torch.randn(n, cs.BUCKET, cs.FLAGSHIP.hidden_size, generator=g, device="cuda")
    rank0 = Mesh(None, rank=0, size=2)
    with torch.inference_mode():
        call = (model(*shard_batch(rank0, x, t, mask)) - model(x, t, mask)[:8]).abs().max().item()
        layer = model.encoder.layer[0]
        linears = max((f(a[:8]) - f(a)[:8]).abs().max().item() for f, a in (
            (model.inputs_to_hidden_dim, x), (layer.attention.self.query, h), (layer.intermediate.dense, h)))
    print(f"one denoiser call at t = 999, rows 0-7 at B = 8 against B = 15: max abs difference {call:.2e}; "
          f"its Linear layers alone {linears:.2e}")


if __name__ == "__main__":
    main()
