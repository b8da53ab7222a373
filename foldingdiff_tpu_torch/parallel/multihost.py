"""
Multi-process runs on torch.distributed (counterpart of
foldingdiff_tpu/parallel/multihost.py).

The reference runs Lightning DDP with one process per GPU (reference
bin/train.py:469-476); the JAX package joins jax.distributed and spans one
global mesh. Here every process joins one process group and runs the same
program; `parallel.mesh` splits the batches and the trainers sum the
gradients. Only the primary process (rank 0) writes files.

Backends: NCCL, one process per card, is the default on the card; gloo is the
default on the CPU, and what ranks that share a card ask for (NCCL refuses
two ranks on one device; gloo runs broadcast and all-reduce on CUDA tensors,
the two collectives that data and tensor parallelism need). A failed NCCL
start raises: nothing falls back to gloo or to the CPU.

Worker, for tests, scripts and launchers (torchrun or one process per rank):

    python -m foldingdiff_tpu_torch.parallel.multihost [--coordinator H:P --nprocs N --procid R]
        [--backend nccl|gloo] [--device cuda|cpu] TARGET [ARGS...]

joins the group (from torchrun's environment when --coordinator is not
given), then runs TARGET: "demo" prints dp_train_step_demo()'s loss as JSON,
"module:function" calls function(ARGS), e.g. bin.sample_torch:main with the
CLI's arguments. It leaves the group when TARGET returns.
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import json
import logging
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from foldingdiff_tpu_torch.devices import require_device

BACKENDS = ("nccl", "gloo")
COLLECTIVE_TIMEOUT = 600  # seconds a collective waits for the other ranks before it raises


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
) -> torch.device:
    """
    Join the process group and return this rank's device: cuda:{LOCAL_RANK
    % device count} (made current) for device "cuda", else the CPU.

    With coordinator_address ("host:port", or a URL such as "file://path"
    or "tcp://host:port"), num_processes and process_id, the group starts
    from them; LOCAL_RANK defaults to process_id (one host). Without them it
    starts from torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE, LOCAL_RANK). backend defaults to "nccl" on the card and
    "gloo" on the CPU; NCCL on the CPU is refused.
    """
    resolved = require_device(device, "distributed device")
    backend = backend or ("nccl" if resolved.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "nccl" and resolved.type != "cuda":
        raise ValueError("the nccl backend runs on CUDA devices only; use gloo on the CPU")
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit) and not all(v is not None for v in explicit):
        raise ValueError("give coordinator_address, num_processes and process_id together, or none of them")
    kwargs = {}
    if coordinator_address is not None:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        kwargs = dict(init_method=url, world_size=int(num_processes), rank=int(process_id))
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    else:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if resolved.type == "cuda":
        resolved = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(resolved)
    if backend == "nccl":  # the communicator starts here, so a failing NCCL raises here
        kwargs["device_id"] = resolved
    dist.init_process_group(backend=backend, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT), **kwargs)
    logging.info(f"torch.distributed ({backend}): rank {dist.get_rank()} of {dist.get_world_size()} on {resolved}")
    return resolved


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """Whether this process writes the files: rank 0, or any process
    outside a process group (reference rank-0 logging, modelling.py:744-749)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def group_mesh():
    """The data mesh over every rank when a process group of more than one
    rank is up, else None."""
    from foldingdiff_tpu_torch.parallel.mesh import make_mesh

    return make_mesh() if dist.is_initialized() and dist.get_world_size() > 1 else None


def data_mesh(batch_size: int):
    """group_mesh() when its size divides batch_size, else None: data-parallel
    training needs whole batches per rank (JAX's orchestration.py:294-302)."""
    mesh = group_mesh()
    if mesh is not None and batch_size % mesh.size:
        logging.warning(f"batch size {batch_size} is not a multiple of the {mesh.size} ranks: every rank trains alone")
        return None
    if mesh is not None:
        logging.info(f"Data-parallel mesh over {mesh.size} ranks")
    return mesh


def dp_train_step_demo(seed: int = 0, batch_size: Optional[int] = None, device: str = "cuda") -> float:
    """
    One data-parallel diffusion train step at a tiny width (2 layers x 64,
    4 heads, L = 16, linear T = 10) over every rank of the process group,
    or on this process alone when none is up. The batch (batch_size rows,
    default 2 per rank) and the weights come from `seed`; dropout is 0, since
    each rank draws its own dropout masks. Returns the global batch's loss,
    the same on every rank and equal to one process's over the same batch.
    `device` is the card unless the caller asks for the CPU; without a card
    it raises at once.
    """
    import numpy as np

    from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from foldingdiff_tpu_torch.models import io as model_io
    from foldingdiff_tpu_torch.models.config import ModelConfig
    from foldingdiff_tpu_torch.parallel.mesh import make_mesh
    from foldingdiff_tpu_torch.training.trainer import Trainer, TrainConfig

    device = require_device(device)
    mesh = make_mesh() if dist.is_initialized() else None
    b, l = batch_size or 2 * (mesh.size if mesh else 1), 16
    config = ModelConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
                         max_position_embeddings=l, position_embedding_type="relative_key",
                         hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = model_io.init_random(config, torch.Generator().manual_seed(seed)).to(device)
    tcfg = TrainConfig(lr=1e-4, batch_size=b, max_epochs=1, lr_scheduler=None, seed=seed)
    trainer = Trainer(model, DiffusionSchedule.create("linear", 10, device=device), tcfg, steps_per_epoch=1,
                      mesh=mesh)
    rng = np.random.default_rng(seed)
    batch = {"angles": rng.uniform(-np.pi, np.pi, size=(b, l, 6)).astype(np.float32),
             "attn_mask": np.ones((b, l), dtype=np.float32), "lengths": np.full((b,), l, dtype=np.int64)}
    avg, _ = trainer.train_step(trainer.to_device(batch))
    return float(avg)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Join a torch.distributed process group and run a target.")
    _add_coordinator_args(parser)
    parser.add_argument("--backend", choices=BACKENDS, default=None, help="default: nccl on cuda, gloo on cpu")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("target", help='"demo", or module:function, called with the remaining arguments')
    parser.add_argument("args", nargs=argparse.REMAINDER)
    return parser


def add_cli_args(parser: argparse.ArgumentParser) -> None:
    """The training CLIs' multi-process flags (bin/train.py:43-74)."""
    parser.add_argument("--multihost", action="store_true",
                        help="join a torch.distributed process group (torchrun's environment unless --coordinator)")
    _add_coordinator_args(parser)


def _add_coordinator_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--coordinator", default=None, type=str, help="rank 0's host:port, with --nprocs, --procid")
    parser.add_argument("--nprocs", default=None, type=int, help="process count for --coordinator")
    parser.add_argument("--procid", default=None, type=int, help="this process's rank for --coordinator")


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    device = initialize(args.coordinator, args.nprocs, args.procid, backend=args.backend, device=args.device)
    try:
        if args.target == "demo":
            loss = dp_train_step_demo(device=str(device))
            print(json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(), "loss": loss}), flush=True)
        else:
            module, _, function = args.target.partition(":")
            getattr(importlib.import_module(module), function)(args.args)
    finally:
        shutdown()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
