#!/usr/bin/env python
"""
Training CLI for the PyTorch port (foldingdiff_tpu_torch): config JSON ->
datasets -> trainer -> model directory, which bin/sample_torch.py loads.

Takes bin/train.py's config -o --dataset --toy --debug_single_time --dryrun
--epochs --batchsize --seed --resume flags, merged over the config JSON
(files under config_jsons/ work unchanged), plus --device (default cuda;
with no CUDA device it exits at once). --cpu is --device cpu. --ngpu is
accepted and unused, as in bin/train.py (passed on to train() as its ngpu).
--multihost joins a torch.distributed process group first, from torchrun's
environment or from --coordinator host:port --nprocs N --procid R (one
process per rank; NCCL on the card, each rank on cuda:{LOCAL_RANK}; gloo on
the CPU), and training is data-parallel over the ranks; only rank 0 writes.
--debug_single_time
trains from the single-timestep debug noiser (data/debug_noisers.py: one
feature at t = 100, noised on the host) through the pre-corrupted step and
returns one {"epoch", "train_loss"} row per epoch; it saves no model.
Without --dryrun, train() writes the KL diagnostics and, where matplotlib is
installed, their figures and the loss plot (training/orchestration.py). On
the card the run holds the advisory job lock (utils_platform.py).

Usage: python bin/train_torch.py config_jsons/cath_full_angles_cosine.json -o results
       torchrun --nproc_per_node 8 bin/train_torch.py config_jsons/cath_full_angles_cosine.json --multihost -o results
"""
import argparse
import json
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("config", nargs="?", default="", type=str, help="config json")
    parser.add_argument("-o", "--outdir", default="./results", type=str, help="results dir")
    parser.add_argument("--dataset", default=None, type=str, help="dataset key or PDB dir")
    parser.add_argument("--toy", default=None, type=int, help="subset to n structures")
    parser.add_argument("--debug_single_time", action="store_true")
    parser.add_argument("--dryrun", action="store_true", help="skip plots and extras")
    parser.add_argument("--epochs", default=None, type=int, help="override max/min epochs")
    parser.add_argument("--batchsize", default=None, type=int)
    parser.add_argument("--seed", default=None, type=int, help="override the training seed (train() default 42)")
    parser.add_argument("--resume", action="store_true", help="resume from the newest train_state checkpoint")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    parser.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    parser.add_argument("--ngpu", default=-1, type=int, help="unused; device count is automatic")
    from foldingdiff_tpu_torch.parallel.multihost import add_cli_args

    add_cli_args(parser)
    return parser


def main(argv=None) -> list:
    """Run the CLI; returns the metrics rows, one per epoch trained."""
    args = build_parser().parse_args(argv)
    from foldingdiff_tpu_torch.devices import require_device
    from foldingdiff_tpu_torch.utils import update_dict_nonnull

    try:
        device = require_device("cpu" if args.cpu else args.device, "--device")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    from foldingdiff_tpu_torch.parallel import multihost
    from foldingdiff_tpu_torch.training.orchestration import train
    from foldingdiff_tpu_torch.utils_platform import job_lock_if_cuda

    if args.multihost:
        device = multihost.initialize(args.coordinator, args.nprocs, args.procid, device=device.type)

    config = {}
    if args.config:
        with open(args.config) as f:
            config = json.load(f)
    overrides = {
        "results_dir": args.outdir,
        "subset": args.toy,
        "single_timestep_debug": args.debug_single_time or None,
        "dryrun": args.dryrun or None,
        "dataset_key": args.dataset,
        "max_epochs": args.epochs,
        "min_epochs": args.epochs,
        "batch_size": args.batchsize,
        "seed": args.seed,
        "resume": args.resume or None,
        "device": str(device),
        "ngpu": args.ngpu,
    }
    config = update_dict_nonnull(config, {k: v for k, v in overrides.items() if v is not None})
    config.pop("multithread_plotting", None)  # accepted for parity; train() takes no such key
    try:
        # the advisory job lock (utils_platform.py), as bin/train.py:108 holds it
        with job_lock_if_cuda(device):
            _, rows = train(**config)
    finally:
        if args.multihost:
            multihost.shutdown()
    return rows


if __name__ == "__main__":
    from foldingdiff_tpu_torch.precision import set_process_default

    logging.basicConfig(level=logging.INFO)
    set_process_default()  # a "default" model's GEMMs in TF32, as XLA:GPU's
    main()
