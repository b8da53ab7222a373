#!/usr/bin/env python
"""
Partial-noise reconstruction for the PyTorch port (foldingdiff_tpu_torch):
noise the test split's structures t steps forward, denoise them with the
model's partial DDPM chain, and report the TM-score of each reconstruction
against its truth (reference bin/partial_noise_reconstruct.py and
sampling.py:287-356).

Takes bin/partial_noise_reconstruct.py's -m --data -t -b -o --nsubset --cpu
flags, plus --device (default cuda); --cpu is --device cpu. With --device
cuda and no CUDA device it exits at once; the CPU is an explicit choice,
never a fallback. The chains run on the device; once they are back on the host, the
NeRF builds and TM-scores run in a spawned process pool, whose workers never
touch CUDA. The JSON has bin/partial_noise_reconstruct.py's keys:
noise_timesteps, tm_scores (by file basename) and tm_scores_coords. When a
torch.distributed process group of more than one rank is up, each batch's
rows are split over the ranks; rank 0 gathers the chains, scores them and
writes the JSON.

Usage: python bin/partial_noise_reconstruct_torch.py -m results -t 250 --data <pdb_dir>
"""
import argparse
import json
import logging
import multiprocessing
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-m", "--model", type=str, required=True)
    parser.add_argument("--data", type=str, required=True, help="PDB dir for the test split")
    parser.add_argument("-t", "--timesteps", type=int, default=250, help="forward-noise steps")
    parser.add_argument("-b", "--batchsize", type=int, default=512)
    parser.add_argument("-o", "--outjson", type=str, default="reconstruction_tm.json")
    parser.add_argument("--nsubset", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    parser.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return parser


def main(argv=None) -> dict:
    """Run the CLI; returns {"n_structures", "chain_seconds",
    "scoring_seconds", "pool_workers" (0: scored in this process),
    "tm_path" ("native" or "numpy"), "payload"}, the payload being the JSON
    written (on another rank than 0: no structures, no payload)."""
    args = build_parser().parse_args(argv)
    import numpy as np

    from foldingdiff_tpu_torch.devices import require_device

    try:
        device = require_device("cpu" if args.cpu else args.device, "--device")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None

    import torch

    from foldingdiff_tpu_torch.data import datasets as dsets
    from foldingdiff_tpu_torch.diffusion import sampling as samp
    from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from foldingdiff_tpu_torch.eval import tmalign_native, tmscore
    from foldingdiff_tpu_torch.models import io as model_io
    from foldingdiff_tpu_torch.parallel.multihost import group_mesh
    from foldingdiff_tpu_torch.utils import modulo_with_wrapped_range

    model, train_args = model_io.from_dir(args.model, device=device)
    schedule = DiffusionSchedule.create(train_args["variance_schedule"], train_args["timesteps"], device=device)
    ds_cls = dsets.DATASET_CLASSES[train_args["angles_definitions"]]
    ds = ds_cls(
        pdbs=args.data,
        split="test",
        pad=train_args["max_seq_len"],
        min_length=train_args.get("min_seq_len", 0),
        trim_strategy=train_args.get("trim_strategy", "leftalign"),
    )
    # Re-apply the stored training mean offset (reference
    # bin/partial_noise_reconstruct.py:44)
    offset_file = os.path.join(args.model, "training_mean_offset.npy")
    mean_offset = np.load(offset_file) if os.path.isfile(offset_file) else None
    if mean_offset is not None:
        ds.set_masked_means(mean_offset)

    data = ds.to_arrays()
    filenames = ds.filenames
    if args.nsubset:
        data = {k: v[: args.nsubset] for k, v in data.items()}
        filenames = filenames[: args.nsubset]

    start = time.perf_counter()
    recons = samp.get_reconstruction_error(
        model, schedule, data,
        is_angular=ds.feature_is_angular["angles"],
        noise_timesteps=args.timesteps,
        batch_size=args.batchsize,
        mean_offset=mean_offset,
        mesh=group_mesh(),
    )  # ends in the copy of each batch to the host
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    chain_seconds = time.perf_counter() - start
    if recons is None:  # another rank than 0: rank 0 holds the chains, scores and writes
        return {"n_structures": 0, "chain_seconds": chain_seconds, "scoring_seconds": 0.0, "pool_workers": 0,
                "tm_path": None, "payload": None}
    truths = [
        modulo_with_wrapped_range(
            data["angles"][i, : int(data["lengths"][i])] + (mean_offset if mean_offset is not None else 0))
        for i in range(len(recons))
    ]

    # Built (or found) here, once, so the pool's workers only load it
    tm_path = "native" if tmalign_native.available() else "numpy"
    start = time.perf_counter()
    ft_names = list(ds.feature_names["angles"])
    jobs = [(r, t, f, ft_names) for r, t, f in zip(recons, truths, filenames)]
    chunksize = 4
    # One worker per CPU, but no more than there are chunks of jobs: each
    # spawned worker pays an interpreter start and the imports
    workers = min(os.cpu_count() or 1, -(-len(jobs) // chunksize))
    if workers > 1:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            results = pool.starmap(tmscore.score_reconstruction, jobs, chunksize=chunksize)
    else:
        workers = 0
        results = [tmscore.score_reconstruction(*job) for job in jobs]
    scoring_seconds = time.perf_counter() - start
    scores, coord_scores = zip(*results) if results else ((), ())
    scores = np.array(scores, dtype=float)
    logging.info(
        f"t={args.timesteps}: reconstruction TM mean {np.nanmean(scores):.3f} "
        f"median {np.nanmedian(scores):.3f}; chains {chain_seconds:.2f} s, TM scoring ({tm_path}) "
        f"{scoring_seconds:.2f} s"
    )
    payload = {
        "noise_timesteps": args.timesteps,
        "tm_scores": {os.path.basename(f): s for f, s in zip(filenames, scores.tolist())},
        "tm_scores_coords": [float(s) for s in coord_scores],
    }
    with open(args.outjson, "w") as f:
        json.dump(payload, f, indent=4)
    return {"n_structures": len(recons), "chain_seconds": chain_seconds, "scoring_seconds": scoring_seconds,
            "pool_workers": workers, "tm_path": tm_path, "payload": payload}


if __name__ == "__main__":
    from foldingdiff_tpu_torch.precision import set_process_default

    logging.basicConfig(level=logging.INFO)
    set_process_default()  # a "default" model's GEMMs in TF32, as XLA:GPU's
    main()
