#!/usr/bin/env python
"""
Sampling CLI for the PyTorch port (foldingdiff_tpu_torch): load a model
directory, run DDPM over a length sweep, write angle CSVs and PDB files.

Takes bin/sample.py's -m -o -n -l -b --seed --nopdb flags, plus --device
(default cuda). With --device cuda and no CUDA device it exits at once;
--device cpu is an explicit choice, never a fallback. Outputs:
  sampled_angles/generated_i.csv.gz   per-structure final angles
  sampled_pdb/generated_i.pdb         NeRF-reconstructed backbones

Usage: python bin/sample_torch.py -m results -l 50 128 -n 10 -b 512 -o sampled
"""
import argparse
import gzip
import logging
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("-m", "--model", type=str, required=True, help="model directory")
    parser.add_argument("-o", "--outdir", type=str, default="./sampled", help="output dir")
    parser.add_argument("-n", "--num", type=int, default=10, help="samples per length")
    parser.add_argument(
        "-l", "--lengths", type=int, nargs=2, default=[50, 128], help="length sweep [min max)"
    )
    parser.add_argument("-b", "--batchsize", type=int, default=512)
    parser.add_argument("--seed", type=int, default=int("0x1234", 16))
    parser.add_argument("--nopdb", action="store_true", help="skip PDB writing")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    return parser


def write_angles_csv(values, feature_names, fname) -> None:
    """One structure's (L, F) angles as a gzipped CSV with a header row,
    values printed as numpy prints them (the same text pandas writes)."""
    with gzip.open(fname, "wt") as f:
        f.write(",".join(feature_names) + "\n")
        for row in values:
            f.write(",".join(str(v) for v in row) + "\n")


def main(argv=None) -> dict:
    """Run the CLI; returns {"n_structures", "sampling_seconds", "pdb_files"}."""
    args = build_parser().parse_args(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")

    from foldingdiff_tpu_torch.data.datasets import AnglesEmptyDataset
    from foldingdiff_tpu_torch.diffusion import sampling as samp
    from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from foldingdiff_tpu_torch.geometry.featurize import create_new_chain_nerf
    from foldingdiff_tpu_torch.models import io as model_io

    outdir = Path(args.outdir)
    os.makedirs(outdir, exist_ok=True)
    model_dir = model_io.resolve_model_dir(args.model)
    model, train_args = model_io.from_dir(model_dir, device=device)
    schedule = DiffusionSchedule.create(
        train_args["variance_schedule"], train_args["timesteps"], device=device
    )
    empty = AnglesEmptyDataset.from_dir(model_dir)
    ft_key = next(iter(empty.feature_names))
    ft_names = list(empty.feature_names[ft_key])
    try:
        mean_offset = empty.get_masked_means()
    except NotImplementedError:
        mean_offset = None

    start = time.perf_counter()
    sampled = samp.sample(
        model, schedule,
        is_angular=empty.feature_is_angular[ft_key],
        pad=empty.pad,
        n=args.num,
        sweep_lengths=tuple(args.lengths),
        batch_size=args.batchsize,
        angular_variance=train_args.get("variance_scale", 1.0),
        mean_offset=mean_offset,
        seed=args.seed,
    )
    sampling_seconds = time.perf_counter() - start
    logging.info(f"Sampled {len(sampled)} structures in {sampling_seconds:.2f} s")

    angles_dir = outdir / "sampled_angles"
    os.makedirs(angles_dir, exist_ok=True)
    for i, s in enumerate(sampled):
        write_angles_csv(s, ft_names, angles_dir / f"generated_{i}.csv.gz")
    logging.info(f"Wrote {len(sampled)} angle CSVs to {angles_dir}")

    pdb_files = []
    if not args.nopdb:
        pdb_dir = outdir / "sampled_pdb"
        os.makedirs(pdb_dir, exist_ok=True)
        for i, s in enumerate(sampled):
            written = create_new_chain_nerf(str(pdb_dir / f"generated_{i}.pdb"), s, ft_names)
            if written:
                pdb_files.append(written)
        logging.info(f"Wrote {len(pdb_files)} PDB files")
    return {"n_structures": len(sampled), "sampling_seconds": sampling_seconds, "pdb_files": pdb_files}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
