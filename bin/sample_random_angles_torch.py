#!/usr/bin/env python
"""
The random-angle baseline with the PyTorch port (foldingdiff_tpu_torch):
each feature's values resampled independently from the test split's pooled
angles into "structures" (counterpart of bin/sample_random_angles.py;
reference bin/sample_random_angles.py). This keeps every marginal and
destroys the joint structure: the null model of the paper's comparisons.

Takes bin/sample_random_angles.py's -m --data -n -o --seed flags, plus
--device (default cuda; with no CUDA device it exits at once; --cpu is
--device cpu) as every entry point of the port takes it, though the
resampling and the NeRF run on the host. The model directory gives the
feature set, the pad and the trimming. Writes sampled_pdb/random_i.pdb.

Usage: python bin/sample_random_angles_torch.py -m results --data <pdb_dir> -n 100 -o random_baseline
"""
import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-m", "--model", type=str, required=True, help="model dir (for config)")
    parser.add_argument("--data", type=str, required=True, help="PDB dir")
    parser.add_argument("-n", "--num", type=int, default=100)
    parser.add_argument("-o", "--outdir", type=str, default="random_baseline")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    parser.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return parser


def main(argv=None) -> dict:
    """Run the CLI; returns {"angles": one (length, F) array per structure,
    "pdb_files": the PDBs written}."""
    args = build_parser().parse_args(argv)
    from foldingdiff_tpu_torch.devices import require_device

    try:
        require_device("cpu" if args.cpu else args.device, "--device")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None

    import json

    import numpy as np

    from foldingdiff_tpu_torch.data import datasets as dsets
    from foldingdiff_tpu_torch.geometry.featurize import create_new_chain_nerf

    with open(os.path.join(args.model, "training_args.json")) as f:
        train_args = json.load(f)
    ds = dsets.DATASET_CLASSES[train_args["angles_definitions"]](
        pdbs=args.data, split="test", pad=train_args["max_seq_len"], min_length=train_args.get("min_seq_len", 0),
        trim_strategy=train_args.get("trim_strategy", "leftalign"), zero_center=False,
    )
    ft_names = list(ds.feature_names["angles"])

    # Pool every observed value of each feature
    rows = []
    for i in range(len(ds)):
        item = ds.__getitem__(i, ignore_zero_center=True)
        rows.append(item["angles"][: int(item["lengths"])])
    pool = np.concatenate(rows)
    rng = np.random.default_rng(args.seed)

    pdb_dir = os.path.join(args.outdir, "sampled_pdb")
    os.makedirs(pdb_dir, exist_ok=True)
    lengths = rng.choice([len(r) for r in rows], size=args.num, replace=True)
    samples, pdb_files = [], []
    for i, length in enumerate(lengths):
        # Each feature column resampled independently (destroys the joint structure)
        angles = np.stack([rng.choice(pool[:, j], size=length, replace=True) for j in range(pool.shape[1])], axis=1)
        samples.append(angles)
        written = create_new_chain_nerf(os.path.join(pdb_dir, f"random_{i}.pdb"), angles, ft_names)
        if written:
            pdb_files.append(written)
    logging.info(f"Wrote {len(pdb_files)}/{args.num} random-angle baseline structures to {pdb_dir}")
    return {"angles": samples, "pdb_files": pdb_files}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
