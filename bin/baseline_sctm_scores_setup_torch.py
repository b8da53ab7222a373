#!/usr/bin/env python
"""
The scTM baseline for the PyTorch port: the REAL test-split structures,
round-tripped through NeRF (so they pass the representation bottleneck that
generated ones do), written as PDBs for the scTM pipeline (reference
bin/baseline_sctm_scores_setup.py:55-95; JAX twin
bin/baseline_sctm_scores_setup.py; host numpy).

Usage: python bin/baseline_sctm_scores_setup_torch.py -m results --data <pdb_dir> -o real_baseline
"""
import argparse
import json
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-m", "--model", type=str, required=True)
    parser.add_argument("--data", type=str, required=True, help="PDB dir")
    parser.add_argument("-n", "--num", type=int, default=0, help="subset; 0 = all")
    parser.add_argument("-o", "--outdir", type=str, default="real_baseline")
    return parser


def main(argv=None) -> list:
    """Run the CLI; returns the PDBs written."""
    from foldingdiff_tpu_torch.data import datasets as dsets
    from foldingdiff_tpu_torch.geometry.featurize import create_new_chain_nerf

    args = build_parser().parse_args(argv)
    with open(os.path.join(args.model, "training_args.json")) as f:
        train_args = json.load(f)
    ds = dsets.DATASET_CLASSES[train_args["angles_definitions"]](
        pdbs=args.data, split="test", pad=train_args["max_seq_len"], min_length=train_args.get("min_seq_len", 0),
        trim_strategy=train_args.get("trim_strategy", "leftalign"), zero_center=False,
    )
    ft_names = list(ds.feature_names["angles"])
    pdb_dir = os.path.join(args.outdir, "sampled_pdb")
    os.makedirs(pdb_dir, exist_ok=True)
    n = args.num or len(ds)
    written = []
    for i in range(min(n, len(ds))):
        item = ds.__getitem__(i, ignore_zero_center=True)
        angles = item["angles"][: int(item["lengths"])]
        name = os.path.splitext(os.path.basename(ds.filenames[i]))[0]
        out = create_new_chain_nerf(os.path.join(pdb_dir, f"{name}.pdb"), angles, ft_names)
        if out:
            written.append(out)
    logging.info(f"NeRF round-tripped {len(written)} real test structures into {pdb_dir}; "
                 "run the inverse-fold + refold + sctm_torch.py pipeline on them")
    return written


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
