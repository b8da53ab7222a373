#!/usr/bin/env python
"""
Novelty against the training set for the PyTorch port: the max TM-score of
each generated structure against the training structures (reference
bin/tmscore_training.py; JAX twin bin/tmscore_training.py), host numpy with
the port's TM-align (foldingdiff_tpu_torch.eval.tmscore; one spawned
process pool serves every query). Writes tm_scores.json and tm_scores_ref.json into
the sampled dir.

Usage: python bin/tmscore_training_torch.py -d sampled_pdb --trainfiles results/train_files.txt
"""
import argparse
import contextlib
import json
import logging
import multiprocessing
import os
import sys
from glob import glob
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from foldingdiff_tpu_torch.eval import tmscore  # noqa: E402


def compute_training_tm_scores(pdb_files, train_files, outdir: Path, nthreads=None) -> dict:
    """{name: max TM against train_files}; writes it and {name: best
    reference} into outdir. With more than one thread, one spawned process
    pool serves every query's sweep."""
    nthreads = nthreads or (os.cpu_count() or 1)
    all_scores, all_refs = {}, {}
    with (multiprocessing.get_context("spawn").Pool(nthreads) if nthreads > 1 and len(train_files) > 1
          else contextlib.nullcontext()) as pool:
        for i, fname in enumerate(pdb_files):
            name = os.path.splitext(os.path.basename(fname))[0]
            score, ref = tmscore.max_tm_across_refs(fname, train_files, n_threads=nthreads, pool=pool)
            all_scores[name] = score
            all_refs[name] = ref
            if i % 10 == 0:
                logging.info(f"{i}/{len(pdb_files)}: {name} max TM {score:.3f}")
    with open(outdir / "tm_scores.json", "w") as f:
        json.dump(all_scores, f, indent=4)
    with open(outdir / "tm_scores_ref.json", "w") as f:
        json.dump(all_refs, f, indent=4)
    return all_scores


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-d", "--dirname", type=str, default=os.path.join(os.getcwd(), "sampled_pdb"))
    parser.add_argument("--trainfiles", type=str, required=True,
                        help="train_files.txt from training, or a directory of PDBs")
    parser.add_argument("-n", "--nsubset", type=int, default=0)
    parser.add_argument("--train-subsample", type=int, default=0,
                        help="score against a seeded random subset of the training set instead of all of it "
                             "(makes the check tractable at CATH-scale corpora; 0 = use all)")
    parser.add_argument("--subsample-seed", type=int, default=1234)
    return parser


def main(argv=None) -> dict:
    """Run the CLI; returns the {name: max TM} dict."""
    # Configured here too, so the subsample's "lower bound" note shows when
    # main() is called from another script
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    pdb_files = sorted(glob(os.path.join(args.dirname, "*.pdb")))
    if args.nsubset:
        pdb_files = pdb_files[: args.nsubset]
    if os.path.isdir(args.trainfiles):
        train_files = sorted(glob(os.path.join(args.trainfiles, "*")))
    else:
        with open(args.trainfiles) as f:
            train_files = [line.strip() for line in f if line.strip()]
    train_files = [f for f in train_files if os.path.isfile(f)]
    if args.train_subsample and args.train_subsample < len(train_files):
        rng = np.random.default_rng(args.subsample_seed)
        idx = rng.choice(len(train_files), args.train_subsample, replace=False)
        train_files = [train_files[i] for i in sorted(idx)]
        logging.info(f"Subsampled training refs to {len(train_files)} (seed {args.subsample_seed}); reported max-TM "
                     "novelty is a lower bound on the full-corpus value")
    logging.info(f"{len(pdb_files)} generated vs {len(train_files)} training structures")
    return compute_training_tm_scores(pdb_files, train_files, Path(args.dirname))


if __name__ == "__main__":
    main()
