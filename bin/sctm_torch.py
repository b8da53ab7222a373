#!/usr/bin/env python
"""
scTM designability for the PyTorch port: the max TM-score between each
generated backbone and its <= 8 refolded structures (reference bin/sctm.py;
JAX twin bin/sctm.py), host numpy with the port's TM-align
(foldingdiff_tpu_torch.eval). The folded dir holds, for each
generated_N.pdb, generated_N_*_residues_*.pdb (the inverse-fold + refold
pipeline's names). Designable means scTM >= 0.5 (reference sctm.py:127-130).

Writes <outprefix>.json, <outprefix>_refs.json and <outprefix>.csv (name,
sctm, length, n_alpha, n_beta, designable) first, then, where matplotlib is
installed, <outprefix>_hist.pdf and, with -t, <outprefix>_vs_training.pdf;
without matplotlib one warning at start names the figures skipped.

Usage: python bin/sctm_torch.py -p sampled_pdb -f omegafold_predictions -o sctm_scores
"""
import argparse
import csv
import functools
import json
import logging
import multiprocessing
import os
import sys
from glob import glob
from typing import List, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from foldingdiff_tpu_torch.eval import tmscore  # noqa: E402
from foldingdiff_tpu_torch.geometry.pdb import get_pdb_length  # noqa: E402
from foldingdiff_tpu_torch.metrics.ss import count_structures_in_pdb  # noqa: E402


def folded_structures(orig_pdb, folded_dirname) -> List[str]:
    """The first 8 refolds of orig_pdb, sorted (reference sctm.py:30-44)."""
    bname = os.path.splitext(os.path.basename(orig_pdb))[0] + "_*_residues_*.pdb"
    folded_pdbs = sorted(glob(os.path.join(folded_dirname, bname)))[:8]
    if len(folded_pdbs) < 8:
        logging.warning(f"Fewer than 8 (n={len(folded_pdbs)}) structures for {orig_pdb}")
    return folded_pdbs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-p", "--predicted", type=str, default=os.path.join(os.getcwd(), "sampled_pdb"))
    parser.add_argument("-f", "--folded", type=str, default=os.path.join(os.getcwd(), "omegafold_predictions"))
    parser.add_argument("-o", "--outprefix", type=str, default=os.path.join(os.getcwd(), "sctm_scores"))
    parser.add_argument("-t", "--trainingtms", type=str, default="",
                        help="optional tm_scores.json of training-set max TM for joint plot")
    return parser


def score_all(backbones: List[str], folded_dir: str) -> Tuple[list, list]:
    """(P-SEA counts, (scTM, best refold)) of each backbone: the max TM over
    its <= 8 refolds, (NaN, "") without any (reference sctm.py:30-44). More
    than 8 backbones on more than one core run in a spawned process pool."""
    folded = [folded_structures(b, folded_dir) for b in backbones]
    nproc = os.cpu_count() or 1
    jobs = [(b, f) for b, f in zip(backbones, folded) if f]
    if nproc > 1 and len(backbones) > 8:
        with multiprocessing.get_context("spawn").Pool(nproc) as pool:
            ss_counts = pool.map(count_structures_in_pdb, backbones, chunksize=10)
            scores = pool.starmap(functools.partial(tmscore.max_tm_across_refs, parallel=False), jobs, chunksize=5)
    else:
        ss_counts = [count_structures_in_pdb(b) for b in backbones]
        scores = [tmscore.max_tm_across_refs(b, f, parallel=False) for b, f in jobs]
    by_backbone = dict(zip((b for b, _ in jobs), scores))
    return ss_counts, [by_backbone.get(b, (np.nan, "")) for b in backbones]


def write_scores(backbones: List[str], folded_dir: str, outprefix: str) -> dict:
    """The numbers: <outprefix>.json ({name: scTM}), _refs.json ({name: best
    refold}) and .csv; returns the {name: scTM} dict."""
    names = [os.path.splitext(os.path.basename(f))[0] for f in backbones]
    lengths = {n: get_pdb_length(f) for n, f in zip(names, backbones)}
    ss_counts, raw = score_all(backbones, folded_dir)
    ok = [i for i, (v, _) in enumerate(raw) if not np.isnan(v)]
    scores = {names[i]: raw[i][0] for i in ok}
    refs = {names[i]: raw[i][1] for i in ok}
    vals = np.array(list(scores.values()))
    passing = int(np.sum(vals >= 0.5))
    logging.info(f"{len(vals)} scored; {passing} designable (scTM >= 0.5) = {passing / max(len(vals), 1):.3f}")
    with open(outprefix + ".json", "w") as f:
        json.dump(scores, f, indent=4)
    with open(outprefix + "_refs.json", "w") as f:
        json.dump(refs, f, indent=4)

    # Per-length breakdown (reference sctm.py:150-179)
    rows = [{"name": n, "sctm": s, "length": lengths[n], "n_alpha": ss_counts[names.index(n)][0],
             "n_beta": ss_counts[names.index(n)][1], "designable": s >= 0.5} for n, s in scores.items()]
    with open(outprefix + ".csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["name", "sctm", "length", "n_alpha", "n_beta", "designable"])
        writer.writeheader()
        writer.writerows(rows)
    for label, keep in (("short (<=70)", lambda r: r["length"] <= 70), ("long (>70)", lambda r: r["length"] > 70),
                        ("all", lambda r: True)):
        sub = [r for r in rows if keep(r)]
        if sub:
            logging.info(f"{label}: {sum(r['designable'] for r in sub)}/{len(sub)} designable, "
                         f"median scTM {np.median([r['sctm'] for r in sub]):.3f}")
    return scores


def plot_scores(scores: dict, outprefix: str, trainingtms: str) -> None:
    from foldingdiff_tpu_torch.metrics.plotting import pyplot

    plt = pyplot()
    vals = np.array(list(scores.values()))
    passing = int(np.sum(vals >= 0.5))
    fig, ax = plt.subplots(dpi=300)
    ax.hist(vals, bins=40)
    ax.axvline(0.5, color="red", linestyle="--", label="designability cutoff")
    ax.set(xlabel="scTM", ylabel="count", title=f"scTM scores ({passing}/{len(vals)} designable)")
    ax.legend()
    fig.savefig(outprefix + "_hist.pdf", bbox_inches="tight")
    plt.close(fig)
    if trainingtms and os.path.isfile(trainingtms):
        with open(trainingtms) as f:
            train_tm = json.load(f)
        common = [n for n in scores if n in train_tm]
        if common:
            fig, ax = plt.subplots(dpi=300, figsize=(5, 5))
            ax.scatter([train_tm[n] for n in common], [scores[n] for n in common], s=8, alpha=0.5)
            ax.axhline(0.5, color="red", linestyle="--", alpha=0.5)
            ax.set(xlabel="max TM to training set", ylabel="scTM", title="scTM vs training similarity")
            fig.savefig(outprefix + "_vs_training.pdf", bbox_inches="tight")
            plt.close(fig)


def main(argv=None) -> dict:
    """Run the CLI; returns the {name: scTM} dict."""
    from foldingdiff_tpu_torch.metrics.plotting import figures_available

    args = build_parser().parse_args(argv)
    for d in (args.predicted, args.folded):
        if not os.path.isdir(d):
            raise SystemExit(f"Missing {d}")
    draw = figures_available([f"{args.outprefix}_hist.pdf"]
                             + ([f"{args.outprefix}_vs_training.pdf"] if args.trainingtms else []))
    backbones = sorted(glob(os.path.join(args.predicted, "*.pdb")))
    logging.info(f"Computing scTM for {len(backbones)} generated structures")
    scores = write_scores(backbones, args.folded, args.outprefix)
    if draw:
        plot_scores(scores, args.outprefix, args.trainingtms)
    return scores


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
