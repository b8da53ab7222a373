#!/usr/bin/env python
"""
MDS embedding of generated structures from their pairwise TM distances,
coloured by length, P-SEA element counts and scTM, for the PyTorch port
(reference bin/mds_structures.py; JAX twin bin/mds_structures.py; UMAP left
out, as there). The embedding needs scikit-learn: without it the CLI exits
at once, naming it. Writes <outprefix>_embedding.npy, then, where matplotlib
is installed, <outprefix>.pdf; without it one warning at start names the
figure skipped.

Usage: python bin/mds_structures_torch.py sampled_pdb -o mds --sctm sctm_scores.json
"""
import argparse
import json
import logging
import os
import sys
from glob import glob

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bin.hclust_structures_torch import get_pairwise_tmscores  # noqa: E402
from foldingdiff_tpu_torch.geometry.pdb import get_pdb_length  # noqa: E402
from foldingdiff_tpu_torch.metrics.ss import count_structures_in_pdb  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("dirname", type=str)
    parser.add_argument("-o", "--outprefix", type=str, default="mds")
    parser.add_argument("--sctm", type=str, default="", help="sctm_scores.json for coloring")
    parser.add_argument("--matrix", type=str, default="", help="precomputed TM matrix .npy")
    parser.add_argument("--nsubset", type=int, default=0)
    return parser


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns the (n, 2) embedding."""
    from foldingdiff_tpu_torch.metrics.plotting import figures_available, pyplot, require_packages

    args = build_parser().parse_args(argv)
    require_packages(("sklearn",), "bin/mds_structures_torch.py's embedding")
    draw = figures_available([f"{args.outprefix}.pdf"])
    from sklearn.manifold import MDS

    fnames = sorted(glob(os.path.join(args.dirname, "*.pdb")))
    if args.nsubset:
        fnames = fnames[: args.nsubset]
    names = [os.path.splitext(os.path.basename(f))[0] for f in fnames]
    if args.matrix and os.path.isfile(args.matrix):
        tm_matrix = np.load(args.matrix)
    else:
        tm_matrix = get_pairwise_tmscores(fnames)

    dist = 1.0 - tm_matrix
    np.fill_diagonal(dist, 0.0)
    dist = (dist + dist.T) / 2
    emb = MDS(n_components=2, dissimilarity="precomputed", random_state=0).fit_transform(dist)
    np.save(args.outprefix + "_embedding.npy", emb)

    colorings = {"length": [get_pdb_length(f) for f in fnames]}
    ss = [count_structures_in_pdb(f) for f in fnames]
    colorings["n_alpha"] = [a for a, _ in ss]
    colorings["n_beta"] = [b for _, b in ss]
    if args.sctm and os.path.isfile(args.sctm):
        with open(args.sctm) as f:
            sctm = json.load(f)
        colorings["scTM"] = [sctm.get(n, np.nan) for n in names]
    if draw:
        plt = pyplot()
        n = len(colorings)
        fig, axes = plt.subplots(dpi=300, ncols=n, figsize=(4.2 * n, 4))
        if n == 1:
            axes = [axes]
        for (label, vals), ax in zip(colorings.items(), axes):
            sc = ax.scatter(emb[:, 0], emb[:, 1], c=vals, s=12, cmap="viridis")
            fig.colorbar(sc, ax=ax, label=label)
            ax.set(title=f"MDS of TM distances, colored by {label}")
        fig.savefig(args.outprefix + ".pdf", bbox_inches="tight")
        plt.close(fig)
        logging.info(f"Wrote {args.outprefix}.pdf")
    return emb


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
