#!/usr/bin/env python
"""
Hierarchical clustering of generated structures by pairwise TM distance for
the PyTorch port (reference bin/hclust_structures.py; JAX twin
bin/hclust_structures.py), host numpy and scipy with the port's TM-align.
Writes <outprefix>_tm_matrix.npy and <outprefix>_clusters.json first, then,
where matplotlib is installed, <outprefix>_dendrogram.pdf; without it one
warning at start names the figure skipped.

Usage: python bin/hclust_structures_torch.py sampled_pdb -o hclust
"""
import argparse
import itertools
import json
import logging
import multiprocessing
import os
import sys
from glob import glob

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from foldingdiff_tpu_torch.eval import tmalign_native, tmscore  # noqa: E402


def get_pairwise_tmscores(fnames, nthreads=None) -> np.ndarray:
    """Symmetric pairwise TM-score matrix with a unit diagonal; a pair that
    fails scores 0 (reference hclust_structures.py:38-70). With the native
    TM-align each PDB is parsed once and every pair aligns in memory; else
    file-level numpy TM-scores, in a spawned process pool past 16 pairs."""
    pairs = list(itertools.combinations(range(len(fnames)), 2))
    if tmalign_native.available():
        traces = [tmscore._load_ca(f) for f in fnames]
        traces = [None if c is None or len(c) < 5 else np.ascontiguousarray(c, dtype=np.float64) for c in traces]
        values = [tmalign_native.tm_align_coords(traces[i], traces[j])
                  if traces[i] is not None and traces[j] is not None else float("nan") for i, j in pairs]
    else:
        args = [(fnames[i], fnames[j]) for i, j in pairs]
        nthreads = nthreads or (os.cpu_count() or 1)
        if nthreads > 1 and len(args) > 16:
            with multiprocessing.get_context("spawn").Pool(nthreads) as pool:
                values = pool.starmap(tmscore.run_tmalign, args, chunksize=16)
        else:
            values = [tmscore.run_tmalign(*a) for a in args]
    mat = np.eye(len(fnames))
    for (i, j), v in zip(pairs, values):
        mat[i, j] = mat[j, i] = v if not np.isnan(v) else 0.0
    return mat


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("dirname", type=str, help="directory of PDB files")
    parser.add_argument("-o", "--outprefix", type=str, default="hclust")
    parser.add_argument("--nclusters", type=int, default=10)
    parser.add_argument("--nsubset", type=int, default=0)
    return parser


def main(argv=None) -> dict:
    """Run the CLI; returns {"tm_matrix": (n, n) array, "clusters": {file: label}}."""
    from scipy.cluster import hierarchy
    from scipy.spatial.distance import squareform

    from foldingdiff_tpu_torch.metrics.plotting import figures_available, pyplot

    args = build_parser().parse_args(argv)
    draw = figures_available([f"{args.outprefix}_dendrogram.pdf"])
    fnames = sorted(glob(os.path.join(args.dirname, "*.pdb")))
    if args.nsubset:
        fnames = fnames[: args.nsubset]
    logging.info(f"Clustering {len(fnames)} structures")
    tm_matrix = get_pairwise_tmscores(fnames)
    np.save(args.outprefix + "_tm_matrix.npy", tm_matrix)

    dist = 1.0 - tm_matrix
    np.fill_diagonal(dist, 0.0)
    dist = (dist + dist.T) / 2
    linkage = hierarchy.linkage(squareform(dist, checks=False), method="average")
    labels = hierarchy.fcluster(linkage, t=args.nclusters, criterion="maxclust")
    clusters = {os.path.basename(n): int(label) for n, label in zip(fnames, labels)}
    with open(args.outprefix + "_clusters.json", "w") as f:
        json.dump(clusters, f, indent=4)
    logging.info(f"Wrote {args.outprefix}_clusters.json ({len(set(labels))} clusters)")

    if draw:
        plt = pyplot()
        fig, ax = plt.subplots(dpi=300, figsize=(10, 4))
        hierarchy.dendrogram(linkage, ax=ax, no_labels=len(fnames) > 50)
        ax.set(title=f"Hierarchical clustering of {len(fnames)} structures (1 - TM)")
        fig.savefig(args.outprefix + "_dendrogram.pdf", bbox_inches="tight")
        plt.close(fig)
    return {"tm_matrix": tm_matrix, "clusters": clusters}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
