#!/usr/bin/env python
"""
The distribution plots of an existing sample directory, without sampling
again, for the PyTorch port (reference bin/sample_plotting_only.py; JAX twin
bin/sample_plotting_only.py): the Ramachandran, distribution, CDF and SS
co-occurrence PDFs, and ss_counts.json. Its output is figures: without
matplotlib it exits at once, naming it.

Usage: python bin/sample_plotting_only_torch.py -d sampled -o sampled/plots
"""
import argparse
import gzip
import logging
import os
import sys
from glob import glob

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from foldingdiff_tpu_torch.metrics import plotting  # noqa: E402
from foldingdiff_tpu_torch.metrics.ss import count_structures_parallel  # noqa: E402


def read_angles_csv(fname: str):
    """(values (L, F), column names) of a CSV that bin/sample_torch.py wrote."""
    with gzip.open(fname, "rt") if fname.endswith(".gz") else open(fname) as f:
        names = f.readline().strip().split(",")
    return np.loadtxt(fname, delimiter=",", skiprows=1, ndmin=2), names


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-d", "--sampled", type=str, default="sampled")
    parser.add_argument("-o", "--outdir", type=str, default="")
    return parser


def main(argv=None) -> list:
    """Run the CLI; returns the paths written."""
    args = build_parser().parse_args(argv)
    plotting.require_packages(("matplotlib",), "bin/sample_plotting_only_torch.py")
    outdir = args.outdir or os.path.join(args.sampled, "plots")
    os.makedirs(outdir, exist_ok=True)
    csvs = sorted(glob(os.path.join(args.sampled, "sampled_angles", "*.csv.gz")))
    if not csvs:
        raise SystemExit(f"No angle CSVs under {args.sampled}/sampled_angles")
    tables = [read_angles_csv(f) for f in csvs]
    ft_names = tables[0][1]
    all_angles = np.concatenate([values for values, _ in tables])

    written = []
    if "phi" in ft_names and "psi" in ft_names:
        written.append(plotting.plot_ramachandran(
            all_angles[:, ft_names.index("phi")], all_angles[:, ft_names.index("psi")],
            os.path.join(outdir, "ramachandran_generated.pdf"), annot_ss=True,
            title=f"Ramachandran, {len(tables)} generated structures"))
    for name, cumulative in (("generated_distributions.pdf", False), ("generated_distributions_cdf.pdf", True)):
        written.append(plotting.plot_distribution_overlap({"generated": all_angles}, os.path.join(outdir, name),
                                                          ft_names, cumulative=cumulative))
    pdbs = sorted(glob(os.path.join(args.sampled, "sampled_pdb", "*.pdb")))
    if pdbs:
        counts = [c for c in count_structures_parallel(pdbs) if c != (-1, -1)]
        if counts:
            a, b = zip(*counts)
            written.append(plotting.plot_ss_cooccurrence(
                a, b, os.path.join(outdir, "ss_cooccurrence_generated.pdf"),
                json_file=os.path.join(outdir, "ss_counts.json")))
    logging.info(f"Plots written to {outdir}")
    return written


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
