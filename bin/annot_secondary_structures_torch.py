#!/usr/bin/env python
"""
Secondary-structure elements (alpha, beta) per PDB by P-SEA (or an external
DSSP), and their co-occurrence, for the PyTorch port (reference
bin/annot_secondary_structures.py; JAX twin
bin/annot_secondary_structures.py), host numpy. With --json the counts are
written first; the co-occurrence PDF needs matplotlib: without it one
warning at start names the figure skipped.

Usage: python bin/annot_secondary_structures_torch.py sampled_pdb/*.pdb plots/ss_cooccurrence.pdf --json counts.json
"""
import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from foldingdiff_tpu_torch.geometry.pdb import get_pdb_length  # noqa: E402
from foldingdiff_tpu_torch.metrics import plotting  # noqa: E402
from foldingdiff_tpu_torch.metrics.ss import count_structures_parallel  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("pdb_files", nargs="+", type=str)
    parser.add_argument("outpdf", type=str)
    parser.add_argument("--json", type=str, default="", help="also write counts json")
    parser.add_argument("--maxlen", type=int, default=0, help="filter to length <= maxlen")
    parser.add_argument("--title", type=str, default="Secondary structure co-occurrence")
    parser.add_argument("--backend", choices=("psea", "dssp"), default="psea",
                        help="SS annotation backend: native P-SEA (default) or the external DSSP binary "
                             "(reference bin/annot_secondary_structures.py:89-99)")
    return parser


def main(argv=None) -> list:
    """Run the CLI; returns the (alpha, beta) counts of the structures that annotated."""
    args = build_parser().parse_args(argv)
    draw = plotting.figures_available([args.outpdf])
    pdb_files = args.pdb_files
    if args.maxlen > 0:
        orig = len(pdb_files)
        pdb_files = [p for p in pdb_files if get_pdb_length(p) <= args.maxlen]
        logging.info(f"Length filter {args.maxlen}: {orig} -> {len(pdb_files)}")

    counts = [c for c in count_structures_parallel(pdb_files, backend=args.backend) if c != (-1, -1)]
    alpha, beta = zip(*counts)
    if args.json:
        plotting.write_ss_counts(alpha, beta, args.json)
    if draw:
        plotting.plot_ss_cooccurrence(alpha, beta, args.outpdf, title=args.title)
        logging.info(f"Wrote {args.outpdf} over {len(counts)} structures")
    return counts


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
