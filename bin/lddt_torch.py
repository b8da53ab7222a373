#!/usr/bin/env python
"""
lDDT of each sampled structure's folded structures against it (the scTM
pairing: sampled <stem>.pdb, folded <stem>_*.pdb), for the PyTorch port
(foldingdiff_tpu_torch.metrics.lddt, host numpy), with bin/lddt.py's flags
and JSON. The reference runs OpenStructure in docker (foldingdiff/lddt.py).

Usage: python bin/lddt_torch.py sampled_pdb omegafold_predictions -o lddt.json
       python bin/lddt_torch.py --pair query.pdb reference.pdb
"""
import argparse
import logging
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from foldingdiff_tpu_torch.metrics.lddt import BACKBONE_ATOM_NAMES, lddt_pdb, lddt_sampled_folded  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("sampled_dir", type=str)
    parser.add_argument("folded_dir", type=str, nargs="?", default="")
    parser.add_argument("-o", "--out", type=str, default="lddt.json")
    parser.add_argument("--pair", nargs=2, type=str, default=None,
                        help="score one query/ref pair instead of directories")
    parser.add_argument("--ca-only", action="store_true",
                        help="score the CA trace only (default: all backbone atoms, the reference OpenStructure "
                             "convention)")
    return parser


def main(argv=None):
    """Run the CLI; returns the score dict (with --pair, the one score)."""
    args = build_parser().parse_args(argv)
    atoms = ("CA",) if args.ca_only else BACKBONE_ATOM_NAMES
    if args.pair:
        score = lddt_pdb(args.pair[0], args.pair[1], atoms=atoms)
        print(score)
        return score
    if not args.folded_dir:
        raise SystemExit("folded_dir required (or use --pair)")
    return lddt_sampled_folded(Path(args.sampled_dir), Path(args.folded_dir), out_path=args.out, atoms=atoms)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
