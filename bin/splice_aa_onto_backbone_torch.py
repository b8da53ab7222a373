#!/usr/bin/env python
"""
Graft an amino-acid sequence's idealized side chains onto a generated
backbone, for the PyTorch port (reference bin/splice_aa_onto_backbone.py;
JAX twin bin/splice_aa_onto_backbone.py; host numpy,
foldingdiff_tpu_torch.geometry.sidechains).

Usage: python bin/splice_aa_onto_backbone_torch.py backbone.pdb SEQVENCE -o full.pdb
"""
import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from foldingdiff_tpu_torch.geometry.sidechains import add_sidechains_to_backbone  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("backbone", type=str)
    parser.add_argument("sequence", type=str, help="1-letter AA sequence or a .fasta file")
    parser.add_argument("-o", "--out", type=str, required=True)
    return parser


def main(argv=None) -> str:
    """Run the CLI; returns the PDB written."""
    args = build_parser().parse_args(argv)
    seq = args.sequence
    if os.path.isfile(seq):
        with open(seq) as f:
            seq = "".join(line.strip() for line in f if not line.startswith(">"))
    out = add_sidechains_to_backbone(args.backbone, seq, args.out)
    logging.info(f"Wrote {out}")
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
