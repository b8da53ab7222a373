#!/usr/bin/env python
"""
Add carbonyl oxygens to N/CA/C backbone PDBs (some downstream tools need
them), for the PyTorch port (reference bin/add_oxygen_to_backbone.py; JAX
twin bin/add_oxygen_to_backbone.py; host numpy,
foldingdiff_tpu_torch.geometry.sidechains).

Usage: python bin/add_oxygen_to_backbone_torch.py sampled_pdb -o sampled_pdb_with_o
"""
import argparse
import logging
import os
import sys
from glob import glob

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from foldingdiff_tpu_torch.geometry.sidechains import add_oxygen_to_backbone  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("dirname", type=str, help="directory of backbone PDBs (or one file)")
    parser.add_argument("-o", "--outdir", type=str, required=True)
    return parser


def main(argv=None) -> list:
    """Run the CLI; returns the PDBs written."""
    args = build_parser().parse_args(argv)
    fnames = sorted(glob(os.path.join(args.dirname, "*.pdb"))) if os.path.isdir(args.dirname) else [args.dirname]
    os.makedirs(args.outdir, exist_ok=True)
    outs = [add_oxygen_to_backbone(f, os.path.join(args.outdir, os.path.basename(f))) for f in fnames]
    logging.info(f"Added oxygens to {len(fnames)} files -> {args.outdir}")
    return outs


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
