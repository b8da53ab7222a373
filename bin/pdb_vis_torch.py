#!/usr/bin/env python
"""
Structure renders for the PyTorch port (reference foldingdiff/pymol_vis.py
without PyMOL; JAX twin bin/pdb_vis.py): PDB to PNG, a batch of PNGs, or a
denoising trajectory to a GIF (foldingdiff_tpu_torch.metrics.struct_vis).
Its output is figures: without matplotlib (or PIL, for a GIF) it exits at
once, naming it.

Usage:
  python bin/pdb_vis_torch.py pdb2png structure.pdb -o structure.png
  python bin/pdb_vis_torch.py pdb2png_batch sampled_pdb/*.pdb -o pngs/
  python bin/pdb_vis_torch.py pdb2gif frame_*.pdb -o trajectory.gif
"""
import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from foldingdiff_tpu_torch.metrics import struct_vis  # noqa: E402
from foldingdiff_tpu_torch.metrics.plotting import require_packages  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("pdb2png")
    p1.add_argument("pdb", type=str)
    p1.add_argument("-o", "--out", type=str, required=True)
    p2 = sub.add_parser("pdb2png_batch")
    p2.add_argument("pdbs", nargs="+", type=str)
    p2.add_argument("-o", "--out", type=str, required=True)
    p3 = sub.add_parser("pdb2gif")
    p3.add_argument("pdbs", nargs="+", type=str, help="ordered trajectory frames")
    p3.add_argument("-o", "--out", type=str, required=True)
    p3.add_argument("--duration", type=int, default=100, help="ms per frame")
    p3.add_argument("--stride", type=int, default=1)
    return parser


def main(argv=None):
    """Run the CLI; returns what the subcommand wrote."""
    args = build_parser().parse_args(argv)
    packages = struct_vis.GIF_PACKAGES if args.cmd == "pdb2gif" else struct_vis.PACKAGES
    require_packages(packages, f"bin/pdb_vis_torch.py {args.cmd}")
    if args.cmd == "pdb2png":
        return struct_vis.pdb2png(args.pdb, args.out)
    if args.cmd == "pdb2png_batch":
        return struct_vis.pdb2png_batch(args.pdbs, args.out)
    return struct_vis.pdb2gif(args.pdbs, args.out, duration_ms=args.duration, stride=args.stride)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
