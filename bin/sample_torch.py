#!/usr/bin/env python
"""
Sampling CLI for the PyTorch port (foldingdiff_tpu_torch): load a model
directory, sample a length sweep (DDPM, DDIM or DPM-Solver++), write angle
CSVs and PDB files.

Takes bin/sample.py's -m -o -n -l -b --seed --method --ddim_steps --ddim_eta
--noise-scale --fullhistory --nopdb flags, plus --device (default cuda).
With --device cuda and no CUDA device it exits at once; --device cpu is an
explicit choice, never a fallback. When a torch.distributed process group of
more than one rank is up (python -m foldingdiff_tpu_torch.parallel.multihost
... bin.sample_torch:main ARGS, or torchrun on that module), each chunk's
rows are split over the ranks and rank 0 gathers them and writes every
output. Outputs:
  sampled_angles/generated_i.csv.gz   per-structure final angles (or x, y, z)
  sampled_angles/sample_history/generated_i/timestep_t.csv.gz
                                      every step's state, with --fullhistory
  sampled_pdb/generated_i.pdb         NeRF-reconstructed backbones; CA traces
                                      for cart-coords models, skipping (with
                                      a warning) any that overflow the PDB
                                      columns
  model_snapshot/                     a copy of the model's files

Usage: python bin/sample_torch.py -m results -l 50 128 -n 10 -b 512 -o sampled
"""
import argparse
import logging
import os
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("-m", "--model", type=str, required=True, help="model directory")
    parser.add_argument("-o", "--outdir", type=str, default="./sampled", help="output dir")
    parser.add_argument("-n", "--num", type=int, default=10, help="samples per length")
    parser.add_argument(
        "-l", "--lengths", type=int, nargs=2, default=[50, 128], help="length sweep [min max)"
    )
    parser.add_argument("-b", "--batchsize", type=int, default=512)
    parser.add_argument("--seed", type=int, default=int("0x1234", 16))
    parser.add_argument(
        "--method", type=str, default="ddpm", choices=["ddpm", "ddim", "dpmpp"],
        help="ddpm = reference-parity ancestral; ddim = accelerated; "
             "dpmpp = DPM-Solver++(2M), fewest steps (--ddim_steps sets both)",
    )
    parser.add_argument("--ddim_steps", type=int, default=50)
    parser.add_argument("--ddim_eta", type=float, default=0.0)
    parser.add_argument(
        "--noise-scale", type=str, default="",
        help="DDPM posterior-noise temperature: one float, or comma-separated "
             "per-feature floats. DDPM only.",
    )
    parser.add_argument("--fullhistory", action="store_true", help="write per-timestep angles")
    parser.add_argument("--nopdb", action="store_true", help="skip PDB writing")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    return parser


def write_pdbs(structures, feature_names, pdb_dir: Path):
    """Each sampled (L, F) table as a PDB: NeRF backbones from angles, CA
    traces from cart-coords tables (x, y, z columns), skipping with a
    warning a trace that write_ca_trace_to_pdb refuses (bin/sample.py:76-89).
    Returns (written paths, indices skipped)."""
    from foldingdiff_tpu_torch.geometry.featurize import create_new_chain_nerf
    from foldingdiff_tpu_torch.geometry.pdb import write_ca_trace_to_pdb

    os.makedirs(pdb_dir, exist_ok=True)
    files, skipped = [], []
    for i, s in enumerate(structures):
        out = str(pdb_dir / f"generated_{i}.pdb")
        if list(feature_names) == ["x", "y", "z"]:
            try:
                files.append(write_ca_trace_to_pdb(s, out))
            except ValueError as e:
                logging.warning(f"Skipping sample {i}: {e}")
                skipped.append(i)
        else:
            written = create_new_chain_nerf(out, s, feature_names)
            if written:
                files.append(written)
    return files, skipped


def main(argv=None) -> dict:
    """Run the CLI; returns {"n_structures", "sampling_seconds", "pdb_files",
    "pdb_skipped"}, the first and the last two of what this process wrote
    (nothing on another rank than 0)."""
    args = build_parser().parse_args(argv)
    if args.noise_scale and args.method != "ddpm":
        raise SystemExit("--noise-scale is a DDPM posterior-noise temperature; "
                         f"method={args.method!r} takes none")
    import numpy as np

    from foldingdiff_tpu_torch.devices import require_device

    try:
        device = require_device(args.device, "--device")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None

    from foldingdiff_tpu_torch.data.datasets import AnglesEmptyDataset
    from foldingdiff_tpu_torch.diffusion import sampling as samp
    from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from foldingdiff_tpu_torch.models import io as model_io
    from foldingdiff_tpu_torch.parallel.multihost import group_mesh
    from foldingdiff_tpu_torch.utils import write_angles_csv

    outdir = Path(args.outdir)
    mesh = group_mesh()
    model_dir = model_io.resolve_model_dir(args.model)
    model, train_args = model_io.from_dir(model_dir, device=device)
    schedule = DiffusionSchedule.create(
        train_args["variance_schedule"], train_args["timesteps"], device=device
    )
    empty = AnglesEmptyDataset.from_dir(model_dir)
    # cart-coords models store their features under "coords", all others "angles"
    ft_key = next(iter(empty.feature_names))
    ft_names = list(empty.feature_names[ft_key])

    try:
        mean_offset = empty.get_masked_means()
    except NotImplementedError:
        mean_offset = None

    noise_scale = None
    if args.noise_scale:
        vals = [float(v) for v in args.noise_scale.split(",")]
        if len(vals) == 1:
            noise_scale = vals[0]
        elif len(vals) == len(ft_names):
            noise_scale = np.asarray(vals, dtype=np.float32)
        else:
            raise SystemExit(f"--noise-scale needs 1 or {len(ft_names)} values, got {len(vals)}")

    start = time.perf_counter()
    sampled = samp.sample(
        model, schedule,
        is_angular=empty.feature_is_angular[ft_key],
        pad=empty.pad,
        n=args.num,
        sweep_lengths=tuple(args.lengths),
        batch_size=args.batchsize,
        angular_variance=train_args.get("variance_scale", 1.0),
        mean_offset=mean_offset,
        seed=args.seed,
        method=args.method,
        ddim_steps=args.ddim_steps,
        ddim_eta=args.ddim_eta,
        noise_scale=noise_scale,
        return_history=args.fullhistory,
        mesh=mesh,
    )
    sampling_seconds = time.perf_counter() - start
    if sampled is None:  # another rank than 0 of the mesh: rank 0 holds the structures and writes
        return {"n_structures": 0, "sampling_seconds": sampling_seconds, "pdb_files": [], "pdb_skipped": []}
    logging.info(f"Sampled {len(sampled)} structures in {sampling_seconds:.2f} s")
    # A copy of the model's files beside the outputs (bin/sample.py:139-145)
    snapshot = outdir / "model_snapshot"
    if snapshot.exists():
        shutil.rmtree(snapshot)
    shutil.copytree(model_dir, snapshot,
                    ignore=shutil.ignore_patterns("logs", "plots", "*.log", "valid_preds", "train_state"))
    final = [s[-1] for s in sampled] if args.fullhistory else sampled

    angles_dir = outdir / "sampled_angles"
    os.makedirs(angles_dir, exist_ok=True)
    for i, s in enumerate(final):
        write_angles_csv(s, ft_names, angles_dir / f"generated_{i}.csv.gz")
    logging.info(f"Wrote {len(final)} angle CSVs to {angles_dir}")

    if args.fullhistory:
        for i, s in enumerate(sampled):
            sub = angles_dir / "sample_history" / f"generated_{i}"
            os.makedirs(sub, exist_ok=True)
            for t_idx in range(s.shape[0]):
                write_angles_csv(s[t_idx], ft_names, sub / f"timestep_{t_idx}.csv.gz")
        logging.info(f"Wrote {len(sampled)} x {sampled[0].shape[0]} history CSVs")

    pdb_files, skipped = [], []
    if not args.nopdb:
        pdb_files, skipped = write_pdbs(final, ft_names, outdir / "sampled_pdb")
        logging.info(f"Wrote {len(pdb_files)} PDB files, skipped {len(skipped)}")
    return {"n_structures": len(final), "sampling_seconds": sampling_seconds, "pdb_files": pdb_files,
            "pdb_skipped": skipped}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
