#!/usr/bin/env python
"""
Sampling CLI for the PyTorch port (foldingdiff_tpu_torch): load a model
directory, sample a length sweep (DDPM, DDIM or DPM-Solver++), write angle
CSVs and PDB files.

Takes bin/sample.py's flags (-m -o -n -l -b --seed --method --ddim_steps
--ddim_eta --noise-scale --fullhistory --nopdb --noplot --testcomparison
--profile --cpu), plus --device (default cuda; --cpu is --device cpu).
With --device cuda and no CUDA device it exits at once; --device cpu is an
explicit choice, never a fallback. --profile DIR writes a torch.profiler
Chrome trace of the sampling to DIR/trace.json. When a torch.distributed process group of
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
  plots/ (unless --noplot)            the report of bin/sample.py:218-281:
                                      ks_tests.json (with --testcomparison:
                                      per feature, (statistic, p) of the
                                      two-sample KS against the test split),
                                      ss_counts.json (P-SEA element counts
                                      per PDB), then, where matplotlib is
                                      installed, the Ramachandran,
                                      distribution, CDF and SS co-occurrence
                                      PDFs; without matplotlib one warning
                                      at start names the figures skipped

Usage: python bin/sample_torch.py -m results -l 50 128 -n 10 -b 512 -o sampled
"""
import argparse
import json
import logging
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

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
    parser.add_argument("--noplot", action="store_true", help="skip the report (its JSONs and plots)")
    parser.add_argument(
        "--testcomparison", type=str, default="",
        help="PDB dir: compare generated against test-split angle distributions",
    )
    parser.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    parser.add_argument("--profile", type=str, default="",
                        help="write a torch.profiler Chrome trace of the sampling to this dir")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    return parser


FIGURES = ("ramachandran_generated.pdf", "generated_distributions.pdf", "generated_distributions_cdf.pdf",
           "ss_cooccurrence_generated.pdf")


def test_split_angles(pdb_dir: str, train_args: dict) -> np.ndarray:
    """The unpadded, uncentred features of the test split of pdb_dir, rows
    pooled over structures, under the model's training settings
    (bin/sample.py:239-258)."""
    from foldingdiff_tpu_torch.data.datasets import DATASET_CLASSES

    test_ds = DATASET_CLASSES[train_args["angles_definitions"]](
        pdbs=pdb_dir, split="test", pad=train_args["max_seq_len"], min_length=train_args.get("min_seq_len", 0),
        trim_strategy=train_args.get("trim_strategy", "leftalign"), zero_center=False,
    )
    rows = []
    for i in range(len(test_ds)):
        item = test_ds.__getitem__(i, ignore_zero_center=True)
        feats = item["angles"] if "angles" in item else item["coords"]
        rows.append(feats[: int(item["lengths"])])
    return np.concatenate(rows)


def write_report(plots_dir: Path, final, ft_names, pdb_files, test_angles=None, draw: bool = True) -> dict:
    """bin/sample.py:218-281: the numbers first -- ks_tests.json (given the
    test split's angles: {feature: [KS statistic, p]}) and ss_counts.json
    (given PDBs) -- then, if draw, the figures. Returns {name: path} of
    what it wrote."""
    from foldingdiff_tpu_torch.metrics import plotting
    from foldingdiff_tpu_torch.metrics.ss import count_structures_parallel

    os.makedirs(plots_dir, exist_ok=True)
    written = {}
    all_angles = np.concatenate(final)
    if test_angles is not None:
        from scipy import stats

        ks = {name: tuple(map(float, stats.ks_2samp(all_angles[:, i], test_angles[:, i])))
              for i, name in enumerate(ft_names)}
        written["ks_tests.json"] = str(plots_dir / "ks_tests.json")
        with open(written["ks_tests.json"], "w") as f:
            json.dump(ks, f, indent=2)
        logging.info(f"KS statistics vs test data: {ks}")
    counts = [c for c in count_structures_parallel(pdb_files) if c != (-1, -1)] if pdb_files else []
    if counts:
        alpha, beta = zip(*counts)
        written["ss_counts.json"] = plotting.write_ss_counts(alpha, beta, str(plots_dir / "ss_counts.json"))
    if not draw:
        return written
    if "phi" in ft_names and "psi" in ft_names:
        written["ramachandran_generated.pdf"] = plotting.plot_ramachandran(
            all_angles[:, ft_names.index("phi")], all_angles[:, ft_names.index("psi")],
            str(plots_dir / "ramachandran_generated.pdf"), annot_ss=True,
            title=f"Ramachandran, {len(final)} generated structures")
    dists = {"generated": all_angles}
    if test_angles is not None:
        dists["test data"] = test_angles
    for name, cumulative in (("generated_distributions.pdf", False), ("generated_distributions_cdf.pdf", True)):
        written[name] = plotting.plot_distribution_overlap(dists, str(plots_dir / name), ft_names,
                                                           cumulative=cumulative)
    if counts:
        written["ss_cooccurrence_generated.pdf"] = plotting.plot_ss_cooccurrence(
            alpha, beta, str(plots_dir / "ss_cooccurrence_generated.pdf"))
    return written


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
    "pdb_skipped", "report"}, the first and the last three of what this
    process wrote (nothing on another rank than 0); "report" maps each file
    of plots/ to its path."""
    args = build_parser().parse_args(argv)
    if args.noise_scale and args.method != "ddpm":
        raise SystemExit("--noise-scale is a DDPM posterior-noise temperature; "
                         f"method={args.method!r} takes none")
    from foldingdiff_tpu_torch.devices import require_device
    from foldingdiff_tpu_torch.utils_profiling import maybe_profile, phase_timer

    try:
        device = require_device("cpu" if args.cpu else args.device, "--device")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    draw = False
    if not args.noplot:
        from foldingdiff_tpu_torch.metrics.plotting import figures_available

        draw = figures_available(FIGURES)

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

    with maybe_profile(args.profile, device), phase_timer("sampling"):
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
        sampling_seconds = time.perf_counter() - start  # the trace's export on leaving the profiler is not in it
    if sampled is None:  # another rank than 0 of the mesh: rank 0 holds the structures and writes
        return {"n_structures": 0, "sampling_seconds": sampling_seconds, "pdb_files": [], "pdb_skipped": [],
                "report": {}}
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
    report = {}
    if not args.noplot:
        test_angles = test_split_angles(args.testcomparison, train_args) if args.testcomparison else None
        report = write_report(outdir / "plots", final, ft_names, pdb_files, test_angles, draw)
    logging.info("Sampling complete")
    return {"n_structures": len(final), "sampling_seconds": sampling_seconds, "pdb_files": pdb_files,
            "pdb_skipped": skipped, "report": report}


if __name__ == "__main__":
    from foldingdiff_tpu_torch.precision import set_process_default

    logging.basicConfig(level=logging.INFO)
    set_process_default()  # a "default" model's GEMMs in TF32, as XLA:GPU's
    main()
