#!/usr/bin/env python
"""
End to end without external data, on the PyTorch port (the port's copy of
examples/run_synthetic_e2e.py): write a dataset of segmental helix/sheet
proteins, train the diffusion model, sample new backbones and evaluate them
-- angle distributions (KS against training), secondary-structure content
(P-SEA) and clashes -- into <outdir>/report.json, with JAX's keys and its
KS gate.

Runs on the card (--device, default cuda; --device cpu with small
--epochs/--nprot for a quick check).

Usage: python examples/run_synthetic_e2e_torch.py -o /tmp/synth_e2e_torch --epochs 300
"""
import argparse
import json
import logging
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples.synthetic_proteins_torch import make_synthetic_protein_dir  # noqa: E402


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(usage=__doc__)
    parser.add_argument("-o", "--outdir", type=str, default="/tmp/synth_e2e_torch")
    parser.add_argument("--nprot", type=int, default=200)
    parser.add_argument("--epochs", type=int, default=300)
    parser.add_argument("--timesteps", type=int, default=100)
    parser.add_argument("--nsample", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    parser.add_argument("--no-gate", action="store_true", help="skip the KS statistical gate")
    parser.add_argument("--ks-threshold", type=float, default=0.15,
                        help="max allowed KS statistic between generated and training angle distributions "
                             "(the gate applies at >= 100 epochs)")
    args = parser.parse_args(argv)

    from foldingdiff_tpu_torch.data.datasets import AnglesOnlyDataset
    from foldingdiff_tpu_torch.devices import require_device
    from foldingdiff_tpu_torch.diffusion import sampling as samp
    from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from foldingdiff_tpu_torch.geometry.featurize import EXHAUSTIVE_ANGLES, create_new_chain_nerf
    from foldingdiff_tpu_torch.metrics.clashes import count_clashes
    from foldingdiff_tpu_torch.metrics.kl import ks_feature_tests
    from foldingdiff_tpu_torch.metrics.ss import count_structures_in_pdb
    from foldingdiff_tpu_torch.models import io as model_io
    from foldingdiff_tpu_torch.training.orchestration import train

    try:
        device = require_device(args.device, "--device")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    os.makedirs(args.outdir, exist_ok=True)
    pdb_dir = os.path.join(args.outdir, "train_pdbs")
    if not os.path.isdir(pdb_dir) or not os.listdir(pdb_dir):
        logging.info(f"Synthesizing {args.nprot} training proteins")
        make_synthetic_protein_dir(pdb_dir, n=args.nprot)

    results_dir = os.path.join(args.outdir, "results")
    train(
        results_dir=results_dir, dataset_key=pdb_dir, angles_definitions="canonical-full-angles", max_seq_len=96,
        min_seq_len=0, trim_strategy="leftalign", timesteps=args.timesteps, variance_schedule="cosine",
        num_hidden_layers=4, hidden_size=128, intermediate_size=256, num_heads=8,
        position_embedding_type="relative_key", batch_size=32, lr=3e-4, lr_scheduler=None,
        max_epochs=args.epochs, min_epochs=args.epochs, dryrun=True, device=str(device),
    )

    model, _ = model_io.from_dir(results_dir, device=device)
    sched = DiffusionSchedule.create("cosine", args.timesteps, device=device)
    mean_offset = np.load(os.path.join(results_dir, "training_mean_offset.npy"))
    sampled = samp.sample(model, sched, is_angular=[True] * 6, pad=96, n=None, sweep_lengths=None,
                          lengths=[64] * args.nsample, batch_size=args.nsample, mean_offset=mean_offset, seed=7)

    # KS of the sampled angle distributions against the training set's: the
    # statistic over all positions (an effect size: the gate) and a p-value
    # on a fixed 500-point subsample per side
    ds = AnglesOnlyDataset(pdbs=pdb_dir, pad=96, min_length=0, zero_center=False, cache_dir=args.outdir,
                           n_workers=1)
    train_rows = []
    for i in range(len(ds)):
        item = ds.__getitem__(i, ignore_zero_center=True)
        train_rows.append(item["angles"][: int(item["lengths"])])
    ks = ks_feature_tests(np.concatenate(sampled), np.concatenate(train_rows), EXHAUSTIVE_ANGLES)

    gen_dir = os.path.join(args.outdir, "generated_pdbs")
    os.makedirs(gen_dir, exist_ok=True)
    ss_counts, clash_counts = [], []
    for i, s in enumerate(sampled):
        out = create_new_chain_nerf(os.path.join(gen_dir, f"gen_{i}.pdb"), s, EXHAUSTIVE_ANGLES)
        if out:
            ss = count_structures_in_pdb(out)
            if ss != (-1, -1):  # annotation-failure sentinel
                ss_counts.append(ss)
            clash_counts.append(count_clashes(out))

    alpha = [a for a, _ in ss_counts]
    beta = [b for _, b in ss_counts]
    report = {
        "ks_tests": ks,
        "generated": len(ss_counts),
        "mean_alpha_elements": float(np.mean(alpha)),
        "mean_beta_elements": float(np.mean(beta)),
        "frac_with_helix": float(np.mean([a > 0 for a in alpha])),
        "mean_clashes": float(np.mean(clash_counts)),
    }
    # The gate: at a real training budget the sampled angle distributions
    # must match the training ones; skipped for smoke budgets
    gated = args.epochs >= 100 and not args.no_gate
    max_stat = max(v["stat"] for v in ks.values())
    report["ks_gate"] = {"applied": gated, "max_stat": float(max_stat), "stat_threshold": args.ks_threshold,
                         "pass": bool(max_stat < args.ks_threshold)}
    with open(os.path.join(args.outdir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    logging.info(json.dumps(report, indent=2))
    if gated and max_stat >= args.ks_threshold:
        logging.error(f"KS gate FAILED: max statistic {max_stat:.3f} >= {args.ks_threshold}")
        sys.exit(1)
    return report


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
