#!/usr/bin/env python
"""
Sample from the autoregressive baseline with the PyTorch port
(foldingdiff_tpu_torch), seeded with the first angles of real structures
(counterpart of bin/sample_autoregressive.py; reference
bin/sample_autoregressive.py).

Takes bin/sample_autoregressive.py's -m --data -n --numseed -o --seed --cpu
flags, plus --device (default cuda; with no CUDA device it exits at once;
--cpu is --device cpu). The seeds are the first --numseed angle sets of
structures drawn from the test split of --data, centred by the model's
training mean offset; the lengths are drawn from that split
(AngleDataset.sample_length). Greedy generation (models/ar.ar_sample) runs
one forward per residue on the device. Outputs:
  sampled_angles/ar_generated_i.csv.gz   angles, offset added back, wrapped
  sampled_pdb/ar_generated_i.pdb         NeRF-reconstructed backbones

Usage: python bin/sample_autoregressive_torch.py -m ar_results --data <pdb_dir> -n 32 -o ar_sampled
"""
import argparse
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-m", "--model", type=str, required=True)
    parser.add_argument("--data", type=str, required=True, help="PDB dir for seed angles")
    parser.add_argument("-n", "--num", type=int, default=32)
    parser.add_argument("--numseed", type=int, default=4)
    parser.add_argument("-o", "--outdir", type=str, default="ar_sampled")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    parser.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return parser


def sample_initial_angles(ds, n: int, num_seed: int, rng):
    """The first num_seed angle sets of n structures drawn from ds
    (reference bin/sample_autoregressive.py:20-52)."""
    import numpy as np

    idx = rng.choice(len(ds), size=n, replace=len(ds) < n)
    return np.stack([ds[int(i)]["angles"][:num_seed] for i in idx])


def main(argv=None) -> dict:
    """Run the CLI; returns {"angles": one (length, F) array per sample,
    "lengths", "generation_seconds", "pdb_files"}."""
    args = build_parser().parse_args(argv)
    from foldingdiff_tpu_torch.devices import require_device

    try:
        device = require_device("cpu" if args.cpu else args.device, "--device")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None

    import numpy as np
    import torch

    from foldingdiff_tpu_torch.data import datasets as dsets
    from foldingdiff_tpu_torch.geometry.featurize import create_new_chain_nerf
    from foldingdiff_tpu_torch.models import io as model_io
    from foldingdiff_tpu_torch.models.ar import BertForAutoregressive, ar_sample
    from foldingdiff_tpu_torch.utils import modulo_with_wrapped_range, write_angles_csv

    model, train_args = model_io.from_dir(args.model, device=device, model_cls=BertForAutoregressive)
    ds = dsets.DATASET_CLASSES[train_args["angles_definitions"]](
        pdbs=args.data, split="test", pad=train_args["max_seq_len"],
        min_length=train_args.get("min_seq_len", 0), trim_strategy=train_args.get("trim_strategy", "leftalign"),
    )
    # Seeds are centred by the TRAINING mean offset (the space the model was
    # trained in), not this split's own; the outputs are shifted back by it
    offset_file = os.path.join(args.model, "training_mean_offset.npy")
    mean_offset = np.load(offset_file) if os.path.isfile(offset_file) else None
    if mean_offset is not None:
        ds.set_masked_means(mean_offset)
    rng = np.random.default_rng(args.seed)
    pad, num_seed = train_args["max_seq_len"], args.numseed

    seeds = sample_initial_angles(ds, args.num, num_seed, rng)
    seed_angles = np.zeros((args.num, pad, seeds.shape[-1]), dtype=np.float32)
    seed_angles[:, :num_seed] = seeds
    lengths = np.asarray(ds.sample_length(args.num) if args.num > 1 else [ds.sample_length()])

    start = time.perf_counter()
    out = ar_sample(model, torch.from_numpy(seed_angles).to(device), torch.from_numpy(lengths).to(device),
                    num_seed=num_seed).cpu().numpy()
    generation_seconds = time.perf_counter() - start
    logging.info(f"Generated {args.num} AR samples in {generation_seconds:.2f} s")

    angles_dir = os.path.join(args.outdir, "sampled_angles")
    pdb_dir = os.path.join(args.outdir, "sampled_pdb")
    os.makedirs(angles_dir, exist_ok=True)
    os.makedirs(pdb_dir, exist_ok=True)
    ft_names = list(ds.feature_names["angles"])
    samples, pdb_files = [], []
    for i, length in enumerate(lengths):
        angles = out[i, : int(length)]
        if mean_offset is not None:
            angles = angles + np.asarray(mean_offset)
        angles = modulo_with_wrapped_range(angles)
        samples.append(angles)
        write_angles_csv(angles, ft_names, os.path.join(angles_dir, f"ar_generated_{i}.csv.gz"))
        written = create_new_chain_nerf(os.path.join(pdb_dir, f"ar_generated_{i}.pdb"), angles, ft_names)
        if written:
            pdb_files.append(written)
    logging.info(f"Wrote {len(lengths)} AR samples to {args.outdir}")
    return {"angles": samples, "lengths": lengths.tolist(), "generation_seconds": generation_seconds,
            "pdb_files": pdb_files}


if __name__ == "__main__":
    from foldingdiff_tpu_torch.precision import set_process_default

    logging.basicConfig(level=logging.INFO)
    set_process_default()  # a "default" model's GEMMs in TF32, as XLA:GPU's
    main()
