#!/usr/bin/env python
"""
Train the autoregressive baseline with the PyTorch port (foldingdiff_tpu_torch):
causal next-angle-set prediction with the denoiser's encoder body
(counterpart of bin/train_autoregressive.py; reference
bin/train_autoregressive.py).

Takes bin/train_autoregressive.py's config -o --dataset --toy --epochs --cpu
flags, merged over the config JSON (files under config_jsons/ work
unchanged; without one the model is 12 x 384 with `absolute` positions),
plus --device (default cuda; with no CUDA device it exits at once; --cpu is
--device cpu) and bin/train.py's --multihost --coordinator --nprocs --procid
(as bin/train_torch.py takes them: data-parallel over the ranks of a
torch.distributed process group, rank 0 writing). Writes training_args.json (with `seq_len_encoding` and the
model's body, so that either package's from_dir loads the directory),
config.json, training_mean_offset.npy, logs/metrics.csv and the top 5
checkpoints by validation loss under models/best_by_valid/, which
bin/sample_autoregressive_torch.py loads.

Usage: python bin/train_autoregressive_torch.py config_jsons/cath_full_angles_cosine.json -o ar_results
"""
import argparse
import json
import logging
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("config", nargs="?", default="", type=str, help="config json")
    parser.add_argument("-o", "--outdir", default="./ar_results", type=str)
    parser.add_argument("--dataset", default=None, type=str, help="dataset key or PDB dir")
    parser.add_argument("--toy", default=None, type=int, help="subset to n structures")
    parser.add_argument("--epochs", default=None, type=int)
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    parser.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    from foldingdiff_tpu_torch.parallel.multihost import add_cli_args

    add_cli_args(parser)
    return parser


def model_config_from(config: dict, ft_is_angular, ft_names):
    """The AR model's config from the config dict, with
    bin/train_autoregressive.py's defaults (12 x 384, `absolute`)."""
    from foldingdiff_tpu_torch.models.config import ModelConfig

    return ModelConfig(
        hidden_size=config.get("hidden_size", 384),
        num_hidden_layers=config.get("num_hidden_layers", 12),
        num_attention_heads=config.get("num_heads", 12),
        intermediate_size=config.get("intermediate_size", 768),
        max_position_embeddings=config.get("max_seq_len", 128),
        position_embedding_type=config.get("position_embedding_type", "absolute"),
        hidden_dropout_prob=config.get("dropout_p", 0.1),
        attention_probs_dropout_prob=config.get("dropout_p", 0.1),
        ft_is_angular=tuple(ft_is_angular),
        ft_names=tuple(ft_names),
        time_encoding=config.get("time_encoding", "gaussian_fourier"),
        decoder=config.get("decoder", "mlp"),
    )


def train_args_for(config: dict, model_config) -> dict:
    """training_args.json of an AR directory: the config with the length
    encoding under `seq_len_encoding` (reference modelling.py:324-327) and
    the model's body filled in where the config names none."""
    train_args = dict(config)
    train_args.setdefault("angles_definitions", "canonical-full-angles")
    train_args["seq_len_encoding"] = train_args.pop("time_encoding", model_config.time_encoding)
    for key, value in (("num_heads", model_config.num_attention_heads), ("hidden_size", model_config.hidden_size),
                       ("num_hidden_layers", model_config.num_hidden_layers),
                       ("intermediate_size", model_config.intermediate_size),
                       ("max_seq_len", model_config.max_position_embeddings),
                       ("position_embedding_type", model_config.position_embedding_type),
                       ("dropout_p", model_config.hidden_dropout_prob), ("decoder", model_config.decoder)):
        train_args.setdefault(key, value)
    return train_args


def main(argv=None) -> list:
    """Run the CLI; returns the metrics rows, one per epoch."""
    args = build_parser().parse_args(argv)
    from foldingdiff_tpu_torch.devices import require_device

    try:
        device = require_device("cpu" if args.cpu else args.device, "--device")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    from foldingdiff_tpu_torch.parallel import multihost

    if args.multihost:
        device = multihost.initialize(args.coordinator, args.nprocs, args.procid, device=device.type)
    try:
        return train(args, device)
    finally:
        if args.multihost:
            multihost.shutdown()


def train(args, device) -> list:
    """Featurize, build the model and fit it; returns the metrics rows."""
    import numpy as np
    import torch

    from foldingdiff_tpu_torch.models import io as model_io
    from foldingdiff_tpu_torch.models.ar import BertForAutoregressive
    from foldingdiff_tpu_torch.parallel import multihost
    from foldingdiff_tpu_torch.training.ar_trainer import ARTrainer
    from foldingdiff_tpu_torch.training.orchestration import get_train_valid_test_sets, record_args_and_metadata
    from foldingdiff_tpu_torch.training.trainer import TrainConfig
    from foldingdiff_tpu_torch.utils import update_dict_nonnull

    config = {}
    if args.config:
        with open(args.config) as f:
            config = json.load(f)
    config = update_dict_nonnull(config, {k: v for k, v in {
        "dataset_key": args.dataset, "max_epochs": args.epochs, "subset": args.toy,
    }.items() if v is not None})

    results = Path(args.outdir)
    primary = multihost.is_primary()
    if primary:
        record_args_and_metadata(dict(config), results)
    train_ds, valid_ds, _ = get_train_valid_test_sets(
        dataset_key=config.get("dataset_key", "cath"),
        angles_definitions=config.get("angles_definitions", "canonical-full-angles"),
        max_seq_len=config.get("max_seq_len", 128),
        min_seq_len=config.get("min_seq_len", 40),
        seq_trim_strategy=config.get("trim_strategy", "leftalign"),
        toy=config.get("subset") or 0,
    )
    mean_offset = train_ds.get_masked_means()
    if primary and mean_offset is not None:
        np.save(results / "training_mean_offset.npy", mean_offset)

    model_config = model_config_from(config, train_ds.feature_is_angular["angles"], train_ds.feature_names["angles"])
    tcfg = TrainConfig(
        lr=config.get("lr", 5e-5),
        batch_size=config.get("batch_size", 64),
        max_epochs=config.get("max_epochs", 100),
        lr_scheduler=config.get("lr_scheduler"),
        l2_norm=config.get("l2_norm", 0.0),
        gradient_clip=config.get("gradient_clip", 1.0),
    )
    train_data = train_ds.to_arrays()
    valid_data = valid_ds.to_arrays() if valid_ds is not None else None
    # randomcrop: a fresh pad-window of each structure longer than pad every
    # epoch, as in the diffusion orchestration
    train_data_refresh = None
    if config.get("trim_strategy") == "randomcrop" and train_ds.over_pad_indices:
        seed0 = int(config.get("seed", 42))

        def train_data_refresh(epoch, _arrays=train_data, _ds=train_ds, _seed=seed0):
            return _ds.refresh_crops_(_arrays, epoch_seed=_seed * 1_000_003 + epoch)

    model = model_io.init_random(model_config, torch.Generator().manual_seed(0),
                                 model_cls=BertForAutoregressive).to(device)
    trainer = ARTrainer(model, tcfg, steps_per_epoch=max(len(train_ds) // tcfg.batch_size, 1),
                        mesh=multihost.data_mesh(tcfg.batch_size))
    rows = trainer.fit(
        train_data, valid_data=valid_data, results_dir=str(results),
        train_args=train_args_for(config, model_config), mean_offset=mean_offset, log_every=1,
        train_data_refresh=train_data_refresh,
    )
    logging.info(f"AR training done: final train loss {rows[-1]['train_loss']:.4f}")
    return rows


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
