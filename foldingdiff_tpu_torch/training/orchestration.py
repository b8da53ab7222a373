"""
Training orchestration: config dict -> datasets -> trainer -> model directory
(counterpart of foldingdiff_tpu/training/orchestration.py; reference
bin/train.py:111-507). `train` takes the JAX package's config-JSON keys, so
the files under config_jsons/ drive it unchanged, plus `device` (the card
unless the caller asks for the CPU).

The debug noisers (`syn_noiser`, `single_angle_debug`,
`single_timestep_debug`; data/debug_noisers.py) train through the
pre-corrupted step, from batches noised on the host, as the JAX package
does. With `use_mesh` (the default, as in JAX) and a process group of more
than one rank up (parallel/multihost.py) whose size divides the batch size,
training is data-parallel over the ranks (JAX's orchestration.py:294-302);
every rank featurizes the same data and only rank 0 writes files (JAX's
:141-160). `ngpu` is accepted and unused, as in JAX's CLI: the ranks are
the devices. The KL and plot diagnostics are left out (matplotlib is not on
the card's machine), so `dryrun` changes nothing here.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from foldingdiff_tpu_torch.data import datasets as dsets
from foldingdiff_tpu_torch.data import debug_noisers as dn
from foldingdiff_tpu_torch.devices import require_device
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.models import io as model_io
from foldingdiff_tpu_torch.models.config import ModelConfig
from foldingdiff_tpu_torch.parallel.multihost import data_mesh, is_primary
from foldingdiff_tpu_torch.training.trainer import Trainer, TrainConfig, dropout_rng


def get_train_valid_test_sets(
    dataset_key: str = "cath",
    angles_definitions: str = "canonical-full-angles",
    max_seq_len: int = 512,
    min_seq_len: int = 0,
    seq_trim_strategy: str = "leftalign",
    toy: int = 0,
    n_workers: Optional[int] = None,
    zero_center: bool = True,
) -> Tuple:
    """(train, validation, test) datasets, the train split's mean offset
    shared to the other two (reference bin/train.py:111-163).
    zero_center=False skips the centring (cart-coords is never centred)."""
    clean_cls = dsets.DATASET_CLASSES[angles_definitions]
    clean = [
        clean_cls(
            pdbs=dataset_key, split=s, pad=max_seq_len, min_length=min_seq_len, trim_strategy=seq_trim_strategy,
            zero_center=zero_center and angles_definitions != "cart-coords", toy=toy, n_workers=n_workers,
        )
        for s in ("train", "validation", "test")
    ]
    if clean[0].means is not None:
        logging.info(f"Sharing train mean offset to valid/test: {clean[0].means}")
        for ds in clean[1:]:
            ds.means = clean[0].means
    return tuple(clean)


def record_args_and_metadata(func_args: Dict, results_folder: Path) -> None:
    """training_args.json and, in a git checkout, git_sha.txt (reference
    bin/train.py:255-284)."""
    os.makedirs(results_folder, exist_ok=True)
    with open(results_folder / "training_args.json", "w") as f:
        json.dump(func_args, f, indent=4, default=str)
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], cwd=os.path.dirname(os.path.abspath(__file__)),
                             capture_output=True, text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        sha = ""
    if sha:
        with open(results_folder / "git_sha.txt", "w") as f:
            f.write(sha + "\n")
    else:
        logging.warning("Could not record git SHA")


def train(
    results_dir: str = "./results",
    dataset_key: str = "cath",
    angles_definitions: str = "canonical-full-angles",
    max_seq_len: int = 512,
    min_seq_len: int = 0,
    trim_strategy: str = "leftalign",
    timesteps: int = 250,
    variance_schedule: str = "linear",
    variance_scale: float = 1.0,
    time_encoding: str = "gaussian_fourier",
    num_hidden_layers: int = 12,
    hidden_size: int = 384,
    intermediate_size: int = 768,
    num_heads: int = 12,
    position_embedding_type: str = "absolute",
    dropout_p: float = 0.1,
    decoder: str = "mlp",
    gradient_clip: float = 1.0,
    batch_size: int = 64,
    lr: float = 5e-5,
    loss: str = "smooth_l1",
    use_pdist_loss=0.0,
    l2_norm: float = 0.0,
    l1_norm: float = 0.0,
    circle_reg: float = 0.0,
    min_epochs: Optional[int] = None,
    max_epochs: int = 10000,
    early_stop_patience: int = 0,
    lr_scheduler: Optional[str] = None,
    use_swa: bool = False,
    fused_steps: int = 1,
    multithread: bool = True,
    subset=False,
    exhaustive_validation_t: bool = False,
    validation_t_points: int = 16,  # timestep grid size; <= 0 is every t in [0, T)
    syn_noiser: str = "",
    single_angle_debug: int = -1,
    single_timestep_debug: bool = False,
    cpu_only: bool = False,
    ngpu: int = -1,
    write_valid_preds: bool = False,
    dryrun: bool = False,
    seed: int = 42,
    zero_center: bool = True,
    use_mesh: bool = True,
    resume: bool = False,
    save_state_every: int = 25,
    device: str = "cuda",
) -> Tuple[Trainer, list]:
    """Train a model into results_dir (reference bin/train.py:287-507);
    returns (trainer, metrics rows). `device` is the card unless the caller
    asks for the CPU (or sets cpu_only); without a card it raises at once."""
    device = require_device("cpu" if cpu_only else device)
    func_args = dict(locals())
    func_args["device"] = str(device)
    results_folder = Path(results_dir)
    primary = is_primary()
    if primary:
        record_args_and_metadata(func_args, results_folder)

    t0 = time.time()
    train_ds, valid_ds, test_ds = get_train_valid_test_sets(
        dataset_key=dataset_key, angles_definitions=angles_definitions, max_seq_len=max_seq_len,
        min_seq_len=min_seq_len, seq_trim_strategy=trim_strategy, toy=subset, n_workers=None if multithread else 1,
        zero_center=zero_center,
    )
    logging.info(f"Featurization took {time.time() - t0:.1f}s")

    mean_offset = train_ds.get_masked_means()
    if primary:
        if mean_offset is not None:
            np.save(results_folder / "training_mean_offset.npy", mean_offset)
        for name, ds in zip(["train", "valid", "test"], [train_ds, valid_ds, test_ds]):
            with open(results_folder / f"{name}_files.txt", "w") as f:
                f.write("\n".join(ds.filenames))

    ft_key = "coords" if angles_definitions == "cart-coords" else "angles"
    debug_noiser = make_debug_noiser(train_ds, ft_key, syn_noiser, single_angle_debug, single_timestep_debug,
                                     timesteps, variance_schedule, seed)
    model_config = ModelConfig(
        hidden_size=hidden_size, num_hidden_layers=num_hidden_layers, num_attention_heads=num_heads,
        intermediate_size=intermediate_size, max_position_embeddings=max_seq_len,
        position_embedding_type=position_embedding_type, hidden_dropout_prob=dropout_p,
        attention_probs_dropout_prob=dropout_p, ft_is_angular=tuple(train_ds.feature_is_angular[ft_key]),
        ft_names=tuple(train_ds.feature_names[ft_key]), time_encoding=time_encoding, decoder=decoder,
    )
    if debug_noiser is not None:
        # The model's width follows the noiser's items (reference
        # bin/train.py:421-423): the first features' flags and names, as JAX
        # slices them, whichever column the noiser keeps
        n_in = debug_noiser[0]["corrupted"].shape[-1]
        model_config = dataclasses.replace(model_config, ft_is_angular=model_config.ft_is_angular[:n_in],
                                           ft_names=model_config.ft_names[:n_in])
    schedule = DiffusionSchedule.create(variance_schedule, timesteps, device=device)

    def as_train_arrays(ds):
        arrays = ds.to_arrays()
        # cart-coords items carry "coords"; the trainer's feature key is "angles"
        if "angles" not in arrays and "coords" in arrays:
            arrays["angles"] = arrays.pop("coords")
        return arrays

    train_data = as_train_arrays(train_ds)
    valid_data = as_train_arrays(valid_ds)
    steps_per_epoch = max(len(train_ds) // batch_size, 1)

    # randomcrop: a fresh pad-window of each structure longer than pad every
    # epoch (reference datasets.py:411-438); validation crops stay fixed
    train_data_refresh = None
    if trim_strategy == "randomcrop" and train_ds.over_pad_indices:
        logging.info(f"randomcrop: re-cropping {len(train_ds.over_pad_indices)} structures > pad={max_seq_len} "
                     "at every epoch")

        def train_data_refresh(epoch, _arrays=train_data, _ds=train_ds, _seed=seed):
            return _ds.refresh_crops_(_arrays, epoch_seed=_seed * 1_000_003 + epoch)

    tcfg = TrainConfig(
        lr=lr, loss=loss, l2_norm=l2_norm, l1_norm=l1_norm, circle_reg=circle_reg, gradient_clip=gradient_clip,
        batch_size=batch_size, min_epochs=min_epochs, max_epochs=max_epochs, lr_scheduler=lr_scheduler,
        early_stop_patience=early_stop_patience, use_pdist_loss=use_pdist_loss, angular_variance=variance_scale,
        use_swa=use_swa, seed=seed, fused_steps=fused_steps,
    )
    model = model_io.init_random(model_config, torch.Generator().manual_seed(seed)).to(device)
    mesh = data_mesh(batch_size) if use_mesh else None
    trainer = Trainer(model, schedule, tcfg, steps_per_epoch=steps_per_epoch, mesh=mesh)
    logging.info(f"Model has {sum(p.numel() for p in model.parameters())} trainable parameters")
    if debug_noiser is not None:
        return trainer, train_debug(trainer, debug_noiser, max_epochs, batch_size, seed)

    rows = trainer.fit(
        train_data, valid_data=valid_data, results_dir=str(results_folder), train_args=func_args,
        mean_offset=mean_offset, log_every=1, resume=resume, save_state_every=save_state_every,
        write_preds_to_dir=str(results_folder / "valid_preds") if write_valid_preds else None,
        exhaustive_t_validation=exhaustive_validation_t, exhaustive_t_points=validation_t_points,
        train_data_refresh=train_data_refresh,
    )
    return trainer, rows


def make_debug_noiser(train_ds, ft_key: str, syn_noiser: str, single_angle_debug: int,
                      single_timestep_debug: bool, timesteps: int, variance_schedule: str, seed: int):
    """The debug noiser that train()'s keys select over the train split, or
    None (reference bin/train.py:165-195)."""
    common = dict(dset_key=ft_key, timesteps=timesteps, beta_schedule=variance_schedule)
    if syn_noiser:
        if syn_noiser != "halfhalf":
            raise ValueError(f"Unknown synthetic noiser {syn_noiser}")
        return dn.SynNoisedByPositionDataset(train_ds, **common)
    if single_angle_debug > 0 and single_timestep_debug:
        return dn.SingleNoisedAngleAndTimeDataset(dset=train_ds, ft_idx=single_angle_debug, seed=seed, **common)
    if single_angle_debug > 0:
        return dn.SingleNoisedAngleDataset(dset=train_ds, ft_idx=single_angle_debug, seed=seed, **common)
    if single_timestep_debug:
        return dn.SingleNoisedAngleAndTimeDataset(dset=train_ds, seed=seed, **common)
    return None


def train_debug(trainer: Trainer, noiser, max_epochs: int, batch_size: int, seed: int) -> List[Dict[str, float]]:
    """Train from a debug noiser's items (reference bin/train.py:425-430):
    each epoch in np.random.default_rng(seed + epoch) order, full batches
    only, one pre-corrupted step each. Returns one {"epoch", "train_loss"}
    row per epoch; the loss is NaN for an epoch without a full batch."""
    logging.warning(f"Training from debug noiser {type(noiser).__name__}")
    keys = ("corrupted", "t", "known_noise", "attn_mask")
    rows = []
    with dropout_rng(trainer.device, trainer.cfg.seed, trainer.mesh):
        for epoch in range(max_epochs):
            order = np.random.default_rng(seed + epoch).permutation(len(noiser))
            losses = []
            for start in range(0, len(order) - batch_size + 1, batch_size):
                items = [noiser[int(i)] for i in order[start : start + batch_size]]
                batch = {k: np.stack([it[k] for it in items]) for k in keys}
                avg, _ = trainer.train_step_precorrupted(trainer.to_device(batch, keys))
                losses.append(avg)
            loss = float(torch.stack(losses).mean().cpu()) if losses else float("nan")
            rows.append({"epoch": epoch, "train_loss": loss})
            logging.info(f"debug epoch {epoch}: {loss:.4f}")
    return rows
