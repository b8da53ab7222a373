"""
Figures on the host (counterpart of foldingdiff_tpu/metrics/plotting.py;
reference foldingdiff/plotting.py and the plot helpers of bin/train.py and
bin/sample.py): loss curves, Ramachandran densities, distribution overlaps,
per-timestep distributions, secondary-structure co-occurrence, KL over
timesteps and consecutive-residue heatmaps.

matplotlib is optional (the card's machine has none): it is imported inside
each function, never when this module is imported. A caller that writes
numbers and figures writes the numbers first and asks `figures_available`
once, before any long work, which logs one warning naming the missing
package and each figure it will not draw; `require_packages` is for callers
whose only output is a figure.
"""
from __future__ import annotations

import csv
import importlib.util
import json
import logging
import os
from typing import Sequence

import numpy as np


def _missing(packages: Sequence[str]) -> list:
    missing = []
    for name in packages:
        try:
            found = importlib.util.find_spec(name) is not None
        except (ImportError, ValueError):
            found = False
        if not found:
            missing.append(name)
    return missing


def figures_available(figures: Sequence[str]) -> bool:
    """True when matplotlib is importable; else one WARNING naming it and
    each figure that will not be drawn, and False. The numbers are written
    either way."""
    if _missing(("matplotlib",)):
        logging.warning(f"matplotlib not installed: not drawing {', '.join(figures)}; every number is still written")
        return False
    return True


def require_packages(packages: Sequence[str], what: str) -> None:
    """SystemExit naming the missing packages, for a command whose only
    output needs them."""
    missing = _missing(packages)
    if missing:
        raise SystemExit(f"{what} needs {', '.join(missing)}, which is not installed")


def pyplot():
    """matplotlib.pyplot on the Agg backend, imported on first use."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


def _read_metrics_csv(metrics_csv: str) -> dict:
    """{column: float array} of the trainer's metrics.csv; empty cells NaN."""
    with open(metrics_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    columns = rows[0].keys() if rows else []
    return {c: np.array([float(r[c]) if r[c] not in ("", None) else np.nan for r in rows]) for c in columns}


def plot_losses(metrics_csv: str, out_fname: str, simple: bool = True) -> str:
    """Train and validation loss curves from the trainer's metrics.csv
    (reference plotting.plot_losses, plotting.py:93-143)."""
    plt = pyplot()
    cols = _read_metrics_csv(metrics_csv)
    fig, ax = plt.subplots(dpi=300)
    if "train_loss" in cols:
        ax.plot(cols["epoch"], cols["train_loss"], label="train loss")
    if "val_loss" in cols and not np.isnan(cols["val_loss"]).all():
        ax.plot(cols["epoch"], cols["val_loss"], label="valid loss")
    if not simple:
        for col in cols:
            if col.startswith("train_loss_"):
                ax.plot(cols["epoch"], cols[col], alpha=0.4, label=col)
    ax.legend()
    ax.set(xlabel="Epoch", ylabel="Loss", title="Training loss")
    fig.savefig(out_fname, bbox_inches="tight")
    plt.close(fig)
    return out_fname


def plot_ramachandran(phi: np.ndarray, psi: np.ndarray, out_fname: str, annot_ss: bool = False,
                      title: str = "Ramachandran plot") -> str:
    """2D density of (phi, psi) (reference bin/sample.py:131-197)."""
    plt = pyplot()
    fig, ax = plt.subplots(dpi=300, figsize=(6, 6))
    h = ax.hist2d(phi, psi, bins=72, range=[[-np.pi, np.pi], [-np.pi, np.pi]], cmap="viridis")
    fig.colorbar(h[3], ax=ax, label="count")
    if annot_ss:
        ax.annotate(r"$\alpha$ helix", xy=(-1.2, -0.8), color="white", fontsize=12)
        ax.annotate(r"$\beta$ sheet", xy=(-2.0, 2.2), color="white", fontsize=12)
    ax.set(xlabel=r"$\phi$ (radians)", ylabel=r"$\psi$ (radians)", title=title)
    fig.savefig(out_fname, bbox_inches="tight")
    plt.close(fig)
    return out_fname


def plot_distribution_overlap(values_dicts: dict, out_fname: str, feature_names: Sequence[str],
                              cumulative: bool = False, title: str = "Distribution comparison") -> str:
    """Overlaid histograms (or CDFs) per feature of {label: (N, F) array}
    (reference bin/sample.py:200-234)."""
    plt = pyplot()
    n_ft = len(feature_names)
    fig, axes = plt.subplots(dpi=300, ncols=n_ft, figsize=(3.2 * n_ft, 2.8), sharey=cumulative)
    if n_ft == 1:
        axes = [axes]
    for i, (name, ax) in enumerate(zip(feature_names, axes)):
        for label, vals in values_dicts.items():
            v = np.asarray(vals)[..., i].ravel()
            v = v[np.isfinite(v)]
            ax.hist(v, bins=60, density=True, histtype="step", cumulative=cumulative, label=label)
        ax.set(title=name)
        if i == 0:
            ax.legend(fontsize=7)
    fig.suptitle(title, y=1.05)
    fig.savefig(out_fname, bbox_inches="tight")
    plt.close(fig)
    return out_fname


def plot_val_dists_at_t(values: np.ndarray, noise: np.ndarray, t: int, feature_names: Sequence[str],
                        out_fname: str) -> str:
    """Noised data against pure noise at one timestep (reference
    plotting.plot_val_dists_at_t, plotting.py:47-90)."""
    return plot_distribution_overlap({"noised data": values, "pure noise": noise}, out_fname, feature_names,
                                     title=f"Distributions at t={t}")


def plot_timestep_distributions(noised_dset, timesteps: int, plots_folder: str, n_intervals: int = 11,
                                max_items: int = 256, shift_angles_zero_twopi: bool = False) -> list:
    """
    Histograms per feature of the CORRUPTED values at n_intervals timesteps
    over [0, T - 1], one train_dists_at_t_<t>.pdf each: the forward process
    reaching the wrapped noise prior (reference bin/train.py:52-80).
    `noised_dset` is a data.datasets.NoisedAnglesDataset.
    """
    plt = pyplot()
    ft_key = getattr(noised_dset, "dset_key", "angles")
    feature_names = list(noised_dset.feature_names[ft_key])
    select_ts = np.unique(np.linspace(0, timesteps - 1, n_intervals).astype(int))
    n = min(len(noised_dset), max_items)
    outs = []
    for t in select_ts:
        vals = []
        for i in range(n):
            item = noised_dset.__getitem__(i, use_t_val=int(t))
            mask = np.asarray(item["attn_mask"]).astype(bool)
            vals.append(np.asarray(item["corrupted"])[mask])
        vals = np.concatenate(vals)
        if shift_angles_zero_twopi:
            vals = np.where(vals < 0, vals + 2 * np.pi, vals)
        fig, axes = plt.subplots(dpi=150, figsize=(len(feature_names) * 2.6, 2.5), ncols=len(feature_names),
                                 sharey=True)
        if len(feature_names) == 1:
            axes = [axes]
        for i, (name, ax) in enumerate(zip(feature_names, axes)):
            ax.hist(vals[:, i], bins=60, density=True, alpha=0.8, histtype="stepfilled")
            ax.set(title=name)
        fig.suptitle(f"Corrupted training distributions at t={t}", y=1.05)
        out = os.path.join(str(plots_folder), f"train_dists_at_t_{t}.pdf")
        fig.savefig(out, bbox_inches="tight")
        plt.close(fig)
        outs.append(out)
    return outs


def write_ss_counts(alpha_counts: Sequence[int], beta_counts: Sequence[int], json_file: str) -> str:
    """{"alpha": [...], "beta": [...]} element counts per structure, the
    JSON that plot_ss_cooccurrence writes beside its figure."""
    with open(json_file, "w") as f:
        json.dump({"alpha": np.asarray(alpha_counts).tolist(), "beta": np.asarray(beta_counts).tolist()}, f)
    return json_file


def plot_ss_cooccurrence(alpha_counts: Sequence[int], beta_counts: Sequence[int], out_fname: str,
                         json_file: str = "", title: str = "Secondary structure co-occurrence", **kwargs) -> str:
    """2D histogram of (# alpha, # beta) elements per structure, and the
    counts' JSON when json_file is given, written first (reference
    bin/annot_secondary_structures.py:108-166)."""
    alpha_counts = np.asarray(alpha_counts)
    beta_counts = np.asarray(beta_counts)
    if json_file:
        write_ss_counts(alpha_counts, beta_counts, json_file)
    plt = pyplot()
    fig, ax = plt.subplots(dpi=300)
    bins = [np.arange(-0.5, max(alpha_counts.max(), 1) + 1.5), np.arange(-0.5, max(beta_counts.max(), 1) + 1.5)]
    h = ax.hist2d(alpha_counts, beta_counts, bins=bins, cmap="Blues", **kwargs)
    fig.colorbar(h[3], ax=ax, label="count")
    ax.set(xlabel=r"# $\alpha$ helices", ylabel=r"# $\beta$ strands", title=title)
    fig.savefig(out_fname, bbox_inches="tight")
    plt.close(fig)
    return out_fname


def plot_kl_divergence(kl_values: np.ndarray, feature_names: Sequence[str], out_fname: str) -> str:
    """KL(noised || noise) per feature over timesteps (bin/train.py:82-108)."""
    plt = pyplot()
    n_timesteps, n_features = kl_values.shape
    fig, axes = plt.subplots(dpi=300, figsize=(n_features * 3.05, 2.5), ncols=n_features, sharey=True)
    if n_features == 1:
        axes = [axes]
    for i, (ft_name, ax) in enumerate(zip(feature_names, axes)):
        ax.plot(np.arange(n_timesteps), kl_values[:, i], label=ft_name)
        ax.axhline(0, color="grey", linestyle="--", alpha=0.5)
        ax.set(title=ft_name, xlabel="Timestep")
        if i == 0:
            ax.set(ylabel="KL divergence")
    fig.suptitle(f"KL(empirical || Gaussian) over timesteps={n_timesteps}", y=1.05)
    fig.savefig(out_fname, bbox_inches="tight")
    plt.close(fig)
    return out_fname


def plot_consecutive_heatmap(values: np.ndarray, out_fname: str,
                             title: str = "Consecutive-residue correlation") -> str:
    """Heatmap of the (x_i, x_{i+1}) pairs (reference plotting.py:146-182)."""
    plt = pyplot()
    values = np.asarray(values)
    pairs_x, pairs_y = values[:-1].ravel(), values[1:].ravel()
    ok = np.isfinite(pairs_x) & np.isfinite(pairs_y)
    fig, ax = plt.subplots(dpi=300, figsize=(5, 5))
    h = ax.hist2d(pairs_x[ok], pairs_y[ok], bins=60, cmap="viridis")
    fig.colorbar(h[3], ax=ax)
    ax.set(xlabel="$x_i$", ylabel="$x_{i+1}$", title=title)
    fig.savefig(out_fname, bbox_inches="tight")
    plt.close(fig)
    return out_fname
