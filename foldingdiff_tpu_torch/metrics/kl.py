"""
Distribution statistics of angle sets, on the host (counterpart of
foldingdiff_tpu/metrics/kl.py; reference foldingdiff/custom_metrics.py:15-82):
- `kl_from_empirical`: KL(u || v) of two samples over shared-bin histograms;
- `kl_from_dset`: per timestep and feature, the KL of a noised dataset's
  values against pure wrapped noise, one vectorised numpy pass per timestep;
- `ks_feature_tests`: per-feature two-sample Kolmogorov-Smirnov tests of
  generated against reference angles, the statistic by which the paper's
  baselines are compared (analysis/README.md:271-277).
numpy and scipy only.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
from scipy import stats

from foldingdiff_tpu_torch.utils import modulo_with_wrapped_range


def kl_from_empirical(u: np.ndarray, v: np.ndarray, nbins: int = 100, pseudocount: bool = False) -> float:
    """KL(u || v) between two empirical samples via shared-bin histograms
    (reference custom_metrics.py:15-37)."""
    min_val = min(np.min(u), np.min(v))
    max_val = max(np.max(u), np.max(v))
    bins = np.linspace(min_val, max_val, nbins + 1)
    if pseudocount:
        u = np.concatenate((u, bins))
        v = np.concatenate((v, bins))
    u_hist, _ = np.histogram(u, bins=bins, density=True)
    v_hist, _ = np.histogram(v, bins=bins, density=True)
    return float(stats.entropy(u_hist, v_hist))


def kl_at_timestep(
    t: int,
    values: np.ndarray,
    sqrt_alphas_cumprod: np.ndarray,
    sqrt_one_minus_alphas_cumprod: np.ndarray,
    is_angular: np.ndarray,
    rng: np.random.Generator,
    angular_scale: float = 1.0,
) -> np.ndarray:
    """KL per feature between q(x_t|x_0)-noised values and pure wrapped noise.

    values: (N, F) unmasked feature rows pooled over the dataset."""
    noise = rng.standard_normal(values.shape)
    noise[:, is_angular] = modulo_with_wrapped_range(noise[:, is_angular] * angular_scale)
    noised = sqrt_alphas_cumprod[t] * values + sqrt_one_minus_alphas_cumprod[t] * noise
    noised[:, is_angular] = modulo_with_wrapped_range(noised[:, is_angular])
    ref_noise = rng.standard_normal(values.shape)
    ref_noise[:, is_angular] = modulo_with_wrapped_range(ref_noise[:, is_angular] * angular_scale)
    return np.array([kl_from_empirical(noised[:, i], ref_noise[:, i]) for i in range(values.shape[1])])


def kl_from_dset(dset, seed: int = 0, max_rows: Optional[int] = 200_000) -> np.ndarray:
    """
    (timesteps, n_features) KL divergence array (reference kl_from_dset,
    custom_metrics.py:66-82). dset is a data.datasets.NoisedAnglesDataset.
    """
    key = dset.dset_key if hasattr(dset, "dset_key") else "angles"
    rows = []
    for i in range(len(dset.dset)):
        item = dset.dset[i]
        rows.append(item[key][item["attn_mask"] > 0])
    values = np.concatenate(rows)
    if max_rows is not None and len(values) > max_rows:
        sel = np.random.default_rng(seed).choice(len(values), size=max_rows, replace=False)
        values = values[sel]
    is_angular = np.asarray(dset.feature_is_angular[key], dtype=bool)
    rng = np.random.default_rng(seed)
    logging.info(f"Computing KL for {dset.timesteps} timesteps over {len(values)} rows")
    return np.array([
        kl_at_timestep(
            t, values, dset.alpha_beta_terms["sqrt_alphas_cumprod"],
            dset.alpha_beta_terms["sqrt_one_minus_alphas_cumprod"], is_angular, rng,
            angular_scale=dset.angular_var_scale,
        )
        for t in range(dset.timesteps)
    ])


def ks_feature_tests(
    gen: np.ndarray,
    ref: np.ndarray,
    feature_names,
    subsample: int = 500,
    seed: int = 0,
    alpha: float = 0.01,
) -> dict:
    """
    Per-feature two-sample KS of generated against reference values.

    gen/ref: (N, F) arrays (rows pooled over structures and positions). For
    each feature: the full-sample statistic and p-value, and a p-value on a
    fixed-size subsample per side, the decision gate (at full N the test
    rejects trivially small differences). One generator draws the
    subsamples in feature order, so a seed reproduces them.
    """
    rng = np.random.default_rng(seed)
    out = {}
    for i, name in enumerate(feature_names):
        stat, p = stats.ks_2samp(gen[:, i], ref[:, i])
        sub_g = rng.choice(gen[:, i], size=min(subsample, len(gen)), replace=False)
        sub_r = rng.choice(ref[:, i], size=min(subsample, len(ref)), replace=False)
        _, p_sub = stats.ks_2samp(sub_g, sub_r)
        out[name] = {
            "stat": float(stat),
            "p": float(p),
            "p_subsampled": float(p_sub),
            "alpha": float(alpha),
            "reject_subsampled": bool(p_sub < alpha),
        }
    return out
