"""
Synthetic / debugging noiser datasets (the port's copy of
foldingdiff_tpu/data/debug_noisers.py; reference foldingdiff/datasets.py:
889-1197): overfit harnesses that training.orchestration.train reaches from
its `syn_noiser`, `single_angle_debug` and `single_timestep_debug` keys
(bin/train_torch.py --debug_single_time). Numpy only: every class draws from
its own np.random.default_rng(seed), in the JAX package's order, so for the
same seed over the same clean dataset its items equal the JAX package's
exactly.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from foldingdiff_tpu_torch.data.datasets import NoisedAnglesDataset
from foldingdiff_tpu_torch.diffusion.schedules import compute_alphas, get_variance_schedule


def _check_disjoint(item: Dict, retval: Dict) -> None:
    if not set(item.keys()).isdisjoint(retval.keys()):
        raise ValueError(f"clean item already has keys {set(item) & set(retval)}")


class SingleNoisedAngleDataset(NoisedAnglesDataset):
    """Noise and return only one feature column (reference datasets.py:889-931)."""

    def __init__(self, use_fixed_noise: bool = False, ft_idx: int = 1, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.selected_index = ft_idx
        self.fixed_noise = None
        if use_fixed_noise:
            logging.warning("Using fixed noise!")
            rng = np.random.default_rng(0)
            self.fixed_noise = (
                rng.standard_normal((512, 4)).astype(np.float32)
                * np.array([1.0, np.pi, np.pi, np.pi], dtype=np.float32)
            )

    def sample_noise(self, vals):
        if self.fixed_noise is not None:
            return self.fixed_noise[: vals.shape[0], : vals.shape[1]]
        return super().sample_noise(vals)

    def __getitem__(self, index: int, use_t_val: Optional[int] = None, **kwargs) -> Dict:
        vals = super().__getitem__(index, use_t_val=use_t_val, **kwargs)
        for k in ["angles", "corrupted", "known_noise"]:
            vals[k] = vals[k][:, self.selected_index : self.selected_index + 1]
        return vals


class SingleNoisedBondDistanceDataset(SingleNoisedAngleDataset):
    """Bond-distance-only variant (reference datasets.py:934-942)."""

    def __init__(self, use_fixed_noise: bool = False, *args, **kwargs):
        super().__init__(use_fixed_noise, ft_idx=0, *args, **kwargs)


class SingleNoisedAngleAndTimeDataset(SingleNoisedAngleDataset):
    """Single angle at a single fixed timestep -- extreme overfit harness
    (reference datasets.py:945-961)."""

    selected_timestep = 100

    def __getitem__(self, index: int, use_t_val: Optional[int] = None, **kwargs) -> Dict:
        if use_t_val is not None:
            raise ValueError("Cannot use specific t for fixed-timestep sampler")
        return super().__getitem__(index, use_t_val=self.selected_timestep, **kwargs)


class SynNoisedByPositionDataset:
    """
    Positive noise on the front half of the sequence, negative on the back --
    a model must use positional information to denoise it
    (reference datasets.py:964-1093). NOT FOR TRAINING real models.
    """

    def __init__(
        self,
        dset,
        dset_key: str = "angles",
        var_val: float = 1.0,
        timesteps: int = 250,
        use_timesteps: bool = False,
        beta_schedule: str = "linear",
        ft_subset: Optional[int] = 1,
        seed: int = 0,
        **kwargs,
    ):
        self.dset = dset
        self.dset_key = dset_key
        self.ft_subset = ft_subset
        self.timesteps = timesteps
        self.schedule = beta_schedule
        betas = get_variance_schedule(beta_schedule, timesteps)
        self.alpha_beta_terms = compute_alphas(betas)
        self.use_timesteps = use_timesteps
        self.var_val = var_val
        self._rng = np.random.default_rng(seed)
        logging.warning(f"Ignoring noiser class kwargs: {kwargs}")

    @property
    def feature_names(self):
        return self.dset.feature_names

    @property
    def feature_is_angular(self):
        return self.dset.feature_is_angular

    @property
    def pad(self):
        return self.dset.pad

    def __len__(self):
        return len(self.dset)

    def _trunc_normal(self, shape, low, high):
        out = np.empty(shape, dtype=np.float32).reshape(-1)
        filled = 0
        while filled < out.size:
            draw = self._rng.normal(0.0, self.var_val, size=out.size * 2)
            draw = draw[(draw >= low) & (draw <= high)]
            take = min(len(draw), out.size - filled)
            out[filled : filled + take] = draw[:take]
            filled += take
        return out.reshape(shape)

    def sample_noise(self, vals: np.ndarray, attn_mask: np.ndarray) -> np.ndarray:
        seq_len = float(np.sum(attn_mask))
        pos = self._trunc_normal(vals.shape, 0.0, np.pi)
        neg = self._trunc_normal(vals.shape, -np.pi, 0.0)
        idx = np.broadcast_to(np.arange(vals.shape[0])[:, None], vals.shape)
        return np.where(idx < seq_len / 2, pos, neg).astype(np.float32)

    def __getitem__(self, index: int) -> Dict:
        item = self.dset[index]
        vals = item[self.dset_key]
        if self.ft_subset is not None:
            vals = vals[:, self.ft_subset : self.ft_subset + 1]
            item[self.dset_key] = vals
        t = int(self._rng.integers(0, self.timesteps))
        noise = self.sample_noise(vals, item["attn_mask"])
        if self.use_timesteps:
            sac = np.float32(self.alpha_beta_terms["sqrt_alphas_cumprod"][t])
            somac = np.float32(self.alpha_beta_terms["sqrt_one_minus_alphas_cumprod"][t])
            noised = sac * vals + somac * noise
        else:
            noised = vals + noise
        # DIFFERENCE vs real noiser: NO MODULO (reference datasets.py:1081)
        retval = {
            "corrupted": noised,
            "t": np.array([t], dtype=np.int64),
            "known_noise": noise,
        }
        _check_disjoint(item, retval)
        item.update(retval)
        return item


class ScoreMatchingNoisedAnglesDataset:
    """
    Wrapped-Gaussian score-matching noiser (reference datasets.py:1143-1197;
    experimental/unused there too, kept for capability parity). Noise level
    sigma(t) interpolates geometrically between sigma_min and sigma_max; the
    score of the wrapped Gaussian is the derivative of the log-sum over
    2*pi*k translates.
    """

    sigma_min = 0.01 * np.pi
    sigma_max = np.pi
    num_ks = 5000

    def __init__(self, dset, dset_key: Optional[str] = "angles", seed: int = 0):
        self.dset = dset
        self.dset_key = dset_key
        self._rng = np.random.default_rng(seed)

    @staticmethod
    def get_sigma(t: float) -> float:
        if not 0 <= t <= 1:
            raise ValueError(f"t must be in [0, 1], got {t}")
        return (
            ScoreMatchingNoisedAnglesDataset.sigma_min ** (1.0 - t)
            * ScoreMatchingNoisedAnglesDataset.sigma_max**t
        )

    @staticmethod
    def get_score(corr: np.ndarray, orig: np.ndarray, t: float) -> np.ndarray:
        """Score (d/dx log p) of the wrapped Gaussian at the corrupted angles."""
        corr = (corr + np.pi) % (2 * np.pi) - np.pi
        orig = (orig + np.pi) % (2 * np.pi) - np.pi
        if corr.shape != orig.shape or not 0 <= t <= 1:
            raise ValueError(f"shapes {corr.shape} and {orig.shape} must agree and t {t} lie in [0, 1]")
        sigma = ScoreMatchingNoisedAnglesDataset.get_sigma(t)
        delta = (corr - orig + np.pi) % (2 * np.pi) - np.pi
        # Truncated wrapped-Gaussian score: sum over k of the translate terms
        ks = np.arange(-64, 65) * 2 * np.pi  # 129 translates dominate the sum
        shifted = delta[..., None] + ks
        logw = -(shifted**2) / (2 * sigma * sigma)
        w = np.exp(logw - logw.max(axis=-1, keepdims=True))
        score = -(shifted / (sigma * sigma) * w).sum(-1) / w.sum(-1)
        return score

    def __len__(self):
        return len(self.dset)

    def __getitem__(self, index: int) -> Dict:
        item = self.dset[index]
        vals = item[self.dset_key]
        t = float(self._rng.uniform(0, 1))
        sigma = self.get_sigma(t)
        noise = self._rng.standard_normal(vals.shape).astype(np.float32) * sigma
        corrupted = ((vals + noise + np.pi) % (2 * np.pi) - np.pi).astype(np.float32)
        retval = {
            "corrupted": corrupted,
            "t": np.array([t], dtype=np.float32),
            "score": self.get_score(corrupted, vals, t).astype(np.float32),
        }
        _check_disjoint(item, retval)
        item.update(retval)
        return item


class SynNoisedMaskedOnlyDataset:
    """
    Noise ONLY masked positions: a correct model satisfies
    f(angles) == f(corrupted). Mask-invariance test harness, NOT for training
    (reference datasets.py:1096-1140).
    """

    def __init__(self, dset, dset_key: str = "angles", seed: int = 0, **kwargs):
        self.dset = dset
        self.dset_key = dset_key
        self._rng = np.random.default_rng(seed)
        logging.warning("NOT FOR TRAINING")

    @property
    def feature_names(self):
        return self.dset.feature_names

    @property
    def feature_is_angular(self):
        return self.dset.feature_is_angular

    @property
    def pad(self):
        return self.dset.pad

    def __len__(self):
        return len(self.dset)

    def __getitem__(self, index: int) -> Dict:
        item = self.dset[index]
        vals = item[self.dset_key]
        attn_mask = item["attn_mask"]
        if not np.all(vals[attn_mask == 0] == 0.0):
            raise ValueError("masked positions of the clean item must be 0")
        noise = self._rng.standard_normal(vals.shape).astype(np.float32)
        noise[attn_mask == 1] = 0.0
        retval = {
            "corrupted": vals + noise,
            "t": np.array([int(self._rng.integers(0, 250))], dtype=np.int64),
            "known_noise": noise,
        }
        _check_disjoint(item, retval)
        item.update(retval)
        return item
