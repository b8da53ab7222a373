"""
Dataset layer (counterpart of foldingdiff_tpu/data/datasets.py): PDB
directories -> featurized, padded angle arrays, numpy only.

- `AngleDataset` ~ the reference CathCanonicalAnglesDataset
  (datasets.py:75-481): featurize every PDB (a spawn process pool), an
  md5-keyed pickle cache, the min-length filter, leftalign / randomcrop /
  discard trimming, a shuffled contiguous 80/10/10 split at
  default_rng(6489), zero-centring by the wrapped circular mean, and
  `refresh_crops_`, the per-epoch re-crop of the structures longer than pad.
- `AnglesOnlyDataset`, `MinimalAnglesDataset`, `CoordsDataset`: the feature
  subsets (reference datasets.py:483-566); `DATASET_CLASSES` names them.
- `AnglesEmptyDataset`: the shape-only stub that sampling uses without data.
- `NoisedAnglesDataset`: per-item DDPM forward noising on the host from a
  numpy generator (reference datasets.py:685-886), the base of the debug
  noisers (data/debug_noisers.py).
- `AutoregressiveCausalDataset`: causal-prefix items for the autoregressive
  baseline; `AngleDataset.sample_length` draws its sampler's lengths.

A structure is featurized by the numpy path of geometry/featurize.py (the
JAX package may take its optional C++ featurizer, which its tests hold equal
to that path). The cache is the port's own file, `cache_canonical_torch_*`,
keyed on the md5 of this package's data/ and geometry/ sources: it never
opens the JAX package's caches, which pickle pandas DataFrames, though
FOLDINGDIFF_CACHE_DIR points both packages at one directory.
"""
from __future__ import annotations

import functools
import glob
import hashlib
import json
import logging
import multiprocessing
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from foldingdiff_tpu_torch import utils
from foldingdiff_tpu_torch.data.feature_sets import (
    FEATURE_SET_NAMES_TO_ANGULARITY,
    FEATURE_SET_NAMES_TO_FEATURE_NAMES,
)
from foldingdiff_tpu_torch.diffusion.schedules import compute_alphas, get_variance_schedule
from foldingdiff_tpu_torch.geometry.featurize import (
    EXHAUSTIVE_ANGLES,
    EXHAUSTIVE_DISTS,
    canonical_distances_and_dihedrals,
)
from foldingdiff_tpu_torch.geometry.pdb import extract_backbone_coords

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL_DATA_DIR = Path(os.path.dirname(_PKG_DIR)) / "data"
CATH_DIR = LOCAL_DATA_DIR / "cath"
ALPHAFOLD_DIR = LOCAL_DATA_DIR / "alphafold"

TRIM_STRATEGIES = ("leftalign", "randomcrop", "discard")
CACHE_PREFIX = "cache_canonical_torch_structures"


def _featurize_one(fname: str) -> Optional[Dict]:
    """{"angles": (L, 9) float64 in AngleDataset's column order, "coords":
    (L, 3) CA coords, "fname"}, or None for a file the featurizer skips."""
    feats = canonical_distances_and_dihedrals(fname, distances=EXHAUSTIVE_DISTS, angles=EXHAUSTIVE_ANGLES)
    if feats is None:
        return None
    values, names = feats
    if names != AngleDataset.feature_names["angles"]:
        raise RuntimeError(f"featurizer columns {names}, expected {AngleDataset.feature_names['angles']}")
    coords = extract_backbone_coords(fname, atoms=("CA",))
    if coords is None:
        return None
    return {"angles": values, "coords": np.asarray(coords), "fname": fname}


class AngleDataset:
    """Full 9-feature (3 distances + 6 angles) dataset over a directory of PDBs."""

    feature_names = {
        "angles": ["0C:1N", "N:CA", "CA:C", "phi", "psi", "omega", "tau", "CA:C:1N", "C:1N:1CA"],
        "coords": ["x", "y", "z"],
    }
    feature_is_angular = {
        "angles": [False, False, False, True, True, True, True, True, True],
        "coords": [False, False, False],
    }

    def __init__(
        self,
        pdbs: Union[str, Sequence[str]] = "cath",
        split: Optional[str] = None,
        pad: int = 512,
        min_length: int = 40,
        trim_strategy: str = "leftalign",
        toy: int = 0,
        zero_center: bool = True,
        cache_dir: Optional[str] = None,
        n_workers: Optional[int] = None,
    ) -> None:
        if pad <= min_length:
            raise ValueError(f"pad {pad} must exceed min_length {min_length}")
        if trim_strategy not in TRIM_STRATEGIES:
            raise ValueError(f"trim_strategy {trim_strategy!r} not in {TRIM_STRATEGIES}")
        self.trim_strategy = trim_strategy
        self.pad = pad
        self.min_length = min_length
        self.pdbs_src = pdbs
        # FOLDINGDIFF_CACHE_DIR overrides the default package-dir cache location
        self.cache_dir = cache_dir or os.environ.get("FOLDINGDIFF_CACHE_DIR") or os.path.dirname(os.path.abspath(__file__))
        self.n_workers = n_workers if n_workers is not None else (os.cpu_count() or 1)
        self.fnames = fnames = self._get_pdb_fnames(pdbs)

        # Cache keyed by this package's source md5 + the file-name set
        # (reference datasets.py:128-163)
        self.structures = None
        codebase_hash = hashlib.md5(
            (utils.md5_all_py_files(os.path.join(_PKG_DIR, "data"))
             + utils.md5_all_py_files(os.path.join(_PKG_DIR, "geometry"))).encode()
        ).hexdigest()
        if toy:
            fnames = fnames[: int(toy) if not isinstance(toy, bool) else 150]
            logging.info(f"Loading toy dataset of {len(fnames)} structures")
            self.structures = self._compute_featurization(fnames)
        elif os.path.exists(self.cache_fname):
            logging.info(f"Loading cached dataset from {self.cache_fname}")
            with open(self.cache_fname, "rb") as src:
                loaded_hash, loaded_structures = pickle.load(src)
            if loaded_hash == codebase_hash:
                self.structures = loaded_structures
            else:
                logging.warning("Mismatched codebase hash; recomputing featurization")
        if self.structures is None:
            self._clean_mismatched_caches()
            self.structures = self._compute_featurization(fnames)
            if not toy:
                logging.info(f"Caching dataset to {self.cache_fname}")
                # written aside and renamed, so that another rank featurizing
                # the same files never reads a partial cache
                partial = f"{self.cache_fname}.tmp{os.getpid()}"
                with open(partial, "wb") as sink:
                    pickle.dump((codebase_hash, self.structures), sink)
                os.replace(partial, self.cache_fname)

        if self.min_length:
            orig = len(self.structures)
            self.structures = [s for s in self.structures if len(s["angles"]) >= self.min_length]
            logging.info(f"Min-length {self.min_length} filter: {orig} -> {len(self.structures)}")
        if self.trim_strategy == "discard":
            orig = len(self.structures)
            self.structures = [s for s in self.structures if len(s["angles"]) <= self.pad]
            logging.info(f"Discard-trim to pad {self.pad}: {orig} -> {len(self.structures)}")

        # Deterministic shuffle + contiguous 80/10/10 split (reference seed
        # 6489, datasets.py:185-206); randomcrop then draws from the same rng
        self.rng = np.random.default_rng(seed=6489)
        self.rng.shuffle(self.structures)
        if split is not None:
            split_idx = int(len(self.structures) * 0.8)
            n_valid = int(len(self.structures) * 0.1)
            if split == "train":
                self.structures = self.structures[:split_idx]
            elif split == "validation":
                self.structures = self.structures[split_idx : split_idx + n_valid]
            elif split == "test":
                self.structures = self.structures[split_idx + n_valid :]
            else:
                raise ValueError(f"Unknown split: {split}")
            logging.info(f"Split {split} contains {len(self.structures)} structures")

        self.means = None
        if zero_center:
            concat = np.concatenate([s["angles"] for s in self.structures])
            self.means = utils.wrapped_mean(concat, axis=0)
            logging.info(f"Zero-centering features by wrapped means {self.means}")

        # Full (untrimmed) lengths, and their own generator for sample_length,
        # as in JAX (foldingdiff_tpu/data/datasets.py:192-193)
        self.all_lengths = [len(s["angles"]) for s in self.structures]
        self._length_rng = np.random.default_rng(seed=6489)
        self._full_item_cache: Dict[int, Dict[str, np.ndarray]] = {}

    # -- file gathering ----------------------------------------------------
    def _get_pdb_fnames(self, pdbs) -> List[str]:
        if isinstance(pdbs, (list, tuple)):
            missing = [f for f in pdbs if not os.path.isfile(f)]
            if missing:
                raise FileNotFoundError(f"Missing files {missing[:5]}")
            return list(pdbs)
        if Path(pdbs).is_dir():
            fnames = []
            for ext in (".pdb", ".pdb.gz"):
                fnames.extend(sorted(glob.glob(os.path.join(pdbs, f"*{ext}"))))
            if not fnames:  # CATH dompdb files have no extension
                fnames = sorted(glob.glob(os.path.join(pdbs, "*")))
        elif pdbs == "cath":
            fnames = sorted(glob.glob(os.path.join(CATH_DIR, "dompdb", "*")))
        elif pdbs == "alphafold":
            fnames = sorted(glob.glob(os.path.join(ALPHAFOLD_DIR, "*.pdb.gz")))
        else:
            raise ValueError(f"Unknown pdb set: {pdbs}")
        if not fnames:
            raise FileNotFoundError(f"No PDB files for {pdbs}")
        return fnames

    def _cache_key(self) -> str:
        src = str(self.pdbs_src)
        return os.path.basename(src) if os.path.isdir(src) else src

    @property
    def cache_fname(self) -> str:
        h = hashlib.md5()
        for f in self.fnames:
            h.update(os.path.basename(f).encode())
        return os.path.join(self.cache_dir, f"{CACHE_PREFIX}_{self._cache_key()}_{h.hexdigest()}.pkl")

    def _clean_mismatched_caches(self) -> None:
        for fname in glob.glob(os.path.join(self.cache_dir, f"{CACHE_PREFIX}_{self._cache_key()}_*.pkl")):
            if fname != self.cache_fname:
                logging.info(f"Removing stale cache {fname}")
                os.remove(fname)

    def _compute_featurization(self, fnames: Sequence[str]) -> List[Dict]:
        logging.info(f"Featurizing {len(fnames)} structures with {self.n_workers} workers")
        if self.n_workers > 1 and len(fnames) > 16:
            with multiprocessing.get_context("spawn").Pool(self.n_workers) as pool:
                results = pool.map(_featurize_one, fnames, chunksize=32)
        else:
            results = [_featurize_one(f) for f in fnames]
        return [r for r in results if r is not None]

    # -- public API (reference parity) --------------------------------------
    def sample_length(self, n: int = 1) -> Union[int, List[int]]:
        """One length (n = 1), or a list of n, drawn with replacement from
        all_lengths by the dataset's own generator."""
        if n < 1:
            raise ValueError(f"n must be positive, got {n}")
        if n == 1:
            return int(self._length_rng.choice(self.all_lengths))
        return self._length_rng.choice(self.all_lengths, size=n, replace=True).tolist()

    def get_masked_means(self) -> Optional[np.ndarray]:
        return None if self.means is None else np.copy(self.means)

    def set_masked_means(self, values: np.ndarray) -> None:
        if self.means is None:
            raise ValueError("this dataset is not zero-centred")
        self.means = np.copy(values)

    @functools.cached_property
    def filenames(self) -> List[str]:
        return [s["fname"] for s in self.structures]

    def __len__(self) -> int:
        return len(self.structures)

    def _feature_subset(self, angles: np.ndarray) -> np.ndarray:
        return angles  # the base class keeps all 9

    def __getitem__(self, index: int, ignore_zero_center: bool = False) -> Dict[str, np.ndarray]:
        if not 0 <= index < len(self):
            raise IndexError("Index out of range")
        col_names = AngleDataset.feature_names["angles"]
        angles = np.array(self.structures[index]["angles"], dtype=np.float64)
        coords = np.asarray(self.structures[index]["coords"], dtype=np.float64)

        if self.means is not None and not ignore_zero_center:
            angles = angles - self.means
            angular_idx = [i for i, c in enumerate(col_names) if c.count(":") != 1]
            angles[:, angular_idx] = utils.modulo_with_wrapped_range(angles[:, angular_idx], -np.pi, np.pi)

        angles = np.nan_to_num(angles, nan=0.0)

        l = min(self.pad, angles.shape[0])
        attn_mask = np.zeros(self.pad, dtype=np.float32)
        attn_mask[:l] = 1.0

        if angles.shape[0] < self.pad:
            angles = np.pad(angles, ((0, self.pad - angles.shape[0]), (0, 0)))
            coords = np.pad(coords, ((0, self.pad - coords.shape[0]), (0, 0)))
        elif angles.shape[0] > self.pad:
            if self.trim_strategy == "leftalign":
                angles, coords = angles[: self.pad], coords[: self.pad]
            elif self.trim_strategy == "randomcrop":
                start = self.rng.integers(0, angles.shape[0] - self.pad)
                angles, coords = angles[start : start + self.pad], coords[start : start + self.pad]
            else:
                raise ValueError(f"{self.trim_strategy} cannot trim a structure longer than pad {self.pad}")

        angular = np.where(AngleDataset.feature_is_angular["angles"])[0]
        if not (utils.tolerant_comparison_check(angles[:, angular], ">=", -np.pi)
                and utils.tolerant_comparison_check(angles[:, angular], "<=", np.pi)):
            raise ValueError(f"structure {index}: angles outside [-pi, pi]")

        return {
            "angles": self._feature_subset(angles.astype(np.float32)),
            "coords": coords.astype(np.float32),
            "attn_mask": attn_mask,
            "position_ids": np.arange(self.pad, dtype=np.int64),
            "lengths": np.int64(l),
        }

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """The whole dataset stacked into dense arrays, one per item key."""
        items = [self[i] for i in range(len(self))]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    @functools.cached_property
    def over_pad_indices(self) -> List[int]:
        """Indices of the structures longer than pad (the ones randomcrop crops)."""
        return [i for i, s in enumerate(self.structures) if len(s["angles"]) > self.pad]

    def _full_item(self, index: int) -> Dict[str, np.ndarray]:
        """__getitem__'s output at the structure's full length (no crop, no
        pad), memoized. Centring, wrap, NaN fill and the float32 cast are
        elementwise, so a crop of it is byte for byte a fresh __getitem__."""
        cached = self._full_item_cache.get(index)
        if cached is None:
            orig_pad = self.pad
            try:
                self.pad = len(self.structures[index]["angles"])  # neither crops nor pads
                cached = self[index]
            finally:
                self.pad = orig_pad
            self._full_item_cache[index] = cached
        return cached

    def refresh_crops_(self, arrays: Dict[str, np.ndarray], epoch_seed: int) -> Dict[str, np.ndarray]:
        """
        Re-draw the random crop of every structure longer than pad, in place
        (the reference crops afresh at every __getitem__, datasets.py:411-438,
        so each epoch sees another window of each long structure). The crops
        are a function of epoch_seed alone, so a resumed run sees the same
        windows. A no-op unless trim_strategy is "randomcrop" and some
        structure exceeds pad.
        """
        if self.trim_strategy != "randomcrop" or not self.over_pad_indices:
            return arrays
        rng = np.random.default_rng(int(epoch_seed) & 0x7FFFFFFFFFFFFFFF)
        for i in self.over_pad_indices:
            item = self._full_item(i)
            start = int(rng.integers(0, int(item["lengths"]) - self.pad))
            # attn_mask, lengths and position_ids of a >pad item do not move
            for k in ("angles", "coords"):
                if k not in arrays:
                    continue
                src = item.get(k)
                if src is None and k == "angles":  # cart-coords arrays carry coords as "angles"
                    src = item.get("coords")
                if src is not None:
                    arrays[k][i] = src[start : start + self.pad]
        return arrays


class AnglesOnlyDataset(AngleDataset):
    """The 6 angles (reference CathCanonicalAnglesOnlyDataset)."""

    feature_names = {"angles": ["phi", "psi", "omega", "tau", "CA:C:1N", "C:1N:1CA"]}
    feature_is_angular = {"angles": [True, True, True, True, True, True]}

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        base = AngleDataset.feature_names["angles"]
        self.feature_idx = [base.index(ft) for ft in self.feature_names["angles"]]

    def get_masked_means(self) -> Optional[np.ndarray]:
        return None if self.means is None else np.copy(self.means)[self.feature_idx]

    def set_masked_means(self, values: np.ndarray) -> None:
        if self.means is None:
            raise ValueError("this dataset is not zero-centred")
        self.means[self.feature_idx] = np.copy(values)

    def _feature_subset(self, angles: np.ndarray) -> np.ndarray:
        sub = angles[:, self.feature_idx]
        if not (sub.min() >= -np.pi - 1e-5 and sub.max() <= np.pi + 1e-5):
            raise ValueError("angles outside [-pi, pi]")
        return sub


class MinimalAnglesDataset(AnglesOnlyDataset):
    """phi, psi, omega and tau (reference CathCanonicalMinimalAnglesDataset)."""

    feature_names = {"angles": ["phi", "psi", "omega", "tau"]}
    feature_is_angular = {"angles": [True, True, True, True]}


class CoordsDataset(AngleDataset):
    """CA xyz coordinates (reference CathCanonicalCoordsDataset)."""

    feature_names = {"coords": ["x", "y", "z"]}
    feature_is_angular = {"coords": [False, False, False]}

    def __getitem__(self, index: int, ignore_zero_center: bool = True):
        item = super().__getitem__(index, ignore_zero_center=ignore_zero_center)
        item.pop("angles", None)
        return item


DATASET_CLASSES = {
    "canonical": AngleDataset,
    "canonical-full-angles": AnglesOnlyDataset,
    "canonical-minimal-angles": MinimalAnglesDataset,
    "cart-coords": CoordsDataset,
}


class AnglesEmptyDataset:
    """Shape-only stub so sampling can run with no data on disk
    (reference datasets.py:569-623)."""

    def __init__(self, feature_set_key: str, pad: int = 128, mean_offset: Optional[np.ndarray] = None):
        k = "coords" if feature_set_key == "cart-coords" else "angles"
        self.feature_is_angular = {k: FEATURE_SET_NAMES_TO_ANGULARITY[feature_set_key]}
        self.feature_names = {k: FEATURE_SET_NAMES_TO_FEATURE_NAMES[feature_set_key]}
        self.pad = pad
        self._mean_offset = mean_offset
        if self._mean_offset is not None and np.asarray(self._mean_offset).size != len(self.feature_names[k]):
            raise ValueError(
                f"mean offset has {np.asarray(self._mean_offset).size} values, "
                f"expected {len(self.feature_names[k])}"
            )

    @classmethod
    def from_dir(cls, dirname: str) -> "AnglesEmptyDataset":
        with open(os.path.join(dirname, "training_args.json")) as f:
            train_args = json.load(f)
        offset_file = os.path.join(dirname, "training_mean_offset.npy")
        mean_offset = np.load(offset_file) if os.path.isfile(offset_file) else None
        return cls(
            feature_set_key=train_args["angles_definitions"],
            pad=train_args["max_seq_len"],
            mean_offset=mean_offset,
        )

    def get_masked_means(self) -> np.ndarray:
        if self._mean_offset is None:
            raise NotImplementedError
        return np.copy(self._mean_offset)


class NoisedAnglesDataset:
    """
    Per-item DDPM forward noising over a clean dataset (reference
    datasets.py:685-886), numpy only: t ~ U[0, timesteps) (or every t in
    turn with exhaustive_t), wrapped Gaussian noise scaled per feature, and
    x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) noise with the angular features
    wrapped. Draws come from np.random.default_rng(seed), in the JAX
    package's order, so the same seed over the same clean dataset gives the
    JAX package's items exactly. The trainer noises whole batches on the
    device instead; the debug noisers build on this class.
    """

    def __init__(
        self,
        dset,
        dset_key: str = "angles",
        timesteps: int = 250,
        exhaustive_t: bool = False,
        beta_schedule: str = "linear",
        nonangular_variance: float = 1.0,
        angular_variance: float = 1.0,
        seed: Optional[int] = None,
    ) -> None:
        self.dset = dset
        self.dset_key = dset_key
        self.n_features = len(dset.feature_is_angular[dset_key])
        self.nonangular_var_scale = nonangular_variance
        self.angular_var_scale = angular_variance
        self.timesteps = timesteps
        self.schedule = beta_schedule
        self.exhaustive_timesteps = exhaustive_t
        betas = get_variance_schedule(beta_schedule, timesteps)
        self.alpha_beta_terms = compute_alphas(betas)
        self._rng = np.random.default_rng(seed)

    @property
    def feature_names(self):
        return self.dset.feature_names

    @property
    def feature_is_angular(self):
        return self.dset.feature_is_angular

    @property
    def pad(self):
        return self.dset.pad

    @property
    def filenames(self):
        return self.dset.filenames

    def sample_length(self, *args, **kwargs):
        return self.dset.sample_length(*args, **kwargs)

    def __len__(self) -> int:
        n = len(self.dset)
        return n * self.timesteps if self.exhaustive_timesteps else n

    def sample_noise(self, vals: np.ndarray) -> np.ndarray:
        noise = self._rng.standard_normal(vals.shape).astype(np.float32)
        is_ang = np.asarray(self.dset.feature_is_angular[self.dset_key])
        scales = np.where(is_ang, self.angular_var_scale, self.nonangular_var_scale)
        noise = noise * scales.astype(np.float32)
        ang_idx = np.where(is_ang)[0]
        noise[..., ang_idx] = utils.modulo_with_wrapped_range(noise[..., ang_idx], -np.pi, np.pi)
        return noise

    def __getitem__(
        self, index: int, use_t_val: Optional[int] = None, ignore_zero_center: bool = False
    ) -> Dict[str, np.ndarray]:
        if not 0 <= index < len(self):
            raise IndexError("Index out of range")
        if self.exhaustive_timesteps:
            item_index, time_index = divmod(index, self.timesteps)
            item = self.dset.__getitem__(item_index, ignore_zero_center=ignore_zero_center)
        else:
            item = self.dset.__getitem__(index, ignore_zero_center=ignore_zero_center)

        vals = np.copy(item[self.dset_key])

        if use_t_val is not None:
            if self.exhaustive_timesteps:
                raise ValueError("use_t_val is not taken with exhaustive_t")
            t = int(np.clip(use_t_val, 0, self.timesteps - 1))
        elif self.exhaustive_timesteps:
            t = int(time_index)
        else:
            t = int(self._rng.integers(0, self.timesteps))

        sqrt_ac = np.float32(self.alpha_beta_terms["sqrt_alphas_cumprod"][t])
        sqrt_omac = np.float32(self.alpha_beta_terms["sqrt_one_minus_alphas_cumprod"][t])
        noise = self.sample_noise(vals)
        noised = sqrt_ac * vals + sqrt_omac * noise
        ang_idx = np.where(self.dset.feature_is_angular[self.dset_key])[0]
        noised[:, ang_idx] = utils.modulo_with_wrapped_range(noised[:, ang_idx], -np.pi, np.pi)

        retval = {
            "corrupted": noised.astype(np.float32),
            "t": np.array([t], dtype=np.int64),
            "known_noise": noise.astype(np.float32),
            "sqrt_alphas_cumprod_t": sqrt_ac,
            "sqrt_one_minus_alphas_cumprod_t": sqrt_omac,
        }
        if not set(item.keys()).isdisjoint(retval.keys()):
            raise ValueError(f"clean item already has keys {set(item) & set(retval)}")
        item.update(retval)
        return item


class AutoregressiveCausalDataset:
    """
    Causal-LM items over a clean dataset (reference datasets.py:626-682):
    each item gains causal_len ~ U[1, length) from np.random.default_rng(seed),
    the prefix mask `causal_attn_mask` over the first causal_len positions,
    the angles at causal_len (`causal_target`) and `causal_idx`. Numpy only,
    so the same seed gives the JAX package's items exactly.
    """

    def __init__(self, dset, dset_key: str = "angles", seed: Optional[int] = None) -> None:
        if dset_key not in dset.feature_is_angular:
            raise ValueError(f"dataset has no {dset_key!r} features")
        self.dset = dset
        self.dset_key = dset_key
        self.n_features = len(dset.feature_is_angular[dset_key])
        self._rng = np.random.default_rng(seed)

    @property
    def feature_names(self):
        return self.dset.feature_names

    @property
    def feature_is_angular(self):
        return self.dset.feature_is_angular

    @property
    def pad(self):
        return self.dset.pad

    def __len__(self) -> int:
        return len(self.dset)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        item = self.dset[index]
        orig_len = int(item["lengths"])
        if orig_len > self.dset.pad:
            raise ValueError(f"item {index}: length {orig_len} exceeds pad {self.dset.pad}")
        causal_len = int(self._rng.integers(1, orig_len))
        causal_attn_mask = np.zeros_like(item["attn_mask"])
        causal_attn_mask[:causal_len] = 1.0
        item["causal_attn_mask"] = causal_attn_mask
        item["causal_target"] = item[self.dset_key][causal_len]
        item["causal_idx"] = np.int64(causal_len)
        return item
