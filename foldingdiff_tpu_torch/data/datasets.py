"""
Dataset layer (counterpart of foldingdiff_tpu/data/datasets.py).

Only the shape-only `AnglesEmptyDataset` is ported so far: sampling needs the
feature names, their angularity, the pad length and the training mean offset,
and no data on disk.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from foldingdiff_tpu.data.feature_sets import (
    FEATURE_SET_NAMES_TO_ANGULARITY,
    FEATURE_SET_NAMES_TO_FEATURE_NAMES,
)


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
