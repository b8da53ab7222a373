"""
Host-side helpers (counterpart of foldingdiff_tpu/utils.py), numpy only:
the angular wrap, the circular mean, the float32-tolerant bound check, the
config merge and the source hash that keys the dataset cache.
"""
from __future__ import annotations

import glob
import hashlib
import logging
import os
from typing import Any, Dict, Literal

import numpy as np


def modulo_with_wrapped_range(vals, range_min: float = -np.pi, range_max: float = np.pi):
    """
    Modulo with a wrapped (possibly negative-min) range, by floored `%`.

    >>> modulo_with_wrapped_range(3, -2, 2)
    -1
    """
    if not (range_min <= 0.0 and range_min < range_max):
        raise ValueError(f"need range_min <= 0 < range_max, got [{range_min}, {range_max})")
    top = range_max - range_min
    return ((vals - range_min) % top) + range_min


def wrapped_mean(x: np.ndarray, axis=None) -> np.ndarray:
    """Circular mean: atan2 of the mean sine and cosine, NaN-tolerant
    (reference custom_metrics.py:85-94)."""
    sin = np.nanmean(np.sin(x), axis=axis)
    cos = np.nanmean(np.cos(x), axis=axis)
    return np.arctan2(sin, cos)


def tolerant_comparison_check(values, cmp: Literal[">=", "<="], v) -> bool:
    """
    Bound check tolerant of float32 rounding at the boundary.

    >>> tolerant_comparison_check(-3.1415927410125732, ">=", -np.pi)
    True
    """
    if cmp == ">=":
        diff = np.nanmin(values) - v
        return bool(np.isclose(diff, 0, atol=1e-5) or diff > 0)
    if cmp == "<=":
        diff = np.nanmax(values) - v
        return bool(np.isclose(diff, 0, atol=1e-5) or diff < 0)
    raise ValueError(f"Illegal comparator: {cmp}")


def update_dict_nonnull(d: Dict[str, Any], vals: Dict[str, Any]) -> Dict[str, Any]:
    """
    Merge `vals` into `d`, skipping None overrides for existing keys.

    >>> update_dict_nonnull({'a': 1, 'b': 2}, {'b': 3, 'c': 4})
    {'a': 1, 'b': 3, 'c': 4}
    """
    for k, v in vals.items():
        if k in d:
            if d[k] != v and v is not None:
                logging.info(f"Replacing key {k} original value {d[k]} with {v}")
                d[k] = v
        else:
            d[k] = v
    return d


def md5_all_py_files(dirname: str) -> str:
    """One md5 over all .py files in a directory, for dataset-cache invalidation."""
    hash_md5 = hashlib.md5()
    for fname in sorted(glob.glob(os.path.join(dirname, "*.py"))):
        with open(fname, "rb") as f:
            for chunk in iter(lambda: f.read(2**20), b""):
                hash_md5.update(chunk)
    return hash_md5.hexdigest()
