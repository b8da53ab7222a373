"""
The yardstick of the roofline and MFU metrics, frozen here: the published
dense peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W limit) and
the least time of one attention call, as chip_smoke.py's bound() computed
them when the benchmark was written: the larger of the call's FLOPs (q.k,
q.E and p.v, 2 per multiply-add, times the instance's products of parts)
over the instance's peak and its bytes (q, k, v, the bias and the distance
table read once, the output written once) over the memory rate.
"""
from __future__ import annotations

from typing import Tuple

PEAK_BYTES = 3.35e12
TF32_PEAK = 495e12
PEAK_FLOPS = {"fma": 67e12, "f64": 67e12, "tf32": TF32_PEAK, "tf32x3": TF32_PEAK,
              **{i: 989e12 for i in ("bf16", "bf16x3", "bf16x6", "bf16x9", "f16", "f16f16", "bf16bf16")}}
PRODUCTS = {"fma": 1, "f64": 1, "tf32": 1, "bf16": 1, "f16": 1, "f16f16": 1, "bf16bf16": 1,
            "tf32x3": 3, "bf16x3": 3, "bf16x6": 6, "bf16x9": 9}


def attention_bound_s(b: int, h: int, l: int, d: int, m: int, instance: str = "tf32", entry: str = "v2",
                      rel: bool = True) -> Tuple[float, str]:
    """(seconds, what bounds it) of one attention call at (B, H, L, D) with
    a table of 2M - 1 rows (v2) or a gathered (L, L, D) e_lr (v1)."""
    flops = 2 * b * h * l * l * d * (3 if rel else 2) * PRODUCTS[instance]
    floats = 4 * b * h * l * d + b * l + (((2 * m - 1) * d if entry == "v2" else l * l * d) if rel else 0)
    ops_s, bytes_s = flops / PEAK_FLOPS[instance], 4 * floats / PEAK_BYTES
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
