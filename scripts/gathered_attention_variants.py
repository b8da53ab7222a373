#!/usr/bin/env python3
"""
Design sweep of the v1 attention kernel's tensor-core instances
(foldingdiff_tpu_torch/csrc/gathered_attention.cu, TF32 and bf16) on one
NVIDIA GPU: each variant is the kernel's source with one design choice
changed by a text substitution, built with nvcc (all variants at once, one
process each) into foldingdiff_tpu_torch/_build/variants/, checked against
the plain PyTorch version in each instance's mode, and timed with the final
source and the FMA instance in the same run.

Variants:
  final             the source as it is: chunks of 32 keys (16 at D = 64)
  keys-16           chunks of 16 keys at D <= 32
  keys-64           chunks of 64 keys at D <= 32
  d64-keys-8        chunks of 8 keys at D = 64
  d64-keys-32       chunks of 32 keys at D = 64

A substitution whose text is no longer in the source stops the run with an
error naming the variant. The inputs, the checks (chip_smoke.check_instance)
and the timing (a CUDA graph of 50 calls, the variants taken in turns,
forwards then backwards) are chip_smoke.py's.

Prints, per variant, ptxas's register and spill report, the checks, and
device times of the TF32 and bf16 instances with and without relative scores
at H = 12, D = 32 and (B, L) = (64, 128), (64, 64), (15, 64), beside the FMA
instance, with the card's name and power limit. The last line is a JSON
object of the times.

Usage: python3 scripts/gathered_attention_variants.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke  # noqa: E402
from foldingdiff_tpu_torch.ops import attention  # noqa: E402
from rel_attention_variants import build_and_report, variant_libraries  # noqa: E402

KEYS = "static constexpr int kKeys = D <= 32 ? 32 : 16;"
SUBSTITUTIONS = {
    "final": [],
    "keys-16": [(KEYS, KEYS.replace("? 32 :", "? 16 :"))],
    "keys-64": [(KEYS, KEYS.replace("? 32 :", "? 64 :"))],
    "d64-keys-8": [(KEYS, KEYS.replace(": 16;", ": 8;"))],
    "d64-keys-32": [(KEYS, KEYS.replace(": 16;", ": 32;"))],
}
TIMED = [(64, 128), (64, 64), (15, 64)]  # (B, L) at H = 12, D = 32, M = 128
CHECKED = [(64, 12, 128, 32, 128), (15, 12, 64, 32, 128), (16, 6, 33, 16, 64), (3, 5, 99, 64, 128),
           (1, 2, 1000, 32, 1000)]


def on(lib, fn):
    """fn run with `lib` as the v1 kernel's library."""
    def run():
        attention.GATHERED_ATTENTION = lib
        return fn()
    return run


def plain(q, k, v, bias, e_lr):
    return lambda mode: chip_smoke.in_mode(mode, lambda: attention.fused_attention_reference(
        q, k, v, bias, e_lr, bf16=mode == "bf16"))


def main() -> None:
    card = chip_smoke.phase_card()  # exits without a card
    libs = variant_libraries(attention.GATHERED_ATTENTION, SUBSTITUTIONS)
    build_and_report(libs, "gathered_attention")

    results = {}
    original = attention.GATHERED_ATTENTION
    try:
        with torch.inference_mode():
            for name, lib in libs.items():
                attention.GATHERED_ATTENTION = lib
                for b, h, l, d, m in CHECKED:
                    q, k, v, bias, table = chip_smoke.attention_inputs(b, h, l, d, m, seed=l + d)
                    for e_lr in (chip_smoke.gathered(table, l, m, permuted=True), None):
                        for mode in ("tf32", "bf16"):
                            chip_smoke.check_instance(
                                f"{name} B={b} H={h} L={l} D={d} rel={e_lr is not None} {mode}", mode,
                                attention.fused_attention(q, k, v, bias, e_lr, mode=mode), plain(q, k, v, bias, e_lr))
            for b, l in TIMED:
                q, k, v, bias, table = chip_smoke.attention_inputs(b, 12, l, 32, 128, chip_smoke.SEED)
                e_lr = chip_smoke.gathered(table, l, 128, permuted=False)
                for rel in (True, False):
                    e = e_lr if rel else None
                    fns = {"fma": lambda: attention.fused_attention(q, k, v, bias, e, mode="ieee")}
                    for name, lib in libs.items():
                        for mode in ("tf32", "bf16"):
                            fns[f"{name} {mode}"] = on(lib, lambda mode=mode: attention.fused_attention(
                                q, k, v, bias, e, mode=mode))
                    key = f"B={b} L={l} {'rel' if rel else 'rel-off'}"
                    results[key] = chip_smoke.in_turns({n: on(original, f) if n == "fma" else f
                                                        for n, f in fns.items()})
                    print(f"{key} on {card} (device ms): " + ", ".join(
                        f"{name} {ms:.4f}" for name, ms in results[key].items()), flush=True)
    finally:
        attention.GATHERED_ATTENTION = original
    print(json.dumps({"card": card, "ms": results}))


if __name__ == "__main__":
    main()
