#!/usr/bin/env python3
"""
Design sweep of the v2 attention kernel (foldingdiff_tpu_torch/csrc/
rel_attention.cu) on one NVIDIA GPU: each variant is the kernel's source with
one design choice undone by a text substitution, built with nvcc (all
variants at once, one process each) into foldingdiff_tpu_torch/_build/
variants/, checked against the plain PyTorch version, and timed with the
final source in the same run.

Variants:
  final               the source as it is
  d-loop-unrolled     the score loop over D / 4 unrolled (its later loads are
                      hoisted and the registers spill)
  staging-unrolled    the cp.async staging loops unrolled
  v-with-k            V waited for with K and the table window, before the
                      scores, instead of only before p . v
  two-blocks-per-sm   __launch_bounds__ asking for two blocks of two heads per
                      SM (255 registers) instead of three (168)
  one-head-per-block  one head per block instead of two

A substitution whose text is no longer in the source stops the run with an
error naming the variant. The inputs and the timing (a CUDA graph of 50
calls, the variants taken in turns, forwards then backwards) are
chip_smoke.py's.

Prints, per variant, ptxas's register and spill report, the largest error
against the plain version, and device times of the rel and rel-off instances
at H = 12, D = 32 and (B, L) = (64, 128), (64, 64), (15, 64), with the card's
name and power limit. The last line is a JSON object of the times.

Usage: python3 scripts/rel_attention_variants.py
"""
from __future__ import annotations

import json
import re
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from foldingdiff_tpu_torch.ops import attention  # noqa: E402

SUBSTITUTIONS = {
    "final": [],
    "d-loop-unrolled": [("#pragma unroll 1\n    for (int d4", "#pragma unroll\n    for (int d4")],
    "staging-unrolled": [
        ("#pragma unroll 1\n  for (int i = threadIdx.x; i < kHeads * kTile * kVec",
         "#pragma unroll\n  for (int i = threadIdx.x; i < kHeads * kTile * kVec"),
        ("#pragma unroll 1\n      for (int i = threadIdx.x; i < kWindow * kVec",
         "#pragma unroll\n      for (int i = threadIdx.x; i < kWindow * kVec"),
    ],
    "v-with-k": [("cp_async_wait<1>();", "cp_async_wait<0>();")],
    "two-blocks-per-sm": [("D <= 32 ? 6 / kHeads : 1", "D <= 32 ? 4 / kHeads : 1")],
    "one-head-per-block": [("constexpr int kHeads = 2;", "constexpr int kHeads = 1;")],
}
TIMED = [(64, 128), (64, 64), (15, 64)]  # (B, L) at H = 12, D = 32, M = 128
CHECKED = [(64, 12, 128, 32, 128), (15, 12, 64, 32, 128), (16, 6, 33, 16, 64), (100, 5, 99, 64, 128)]


def variant_libraries() -> dict:
    source = (attention.CSRC_DIR / "rel_attention.cu").read_text()
    libs = {}
    for name, subs in SUBSTITUTIONS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        directory = attention.BUILD_DIR / "variants" / name
        directory.mkdir(parents=True, exist_ok=True)
        (directory / "rel_attention.cu").write_text(text)
        shutil.copy(attention.CSRC_DIR / "launch.cuh", directory / "launch.cuh")
        lib = attention.CudaLibrary("rel_attention", attention.REL_ATTENTION.argtypes, attention.REL_ATTENTION.instances)
        lib.source = directory / "rel_attention.cu"
        libs[name] = lib
    return libs


def inputs(b, h, l, d, m, seed=0):
    """chip_smoke.py's attention inputs, with q, k, v as (B, H, L, D) views of
    (B, L, H, D) storage."""
    q, k, v, bias, table = chip_smoke.attention_inputs(b, h, l, d, m, seed)
    return (*(x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)), bias, table)


def on(lib, fn):
    """fn run with `lib` as the v2 kernel's library."""
    def run():
        attention.REL_ATTENTION = lib
        return fn()
    return run


def main() -> None:
    card = chip_smoke.phase_card()  # exits without a card
    libs = variant_libraries()
    with ThreadPoolExecutor(len(libs)) as pool:
        reports = dict(zip(libs, pool.map(lambda lib: attention.build([lib])["rel_attention"], libs.values())))
    for name, report in reports.items():
        instance, spill = "?", "?"
        for line in report.splitlines():
            if "Function properties for" in line:
                found = re.search(r"rel_attention_kernelILi(\d+)ELb(\d)E", line)
                instance = "D={} rel={}".format(*found.groups()) if found else "?"
            elif "spill stores" in line:
                spill = re.search(r"(\d+) bytes spill stores", line).group(1)
            elif "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"{name}: {instance}: {regs} registers, {spill} bytes spilled", flush=True)

    results = {}
    original = attention.REL_ATTENTION
    try:
        with torch.inference_mode():
            for name, lib in libs.items():
                attention.REL_ATTENTION = lib
                worst = 0.0
                for b, h, l, d, m in CHECKED:
                    q, k, v, bias, table = inputs(b, h, l, d, m, seed=l + d)
                    for kw in (dict(rel_table=table, m=m), {}):
                        out = attention.fused_attention_v2(q, k, v, bias, **kw)
                        ref = attention.fused_attention_v2_reference(q, k, v, bias, **kw)
                        worst = max(worst, (out - ref).abs().max().item())
                print(f"{name}: max abs err against the plain version {worst:.3e}", flush=True)
                if not worst <= 1e-4:
                    raise RuntimeError(f"{name} disagrees with the plain version: {worst}")
            for b, l in TIMED:
                q, k, v, bias, table = inputs(b, 12, l, 32, 128)
                for rel in (True, False):
                    kw = dict(rel_table=table, m=128) if rel else {}
                    key = f"B={b} L={l} {'rel' if rel else 'rel-off'}"
                    results[key] = chip_smoke.in_turns({name: on(lib, lambda: attention.fused_attention_v2(
                        q, k, v, bias, **kw)) for name, lib in libs.items()})
                    print(f"{key} on {card} (device ms): " + ", ".join(
                        f"{name} {ms:.4f}" for name, ms in results[key].items()), flush=True)
    finally:
        attention.REL_ATTENTION = original
    print(json.dumps({"card": card, "ms": results}))


if __name__ == "__main__":
    main()
