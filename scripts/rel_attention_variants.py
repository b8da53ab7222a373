#!/usr/bin/env python3
"""
Design sweep of the v2 attention kernel (foldingdiff_tpu_torch/csrc/
rel_attention.cu) on one NVIDIA GPU: each variant is the kernel's source with
one design choice changed by a text substitution, built with nvcc (all
variants at once, one process each) into foldingdiff_tpu_torch/_build/
variants/, checked against the plain PyTorch version in each instance's mode,
and timed with the final source in the same run.

Variants of the FMA instance (timed on it alone):
  d-loop-unrolled     the score loop over D / 4 unrolled (its later loads are
                      hoisted and the registers spill)
  staging-unrolled    the cp.async staging loops unrolled
  v-with-k            V waited for with K and the table window, before the
                      scores, instead of only before p . v
  two-blocks-per-sm   __launch_bounds__ asking for two blocks of two heads per
                      SM (255 registers) instead of three (168)
  one-head-per-block  one head per block instead of two
Variants of the TF32 instance's resident body (timed on it):
  stages-2            a ring of two stages per block at L > 64 instead of one
                      (one block per SM: shared memory holds only one then)
  short-stages-1      one stage at L <= 64 instead of three (two blocks per SM)
  window-32,          QE windows of 32 or 64 keys at L > 64 instead of 16
  window-64           (fewer products, more shared memory: one block per SM)
  short-window-16     QE windows of 16 keys at L <= 64 instead of 64
  one-block-per-sm    one block of eight warps per SM instead of two
  table-per-item      the distance table staged again for every work item
                      instead of once per block
  chunked             the chunked design (one block per 64 query rows, K, V
                      and a table window staged per 64-key chunk, bf16 in two
                      passes) at every L, as it ran before the resident one
                      (timed on TF32 and bf16)
Variants of the multi-pass instances' resident design (tf32x3, bf16x3,
bf16x6, bf16x9; timed on all four):
  parts-window-16     QE windows of 16 keys for the bf16 parts at L > 64
                      instead of 64
  parts-group-48      groups of n-tiles whose B chunks take up to 48
                      registers instead of 24
Variants of the TF32x3 instance at L <= 64 (the resident design's float32
stages; timed on it):
  x3-split-at-mma     every operand split at each mma (device.cuh's
                      mma_split) instead of q's parts once per item and each
                      K, table and V fragment's as loaded
  x3-group-24,        groups of n-tiles whose B parts take up to 24, 32 or
  x3-group-32,        80 registers instead of 48 (2, 2 or 10 n-tiles of QE
  x3-group-80         and 2, 4 or 8 of the scores instead of 5 and 4)
Variants of the f64 instance's resident design (DMMA; timed on it):
  f64-window-16       QE windows of 16 keys at L > 64 instead of 32
Variants of the output-rounding instances' resident design (attention_half,
16-bit planes; timed on f16f16 and bf16bf16):
  half-long-one-block one block of eight warps per SM at L > 64 (255
                      registers) instead of two (128)
  half-short-two-blocks
                      two blocks per SM at L <= 64 instead of one
  half-window-16,     QE windows of 16 or 64 keys at L > 64 instead of 32
  half-window-64      (64: one block per SM with relative scores)
  half-short-window-16
                      QE windows of 16 keys at L <= 64 instead of 64
  half-group-2        at most two n-tiles whose mma interleave instead of four
  half-long-rel-group-2
                      two n-tiles of QE and of the scores interleaved with
                      relative scores at L > 64 instead of one
Variants of the f16 and bf16 instances on that design (their QE slices of
float32 values by 16-key windows at L > 64, each score accumulator seeded
with its relative term; timed on f16 and bf16, but f16-tf32-body on f16
and bf16-tf32-body on bf16):
  f16-one-block       one block of eight warps per SM at L > 64 (255
                      registers), 32-key QE windows and the stage's rows
                      padded, instead of two blocks, 16-key windows and an
                      unpadded stage
  f16-qk-group-1,     the q.k products onto the seeded scores one or two
  f16-qk-group-2      n-tiles at a time instead of four
  f16-tf32-body       the TF32 instance's resident body (TF32 tensor cores
                      on f16 values), as f16 ran before attention_half
  bf16-tf32-body      the same for bf16 (TF32 tensor cores on bf16 values),
                      as bf16 ran before attention_half
"final", the source as it is, is timed on all eleven instances. A variant
but "final" is built as one part of the instances it is run on (and
TF32's, which the multi-pass checks read).

A substitution whose text is no longer in the source stops the run with an
error naming the variant (tests/test_torch_attention.py checks them against
the source on the CPU). The inputs, the checks (chip_smoke.check_instance)
and the timing (a CUDA graph of 50 calls, the variants taken in turns,
forwards then backwards) are chip_smoke.py's.

Prints, per variant, ptxas's register and spill report, the largest error
against the plain version, and device times of the rel and rel-off instances
at H = 12, D = 32 and (B, L) = (64, 128), (64, 64), (15, 64), with the card's
name and power limit. The last line is a JSON object of the times.

Usage: python3 scripts/rel_attention_variants.py [VARIANT ...]   (all by default)
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

F16_QK = ("constexpr int kGK = group_upto(kNT, kHalfGroup);\n#pragma unroll\n"  # f16's q.k onto the seeded scores
          "      for (int n0 = 0; n0 < kNT; n0 += kGK) {\n        half_products<D, A, kGK, kRow>(&s[n0]")
SUBSTITUTIONS = {
    "final": [],
    "d-loop-unrolled": [("#pragma unroll 1\n    for (int d4", "#pragma unroll\n    for (int d4")],
    "staging-unrolled": [
        ("#pragma unroll 1\n  for (int i = threadIdx.x; i < kHeads * kTile * kVec",
         "#pragma unroll\n  for (int i = threadIdx.x; i < kHeads * kTile * kVec"),
        ("#pragma unroll 1\n      for (int i = threadIdx.x; i < kWindow * kVec",
         "#pragma unroll\n      for (int i = threadIdx.x; i < kWindow * kVec"),
    ],
    "v-with-k": [("cp_async_wait<1>();\n    __syncthreads();\n\n    // Scores of rows",
                  "cp_async_wait<0>();\n    __syncthreads();\n\n    // Scores of rows")],
    "two-blocks-per-sm": [("D <= 32 ? 6 / kHeads : 1", "D <= 32 ? 4 / kHeads : 1")],
    "one-head-per-block": [("constexpr int kHeads = 2;", "constexpr int kHeads = 1;")],
    "stages-2": [("constexpr int kStagesLong = 1;", "constexpr int kStagesLong = 2;")],
    "short-stages-1": [("constexpr int kStagesShort = 3;", "constexpr int kStagesShort = 1;")],
    "window-32": [("constexpr int kWindowLong = 16;", "constexpr int kWindowLong = 32;")],
    "window-64": [("constexpr int kWindowLong = 16;", "constexpr int kWindowLong = 64;")],
    "short-window-16": [("constexpr int kWindowShort = 64;", "constexpr int kWindowShort = 16;")],
    "one-block-per-sm": [("<= kSmemPerSM ? 2 : 1;", "<= kSmemPerSM ? 1 : 1;")],
    "table-per-item": [("constexpr bool kTableResident = true;", "constexpr bool kTableResident = false;")],
    "chunked": [("  if constexpr (D <= 32) {\n    if (a.L <= rs::kMaxL) {", "  if constexpr (D < 0) {\n    if (a.L <= rs::kMaxL) {")],
    "parts-window-16": [("constexpr int kWindowParts = 64;", "constexpr int kWindowParts = 16;")],
    "parts-group-48": [("constexpr int kGroupWords = 24;", "constexpr int kGroupWords = 48;")],
    "x3-split-at-mma": [("constexpr bool kSplitAtLoad = kParts<A> > 1;", "constexpr bool kSplitAtLoad = false;")],
    "x3-group-24": [("constexpr int kX3GroupWords = 48;", "constexpr int kX3GroupWords = 24;")],
    "x3-group-32": [("constexpr int kX3GroupWords = 48;", "constexpr int kX3GroupWords = 32;")],
    "x3-group-80": [("constexpr int kX3GroupWords = 48;", "constexpr int kX3GroupWords = 80;")],
    "f64-window-16": [("constexpr int kWindowF64 = 32;", "constexpr int kWindowF64 = 16;")],
    "half-long-one-block": [("constexpr int kHalfBlocksLong = 2;", "constexpr int kHalfBlocksLong = 1;")],
    "half-short-two-blocks": [("constexpr int kHalfBlocksShort = 1;", "constexpr int kHalfBlocksShort = 2;")],
    "half-window-16": [("constexpr int kHalfWindowLong = 32;", "constexpr int kHalfWindowLong = 16;")],
    "half-window-64": [("constexpr int kHalfWindowLong = 32;", "constexpr int kHalfWindowLong = 64;"),
                       ("constexpr int kHalfBlocksLong = 2;", "constexpr int kHalfBlocksLong = 1;")],
    "half-short-window-16": [("constexpr int kHalfWindowShort = 64;", "constexpr int kHalfWindowShort = 16;")],
    "half-group-2": [("constexpr int kHalfGroup = 4;", "constexpr int kHalfGroup = 2;")],
    "half-long-rel-group-2": [("constexpr int kHalfGroupLongRel = 1;", "constexpr int kHalfGroupLongRel = 2;")],
    "f16-one-block": [("constexpr int kHalfBlocksLong = 2;", "constexpr int kHalfBlocksLong = 1;"),
                      ("constexpr int kHalfWindowF32 = 16;", "constexpr int kHalfWindowF32 = 32;"),
                      ("kSRow = kF32QE ? D : D + 4;", "kSRow = D + 4;")],
    "f16-qk-group-1": [(F16_QK, F16_QK.replace("group_upto(kNT, kHalfGroup)", "1"))],
    "f16-qk-group-2": [(F16_QK, F16_QK.replace("group_upto(kNT, kHalfGroup)", "group_upto(kNT, 2)"))],
    "f16-tf32-body": [("kHalfBody = kRoundsOutput<A> || A == Arith::F16 || A == Arith::BF16;",
                       "kHalfBody = kRoundsOutput<A> || A == Arith::BF16;")],
    "bf16-tf32-body": [("kHalfBody = kRoundsOutput<A> || A == Arith::F16 || A == Arith::BF16;",
                        "kHalfBody = kRoundsOutput<A> || A == Arith::F16;")],
}
FMA_VARIANTS = ("d-loop-unrolled", "staging-unrolled", "v-with-k", "two-blocks-per-sm", "one-head-per-block")
MULTI_PASS = ("tf32x3", "bf16x3", "bf16x6", "bf16x9")
ROUNDING = ("f16f16", "bf16bf16")  # the output-rounding instances (attention_half)
TIMED = [(64, 128), (64, 64), (15, 64)]  # (B, L) at H = 12, D = 32, M = 128
CHECKED = [(64, 12, 128, 32, 128), (15, 12, 64, 32, 128), (16, 6, 33, 16, 64), (100, 5, 99, 64, 128),
           (2, 3, 200, 32, 256), (3, 2, 1, 32, 128)]


def instances_of(variant: str) -> tuple:
    """The instances a variant changes, and so is checked and timed on."""
    if variant == "final":
        return ("fma", "tf32", "bf16", *MULTI_PASS, "f64", "f16", *ROUNDING)
    if variant.startswith("half-"):
        return ROUNDING
    if variant.endswith("-tf32-body"):
        return (variant.split("-")[0],)
    if variant.startswith("f16-"):
        return ("f16", "bf16")
    if variant.startswith("parts-"):
        return MULTI_PASS
    if variant.startswith("f64-"):
        return ("f64",)
    if variant.startswith("x3-"):
        return ("tf32x3",)
    if variant == "chunked":
        return ("tf32", "bf16")
    return ("fma",) if variant in FMA_VARIANTS else ("tf32",)


def variant_libraries(base: attention.CudaLibrary, substitutions: dict, instances_of=None) -> dict:
    """{variant: a CudaLibrary of base's kernel whose source is base's with
    the variant's substitutions made, under _build/variants/<variant>/ with
    the shared headers beside it}. Given instances_of (variant -> the
    instances it is run on), a variant but "final" is built as one part of
    those instances alone."""
    source = base.source.read_text()
    libs = {}
    for name, subs in substitutions.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        directory = attention.BUILD_DIR / "variants" / name
        directory.mkdir(parents=True, exist_ok=True)
        (directory / base.source.name).write_text(text)
        for header in attention.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, directory / header.name)
        lib = attention.CudaLibrary(base.name, base.argtypes, base.instances, base.parts)
        lib.source = directory / base.source.name
        if instances_of and name != "final":
            lib.parts = ((instances_of(name), attention.HEAD_DIMS),)
        libs[name] = lib
    return libs


def build_and_report(libs: dict, kernel: str) -> None:
    """Builds every variant at once (one nvcc each) and prints ptxas's
    registers and spills per instance of `kernel` (a mangled-name prefix)."""
    with ThreadPoolExecutor(len(libs)) as pool:
        reports = dict(zip(libs, pool.map(lambda lib: attention.build([lib])[lib.name], libs.values())))
    for name, report in reports.items():
        instance, spill = "?", "?"
        for line in report.splitlines():
            if "Function properties for" in line:
                found = re.search(rf"\d({kernel}(?:_[a-z0-9]+)?_kernel)ILi(\d+)E(?:Lb(\d)E)?(?:Li(\d+)E)?", line)
                instance = "?" if not found else "{} D={}".format(*found.groups()[:2]) + (
                    f" rel={found.group(3)}" if found.group(3) else "") + (
                    f" keys={found.group(4)}" if found.group(4) else "")
            elif "spill stores" in line:
                spill = re.search(r"(\d+) bytes spill stores", line).group(1)
            elif "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"{name}: {instance}: {regs} registers, {spill} bytes spilled", flush=True)


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


def plain(q, k, v, bias, kw):
    return lambda mode: chip_smoke.v2_plain(q, k, v, bias, kw, mode)


def main() -> None:
    card = chip_smoke.phase_card()  # exits without a card
    only = sys.argv[1:]  # variants to run ("final" always), or all
    libs = variant_libraries(attention.REL_ATTENTION, {name: subs for name, subs in SUBSTITUTIONS.items()
                                                        if not only or name == "final" or name in only},
                             lambda name: tuple(dict.fromkeys(("tf32", *instances_of(name)))))
    build_and_report(libs, "rel_attention")

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
                        for i in instances_of(name):
                            out = attention.fused_attention_v2(q, k, v, bias, mode="ieee" if i == "fma" else i, **kw)
                            if i == "fma":
                                worst = max(worst, (out - plain(q, k, v, bias, kw)("ieee")).abs().max().item())
                            else:
                                tf32_drift = None  # a multi-pass instance's gate takes the TF32 instance's drift
                                if i in MULTI_PASS:
                                    tf32_drift = chip_smoke.rel_rms(
                                        attention.fused_attention_v2(q, k, v, bias, mode="tf32", **kw),
                                        plain(q, k, v, bias, kw)("ieee"))
                                chip_smoke.check_instance(f"{name} B={b} H={h} L={l} D={d} rel={bool(kw)} {i}", i,
                                                          out, plain(q, k, v, bias, kw), tf32_drift)
                if "fma" in instances_of(name):
                    print(f"{name}: FMA max abs err against the plain version {worst:.3e}", flush=True)
                    if not worst <= chip_smoke.KERNEL_TOL:
                        raise RuntimeError(f"{name} disagrees with the plain version: {worst}")
            for b, l in TIMED:
                q, k, v, bias, table = inputs(b, 12, l, 32, 128)
                for rel in (True, False):
                    kw = dict(rel_table=table, m=128) if rel else {}
                    key = f"B={b} L={l} {'rel' if rel else 'rel-off'}"
                    results[key] = chip_smoke.in_turns({
                        f"{name} {i}": on(lib, lambda i=i: attention.fused_attention_v2(
                            q, k, v, bias, mode="ieee" if i == "fma" else i, **kw))
                        for name, lib in libs.items() for i in instances_of(name)})
                    print(f"{key} on {card} (device ms): " + ", ".join(
                        f"{name} {ms:.4f}" for name, ms in results[key].items()), flush=True)
    finally:
        attention.REL_ATTENTION = original
    print(json.dumps({"card": card, "ms": results}))

if __name__ == "__main__":
    main()
