#!/usr/bin/env python3
"""
Design sweep of the v1 attention kernel's tensor-core instances
(foldingdiff_tpu_torch/csrc/gathered_attention.cu) on one
NVIDIA GPU: each variant is the kernel's source with one design choice
changed by a text substitution, built with nvcc (all variants at once, one
process each) into foldingdiff_tpu_torch/_build/variants/, checked against
the plain PyTorch version in each instance's mode, and timed with the final
source and the FMA instance in the same run.

Variants of the resident design (the TF32, bf16 and 16-bit instances at
L <= 128, D <= 32; timed on those five, both of its bodies: the TF32 one
and bf16's and bf16bf16's attention_half):
  final             the source as it is: one block of 16 pairs per SM, K's
                    and V's loads four n-tiles at a time, e_lr's four,
                    scores held 64 keys at a time
  load-group-1,     K's and V's loads one or two n-tiles at a time instead
  load-group-2      of four
  rel-group-8       e_lr's loads eight n-tiles at a time instead of four
  chunk-32          scores held in registers 32 keys at a time instead of
                    64 (the earlier chunks parked in shared memory)
Variants of the chunked design (the multi-pass instances everywhere, the
others at L > 128 or D = 64):
  keys-16, keys-64  chunks of 16 or 64 keys at D <= 32 (the multi-pass
                    instances)
  d64-keys-8,       chunks of 8 or 32 keys at D = 64 (checked at D = 64,
  d64-keys-32       timed on TF32 and bf16)
  parts-group-1     no interleaving: one n-tile's products at a time
  parts-group-2     the products of two n-tiles interleaved instead of four
                    (these two on the multi-pass instances)
  hide-k-strides,   K's (and e_lr's) or V's row stride hidden from the
  hide-v-strides    optimiser for every multi-pass instance, not bf16x9's
                    and TF32x3's (K) or bf16x9's (V) alone
  k-lane-offset,    K's row addresses in the split-once instances as a
  k-wide, k-ldg     per-chunk base and a 32-bit lane offset, as 64-bit
                    products, or through __ldg instead of plain loads
  v-rows            V's four row pointers a lane reads per 16 keys taken
                    once per chunk and advanced by 16 rows
Variants of the multi-pass instances' resident design (TF32x3, bf16x6 and
bf16x9, which share its groups and chunks; timed on the three):
  mp-split-at-mma   every operand split at each mma (device.cuh's
                    mma_split) instead of once: q's parts per item, e_lr's,
                    K's and V's as loaded, P's per 16 keys
  mp-chunk-32,      scores held in registers 32 keys at a time at KEYS = 128
  mp-short-chunk-64 instead of 64, or all 64 at KEYS = 64 instead of 32
  mp-rel-group-2    e_lr's loads and products two n-tiles at a time instead
                    of four
  mp-k-group-4,     K's or V's four n-tiles at a time instead of two (the
  mp-v-group-4      bf16-part instances' V at KEYS = 64 only)
  x3-chunked        TF32x3 alone: the chunked design's two passes over the
                    keys, as before the resident one (K staged in shared
                    memory does not fit beside the store and the two
                    stages: the source's note)
  bf16xN-chunked-body
                    bf16x6 and bf16x9 alone: the same for them
  bf16xN-v-group-2  bf16x6 and bf16x9 alone: V's two n-tiles at a time at
                    KEYS = 128 instead of four
Variants of the bf16 instances' resident body (attention_half: 16-bit
operands, m16n8k16; checked and timed on bf16 and bf16bf16):
  bf16-tf32-body    the TF32 instance's resident body (TF32 tensor cores on
                    bf16 values in 32-bit words) for both, as they ran
                    before attention_half
  half-bf16-rel-rounded
                    bf16's relative term rounded to bf16 in the store, as
                    bf16bf16 rounds it: a control, run on bf16 alone, that
                    must fail the bf16 gate where attention_half runs
                    (L <= 128, D <= 32; its checks there are expected to
                    fail; it is timed all the same)
Probes of what bounds the resident bodies (not checked: their outputs are
not the function; timed on tf32, the TF32 body, and on bf16 and bf16bf16,
attention_half):
  probe-no-products the loads of e_lr, K and V kept, every product dropped
                    (each loaded value added into the accumulator it fed)
  probe-no-l2       the products kept, e_lr's, K's and V's L2 bytes dropped:
                    every warp reads the same 8 rows of e_lr, 8 of K and 16
                    of V (a kilobyte or two, held in L1)
Variants of the f64 instance's resident design (DMMA; timed on it):
  f64-chunk-64      scores held in registers 64 keys at a time instead of 32
  f64-rel-group-2   e_lr's loads two n-tiles at a time instead of four
  f64-k-group-4,    K's or V's loads four n-tiles at a time instead of two
  f64-v-group-4
A variant but "final" is built as one part of the instances it is run on
(and TF32's, which every check runs first).

A substitution whose text is no longer in the source stops the run with an
error naming the variant. The inputs (q, k and v as the projections'
(B, L, H, D) views, as the denoiser hands them over), the checks
(chip_smoke.check_instance) and the timing (a CUDA graph of 50 calls, the
variants taken in turns, forwards then backwards) are chip_smoke.py's.

Prints, per variant, ptxas's register and spill report, the checks, and
device times of the variants' instances with relative scores at H = 12,
D = 32 and (B, L) = (64, 128), (64, 64), (15, 64), beside the FMA instance,
with the card's name and power limit. The last line is a JSON object of the
times.

Usage: python3 scripts/gathered_attention_variants.py [VARIANT ...]   (all by default)
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
K_PRODUCTS = "  products<A, G, D / 16>(c, a, [&](int kc, int n, uint32_t (&b)[kParts<A>][2 * kSteps<A>]) {"
K_LOAD = "*reinterpret_cast<const float4*>(base + row * st + 16 * kc + 4 * t)"
V_CHUNK = "for (int kc = 0; kc < kNT / 2; ++kc) {\n"
V_LOAD = "load_cols(x[r], v0 + dr * sl + 8 * V::kW * hb, key + dr < keys);"
# the probes' texts, in both resident bodies (rs::attention's TF32 body and attention_half)
E_COLUMNS = "tc::columns<D>(e_row, D, a.L, 8 * (nt0 + n) + g, cc, t)"
K_ROW = "*reinterpret_cast<const float4*>(kp + row * sl + 16 * cc + 4 * t)"
V_ROW = "vp + key * sl + V::kW * g + 8 * V::kW * hb"
HALF_MMA = "  mma16<A>(c, a, pack16<A>(y.x, y.y), pack16<A>(y.z, y.w));"
HALF_PV = "mma16<A>(o[V::kW * hb + dd], pa, pack16<A>("
HALF_CHUNK = "template <Arith A>\n__device__ __forceinline__ void mma_chunk("
SUBSTITUTIONS = {
    "final": [],
    "load-group-1": [("constexpr int kLoadGroup = 4;", "constexpr int kLoadGroup = 1;")],
    "load-group-2": [("constexpr int kLoadGroup = 4;", "constexpr int kLoadGroup = 2;")],
    "rel-group-8": [("constexpr int kRelGroup = 4;", "constexpr int kRelGroup = 8;")],
    "chunk-32": [("constexpr int kChunkNT = 8;", "constexpr int kChunkNT = 4;")],
    "hide-k-strides": [("constexpr bool kHideKStride = A == Arith::BF16x9 || A == Arith::TF32x3;",
                        "constexpr bool kHideKStride = kParts<A> > 1;")],
    "hide-v-strides": [("constexpr bool kHideVStride = A == Arith::BF16x9;", "constexpr bool kHideVStride = kParts<A> > 1;")],
    "k-lane-offset": [(K_PRODUCTS, "  const int st0 = kHideKStride<A> ? opaque(stride) : stride;\n"
                                   "  const float* kb = base + j0 * st0;\n"
                                   "  const int lo = g * st0 + 4 * t;\n" + K_PRODUCTS),
                      (K_LOAD, "*reinterpret_cast<const float4*>(kb + (lo + 8 * n * st0) + 16 * kc)")],
    "k-wide": [(K_LOAD, "*reinterpret_cast<const float4*>(base + static_cast<long long>(row) * st + 16 * kc + 4 * t)")],
    "k-ldg": [(K_LOAD, "__ldg(reinterpret_cast<const float4*>(base + row * st + 16 * kc + 4 * t))")],
    "v-rows": [(V_CHUNK, "const int vsl = kHideVStride<A> ? opaque(a.sl) : a.sl;\n"
                         "        const float* vr0 = vp + (j0 + 2 * t) * vsl + V::kW * g;\n"
                         "        const float* vr[4] = {vr0, vr0 + vsl, vr0 + 8 * vsl, vr0 + 9 * vsl};\n"
                         "        " + V_CHUNK),
               (V_LOAD, "load_cols(x[r], vr[r] + kc * (16 * vsl) + 8 * V::kW * hb, key + dr < keys);")],
    "keys-16": [(KEYS, KEYS.replace("? 32 :", "? 16 :"))],
    "keys-64": [(KEYS, KEYS.replace("? 32 :", "? 64 :"))],
    "d64-keys-8": [(KEYS, KEYS.replace(": 16;", ": 8;"))],
    "d64-keys-32": [(KEYS, KEYS.replace(": 16;", ": 32;"))],
    "parts-group-1": [("constexpr int kGroupMax = 4;", "constexpr int kGroupMax = 1;")],
    "parts-group-2": [("constexpr int kGroupMax = 4;", "constexpr int kGroupMax = 2;")],
    "mp-split-at-mma": [("constexpr bool kSplitOnce = kParts<A> > 1;", "constexpr bool kSplitOnce = false;")],
    "mp-chunk-32": [("constexpr int kMPChunkNT = 8;", "constexpr int kMPChunkNT = 4;")],
    "mp-short-chunk-64": [("constexpr int kMPChunkNTShort = 4;", "constexpr int kMPChunkNTShort = 8;")],
    "mp-rel-group-2": [("constexpr int kMPRelGroup = 4;", "constexpr int kMPRelGroup = 2;")],
    "mp-k-group-4": [("constexpr int kMPKGroup = 2;", "constexpr int kMPKGroup = 4;")],
    "mp-v-group-4": [("constexpr int kMPVGroup = 2;", "constexpr int kMPVGroup = 4;")],
    "x3-chunked": [("kParts<A> == 1 || A == Arith::TF32x3 || ", "kParts<A> == 1 || ")],
    "bf16xN-chunked-body": [(" || A == Arith::BF16x6 || A == Arith::BF16x9;", ";")],
    "bf16xN-v-group-2": [("constexpr int kBPVGroup = 4;", "constexpr int kBPVGroup = 2;")],
    "bf16-tf32-body": [("constexpr bool kHalfBody = A == Arith::BF16 || A == Arith::BF16BF16;",
                        "constexpr bool kHalfBody = false;")],
    "half-bf16-rel-rounded": [("make_float2(output<A>(qe[0]), output<A>(qe[1]))",
                               "make_float2(bf16_value(qe[0]), bf16_value(qe[1]))"),
                              ("make_float2(output<A>(qe[2]), output<A>(qe[3]))",
                               "make_float2(bf16_value(qe[2]), bf16_value(qe[3]))")],
    "probe-no-products": [
        ("mma_split<A>(acc, qr[2 * cc], held<A>(y[n][cc].x), held<A>(y[n][cc].y));",
         "acc[0] += y[n][cc].x, acc[1] += y[n][cc].y;"),
        ("mma_split<A>(acc, qr[2 * cc + 1], held<A>(y[n][cc].z), held<A>(y[n][cc].w));",
         "acc[2] += y[n][cc].z, acc[3] += y[n][cc].w;"),
        ("mma_split<A>(s[n0 + n], qf[2 * cc], held<A>(y[n][cc].x), held<A>(y[n][cc].y));",
         "s[n0 + n][0] += y[n][cc].x, s[n0 + n][1] += y[n][cc].y;"),
        ("mma_split<A>(s[n0 + n], qf[2 * cc + 1], held<A>(y[n][cc].z), held<A>(y[n][cc].w));",
         "s[n0 + n][2] += y[n][cc].z, s[n0 + n][3] += y[n][cc].w;"),
        ("mma_split<A>(o[V::kW * hb + dd], pa, held<A>(x[n][0][hb][dd]), held<A>(x[n][1][hb][dd]));",
         "o[V::kW * hb + dd][0] += x[n][0][hb][dd] * p[0], o[V::kW * hb + dd][2] += x[n][1][hb][dd] * p[2];"),
        (HALF_MMA, "  c[0] += y.x, c[1] += y.y, c[2] += y.z, c[3] += y.w;"),
        (HALF_CHUNK, "__device__ __forceinline__ void probe_add(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, "
                     "uint32_t b1) {\n  c[0] += __uint_as_float(b0 ^ a[0]), c[2] += __uint_as_float(b1 ^ a[1]);\n}\n"
                     + HALF_CHUNK),
        (HALF_PV, "probe_add(o[V::kW * hb + dd], pa, pack16<A>(")],
    "probe-no-l2": [(E_COLUMNS, "tc::columns<D>(a.e_lr, D, a.L, g, cc, t)"),
                    (K_ROW, "*reinterpret_cast<const float4*>(a.k + g * sl + 16 * cc + 4 * t)"),
                    (V_ROW, "a.v + (key & 15) * sl + V::kW * g + 8 * V::kW * hb")],
    "f64-chunk-64": [("constexpr int kF64ChunkNT = 4;", "constexpr int kF64ChunkNT = 8;")],
    "f64-rel-group-2": [("constexpr int kF64RelGroup = 4;", "constexpr int kF64RelGroup = 2;")],
    "f64-k-group-4": [("constexpr int kF64KGroup = 2;", "constexpr int kF64KGroup = 4;")],
    "f64-v-group-4": [("constexpr int kF64VGroup = 2;", "constexpr int kF64VGroup = 4;")],
}
RESIDENT = ("tf32", "bf16", "f16", "f16f16", "bf16bf16")
MULTI_PASS = ("tf32x3", "bf16x3", "bf16x6", "bf16x9")
HALF = ("bf16", "bf16bf16")  # attention_half's instances
# variants whose checks must fail (controls of a gate), by instance
MUST_FAIL = {"half-bf16-rel-rounded": ("bf16",)}


def modes_of(variant: str) -> tuple:
    """The instances a variant changes, and so is checked and timed on."""
    if variant == "final":
        return (*RESIDENT, *MULTI_PASS, "f64")
    if variant.startswith("f64-"):
        return ("f64",)
    if variant in MUST_FAIL:
        return MUST_FAIL[variant]
    if variant == "bf16-tf32-body":
        return HALF
    if variant.startswith("probe-"):
        return ("tf32", *HALF)
    if variant.startswith("x3-"):
        return ("tf32x3",)
    if variant.startswith("bf16xN-"):
        return ("bf16x6", "bf16x9")
    if variant.startswith("mp-"):
        return ("tf32x3", "bf16x6", "bf16x9")
    if variant.startswith(("parts-", "keys-", "hide-", "k-", "v-")):
        return MULTI_PASS
    return ("tf32", "bf16") if variant.startswith("d64-") else RESIDENT


TIMED = [(64, 128), (64, 64), (15, 64)]  # (B, L) at H = 12, D = 32, M = 128
CHECKED = [(64, 12, 128, 32, 128), (15, 12, 64, 32, 128), (16, 6, 33, 16, 64), (3, 5, 99, 64, 128),
           (5, 7, 65, 32, 128), (1, 2, 1000, 32, 1000)]


def on(lib, fn):
    """fn run with `lib` as the v1 kernel's library."""
    def run():
        attention.GATHERED_ATTENTION = lib
        return fn()
    return run


def projection_views(q, k, v) -> list:
    """q, k, v (B, H, L, D) as the denoiser hands them over: views of
    (B, L, H, D) storage."""
    return [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]


def plain(q, k, v, bias, e_lr):
    return lambda mode: chip_smoke.in_mode(mode, lambda: attention.fused_attention_reference(
        q, k, v, bias, e_lr, mode=mode))


def main() -> None:
    card = chip_smoke.phase_card()  # exits without a card
    only = sys.argv[1:]  # variants to run ("final" always), or all
    libs = variant_libraries(attention.GATHERED_ATTENTION, {name: subs for name, subs in SUBSTITUTIONS.items()
                                                             if not only or name == "final" or name in only},
                             lambda name: tuple(dict.fromkeys(("tf32", *modes_of(name)))))
    build_and_report(libs, "gathered_attention")

    results = {}
    original = attention.GATHERED_ATTENTION
    try:
        with torch.inference_mode():
            for name, lib in libs.items():
                attention.GATHERED_ATTENTION = lib
                if name.startswith("probe-"):
                    continue  # a probe's output is not the function
                for b, h, l, d, m in CHECKED:
                    q, k, v, bias, table = chip_smoke.attention_inputs(b, h, l, d, m, seed=l + d)
                    views = projection_views(q, k, v)
                    e_lr = chip_smoke.gathered(table, l, m, permuted=True)
                    tf32_drift = None
                    for mode in dict.fromkeys(("tf32", *modes_of(name))):  # TF32 first: the multi-pass gates take its drift
                        tag = f"{name} B={b} H={h} L={l} D={d} {mode}"
                        out = attention.fused_attention(*views, bias, e_lr, mode=mode)
                        if mode in MUST_FAIL.get(name, ()) and l <= 128 and d <= 32:  # where attention_half runs
                            ok, reading, _, _ = chip_smoke.instance_reading(mode, out, plain(q, k, v, bias, e_lr),
                                                                            None, chip_smoke.BF16_SHARE)
                            print(f"{tag} (a control: must fail): {reading}", flush=True)
                            if ok:
                                raise RuntimeError(f"{tag}: the control passes the {mode} gate")
                            continue
                        _, drift = chip_smoke.check_instance(tag, mode, out, plain(q, k, v, bias, e_lr), tf32_drift)
                        tf32_drift = drift if mode == "tf32" else tf32_drift
            for b, l in TIMED:
                q, k, v, bias, table = chip_smoke.attention_inputs(b, 12, l, 32, 128, chip_smoke.SEED)
                views = projection_views(q, k, v)
                e_lr = chip_smoke.gathered(table, l, 128, permuted=False)
                fns = {"fma": lambda: attention.fused_attention(*views, bias, e_lr, mode="ieee")}
                for name, lib in libs.items():
                    for mode in modes_of(name):
                        fns[f"{name} {mode}"] = on(lib, lambda mode=mode: attention.fused_attention(
                            *views, bias, e_lr, mode=mode))
                key = f"B={b} L={l} rel"
                results[key] = chip_smoke.in_turns({n: on(original, f) if n == "fma" else f
                                                    for n, f in fns.items()})
                print(f"{key} on {card} (device ms): " + ", ".join(
                    f"{name} {ms:.4f}" for name, ms in results[key].items()), flush=True)
    finally:
        attention.GATHERED_ATTENTION = original
    print(json.dumps({"card": card, "ms": results}))


if __name__ == "__main__":
    main()
