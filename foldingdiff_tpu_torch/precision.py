"""
The matmul precision of a model: `ModelConfig.matmul_precision` read as the
JAX models read it, which run their forward under
`jax.default_matmul_precision(cfg.matmul_precision)` unless it is "default"
(and so their backward: JAX's transposes keep each dot's precision).

models/config.py's docstring maps each name onto a mode of this module:
"caller", "ieee", "tf32", "bf16", one of the multi-pass float32 modes
"tf32x3", "bf16x3", "bf16x6" and "bf16x9", "f64", or one of the 16-bit modes
"f16", "f16f16" and "bf16bf16"; any other name (the four ANY_F8_* presets,
which JAX refuses for float32 operands, and unknown strings) is a
ValueError (mode_of).

- "caller" ("default") enters no scope: the model's GEMMs run at the
  caller's torch.backends.cuda.matmul.fp32_precision, as a JAX model at
  "default" runs at its caller's default_matmul_precision. The port's
  command-line programs set TF32 for the process (set_process_default), as
  XLA:GPU computes float32 dots by default.
- "tf32" and "ieee" set cuBLAS's float32 GEMMs through fp32_precision while
  the model runs (matmul_precision), the caller's value restored after.
  Only the new API is used: once fp32_precision is "tf32", reading the
  legacy allow_tf32 raises in torch.
- "bf16", the 16-bit modes and the multi-pass modes (SPLITS) run every GEMM
  of the model as JAX's DotAlgorithmPreset defines it: each float32 operand
  x is split into parts, x0 = r(x), x1 = r(x - x0) and x2 = r(x - x0 - x1),
  each rounded by r to bf16 or f16 (to nearest even; an f16 value past
  65504 becomes an infinity, as a cast to f16 gives) or to TF32 (to
  nearest, ties away from zero, as cvt.rna.tf32.f32), and a fixed list of
  products of parts is summed in float32, the small terms first; the
  F16_F16_F16 and BF16_BF16_BF16 presets then round the dot's output once,
  to f16 or bf16 (OUTPUT_ROUNDING), in float32 storage:

  | mode | preset | r | parts | products | output |
  | --- | --- | --- | --- | --- | --- |
  | "bf16" | BF16_BF16_F32 | bf16 | x0 | a0.b0 | float32 |
  | "f16" | F16_F16_F32 | f16 | x0 | a0.b0 | float32 |
  | "f16f16" | F16_F16_F16 | f16 | x0 | a0.b0 | rounded to f16 |
  | "bf16bf16" | BF16_BF16_BF16 | bf16 | x0 | a0.b0 | rounded to bf16 |
  | "tf32x3" | TF32_TF32_F32_X3 | TF32 | x0, x1 | a1.b0 + a0.b1 + a0.b0 | float32 |
  | "bf16x3" | BF16_BF16_F32_X3 | bf16 | x0, x1 | the same | float32 |
  | "bf16x6" | BF16_BF16_F32_X6 | bf16 | x0, x1, x2 | the six with i + j <= 2 | float32 |
  | "bf16x9" | BF16_BF16_F32_X9 | bf16 | x0, x1, x2 | all nine | float32 |

  (einsum, linear), forward and backward: the backward's products split
  the cotangent and the other operand the same way, and round each
  gradient's output as the forward's, as JAX's transposes of such a dot
  keep its preset. Every subtraction above is exact in float32, and so is
  every product of two parts (TF32 and f16 keep 11 significant bits, bf16
  8; f16's subnormals are float32 normals), so the GEMMs run as float32
  GEMMs of the parts under TF32, which holds each such value exactly: the
  card and the CPU compute the same products and differ only in the order
  of the float32 sums. No GEMM of the port takes float16 tensors, so
  cuBLAS's reduced-precision f16 reductions
  (allow_fp16_reduced_precision_reduction) never apply. All the products
  of a dot are one GEMM, its operands the parts concatenated along a
  contracted dimension, the small terms first (_product).
- The reading of F16_F16_F16 and BF16_BF16_BF16, whose preset names a
  16-bit accumulation: the products of the 16-bit values are summed in
  float32 and the dot's result is rounded once to the 16-bit type. XLA:CPU
  computes F16_F16_F16 so (equal at 99.8% of a 64 x 512 . 512 x 32 dot's
  elements, the rest within one f16 step or float32's reordering of the
  sum; a sum rounded to f16 at every add disagrees at most elements), the
  dot that JAX lowers for a GPU has an f16 or bf16 result type, and tensor
  cores have no bf16 accumulator. No rounding after every add is emulated.
- "f64" (F64_F64_F64) casts both operands to float64, runs the GEMM there
  (on the H100's FP64 tensor cores through cuBLAS) and casts its output to
  float32, forward and backward (the cotangent with it): a plain dense
  product, which the JAX package too computes outside any Pallas kernel.
- The attention kernels (csrc/) compute their products in the model's mode
  as well (kernel_mode): float32 FMA under "ieee", TF32 tensor cores under
  "tf32" (and "caller" under a caller's TF32), the parts' products of
  "bf16", "tf32x3" and the 16-bit modes on TF32 tensor cores (the output
  roundings applied to each dot's output), of the bf16 multi-pass modes on
  bf16 tensor cores, and float64 FMA under "f64". Their plain versions take
  the same products (einsum).
- The CPU's GEMMs do not read the CUDA setting: "caller", "tf32" and "ieee"
  give the same numbers there.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn

# matmul_precision -> mode; every other name of JAX's enum raises (mode_of)
MODES = {
    "default": "caller",
    "bfloat16": "tf32", "high": "tf32", "tensorfloat32": "tf32", "TF32_TF32_F32": "tf32",
    "highest": "ieee", "float32": "ieee", "F32_F32_F32": "ieee",
    "BF16_BF16_F32": "bf16",
    "TF32_TF32_F32_X3": "tf32x3",
    "BF16_BF16_F32_X3": "bf16x3", "BF16_BF16_F32_X6": "bf16x6", "BF16_BF16_F32_X9": "bf16x9",
    "F64_F64_F64": "f64",
    "F16_F16_F32": "f16", "F16_F16_F16": "f16f16", "BF16_BF16_BF16": "bf16bf16",
}
# mode -> (the rounding r of a part, the parts of an operand, the products
# (i, j) of part i of the first operand and part j of the second, smallest first)
_X3 = ((1, 0), (0, 1), (0, 0))
SPLITS = {
    "bf16": ("bf16", 1, ((0, 0),)),
    "tf32x3": ("tf32", 2, _X3),
    "bf16x3": ("bf16", 2, _X3),
    "bf16x6": ("bf16", 3, ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))),
    "bf16x9": ("bf16", 3, ((2, 2), (2, 1), (1, 2), (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))),
    "f16": ("f16", 1, ((0, 0),)),
    "f16f16": ("f16", 1, ((0, 0),)),
    "bf16bf16": ("bf16", 1, ((0, 0),)),
}
# mode -> the rounding of each product's output (the F16_F16_F16 and
# BF16_BF16_BF16 presets: f32 sums, the result rounded once)
OUTPUT_ROUNDING = {"f16f16": "f16", "bf16bf16": "bf16"}
# the arithmetics of the attention kernels' products (kernel_mode), in the
# order of their instances (ops/attention.py's INSTANCES)
KERNEL_MODES = ("ieee", "tf32", "bf16", "tf32x3", "bf16x3", "bf16x6", "bf16x9", "f64", "f16", "f16f16", "bf16bf16")
# the modes whose products this module computes itself (einsum, linear);
# the rest are torch's float32 GEMMs under the matmul_precision scope
OWN_PRODUCTS = (*SPLITS, "f64")


def mode_of(matmul_precision: str) -> str:
    """The port's mode ("caller" or one of KERNEL_MODES) of a
    matmul_precision; ValueError for a name the port does not run, never a
    silent float32."""
    try:
        return MODES[matmul_precision]
    except (KeyError, TypeError):
        raise ValueError(f"matmul_precision {matmul_precision!r} is not one the port runs; "
                         f"supported: {', '.join(MODES)}") from None


def kernel_mode(mode: str) -> str:
    """The arithmetic of the attention kernels' products under a model's
    mode: one of KERNEL_MODES, the mode itself. "caller" takes the caller's
    setting at the call (or at a CUDA graph's capture): "tf32" where the
    float32 GEMMs that cuBLAS runs then would be TF32 (torch.backends.cuda.
    matmul.fp32_precision "tf32", or "none" under torch.backends.
    fp32_precision "tf32"), else "ieee". ValueError for any other mode."""
    if mode == "caller":
        setting = torch.backends.cuda.matmul.fp32_precision
        if setting == "none":
            setting = torch.backends.fp32_precision
        return "tf32" if setting == "tf32" else "ieee"
    if mode not in KERNEL_MODES:
        raise ValueError(f"mode {mode!r} is not one of the port's: caller, {', '.join(KERNEL_MODES)}")
    return mode


def set_process_default() -> None:
    """TF32 for the process's float32 GEMMs on the card, where a "default"
    model runs them: XLA:GPU's default. For a program's entry, not a
    library call."""
    torch.backends.cuda.matmul.fp32_precision = "tf32"


@contextlib.contextmanager
def matmul_precision(mode: str) -> Iterator[None]:
    """cuBLAS's float32 GEMMs in IEEE float32 ("ieee", and "f64", whose
    GEMMs are float64 ones) or on TF32 tensor cores ("tf32", and the SPLITS
    modes, whose GEMMs take parts that TF32 holds exactly: bf16, f16 or
    TF32 values) while the block runs, the caller's fp32_precision restored
    after, also on an exception; "caller" leaves the caller's setting in
    place."""
    if mode == "caller":
        yield
        return
    matmul = torch.backends.cuda.matmul
    before = matmul.fp32_precision
    matmul.fp32_precision = "ieee" if mode in ("ieee", "f64") else "tf32"
    try:
        yield
    finally:
        matmul.fp32_precision = before


def _to_bf16_values(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _to_f16_values(t: torch.Tensor) -> torch.Tensor:
    """f16's rounding (to nearest even; past 65504 an infinity, f16's
    subnormals kept) as float32 values, which TF32 holds exactly."""
    return t.to(torch.float16).to(t.dtype)


def to_tf32_values(t: torch.Tensor) -> torch.Tensor:
    """The TF32 rounding of a float32 tensor as cvt.rna.tf32.f32 computes it
    (10 stored significand bits, to nearest, ties away from zero), as
    float32 values: two integer operations on the int32 view, since torch has
    no TF32 dtype, the same as the attention kernels' multi-pass parts
    (csrc/device.cuh, round_part). Infinities and the NaN that arithmetic
    makes pass as they are; a NaN whose payload lies in the 13 low bits
    alone would become an infinity."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


# a part's rounding (SPLITS) or an output's (OUTPUT_ROUNDING) -> its function
ROUNDINGS = {"bf16": _to_bf16_values, "f16": _to_f16_values, "tf32": to_tf32_values}


def parts(x: torch.Tensor, mode: str) -> list[torch.Tensor]:
    """The parts x0, x1, ... of a float32 operand in a SPLITS mode: x0 =
    r(x), x1 = r(x - x0), x2 = r(x - x0 - x1), every subtraction exact."""
    rounding, n, _ = SPLITS[mode]
    r = ROUNDINGS[rounding]
    out = [r(x)]
    for _ in range(n - 1):
        x = x - out[-1]
        out.append(r(x))
    return out


def round_output(t: torch.Tensor, mode: str) -> torch.Tensor:
    """A product's output as the mode leaves it: rounded once to f16 or bf16
    values under "f16f16" and "bf16bf16" (OUTPUT_ROUNDING), else as it is."""
    rounding = OUTPUT_ROUNDING.get(mode)
    return ROUNDINGS[rounding](t) if rounding else t


def _product(eq: str, a_parts, b_parts, mode: str, rounded: bool = True) -> torch.Tensor:
    """torch.einsum(eq) summed over the mode's products (i, j) of
    a_parts[i] and b_parts[j], as one einsum: the parts concatenated along
    a contracted index, the products in their order (the small terms
    first); the output rounded as the mode says (round_output) if `rounded`."""
    products = SPLITS[mode][2]
    (sa, sb), so = eq.split("->")[0].split(","), eq.split("->")[1]
    if len(products) == 1:
        (i, j), = products
        out = torch.einsum(eq, a_parts[i], b_parts[j])
    else:
        c = next(x for x in sa if x in sb and x not in so)
        out = torch.einsum(eq, torch.cat([a_parts[i] for i, _ in products], dim=sa.index(c)),
                           torch.cat([b_parts[j] for _, j in products], dim=sb.index(c)))
    return round_output(out, mode) if rounded else out


def _backward_equations(eq: str) -> tuple[str, str]:
    """The einsums of the gradients of torch.einsum(eq, a, b): the
    cotangent with b, and a with the cotangent."""
    (sa, sb), so = eq.split("->")[0].split(","), eq.split("->")[1]
    return f"{so},{sb}->{sa}", f"{sa},{so}->{sb}"


class _SplitProduct(torch.autograd.Function):
    """torch.einsum(eq, a, b) (two operands, at least one contracted index)
    in a SPLITS mode: the listed products of the operands' parts, the
    output rounded as the mode says. Its backward runs the split products
    of the cotangent with the other operand, once per operand, each
    gradient rounded as the output, as JAX's transposes of such a dot do (a
    straight-through gradient per part would count the cotangent once per
    product). With `rounded` off, the forward's output is left unrounded
    (a partial sum that its caller rounds once summed); the gradients,
    whole on each rank, are rounded all the same."""

    @staticmethod
    def forward(ctx, eq: str, a: torch.Tensor, b: torch.Tensor, mode: str, rounded: bool) -> torch.Tensor:
        a_parts, b_parts = parts(a, mode), parts(b, mode)
        ctx.eq, ctx.mode = eq, mode
        ctx.save_for_backward(*a_parts, *b_parts)
        return _product(eq, a_parts, b_parts, mode, rounded)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        n = SPLITS[ctx.mode][1]
        saved = ctx.saved_tensors
        a_parts, b_parts, g_parts = saved[:n], saved[n:], parts(grad, ctx.mode)
        eq_a, eq_b = _backward_equations(ctx.eq)
        grad_a = _product(eq_a, g_parts, b_parts, ctx.mode) if ctx.needs_input_grad[1] else None
        grad_b = _product(eq_b, a_parts, g_parts, ctx.mode) if ctx.needs_input_grad[2] else None
        return None, grad_a, grad_b, None, None


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor, mode: str, rounded: bool = True) -> torch.Tensor:
    """torch.einsum(eq, a, b) in a model's mode: in a SPLITS mode the
    preset's products of the operands' parts (float32 output, rounded under
    "f16f16" and "bf16bf16" unless `rounded` is off), under "f64" the
    float64 product, forward and backward (autograd casts the cotangent to
    float64 and each gradient back); else torch.einsum, whose float32 GEMM
    follows the matmul_precision scope."""
    if mode == "f64":
        return torch.einsum(eq, a.double(), b.double()).to(a.dtype)
    if mode not in SPLITS:
        return torch.einsum(eq, a, b)
    return _SplitProduct.apply(eq, a, b, mode, rounded)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, mode: str,
           rounded: bool = True) -> torch.Tensor:
    """F.linear(x, weight, bias) in a model's mode: in a SPLITS mode and
    under "f64" the product as einsum computes it (`rounded` as there), the
    bias added in float32 after it (as flax's Dense adds it after its dot);
    else F.linear, whose float32 GEMM follows the matmul_precision scope."""
    if mode not in OWN_PRODUCTS:
        return F.linear(x, weight, bias)
    out = einsum("mk,nk->mn", x.reshape(-1, x.shape[-1]), weight, mode, rounded)
    out = out.reshape(*x.shape[:-1], weight.shape[0])
    return out if bias is None else out + bias


class Linear(nn.Linear):
    """nn.Linear (the same parameters and state-dict names) whose product
    runs in a model's mode (linear)."""

    def __init__(self, in_features: int, out_features: int, mode: str) -> None:
        super().__init__(in_features, out_features)
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.mode)
