"""
The matmul precision of a model: `ModelConfig.matmul_precision` read as the
JAX models read it, which run their forward under
`jax.default_matmul_precision(cfg.matmul_precision)` unless it is "default"
(and so their backward: JAX's transposes keep each dot's precision).

models/config.py's docstring maps each name onto a mode of this module:
"caller", "ieee", "tf32" or "bf16"; any other name is a ValueError
(mode_of).

- "caller" ("default") enters no scope: the model's GEMMs run at the
  caller's torch.backends.cuda.matmul.fp32_precision, as a JAX model at
  "default" runs at its caller's default_matmul_precision. The port's
  command-line programs set TF32 for the process (set_process_default), as
  XLA:GPU computes float32 dots by default.
- "tf32" and "ieee" set cuBLAS's float32 GEMMs through fp32_precision while
  the model runs (matmul_precision), the caller's value restored after.
  Only the new API is used: once fp32_precision is "tf32", reading the
  legacy allow_tf32 raises in torch.
- "bf16" runs every GEMM of the model on bf16 operands with float32
  products, sums and output (linear, bf16_einsum), forward and backward,
  where the cotangent is rounded to bf16 as well, as JAX's transposes of
  such a dot take bf16 operands. Its GEMMs are float32 GEMMs of the
  bf16-rounded values under TF32: TF32 holds bf16's 8 bits, and each product
  of two bf16 values is exact in float32, so the card and the CPU compute
  the same products and differ only in the order of the float32 sums.
- The attention kernels (csrc/) compute their products in the model's mode
  as well (kernel_mode): float32 FMA under "ieee", TF32 tensor cores under
  "tf32" (and "caller" under a caller's TF32), bf16 values on TF32 tensor
  cores under "bf16". Their plain versions take bf16 operands under "bf16".
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
}


def mode_of(matmul_precision: str) -> str:
    """The port's mode ("caller", "ieee", "tf32" or "bf16") of a
    matmul_precision; ValueError for a name the port does not run, never a
    silent float32."""
    try:
        return MODES[matmul_precision]
    except (KeyError, TypeError):
        raise ValueError(f"matmul_precision {matmul_precision!r} is not one the port runs; "
                         f"supported: {', '.join(MODES)}") from None


def kernel_mode(mode: str) -> str:
    """The arithmetic of the attention kernels' products under a model's
    mode: "ieee", "tf32" or "bf16". "caller" takes the caller's setting at
    the call (or at a CUDA graph's capture): "tf32" where the float32 GEMMs
    that cuBLAS runs then would be TF32 (torch.backends.cuda.matmul.
    fp32_precision "tf32", or "none" under torch.backends.fp32_precision
    "tf32"), else "ieee". ValueError for any other mode."""
    if mode == "caller":
        setting = torch.backends.cuda.matmul.fp32_precision
        if setting == "none":
            setting = torch.backends.fp32_precision
        return "tf32" if setting == "tf32" else "ieee"
    if mode not in ("ieee", "tf32", "bf16"):
        raise ValueError(f"mode {mode!r} is not one of the port's: caller, ieee, tf32, bf16")
    return mode


def set_process_default() -> None:
    """TF32 for the process's float32 GEMMs on the card, where a "default"
    model runs them: XLA:GPU's default. For a program's entry, not a
    library call."""
    torch.backends.cuda.matmul.fp32_precision = "tf32"


@contextlib.contextmanager
def matmul_precision(mode: str) -> Iterator[None]:
    """cuBLAS's float32 GEMMs in IEEE float32 ("ieee") or on TF32 tensor
    cores ("tf32", and "bf16", whose GEMMs take bf16 values) while the block
    runs, the caller's fp32_precision restored after, also on an exception;
    "caller" leaves the caller's setting in place."""
    if mode == "caller":
        yield
        return
    matmul = torch.backends.cuda.matmul
    before = matmul.fp32_precision
    matmul.fp32_precision = "ieee" if mode == "ieee" else "tf32"
    try:
        yield
    finally:
        matmul.fp32_precision = before


def _to_bf16_values(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


class _RoundOperand(torch.autograd.Function):
    """The bf16 rounding of a product's operand; its gradient passes as it
    is (the product's backward already took bf16 operands)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return _to_bf16_values(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad


class _RoundCotangent(torch.autograd.Function):
    """The identity on a product's output, whose cotangent is rounded to
    bf16: the bf16 operand of both backward products."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return _to_bf16_values(grad)


def bf16_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.einsum(eq, a, b) at BF16_BF16_F32: bf16 operands, float32
    products, sums and output; the backward's products on bf16 operands."""
    return _RoundCotangent.apply(torch.einsum(eq, _RoundOperand.apply(a), _RoundOperand.apply(b)))


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, mode: str) -> torch.Tensor:
    """F.linear(x, weight, bias) in a model's mode: under "bf16" the product
    at BF16_BF16_F32 (bf16_einsum), the bias added in float32; else
    F.linear, whose float32 GEMM follows the matmul_precision scope."""
    if mode != "bf16":
        return F.linear(x, weight, bias)
    out = _RoundCotangent.apply(F.linear(_RoundOperand.apply(x), _RoundOperand.apply(weight)))
    return out if bias is None else out + bias


class Linear(nn.Linear):
    """nn.Linear (the same parameters and state-dict names) whose product
    runs in a model's mode (linear)."""

    def __init__(self, in_features: int, out_features: int, mode: str) -> None:
        super().__init__(in_features, out_features)
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.mode)
