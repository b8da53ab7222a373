#!/usr/bin/env python3
"""
The two forms of a multi-pass preset's GEMM on one NVIDIA GPU, at the
flagship's dense layers (B * L = 64 x 128 tokens; 384 -> 384, 384 -> 768,
768 -> 384), forward and backward, each in turns with the other:

- "concatenated" (the port's, precision.linear): one TF32 GEMM per dot,
  its operands the parts concatenated along the contracted dimension;
- "per product": one TF32 GEMM per listed product of parts, the outputs
  summed in float32, the small terms first.

Both compute the same products (checked here against each other, 1e-5 of
the largest output), so only the time differs. Beside them the plain
float32 GEMM under TF32 and under IEEE float32. Device ms per call by CUDA
events over 20 calls (forward, and forward with both gradients), the mean
of two runs taken in turns. Prints one line per shape and mode, and last a
JSON object of every time with the card's name and power limit.

Usage: python3 scripts/split_gemm_forms.py
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from foldingdiff_tpu_torch import precision  # noqa: E402

TOKENS = 64 * 128
SHAPES = [(384, 384), (384, 768), (768, 384)]  # (in, out) of the flagship's dense layers
MODES = ("tf32x3", "bf16x3", "bf16x6", "bf16x9")


class _PerProduct(torch.autograd.Function):
    """x @ w.T in a SPLITS mode as one GEMM per listed product of parts."""

    @staticmethod
    def forward(ctx, x, w, mode):
        ctx.save_for_backward(x, w)
        ctx.mode = mode
        return _products(x, w.t(), mode)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        return _products(grad, w, ctx.mode), _products(grad.t(), x, ctx.mode), None


def _products(a, b, mode):
    a_parts, b_parts = precision.parts(a, mode), precision.parts(b, mode)
    out = None
    for i, j in precision.SPLITS[mode][2]:
        term = a_parts[i] @ b_parts[j]
        out = term if out is None else out + term
    return out


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("split_gemm_forms: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for k, n in SHAPES:
        x = torch.randn(TOKENS, k, generator=g, device="cuda", requires_grad=True)
        w = torch.randn(n, k, generator=g, device="cuda", requires_grad=True)
        grad = torch.randn(TOKENS, n, generator=g, device="cuda")

        def step(fn, backward):
            def run():
                out = fn()
                if backward:
                    torch.autograd.grad(out, (x, w), grad)
            return run

        forms = {"tf32": lambda: torch.nn.functional.linear(x, w), "ieee": lambda: torch.nn.functional.linear(x, w)}
        for mode in MODES:
            with precision.matmul_precision(mode):
                concatenated = precision.linear(x, w, None, mode)
                per_product = _PerProduct.apply(x, w, mode)
            err = (concatenated - per_product).abs().max().item()
            if not err <= 1e-5 * per_product.abs().max().item():
                raise RuntimeError(f"{mode} {k} -> {n}: the two forms differ by {err}")
            forms[f"{mode} concatenated"] = lambda mode=mode: precision.linear(x, w, None, mode)
            forms[f"{mode} per product"] = lambda mode=mode: _PerProduct.apply(x, w, mode)
        for backward in (False, True):
            times = {name: [] for name in forms}
            for order in (list(forms), list(reversed(forms))):
                for name in order:
                    scope = "ieee" if name == "ieee" else name.split()[0]
                    with precision.matmul_precision(scope):
                        times[name].append(cuda_ms(step(forms[name], backward)))
            what = "forward and backward" if backward else "forward"
            for name, t in times.items():
                results[f"{k}->{n} {what} {name}"] = sum(t) / 2
                print(f"{TOKENS} x {k} -> {n}, {what}, {name}: {sum(t) / 2:.4f} ms ({t[0]:.4f}, {t[1]:.4f})",
                      flush=True)
    print(json.dumps({"card": card, "ms": results}))


if __name__ == "__main__":
    main()
