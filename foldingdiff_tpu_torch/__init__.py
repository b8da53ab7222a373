"""
foldingdiff_tpu_torch: the PyTorch/CUDA port of `foldingdiff_tpu`.

The module layout mirrors the JAX package, so each module's counterpart sits
at the same path (`models/bert.py`, `diffusion/sampling.py`, ...). The port
imports `torch` and never `jax`; the JAX package stays the reference that the
tests (`tests/test_torch_*.py`) hold it against.

The relative_key attention that the JAX package wrote as a Pallas TPU kernel
(`foldingdiff_tpu/ops/pallas_attention.py`) is a hand-written CUDA kernel here
(`csrc/rel_attention.cu`), built with nvcc on first use; see `ops/attention.py`.
"""

__version__ = "0.1.0"
