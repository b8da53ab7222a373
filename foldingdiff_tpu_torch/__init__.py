"""
foldingdiff_tpu_torch: the PyTorch/CUDA port of `foldingdiff_tpu`.

The module layout mirrors the JAX package, so each module's counterpart sits
at the same path (`models/bert.py`, `diffusion/sampling.py`, ...). The port
imports `torch` and never `jax`, and nothing of the JAX package: it keeps its
own copies of what it needs (`data/feature_sets.py`). The JAX package stays
the reference that the tests (`tests/test_torch_*.py`) hold it against. Its
entry points run on the card unless the caller asks for the CPU
(`devices.require_device`).

The fused attention that the JAX package wrote as Pallas TPU kernels
(`foldingdiff_tpu/ops/pallas_attention.py`, entries v2 and v1) is two
hand-written CUDA kernels here (`csrc/rel_attention.cu`,
`csrc/gathered_attention.cu`), built with nvcc on first use; see
`ops/attention.py`.
"""

__version__ = "0.1.0"
