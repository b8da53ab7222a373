"""Diffusion training (counterpart of foldingdiff_tpu/training/)."""
