"""
Plain PyTorch references of what the benchmark's cells time: the denoiser's
forward pass, the DDPM chain's arithmetic, and the training step's loss,
clip and AdamW. They import nothing of the program (foldingdiff_tpu_torch)
and nothing of JAX, and are written from
the published model (microsoft/foldingdiff, modelling.py and sampling.py,
HF BertEncoder): every GEMM runs in the precision the caller sets, which
the checks set to IEEE float32.
"""
