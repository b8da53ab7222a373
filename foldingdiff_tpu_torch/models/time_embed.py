"""
Time-step encoders and the sequence positional encoding (counterpart of
foldingdiff_tpu/models/time_embed.py).

The Gaussian Fourier weight `W` is a fixed, non-trainable buffer
(reference modelling.py:55-57): it is loaded with the checkpoint and never
redrawn, and it is part of the state dict under `time_embed.W`.
"""
from __future__ import annotations

import math

import torch
from torch import nn


class GaussianFourierProjection(nn.Module):
    """embed(t) = [sin(2*pi*t*W), cos(2*pi*t*W)], W ~ N(0, scale^2) fixed.

    The 2*pi enters twice, as in the reference: once in W's scale at init,
    once in the forward pass.
    """

    def __init__(self, embed_dim: int, scale: float = 2 * math.pi):
        super().__init__()
        self.register_buffer("W", torch.randn(embed_dim // 2) * scale)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t.reshape(-1).to(torch.float32)
        x_proj = t[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class SinusoidalPositionEmbeddings(nn.Module):
    """Standard transformer sinusoidal embedding over the timestep."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.embed_dim = embed_dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half_dim = self.embed_dim // 2
        freqs = torch.exp(
            torch.arange(half_dim, dtype=torch.float32, device=t.device)
            * -(math.log(10000.0) / (half_dim - 1))
        )
        t = t.reshape(-1).to(torch.float32)
        args = t[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class PositionalEncoding(nn.Module):
    """Classic sin/cos positional encoding over sequence positions, then
    dropout (reference modelling.py:96-129; the main model does not use it
    there either). `pe` is a (max_len, d_model) float32 buffer."""

    def __init__(self, d_model: int, dropout: float = 0.1, max_len: int = 5000):
        super().__init__()
        position = torch.arange(max_len, dtype=torch.float32)[:, None]
        div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32) * (-math.log(10000.0) / d_model))
        pe = torch.zeros(max_len, d_model)
        pe[:, 0::2] = torch.sin(position * div_term)
        pe[:, 1::2] = torch.cos(position * div_term)
        self.register_buffer("pe", pe)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 3:
            raise ValueError(f"expected (B, L, D), got {tuple(x.shape)}")
        return self.dropout(x + self.pe[None, : x.shape[1], :])


def get_time_encoder(kind: str, embed_dim: int) -> nn.Module:
    if kind == "gaussian_fourier":
        return GaussianFourierProjection(embed_dim)
    if kind == "sinusoidal":
        return SinusoidalPositionEmbeddings(embed_dim)
    raise ValueError(f"Unknown time encoding: {kind}")
