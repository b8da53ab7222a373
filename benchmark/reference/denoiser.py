"""
The BERT-for-diffusion denoiser of foldingdiff (modelling.py:211-484, HF
BertEncoder) in plain PyTorch: input projection, LayerNorm and dropout,
the Gaussian-Fourier time embedding added at every position, post-LN
layers whose `relative_key` scores add q[l] . E[l - r + M - 1] to q . k
before the 1/sqrt(d) scale, an additive -10000 mask, exact GELU, and the
MLP head (dense, GELU, LayerNorm, dense). Parameters are a dict of tensors
under the HF names; `parameter_specs` lists them with the init the
benchmark draws them from.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-12
# angularity of each feature, by the published feature sets' names
FEATURES = {"canonical-full-angles": (True,) * 6, "canonical-minimal-angles": (True,) * 4,
            "cart-coords": (False,) * 3}


def widths(config: dict) -> dict:
    """The sizes the reference reads from a configuration file."""
    hidden, heads = config["hidden_size"], config["num_heads"]
    if config.get("position_embedding_type") != "relative_key":
        raise ValueError("the reference computes relative_key attention only")
    return dict(hidden=hidden, heads=heads, head=hidden // heads, inter=config["intermediate_size"],
                layers=config["num_hidden_layers"], max_pos=config["max_seq_len"],
                n_ft=len(FEATURES[config["angles_definitions"]]), dropout=config["dropout_p"])


def parameter_specs(config: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every tensor of the state dict, in a fixed
    order. init: "matrix" N(0, 1/fan_in), "small" N(0, 0.02^2), "ln_weight"
    1 + N(0, 0.02^2), "table" N(0, 1), "fourier" N(0, 1) * 2 pi (the
    published init of the fixed time-embedding buffer W)."""
    w = widths(config)
    h, i, f = w["hidden"], w["inter"], w["n_ft"]

    def dense(name, d_in, d_out):
        return [(f"{name}.weight", (d_out, d_in), "matrix"), (f"{name}.bias", (d_out,), "small")]

    def norm(name, d):
        return [(f"{name}.weight", (d,), "ln_weight"), (f"{name}.bias", (d,), "small")]

    specs = dense("inputs_to_hidden_dim", f, h) + norm("embeddings.LayerNorm", h)
    specs.append(("time_embed.W", (h // 2,), "fourier"))
    for n in range(w["layers"]):
        p = f"encoder.layer.{n}"
        for proj in ("query", "key", "value"):
            specs += dense(f"{p}.attention.self.{proj}", h, h)
        specs.append((f"{p}.attention.self.distance_embedding.weight", (2 * w["max_pos"] - 1, w["head"]), "table"))
        specs += dense(f"{p}.attention.output.dense", h, h) + norm(f"{p}.attention.output.LayerNorm", h)
        specs += dense(f"{p}.intermediate.dense", h, i)
        specs += dense(f"{p}.output.dense", i, h) + norm(f"{p}.output.LayerNorm", h)
    specs += dense("token_decoder.dense1", h, h) + norm("token_decoder.layer_norm", h)
    specs += dense("token_decoder.dense2", h, f)
    return specs


def _dropout(x: torch.Tensor, p: float, train: bool) -> torch.Tensor:
    return F.dropout(x, p, training=True) if train and p > 0 else x


def _linear(x: torch.Tensor, params: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return F.linear(x, params[f"{name}.weight"], params[f"{name}.bias"])


def _norm(x: torch.Tensor, params: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], params[f"{name}.weight"], params[f"{name}.bias"], LN_EPS)


def attention(q, k, v, table, bias, max_pos: int, dropout: float = 0.0, train: bool = False):
    """softmax((q.k + q.E[l - r + M - 1]) / sqrt(d) + bias) v over (B, H, L, D)
    heads, bias (B, L) per key."""
    l = q.shape[2]
    pos = torch.arange(l, device=q.device)
    e_lr = table[pos[:, None] - pos[None, :] + max_pos - 1]  # (L, L, D)
    scores = torch.einsum("bhld,bhrd->bhlr", q, k) + torch.einsum("bhld,lrd->bhlr", q, e_lr)
    scores = scores / math.sqrt(q.shape[-1]) + bias[:, None, None, :]
    probs = _dropout(torch.softmax(scores, dim=-1), dropout, train)
    return torch.einsum("bhlr,bhrd->bhld", probs, v)


def forward(params: Dict[str, torch.Tensor], config: dict, x: torch.Tensor, t: torch.Tensor, mask: torch.Tensor,
            train: bool = False) -> torch.Tensor:
    """Predicted noise (B, L, F) of x (B, L, F) at timesteps t (B,) under the
    key mask (B, L), 1 = keep. With `train`, dropout draws from the
    default generator of x's device, in the published order: after the
    embeddings' LayerNorm, then per layer on the attention probabilities,
    after the attention output dense and after the FFN output dense."""
    w = widths(config)
    b, l, _ = x.shape
    p = w["dropout"]
    hidden = _dropout(_norm(_linear(x, params, "inputs_to_hidden_dim"), params, "embeddings.LayerNorm"), p, train)
    proj = t.reshape(-1).to(torch.float32)[:, None] * params["time_embed.W"][None, :] * 2 * math.pi
    hidden = hidden + torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)[:, None, :]
    bias = (1.0 - mask.to(x.dtype)) * -10000.0
    for n in range(w["layers"]):
        pre = f"encoder.layer.{n}"

        def heads(name):
            return _linear(hidden, params, f"{pre}.attention.self.{name}").view(b, l, w["heads"], w["head"]).transpose(1, 2)

        ctx = attention(heads("query"), heads("key"), heads("value"),
                        params[f"{pre}.attention.self.distance_embedding.weight"], bias, w["max_pos"], p, train)
        ctx = ctx.transpose(1, 2).reshape(b, l, w["hidden"])
        attn = _dropout(_linear(ctx, params, f"{pre}.attention.output.dense"), p, train)
        hidden = _norm(attn + hidden, params, f"{pre}.attention.output.LayerNorm")
        ff = F.gelu(_linear(hidden, params, f"{pre}.intermediate.dense"))
        ff = _dropout(_linear(ff, params, f"{pre}.output.dense"), p, train)
        hidden = _norm(ff + hidden, params, f"{pre}.output.LayerNorm")
    out = _norm(F.gelu(_linear(hidden, params, "token_decoder.dense1")), params, "token_decoder.layer_norm")
    return _linear(out, params, "token_decoder.dense2")


def forward_blocks(params, config, x, t, mask, block: int = 512) -> torch.Tensor:
    """forward() without gradients over rows in blocks of `block`, so that
    a long list of recorded states fits beside nothing else."""
    with torch.no_grad():
        return torch.cat([forward(params, config, x[i:i + block], t[i:i + block], mask[i:i + block])
                          for i in range(0, x.shape[0], block)])


def matmul_flops(config: dict, length: int) -> int:
    """The GEMM FLOPs (2 per multiply-add) of one forward pass over one
    sequence of `length` positions: the projections and dense layers at
    every position, and per layer and head the q.k, q.E and p.v products."""
    w = widths(config)
    h, i, f = w["hidden"], w["inter"], w["n_ft"]
    per_position = f * h + w["layers"] * (4 * h * h + 2 * h * i) + h * h + h * f
    attention_products = w["layers"] * 3 * length * length * h
    return 2 * (length * per_position + attention_products)

