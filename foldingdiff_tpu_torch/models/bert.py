"""
BERT-for-diffusion denoiser (counterpart of foldingdiff_tpu/models/bert.py).

Numerics follow the JAX model and the reference (foldingdiff/modelling.py:
211-484, HF BertEncoder):
- continuous features projected to the hidden size, optional absolute
  position embeddings, LayerNorm(eps=1e-12)
- the time embedding is added to every position
- post-LN BERT layers; `relative_key` adds q . E[l - j + M - 1] to the raw
  q . k scores BEFORE the 1/sqrt(d) scale
- additive -10000 attention mask, exact GELU
- MLP angle head: dense -> gelu -> LayerNorm -> dense

Module names are the reference state-dict names (encoder.layer.N.attention.
self.query, ...), so a reference .ckpt loads with load_state_dict(strict=True).

Attention for `relative_key` and `absolute` goes through
ops.attention.fused_attention_v2 (the CUDA kernel on the card), or through its
plain version when config.attention_impl == "plain". The relative scores use
arange positions, as HF does. The model is forward-only: it has no dropout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from foldingdiff_tpu_torch.models.config import ModelConfig
from foldingdiff_tpu_torch.models.time_embed import get_time_encoder
from foldingdiff_tpu_torch.ops.attention import fused_attention_v2, fused_attention_v2_reference

_ATTENTION_IMPLS = {"auto": fused_attention_v2, "plain": fused_attention_v2_reference}


def _act(name: str):
    if name == "gelu":
        return F.gelu
    if name == "gelu_new":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(f"Unsupported activation {name}")


class SelfAttention(nn.Module):
    """HF BertSelfAttention numerics incl. relative_key position scoring."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        if config.position_embedding_type == "relative_key_query":
            raise NotImplementedError("relative_key_query attention is not ported yet")
        if config.attention_impl not in _ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl {config.attention_impl!r} not in {sorted(_ATTENTION_IMPLS)}"
            )
        self.n_heads = config.num_attention_heads
        self.head_size = config.attention_head_size
        self.max_pos = config.max_position_embeddings
        self.attend = _ATTENTION_IMPLS[config.attention_impl]
        hidden = config.hidden_size
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.distance_embedding = (
            nn.Embedding(2 * self.max_pos - 1, self.head_size)
            if config.position_embedding_type == "relative_key"
            else None
        )

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        b, l, _ = hidden.shape

        def heads(x):  # (B, L, H*D) -> (B, H, L, D), the kernel's layout
            return x.view(b, l, self.n_heads, self.head_size).transpose(1, 2).contiguous()

        table = self.distance_embedding.weight if self.distance_embedding is not None else None
        ctx = self.attend(
            heads(self.query(hidden)), heads(self.key(hidden)), heads(self.value(hidden)),
            attn_bias, rel_table=table, m=self.max_pos if table is not None else None,
        )
        return ctx.transpose(1, 2).reshape(b, l, self.n_heads * self.head_size)


class _DenseLayerNorm(nn.Module):
    """dense + LayerNorm(out + residual): HF BertSelfOutput / BertOutput."""

    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class _Attention(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.self = SelfAttention(config)
        self.output = _DenseLayerNorm(config.hidden_size, config.hidden_size, config.layer_norm_eps)


class _Intermediate(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.intermediate_size)


class Layer(nn.Module):
    """One post-LN BERT layer (attention + FFN), HF module naming."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.act = _act(config.hidden_act)
        self.attention = _Attention(config)
        self.intermediate = _Intermediate(config)
        self.output = _DenseLayerNorm(config.intermediate_size, config.hidden_size, config.layer_norm_eps)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        attn = self.attention.self(hidden, attn_bias)
        hidden = self.attention.output(attn, hidden)
        ff = self.act(self.intermediate.dense(hidden))
        return self.output(ff, hidden)


class _Encoder(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.layer = nn.ModuleList(Layer(config) for _ in range(config.num_hidden_layers))


class Embeddings(nn.Module):
    """Reference BertEmbeddings (modelling.py:132-170): absolute position
    embeddings only when position_embedding_type == absolute; LayerNorm always."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.position_embeddings = (
            nn.Embedding(config.max_position_embeddings, config.hidden_size)
            if config.position_embedding_type == "absolute"
            else None
        )
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, input_embeds: torch.Tensor, position_ids: torch.Tensor) -> torch.Tensor:
        emb = input_embeds
        if self.position_embeddings is not None:
            emb = emb + self.position_embeddings(position_ids)
        return self.LayerNorm(emb)


class AnglesPredictor(nn.Module):
    """dense -> act -> LayerNorm -> dense head (modelling.py:173-208)."""

    def __init__(self, d_model: int, d_out: int, activation: str = "gelu", eps: float = 1e-12):
        super().__init__()
        self.dense1 = nn.Linear(d_model, d_model)
        self.act = _act(activation)
        self.layer_norm = nn.LayerNorm(d_model, eps=eps)
        self.dense2 = nn.Linear(d_model, d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense2(self.layer_norm(self.act(self.dense1(x))))


class BertForDiffusion(nn.Module):
    """
    Noise-prediction transformer: (x_t, t, mask) -> predicted noise.

    forward(inputs (B, L, F) float32, timestep (B,) int, attention_mask (B, L)
    with 1 = keep, position_ids (B, L) or None for arange).
    """

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.inputs_to_hidden_dim = nn.Linear(config.n_inputs, config.hidden_size)
        self.embeddings = Embeddings(config)
        self.time_embed = get_time_encoder(config.time_encoding, config.hidden_size)
        self.encoder = _Encoder(config)
        if config.decoder == "mlp":
            self.token_decoder = AnglesPredictor(config.hidden_size, config.n_inputs)
        elif config.decoder == "linear":
            self.token_decoder = nn.Linear(config.hidden_size, config.n_inputs)
        else:
            raise ValueError(f"Unrecognized decoder: {config.decoder}")

    def forward(
        self,
        inputs: torch.Tensor,
        timestep: torch.Tensor,
        attention_mask: torch.Tensor,
        position_ids: torch.Tensor | None = None,
    ) -> torch.Tensor:
        b, l, _ = inputs.shape
        if position_ids is None:
            position_ids = torch.arange(l, device=inputs.device).expand(b, l)
        attn_bias = (1.0 - attention_mask.to(inputs.dtype)) * -10000.0

        hidden = self.embeddings(self.inputs_to_hidden_dim(inputs), position_ids)
        hidden = hidden + self.time_embed(timestep)[:, None, :]
        for layer in self.encoder.layer:
            hidden = layer(hidden, attn_bias)
        return self.token_decoder(hidden)
