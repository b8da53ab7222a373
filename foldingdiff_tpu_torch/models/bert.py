"""
BERT-for-diffusion denoiser (counterpart of foldingdiff_tpu/models/bert.py).

Numerics follow the JAX model and the reference (foldingdiff/modelling.py:
211-484, HF BertEncoder):
- continuous features projected to the hidden size, optional absolute
  position embeddings, LayerNorm(eps=1e-12)
- the time embedding is added to every position
- post-LN BERT layers; `relative_key` adds q[l] . E[pos[l] - pos[j] + M - 1]
  to the raw q . k scores BEFORE the 1/sqrt(d) scale, and
  `relative_key_query` adds k[j] . E[pos[l] - pos[j] + M - 1] as well
- additive -10000 attention mask, exact GELU
- MLP angle head: dense -> gelu -> LayerNorm -> dense

Module names are the reference state-dict names (encoder.layer.N.attention.
self.query, ...), so a reference .ckpt loads with load_state_dict(strict=True).

attention_impl and relative_scores_impl route each layer's attention as the
JAX model does (foldingdiff_tpu/models/bert.py:93-179), decided on the host
from the config and from whether position_ids was given (see attention_route):
- "pallas_v2": ops.attention.fused_attention_v2 (the CUDA kernel of
  csrc/rel_attention.cu on the card) on the raw distance table, with arange
  positions, as JAX's v2 kernel assumes;
- "pallas": ops.attention.fused_attention (csrc/gathered_attention.cu) on
  e_lr gathered from position_ids[0];
- "auto": JAX's einsum path, so the positions follow relative_scores_impl:
  under "gather" (the default) position_ids[0], which is arange when
  position_ids is None, so that case takes the v2 kernel and a given
  position_ids the v1 kernel; under "skew" and "onedot" arange, the v2 kernel;
- "xla" and "plain": the plain einsums, on e_lr gathered from position_ids[0]
  under "gather" and from arange under "skew" and "onedot".
`relative_key_query` runs the plain einsums on position_ids[0] under every
value, as in JAX, whose skew and onedot apply to `relative_key` only.

Train mode (`model.train()`) is the JAX model with deterministic=False:
- dropout where JAX has it: after the embeddings' LayerNorm (bert.py:237),
  on the attention probabilities (:186), after the attention output dense
  (:205) and after the FFN output dense (:213). It draws from the device's
  default generator, which torch.utils.checkpoint replays under `remat`;
- every route is the plain einsums, as JAX's "auto" always is
  (bert.py:93-102): "auto", "xla" and "plain" train; "pallas" and
  "pallas_v2" raise, since the kernels are forward-only (as in JAX, whose
  Pallas kernels have no VJP);
- config.remat recomputes each layer in the backward pass
  (torch.utils.checkpoint, non-reentrant); the state dict is the same.
Eval mode launches what it launched before train mode existed: dropout is
the identity there and adds no device operation.

config.matmul_precision sets every GEMM of the model (precision.py), as
JAX's bert.py:277-279 scope does: forward() runs under matmul_scope(), the
trainers run the backward pass under it too (training/trainer.py:
optimizer_step), and under "BF16_BF16_F32" and the multi-pass presets
(TF32_TF32_F32_X3, BF16_BF16_F32_X3, _X6, _X9) every Linear and every
einsum of the plain attention computes the preset's products of bf16 or
TF32 parts with a float32 output (precision.linear, precision.einsum),
forward and backward, remat's recompute included. The fused attention
kernels take the model's mode too and compute the products that the JAX
model's einsums compute in it (ops/attention.py's table): in float32 FMA, on
TF32 tensor cores, or the preset's products of parts on them. Under
"default" the kernel follows the caller's TF32 setting at the call, as the
GEMMs do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from foldingdiff_tpu_torch import precision
from foldingdiff_tpu_torch.models.config import ModelConfig
from foldingdiff_tpu_torch.models.time_embed import get_time_encoder
from foldingdiff_tpu_torch.ops.attention import fused_attention, fused_attention_reference, fused_attention_v2

# attention_impl -> the kernel entry it names: "v2", "v1", or "plain" (the einsums)
_ENTRIES = {"auto": "v2", "pallas_v2": "v2", "pallas": "v1", "xla": "plain", "plain": "plain"}
# relative_scores_impl values whose JAX einsums score arange distances
_ARANGE_SCORES = ("skew", "onedot")


def attention_route(config: ModelConfig, position_ids_given: bool, training: bool = False) -> tuple[str, bool]:
    """(entry, arange) of every layer's attention: the entry "v2", "v1" or
    "plain", and whether its relative scores take arange positions in place
    of position_ids[0]. Decided from the config, from whether the caller
    gave position_ids and from train mode, never from the positions' values."""
    if config.position_embedding_type == "relative_key_query":
        return "plain", False
    entry = _ENTRIES[config.attention_impl]
    arange = config.relative_scores_impl in _ARANGE_SCORES
    if training and entry != "plain" and config.attention_impl != "auto":
        raise ValueError(
            f"attention_impl {config.attention_impl!r} runs a fused attention kernel, which is forward-only; "
            "train with 'auto', 'xla' or 'plain' (the einsums)"
        )
    if entry == "plain" or training:
        return "plain", arange
    if (config.attention_impl == "auto" and not arange and position_ids_given
            and config.position_embedding_type == "relative_key"):
        return "v1", False
    return entry, entry == "v2"


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
        if config.attention_impl not in _ENTRIES:
            raise ValueError(f"attention_impl {config.attention_impl!r} not in {sorted(_ENTRIES)}")
        self.key_query = config.position_embedding_type == "relative_key_query"
        self.n_heads = config.num_attention_heads
        self.head_size = config.attention_head_size
        self.max_pos = config.max_position_embeddings
        self.probs_dropout = config.attention_probs_dropout_prob
        self.mode = mode = config.matmul_mode
        hidden = config.hidden_size
        self.query = precision.Linear(hidden, hidden, mode)
        self.key = precision.Linear(hidden, hidden, mode)
        self.value = precision.Linear(hidden, hidden, mode)
        self.distance_embedding = (
            nn.Embedding(2 * self.max_pos - 1, self.head_size)
            if config.position_embedding_type in ("relative_key", "relative_key_query")
            else None
        )

    def forward(
        self, hidden: torch.Tensor, attn_bias: torch.Tensor, route: str, dist_idx: torch.Tensor | None = None
    ) -> torch.Tensor:
        """route is attention_route's entry; dist_idx is distance_index of the
        positions it names, needed by the "v1" and "plain" entries."""
        b, l, _ = hidden.shape

        def heads(x):  # (B, L, H*D) -> (B, H, L, D); both kernels read this view as it is
            x = x.view(b, l, self.n_heads, self.head_size).transpose(1, 2)
            return x if route in ("v2", "v1") else x.contiguous()

        q, k, v = heads(self.query(hidden)), heads(self.key(hidden)), heads(self.value(hidden))
        table = self.distance_embedding.weight if self.distance_embedding is not None else None
        # each kernel returns a view of a (B, L, H, D) buffer: the reshape below copies nothing
        if route == "v2":
            ctx = fused_attention_v2(q, k, v, attn_bias, rel_table=table,
                                     m=self.max_pos if table is not None else None, mode=self.mode)
        else:
            e_lr = gather_distance_embeddings(table, dist_idx) if table is not None else None
            if route == "v1":
                ctx = fused_attention(q, k, v, attn_bias, e_lr, mode=self.mode)
            else:
                ctx = fused_attention_reference(q, k, v, attn_bias, e_lr, key_term=self.key_query,
                                                dropout_p=self.probs_dropout if self.training else 0.0,
                                                mode=self.mode)
        return ctx.transpose(1, 2).reshape(b, l, self.n_heads * self.head_size)


def distance_index(pos: torch.Tensor, max_pos: int) -> torch.Tensor:
    """idx[l, r] = pos[l] - pos[r] + M - 1 for the (L,) positions pos, the
    rows of the distance table that JAX's gather_dist_emb reads (bert.py:
    137-142). Every index lies in the table when the positions lie in [0, M)."""
    return pos[:, None] - pos[None, :] + (max_pos - 1)


def gather_distance_embeddings(table: torch.Tensor, dist_idx: torch.Tensor) -> torch.Tensor:
    """e_lr[l, r] = table[dist_idx[l, r]], a contiguous (L, L, D) tensor, the
    layout the gathered-attention kernel reads. One device operation."""
    l = dist_idx.shape[0]
    return torch.index_select(table, 0, dist_idx.reshape(-1)).view(l, l, -1)


class _DenseLayerNorm(nn.Module):
    """LayerNorm(dropout(dense(x)) + residual): HF BertSelfOutput / BertOutput."""

    def __init__(self, d_in: int, d_out: int, config: ModelConfig):
        super().__init__()
        self.dense = precision.Linear(d_in, d_out, config.matmul_mode)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)
        self.LayerNorm = nn.LayerNorm(d_out, eps=config.layer_norm_eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class _Attention(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.self = SelfAttention(config)
        self.output = _DenseLayerNorm(config.hidden_size, config.hidden_size, config)


class _Intermediate(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.dense = precision.Linear(config.hidden_size, config.intermediate_size, config.matmul_mode)


class Layer(nn.Module):
    """One post-LN BERT layer (attention + FFN), HF module naming."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.act = _act(config.hidden_act)
        self.attention = _Attention(config)
        self.intermediate = _Intermediate(config)
        self.output = _DenseLayerNorm(config.intermediate_size, config.hidden_size, config)

    def forward(
        self, hidden: torch.Tensor, attn_bias: torch.Tensor, route: str, dist_idx: torch.Tensor | None = None
    ) -> torch.Tensor:
        attn = self.attention.self(hidden, attn_bias, route, dist_idx)
        hidden = self.attention.output(attn, hidden)
        ff = self.act(self.intermediate.dense(hidden))
        return self.output(ff, hidden)


class _Encoder(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.layer = nn.ModuleList(Layer(config) for _ in range(config.num_hidden_layers))


class Embeddings(nn.Module):
    """Reference BertEmbeddings (modelling.py:132-170): absolute position
    embeddings only when position_embedding_type == absolute; LayerNorm and
    dropout always."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.position_embeddings = (
            nn.Embedding(config.max_position_embeddings, config.hidden_size)
            if config.position_embedding_type == "absolute"
            else None
        )
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, input_embeds: torch.Tensor, position_ids: torch.Tensor) -> torch.Tensor:
        emb = input_embeds
        if self.position_embeddings is not None:
            emb = emb + self.position_embeddings(position_ids)
        return self.dropout(self.LayerNorm(emb))


class AnglesPredictor(nn.Module):
    """dense -> act -> LayerNorm -> dense head (modelling.py:173-208)."""

    def __init__(self, d_model: int, d_out: int, mode: str, activation: str = "gelu", eps: float = 1e-12):
        super().__init__()
        self.dense1 = precision.Linear(d_model, d_model, mode)
        self.act = _act(activation)
        self.layer_norm = nn.LayerNorm(d_model, eps=eps)
        self.dense2 = precision.Linear(d_model, d_out, mode)

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
        mode = config.matmul_mode
        self.inputs_to_hidden_dim = precision.Linear(config.n_inputs, config.hidden_size, mode)
        self.embeddings = Embeddings(config)
        self.time_embed = get_time_encoder(config.time_encoding, config.hidden_size)
        self.encoder = _Encoder(config)
        if config.decoder == "mlp":
            self.token_decoder = AnglesPredictor(config.hidden_size, config.n_inputs, mode)
        elif config.decoder == "linear":
            self.token_decoder = precision.Linear(config.hidden_size, config.n_inputs, mode)
        else:
            raise ValueError(f"Unrecognized decoder: {config.decoder}")

    def forward(
        self,
        inputs: torch.Tensor,
        timestep: torch.Tensor,
        attention_mask: torch.Tensor,
        position_ids: torch.Tensor | None = None,
    ) -> torch.Tensor:
        position_ids, attn_bias, route, dist_idx = self._attention_inputs(inputs, attention_mask, position_ids)
        with self.matmul_scope():
            hidden = self.embeddings(self.inputs_to_hidden_dim(inputs), position_ids)
            hidden = hidden + self.time_embed(timestep)[:, None, :]
            remat = self.config.remat and self.training and torch.is_grad_enabled()
            return self._encode(hidden, attn_bias, route, dist_idx, remat)

    def matmul_scope(self):
        """The context of config.matmul_precision (precision.matmul_precision)
        that the forward runs in, and that a backward pass through the model
        must run in (optimizer_step enters it)."""
        return precision.matmul_precision(self.config.matmul_mode)

    def _attention_inputs(self, inputs: torch.Tensor, attention_mask: torch.Tensor,
                          position_ids: torch.Tensor | None):
        """(position_ids, additive key bias, route, dist_idx) of the layers:
        arange positions when none are given, the route that attention_route
        picks, and the distance index of the positions it names (None on the
        "v2" route and without relative scores)."""
        b, l, _ = inputs.shape
        route, arange = attention_route(self.config, position_ids is not None, self.training)
        if position_ids is None:
            position_ids = torch.arange(l, device=inputs.device).expand(b, l)
        attn_bias = (1.0 - attention_mask.to(inputs.dtype)) * -10000.0
        dist_idx = None
        if route != "v2" and self.config.position_embedding_type != "absolute":
            pos = torch.arange(l, device=inputs.device) if arange else position_ids[0]
            dist_idx = distance_index(pos, self.config.max_position_embeddings)
        return position_ids, attn_bias, route, dist_idx

    def _encode(self, hidden: torch.Tensor, attn_bias: torch.Tensor, route: str, dist_idx: torch.Tensor | None,
                remat: bool = False) -> torch.Tensor:
        """The layers, each recomputed in the backward pass under remat, then the decoder."""
        for layer in self.encoder.layer:
            if remat:
                hidden = checkpoint(layer, hidden, attn_bias, route, dist_idx, use_reentrant=False)
            else:
                hidden = layer(hidden, attn_bias, route, dist_idx)
        return self.token_decoder(hidden)
