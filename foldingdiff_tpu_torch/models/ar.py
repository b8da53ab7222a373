"""
Autoregressive baseline: next-angle-set prediction (counterpart of
foldingdiff_tpu/models/ar.py; reference modelling.py:807-1009).

The encoder body is the denoiser's, with the same module names, so
models/io.py loads, saves and converts either class's weights alike. Two
differences from BertForDiffusion:
- there is no timestep: the time embedding encodes the sequence length and is
  added to the projected inputs BEFORE the embeddings' LayerNorm
  (reference modelling.py:823-828), where the denoiser adds its time
  embedding after it;
- the attention mask is a causal prefix mask, and the model has no remat.
Its GEMMs follow config.matmul_precision as the denoiser's do (bert.py).

The layers route their attention as the denoiser's do (bert.attention_route):
in eval mode under "auto" every forward launches the v2 kernel once per
layer, its rel instance under `relative_key` and its rel-off instance under
`absolute`; train mode runs the einsums.

`ar_sample` grows the prefix one residue at a time with a full forward per
step, as the reference and the JAX package do (no KV cache: every prefix row
attends to the whole prefix, so its hidden state changes at every step).
"""
from __future__ import annotations

import torch

from foldingdiff_tpu_torch.models.bert import BertForDiffusion


class BertForAutoregressive(BertForDiffusion):
    """(angles, causal mask, seq_lengths) -> the predicted next angle set at
    every position.

    forward(inputs (B, L, F) float32, attention_mask (B, L) with 1 = keep,
    seq_lengths (B,) int, position_ids (B, L) or None for arange).
    """

    def forward(
        self,
        inputs: torch.Tensor,
        attention_mask: torch.Tensor,
        seq_lengths: torch.Tensor,
        position_ids: torch.Tensor | None = None,
    ) -> torch.Tensor:
        position_ids, attn_bias, route, dist_idx = self._attention_inputs(inputs, attention_mask, position_ids)
        with self.matmul_scope():
            hidden = self.inputs_to_hidden_dim(inputs) + self.time_embed(seq_lengths)[:, None, :]
            return self._encode(self.embeddings(hidden, position_ids), attn_bias, route, dist_idx)


def ar_sample(
    model: BertForAutoregressive,
    seed_angles: torch.Tensor,  # (B, L, F), the first num_seed positions filled
    seq_lengths: torch.Tensor,  # (B,)
    num_seed: int = 2,
) -> torch.Tensor:
    """
    Greedy generation (reference modelling.py:864-893): for i from num_seed
    to max(seq_lengths), one forward in eval mode at the full padded length
    with the keys before i unmasked, and row i of its prediction written into
    the result in place, on the device. The host waits only for
    max(seq_lengths), once, before the loop. Positions past an item's own
    length are generated too, as in the reference; the caller trims them. A
    length beyond the pad L keeps the loop going to it, each further step
    rewriting row L - 1 from all L keys, as JAX's clamped slices do.
    Returns a new (B, L, F) tensor; the model's mode is restored after.
    """
    b, l, _ = seed_angles.shape
    max_len = int(seq_lengths.max())
    keys = torch.arange(l, device=seed_angles.device)
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            out = seed_angles.clone()
            for i in range(num_seed, max_len):
                mask = (keys < i).to(out.dtype).expand(b, l)
                row = min(i, l - 1)  # past the pad, JAX's dynamic slice clamps to the last row
                out[:, row] = model(out, mask, seq_lengths)[:, row]
    finally:
        model.train(was_training)
    return out
