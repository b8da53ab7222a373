"""
Model configuration (counterpart of foldingdiff_tpu/models/config.py).

Its own copy of `ModelConfig`, with the same fields and defaults as the JAX
dataclass (tests/test_torch_ops.py keeps them equal), so one config.json /
training_args.json drives both packages. The JAX module cannot be imported
here: its package pulls in flax. The feature-set registry is imported from
foldingdiff_tpu.data.feature_sets, which needs nothing beyond the standard
library.

Fields the port reads differently:
- attention_impl: "auto" (the default) runs ops.attention.fused_attention_v2,
  which launches the CUDA kernel on a CUDA tensor and its plain version on a
  CPU tensor; "plain" runs the plain PyTorch version on any device.
- matmul_precision, relative_scores_impl, remat and the dropout probabilities
  are kept for config parity and not read: the port computes in float32 (the
  caller keeps TF32 off), the relative scores are the `gather` semantics (the
  other impls are numerically identical layouts of it), and the denoiser is
  forward-only.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # Transformer body (HF BertConfig subset)
    hidden_size: int = 384
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 768
    max_position_embeddings: int = 128
    position_embedding_type: str = "relative_key"  # absolute | relative_key | relative_key_query
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    initializer_range: float = 0.02
    # foldingdiff head/inputs
    ft_is_angular: Tuple[bool, ...] = (True, True, True, True, True, True)
    ft_names: Tuple[str, ...] = ("phi", "psi", "omega", "tau", "CA:C:1N", "C:1N:1CA")
    time_encoding: str = "gaussian_fourier"  # gaussian_fourier | sinusoidal
    decoder: str = "mlp"  # mlp | linear
    matmul_precision: str = "default"
    attention_impl: str = "auto"  # auto (kernel entry) | plain
    relative_scores_impl: str = "gather"
    remat: bool = False

    @property
    def n_inputs(self) -> int:
        return len(self.ft_is_angular)

    @property
    def attention_head_size(self) -> int:
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} is not a multiple of "
                f"num_attention_heads {self.num_attention_heads}"
            )
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_train_args(cls, train_args: dict, ft_is_angular=None, ft_names=None) -> "ModelConfig":
        """Build from a reference-style training_args.json dict."""
        from foldingdiff_tpu.data.feature_sets import (
            FEATURE_SET_NAMES_TO_ANGULARITY,
            FEATURE_SET_NAMES_TO_FEATURE_NAMES,
        )

        key = train_args.get("angles_definitions", "canonical-full-angles")
        if ft_is_angular is None:
            ft_is_angular = FEATURE_SET_NAMES_TO_ANGULARITY[key]
        if ft_names is None:
            ft_names = FEATURE_SET_NAMES_TO_FEATURE_NAMES[key]
        time_key = "time_encoding" if "time_encoding" in train_args else "seq_len_encoding"
        return cls(
            hidden_size=train_args["hidden_size"],
            num_hidden_layers=train_args["num_hidden_layers"],
            num_attention_heads=train_args["num_heads"],
            intermediate_size=train_args["intermediate_size"],
            max_position_embeddings=train_args["max_seq_len"],
            position_embedding_type=train_args.get("position_embedding_type", "absolute"),
            hidden_dropout_prob=train_args.get("dropout_p", 0.1),
            attention_probs_dropout_prob=train_args.get("dropout_p", 0.1),
            ft_is_angular=tuple(ft_is_angular),
            ft_names=tuple(ft_names),
            time_encoding=train_args.get(time_key, "gaussian_fourier"),
            decoder=train_args.get("decoder", "mlp"),
        )

    @classmethod
    def from_hf_config_json(cls, fname: str, **overrides) -> "ModelConfig":
        """Build the transformer body from an HF config.json artifact."""
        with open(fname) as f:
            cfg = json.load(f)
        fields = dict(
            hidden_size=cfg["hidden_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            intermediate_size=cfg["intermediate_size"],
            max_position_embeddings=cfg["max_position_embeddings"],
            position_embedding_type=cfg.get("position_embedding_type", "absolute"),
            hidden_dropout_prob=cfg.get("hidden_dropout_prob", 0.1),
            attention_probs_dropout_prob=cfg.get("attention_probs_dropout_prob", 0.1),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
            hidden_act=cfg.get("hidden_act", "gelu"),
        )
        fields.update(overrides)
        return cls(**fields)

    def to_hf_config_dict(self) -> dict:
        """Export the transformer body as an HF-style config.json dict."""
        return {
            "architectures": ["BertModel"],
            "attention_probs_dropout_prob": self.attention_probs_dropout_prob,
            "classifier_dropout": None,
            "hidden_act": self.hidden_act,
            "hidden_dropout_prob": self.hidden_dropout_prob,
            "hidden_size": self.hidden_size,
            "initializer_range": self.initializer_range,
            "intermediate_size": self.intermediate_size,
            "layer_norm_eps": self.layer_norm_eps,
            "max_position_embeddings": self.max_position_embeddings,
            "model_type": "bert",
            "num_attention_heads": self.num_attention_heads,
            "num_hidden_layers": self.num_hidden_layers,
            "pad_token_id": 0,
            "position_embedding_type": self.position_embedding_type,
            "type_vocab_size": 2,
            "use_cache": False,
            "vocab_size": 30522,
        }
