"""
Model configuration (counterpart of foldingdiff_tpu/models/config.py).

Its own copy of `ModelConfig`, with the same fields and defaults as the JAX
dataclass (tests/test_torch_ops.py keeps them equal), so one config.json /
training_args.json drives both packages. The JAX module cannot be imported
here: its package pulls in flax. The feature-set registry is the port's own
copy too (data/feature_sets.py): the port imports nothing of the JAX package.

Fields the port reads differently:
- attention_impl and relative_scores_impl take the JAX package's values, and
  the relative scores follow the positions that JAX's route follows:
  "pallas_v2" runs ops.attention.fused_attention_v2 (the raw distance table,
  arange positions), "pallas" runs ops.attention.fused_attention (e_lr
  gathered from position_ids[0]), "xla" runs the plain einsums, on
  position_ids[0] under relative_scores_impl "gather" and on arange under
  "skew" and "onedot". "plain" is a second name of "xla". "auto" (the
  default) is JAX's einsum path computed by a kernel: the v2 kernel where the
  positions are arange (position_ids None, or "skew" and "onedot"), the v1
  kernel where "gather" meets a given position_ids. Each kernel entry
  launches its CUDA kernel on a CUDA tensor and its plain version on a CPU
  tensor. relative_key_query always runs the plain einsums on
  position_ids[0], as in JAX. models/bert.py:attention_route decides.
- hidden_dropout_prob and attention_probs_dropout_prob are read in train
  mode (model.train()) only, and remat recomputes each layer in the
  backward pass of train mode (models/bert.py).
- matmul_precision is read as the JAX models read it: every GEMM of the
  model's forward and backward passes runs at it (precision.py), and the
  caller's setting holds outside the model. "default" enters no scope, as
  JAX's models do not: the caller's setting holds inside the model too, and
  the port's command-line programs set TF32 for the process, XLA:GPU's
  default (precision.set_process_default). Checked at construction:

| matmul_precision (JAX's names) | JAX on an H100 | the port on the H100 (precision.py's mode) |
| --- | --- | --- |
| "default" | the caller's; TF32 by XLA:GPU's default | the caller's; TF32 under the port's programs ("caller") |
| "bfloat16" (Precision.DEFAULT) | TF32 | TF32 tensor cores ("tf32") |
| "high", "tensorfloat32" (Precision.HIGH) | TF32 | TF32 tensor cores ("tf32") |
| "highest", "float32", preset "F32_F32_F32" | IEEE float32 | IEEE float32 ("ieee") |
| preset "TF32_TF32_F32" | TF32 | TF32 tensor cores ("tf32") |
| preset "BF16_BF16_F32" | bf16 operands, f32 sums and output | bf16 operands, f32 sums, f32 output ("bf16") |
| preset "TF32_TF32_F32_X3" | 3 products of TF32 parts, f32 sums | the same products on TF32 tensor cores ("tf32x3") |
| presets "BF16_BF16_F32_X3", "_X6", "_X9" | 3, 6 or 9 products of bf16 parts, f32 sums | the same products, bf16 parts, f32 sums ("bf16x3", "bf16x6", "bf16x9") |
| preset "F64_F64_F64" | operands cast to f64, an f64 dot, its result cast to f32 | the same: float64 GEMMs, their outputs cast to float32 ("f64") |
| preset "F16_F16_F32" | f16 operands, f32 accumulation and output | f16 values in float32 GEMMs under TF32, exact products, f32 sums and output ("f16") |
| preset "F16_F16_F16" | f16 operands, a dot with an f16 result | as "f16", each dot's result rounded once to f16 ("f16f16") |
| preset "BF16_BF16_BF16" | bf16 operands, a dot with a bf16 result | bf16 values in float32 GEMMs, each dot's result rounded once to bf16 ("bf16bf16") |
| presets "ANY_F8_ANY_F8_F32", "_F32_FAST_ACCUM", "ANY_F8_ANY_F8_ANY", "_ANY_FAST_ACCUM" | refused at lowering for float32 operands ("requires both inputs to have float8 dtypes"), on a GPU too | ValueError, the same outcome |
| other strings | refused | ValueError |

  F16_F16_F16 and BF16_BF16_BF16 name a 16-bit accumulation, which cannot
  be observed here from XLA:GPU. The port reads them as f32 sums of the
  products of the 16-bit values with the dot's result rounded once to the
  16-bit type: XLA:CPU computes F16_F16_F16 so (to one f16 step), the dot
  that JAX lowers for a GPU has an f16 or bf16 result type, and tensor
  cores have no bf16 accumulator (precision.py). Under tensor parallelism
  (parallel/tp.py) the row-parallel layers sum the ranks' unrounded
  partial products in float32 and round the sum once at those two
  presets, as one device rounds its dot.

  The fused attention kernels follow the value too (ops/attention.py): both
  run float32 FMA at IEEE float32, TF32 tensor cores at TF32 (and at
  "default" under a caller's TF32), the bf16 values of "BF16_BF16_F32" and
  the TF32 parts of "TF32_TF32_F32_X3" on TF32 tensor cores, the bf16 parts
  of the other multi-pass presets on bf16 tensor cores, the f16 or bf16
  values of the 16-bit presets on TF32 tensor cores (each dot's output
  rounded where the preset says), and float64 FMA at F64_F64_F64. On the
  CPU, whose GEMMs ignore the CUDA TF32 setting, every value but the
  presets of precision.SPLITS and F64_F64_F64 gives float32's numbers;
  those compute their products there as on the card.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Tuple

from foldingdiff_tpu_torch.data.feature_sets import (
    FEATURE_SET_NAMES_TO_ANGULARITY,
    FEATURE_SET_NAMES_TO_FEATURE_NAMES,
)
from foldingdiff_tpu_torch.precision import mode_of


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
    attention_impl: str = "auto"  # auto | pallas_v2 | pallas | xla | plain
    relative_scores_impl: str = "gather"  # gather | skew | onedot
    remat: bool = False

    def __post_init__(self) -> None:
        mode_of(self.matmul_precision)  # a ValueError for a name the port does not run

    @property
    def matmul_mode(self) -> str:
        """The mode of precision.py: "caller" or one of precision.KERNEL_MODES."""
        return mode_of(self.matmul_precision)

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
        """Build the transformer body from an HF config.json artifact, and
        its matmul_precision where the file names one (to_hf_config_dict)."""
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
            matmul_precision=cfg.get("matmul_precision", "default"),
        )
        fields.update(overrides)
        return cls(**fields)

    def to_hf_config_dict(self) -> dict:
        """Export the transformer body as an HF-style config.json dict, with
        matmul_precision where it is not "default" (so that a default
        config's file is the JAX package's, whose from_dir ignores the key)."""
        precision = {} if self.matmul_precision == "default" else {"matmul_precision": self.matmul_precision}
        return {
            **precision,
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
