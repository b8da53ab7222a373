"""
Model directory I/O (counterpart of foldingdiff_tpu/models/io.py).

- `from_dir` loads a reference-layout model directory: training_args.json +
  config.json + a models/best_by_{valid,train,...}/ checkpoint, by default
  the latest epoch under best_by_valid (reference modelling.py:297-382). A torch `.ckpt` (lightning-style
  {"state_dict": ...} or a bare state dict) loads by load_state_dict; the JAX
  package's flax `.msgpack` is decoded with `msgpack` and mapped onto the
  same names by `state_dict_from_flax`.
- `save_model_dir` writes the same layout, with the weights as a `.ckpt`,
  keeping the newest `keep_top_k` checkpoints of its best_by_ directory.
- `init_random` builds seeded random weights.

Either model class loads and saves through these functions: the denoiser
(`BertForDiffusion`, the default) and the autoregressive baseline
(`models/ar.BertForAutoregressive`), whose state dicts share every name. The
caller names the class: a directory does not say which model it holds.

The GaussianFourier `time_embed.W` buffer is loaded with the weights, never
redrawn (reference modelling.py:55-57).
"""
from __future__ import annotations

import glob
import json
import math
import os
import re
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np
import torch

from foldingdiff_tpu_torch.devices import require_device
from foldingdiff_tpu_torch.models.bert import BertForDiffusion
from foldingdiff_tpu_torch.models.config import ModelConfig

# The fields config.json sets over training_args.json: the transformer body, and matmul_precision
_BODY_FIELDS = (
    "hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
    "max_position_embeddings", "position_embedding_type", "layer_norm_eps", "hidden_act", "matmul_precision",
)


def _empty_model(config: ModelConfig, model_cls: Type[BertForDiffusion]) -> BertForDiffusion:
    # Built on the meta device: no weights are initialised only to be replaced
    with torch.device("meta"):
        return model_cls(config)


def _with_weights(config: ModelConfig, state_dict: Dict[str, torch.Tensor],
                  model_cls: Type[BertForDiffusion]) -> BertForDiffusion:
    model = _empty_model(config, model_cls)
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model.eval()


def init_random(config: ModelConfig, generator: torch.Generator,
                model_cls: Type[BertForDiffusion] = BertForDiffusion) -> BertForDiffusion:
    """
    A `model_cls` on the CPU with seeded random weights, drawn in state-dict order
    from `generator` at the JAX package's init scales: dense kernels
    N(0, 1/fan_in) (flax's lecun_normal, untruncated), embeddings
    N(0, initializer_range^2), LayerNorm 1/0, biases 0, time_embed.W
    N(0, (2 pi)^2).
    """
    sd = {}
    for name, t in _empty_model(config, model_cls).state_dict().items():
        shape = t.shape
        if name.endswith("bias"):
            sd[name] = torch.zeros(shape)
        elif "LayerNorm" in name or "layer_norm" in name:
            sd[name] = torch.ones(shape)
        elif name == "time_embed.W":
            sd[name] = torch.randn(shape, generator=generator) * (2 * math.pi)
        elif name.endswith(("distance_embedding.weight", "position_embeddings.weight")):
            sd[name] = torch.randn(shape, generator=generator) * config.initializer_range
        else:  # nn.Linear weight, (out, in)
            sd[name] = torch.randn(shape, generator=generator) / math.sqrt(shape[1])
    return _with_weights(config, sd, model_cls)


def state_dict_from_flax(params: Dict[str, Any], constants: Dict[str, Any], config: ModelConfig) -> Dict[str, torch.Tensor]:
    """
    The JAX package's (params, constants) trees, as numpy arrays, to the
    port's reference-named state dict: the inverse of foldingdiff_tpu's
    convert_torch_state_dict. Flax Dense kernels are (in, out), so they are
    transposed to torch's (out, in).
    """
    sd: Dict[str, np.ndarray] = {}

    def dense(prefix: str, tree: Dict[str, Any]):
        sd[f"{prefix}.weight"] = np.asarray(tree["kernel"]).T
        sd[f"{prefix}.bias"] = np.asarray(tree["bias"])

    def ln(prefix: str, tree: Dict[str, Any]):
        sd[f"{prefix}.weight"] = np.asarray(tree["scale"])
        sd[f"{prefix}.bias"] = np.asarray(tree["bias"])

    dense("inputs_to_hidden_dim", params["inputs_to_hidden_dim"])
    emb = params["embeddings"]
    if "position_embeddings" in emb:
        sd["embeddings.position_embeddings.weight"] = np.asarray(emb["position_embeddings"]["embedding"])
    ln("embeddings.LayerNorm", emb["LayerNorm"])
    for i in range(config.num_hidden_layers):
        layer = params[f"encoder_layer_{i}"]
        pre = f"encoder.layer.{i}"
        self_attn = layer["attention_self"]
        for name in ("query", "key", "value"):
            dense(f"{pre}.attention.self.{name}", self_attn[name])
        if "distance_embedding" in self_attn:
            sd[f"{pre}.attention.self.distance_embedding.weight"] = np.asarray(
                self_attn["distance_embedding"]["embedding"]
            )
        dense(f"{pre}.attention.output.dense", layer["attention_output_dense"])
        ln(f"{pre}.attention.output.LayerNorm", layer["attention_output_LayerNorm"])
        dense(f"{pre}.intermediate.dense", layer["intermediate_dense"])
        dense(f"{pre}.output.dense", layer["output_dense"])
        ln(f"{pre}.output.LayerNorm", layer["output_LayerNorm"])
    dec = params["token_decoder"]
    if config.decoder == "mlp":
        dense("token_decoder.dense1", dec["dense1"])
        ln("token_decoder.layer_norm", dec["layer_norm"])
        dense("token_decoder.dense2", dec["dense2"])
    else:
        dense("token_decoder", dec)
    if "time_embed" in constants:
        sd["time_embed.W"] = np.asarray(constants["time_embed"]["W"])
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}


def _read_flax_msgpack(path: str) -> Dict[str, Any]:
    """Decode flax.serialization.msgpack_serialize output: nested dicts whose
    array leaves are msgpack extension 1 (ndarray) or 3 (numpy scalar), each
    the msgpack tuple (shape, dtype name, C-order bytes)."""
    import msgpack

    def ext_hook(code: int, data: bytes):
        if code not in (1, 3):
            raise ValueError(f"{path}: unsupported msgpack extension type {code}")
        shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)
        return arr if code == 1 else arr[()]

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)


def _load_ckpt(path: str) -> Dict[str, torch.Tensor]:
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    return loaded.get("state_dict", loaded)


def save_model_dir(
    dirname: str,
    config: ModelConfig,
    state_dict: Dict[str, torch.Tensor],
    train_args: Dict,
    mean_offset: Optional[np.ndarray] = None,
    epoch: int = 0,
    best_by: str = "valid",
    keep_top_k: int = 5,
) -> str:
    """
    Write training_args.json, config.json, training_mean_offset.npy, and the
    weights as models/best_by_{best_by}/epoch=N.ckpt ({"state_dict": ...},
    the reference layout, bin/train.py:214-233, 255-284, 363-367, 463), then
    delete all but the newest keep_top_k checkpoints there by epoch. Returns
    the checkpoint's path.
    """
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "training_args.json"), "w") as f:
        json.dump(train_args, f, indent=4, default=str)
    with open(os.path.join(dirname, "config.json"), "w") as f:
        json.dump(config.to_hf_config_dict(), f, indent=2)
    if mean_offset is not None:
        np.save(os.path.join(dirname, "training_mean_offset.npy"), np.asarray(mean_offset))
    subdir = os.path.join(dirname, "models", f"best_by_{best_by}")
    os.makedirs(subdir, exist_ok=True)
    out = os.path.join(subdir, f"epoch={epoch}.ckpt")
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}}, out)
    ckpts = sorted(glob.glob(os.path.join(subdir, "*.ckpt")), key=_epoch_from_fname)
    for stale in ckpts[:-keep_top_k]:
        os.remove(stale)
    return out


def _epoch_from_fname(fname: str) -> int:
    m = re.findall(r"epoch=([0-9]+)", os.path.basename(fname))
    return int(m[-1]) if m else -1


def resolve_model_dir(name_or_dir: str) -> str:
    """
    An existing directory is returned as-is; a Hugging Face hub model id
    (e.g. "wukevin/foldingdiff") is snapshot-downloaded and its local path
    returned (reference bin/sample.py:302-307). Needs the network and
    huggingface_hub; untested here.
    """
    if os.path.isdir(name_or_dir):
        return name_or_dir
    parts = name_or_dir.split("/")
    if len(parts) == 2 and all(p and not p.startswith(".") for p in parts):
        try:
            from huggingface_hub import snapshot_download
        except ImportError:
            snapshot_download = None
        if snapshot_download is not None:
            local = snapshot_download(name_or_dir)
            # The reference hub layout nests the artifact dir under models/
            nested = os.path.join(local, "models")
            if not os.path.isfile(os.path.join(local, "training_args.json")) and os.path.isdir(nested):
                for sub in sorted(os.listdir(nested)):
                    cand = os.path.join(nested, sub)
                    if os.path.isfile(os.path.join(cand, "training_args.json")):
                        return cand
            return local
    raise FileNotFoundError(f"{name_or_dir} is neither a local model directory nor a hub id")


def from_dir(
    dirname: str,
    device: torch.device | str = "cuda",
    idx: int = -1,
    best_by: str = "valid",
    model_cls: Type[BertForDiffusion] = BertForDiffusion,
    **config_overrides,
) -> Tuple[BertForDiffusion, Dict]:
    """
    Load a model directory (reference layout or the JAX package's native
    msgpack layout) into a `model_cls`: BertForDiffusion, or
    BertForAutoregressive for the autoregressive baseline's directories, which
    hold the same weight names. Returns (model in eval mode on `device`,
    train_args).
    `device` is the card unless the caller asks for the CPU; without a card
    the default raises at once (devices.require_device).
    The checkpoints under models/best_by_{best_by}/ are sorted by epoch and
    `idx` picks one (default -1, the latest), as the JAX package's from_dir.
    `config_overrides` replace config fields, e.g. attention_impl="plain".
    """
    device = require_device(device)
    dirname = resolve_model_dir(dirname)
    with open(os.path.join(dirname, "training_args.json")) as f:
        train_args = json.load(f)
    config = ModelConfig.from_train_args(train_args)
    cfg_json = os.path.join(dirname, "config.json")
    if os.path.isfile(cfg_json):  # config.json wins for the transformer body
        body = ModelConfig.from_hf_config_json(cfg_json)
        config = ModelConfig(**{**config.__dict__, **{k: getattr(body, k) for k in _BODY_FIELDS}})
    if config_overrides:
        config = ModelConfig(**{**config.__dict__, **config_overrides})
    subdir = os.path.join(dirname, "models", f"best_by_{best_by}")
    native = sorted(glob.glob(os.path.join(subdir, "*.msgpack")), key=_epoch_from_fname)
    torch_ckpts = sorted(glob.glob(os.path.join(subdir, "*.ckpt")), key=_epoch_from_fname)
    if native:
        tree = _read_flax_msgpack(native[idx])
        sd = state_dict_from_flax(tree["params"], tree.get("constants", {}), config)
    elif torch_ckpts:
        sd = _load_ckpt(torch_ckpts[idx])
    else:
        raise FileNotFoundError(f"No checkpoints under {subdir}")
    return _with_weights(config, sd, model_cls).to(device), train_args
