"""
The port's denoiser (models/bert.py) and weight I/O (models/io.py) against the
JAX package: the same weights, converted by state_dict_from_flax, and the same
numpy inputs through both models; the two committed fixtures through the
port's from_dir.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldingdiff_tpu.models import io as jax_io
from foldingdiff_tpu.models.bert import BertForDiffusion as JaxBert
from foldingdiff_tpu.models.config import ModelConfig as JaxConfig
from foldingdiff_tpu_torch.models import io as model_io
from foldingdiff_tpu_torch.models.bert import BertForDiffusion
from foldingdiff_tpu_torch.models.config import ModelConfig

TESTS = os.path.dirname(__file__)
TORCH_FIXTURE = os.path.join(TESTS, "torch_trained_model_for_testing")
MINI_FIXTURE = os.path.join(TESTS, "mini_model_for_testing", "results")


def _inputs(b, l, t_max, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-np.pi, np.pi, (b, l, 6)).astype(np.float32)
    t = rng.integers(0, t_max, b)
    mask = (np.arange(l)[None, :] < rng.integers(l // 2, l + 1, (b, 1))).astype(np.float32)
    return x, t, mask


def _torch_forward(model, x, t, mask):
    with torch.inference_mode():
        return model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mask)).numpy()


def _jax_forward(config, params, constants, x, t, mask):
    model = JaxBert(dataclasses.replace(config, matmul_precision="highest"))
    return np.asarray(model.apply({"params": params, "constants": constants},
                                  jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask), deterministic=True))


@pytest.mark.parametrize("position_embedding_type", ["relative_key", "absolute"])
@pytest.mark.parametrize("time_encoding", ["gaussian_fourier", "sinusoidal"])
def test_denoiser_matches_jax(position_embedding_type, time_encoding):
    fields = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
                  max_position_embeddings=40, position_embedding_type=position_embedding_type,
                  time_encoding=time_encoding)
    jax_config = JaxConfig(**fields)
    variables = jax_io.init_model_variables(JaxBert(jax_config), jax.random.PRNGKey(3), pad=40)
    params = jax.tree.map(np.asarray, variables["params"])
    constants = jax.tree.map(np.asarray, variables.get("constants", {}))

    config = ModelConfig(**fields)
    model = BertForDiffusion(config).eval()
    model.load_state_dict(model_io.state_dict_from_flax(params, constants, config), strict=True)

    # Sinusoidal: XLA's and PyTorch's float32 exp differ by an ulp on some
    # frequencies, which at t ~ 1000 moves the embedding by ~6e-5
    # (test_torch_ops.py); small timesteps keep that below the tolerance
    x, t, mask = _inputs(3, 40, 1000 if time_encoding == "gaussian_fourier" else 50, seed=4)
    ours = _torch_forward(model, x, t, mask)
    ref = _jax_forward(jax_config, params, constants, x, t, mask)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_relative_key_query_is_not_ported():
    with pytest.raises(NotImplementedError):
        BertForDiffusion(ModelConfig(hidden_size=32, num_attention_heads=2, num_hidden_layers=1,
                                     position_embedding_type="relative_key_query"))


def test_from_dir_torch_ckpt_matches_parity():
    parity = np.load(os.path.join(TORCH_FIXTURE, "parity.npz"))
    model, train_args = model_io.from_dir(TORCH_FIXTURE)
    assert train_args["position_embedding_type"] == "relative_key"
    assert len(model.state_dict()) == 62
    ours = _torch_forward(model, parity["x"], parity["t"], parity["mask"])
    np.testing.assert_allclose(ours, parity["predicted_noise"], atol=2e-5, rtol=1e-4)


def test_from_dir_flax_msgpack_matches_jax_from_dir():
    jmodel, params, constants, _ = jax_io.from_dir(MINI_FIXTURE)
    model, train_args = model_io.from_dir(MINI_FIXTURE)
    assert train_args["timesteps"] == 250
    x, t, mask = _inputs(2, 64, 250, seed=5)
    ref = _jax_forward(jmodel.config, params, constants, x, t, mask)
    np.testing.assert_allclose(_torch_forward(model, x, t, mask), ref, atol=1e-5)


def test_save_model_dir_round_trip(tmp_path):
    config = ModelConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
                         max_position_embeddings=16)
    model = model_io.init_random(config, torch.Generator().manual_seed(0))
    again = model_io.init_random(config, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), again.state_dict().values()))
    train_args = {"angles_definitions": "canonical-full-angles", "max_seq_len": 16, "num_hidden_layers": 1,
                  "hidden_size": 32, "intermediate_size": 64, "num_heads": 2,
                  "position_embedding_type": "relative_key", "timesteps": 10, "variance_schedule": "linear"}
    offset = np.linspace(-1, 1, 6)
    path = model_io.save_model_dir(str(tmp_path), config, model.state_dict(), train_args, offset, epoch=3)
    assert path.endswith(os.path.join("models", "best_by_valid", "epoch=3.ckpt"))
    loaded, loaded_args = model_io.from_dir(str(tmp_path))
    assert loaded_args == train_args and loaded.config == config
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), loaded.state_dict().values()))
    np.testing.assert_array_equal(np.load(tmp_path / "training_mean_offset.npy"), offset)


def test_from_dir_overrides_attention_impl():
    model, _ = model_io.from_dir(TORCH_FIXTURE, attention_impl="plain")
    assert model.config.attention_impl == "plain"
    with pytest.raises(ValueError, match="attention_impl"):
        model_io.from_dir(TORCH_FIXTURE, attention_impl="pallas_v2")


def test_resolve_model_dir_local_and_missing(tmp_path):
    assert model_io.resolve_model_dir(TORCH_FIXTURE) == TORCH_FIXTURE
    with pytest.raises(FileNotFoundError):
        model_io.resolve_model_dir(str(tmp_path / "missing" / "model" / "dir"))
