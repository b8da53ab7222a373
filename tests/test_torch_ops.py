"""
The port's small host and elementwise pieces against the JAX package:
angle wrapping, variance schedules, ModelConfig, time encoders and forward
noising. Inputs are made with numpy and handed to both.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldingdiff_tpu.diffusion import noise as jnoise
from foldingdiff_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule
from foldingdiff_tpu.models import time_embed as jtime
from foldingdiff_tpu.models.config import ModelConfig as JaxConfig
from foldingdiff_tpu.ops import angles as jangles
from foldingdiff_tpu_torch.diffusion import noise as tnoise
from foldingdiff_tpu_torch.diffusion.schedules import ARRAY_NAMES, DiffusionSchedule
from foldingdiff_tpu_torch.models import time_embed as ttime
from foldingdiff_tpu_torch.models.config import ModelConfig
from foldingdiff_tpu_torch.ops import angles as tangles


def test_wrap_angles_bitwise():
    rng = np.random.default_rng(0)
    edges = np.array(
        [np.pi, -np.pi, np.nextafter(np.float32(np.pi), 0), 3 * np.pi, -3 * np.pi, 0.0, -0.0,
         10 * np.pi + 0.1, -10 * np.pi - 0.1, 37.5 * np.pi, -1e3, 1e3],
        dtype=np.float32,
    )
    x = np.concatenate([edges, rng.uniform(-40 * np.pi, 40 * np.pi, 4096).astype(np.float32)])
    ours = tangles.wrap_angles(torch.from_numpy(x)).numpy()
    ref = np.asarray(jangles.wrap_angles(jnp.asarray(x)))
    np.testing.assert_array_equal(ours, ref)
    assert ours.min() >= -np.float32(np.pi) and ours.max() < np.float32(np.pi)


def test_wrap_angular_features_only_wraps_angular_channels():
    rng = np.random.default_rng(1)
    x = rng.uniform(-20, 20, (3, 7, 4)).astype(np.float32)
    is_angular = np.array([True, False, True, False])
    ours = tangles.wrap_angular_features(torch.from_numpy(x), torch.from_numpy(is_angular)).numpy()
    ref = np.asarray(jangles.wrap_angular_features(jnp.asarray(x), jnp.asarray(is_angular)))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours[..., 1], x[..., 1])


@pytest.mark.parametrize("keyword", ["cosine", "linear", "quadratic"])
def test_schedule_arrays_bitwise(keyword):
    ours = DiffusionSchedule.create(keyword, 1000, device="cpu")
    ref = JaxSchedule.create(keyword, 1000)
    assert ours.timesteps == ref.timesteps and ours.schedule_name == ref.schedule_name
    for name in ARRAY_NAMES:
        expected = np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(getattr(ours, name).numpy(), expected, err_msg=name)
        np.testing.assert_array_equal(ours.host[name], expected, err_msg=name)
        assert getattr(ours, name).dtype == torch.float32


def test_model_config_fields_and_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert ours == ref
    assert ModelConfig().attention_head_size == JaxConfig().attention_head_size
    assert ModelConfig().n_inputs == JaxConfig().n_inputs


def test_model_config_constructors_match_jax(tmp_path):
    train_args = {
        "hidden_size": 96, "num_hidden_layers": 3, "num_heads": 6, "intermediate_size": 192,
        "max_seq_len": 64, "position_embedding_type": "relative_key", "dropout_p": 0.0,
        "angles_definitions": "canonical", "seq_len_encoding": "sinusoidal", "decoder": "linear",
    }
    ours = ModelConfig.from_train_args(train_args)
    ref = JaxConfig.from_train_args(train_args)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.to_hf_config_dict() == ref.to_hf_config_dict()

    cfg_json = tmp_path / "config.json"
    cfg_json.write_text(json.dumps(ref.to_hf_config_dict()))
    assert dataclasses.asdict(ModelConfig.from_hf_config_json(str(cfg_json), decoder="linear")) == \
        dataclasses.asdict(JaxConfig.from_hf_config_json(str(cfg_json), decoder="linear"))


def test_gaussian_fourier_uses_loaded_w():
    rng = np.random.default_rng(2)
    w = rng.normal(size=16).astype(np.float32) * 2 * np.pi
    t = rng.integers(0, 1000, 5)
    module = jtime.GaussianFourierProjection(embed_dim=32)
    ref = module.apply({"constants": {"W": jnp.asarray(w)}}, jnp.asarray(t))
    ours = ttime.GaussianFourierProjection(32)
    ours.load_state_dict({"W": torch.from_numpy(w)})
    np.testing.assert_allclose(ours(torch.from_numpy(t)).numpy(), np.asarray(ref), atol=1e-5)


def test_sinusoidal_embedding_matches_jax():
    # XLA's and PyTorch's float32 exp differ by an ulp on some frequencies;
    # at t ~ 1000 that ulp moves the sine's argument by ~6e-5
    t = np.random.default_rng(3).integers(0, 1000, 7)
    ref = jtime.SinusoidalPositionEmbeddings(embed_dim=48).apply({}, jnp.asarray(t))
    ours = ttime.SinusoidalPositionEmbeddings(48)(torch.from_numpy(t))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4)


def test_q_sample_matches_jax():
    rng = np.random.default_rng(4)
    x0 = rng.uniform(-np.pi, np.pi, (3, 10, 4)).astype(np.float32)
    eps = rng.normal(size=x0.shape).astype(np.float32)
    t = rng.integers(0, 100, 3)
    is_angular = [True, True, False, True]
    ref = jnoise.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(eps), JaxSchedule.create("cosine", 100), is_angular)
    ours = tnoise.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(eps),
                           DiffusionSchedule.create("cosine", 100, device="cpu"), is_angular)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_empty_dataset_matches_jax():
    from foldingdiff_tpu.data.datasets import AnglesEmptyDataset as JaxEmpty
    from foldingdiff_tpu_torch.data.datasets import AnglesEmptyDataset

    fixture = os.path.join(os.path.dirname(__file__), "mini_model_for_testing", "results")
    ours, ref = AnglesEmptyDataset.from_dir(fixture), JaxEmpty.from_dir(fixture)
    assert (ours.pad, ours.feature_names, ours.feature_is_angular) == (ref.pad, ref.feature_names, ref.feature_is_angular)
    np.testing.assert_array_equal(ours.get_masked_means(), ref.get_masked_means())
    with pytest.raises(NotImplementedError):
        AnglesEmptyDataset("cart-coords").get_masked_means()
    with pytest.raises(ValueError, match="mean offset"):
        AnglesEmptyDataset("canonical-full-angles", mean_offset=np.zeros(4))


def test_feature_set_registry_copy_matches_jax():
    from foldingdiff_tpu.data import feature_sets as jax_feature_sets
    from foldingdiff_tpu_torch.data import feature_sets

    for name in ("FEATURE_SET_NAMES_TO_ANGULARITY", "FEATURE_SET_NAMES_TO_FEATURE_NAMES"):
        ours, ref = getattr(feature_sets, name), getattr(jax_feature_sets, name)
        assert list(ours) == list(ref)
        for key in ref:
            assert ours[key] == ref[key], (name, key)


def test_wrap_angles_on_a_numpy_array_matches_jax_utils():
    """sample() wraps the shifted host arrays with ops.angles.wrap_angles in
    place of the JAX package's utils.modulo_with_wrapped_range."""
    from foldingdiff_tpu.utils import modulo_with_wrapped_range

    vals = np.random.default_rng(3).uniform(-4 * np.pi, 4 * np.pi, (50, 6))
    vals[0, :4] = [-np.pi, np.pi, 0.0, 2 * np.pi]
    np.testing.assert_array_equal(tangles.wrap_angles(vals), modulo_with_wrapped_range(vals, -np.pi, np.pi))


def test_sample_wrapped_noise_scales_and_wraps():
    g = torch.Generator().manual_seed(0)
    is_angular = [True, False]
    noise = tnoise.sample_wrapped_noise(g, (4000, 2), is_angular, angular_scale=3.0, nonangular_scale=0.5)
    assert noise.dtype == torch.float32 and noise.shape == (4000, 2)
    assert noise[:, 0].min() >= -np.pi and noise[:, 0].max() < np.pi
    assert noise[:, 0].std() > 1.5  # wrapped N(0, 9) is close to uniform on the circle
    assert abs(noise[:, 1].std().item() - 0.5) < 0.05
    again = tnoise.sample_wrapped_noise(torch.Generator().manual_seed(0), (4000, 2), is_angular, 3.0, 0.5)
    assert torch.equal(noise, again)


def test_positional_encoding_matches_flax_in_eval():
    """The sin/cos table plus x, in eval mode, against the flax module in
    deterministic mode: within 1e-5 over the first 128 positions (XLA's and
    torch's float32 exp and sin may differ by an ulp, which grows with the
    position)."""
    x = np.random.default_rng(3).normal(size=(2, 128, 384)).astype(np.float32)
    ref = np.asarray(jtime.PositionalEncoding(d_model=384).apply({}, jnp.asarray(x), deterministic=True))
    module = ttime.PositionalEncoding(384).eval()
    assert module.pe.shape == (5000, 384) and module.pe.dtype == torch.float32
    with torch.no_grad():
        ours = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def test_positional_encoding_dropout_in_train_mode():
    """In train mode a share p of the elements is zeroed and the rest are
    scaled by 1 / (1 - p)."""
    p = 0.25
    module = ttime.PositionalEncoding(64, dropout=p).train()
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(8, 100, 64)).astype(np.float32))
    torch.manual_seed(0)
    out = module(x)
    clean = x + module.pe[None, :100]
    dropped = out == 0
    assert abs(dropped.float().mean().item() - p) < 0.01
    torch.testing.assert_close(out[~dropped], clean[~dropped] / (1 - p), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="expected"):
        module(x[0])
