"""
The port's denoiser (models/bert.py) and weight I/O (models/io.py) against the
JAX package: the same weights, converted by state_dict_from_flax, and the same
numpy inputs through both models; the two committed fixtures through the
port's from_dir. Every attention_impl is held against the JAX einsum path
("xla"): the JAX model's Pallas paths run on a TPU only.
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


def _torch_forward(model, x, t, mask, position_ids=None):
    pos = None if position_ids is None else torch.from_numpy(position_ids)
    with torch.inference_mode():
        return model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mask), pos).numpy()


def _jax_forward(config, params, constants, x, t, mask, position_ids=None):
    model = JaxBert(dataclasses.replace(config, matmul_precision="highest"))
    pos = None if position_ids is None else jnp.asarray(position_ids)
    return np.asarray(model.apply({"params": params, "constants": constants},
                                  jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask), pos, deterministic=True))


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


SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
             max_position_embeddings=40)
ATTENTION_IMPLS = ["auto", "pallas_v2", "pallas", "xla", "plain"]


@pytest.fixture(scope="module")
def jax_einsum_reference():
    """Per position_embedding_type: (weights, inputs, a permutation of arange(L) as position ids,
    and the JAX einsum path's outputs for arange and for the permuted positions)."""
    cache = {}

    def get(position_embedding_type):
        if position_embedding_type not in cache:
            jax_config = JaxConfig(**SMALL, position_embedding_type=position_embedding_type, attention_impl="xla")
            variables = jax_io.init_model_variables(JaxBert(jax_config), jax.random.PRNGKey(5), pad=40)
            params = jax.tree.map(np.asarray, variables["params"])
            constants = jax.tree.map(np.asarray, variables.get("constants", {}))
            x, t, mask = _inputs(3, 40, 1000, seed=6)
            perm = np.broadcast_to(np.random.default_rng(7).permutation(40), (3, 40)).copy()
            cache[position_embedding_type] = (
                params, constants, (x, t, mask), perm,
                _jax_forward(jax_config, params, constants, x, t, mask),
                _jax_forward(jax_config, params, constants, x, t, mask, perm),
            )
        return cache[position_embedding_type]

    return get


def _port_model(params, constants, position_embedding_type, attention_impl, **fields):
    config = ModelConfig(**SMALL, position_embedding_type=position_embedding_type, attention_impl=attention_impl,
                         **fields)
    model = BertForDiffusion(config).eval()
    model.load_state_dict(model_io.state_dict_from_flax(params, constants, config), strict=True)
    return model


@pytest.mark.parametrize("attention_impl", ATTENTION_IMPLS)
@pytest.mark.parametrize("position_embedding_type", ["relative_key", "absolute"])
def test_attention_impls_match_jax_einsum_path(jax_einsum_reference, position_embedding_type, attention_impl):
    params, constants, inputs, _, ref, _ = jax_einsum_reference(position_embedding_type)
    model = _port_model(params, constants, position_embedding_type, attention_impl)
    np.testing.assert_allclose(_torch_forward(model, *inputs), ref, atol=1e-5)


@pytest.mark.parametrize("attention_impl", ["auto", "pallas_v2", "pallas"])
def test_kernel_routes_get_their_layouts_and_match_jax(jax_einsum_reference, monkeypatch, attention_impl):
    """Both kernel entries get the projections' (B, L, H, D) views uncopied,
    and the model stays within 1e-5 of the JAX einsum path."""
    from foldingdiff_tpu_torch.models import bert

    seen = []
    for name in ("fused_attention_v2", "fused_attention"):
        def record(q, k, v, *args, _entry=getattr(bert, name), _name=name, **kwargs):
            seen.append((_name, [t.stride() for t in (q, k, v)]))
            return _entry(q, k, v, *args, **kwargs)
        monkeypatch.setattr(bert, name, record)
    params, constants, inputs, _, ref, _ = jax_einsum_reference("relative_key")
    model = _port_model(params, constants, "relative_key", attention_impl)
    np.testing.assert_allclose(_torch_forward(model, *inputs), ref, atol=1e-5)
    b, l, h, d = 3, 40, SMALL["num_attention_heads"], SMALL["hidden_size"] // SMALL["num_attention_heads"]
    entry = "fused_attention" if attention_impl == "pallas" else "fused_attention_v2"
    assert seen == [(entry, [(l * h * d, d, h * d, 1)] * 3)] * SMALL["num_hidden_layers"]


@pytest.mark.parametrize("attention_impl", ["auto", "pallas", "xla", "plain"])
def test_permuted_position_ids_match_jax_einsum_path(jax_einsum_reference, attention_impl):
    """The auto (v1 kernel when position_ids is given), pallas and plain paths
    gather the distance embeddings from position_ids[0], as JAX's
    gather_dist_emb does; L = M keeps every index in the table."""
    params, constants, inputs, perm, arange_ref, ref = jax_einsum_reference("relative_key")
    assert np.abs(ref - arange_ref).max() > 1e-3  # the positions matter
    model = _port_model(params, constants, "relative_key", attention_impl)
    np.testing.assert_allclose(_torch_forward(model, *inputs, perm), ref, atol=1e-5)


@pytest.fixture(scope="module")
def jax_scores_impl_reference(jax_einsum_reference):
    """JAX's output for relative_key with the permuted position ids under
    (relative_scores_impl, attention_impl), the weights and inputs of
    jax_einsum_reference."""
    params, constants, inputs, perm, _, _ = jax_einsum_reference("relative_key")
    cache = {}

    def get(relative_scores_impl, attention_impl):
        key = (relative_scores_impl, attention_impl)
        if key not in cache:
            jax_config = JaxConfig(**SMALL, position_embedding_type="relative_key",
                                   relative_scores_impl=relative_scores_impl, attention_impl=attention_impl)
            cache[key] = _jax_forward(jax_config, params, constants, *inputs, perm)
        return cache[key]

    return get


@pytest.mark.parametrize("attention_impl", ATTENTION_IMPLS)
@pytest.mark.parametrize("relative_scores_impl", ["skew", "onedot"])
def test_relative_scores_impl_positions_match_jax(jax_einsum_reference, jax_scores_impl_reference,
                                                  relative_scores_impl, attention_impl):
    """JAX's skew and onedot einsums score arange distances whatever the
    position ids, its pallas kernel gathers from position_ids[0] and its
    pallas_v2 kernel takes arange, whatever relative_scores_impl is. The JAX
    Pallas routes run on a TPU only, so "pallas" and "pallas_v2" are held
    against the einsum outputs those routes equal: gather on the permuted
    positions, and arange."""
    params, constants, inputs, perm, arange_ref, gather_ref = jax_einsum_reference("relative_key")
    if attention_impl == "pallas":
        ref = gather_ref
    elif attention_impl == "pallas_v2":
        ref = arange_ref
    else:
        ref = jax_scores_impl_reference(relative_scores_impl, attention_impl)
        np.testing.assert_allclose(ref, arange_ref, atol=1e-5)  # JAX scores arange here
    model = _port_model(params, constants, "relative_key", attention_impl, relative_scores_impl=relative_scores_impl)
    np.testing.assert_allclose(_torch_forward(model, *inputs, perm), ref, atol=1e-5)


@pytest.mark.parametrize("attention_impl", ATTENTION_IMPLS)
def test_relative_key_query_matches_jax(jax_einsum_reference, attention_impl):
    """relative_key_query runs the plain einsums under every attention_impl,
    as in JAX, with arange and with permuted position ids; its weights load
    strictly through state_dict_from_flax."""
    params, constants, inputs, perm, ref, ref_perm = jax_einsum_reference("relative_key_query")
    model = _port_model(params, constants, "relative_key_query", attention_impl)
    assert model.encoder.layer[0].attention.self.distance_embedding is not None
    np.testing.assert_allclose(_torch_forward(model, *inputs), ref, atol=1e-5)
    np.testing.assert_allclose(_torch_forward(model, *inputs, perm), ref_perm, atol=1e-5)


def test_from_dir_torch_ckpt_matches_parity():
    parity = np.load(os.path.join(TORCH_FIXTURE, "parity.npz"))
    model, train_args = model_io.from_dir(TORCH_FIXTURE, device="cpu")
    assert train_args["position_embedding_type"] == "relative_key"
    assert len(model.state_dict()) == 62
    ours = _torch_forward(model, parity["x"], parity["t"], parity["mask"])
    np.testing.assert_allclose(ours, parity["predicted_noise"], atol=2e-5, rtol=1e-4)


def test_from_dir_flax_msgpack_matches_jax_from_dir():
    jmodel, params, constants, _ = jax_io.from_dir(MINI_FIXTURE)
    model, train_args = model_io.from_dir(MINI_FIXTURE, device="cpu")
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
    loaded, loaded_args = model_io.from_dir(str(tmp_path), device="cpu")
    assert loaded_args == train_args and loaded.config == config
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), loaded.state_dict().values()))
    np.testing.assert_array_equal(np.load(tmp_path / "training_mean_offset.npy"), offset)


def test_from_dir_overrides_attention_impl():
    model, _ = model_io.from_dir(TORCH_FIXTURE, attention_impl="plain", device="cpu")
    assert model.config.attention_impl == "plain"
    with pytest.raises(ValueError, match="attention_impl"):
        model_io.from_dir(TORCH_FIXTURE, attention_impl="flash", device="cpu")


def test_resolve_model_dir_local_and_missing(tmp_path):
    assert model_io.resolve_model_dir(TORCH_FIXTURE) == TORCH_FIXTURE
    with pytest.raises(FileNotFoundError):
        model_io.resolve_model_dir(str(tmp_path / "missing" / "model" / "dir"))
