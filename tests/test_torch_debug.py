"""
The port's debug noisers and their training path (data/debug_noisers.py,
data/datasets.NoisedAnglesDataset, Trainer.train_step_precorrupted,
orchestration.train's debug keys, bin/train_torch.py --debug_single_time)
against the JAX package's on the CPU:
- every noiser class, over one clean dataset with the same seed, gives the
  JAX package's items exactly (both draw from numpy generators);
- one pre-corrupted step from JAX's initial parameters, with dropout 0:
  loss terms within 1e-5, gradients within rtol 1e-4 (atol 1e-6), the
  parameters after the step within 1e-6 where the gradient exceeds 1e-6
  (elsewhere within 2 lr); the loss carries no L1 penalty, though l1_norm
  is set;
- train() with each debug key builds a 1-feature model and returns finite
  per-epoch rows.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldingdiff_tpu.data import datasets as jax_datasets
from foldingdiff_tpu.data import debug_noisers as jax_noisers
from foldingdiff_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule
from foldingdiff_tpu.models.bert import BertForDiffusion as JaxBert
from foldingdiff_tpu.models.config import ModelConfig as JaxConfig
from foldingdiff_tpu.training import trainer as jax_trainer
from foldingdiff_tpu_torch.data import datasets as dsets
from foldingdiff_tpu_torch.data import debug_noisers
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.models import io as model_io
from foldingdiff_tpu_torch.models.bert import BertForDiffusion
from foldingdiff_tpu_torch.models.config import ModelConfig
from foldingdiff_tpu_torch.training import orchestration
from foldingdiff_tpu_torch.training.trainer import Trainer, TrainConfig
from tests.helpers import make_synthetic_pdb_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hidden_size=48, num_hidden_layers=1, num_attention_heads=4, intermediate_size=96,
             max_position_embeddings=48)
T = 25


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these eager loops run many tiny ops, which a
    thread pool slows down, the more so on cores that other test workers
    share."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def pdb_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pdbs"))
    make_synthetic_pdb_dir(d, n=16, seed=4, min_len=30)
    return d


@pytest.fixture(scope="module")
def clean(pdb_dir, tmp_path_factory):
    return dsets.AnglesOnlyDataset(pdbs=pdb_dir, pad=48, min_length=0, cache_dir=str(tmp_path_factory.mktemp("c")),
                                   n_workers=1)


@pytest.fixture(scope="module")
def minimal(pdb_dir, tmp_path_factory):
    """phi, psi, omega and tau: the width of the fixed noise (512, 4)."""
    return dsets.MinimalAnglesDataset(pdbs=pdb_dir, pad=48, min_length=0,
                                      cache_dir=str(tmp_path_factory.mktemp("m")), n_workers=1)


NOISERS = {
    "noised": ("NoisedAnglesDataset", dict(timesteps=50, seed=3, beta_schedule="cosine", angular_variance=0.7)),
    "noised_exhaustive_t": ("NoisedAnglesDataset", dict(timesteps=5, exhaustive_t=True, seed=3)),
    "single_angle": ("SingleNoisedAngleDataset", dict(timesteps=50, ft_idx=2, seed=1)),
    "single_angle_fixed_noise": ("SingleNoisedAngleDataset", dict(use_fixed_noise=True, timesteps=50, seed=1)),
    "single_bond_distance": ("SingleNoisedBondDistanceDataset", dict(timesteps=50, seed=1)),
    "single_angle_and_time": ("SingleNoisedAngleAndTimeDataset", dict(timesteps=250, seed=2)),
    "syn_by_position": ("SynNoisedByPositionDataset", dict(timesteps=50, seed=4)),
    "syn_by_position_timesteps": ("SynNoisedByPositionDataset", dict(timesteps=50, use_timesteps=True, seed=4,
                                                                     beta_schedule="cosine")),
    "score_matching": ("ScoreMatchingNoisedAnglesDataset", dict(seed=5)),
    "syn_masked_only": ("SynNoisedMaskedOnlyDataset", dict(seed=6)),
}


@pytest.mark.parametrize("case", sorted(NOISERS))
def test_noiser_items_equal_jax(case, clean, minimal):
    name, kw = NOISERS[case]
    if kw.get("use_fixed_noise"):
        clean = minimal
    jax_mod = jax_datasets if name == "NoisedAnglesDataset" else jax_noisers
    port_mod = dsets if name == "NoisedAnglesDataset" else debug_noisers
    ref, ours = getattr(jax_mod, name)(dset=clean, **kw), getattr(port_mod, name)(dset=clean, **kw)
    assert len(ours) == len(ref)
    for index in (0, 3, 1, 0, len(ref) - 1):  # the generator's sequence, an item drawn twice
        a, b = ours[index], ref[index]
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_noiser_checks():
    with pytest.raises(ValueError, match="Cannot use specific t"):
        debug_noisers.SingleNoisedAngleAndTimeDataset.__getitem__(None, 0, use_t_val=3)
    with pytest.raises(ValueError, match="t must be in"):
        debug_noisers.ScoreMatchingNoisedAnglesDataset.get_sigma(1.5)


def test_train_step_precorrupted_matches_jax(clean):
    noiser = debug_noisers.SingleNoisedAngleDataset(dset=clean, timesteps=T, beta_schedule="cosine", seed=0)
    items = [noiser[i] for i in range(6)]
    batch = {k: np.stack([it[k] for it in items]) for k in ("corrupted", "t", "known_noise", "attn_mask")}
    kw = dict(lr=1e-3, batch_size=6, max_epochs=1, lr_scheduler=None, seed=0, l1_norm=1e-4)
    one = dict(ft_is_angular=(True,), ft_names=("phi",), hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)

    jt = jax_trainer.Trainer(JaxBert(JaxConfig(**SMALL, **one, matmul_precision="highest")),
                             JaxSchedule.create("cosine", T), jax_trainer.TrainConfig(**kw), 1)
    state = jt.init_state(jax.random.PRNGKey(0), pad=48)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(1)

    def jax_loss(p):
        terms = jt._loss_terms_precorrupted(p, state.constants, jbatch, key, deterministic=False)
        return jnp.mean(terms), terms

    @jax.jit
    def jax_step(st):
        return jax.value_and_grad(jax_loss, has_aux=True)(st.params), jt._step_precorrupted_impl(st, jbatch, key)

    ((ref_avg, ref_terms), ref_grads), (new_state, step_avg, _) = jax_step(state)
    assert float(step_avg) == float(ref_avg)  # JAX's step loss: the terms' mean, no L1 penalty

    config = ModelConfig(**SMALL, **one)
    model = BertForDiffusion(config)
    model.load_state_dict(model_io.state_dict_from_flax(jax.tree.map(np.asarray, state.params),
                                                        jax.tree.map(np.asarray, state.constants), config))
    trainer = Trainer(model, DiffusionSchedule.create("cosine", T, device="cpu"), TrainConfig(**kw), 1)
    tb = trainer.to_device(batch, tuple(batch))
    model.train()
    terms = trainer._loss_terms_precorrupted(tb)
    terms.mean().backward()
    assert terms.shape == (1,)
    np.testing.assert_allclose(terms.detach().numpy(), np.asarray(ref_terms), atol=1e-5, rtol=0)
    want_grads = model_io.state_dict_from_flax(jax.tree.map(np.asarray, ref_grads), {}, config)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(want_grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[n].numpy(), rtol=1e-4, atol=1e-6, err_msg=n)

    avg, step_terms = trainer.train_step_precorrupted(tb)
    assert trainer.step == 1 and avg.item() == step_terms.mean().item()
    np.testing.assert_allclose(avg.item(), float(ref_avg), atol=1e-5, rtol=0)
    want = model_io.state_dict_from_flax(jax.tree.map(np.asarray, new_state.params),
                                         jax.tree.map(np.asarray, new_state.constants), config)
    for n, p in model.named_parameters():
        got, ref, g = p.detach().numpy(), want[n].numpy(), want_grads[n].numpy()
        big = np.abs(g) > 1e-6  # below it a first Adam step's direction is float noise
        np.testing.assert_allclose(got[big], ref[big], atol=1e-6, rtol=0, err_msg=n)
        assert np.all(np.abs(got[~big] - ref[~big]) <= 2 * kw["lr"]), n


TRAIN_KW = dict(angles_definitions="canonical-full-angles", max_seq_len=48, min_seq_len=0, timesteps=10,
                variance_schedule="cosine", num_hidden_layers=1, hidden_size=32, intermediate_size=64, num_heads=2,
                batch_size=8, lr=3e-4, lr_scheduler=None, max_epochs=2, multithread=False, device="cpu")


@pytest.mark.parametrize("debug", [{"single_angle_debug": 1}, {"syn_noiser": "halfhalf"},
                                   {"single_angle_debug": 2, "single_timestep_debug": True}])
def test_train_with_debug_noisers(debug, pdb_dir, tmp_path, monkeypatch):
    """A 1-feature model with the first feature's flag and name (JAX's slice,
    whichever column the noiser keeps), one finite row per epoch."""
    monkeypatch.setenv("FOLDINGDIFF_CACHE_DIR", str(tmp_path))
    trainer, rows = orchestration.train(results_dir=str(tmp_path / "r"), dataset_key=pdb_dir, **TRAIN_KW, **debug)
    assert trainer.model.config.n_inputs == 1 and trainer.model.config.ft_names == ("phi",)
    assert [r["epoch"] for r in rows] == [0, 1] and all(np.isfinite(r["train_loss"]) for r in rows)
    assert trainer.step == 2 * (12 // 8)  # 16 structures, 12 in the train split: one full batch per epoch
    with pytest.raises(ValueError, match="Unknown synthetic noiser"):
        orchestration.train(results_dir=str(tmp_path / "x"), dataset_key=pdb_dir, **{**TRAIN_KW, "syn_noiser": "x"})


def test_train_torch_cli_debug_single_time(pdb_dir, tmp_path, monkeypatch):
    import json

    spec = importlib.util.spec_from_file_location("train_torch", os.path.join(REPO, "bin", "train_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({k: v for k, v in TRAIN_KW.items() if k != "device"}))
    monkeypatch.setenv("FOLDINGDIFF_CACHE_DIR", str(tmp_path))
    argv = [str(cfg), "--dataset", pdb_dir, "--epochs", "1", "--debug_single_time", "-o", str(tmp_path / "out")]
    rows = cli.main([*argv, "--device", "cpu"])
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cuda: no CUDA device is available"):
        cli.main([*argv[:-1], str(tmp_path / "no_card")])
    assert not (tmp_path / "no_card").exists()
