"""
The port's training path (foldingdiff_tpu_torch/training/, the denoiser's
train mode, bin/train_torch.py) against the JAX package's on the CPU, at
2 layers x 48, 4 heads, pad 48:
- the learning-rate schedules at every step of 3 epochs (bit-equal; the
  one-cycle cosine within 1e-9, one float32 ulp of its 1e-2 peak), and the batch order;
- one train step from JAX's initial parameters (carried across by
  state_dict_from_flax), given the same batch, t and noise, with dropout 0:
  loss terms within 1e-5 (the pdist term, a mean of squared distance errors
  of ~5 A^2 after float32 chain builds, within rtol 1e-5), gradients within
  rtol 1e-4 (atol 1e-6), and the parameters after the clipped AdamW step
  within atol 1e-6 where the gradient exceeds 1e-6 (a first Adam step moves
  an element by about lr); elsewhere float noise decides the move, which
  stays within 2 lr. With pdist, float32 gradients stray ~1e-3 from float64
  in JAX and in the port alike, so both are held against the port's float64
  step: the port within 1.5 times JAX's distance, and the floor of the
  parameter check is 10 times that distance;
- train mode: dropout 0 equals eval mode, the dropout rate and scale,
  "pallas" refused, remat's loss and gradients within 1e-6;
- fit (with exhaustive-t validation and its prediction dump, SWA, early
  stopping and the SIGTERM checkpoint), resume, the checkpoints JAX's
  from_dir loads (predictions within 1e-5), and the CLI.
"""
import csv
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldingdiff_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule
from foldingdiff_tpu.models import io as jax_io
from foldingdiff_tpu.models.bert import BertForDiffusion as JaxBert
from foldingdiff_tpu.models.config import ModelConfig as JaxConfig
from foldingdiff_tpu.training import trainer as jax_trainer
from foldingdiff_tpu_torch.data import datasets as dsets
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.models import io as model_io
from foldingdiff_tpu_torch.models.bert import BertForDiffusion
from foldingdiff_tpu_torch.models.config import ModelConfig
from foldingdiff_tpu_torch.training import orchestration
from foldingdiff_tpu_torch.training.trainer import Trainer, TrainConfig, make_lr_schedule
from tests.helpers import make_synthetic_pdb_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hidden_size=48, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
             max_position_embeddings=48)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
T = 25
TRAIN_ARGS = {
    "angles_definitions": "canonical-full-angles", "max_seq_len": 48, "num_hidden_layers": 2, "hidden_size": 48,
    "intermediate_size": 96, "num_heads": 4, "position_embedding_type": "relative_key",
    "time_encoding": "gaussian_fourier", "decoder": "mlp", "timesteps": T, "variance_schedule": "cosine",
    "variance_scale": 1.0,
}


@pytest.fixture(scope="module")
def pdb_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pdbs"))
    make_synthetic_pdb_dir(d, n=16, seed=2, min_len=30)
    return d


@pytest.fixture(scope="module")
def data(pdb_dir, tmp_path_factory):
    ds = dsets.AnglesOnlyDataset(pdbs=pdb_dir, pad=48, min_length=0, trim_strategy="leftalign",
                                 cache_dir=str(tmp_path_factory.mktemp("cache")), n_workers=1)
    return ds.to_arrays(), ds.get_masked_means()


def _port_model(config, params, constants):
    model = BertForDiffusion(config)
    model.load_state_dict(model_io.state_dict_from_flax(params, constants, config), strict=True)
    return model


# -- schedules and batch order ----------------------------------------------
@pytest.mark.parametrize("scheduler,max_epochs", [("LinearWarmup", 3), ("LinearWarmup", 30),
                                                  ("OneCycleLR", 3), ("OneCycleLR", 30), (None, 3)])
def test_lr_schedule_equals_jax_at_every_step(scheduler, max_epochs):
    steps_per_epoch = 7
    kw = dict(lr=3e-4, max_epochs=max_epochs, lr_scheduler=scheduler)
    ours = make_lr_schedule(TrainConfig(**kw), steps_per_epoch)
    ref = jax_trainer.make_lr_schedule(jax_trainer.TrainConfig(**kw), steps_per_epoch)
    steps = range(max_epochs * steps_per_epoch + 2) if max_epochs == 3 else range(0, 30 * 7 + 2, 3)
    got = np.array([ours(s) for s in steps], dtype=np.float32)
    want = np.array([float(ref(jnp.asarray(s))) for s in steps], dtype=np.float32)
    if scheduler == "OneCycleLR":  # numpy's float32 cos and XLA's differ by an ulp at some points
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)  # one ulp of the 1e-2 peak
    else:
        np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > (1 if scheduler else 0)


def test_batches_order_equals_jax():
    rng = np.random.default_rng(0)
    data = {"angles": rng.normal(size=(21, 8, 6)).astype(np.float32),
            "attn_mask": (rng.uniform(size=(21, 8)) > 0.3).astype(np.float32),
            "lengths": rng.integers(1, 9, 21)}
    ours = Trainer(BertForDiffusion(ModelConfig(**SMALL)), DiffusionSchedule.create("cosine", T, device="cpu"),
                   TrainConfig(batch_size=4), steps_per_epoch=5)
    ref = jax_trainer.Trainer(JaxBert(JaxConfig(**SMALL)), JaxSchedule.create("cosine", T),
                              jax_trainer.TrainConfig(batch_size=4), steps_per_epoch=5)
    for shuffle in (True, False):
        r1, r2 = np.random.default_rng(42), np.random.default_rng(42)
        for _ in range(2):  # two epochs from one rng
            a = list(ours._batches(data, r1, shuffle))
            b = list(ref._batches(data, r2, shuffle, shard=False))
            assert len(a) == len(b) == 6 and a[-1][0]["angles"].shape[0] == 1  # the ragged tail is kept
            for (ba, wa), (bb, wb) in zip(a, b):
                assert wa == wb
                for k in ba:
                    np.testing.assert_array_equal(ba[k], bb[k])


# -- one train step against JAX's -------------------------------------------
STEP_CASES = {
    "smooth_l1": {},
    "pdist": {"use_pdist_loss": (0.2, 1.0)},
    "l1_loss": {"loss": "l1"},
    "l1_norm_circle": {"l1_norm": 1e-4, "circle_reg": 0.1},
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case, data, monkeypatch):
    arrays, _ = data
    b = 6
    batch = {k: arrays[k][:b] for k in ("angles", "attn_mask", "lengths")}
    rng = np.random.default_rng(3)
    t = rng.integers(0, T, b).astype(np.int32)
    noise = np.asarray(jax_trainer.sample_wrapped_noise(jax.random.PRNGKey(5), batch["angles"].shape, [True] * 6))
    kw = dict(lr=1e-3, batch_size=b, max_epochs=1, lr_scheduler=None, seed=0, **STEP_CASES[case])

    jcfg = JaxConfig(**SMALL, **NO_DROPOUT, matmul_precision="highest")
    jt = jax_trainer.Trainer(JaxBert(jcfg), JaxSchedule.create("cosine", T), jax_trainer.TrainConfig(**kw), 1)
    state = jt.init_state(jax.random.PRNGKey(0), pad=48)
    params = jax.tree.map(np.asarray, state.params)
    constants = jax.tree.map(np.asarray, state.constants)
    # The JAX trainer draws t and noise inside its step: hand it these instead
    monkeypatch.setattr(jax_trainer, "sample_wrapped_noise", lambda *a, **k: jnp.asarray(noise))
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(t))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(1)

    def jax_loss(p):
        terms = jt._loss_terms(p, state.constants, jbatch, key, deterministic=False)
        avg = jnp.mean(terms)
        if kw.get("l1_norm", 0) > 0:
            avg = avg + kw["l1_norm"] * sum(jnp.sum(jnp.abs(x)) for x in jax.tree.leaves(p))
        return avg, terms

    @jax.jit
    def jax_step(st):
        return jax.value_and_grad(jax_loss, has_aux=True)(st.params), jt._step_impl(st, jbatch, key)[0]

    ((ref_avg, ref_terms), ref_grads), new_state = jax_step(state)

    config = ModelConfig(**SMALL, **NO_DROPOUT)
    model = _port_model(config, params, constants)
    trainer = Trainer(model, DiffusionSchedule.create("cosine", T, device="cpu"), TrainConfig(**kw), 1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tt, tn = torch.from_numpy(t.astype(np.int64)), torch.tensor(noise)
    model.train()
    terms = trainer._loss_terms(tb, tt, tn)
    avg = terms.mean() + (kw.get("l1_norm", 0) * trainer.l1_penalty() if kw.get("l1_norm", 0) else 0)
    avg.backward()
    assert terms.shape == ((7,) if case == "pdist" else (6,))
    np.testing.assert_allclose(terms.detach().numpy()[:6], np.asarray(ref_terms)[:6], atol=1e-5, rtol=0)
    if case == "pdist":  # a mean of squared distance errors (~5 A^2), after two float32 47-residue chain builds
        np.testing.assert_allclose(terms[6].item(), float(ref_terms[6]), rtol=1e-5)
    np.testing.assert_allclose(avg.item(), float(ref_avg), atol=1e-5, rtol=0)
    want_grads = model_io.state_dict_from_flax(jax.tree.map(np.asarray, ref_grads), {}, config)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(want_grads)
    floor = {n: 1e-6 for n in grads}  # below it a first Adam step's direction is float noise
    if case == "pdist":
        # The chain build makes this gradient ill-conditioned in float32: JAX's
        # and the port's both stray ~1e-3 from the same step in float64. So
        # each is held against float64, the port at least as close as JAX
        g64 = _float64_grads(config, params, constants, kw, tb, tt, tn)
        for n, g in grads.items():
            jax_err = np.abs(want_grads[n].numpy() - g64[n]).max()
            assert np.abs(g.numpy() - g64[n]).max() <= 1.5 * jax_err + 1e-7, n
            floor[n] = max(10 * jax_err, 1e-6)
    else:
        for n, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want_grads[n].numpy(), rtol=1e-4, atol=1e-6, err_msg=n)

    w_before = model.time_embed.W.clone()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer.train_step(tb, tt, tn)
    assert trainer.step == 1
    assert "time_embed.W" not in dict(model.named_parameters())
    assert torch.equal(model.time_embed.W, w_before)  # the buffer is not optimized
    want = model_io.state_dict_from_flax(jax.tree.map(np.asarray, new_state.params),
                                         jax.tree.map(np.asarray, new_state.constants), config)
    np.testing.assert_array_equal(model.time_embed.W.numpy(), want["time_embed.W"].numpy())
    lr = kw["lr"]
    for n, p in model.named_parameters():
        got, ref, g = p.detach().numpy(), want[n].numpy(), want_grads[n].numpy()
        big = np.abs(g) > floor[n]
        np.testing.assert_allclose(got[big], ref[big], atol=1e-6, rtol=0, err_msg=n)
        assert np.all(np.abs(got[~big] - ref[~big]) <= 2 * lr), n
        assert np.abs(got - before[n].numpy()).max() > 0, n


def _float64_grads(config, params, constants, kw, batch, t, noise):
    """The port's gradients of the same step in float64."""
    model = _port_model(config, params, constants).double().train()
    trainer = Trainer(model, DiffusionSchedule.create("cosine", T, device="cpu"), TrainConfig(**kw), 1)
    batch = {**batch, "angles": batch["angles"].double()}
    trainer._loss_terms(batch, t, noise.double()).mean().backward()
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


# -- train mode --------------------------------------------------------------
def _model(seed=0, **fields):
    return model_io.init_random(ModelConfig(**{**SMALL, **fields}), torch.Generator().manual_seed(seed))


def _inputs(b=3, l=48, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-np.pi, np.pi, (b, l, 6)).astype(np.float32))
    t = torch.tensor(rng.integers(0, T, b))
    mask = torch.tensor((np.arange(l)[None, :] < rng.integers(l // 2, l + 1, (b, 1))).astype(np.float32))
    return x, t, mask


@pytest.mark.parametrize("impl", ["auto", "xla", "plain"])
def test_dropout_zero_train_mode_equals_eval_mode(impl):
    model = _model(attention_impl=impl, **NO_DROPOUT)
    x, t, mask = _inputs()
    with torch.no_grad():
        eval_out = model.eval()(x, t, mask)
        train_out = model.train()(x, t, mask)
    np.testing.assert_allclose(train_out.numpy(), eval_out.numpy(), atol=1e-6, rtol=0)


def test_dropout_rate_and_scale():
    model = _model()  # dropout 0.1 everywhere, as the config's default
    drops = [m for m in model.modules() if isinstance(m, torch.nn.Dropout)]
    assert len(drops) == 1 + 2 * SMALL["num_hidden_layers"] and all(m.p == 0.1 for m in drops)
    assert all(layer.attention.self.probs_dropout == 0.1 for layer in model.encoder.layer)
    ones = torch.ones(200_000)
    torch.manual_seed(0)
    out = model.embeddings.dropout.train()(ones)
    kept = out[out != 0]
    assert abs(kept.numel() / ones.numel() - 0.9) < 0.005
    np.testing.assert_allclose(kept.numpy(), 1 / 0.9, rtol=1e-6)
    x, t, mask = _inputs()
    with torch.no_grad():
        a, b = model.train()(x, t, mask), model(x, t, mask)
        assert not torch.allclose(a, b)
        assert torch.equal(model.eval()(x, t, mask), model(x, t, mask))


@pytest.mark.parametrize("impl", ["pallas", "pallas_v2"])
def test_kernel_routes_refuse_train_mode(impl):
    model = _model(attention_impl=impl).train()
    with pytest.raises(ValueError, match="forward-only"):
        model(*_inputs())
    with torch.no_grad():
        model.eval()(*_inputs())  # eval mode takes the kernel entry (its plain version on the CPU)


def test_remat_gives_the_same_loss_and_gradients():
    """remat recomputes each layer in the backward pass and replays its
    dropout draws: the same loss and gradients within 1e-6."""
    x, t, mask = _inputs()
    results = []
    for remat in (False, True):
        model = _model(remat=remat).train()
        torch.manual_seed(7)
        loss = model(x, t, mask).square().mean()
        loss.backward()
        results.append((loss.item(), {n: p.grad for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert abs(l0 - l1) <= 1e-6
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), atol=1e-6, rtol=0, err_msg=n)


# -- fit, resume, checkpoints, CLI ------------------------------------------
def _fit(data, results_dir, max_epochs, resume=False, fit_kw=None, **kw):
    arrays, mean_offset = data
    model = _model(seed=1)
    tcfg = TrainConfig(**{"lr": 3e-4, "batch_size": 5, "max_epochs": max_epochs, "lr_scheduler": "LinearWarmup",
                          "seed": 0, **kw})
    trainer = Trainer(model, DiffusionSchedule.create("cosine", T, device="cpu"), tcfg, steps_per_epoch=3)
    rows = trainer.fit(arrays, valid_data=arrays, results_dir=str(results_dir), train_args=TRAIN_ARGS,
                       mean_offset=mean_offset, resume=resume, save_state_every=1, **(fit_kw or {}))
    return trainer, rows


@pytest.fixture(scope="module")
def fitted(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("fit")
    trainer, rows = _fit(data, out, max_epochs=2)
    return out, trainer, rows


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_fit_writes_jax_csv_header_and_checkpoints(fitted, data, tmp_path):
    out, trainer, rows = fitted
    assert [r["epoch"] for r in rows] == [0, 1] and trainer.step == 2 * 4  # 16 items, batch 5: 4 steps
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in rows)
    # JAX's fit on the same arrays writes the header to match (its steps
    # stubbed out: the header does not depend on what they compute)
    arrays, mean_offset = data
    jt = jax_trainer.Trainer(JaxBert(JaxConfig(**SMALL)), JaxSchedule.create("cosine", T),
                             jax_trainer.TrainConfig(batch_size=16, max_epochs=1, seed=0), steps_per_epoch=1)
    jt._train_step = lambda state, batch, key: (state, jnp.asarray(1.0), jnp.ones(6))
    jt._eval_step = lambda params, constants, batch, key: jnp.ones(6)
    state = jt.init_state(jax.random.PRNGKey(0), pad=48)
    jt.fit(state, arrays, valid_data=arrays, results_dir=str(tmp_path), model_config=JaxConfig(**SMALL),
           train_args=TRAIN_ARGS, mean_offset=mean_offset)
    ours = _csv(out / "logs" / "metrics.csv")
    assert ours[0] == _csv(tmp_path / "logs" / "metrics.csv")[0]
    assert len(ours) == 3
    for best_by in ("valid", "train"):
        ckpts = glob.glob(str(out / "models" / f"best_by_{best_by}" / "*.ckpt"))
        assert 1 <= len(ckpts) <= 2, best_by
    assert sorted(os.listdir(out / "train_state")) == ["state_epoch=0.pt", "state_epoch=1.pt"]
    for name in ("training_args.json", "config.json", "training_mean_offset.npy"):
        assert os.path.isfile(out / name)


def test_resume_continues_at_epoch_two(fitted, data, tmp_path):
    out, trainer, _ = fitted
    import shutil

    run = tmp_path / "run"
    shutil.copytree(out, run)
    resumed, rows = _fit(data, run, max_epochs=3, resume=True)
    assert [r["epoch"] for r in rows] == [2] and rows[0]["step"] == 3 * 4 and resumed.step == 12
    assert resumed.optimizer.state_dict()["state"][0]["step"].item() == 12
    assert len(_csv(run / "logs" / "metrics.csv")) == 4  # header + epochs 0, 1, 2
    assert sorted(os.listdir(run / "train_state")) == ["state_epoch=1.pt", "state_epoch=2.pt"]


def test_fit_options(data, tmp_path):
    """Exhaustive-t validation with the prediction dump, SWA into best_by_swa,
    early stopping, and the SIGTERM checkpoint, each on a short fit."""
    import json
    import signal

    arrays, _ = data
    _, rows = _fit(data, tmp_path / "ex", max_epochs=1, fit_kw=dict(
        write_preds_to_dir=str(tmp_path / "preds"), exhaustive_t_validation=True, exhaustive_t_points=4))
    assert np.isfinite(rows[0]["val_loss"])
    preds = json.loads((tmp_path / "preds" / "0_preds.json").read_text())
    assert np.asarray(preds["predicted_noise"]).shape == (5, 48, 6) and len(preds["losses"]) == 6

    # SWA over the last 20% of 10 epochs: the mean of the weights after epochs 8 and 9
    _, rows = _fit(data, tmp_path / "swa", max_epochs=10, use_swa=True, lr_scheduler=None)
    assert len(rows) == 10
    assert os.listdir(tmp_path / "swa" / "models" / "best_by_swa") == ["epoch=10.ckpt"]
    swa = torch.load(tmp_path / "swa" / "models" / "best_by_swa" / "epoch=10.ckpt", weights_only=True)["state_dict"]
    weights = [torch.load(tmp_path / "swa" / "train_state" / f"state_epoch={epoch}.pt", weights_only=True)["model"]
               for epoch in (8, 9)]  # the two train states kept
    name = "token_decoder.dense2.weight"
    assert not torch.equal(weights[0][name], weights[1][name])
    torch.testing.assert_close(swa[name], (weights[0][name] + weights[1][name]) / 2, atol=1e-7, rtol=0)

    # patience 2: the fit ends at the second epoch in a row without a new best validation loss
    _, rows = _fit(data, tmp_path / "stop", max_epochs=8, early_stop_patience=2, lr_scheduler=None, lr=0.0)
    best, waited, stop = np.inf, 0, None
    for r in rows:
        best, waited = (r["val_loss"], 0) if r["val_loss"] < best else (best, waited + 1)
        if waited == 2:
            stop = r["epoch"]
            break
    assert stop is not None and rows[-1]["epoch"] == stop < 7

    def term_at_epoch_one(epoch):
        if epoch == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return arrays

    trainer = Trainer(_model(seed=1), DiffusionSchedule.create("cosine", T, device="cpu"),
                      TrainConfig(batch_size=5, max_epochs=4, seed=0), steps_per_epoch=3)
    handler = signal.getsignal(signal.SIGTERM)
    rows = trainer.fit(arrays, results_dir=str(tmp_path / "term"), train_args=TRAIN_ARGS,
                       train_data_refresh=term_at_epoch_one)
    assert [r["epoch"] for r in rows] == [0, 1] and signal.getsignal(signal.SIGTERM) == handler
    assert os.listdir(tmp_path / "term" / "train_state") == ["state_epoch=1.pt"]


@pytest.mark.parametrize("best_by,idx", [("valid", -1), ("train", 0)])
def test_jax_from_dir_loads_the_port_trained_directory(fitted, best_by, idx):
    out = str(fitted[0])
    jmodel, params, constants, _ = jax_io.from_dir(out, idx=idx, best_by=best_by)
    model, _ = model_io.from_dir(out, device="cpu", idx=idx, best_by=best_by, attention_impl="plain")
    x, t, mask = _inputs(b=4, seed=2)
    with torch.no_grad():
        ours = model(x, t, mask).numpy()
    jcfg = JaxConfig(**{**jmodel.config.__dict__, "matmul_precision": "highest"})
    ref = np.asarray(JaxBert(jcfg).apply({"params": params, "constants": constants}, jnp.asarray(x.numpy()),
                                         jnp.asarray(t.numpy()), jnp.asarray(mask.numpy())))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    assert not np.allclose(ours, _model(seed=1).eval()(x, t, mask).detach().numpy())  # trained, not the init


def test_save_model_dir_keeps_top_k(tmp_path):
    model = _model()
    for epoch in (3, 1, 7, 5):
        model_io.save_model_dir(str(tmp_path), model.config, model.state_dict(), TRAIN_ARGS, epoch=epoch,
                                best_by="train", keep_top_k=2)
    assert sorted(os.listdir(tmp_path / "models" / "best_by_train")) == ["epoch=5.ckpt", "epoch=7.ckpt"]


def test_train_refuses_what_is_not_ported(monkeypatch, tmp_path):
    """train() takes use_mesh and ngpu as JAX's does (ngpu unused: the ranks
    of a process group are the devices; without one there is no mesh), and
    refuses the card when there is none."""
    import inspect

    params = inspect.signature(orchestration.train).parameters
    assert params["use_mesh"].default is True and params["ngpu"].default == -1
    class Featurizing(Exception):
        pass

    def featurize(**kw):
        raise Featurizing

    monkeypatch.setattr(orchestration, "get_train_valid_test_sets", featurize)
    for kw in ({"use_mesh": True}, {"ngpu": 4}):  # accepted: train() goes on to featurize
        with pytest.raises(Featurizing):
            orchestration.train(results_dir=str(tmp_path / "m"), device="cpu", **kw)
    assert orchestration.data_mesh(64) is None
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device cuda: no CUDA device is available"):
        orchestration.train(results_dir=str(tmp_path / "x"))
    assert not (tmp_path / "x").exists()


def _cli(args, **kw):
    return subprocess.run([sys.executable, "bin/train_torch.py", *args], cwd=REPO, capture_output=True, text=True,
                          timeout=300, **kw)


def test_train_torch_cli_on_cpu(pdb_dir, tmp_path):
    import json

    cfg = {**TRAIN_ARGS, "min_seq_len": 0, "trim_strategy": "leftalign", "batch_size": 8, "lr": 1e-4,
           "lr_scheduler": "LinearWarmup", "multithread": False, "save_state_every": 1}
    cfg_file = tmp_path / "tiny.json"
    cfg_file.write_text(json.dumps(cfg))
    env = {**os.environ, "FOLDINGDIFF_CACHE_DIR": str(tmp_path)}
    proc = _cli([str(cfg_file), "--dataset", pdb_dir, "--epochs", "1", "--device", "cpu", "-o",
                 str(tmp_path / "out")], env=env)
    assert proc.returncode == 0, proc.stderr
    assert len(_csv(tmp_path / "out" / "logs" / "metrics.csv")) == 2
    assert glob.glob(str(tmp_path / "out" / "models" / "best_by_valid" / "epoch=0.ckpt"))
    model, _ = model_io.from_dir(str(tmp_path / "out"), device="cpu")
    assert model.config.hidden_size == 48
    proc = _cli([str(cfg_file), "--dataset", pdb_dir, "-o", str(tmp_path / "no_card")],
                env={**env, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not (tmp_path / "no_card").exists()
