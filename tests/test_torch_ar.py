"""
The port's autoregressive baseline (models/ar.py, training/ar_trainer.py,
data/datasets.AutoregressiveCausalDataset and sample_length, from_dir's
model_cls, and bin/{train,sample}_autoregressive_torch.py and
bin/sample_random_angles_torch.py) against the JAX package's on the CPU, at
2 layers x 48, 4 heads, M = 32:
- the forward from JAX's initial parameters (through state_dict_from_flax),
  `relative_key` and `absolute`, at prefixes of 1, 4 and 31 keys, within
  1e-5; the denoiser's ordering (the length embedding added after the
  embeddings' LayerNorm) on the same weights is not;
- the v2 attention entry on causal prefix masks: JAX's Pallas kernel in
  interpret mode against the port's plain version, within 1e-5;
- ar_sample against JAX's from the same seeds, within 1e-4, also for a
  length past the pad;
- one ARTrainer step against JAX's from the same parameters, dropout 0, with
  JAX's causal lengths replayed and injected: loss within 1e-6, gradients
  within rtol 1e-4, parameters within 1e-5 / rtol 1e-4 where the gradient
  exceeds 1e-6 (elsewhere within 2 lr); zero-length rows do not reach the loss;
- the causal items and the length draws equal to JAX's;
- AR directories crossing both ways, and the three CLIs end to end.
"""
import dataclasses
import glob
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldingdiff_tpu.data import datasets as jax_datasets
from foldingdiff_tpu.models import io as jax_io
from foldingdiff_tpu.models.ar import BertForAutoregressive as JaxAR
from foldingdiff_tpu.models.ar import ar_sample as jax_ar_sample
from foldingdiff_tpu.models.config import ModelConfig as JaxConfig
from foldingdiff_tpu.ops.pallas_attention import fused_attention_v2 as jax_fused_attention_v2
from foldingdiff_tpu.training import ar_trainer as jax_ar_trainer
from foldingdiff_tpu.training.trainer import TrainConfig as JaxTrainConfig
from foldingdiff_tpu_torch.data import datasets as dsets
from foldingdiff_tpu_torch.models import io as model_io
from foldingdiff_tpu_torch.models.ar import BertForAutoregressive, ar_sample
from foldingdiff_tpu_torch.models.bert import BertForDiffusion
from foldingdiff_tpu_torch.models.config import ModelConfig
from foldingdiff_tpu_torch.ops.attention import REL_ATTENTION, fused_attention_v2_reference
from foldingdiff_tpu_torch.training.ar_trainer import ARTrainer, causal_lengths
from foldingdiff_tpu_torch.training.trainer import TrainConfig
from tests.helpers import make_synthetic_pdb_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 32
SMALL = dict(hidden_size=48, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
             max_position_embeddings=L)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
POSITIONS = ("relative_key", "absolute")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these eager loops run many tiny ops, which a
    thread pool slows down, the more so on cores that other test workers
    share."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module", params=POSITIONS)
def jax_model(request):
    """(JAX model, params, constants) at JAX's initial parameters, float32 matmuls at "highest"."""
    cfg = JaxConfig(**SMALL, **NO_DROPOUT, position_embedding_type=request.param, matmul_precision="highest")
    model = JaxAR(cfg)
    variables = model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, L, 6)), jnp.ones((1, L)),
                           jnp.full((1,), L), deterministic=True)
    return model, jax.tree.map(np.asarray, variables["params"]), jax.tree.map(np.asarray, variables["constants"])


def _port(jax_model, **fields):
    model, params, constants = jax_model
    config = ModelConfig(**SMALL, **NO_DROPOUT, position_embedding_type=model.config.position_embedding_type,
                         **fields)
    port = BertForAutoregressive(config)
    port.load_state_dict(model_io.state_dict_from_flax(params, constants, config), strict=True)
    return port.eval()


def _jax_apply(jax_model, x, mask, lengths):
    model, params, constants = jax_model
    return np.asarray(model.apply({"params": params, "constants": constants}, jnp.asarray(x), jnp.asarray(mask),
                                  jnp.asarray(lengths), deterministic=True))


def _inputs(prefix, b=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-np.pi, np.pi, (b, L, 6)).astype(np.float32)
    mask = np.broadcast_to((np.arange(L) < prefix).astype(np.float32), (b, L)).copy()
    return x, mask, np.array([20, 32, 7][:b])


# -- the forward -------------------------------------------------------------
@pytest.mark.parametrize("prefix", [1, 4, 31])
def test_forward_matches_jax(jax_model, prefix):
    x, mask, lengths = _inputs(prefix)
    want = _jax_apply(jax_model, x, mask, lengths)
    model = _port(jax_model)
    REL_ATTENTION.launches = 0
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(lengths)).numpy()
    assert REL_ATTENTION.launches == 0  # CPU tensors take the plain version
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # The denoiser's ordering, the length embedding after the embeddings'
    # LayerNorm, computes another function on the same weights
    with torch.inference_mode():
        diffusion_order = BertForDiffusion.forward(model, torch.from_numpy(x), torch.from_numpy(lengths),
                                                   torch.from_numpy(mask)).numpy()
    assert np.abs(diffusion_order - want).max() > 1e-2


@pytest.mark.parametrize("rel", [True, False])
def test_v2_entry_on_causal_masks_matches_jax_kernel(rel):
    """JAX's v2 Pallas kernel (interpret mode) against the port's plain v2
    on the bias of ar_sample's and the trainer's prefix masks."""
    b, h, d, m = 4, 4, 16, L
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(b, h, L, d)).astype(np.float32) for _ in range(3))
    prefix = np.array([1, 4, 17, 31])
    bias = np.where(np.arange(L)[None, :] < prefix[:, None], 0.0, -10000.0).astype(np.float32)
    table = (rng.normal(size=(2 * m - 1, d)) * 0.5).astype(np.float32) if rel else None
    want = jax_fused_attention_v2(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                  rel_table=None if table is None else jnp.asarray(table),
                                  m=m if rel else None, interpret=True)
    got = fused_attention_v2_reference(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                                       rel_table=None if table is None else torch.from_numpy(table),
                                       m=m if rel else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("lengths", [[20, 32], [20, 36]])  # 36: past the pad, where JAX's slices clamp
def test_ar_sample_matches_jax(jax_model, lengths):
    model, params, constants = jax_model
    rng = np.random.default_rng(0)
    seeds = rng.uniform(-1, 1, size=(2, L, 6)).astype(np.float32)
    lengths = np.array(lengths)
    want = np.asarray(jax_ar_sample(model, params, constants, jnp.asarray(seeds), lengths, num_seed=4))
    port = _port(jax_model).train()
    got = ar_sample(port, torch.from_numpy(seeds), torch.from_numpy(lengths), num_seed=4)
    assert port.training  # the caller's mode is restored
    np.testing.assert_array_equal(got[:, :4].numpy(), seeds[:, :4])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


# -- one train step ------------------------------------------------------------
def _batch(pad_value=0.0):
    rng = np.random.default_rng(3)
    lengths = np.array([32, 20, 0, 0])
    angles = rng.uniform(-np.pi, np.pi, size=(4, L, 6)).astype(np.float32)
    angles[2:] = pad_value
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    return {"angles": angles, "attn_mask": mask, "lengths": lengths}


def test_train_step_matches_jax(jax_model):
    model, params, constants = jax_model
    kw = dict(lr=1e-3, batch_size=4, max_epochs=1, lr_scheduler=None, seed=0)
    jt = jax_ar_trainer.ARTrainer(model, JaxTrainConfig(**kw), steps_per_epoch=1)
    state = jt.init_state(jax.random.PRNGKey(0), pad=L)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(1)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jt._loss(p, state.constants, jbatch, key, deterministic=False)))(state.params)
    new_state, step_loss = jax.jit(jt._step_impl)(state, jbatch, key)
    assert float(step_loss) == float(ref_loss)

    # JAX's draw, replayed (ar_trainer.py:65-69), then injected into the port
    c_key, _ = jax.random.split(key)
    u = np.array(jax.random.uniform(c_key, (4,)))
    want_len = np.asarray(jnp.clip((1 + jnp.asarray(u) * (jbatch["lengths"].astype(jnp.float32) - 1))
                                   .astype(jnp.int32), 1, L - 1))
    causal = causal_lengths(torch.from_numpy(u), torch.from_numpy(batch["lengths"]), L)
    np.testing.assert_array_equal(causal.numpy(), want_len)
    assert causal[2:].tolist() == [1, 1]  # zero-length rows clip to 1

    config = _port(jax_model).config
    port = BertForAutoregressive(config)
    port.load_state_dict(model_io.state_dict_from_flax(jax.tree.map(np.asarray, state.params),
                                                       jax.tree.map(np.asarray, state.constants), config))
    trainer = ARTrainer(port, TrainConfig(**kw), steps_per_epoch=1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    port.train()
    loss = trainer._loss(tb, causal)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-6, rtol=0)
    want_grads = model_io.state_dict_from_flax(jax.tree.map(np.asarray, ref_grads), {}, config)
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    assert sorted(grads) == sorted(want_grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[n].numpy(), rtol=1e-4, atol=1e-6, err_msg=n)

    assert torch.equal(trainer.train_step(tb, causal), loss.detach()) and trainer.step == 1
    want = model_io.state_dict_from_flax(jax.tree.map(np.asarray, new_state.params),
                                         jax.tree.map(np.asarray, new_state.constants), config)
    for n, p in port.named_parameters():
        got, ref, g = p.detach().numpy(), want[n].numpy(), want_grads[n].numpy()
        big = np.abs(g) > 1e-6  # below it a first Adam step's direction is float noise
        np.testing.assert_allclose(got[big], ref[big], atol=1e-5, rtol=1e-4, err_msg=n)
        assert np.all(np.abs(got[~big] - ref[~big]) <= 2 * kw["lr"]), n

    # What the zero-length rows hold never reaches the loss
    garbage = {k: torch.from_numpy(v) for k, v in _batch(pad_value=2.5).items()}
    assert torch.equal(trainer.eval_step(tb, causal), trainer.eval_step(garbage, causal))


# -- data ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def pdb_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pdbs"))
    make_synthetic_pdb_dir(d, n=16, seed=7, min_len=30)
    return d


def test_causal_items_and_length_draws_equal_jax(pdb_dir, tmp_path):
    kw = dict(pdbs=pdb_dir, split="train", pad=40, min_length=0, n_workers=1)
    ours = dsets.AnglesOnlyDataset(cache_dir=str(tmp_path), **kw)  # the two packages' cache files differ
    ref = jax_datasets.AnglesOnlyDataset(cache_dir=str(tmp_path), **kw)
    assert ours.all_lengths == ref.all_lengths and max(ours.all_lengths) > 40  # untrimmed
    assert [ours.sample_length() for _ in range(3)] == [ref.sample_length() for _ in range(3)]
    assert ours.sample_length(7) == ref.sample_length(7)
    noised = dsets.NoisedAnglesDataset(ours, timesteps=5, seed=0)
    assert noised.sample_length(4) == jax_datasets.NoisedAnglesDataset(ref, timesteps=5, seed=0).sample_length(4)
    # Both wrappers over one clean dataset, from one seed
    a, b = dsets.AutoregressiveCausalDataset(ours, seed=3), jax_datasets.AutoregressiveCausalDataset(ours, seed=3)
    assert len(a) == len(b) == len(ours) and a.pad == 40
    for i in list(range(len(ours))) * 2:
        got, want = a[i], b[i]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["causal_attn_mask"].sum() == got["causal_idx"] < got["lengths"]


# -- directories across the packages, and the CLIs ---------------------------
def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "bin", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def trained(pdb_dir, tmp_path_factory):
    """A relative_key AR directory written by bin/train_autoregressive_torch.py on the CPU."""
    tmp = tmp_path_factory.mktemp("ar")
    config = {"dataset_key": pdb_dir, "angles_definitions": "canonical-full-angles", "max_seq_len": L,
              "min_seq_len": 0, "num_hidden_layers": 2, "hidden_size": 48, "intermediate_size": 96, "num_heads": 4,
              "position_embedding_type": "relative_key", "batch_size": 4, "lr": 1e-3}
    (tmp / "config.json").write_text(json.dumps(config))
    cache = os.environ.get("FOLDINGDIFF_CACHE_DIR")
    os.environ["FOLDINGDIFF_CACHE_DIR"] = str(tmp)
    try:
        rows = _script("train_autoregressive_torch").main(
            [str(tmp / "config.json"), "-o", str(tmp / "out"), "--epochs", "2", "--cpu"])
    finally:
        if cache is None:
            os.environ.pop("FOLDINGDIFF_CACHE_DIR")
        else:
            os.environ["FOLDINGDIFF_CACHE_DIR"] = cache
    return tmp / "out", rows


def test_train_cli_writes_a_directory_jax_loads(trained):
    out, rows = trained
    assert [r["epoch"] for r in rows] == [0, 1] and all(np.isfinite(r["train_loss"]) for r in rows)
    assert rows[-1]["step"] == 2 * (12 // 4)  # 12 training structures in full batches of 4
    csv_rows = (out / "logs" / "metrics.csv").read_text().splitlines()
    assert csv_rows[0] == "epoch,step,train_loss,val_loss,epoch_seconds" and len(csv_rows) == 3
    args = json.loads((out / "training_args.json").read_text())
    assert args["seq_len_encoding"] == "gaussian_fourier" and "time_encoding" not in args
    assert sorted(os.path.basename(p) for p in glob.glob(str(out / "models" / "best_by_valid" / "*"))) == \
        ["epoch=0.ckpt", "epoch=1.ckpt"]

    jmodel, params, constants, _ = jax_io.from_dir(str(out))  # the torch .ckpt path
    jar = JaxAR(dataclasses.replace(jmodel.config, matmul_precision="highest"))
    model, _ = model_io.from_dir(str(out), device="cpu", model_cls=BertForAutoregressive)
    assert isinstance(model, BertForAutoregressive) and not model.training
    x, mask, lengths = _inputs(prefix=9)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, _jax_apply((jar, params, constants), x, mask, lengths), atol=1e-5, rtol=0)


def test_port_loads_a_jax_written_ar_directory(jax_model, tmp_path):
    model, params, constants = jax_model
    pos = model.config.position_embedding_type
    train_args = {"angles_definitions": "canonical-full-angles", "max_seq_len": L, "num_hidden_layers": 2,
                  "hidden_size": 48, "intermediate_size": 96, "num_heads": 4, "position_embedding_type": pos,
                  "dropout_p": 0.0, "seq_len_encoding": "gaussian_fourier"}
    jax_io.save_model_dir(str(tmp_path), model.config, params, constants, train_args)
    port, _ = model_io.from_dir(str(tmp_path), device="cpu", model_cls=BertForAutoregressive)
    x, mask, lengths = _inputs(prefix=4)
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, _jax_apply(jax_model, x, mask, lengths), atol=1e-5, rtol=0)


def test_sample_clis_end_to_end(trained, pdb_dir, tmp_path, monkeypatch):
    out, _ = trained
    monkeypatch.setenv("FOLDINGDIFF_CACHE_DIR", str(tmp_path))
    result = _script("sample_autoregressive_torch").main(
        ["-m", str(out), "--data", pdb_dir, "-n", "3", "--numseed", "4", "-o", str(tmp_path / "ar"), "--cpu"])
    test_lengths = dsets.AnglesOnlyDataset(pdbs=pdb_dir, split="test", pad=L, min_length=0, n_workers=1,
                                           cache_dir=str(tmp_path)).all_lengths
    assert len(result["lengths"]) == 3 and set(result["lengths"]) <= set(test_lengths)
    for i, (angles, length) in enumerate(zip(result["angles"], result["lengths"])):
        length = min(length, L)  # a length beyond the pad is cut to it, as in JAX
        assert angles.shape == (length, 6) and np.all(np.isfinite(angles))
        assert angles.min() >= -np.pi and angles.max() < np.pi
        csv = np.loadtxt(tmp_path / "ar" / "sampled_angles" / f"ar_generated_{i}.csv.gz", delimiter=",",
                         skiprows=1)
        np.testing.assert_array_equal(csv, angles)
        pdb = (tmp_path / "ar" / "sampled_pdb" / f"ar_generated_{i}.pdb").read_text().splitlines()
        assert sum(line.startswith("ATOM") for line in pdb) == 3 * length

    rand = _script("sample_random_angles_torch").main(
        ["-m", str(out), "--data", pdb_dir, "-n", "4", "-o", str(tmp_path / "random"), "--cpu"])
    assert len(rand["pdb_files"]) == 4
    pool = np.concatenate([dsets.AnglesOnlyDataset(pdbs=pdb_dir, split="test", pad=L, min_length=0, n_workers=1,
                                                   zero_center=False, cache_dir=str(tmp_path))[i]["angles"]
                           for i in range(3)])
    for angles in rand["angles"]:
        assert len(angles) in [min(t, L) for t in test_lengths]  # lengths as the split's items hold them
        for j in range(6):  # every value comes from the test split's own column
            assert np.isin(angles[:, j], pool[:, j]).all()


@pytest.mark.parametrize("name", ["train_autoregressive_torch", "sample_autoregressive_torch",
                                  "sample_random_angles_torch"])
def test_clis_refuse_a_missing_card(name, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    argv = [] if name.startswith("train") else ["-m", "x", "--data", "y"]
    with pytest.raises(SystemExit, match="--device cuda: no CUDA device is available"):
        _script(name).main(argv)
