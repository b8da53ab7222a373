"""
The port's multi-device layer (foldingdiff_tpu_torch/parallel/ and the
meshes of its trainers, samplers and CLIs) on the CPU with gloo, at 2 layers
x 64, 4 heads, L = 32: a run over N ranks holds equal to one process of the
port and to the JAX package's mesh on the same numpy inputs.

Each process group starts once per module (torch.multiprocessing.spawn, a
file store): one of 2 ranks and one of 4. The workers compute every case and
save what they found; the tests assert on it. Workers import this module,
so it imports no JAX at its top: the JAX references are made inside the
tests. Dropout is 0 wherever results are compared (each rank draws its own
masks), and t, noise and the AR causal lengths are injected.

- A DP train step over 2 ranks on a ragged batch (B = 6, whose shards hold
  90 and 31 positions) and on B = 5 (90 and 22, and a zero row of padding),
  smooth-L1, pdist and L1 + circle penalty: the loss within 1e-5 of one
  process (and at B = 5 of JAX's Trainer on a 2-device mesh), gradients
  within rtol 1e-4 / atol 1e-6, the parameters after the step within 1e-6
  where the gradient clears 1e-6 (elsewhere 2 lr). The pdist term, a mean of
  squared distance errors after float32 chain builds, is held within rtol
  1e-5 of one process, and against JAX both are held to the port's float64
  step, as tests/test_torch_training.py holds the gradients. Averaging each
  rank's own mean misses JAX's loss.
- An AR DP step with zero-length rows against JAX's ARTrainer on one device.
- Sharded DDPM and DDIM sampling and reconstruction against one rank.
- fit over 2 ranks: metrics equal to one process, files on rank 0 only,
  resume from rank 0's train state on both ranks.
- Megatron TP over (1, 2), (2, 1), (2, 2) and (1, 4): the forward within 1e-5
  of one device, one train step (parameters and Adam moments) equal to one
  device's, the spec rules against JAX's, a head count the model axis does
  not divide refused.
- bin/train_torch.py --multihost and the parallel.multihost worker as two
  processes each.
"""
import csv
import functools
import json
import math
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from foldingdiff_tpu_torch.diffusion import sampling
from foldingdiff_tpu_torch.diffusion.noise import q_sample
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.models import io as model_io
from foldingdiff_tpu_torch.models.ar import BertForAutoregressive
from foldingdiff_tpu_torch.models.bert import BertForDiffusion
from foldingdiff_tpu_torch.models.config import ModelConfig
from foldingdiff_tpu_torch.parallel import multihost, tp
from foldingdiff_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from foldingdiff_tpu_torch.training.ar_trainer import ARTrainer, causal_lengths
from foldingdiff_tpu_torch.training.trainer import Trainer, TrainConfig, _per_feature_losses

REPO = Path(__file__).resolve().parent.parent
MINI_FIXTURE = str(REPO / "tests" / "mini_model_for_testing" / "results")
L, T, LR = 32, 25, 1e-3
CFG = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
           max_position_embeddings=L)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
DP_CASES = {"smooth_l1": {}, "pdist": {"use_pdist_loss": (0.2, 1.0)}, "l1_norm": {"l1_norm": 1e-4, "circle_reg": 0.1}}
DP_STEPS = [(case, b) for case in DP_CASES for b in (6, 5)]
LENGTHS = [32, 30, 28, 12, 10, 9]  # over 2 ranks: rows 0-2 hold 90 positions, rows 3-5 31 (B = 5: 22)
AR_LENGTHS = [20, 32, 0, 7, 0]  # zero-length rows, and a zero row of padding over 2 ranks
SAMPLE_LENGTHS = [20, 21, 22, 23, 24, 25, 26]  # batch 4: chunks of 4 and 3, the second padded over 2 ranks
TP_MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}
FIT_KW = dict(lr=3e-4, batch_size=4, lr_scheduler="LinearWarmup", seed=0)
GROUP_TIMEOUT = 240  # seconds for a group's workers to finish


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the workers use: these small eager steps run
    many tiny ops, which a thread pool slows down, the more so on cores that
    other test workers and this module's ranks share."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


# -- inputs and steps shared by the workers and the tests -------------------
def _model(model_cls=BertForDiffusion, **fields) -> BertForDiffusion:
    return model_io.init_random(ModelConfig(**{**CFG, **NO_DROPOUT, **fields}), torch.Generator().manual_seed(0),
                                model_cls=model_cls)


def _schedule() -> DiffusionSchedule:
    return DiffusionSchedule.create("cosine", T, device="cpu")


def _wrap(x):
    return ((x + np.pi) % (2 * np.pi) - np.pi).astype(np.float32)


def _dp_inputs(b: int):
    rng = np.random.default_rng(3)
    lengths = np.array(LENGTHS[:b])
    batch = {"angles": rng.uniform(-np.pi, np.pi, (b, L, 6)).astype(np.float32),
             "attn_mask": (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32), "lengths": lengths}
    return batch, rng.integers(0, T, b), _wrap(rng.normal(size=(b, L, 6)))


def _tensors(batch, t, noise):
    return {k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(t), torch.from_numpy(noise)


def _dp_kw(case: str, b: int) -> dict:
    return dict(lr=LR, batch_size=b, max_epochs=1, lr_scheduler=None, seed=0, **DP_CASES[case])


def _dp_step(case: str, b: int, mesh=None) -> dict:
    """One train step of the port, over the mesh's ranks or in this process:
    its loss and terms, the gradients of the global loss (the L1 term's
    added, as JAX's value_and_grad gives them, before the clip), the
    parameters and the Adam moments after the step."""
    kw = _dp_kw(case, b)
    tb, tt, tn = _tensors(*_dp_inputs(b))
    probe = Trainer(_model(), _schedule(), TrainConfig(**kw), 1, mesh=mesh)
    probe.model.train()
    probe._loss_terms(tb, tt, tn).mean().backward()
    named = list(probe.model.named_parameters())
    if mesh is not None:
        mesh.reduce_gradients(named)
    l1 = kw.get("l1_norm", 0.0)
    grads = {n: (p.grad + l1 * torch.where(p >= 0, 1.0, -1.0)).numpy() for n, p in named}
    trainer = Trainer(_model(), _schedule(), TrainConfig(**kw), 1, mesh=mesh)
    avg, terms = trainer.train_step(tb, tt, tn)
    out = {"avg": avg.item(), "terms": terms.numpy(), "grads": grads,
           "params": {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()},
           "moments": {n: {k: trainer.optimizer.state[p][k].numpy().copy() for k in ("exp_avg", "exp_avg_sq")}
                       for n, p in trainer.model.named_parameters()}}
    if mesh is not None and case == "smooth_l1" and b == 5:
        # What plain DDP would report: each rank's own masked mean, averaged over the ranks
        batch, t, noise = trainer._local(tb, tt, tn)
        model = _model().train()
        corrupted = q_sample(batch["angles"], t, noise, _schedule(), [True] * 6)
        local = _per_feature_losses(model(corrupted, t, batch["attn_mask"]), noise, batch["attn_mask"], [True] * 6,
                                    "smooth_l1", 0.0).mean().detach()
        out["ddp_average"] = (mesh.all_reduce(local) / mesh.size).item()
    return out


def _ar_inputs():
    rng = np.random.default_rng(4)
    lengths = np.array(AR_LENGTHS)
    batch = {"angles": rng.uniform(-np.pi, np.pi, (len(lengths), L, 6)).astype(np.float32),
             "attn_mask": (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32), "lengths": lengths}
    return batch, rng.uniform(size=len(lengths)).astype(np.float32)


AR_KW = dict(lr=LR, batch_size=len(AR_LENGTHS), max_epochs=1, lr_scheduler=None, seed=0)


def _ar_step(mesh=None) -> dict:
    batch, u = _ar_inputs()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    causal = causal_lengths(torch.from_numpy(u), tb["lengths"], L)
    trainer = ARTrainer(_model(BertForAutoregressive), TrainConfig(**AR_KW), 1, mesh=mesh)
    loss = trainer.train_step(tb, causal)
    return {"loss": loss.item(), "params": {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}}


def _sample(method: str, mesh=None):
    model, _ = model_io.from_dir(MINI_FIXTURE, device="cpu")
    schedule = DiffusionSchedule.create("linear", 20, device="cpu")
    kw = dict(ddim_steps=8, ddim_eta=0.5, return_history=True) if method == "ddim" else {}
    return sampling.sample(model, schedule, is_angular=[True] * 6, pad=64, lengths=SAMPLE_LENGTHS, batch_size=4,
                           mean_offset=np.linspace(-1, 1, 6), seed=11, method=method, mesh=mesh, **kw)


def _reconstruct(mesh=None):
    model, _ = model_io.from_dir(MINI_FIXTURE, device="cpu")
    schedule = DiffusionSchedule.create("linear", 20, device="cpu")
    rng = np.random.default_rng(6)
    lengths = np.array([40, 64, 52, 45, 61])
    data = {"angles": _wrap(rng.normal(size=(5, 64, 6))),
            "attn_mask": (np.arange(64)[None, :] < lengths[:, None]).astype(np.float32), "lengths": lengths}
    return sampling.get_reconstruction_error(model, schedule, data, is_angular=[True] * 6, noise_timesteps=6,
                                             batch_size=3, seed=2, mesh=mesh)


def _fit_arrays():
    rng = np.random.default_rng(8)
    lengths = rng.integers(10, L + 1, 16)
    return {"angles": rng.uniform(-np.pi, np.pi, (16, L, 6)).astype(np.float32),
            "attn_mask": (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32), "lengths": lengths}


def _fit(results_dir: str, max_epochs: int, mesh=None, resume=False, **fit_kw):
    trainer = Trainer(_model(), _schedule(), TrainConfig(max_epochs=max_epochs, **FIT_KW), steps_per_epoch=4,
                      mesh=mesh)
    arrays = _fit_arrays()
    rows = trainer.fit(arrays, valid_data=arrays, results_dir=results_dir, train_args={"timesteps": T},
                       save_state_every=1, resume=resume, **fit_kw)
    return trainer, rows


RESUME_KW = dict(exhaustive_t_validation=True, exhaustive_t_points=3)


def _tp_inputs():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(-np.pi, np.pi, (5, L, 6)).astype(np.float32))
    mask = torch.from_numpy((np.arange(L)[None, :] < rng.integers(L // 2, L + 1, (5, 1))).astype(np.float32))
    return x, torch.from_numpy(rng.integers(0, T, 5)), mask


# -- the workers ----------------------------------------------------------------
def _tp_case(shape) -> dict:
    mesh = tp.make_mesh_2d(*shape)
    out = {"forward": tp.TPRunner(_model(), mesh)(*_tp_inputs()).numpy()}
    trainer = tp.shard_train_state(Trainer(_model(), _schedule(), TrainConfig(**_dp_kw("smooth_l1", 5)), 1), mesh)
    avg, terms = tp.tp_train_step(trainer, *_tensors(*_dp_inputs(5)))
    out.update(avg=avg.item(), terms=terms.numpy(),
               params={n: t.numpy() for n, t in tp.full_state_dict(trainer.model, mesh).items()
                       if n != "time_embed.W"},
               moments={n: {k: tp.unshard(trainer.optimizer.state[p][k], tp.spec_for(n), mesh.model).numpy()
                            for k in ("exp_avg", "exp_avg_sq")} for n, p in trainer.model.named_parameters()},
               local_heads=trainer.model.encoder.layer[0].attention.self.n_heads)
    return out


def _two_rank_cases(tmp: Path) -> dict:
    mesh = make_mesh()
    out = {"dp": {(case, b): _dp_step(case, b, mesh) for case, b in DP_STEPS}, "ar": _ar_step(mesh),
           "demo": multihost.dp_train_step_demo(seed=0)}
    for method in ("ddpm", "ddim"):
        out[method] = _sample(method, mesh)
    out["recon"] = _reconstruct(mesh)

    # fit, each rank into its own directory (as on hosts with their own disks)
    own = tmp / f"fit_rank{mesh.rank}"
    _, out["fit_rows"] = _fit(str(own), 2, mesh)
    out["fit_files"] = sorted(str(p.relative_to(own)) for p in own.rglob("*")) if own.exists() else []
    resumed, out["resumed_rows"] = _fit(str(own), 3, mesh, resume=True, write_preds_to_dir=str(own / "preds"),
                                        **RESUME_KW)
    out["resumed_step"] = resumed.step
    out["resumed_files"] = sorted(str(p.relative_to(own)) for p in own.rglob("*")) if own.exists() else []
    out["resumed_params"] = {n: p.detach().numpy().copy() for n, p in resumed.model.named_parameters()}

    out["tp"] = {shape: _tp_case(shape) for shape in TP_MESHES[2]}
    try:
        tp.TPRunner(_model(hidden_size=48, num_attention_heads=3, intermediate_size=96), tp.make_mesh_2d(1, 2))
    except ValueError as e:
        out["tp_refusal"] = str(e)
    return out


def _four_rank_cases(tmp: Path) -> dict:
    out = {"tp": {shape: _tp_case(shape) for shape in TP_MESHES[4]}}
    try:
        tp.make_mesh_2d(3, 1)
    except ValueError as e:
        out["mesh_refusal"] = str(e)
    return out


def _group_worker(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    multihost.initialize(f"file://{tmp}/store", world, rank, device="cpu")
    try:
        results = (_two_rank_cases if world == 2 else _four_rank_cases)(Path(tmp))
        torch.save(results, f"{tmp}/rank{rank}.pt")
    finally:
        multihost.shutdown()


def _start_processes(tmp: Path):
    """Two runs of two processes each: bin/train_torch.py --multihost
    --coordinator (1 epoch on 16 synthetic PDB files, both ranks featurizing
    into one cache) and the parallel.multihost worker's demo. Returns the
    processes; each writes its output to tmp/out<i>.txt and tmp/err<i>.txt."""
    from tests.helpers import make_synthetic_pdb_dir

    pdbs = str(tmp / "pdbs")
    make_synthetic_pdb_dir(pdbs, n=16, seed=2, min_len=30)
    cfg = {"angles_definitions": "canonical-full-angles", "max_seq_len": L, "min_seq_len": 0,
           "trim_strategy": "leftalign", "timesteps": T, "variance_schedule": "cosine", "num_hidden_layers": 2,
           "hidden_size": 48, "intermediate_size": 96, "num_heads": 4, "position_embedding_type": "relative_key",
           "batch_size": 8, "lr": 1e-4, "multithread": False, "save_state_every": 1}
    (tmp / "tiny.json").write_text(json.dumps(cfg))
    cli_port, worker_port = _free_ports(2)
    argvs = [["bin/train_torch.py", str(tmp / "tiny.json"), "--dataset", pdbs, "--epochs", "1", "--cpu",
              "-o", str(tmp / "out"), "--multihost", "--coordinator", f"localhost:{cli_port}", "--nprocs", "2",
              "--procid", str(r)] for r in range(2)]
    argvs += [["-m", "foldingdiff_tpu_torch.parallel.multihost", "--coordinator", f"localhost:{worker_port}",
               "--nprocs", "2", "--procid", str(r), "--device", "cpu", "demo"] for r in range(2)]
    env = {**os.environ, "FOLDINGDIFF_CACHE_DIR": str(tmp)}
    procs = []
    for i, argv in enumerate(argvs):
        with open(tmp / f"out{i}.txt", "w") as out, open(tmp / f"err{i}.txt", "w") as err:
            procs.append(subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env, stdout=out, stderr=err))
    return procs


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The 2- and 4-rank groups and the four processes, all started together
    (their work overlaps); everything left running is stopped at the end."""
    tmps = {world: tmp_path_factory.mktemp(f"{world}_ranks") for world in (2, 4)}
    ctxs = {world: mp.start_processes(_group_worker, args=(world, str(tmp)), nprocs=world, join=False,
                                      start_method="spawn") for world, tmp in tmps.items()}
    proc_tmp = tmp_path_factory.mktemp("processes")
    procs = _start_processes(proc_tmp)
    yield tmps, ctxs, proc_tmp, procs, time.monotonic() + GROUP_TIMEOUT
    for p in [*procs, *(q for ctx in ctxs.values() for q in ctx.processes)]:
        p.kill()


@pytest.fixture(scope="module")
def groups(started):
    """{world: every rank's results}; any rank's failure raises. JAX's
    references (cached) are made while the ranks work."""
    tmps, ctxs, _, _, deadline = started
    for case in DP_CASES:
        _jax_dp_step(case, 5)
    for world, ctx in ctxs.items():
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world}-rank group did not finish in {GROUP_TIMEOUT} s")
    return {world: [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
            for world, tmp in tmps.items()}


@pytest.fixture(scope="module")
def two(groups):
    return groups[2]


@pytest.fixture(scope="module")
def four(groups):
    return groups[4]


@pytest.fixture(scope="module")
def processes(started):
    """(the CLI's results directory, the worker ranks' outputs); any process
    that fails raises."""
    _, _, tmp, procs, deadline = started
    for i, p in enumerate(procs):
        p.wait(timeout=max(deadline - time.monotonic(), 1))
        assert p.returncode == 0, (tmp / f"err{i}.txt").read_text()
    return tmp / "out", [(tmp / f"out{i}.txt").read_text() for i in (2, 3)]


# -- checks -----------------------------------------------------------------------
def _check_params(got: dict, want: dict, grads: dict, lr: float, floors=None, atol=1e-6, rtol=0.0) -> None:
    """Parameters after a first Adam step: within atol + rtol |p| where the
    gradient clears its floor (1e-6); elsewhere within 2 lr, since a first
    step moves an element by about lr, its sign set by float noise there."""
    for n, ref in want.items():
        big = np.abs(grads[n]) > (floors or {}).get(n, 1e-6)
        np.testing.assert_allclose(got[n][big], ref[big], atol=atol, rtol=rtol, err_msg=n)
        assert np.all(np.abs(got[n][~big] - ref[~big]) <= 2 * lr), n


def _circular(a, b) -> float:
    return float(np.abs(_wrap(np.asarray(a) - np.asarray(b))).max())


@functools.cache
def _jax_dp_step(case: str, b: int) -> dict:
    """JAX's Trainer on a 2-device mesh, from the port's initial weights, t and
    noise injected (zero-padded as shard_batch pads the batch): the loss and
    terms, the gradients and the parameters after _step_impl's update, from
    one compiled program."""
    import jax
    import jax.numpy as jnp

    from foldingdiff_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule
    from foldingdiff_tpu.models import io as jax_io
    from foldingdiff_tpu.models.bert import BertForDiffusion as JaxBert
    from foldingdiff_tpu.models.config import ModelConfig as JaxConfig
    from foldingdiff_tpu.parallel import mesh as jax_mesh
    from foldingdiff_tpu.training import trainer as jax_trainer

    kw = _dp_kw(case, b)
    jcfg = JaxConfig(**CFG, **NO_DROPOUT, matmul_precision="highest")
    mesh = jax_mesh.make_mesh(jax.devices()[:2])
    jt = jax_trainer.Trainer(JaxBert(jcfg), JaxSchedule.create("cosine", T), jax_trainer.TrainConfig(**kw), 1,
                             mesh=mesh)
    params, constants = jax_io.convert_torch_state_dict(_model().state_dict(), jcfg)
    state = jt.init_state(jax.random.PRNGKey(0), pad=L)
    state = state.replace(params=jax_mesh.replicate(mesh, params), constants=jax_mesh.replicate(mesh, constants),
                          opt_state=jax_mesh.replicate(mesh, jt.tx.init(params)))
    batch, t, noise = _dp_inputs(b)
    pad = (-b) % 2
    t = np.concatenate([t, np.zeros(pad, t.dtype)]).astype(np.int32)
    noise = np.concatenate([noise, np.zeros((pad, L, 6), np.float32)])
    jbatch = dict(zip(batch, jax_mesh.shard_batch(mesh, *batch.values())))
    key = jax.random.PRNGKey(1)
    l1 = kw.get("l1_norm", 0.0)

    def loss(p):
        terms = jt._loss_terms(p, state.constants, jbatch, key, deterministic=False)
        avg = jnp.mean(terms)
        if l1 > 0:
            avg = avg + l1 * sum(jnp.sum(jnp.abs(x)) for x in jax.tree.leaves(p))
        return avg, terms

    @jax.jit
    def step(st):
        return jax.value_and_grad(loss, has_aux=True)(st.params), jt._step_impl(st, jbatch, key)[0]

    with pytest.MonkeyPatch.context() as monkeypatch:  # JAX's step draws t and noise inside: hand it these
        monkeypatch.setattr(jax_trainer, "sample_wrapped_noise", lambda *a, **k: jnp.asarray(noise))
        monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(t))
        ((avg, terms), grads), new_state = step(state)
    config = ModelConfig(**CFG, **NO_DROPOUT)
    return {"avg": float(avg), "terms": np.asarray(terms),
            "grads": {n: v.numpy() for n, v in model_io.state_dict_from_flax(
                jax.tree.map(np.asarray, grads), {}, config).items()},
            "params": {n: v.numpy() for n, v in model_io.state_dict_from_flax(
                jax.tree.map(np.asarray, new_state.params), {}, config).items()}}


def _float64_step(case: str, b: int):
    """The port's loss terms and gradients of the same step in float64 (one process)."""
    tb, tt, tn = _tensors(*_dp_inputs(b))
    trainer = Trainer(_model().double().train(), _schedule(), TrainConfig(**_dp_kw(case, b)), 1)
    terms = trainer._loss_terms({**tb, "angles": tb["angles"].double()}, tt, tn.double())
    terms.mean().backward()
    return terms.detach().numpy(), {n: p.grad.numpy() for n, p in trainer.model.named_parameters()}


# -- data parallelism ---------------------------------------------------------------
@pytest.mark.parametrize("case,b", DP_STEPS)
def test_dp_train_step_matches_one_process(two, case, b):
    dp, other = two[0]["dp"][case, b], two[1]["dp"][case, b]
    one = _dp_step(case, b)
    assert dp["avg"] == other["avg"]  # the global loss on every rank
    assert dp["terms"].shape == ((7,) if case == "pdist" else (6,))
    np.testing.assert_allclose(dp["terms"][:6], one["terms"][:6], atol=1e-5, rtol=0)
    if case == "pdist":  # a mean of squared distance errors after float32 chain builds (as for one device)
        np.testing.assert_allclose(dp["terms"][6], one["terms"][6], rtol=1e-5)
        np.testing.assert_allclose(dp["avg"], one["avg"], rtol=1e-5)
    else:
        np.testing.assert_allclose(dp["avg"], one["avg"], atol=1e-5, rtol=0)
    for n, g in dp["grads"].items():
        np.testing.assert_allclose(g, one["grads"][n], rtol=1e-4, atol=1e-6, err_msg=n)
        np.testing.assert_array_equal(g, other["grads"][n])
    _check_params(dp["params"], one["params"], one["grads"], LR)
    initial = _model().state_dict()
    for n, p in dp["params"].items():
        np.testing.assert_array_equal(p, other["params"][n])  # the ranks stay replicated
        assert np.abs(p - initial[n].numpy()).max() > 0, n


@pytest.mark.parametrize("case", DP_CASES)
def test_dp_train_step_matches_jax_mesh(two, case):
    """B = 5 over 2 ranks: shards of 90 and 22 positions, the second with a
    zero row of padding, as JAX's shard_batch pads it."""
    dp, ref = two[0]["dp"][case, 5], _jax_dp_step(case, 5)
    np.testing.assert_allclose(dp["terms"][:6], ref["terms"][:6], atol=1e-5, rtol=0)
    floors = None
    if case == "pdist":
        # The chain builds make the pdist term and its gradients ill-conditioned
        # in float32 (a denoised chain at large t), in JAX and in the port
        # alike: both are held against the port's float64 step, the port at
        # least as close as JAX (as tests/test_torch_training.py does)
        t64, g64 = _float64_step(case, 5)
        assert abs(dp["terms"][6] - t64[6]) <= 1.5 * abs(ref["terms"][6] - t64[6]) + 1e-6
        floors = {}
        for n, g in dp["grads"].items():
            jax_err = np.abs(ref["grads"][n] - g64[n]).max()
            assert np.abs(g - g64[n]).max() <= 1.5 * jax_err + 1e-7, n
            floors[n] = max(10 * jax_err, 1e-6)
    else:
        np.testing.assert_allclose(dp["avg"], ref["avg"], atol=1e-5, rtol=0)
        for n, g in dp["grads"].items():
            np.testing.assert_allclose(g, ref["grads"][n], rtol=1e-4, atol=1e-6, err_msg=n)
    _check_params(dp["params"], ref["params"], ref["grads"], LR, floors)


def test_averaging_each_ranks_mean_would_miss_the_global_loss(two):
    """Plain DDP averages each rank's own masked mean. The shards of the
    ragged batch hold 90 and 22 positions, so that average is not JAX's mean
    over the global batch; the port's global counts are."""
    ref = _jax_dp_step("smooth_l1", 5)
    dp = two[0]["dp"]["smooth_l1", 5]
    assert abs(dp["avg"] - ref["avg"]) <= 1e-5
    assert abs(dp["ddp_average"] - ref["avg"]) > 1e-3, (dp["ddp_average"], ref["avg"])


def test_ar_dp_step_with_zero_length_rows_matches_jax(two, monkeypatch):
    import jax
    import jax.numpy as jnp

    from foldingdiff_tpu.models import io as jax_io
    from foldingdiff_tpu.models.ar import BertForAutoregressive as JaxAR
    from foldingdiff_tpu.models.config import ModelConfig as JaxConfig
    from foldingdiff_tpu.training import ar_trainer as jax_ar_trainer
    from foldingdiff_tpu.training.trainer import TrainConfig as JaxTrainConfig

    jcfg = JaxConfig(**CFG, **NO_DROPOUT, matmul_precision="highest")
    jt = jax_ar_trainer.ARTrainer(JaxAR(jcfg), JaxTrainConfig(**AR_KW), steps_per_epoch=1)
    params, constants = jax_io.convert_torch_state_dict(_model(BertForAutoregressive).state_dict(), jcfg)
    state = jt.init_state(jax.random.PRNGKey(0), pad=L)
    state = state.replace(params=params, constants=constants, opt_state=jt.tx.init(params))
    batch, u = _ar_inputs()
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(u))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(1)
    (ref_loss, ref_grads), (new_state, _) = jax.jit(lambda st: (jax.value_and_grad(
        lambda p: jt._loss(p, st.constants, jbatch, key, deterministic=False))(st.params),
        jt._step_impl(st, jbatch, key)))(state)
    config = ModelConfig(**CFG, **NO_DROPOUT)
    want = model_io.state_dict_from_flax(jax.tree.map(np.asarray, new_state.params), {}, config)
    grads = model_io.state_dict_from_flax(jax.tree.map(np.asarray, ref_grads), {}, config)

    dp, one = two[0]["ar"], _ar_step()
    assert dp["loss"] == two[1]["ar"]["loss"]
    np.testing.assert_allclose(dp["loss"], float(ref_loss), atol=1e-6, rtol=0)
    np.testing.assert_allclose(dp["loss"], one["loss"], atol=1e-6, rtol=0)
    want = {n: v.numpy() for n, v in want.items()}
    grads = {n: v.numpy() for n, v in grads.items()}
    _check_params(dp["params"], want, grads, LR, atol=1e-5, rtol=1e-4)
    _check_params(dp["params"], one["params"], grads, LR, atol=1e-6)


@pytest.mark.parametrize("method", ["ddpm", "ddim"])
def test_sharded_sampling_matches_one_rank(two, method):
    """Two ranks, chunks of 4 and 3 (one padded row), T = 20: rank 0 returns
    what one rank samples (DDIM with eta 0.5 and its history), rank 1 None."""
    got, one = two[0][method], _sample(method)
    assert two[1][method] is None
    assert [s.shape for s in got] == [s.shape for s in one]
    assert got[0].shape == ((8, 20, 6) if method == "ddim" else (20, 6))
    for a, b in zip(got, one):
        assert _circular(a, b) <= 1e-5


def test_sharded_reconstruction_matches_one_rank(two):
    got, one = two[0]["recon"], _reconstruct()
    assert two[1]["recon"] is None
    assert [r.shape for r in got] == [r.shape for r in one] == [(n, 6) for n in (40, 64, 52, 45, 61)]
    for a, b in zip(got, one):
        assert _circular(a, b) <= 1e-5


def test_dp_train_step_demo_matches_one_process(two):
    assert two[0]["demo"] == two[1]["demo"]
    np.testing.assert_allclose(two[0]["demo"], multihost.dp_train_step_demo(seed=0, batch_size=4), atol=1e-6)


# -- fit: metrics, writes, resume ------------------------------------------------------
def test_fit_metrics_equal_one_process_and_only_rank_0_writes(two, tmp_path):
    _, one_rows = _fit(str(tmp_path / "one"), 2)
    for rows in (two[0]["fit_rows"], two[1]["fit_rows"]):
        assert [r["epoch"] for r in rows] == [0, 1] and rows[-1]["step"] == 8
        for got, want in zip(rows, one_rows):
            for k, v in want.items():
                if k != "epoch_seconds":
                    np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)
    files = two[0]["fit_files"]
    assert "logs/metrics.csv" in files and "train_state/state_epoch=1.pt" in files
    assert any(f.startswith("models/best_by_valid/") for f in files)
    assert two[1]["fit_files"] == []  # rank 1 wrote nothing


def test_resume_from_rank_0_reaches_every_rank(two, tmp_path):
    """Only rank 0's directory holds train_state/: both ranks continue at
    epoch 2 with the same parameters, as one process resumed from it does."""
    _fit(str(tmp_path / "one"), 2)
    one, one_rows = _fit(str(tmp_path / "one"), 3, resume=True, write_preds_to_dir=str(tmp_path / "preds"),
                         **RESUME_KW)
    for rank in (0, 1):
        rows = two[rank]["resumed_rows"]
        assert [r["epoch"] for r in rows] == [2] and rows[0]["step"] == 12 and two[rank]["resumed_step"] == 12
        np.testing.assert_allclose(rows[0]["val_loss"], one_rows[0]["val_loss"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(rows[0]["train_loss"], one_rows[0]["train_loss"], atol=1e-5, rtol=0)
    for n, p in two[0]["resumed_params"].items():
        np.testing.assert_array_equal(p, two[1]["resumed_params"][n])
        np.testing.assert_allclose(p, one.model.state_dict()[n].numpy(), atol=1e-4, rtol=0, err_msg=n)
    assert "preds/2_preds.json" in two[0]["resumed_files"] and two[1]["resumed_files"] == []
    assert (tmp_path / "preds" / "2_preds.json").exists()


# -- tensor parallelism ----------------------------------------------------------------
def _tp_results(two, four, shape):
    world = 2 if shape in TP_MESHES[2] else 4
    return [r["tp"][shape] for r in (two if world == 2 else four)]


ALL_TP = TP_MESHES[2] + TP_MESHES[4]


@pytest.mark.parametrize("shape", ALL_TP)
def test_tp_forward_matches_one_device(two, four, shape):
    ranks = _tp_results(two, four, shape)
    with torch.no_grad():
        want = _model().eval()(*_tp_inputs()).numpy()
    for r in ranks:
        np.testing.assert_allclose(r["forward"], want, atol=1e-5, rtol=0)
    assert ranks[0]["local_heads"] == CFG["num_attention_heads"] // shape[1]


@pytest.mark.parametrize("shape", ALL_TP)
def test_tp_train_step_matches_one_device(two, four, shape):
    """Parameters (gathered from their shards) and Adam moments after one TP
    step, against one device's; the key biases' gradients are float noise
    (softmax ignores a shift of a query's scores), so their moments are held
    to 1e-8."""
    one = _dp_step("smooth_l1", 5)
    for r in _tp_results(two, four, shape):
        np.testing.assert_allclose(r["avg"], one["avg"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["terms"], one["terms"], atol=1e-5, rtol=0)
        assert sorted(r["params"]) == sorted(one["params"])
        _check_params(r["params"], one["params"], one["grads"], LR)
        for n, m in r["moments"].items():
            for k, v in m.items():
                np.testing.assert_allclose(v, one["moments"][n][k], rtol=1e-4, atol=1e-8, err_msg=f"{n} {k}")


def _flax_path(name: str) -> str:
    """The JAX package's parameter path of a port state-dict entry of an encoder layer."""
    m = re.match(r"encoder\.layer\.(\d+)\.(.+)\.(weight|bias)$", name)
    module = m.group(2).replace("attention.self.", "attention_self/").replace(".", "_")
    leaf = {"weight": "embedding" if "distance_embedding" in module else
            "scale" if "LayerNorm" in module else "kernel", "bias": "bias"}[m.group(3)]
    return f"encoder_layer_{m.group(1)}/{module}/{leaf}"


def test_tp_spec_rules_cover_every_dense_kernel_as_jax_does():
    from foldingdiff_tpu.parallel import tp as jax_tp

    names = list(_model().state_dict())
    sharded = [n for n in names if tp.spec_for(n)]
    for n in names:
        if n.startswith("encoder."):
            want = tuple(jax_tp._spec_for(_flax_path(n)))
            # a torch Linear weight is the transpose of a flax kernel
            assert tp.spec_for(n) == (tuple(reversed(want)) if n.endswith("weight") else want), n
        else:
            assert tp.spec_for(n) == (), n
    # q, k, v and intermediate (weight and bias) and both output dense weights, per layer
    assert len(sharded) == CFG["num_hidden_layers"] * 10
    dense = [n for n, m in _model().named_modules() if isinstance(m, torch.nn.Linear) and n.startswith("encoder.")]
    assert all(tp.spec_for(f"{n}.weight") for n in dense)


def test_tp_refuses_what_the_model_axis_does_not_divide(two, four):
    for r in two:
        assert "3 attention heads" in r["tp_refusal"] and "model axis of 2" in r["tp_refusal"]
    for r in four:
        assert "needs 3 ranks" in r["mesh_refusal"]


# -- processes: the training CLI and the worker -------------------------------------------
def _free_ports(n: int) -> list:
    """n distinct free ports on localhost (all held open while they are chosen)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def test_train_cli_multihost_two_processes_write_one_directory(processes):
    out, _ = processes
    with open(out / "logs" / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0"] and math.isfinite(float(rows[0]["val_loss"]))
    assert os.listdir(out / "models" / "best_by_valid") == ["epoch=0.ckpt"]
    assert os.listdir(out / "train_state") == ["state_epoch=0.pt"]
    assert json.loads((out / "training_args.json").read_text())["device"] == "cpu"


def test_multihost_worker_runs_the_demo_on_two_processes(processes):
    losses = [json.loads(o.strip().splitlines()[-1]) for o in processes[1]]
    assert [x["rank"] for x in losses] == [0, 1] and losses[0]["loss"] == losses[1]["loss"]
    np.testing.assert_allclose(losses[0]["loss"], multihost.dp_train_step_demo(seed=0, batch_size=4), atol=1e-6)


def test_initialize_refuses_nccl_on_the_cpu_and_partial_coordinates(monkeypatch):
    with pytest.raises(ValueError, match="nccl backend runs on CUDA devices only"):
        multihost.initialize("localhost:1", 1, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("localhost:1", device="cpu")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("localhost:1", 1, 0)
    assert not dist.is_initialized() and multihost.is_primary()


def test_shard_batch_zero_pads_to_the_ranks():
    mesh = Mesh(None, rank=1, size=2)  # rank 1's view of 2, without a process group
    a = np.arange(10).reshape(5, 2)
    got_np, got_t = shard_batch(mesh, a, torch.from_numpy(a))
    np.testing.assert_array_equal(got_np, [[6, 7], [8, 9], [0, 0]])
    assert torch.equal(got_t, torch.tensor([[6, 7], [8, 9], [0, 0]]))
    with pytest.raises(ValueError, match="batch dims differ"):
        shard_batch(mesh, a, a[:4])
