"""
The bodies that the port captures as CUDA graphs, run eagerly on the CPU
(a CUDA graph needs the card; tests/test_torch_cuda.py holds the graphs
themselves against the eager loops there):
- the table-driven reverse steps (sampling.TableChain, the bodies of
  sampling's graphed loops, one step per segment) against the eager loops,
  bit for bit: DDPM (full chain, start_t, a per-feature noise_scale,
  return_history), DDIM (eta 0; eta 0.5 from a generator and from given
  step noise) and DPM-Solver++ at T = 10, and the generator's state after
  the chain;
- the same bodies against the JAX package's loops on the same numpy inputs
  and injected noise, within the chain tolerance of 1e-4 (linear T = 10);
- the train step's graph body with its learning rate in a tensor against
  train_step over 3 steps of the one-cycle schedule, within 1e-6: a tensor
  learning rate is the schedule's float64 value rounded to float32, so each
  update moves by a float32 ulp of lr more or less; fused_steps = 3 (one
  body of three steps) against three bodies of one step, bit for bit; the
  epoch's grouping into full groups and single steps;
- that the bodies neither read the device back nor copy from the host,
  which a capture refuses (an audit of the dispatched operations);
- the float32 transcription of optax.adamw that tests/test_torch_cuda.py
  holds the card's capturable AdamW to, against optax itself;
- StepGraph's refusals, and its launch accounting with a stand-in library.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from foldingdiff_tpu.diffusion import sampling as jax_sampling
from foldingdiff_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule
from foldingdiff_tpu.models import io as jax_io
from foldingdiff_tpu_torch import graphs
from foldingdiff_tpu_torch.diffusion import sampling
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule, ddim_table, ddpm_table, dpmpp_table
from foldingdiff_tpu_torch.models import io as model_io
from foldingdiff_tpu_torch.models.config import ModelConfig
from foldingdiff_tpu_torch.training import checkpoint
from foldingdiff_tpu_torch.training.trainer import Trainer, TrainConfig
from tests.test_torch_cuda import optax_adamw_f32

MINI_FIXTURE = os.path.join(os.path.dirname(__file__), "mini_model_for_testing", "results")
IS_ANGULAR = [True, True, True, True, True, False]
T, B, L = 10, 3, 64
NOISE_SCALE = (0.5, 1.0, 1.5, 2.0, 1.0, 0.8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the chains and steps here run many tiny ops,
    which a thread pool slows down, the more so on cores that other test
    workers share."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def mini():
    model, _ = model_io.from_dir(MINI_FIXTURE, device="cpu")
    rng = np.random.default_rng(7)
    x = rng.uniform(-np.pi, np.pi, (B, L, 6)).astype(np.float32)
    mask = (np.arange(L)[None, :] < np.array([[64], [50], [41]])).astype(np.float32)
    return model, DiffusionSchedule.create("linear", T, device="cpu"), x, mask


def _chain(method, table, model, x, mask, **options):
    return sampling.TableChain(method, table, model, torch.from_numpy(x), torch.from_numpy(mask),
                               torch.tensor(IS_ANGULAR), graphed=False, **options)


# (start_t, noise_scale, return_history)
DDPM_CASES = [(None, 1.0, False), (7, 1.0, False), (None, NOISE_SCALE, False), (None, 1.0, True), (4, NOISE_SCALE, True)]


@pytest.mark.parametrize("start_t,noise_scale,history", DDPM_CASES)
def test_ddpm_body_equals_the_eager_loop(mini, start_t, noise_scale, history):
    model, schedule, x, mask = mini
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    ref = sampling.p_sample_loop(model, torch.from_numpy(x), torch.from_numpy(mask), schedule, IS_ANGULAR,
                                 generator=gens[0], noise_scale=np.asarray(noise_scale, np.float32),
                                 start_t=start_t, return_history=history)
    scale = noise_scale if isinstance(noise_scale, float) else torch.tensor(noise_scale)
    chain = _chain("ddpm", ddpm_table(schedule, start_t or T), model, x, mask, noise_scale=scale,
                   draws=True, return_history=history)
    ours = chain.run(torch.from_numpy(x), torch.from_numpy(mask), gens[1])
    assert torch.equal(ours, ref)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())  # the last step (t = 0) draws nothing


@pytest.mark.parametrize("eta,source", [(0.0, None), (0.5, "generator"), (0.5, "step_noise")])
def test_ddim_body_equals_the_eager_loop(mini, eta, source):
    model, schedule, x, mask = mini
    n = 6
    gens = [torch.Generator().manual_seed(4) for _ in range(2)]
    step_noise = (torch.from_numpy(np.random.default_rng(5).normal(size=(n, B, L, 6)).astype(np.float32))
                  if source == "step_noise" else None)
    ref = sampling.ddim_sample_loop(model, torch.from_numpy(x), torch.from_numpy(mask), schedule, IS_ANGULAR,
                                    n_steps=n, eta=eta, generator=gens[0] if source == "generator" else None,
                                    step_noise=step_noise, return_history=True)
    chain = _chain("ddim", ddim_table(schedule, n, eta), model, x, mask,
                   draws=source == "generator", step_noise=step_noise is not None, return_history=True)
    ours = chain.run(torch.from_numpy(x), torch.from_numpy(mask), gens[1] if source == "generator" else None,
                     step_noise)
    assert torch.equal(ours, ref)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.parametrize("history", [False, True])
def test_dpmpp_body_equals_the_eager_loop(mini, history):
    model, schedule, x, mask = mini
    ref = sampling.dpmpp_sample_loop(model, torch.from_numpy(x), torch.from_numpy(mask), schedule, IS_ANGULAR,
                                     n_steps=7, return_history=history)
    chain = _chain("dpmpp", dpmpp_table(schedule, 7), model, x, mask, return_history=history)
    assert torch.equal(chain.run(torch.from_numpy(x), torch.from_numpy(mask)), ref)


def test_a_chain_runs_again_from_its_start(mini):
    """A cached chain's second run starts from its counter's first value and
    fresh buffers: the same x_T and generator seed give the same result."""
    model, schedule, x, mask = mini
    chain = _chain("dpmpp", dpmpp_table(schedule, 5), model, x, mask)
    first = chain.run(torch.from_numpy(x), torch.from_numpy(mask))
    chain.run(torch.from_numpy(x[::-1].copy()), torch.from_numpy(mask))
    assert torch.equal(chain.run(torch.from_numpy(x), torch.from_numpy(mask)), first)


@pytest.fixture(scope="module")
def jax_mini():
    """The mini fixture's JAX denoiser at matmul_precision "highest", as a model_fn."""
    jmodel, params, constants, _ = jax_io.from_dir(MINI_FIXTURE)
    jmodel = type(jmodel)(dataclasses.replace(jmodel.config, matmul_precision="highest"))

    def jax_fn(x_, t_, m_):
        return jmodel.apply({"params": params, "constants": constants}, x_, t_, m_, deterministic=True)

    return jax_fn


@pytest.mark.parametrize("method", ["ddpm", "ddim", "dpmpp"])
def test_bodies_match_jax_given_its_noise(mini, jax_mini, method):
    """The table-driven bodies against the JAX package's loops on the mini
    fixture's weights, from the same x_T; DDPM given the normals JAX's
    p_sample_loop draws, DDIM at eta 0."""
    model, schedule, x, mask = mini
    jax_fn = jax_mini

    key, n = jax.random.PRNGKey(11), 6
    args = (jax_fn, jnp.asarray(x), key, jnp.asarray(mask), JaxSchedule.create("linear", T), IS_ANGULAR)
    if method == "ddpm":
        ref = jax_sampling.p_sample_loop(*args)
        step_noise = np.stack([np.array(jax.random.normal(k, x.shape, dtype=jnp.float32))
                               for k in jax.random.split(key, T)])
        chain = _chain("ddpm", ddpm_table(schedule, T), model, x, mask, step_noise=True)
        ours = chain.run(torch.from_numpy(x), torch.from_numpy(mask), step_noise=torch.from_numpy(step_noise))
    elif method == "ddim":
        ref = jax_sampling.ddim_sample_loop(*args, n_steps=n)
        ours = _chain("ddim", ddim_table(schedule, n, 0.0), model, x, mask).run(
            torch.from_numpy(x), torch.from_numpy(mask))
    else:
        ref = jax_sampling.dpmpp_sample_loop(*args, n_steps=n)
        ours = _chain("dpmpp", dpmpp_table(schedule, n), model, x, mask).run(
            torch.from_numpy(x), torch.from_numpy(mask))
    err = np.abs((ours.numpy() - np.asarray(ref) + np.pi) % (2 * np.pi) - np.pi)
    assert err.max() <= 1e-4


def test_loops_on_the_cpu_run_eagerly(mini):
    """cuda_graphs is the default, and a CPU tensor runs the eager loop: no
    TableChain is made."""
    model, schedule, x, mask = mini
    made = []
    real = sampling.TableChain.__init__

    def spy(self, *args, **kwargs):
        made.append(args[0])
        real(self, *args, **kwargs)

    sampling.TableChain.__init__ = spy
    try:
        run = sampling.build_sampler(model, schedule, IS_ANGULAR, method="ddim", ddim_steps=3)
        run(torch.from_numpy(x), torch.from_numpy(mask))
    finally:
        sampling.TableChain.__init__ = real
    assert made == []


# -- graph safety ----------------------------------------------------------------
class HostTraffic(TorchDispatchMode):
    """Records the dispatched operations that a CUDA graph capture refuses or
    cannot hold: a read of a device value on the host (_local_scalar_dense,
    nonzero) and a tensor made from host data (lift_fresh: on the card a copy
    from the host)."""

    REFUSED = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(str(func).startswith(name) for name in self.REFUSED):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("method", ["ddpm", "ddim", "dpmpp"])
def test_chain_bodies_neither_read_back_nor_copy_from_the_host(mini, method):
    model, schedule, x, mask = mini
    table = {"ddpm": ddpm_table(schedule, T), "ddim": ddim_table(schedule, 4, 0.5),
             "dpmpp": dpmpp_table(schedule, 4)}[method]
    chain = _chain(method, table, model, x, mask, draws=method != "dpmpp", return_history=True,
                   noise_scale=torch.tensor(NOISE_SCALE))
    chain.run(torch.from_numpy(x), torch.from_numpy(mask), torch.Generator().manual_seed(0))  # state set up
    audit = HostTraffic()
    with torch.inference_mode():
        chain.state.counter.zero_()
        with audit:
            chain.main()
            if chain.last is not None:
                chain.last()
    assert audit.seen == []


SMALL = ModelConfig(hidden_size=48, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
                    max_position_embeddings=48, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def _trainer(fused=1, pdist=(0.5, 1.0)):
    model = model_io.init_random(SMALL, torch.Generator().manual_seed(2))
    cfg = TrainConfig(lr=1e-3, batch_size=8, max_epochs=2, lr_scheduler="OneCycleLR", fused_steps=fused,
                      use_pdist_loss=pdist)
    return Trainer(model, DiffusionSchedule.create("cosine", 25, device="cpu"), cfg, steps_per_epoch=3)


def _batches(n, b=8, l=48):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        lengths = rng.integers(30, l + 1, b)
        out.append({"angles": rng.uniform(-np.pi, np.pi, (b, l, 6)).astype(np.float32),
                    "attn_mask": (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32),
                    "lengths": lengths.astype(np.int64)})
    return out


def _body_steps(trainer, batches, k):
    """The graphs' train-step body, run eagerly: len(batches) steps in bodies
    of k steps, each learning rate from the schedule in a tensor slot."""
    rows = []
    for start in range(0, len(batches), k):
        group = [trainer.to_device(b) for b in batches[start:start + k]]
        lrs = torch.tensor([trainer.lr_schedule(trainer.step + i) for i in range(len(group))], dtype=torch.float32)
        rows.append(trainer._steps_body(group, lrs)())
        trainer.step += len(group)
    return torch.cat(rows)


def test_train_body_with_a_tensor_lr_matches_train_step():
    batches = _batches(3)
    runs = {}
    for name in ("train_step", "body"):
        trainer = _trainer()
        torch.manual_seed(7)
        if name == "train_step":
            rows = torch.stack([torch.cat([a[None], t]) for a, t in
                                (trainer.train_step(trainer.to_device(b)) for b in batches)])
        else:
            rows = _body_steps(trainer, batches, 1)
        runs[name] = (rows, [p.detach().clone() for p in trainer.model.parameters()])
    (rows_a, params_a), (rows_b, params_b) = runs["train_step"], runs["body"]
    assert (rows_a - rows_b).abs().max().item() <= 1e-6
    assert max((p - q).abs().max().item() for p, q in zip(params_a, params_b)) <= 1e-6


def test_fused_body_of_three_steps_equals_three_single_steps():
    batches = _batches(6)
    runs = []
    for k in (1, 3):
        trainer = _trainer(fused=k)
        torch.manual_seed(7)
        runs.append((_body_steps(trainer, batches, k), [p.detach().clone() for p in trainer.model.parameters()],
                     trainer.generator.get_state()))
    (rows_1, params_1, gen_1), (rows_3, params_3, gen_3) = runs
    assert torch.equal(rows_1, rows_3) and torch.equal(gen_1, gen_3)
    assert all(torch.equal(p, q) for p, q in zip(params_1, params_3))


def test_train_body_neither_reads_back_nor_copies_from_the_host(monkeypatch):
    """The draws, the forward with dropout and pdist, the backward and the
    clip. AdamW's update is left out: on the CPU it reads its step counts on
    the host, where the card's capturable AdamW keeps them on the device
    (tests/test_torch_cuda.py captures that one)."""
    trainer = _trainer()
    batch = trainer.to_device(_batches(1)[0])
    lrs = torch.tensor([1e-3])
    trainer._steps_body([batch], lrs)()  # the optimizer's state made
    monkeypatch.setattr(trainer.optimizer, "step", lambda: None)
    audit = HostTraffic()
    with audit:
        trainer._steps_body([batch], lrs)()
    assert audit.seen == []


@pytest.mark.parametrize("fused,expected", [(1, [1] * 8), (3, [3, 3, 1, 1]), (4, [4, 1, 1, 1, 1])])
def test_an_epoch_groups_full_runs_of_one_shape(fused, expected, monkeypatch):
    """Seven full batches of 8 and a ragged tail of 5: full groups of
    fused_steps same-shape batches, the rest and the tail one by one."""
    trainer = _trainer(fused=fused)
    calls = []
    monkeypatch.setattr(trainer, "train_steps", lambda group: calls.append(len(group)) or
                        torch.zeros(len(group), 1 + len(trainer.is_angular) + 1))
    data = {k: np.concatenate([b[k] for b in _batches(8)])[:61] for k in ("angles", "attn_mask", "lengths")}
    steps = trainer._graphed_epoch(trainer._batches(data, np.random.default_rng(0), shuffle=True))
    assert calls == expected and len(steps) == 8


def test_trainer_graphs_only_on_one_card():
    """On the CPU fit() takes the eager step (as it does under a mesh or
    with remat), and its optimizer, plain AdamW there, keeps a float
    learning rate; train_steps refuses."""
    trainer = _trainer()
    assert not trainer.cuda_graphs and not torch.is_tensor(trainer.optimizer.param_groups[0]["lr"])
    with pytest.raises(RuntimeError, match="CUDA graphs"):
        trainer.train_steps(_batches(1))


def test_a_card_trainers_state_resumes_on_the_cpu(tmp_path):
    """A train state saved on the card holds a tensor learning rate and
    capturable step counts; a CPU trainer resumes from it with a float
    learning rate and host step counts, and steps as from its own."""
    batches = _batches(3)
    trainer = _trainer(pdist=0.0)
    for b in batches[:2]:
        trainer.train_step(trainer.to_device(b))
    state = trainer.optimizer.state_dict()
    path = checkpoint.save_train_state(str(tmp_path), trainer.model, trainer.optimizer, trainer.step, 0)
    payload = torch.load(path, weights_only=True)
    for group in payload["optimizer"]["param_groups"]:  # as a trainer on the card writes them
        group["lr"], group["capturable"] = torch.tensor(group["lr"]), True
    torch.save(payload, path)
    resumed = _trainer(pdist=0.0)
    assert resumed._restore(str(tmp_path)) == 1 and resumed.step == 2
    group = resumed.optimizer.param_groups[0]
    assert not torch.is_tensor(group["lr"]) and group["capturable"] is False
    assert all(s["step"].device.type == "cpu" for s in resumed.optimizer.state.values())
    assert all(torch.equal(resumed.optimizer.state[p]["step"], s["step"])
               for p, s in zip(resumed.model.parameters(), state["state"].values()))
    resumed.generator.set_state(trainer.generator.get_state())  # the draws of the step below
    torch.manual_seed(1)
    loss_a, _ = trainer.train_step(trainer.to_device(batches[2]))
    torch.manual_seed(1)
    loss_b, _ = resumed.train_step(resumed.to_device(batches[2]))
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(p, q) for p, q in zip(trainer.model.parameters(), resumed.model.parameters()))


# -- StepGraph --------------------------------------------------------------------
@pytest.mark.parametrize("device,error", [("cpu", ValueError), ("cuda", RuntimeError)])
def test_step_graph_refuses_the_cpu_and_a_missing_card(device, error, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error):
        graphs.StepGraph(lambda: None, device)


def test_captured_launches_are_taken_back_and_added_per_replay():
    class Library:  # a stand-in for ops.attention.CudaLibrary's counts
        launches, rel_off_launches = 5, 1

    lib, other = Library(), Library()
    account = graphs.CapturedLaunches([lib, other])
    with account.capturing():  # the body counts 12 launches of lib, 2 of them rel-off, during capture
        lib.launches += 12
        lib.rel_off_launches += 2
    assert (lib.launches, lib.rel_off_launches) == (5, 1) and account.per_replay == [(12, 2), (0, 0)]
    for _ in range(3):
        account.replayed()
    assert (lib.launches, lib.rel_off_launches, other.launches) == (5 + 36, 1 + 6, 5)


def test_optax_transcription_matches_optax():
    """optax_adamw_f32 (the reference of the card's AdamW in
    tests/test_torch_cuda.py) against optax.adamw over three steps at a
    changing learning rate: the same float32 operations, bit for bit."""
    import optax

    rng = np.random.default_rng(6)
    shapes = [(64, 48), (48,), (7, 3, 5)]
    start = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** -k).astype(np.float32) for s in shapes] for k in range(3)]
    lrs = [1e-3, 5e-4, 2e-3]
    schedule = lambda count: jnp.asarray(lrs, dtype=jnp.float32)[count]  # noqa: E731
    tx = optax.adamw(schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    params = [jnp.asarray(p) for p in start]
    state = tx.init(params)
    for step_grads in grads:
        updates, state = tx.update([jnp.asarray(g) for g in step_grads], state, params)
        params = optax.apply_updates(params, updates)
    ours = optax_adamw_f32(start, grads, lrs, 0.01)
    assert all(np.array_equal(np.asarray(p), q) for p, q in zip(params, ours))
