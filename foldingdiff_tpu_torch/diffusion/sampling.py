"""
Reverse-diffusion sampling (counterpart of foldingdiff_tpu/diffusion/sampling.py):
DDPM ancestral sampling, DDIM and DPM-Solver++, each with its full
history on request; partial DDPM chains for partial-noise reconstruction
(get_reconstruction_error); and sample_simple over a model directory.

Reference behavior: foldingdiff/sampling.py:27-224.
- p_sample (DDPM Eq. 11): mean = 1/sqrt(a_t) (x - b_t eps / sqrt(1 - abar_t)),
  plus sqrt(posterior_variance_t) noise for t > 0
- per-feature angular wrap after every step
- x_T ~ wrapped N(0, scale) noise
- mean-offset un-shift and re-wrap at the end
DDIM and DPM-Solver++ are the JAX package's accelerated samplers, which the
reference lacks; the port keeps their wrapped-angle adaptations (the x0 clamp
on angular channels, DPM-Solver++'s geodesic correction).

How a chain runs. Each chain's per-step scalars are a StepTable
(diffusion/schedules.py), built on the host once per chain. On the card the
loops run the JAX package's execution model (one device execution per
chunk, sampling.py:152-156): a TableChain holds the chain's state in static
buffers and a step counter on the device, and its table-driven step body
(ddpm_step_body, ddim_step_body, dpmpp_step_body) reads its timestep and
scalars from a device copy of the table through the counter and advances
it. One step of the body is captured as one CUDA graph (graphs.StepGraph),
DDPM's noiseless last step as a second, so the host's loop is only graph
replays; build_sampler caches the chains per shape, as JAX's jit caches per
shape. The body launches the kernels the eager step launches, in
the same order, on the same scalars, so a graphed chain gives the eager
chain's bits. On the CPU, or with cuda_graphs=False, each loop is an eager
Python loop under torch.inference_mode() that reads its scalars from the
host table: the reference the graphed chains are held to.

Seeds: sample() draws each chunk's x_T and per-step noise from its own
torch.Generator on the sampling device, seeded from (seed, chunk index)
through numpy's SeedSequence; get_reconstruction_error draws each batch's
eps and step noise the same way. The numbers differ from the JAX package's
for the same seed; only the distributions agree. A graphed chain draws from
a generator of its own, registered with its graphs, that takes the caller's
generator's state before the chain and hands it back after, so the caller's
generator ends where the eager chain leaves it.

Data parallelism (`mesh`, a parallel.mesh.Mesh; JAX's shard_fn,
sampling.py:474, 504-505, 538, 606-607): each chunk's rows are split over the
ranks, zero-padded to a multiple of them. Every rank still draws the whole
chunk's x_T and each step's whole noise from the chunk's generator and takes
its rows, so the rows a rank computes are the rows one device computes.
Rank 0 gathers the results on the host and returns them in order; the other
ranks return None.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from foldingdiff_tpu_torch.diffusion.noise import q_sample, sample_wrapped_noise
from foldingdiff_tpu_torch.diffusion.schedules import (  # noqa: F401 (dpmpp_nodes: this module's API too)
    DiffusionSchedule,
    StepTable,
    ddim_table,
    ddpm_coefs,
    ddpm_table,
    dpmpp_nodes,
    dpmpp_table,
)
from foldingdiff_tpu_torch.graphs import StepGraph
from foldingdiff_tpu_torch.ops.angles import wrap_angles, wrap_angular_features
from foldingdiff_tpu_torch.parallel.mesh import Mesh, gather_to_primary, shard_batch

ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
SAMPLING_METHODS = ("ddpm", "ddim", "dpmpp")
# (mesh, n): a loop's x holds this rank's rows of a chunk of n rows
Shard = Optional[Tuple[Mesh, int]]


def _normal(like: torch.Tensor, generator: torch.Generator, shard: Shard = None) -> torch.Tensor:
    """A standard normal draw shaped like `like` from generator; under a
    shard, the whole chunk's draw and this rank's rows of it."""
    if shard is None:
        return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)
    mesh, n = shard
    return shard_batch(mesh, torch.randn((n, *like.shape[1:]), generator=generator, dtype=like.dtype,
                                         device=like.device))


def p_sample_step(
    model_fn: ModelFn,
    x: torch.Tensor,
    t: int,
    noise: Optional[torch.Tensor],
    attn_mask: torch.Tensor,
    schedule: DiffusionSchedule,
    is_angular: torch.Tensor,
    noise_scale: float | torch.Tensor = 1.0,
) -> torch.Tensor:
    """
    One reverse step at timestep t (a Python int). model_fn(x, t_vec, mask)
    -> eps. `noise` (like x) is the posterior noise, added only when t > 0 and
    then unused (None is allowed at t = 0). noise_scale is a scalar or an (F,)
    tensor: the per-feature sampling temperature on that noise (1.0 is
    reference DDPM). Angular channels (is_angular, (F,) bool) are wrapped.
    The scalars are ddpm_coefs' float32 values at t.
    """
    sqrt_recip_alpha_t, beta_t, recip_sqrt_omac_t, sigma_t = (float(c) for c in ddpm_coefs(schedule, t)[0])
    t_vec = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
    eps_pred = model_fn(x, t_vec, attn_mask)
    x_next = sqrt_recip_alpha_t * (x - beta_t * eps_pred * recip_sqrt_omac_t)
    if t > 0:
        if torch.is_tensor(noise_scale):  # per feature, possibly made on the host
            noise_scale = noise_scale.to(device=x.device, dtype=x.dtype)
        x_next = x_next + sigma_t * (noise_scale * noise)
    return wrap_angular_features(x_next, is_angular)


def p_sample_loop(
    model_fn: ModelFn,
    noise: torch.Tensor,
    attn_mask: torch.Tensor,
    schedule: DiffusionSchedule,
    is_angular: Sequence[bool] | torch.Tensor,
    generator: Optional[torch.Generator] = None,
    step_noise: Optional[torch.Tensor] = None,
    noise_scale: float | np.ndarray | torch.Tensor = 1.0,
    start_t: Optional[int] = None,
    return_history: bool = False,
    shard: Shard = None,
    cuda_graphs: bool = True,
    chains: Optional["ChainCache"] = None,
) -> torch.Tensor:
    """
    Reverse chain S-1 .. 0 from x_S = `noise` (B, L, F), where S is start_t
    (a partial chain, partial-noise reconstruction's) or T. The posterior
    noise of step i (timestep S-1-i) is step_noise[i] when an (S, B, L, F)
    tensor is given, otherwise a fresh normal draw from `generator` (under
    `shard`, of the whole chunk, of which x holds this rank's rows).
    noise_scale is p_sample_step's temperature, a scalar or per feature.
    Returns x_0, or with return_history the (S, B, L, F) states after every
    step, kept in one tensor on the device.

    On a CUDA tensor with cuda_graphs (the default) the chain runs as CUDA
    graphs of one step each (a TableChain, reused from `chains`, a sampler's
    cache, when one is given); otherwise as the eager loop.
    """
    steps = schedule.timesteps if start_t is None else int(start_t)
    if not 1 <= steps <= schedule.timesteps:
        raise ValueError(f"start_t must be in [1, {schedule.timesteps}], got {start_t}")
    _check_noise_source(generator, step_noise, (steps, *noise.shape))
    if not isinstance(noise_scale, (int, float)):  # per feature: on the device once
        noise_scale = torch.as_tensor(noise_scale, dtype=noise.dtype, device=noise.device)
    is_angular = torch.as_tensor(is_angular, dtype=torch.bool, device=noise.device)
    if _graphed(cuda_graphs, noise):
        chain = _chain(chains, lambda: ddpm_table(schedule, steps), "ddpm", model_fn, noise, attn_mask, is_angular,
                       noise_scale=noise_scale, draws=generator is not None,
                       step_noise=step_noise is not None, return_history=return_history, shard=shard)
        return chain.run(noise, attn_mask, generator, step_noise)
    x = noise
    with torch.inference_mode():
        history = _history(steps, noise, return_history)
        for i, t in enumerate(range(steps - 1, -1, -1)):
            if t == 0:
                z = None
            elif step_noise is not None:
                z = step_noise[i]
            else:
                z = _normal(x, generator, shard)
            x = p_sample_step(model_fn, x, t, z, attn_mask, schedule, is_angular, noise_scale)
            if history is not None:
                history[i] = x
    return x if history is None else history


def _history(steps: int, like: torch.Tensor, return_history: bool) -> Optional[torch.Tensor]:
    """The (steps, *like.shape) tensor a loop fills with its state after each
    step, on like's device (one copy to the host at the end, no sync per
    step), or None without return_history."""
    return torch.empty((steps, *like.shape), dtype=like.dtype, device=like.device) if return_history else None


def _check_noise_source(generator, step_noise, shape) -> None:
    if (generator is None) == (step_noise is None):
        raise ValueError("give exactly one of generator and step_noise")
    if step_noise is not None and step_noise.shape != shape:
        raise ValueError(f"step_noise must be {shape}, got {tuple(step_noise.shape)}")


def _clamp_angular(x: torch.Tensor, is_angular: torch.Tensor) -> torch.Tensor:
    """Clamp angular channels to [-pi, pi] (the float32 pi, as jnp.clip)."""
    return torch.where(is_angular, x.clamp(-math.pi, math.pi), x)


def ddim_sample_loop(
    model_fn: ModelFn,
    noise: torch.Tensor,
    attn_mask: torch.Tensor,
    schedule: DiffusionSchedule,
    is_angular: Sequence[bool] | torch.Tensor,
    n_steps: int = 50,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
    step_noise: Optional[torch.Tensor] = None,
    return_history: bool = False,
    shard: Shard = None,
    cuda_graphs: bool = True,
    chains: Optional["ChainCache"] = None,
) -> torch.Tensor:
    """
    DDIM (Song et al. 2021) over the strided grid
    linspace(0, T-1, n_steps)[::-1], each step jumping to the next grid
    timestep (abar = 1 after the last), from x_T = `noise`; the scalars are
    ddim_table's. The x0 prediction of angular channels is clamped to
    [-pi, pi] before the jump, which wrapped-angle diffusion needs (see the
    JAX package's ddim_sample_loop); every step ends in the angular wrap.

    eta = 0 is deterministic and takes no noise source. eta > 0 adds
    sigma_i times step_noise[i] ((n_steps, B, L, F)) or a fresh normal draw
    from `generator` (of the whole chunk under `shard`, as p_sample_loop):
    give exactly one. Returns x_0, or with return_history the
    (n_steps, B, L, F) states after every step. cuda_graphs and chains as
    p_sample_loop's.
    """
    if eta > 0:
        _check_noise_source(generator, step_noise, (n_steps, *noise.shape))
    table = ddim_table(schedule, n_steps, eta)
    is_angular = torch.as_tensor(is_angular, dtype=torch.bool, device=noise.device)
    if _graphed(cuda_graphs, noise):
        chain = _chain(chains, lambda: table, "ddim", model_fn, noise, attn_mask, is_angular,
                       draws=eta > 0 and generator is not None, step_noise=eta > 0 and step_noise is not None,
                       return_history=return_history, shard=shard)
        return chain.run(noise, attn_mask, generator if eta > 0 else None, step_noise if eta > 0 else None)
    x = noise
    with torch.inference_mode():
        history = _history(n_steps, noise, return_history)
        for i in range(n_steps):
            c = table.row(i)
            t_vec = torch.full((x.shape[0],), int(table.t[i]), dtype=torch.int64, device=x.device)
            eps = model_fn(x, t_vec, attn_mask)
            x0 = _clamp_angular((x - c["sqrt_one_minus_a"] * eps) * c["recip_sqrt_a"], is_angular)
            dir_xt = c["dir_coef"] * eps
            x = c["sqrt_a_prev"] * x0 + dir_xt
            if eta > 0:
                z = step_noise[i] if step_noise is not None else _normal(x, generator, shard)
                x = x + c["sigma"] * z
            x = wrap_angular_features(x, is_angular)
            if history is not None:
                history[i] = x
    return x if history is None else history


def dpmpp_sample_loop(
    model_fn: ModelFn,
    noise: torch.Tensor,
    attn_mask: torch.Tensor,
    schedule: DiffusionSchedule,
    is_angular: Sequence[bool] | torch.Tensor,
    n_steps: int = 20,
    return_history: bool = False,
    cuda_graphs: bool = True,
    chains: Optional["ChainCache"] = None,
) -> torch.Tensor:
    """
    DPM-Solver++(2M) (Lu et al. 2022), x0 parameterisation, on the nodes of
    dpmpp_nodes plus the clean state abar = 1, from x_T = `noise`. Update i
    over nodes t_{i-1} -> t_i:
        x0_i = (x - sigma_{i-1} eps(x, t_{i-1})) / alpha_{i-1}, clamped on
               angular channels to [-pi, pi]
        D_i  = x0_i + (1 / (2 r_i)) wrap(x0_i - x0_{i-1}),  r_i = h_{i-1} / h_i
        x   <- (sigma_i / sigma_{i-1}) x + alpha_i (1 - e^{-h_i}) D_i, wrapped
    first order (D = x0) on the first and the last step. The coefficients
    are dpmpp_table's, computed in float64 on the host and used as float32,
    as in the JAX package; the difference x0_i - x0_{i-1} is the geodesic
    one. Deterministic. Returns x_0, or with return_history the
    (n_steps, B, L, F) states after every step. cuda_graphs and chains as
    p_sample_loop's.
    """
    table = dpmpp_table(schedule, n_steps)
    is_angular = torch.as_tensor(is_angular, dtype=torch.bool, device=noise.device)
    if _graphed(cuda_graphs, noise):
        chain = _chain(chains, lambda: table, "dpmpp", model_fn, noise, attn_mask, is_angular,
                       return_history=return_history)
        return chain.run(noise, attn_mask)
    x, x0_prev = noise, torch.zeros_like(noise)
    with torch.inference_mode():
        history = _history(n_steps, noise, return_history)
        for i in range(n_steps):
            c = table.row(i)
            t_vec = torch.full((x.shape[0],), int(table.t[i]), dtype=torch.int64, device=x.device)
            eps = model_fn(x, t_vec, attn_mask)
            x0 = _clamp_angular((x - c["sigma_src"] * eps) * c["recip_alpha_src"], is_angular)
            d = x0 + c["c_corr"] * wrap_angular_features(x0 - x0_prev, is_angular)
            x = wrap_angular_features(c["c_x"] * x + c["c_d"] * d, is_angular)
            x0_prev = x0
            if history is not None:
                history[i] = x
    return x if history is None else history


# -- the table-driven chains ---------------------------------------------------
@dataclasses.dataclass
class ChainState:
    """The static buffers of a table-driven chain: x (B, L, F) and attn_mask
    (B, L); `counter`, (1,) int64 on x's device, the step index that the next
    step reads its table row at; the optional (S, B, L, F) history and given
    step noise; DPM-Solver++'s previous x0 (B, L, F)."""

    x: torch.Tensor
    attn_mask: torch.Tensor
    counter: torch.Tensor
    history: Optional[torch.Tensor] = None
    step_noise: Optional[torch.Tensor] = None
    x0_prev: Optional[torch.Tensor] = None


def _row(state: ChainState, t_tab: torch.Tensor, coefs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_vec (B,), the (K,) coefficients) of the step the counter names."""
    i = state.counter
    return t_tab.index_select(0, i).expand(state.x.shape[0]), coefs.index_select(0, i)[0]


def _finish(state: ChainState, x_new: torch.Tensor, is_angular: torch.Tensor) -> None:
    """The step's end: x <- wrap(x_new) on the angular channels, written in
    place; the history row of this step; the counter advanced."""
    torch.where(is_angular, wrap_angles(x_new), x_new, out=state.x)
    if state.history is not None:
        state.history.index_copy_(0, state.counter, state.x[None])
    state.counter.add_(1)


def _step_noise(state: ChainState) -> torch.Tensor:
    return state.step_noise.index_select(0, state.counter)[0]


def ddpm_step_body(model_fn: ModelFn, state: ChainState, t_tab: torch.Tensor, coefs: torch.Tensor,
                   is_angular: torch.Tensor, noise_scale: float | torch.Tensor = 1.0,
                   noise: Optional[Callable[[], torch.Tensor]] = None) -> None:
    """p_sample_step at the counter's row of a ddpm_table ((t_tab, coefs) on
    the state's device), in place on `state`. noise() gives the posterior
    noise; None is the last step (t = 0), which draws none."""
    z = noise() if noise is not None else None
    t_vec, c = _row(state, t_tab, coefs)
    eps_pred = model_fn(state.x, t_vec, state.attn_mask)
    x_next = c[0] * (state.x - c[1] * eps_pred * c[2])
    if z is not None:
        x_next = x_next + c[3] * (noise_scale * z)
    _finish(state, x_next, is_angular)


def ddim_step_body(model_fn: ModelFn, state: ChainState, t_tab: torch.Tensor, coefs: torch.Tensor,
                   is_angular: torch.Tensor, noise: Optional[Callable[[], torch.Tensor]] = None) -> None:
    """ddim_sample_loop's step at the counter's row of a ddim_table, in place
    on `state`; noise() gives eta > 0's draw."""
    t_vec, c = _row(state, t_tab, coefs)
    eps = model_fn(state.x, t_vec, state.attn_mask)
    x0 = _clamp_angular((state.x - c[0] * eps) * c[1], is_angular)
    dir_xt = c[3] * eps
    x_new = c[2] * x0 + dir_xt
    if noise is not None:
        x_new = x_new + c[4] * noise()
    _finish(state, x_new, is_angular)


def dpmpp_step_body(model_fn: ModelFn, state: ChainState, t_tab: torch.Tensor, coefs: torch.Tensor,
                    is_angular: torch.Tensor) -> None:
    """dpmpp_sample_loop's update at the counter's row of a dpmpp_table, in
    place on `state` (x0_prev included)."""
    t_vec, c = _row(state, t_tab, coefs)
    eps = model_fn(state.x, t_vec, state.attn_mask)
    x0 = _clamp_angular((state.x - c[3] * eps) * c[4], is_angular)
    d = x0 + c[2] * wrap_angular_features(x0 - state.x0_prev, is_angular)
    x_new = c[0] * state.x + c[1] * d
    state.x0_prev.copy_(x0)
    _finish(state, x_new, is_angular)


class TableChain:
    """
    One chain shape's table-driven reverse chain (module docstring): the
    method's StepTable on the device, the ChainState, and the step body in
    two segments: `main`, one step, run for every step but DDPM's last, and
    for DDPM `last`, its noiseless last step. With `graphed` each segment is a
    StepGraph (captured at its first run, replayed after); without, the body
    runs eagerly, on any device, which is how the CPU tests hold the bodies to
    the eager loops. `draws`: the noise comes from a generator (run()'s), which
    the chain's own generator stands in for; `step_noise`: from a given
    (S, B, L, F) tensor. The model's weights are read through pointers baked
    into the graphs: loading weights into the same module is seen, a new
    module needs a new chain.
    """

    def __init__(self, method: str, table: StepTable, model_fn: ModelFn, like: torch.Tensor, mask_like: torch.Tensor,
                 is_angular: torch.Tensor, *, noise_scale: float | torch.Tensor = 1.0,
                 draws: bool = False, step_noise: bool = False, return_history: bool = False, shard: Shard = None,
                 graphed: bool = True, pool=None):
        if method not in SAMPLING_METHODS:
            raise ValueError(f"method {method!r} not in {SAMPLING_METHODS}")
        device, n = like.device, len(table)
        self.method, self.model_fn, self.is_angular, self.noise_scale = method, model_fn, is_angular, noise_scale
        self.shard = shard
        self.t_tab, self.coefs = table.to(device)
        with torch.inference_mode():
            self.state = ChainState(
                x=torch.empty_like(like), attn_mask=torch.empty_like(mask_like),
                counter=torch.zeros(1, dtype=torch.int64, device=device),
                history=_history(n, like, return_history),
                step_noise=torch.empty((n, *like.shape), dtype=like.dtype, device=device) if step_noise else None,
                x0_prev=torch.empty_like(like) if method == "dpmpp" else None,
            )
        self.generator = torch.Generator(device=device) if draws else None
        self.noisy = (draws or step_noise) and method != "dpmpp"
        # DDPM's last step (t = 0) draws no noise: a segment of its own
        self.n_main = n - 1 if method == "ddpm" else n
        self.main = self._segment(False, graphed, pool) if self.n_main else None
        self.last = self._segment(True, graphed, pool) if method == "ddpm" else None

    def _noise(self) -> torch.Tensor:
        if self.state.step_noise is not None:
            return _step_noise(self.state)
        return _normal(self.state.x, self.generator, self.shard)

    def step(self, last: bool = False) -> None:
        """One step of the method's body at the counter's row."""
        noise = self._noise if self.noisy and not last else None
        s, args = self.state, (self.t_tab, self.coefs, self.is_angular)
        if self.method == "ddpm":
            ddpm_step_body(self.model_fn, s, *args, self.noise_scale, noise)
        elif self.method == "ddim":
            ddim_step_body(self.model_fn, s, *args, noise)
        else:
            dpmpp_step_body(self.model_fn, s, *args)

    def _segment(self, last: bool, graphed: bool, pool):
        def body() -> None:
            self.step(last)

        if not graphed:
            return body
        return StepGraph(body, self.state.x.device, generators=[self.generator] if self.generator else (), pool=pool)

    def run(self, x_t: torch.Tensor, attn_mask: torch.Tensor, generator: Optional[torch.Generator] = None,
            step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The chain from x_t: a fresh tensor of x_0, or of the history.
        `generator` (when the chain draws) ends where the eager chain would
        leave it."""
        s = self.state
        with torch.inference_mode():
            s.x.copy_(x_t)
            s.attn_mask.copy_(attn_mask)
            s.counter.zero_()
            if s.x0_prev is not None:
                s.x0_prev.zero_()
            if s.step_noise is not None:
                s.step_noise.copy_(step_noise)
            if self.generator is not None:
                self.generator.set_state(generator.get_state())
            for _ in range(self.n_main):
                self.main()
            if self.last is not None:
                self.last()
            if self.generator is not None:
                generator.set_state(self.generator.get_state())
            return (s.x if s.history is None else s.history).clone()


class ChainCache:
    """A sampler's TableChains, one per chunk shape and noise source, whose
    graphs share one memory pool (they replay one at a time on one stream).
    The sampler's options are fixed, so its shape names a chain."""

    def __init__(self) -> None:
        self.chains: Dict[tuple, TableChain] = {}
        self.pool = None

    def get(self, key: tuple, make: Callable[[object], TableChain]) -> TableChain:
        if key not in self.chains:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            self.chains[key] = make(self.pool)
        return self.chains[key]


def _graphed(cuda_graphs: bool, x: torch.Tensor) -> bool:
    """Whether a loop runs as CUDA graphs: on a CUDA tensor unless the caller
    asks for the eager loop. Any other device runs the eager loop."""
    return cuda_graphs and x.device.type == "cuda"


def _chain(chains: Optional[ChainCache], table: Callable[[], StepTable], method: str, model_fn: ModelFn,
           noise: torch.Tensor, attn_mask: torch.Tensor, is_angular: torch.Tensor, **options) -> TableChain:
    """The graphed TableChain of this call: `chains`' one for the shape, made
    at first use, or a new one when no cache is given."""
    def make(pool) -> TableChain:
        return TableChain(method, table(), model_fn, noise, attn_mask, is_angular, graphed=True, pool=pool,
                          **options)

    if chains is None:
        return make(None)
    shard = options.get("shard")
    key = (method, tuple(noise.shape), tuple(attn_mask.shape), options.get("draws"), options.get("step_noise"),
           None if shard is None else shard[1])
    return chains.get(key, make)


def chunk_generator(seed: int, chunk_i: int, device: torch.device | str) -> torch.Generator:
    """The generator of one sample() chunk: seeded with 63 bits of numpy's
    SeedSequence over (seed, chunk index)."""
    state = np.random.SeedSequence([seed, chunk_i]).generate_state(1, dtype=np.uint64)[0]
    generator = torch.Generator(device=device)
    generator.manual_seed(int(state) >> 1)
    return generator


def build_sampler(
    model: ModelFn,
    schedule: DiffusionSchedule,
    is_angular: Sequence[bool],
    angular_variance: float = 1.0,
    method: str = "ddpm",
    ddim_steps: int = 50,
    ddim_eta: float = 0.0,
    noise_scale: float | np.ndarray | None = None,
    start_t: Optional[int] = None,
    return_history: bool = False,
    gen_noise: bool = False,
    mesh: Optional[Mesh] = None,
    cuda_graphs: bool = True,
):
    """
    Sampler closure over `model` (the denoiser, or any model_fn), which runs
    on its own device. method:
    "ddpm" (ancestral, reference parity), "ddim" (ddim_steps model
    evaluations, ddim_eta) or "dpmpp" (DPM-Solver++(2M); ddim_steps sets its
    step budget too). noise_scale is the DDPM posterior-noise temperature, a
    scalar or per feature (None: 1.0); start_t runs a partial DDPM chain from
    timestep start_t - 1. The other methods take neither, and raise if given
    one: their node grids start at T - 1, so a partial input would be
    inverted wrongly. return_history returns every step's state, stacked
    (steps, B, L, F), instead of x_0.

    On the card the chains run as CUDA graphs of one step, captured at a
    shape's first chunk and cached per shape in the closure, as JAX's jit caches per shape; cuda_graphs=False
    runs the eager loops. The graphs read `model`'s weights where they lie:
    loading a state dict into the same module is seen by them, a new module
    needs a new sampler (the role of JAX's params_as_arg).

    gen_noise=False: sampler(noise, attn_mask, generator=None,
    step_noise=None, shard=None), from a given x_T (or x_{start_t}), the step
    noise drawn from `generator` (under `shard`, of the whole chunk) or given
    (DDPM, and DDIM with eta > 0, need one).
    gen_noise=True: sampler(attn_mask, seed, chunk_i), x_T and any step noise
    drawn from chunk_generator(seed, chunk_i); under `mesh` attn_mask is the
    whole chunk's and the sampler returns this rank's rows of it.
    """
    if method not in SAMPLING_METHODS:
        raise ValueError(f"method {method!r} not in {SAMPLING_METHODS}")
    if noise_scale is not None and method != "ddpm":
        raise ValueError(f"noise_scale is a DDPM posterior-noise temperature; method={method!r} takes none")
    if start_t is not None and method != "ddpm":
        raise ValueError(f"start_t is only supported with method='ddpm', got {method!r}")
    n_ft = len(is_angular)
    chains = ChainCache()
    graphs = dict(cuda_graphs=cuda_graphs, chains=chains)

    def run_loop(noise: torch.Tensor, attn_mask: torch.Tensor, generator: Optional[torch.Generator] = None,
                 step_noise: Optional[torch.Tensor] = None, shard: Shard = None) -> torch.Tensor:
        if method == "ddim":
            return ddim_sample_loop(model, noise, attn_mask, schedule, is_angular, ddim_steps, ddim_eta,
                                    generator=generator, step_noise=step_noise, return_history=return_history,
                                    shard=shard, **graphs)
        if method == "dpmpp":
            return dpmpp_sample_loop(model, noise, attn_mask, schedule, is_angular, ddim_steps,
                                     return_history=return_history, **graphs)
        return p_sample_loop(model, noise, attn_mask, schedule, is_angular, generator=generator,
                             step_noise=step_noise, noise_scale=1.0 if noise_scale is None else noise_scale,
                             start_t=start_t, return_history=return_history, shard=shard, **graphs)

    if not gen_noise:
        return run_loop

    def sampler(attn_mask: torch.Tensor, seed: int, chunk_i: int) -> torch.Tensor:
        generator = chunk_generator(seed, chunk_i, attn_mask.device)
        b, l = attn_mask.shape
        noise = sample_wrapped_noise(generator, (b, l, n_ft), is_angular, angular_variance)
        if mesh is None:
            return run_loop(noise, attn_mask, generator)
        noise, attn_mask = shard_batch(mesh, noise, attn_mask)
        return run_loop(noise, attn_mask, generator, shard=(mesh, b))

    return sampler


def sample(
    model: torch.nn.Module,
    schedule: DiffusionSchedule,
    *,
    is_angular: Sequence[bool],
    pad: int,
    n: int = 10,
    sweep_lengths: Optional[Tuple[int, int]] = (50, 128),
    lengths: Optional[Sequence[int]] = None,
    batch_size: int = 512,
    angular_variance: float = 1.0,
    mean_offset: Optional[np.ndarray] = None,
    seed: int = 0x1234,
    bucket_multiple: int = 64,
    method: str = "ddpm",
    ddim_steps: int = 50,
    ddim_eta: float = 0.0,
    noise_scale: float | np.ndarray | None = None,
    return_history: bool = False,
    sampler=None,
    mesh: Optional[Mesh] = None,
) -> Optional[List[np.ndarray]]:
    """
    Batched sampling with a length sweep (reference sampling.sample,
    sampling.py:135-224) on the model's device, by build_sampler's `method`
    unless a prebuilt `sampler` (gen_noise=True form) is given. Returns one
    (length, F) array per requested structure, in request order, or with
    return_history its (steps, length, F) trajectory, with the training mean
    offset re-applied to every entry and angular features re-wrapped.

    Lengths are grouped by padded bucket (a multiple of bucket_multiple, at
    most pad) before chunking by batch_size, so a short chunk runs at its
    small bucket. Chunk i is sampled from chunk_generator(seed, i).

    Under `mesh` (a prebuilt sampler must be built with the same mesh) every
    rank runs its rows of each chunk; rank 0 returns the structures, the
    other ranks None.
    """
    if lengths is None:
        if sweep_lengths is None:
            raise ValueError("give lengths or sweep_lengths")
        sweep_min, sweep_max = sweep_lengths
        if not sweep_min < sweep_max:
            raise ValueError(f"Min length {sweep_min} must be < max {sweep_max}")
        lengths = [l for l in range(sweep_min, sweep_max) for _ in range(n)]
    lengths = list(lengths)
    logging.info(f"Sampling {len(lengths)} items in batches of {batch_size}")

    is_angular_arr = np.asarray(is_angular, dtype=bool)
    device = next(model.parameters()).device
    if sampler is None:
        sampler = build_sampler(model, schedule, list(is_angular_arr), angular_variance, method, ddim_steps,
                                ddim_eta, noise_scale, return_history=return_history, gen_noise=True, mesh=mesh)

    def bucket_of(length: int) -> int:
        return min(pad, -(-length // bucket_multiple) * bucket_multiple)

    groups: dict = {}
    for i, length in enumerate(lengths):
        groups.setdefault(bucket_of(length), []).append(i)
    split_chunks: List[List[int]] = [
        g[i : i + batch_size]
        for _, g in sorted(groups.items())
        for i in range(0, len(g), batch_size)
    ]

    # Enqueue every chunk before reading any back, so the device never waits
    # on a host copy between chunks
    pending = []
    for chunk_i, idx_chunk in enumerate(split_chunks):
        this_lengths = [lengths[i] for i in idx_chunk]
        seq_len = bucket_of(max(this_lengths))
        attn_mask = torch.from_numpy(
            (np.arange(seq_len)[None, :] < np.asarray(this_lengths)[:, None]).astype(np.float32)
        ).to(device)
        pending.append((idx_chunk, this_lengths, sampler(attn_mask, seed, chunk_i)))

    outputs = [device_out.cpu().numpy() for _, _, device_out in pending]
    if mesh is not None:  # each rank's rows of every chunk, in rank order: the zero-padded chunks
        gathered = gather_to_primary(mesh, outputs)
        if gathered is None:
            return None
        axis = 1 if return_history else 0
        outputs = [np.concatenate([g[c] for g in gathered], axis=axis) for c in range(len(pending))]
    results: dict = {}
    for (idx_chunk, this_lengths, _), sampled in zip(pending, outputs):
        for i, (orig_idx, l) in enumerate(zip(idx_chunk, this_lengths)):
            results[orig_idx] = sampled[:, i, :l, :] if return_history else sampled[i, :l, :]
    retval = [results[i] for i in range(len(lengths))]

    if mean_offset is not None:
        mean_offset = np.asarray(mean_offset)
        logging.info(f"Shifting predicted values by original offset: {mean_offset}")
        angular_idx = np.where(is_angular_arr)[0]
        shifted = []
        for s in retval:
            s = s + mean_offset
            s[..., angular_idx] = wrap_angles(s[..., angular_idx])
            shifted.append(s)
        retval = shifted
    return retval


def reconstruct_batch(
    model_fn: ModelFn,
    schedule: DiffusionSchedule,
    x0: np.ndarray,
    attn_mask: np.ndarray,
    lengths: Sequence[int],
    eps: torch.Tensor,
    *,
    is_angular: Sequence[bool],
    noise_timesteps: int,
    generator: Optional[torch.Generator] = None,
    step_noise: Optional[torch.Tensor] = None,
    mean_offset: Optional[np.ndarray] = None,
    shard: Shard = None,
    chain=None,
) -> List[np.ndarray]:
    """
    One batch of partial-noise reconstruction on eps's device: x0 (B, L, F)
    q-sampled with the wrapped noise eps to t = noise_timesteps - 1, the
    partial DDPM chain from start_t = noise_timesteps (its step noise drawn
    from `generator`, of the whole batch under `shard`, or given,
    (noise_timesteps, B, L, F)), then on the host
    the mean offset re-added, the angular features re-wrapped and each
    structure trimmed to its length. `chain`: that partial chain, built once
    for many batches (build_sampler with start_t = noise_timesteps), so its
    graphs are captured once per batch shape; by default one is built here.
    """
    device = eps.device
    is_angular_arr = np.asarray(is_angular, dtype=bool)
    x0_t = torch.as_tensor(x0, dtype=eps.dtype, device=device)
    t = torch.full((x0_t.shape[0],), noise_timesteps - 1, dtype=torch.int64, device=device)
    corrupted = q_sample(x0_t, t, eps, schedule, is_angular_arr.tolist())
    mask = torch.as_tensor(attn_mask, dtype=torch.float32, device=device)
    partial_chain = chain or build_sampler(model_fn, schedule, is_angular_arr.tolist(), start_t=noise_timesteps)
    recon = partial_chain(corrupted, mask, generator=generator, step_noise=step_noise, shard=shard).cpu().numpy()
    if mean_offset is not None:
        recon = recon + np.asarray(mean_offset)
        ang_idx = np.where(is_angular_arr)[0]
        recon[..., ang_idx] = wrap_angles(recon[..., ang_idx])
    return [recon[i, : int(l)] for i, l in enumerate(lengths)]


def get_reconstruction_error(
    model: torch.nn.Module,
    schedule: DiffusionSchedule,
    data: dict,
    *,
    is_angular: Sequence[bool],
    noise_timesteps: int = 250,
    batch_size: int = 512,
    seed: int = 0,
    mean_offset: Optional[np.ndarray] = None,
    mesh: Optional[Mesh] = None,
) -> Optional[List[np.ndarray]]:
    """
    Partial-noise reconstruction (reference sampling.get_reconstruction_error,
    sampling.py:287-356) on the model's device: each batch of test items
    q-sampled to t = noise_timesteps - 1 and denoised by the partial DDPM
    chain (reconstruct_batch), returned as reconstructed (length, F) angle
    sets. TM scoring against the truth is the caller's business
    (bin/partial_noise_reconstruct_torch.py).

    data: {"angles": (N, L, F), "attn_mask": (N, L), "lengths": (N,)}. Batch
    i draws its eps and step noise from chunk_generator(seed, i); the
    numbers differ from the JAX package's for the same seed. Under `mesh`
    every rank runs its rows of each batch; rank 0 returns the
    reconstructions, the other ranks None.
    """
    if not 1 <= noise_timesteps <= schedule.timesteps:
        raise ValueError(f"noise_timesteps must be in [1, {schedule.timesteps}], got {noise_timesteps}")
    device = next(model.parameters()).device
    n = data["angles"].shape[0]
    starts = range(0, n, batch_size)
    chain = build_sampler(model, schedule, list(is_angular), start_t=noise_timesteps)
    batches: List[List[np.ndarray]] = []
    for batch_i, start in enumerate(starts):
        rows = slice(start, start + batch_size)
        x0, mask, lengths = data["angles"][rows], data["attn_mask"][rows], data["lengths"][rows]
        generator = chunk_generator(seed, batch_i, device)
        eps = sample_wrapped_noise(generator, tuple(x0.shape), is_angular)
        shard = None
        if mesh is not None:
            shard = (mesh, x0.shape[0])
            x0, mask, lengths = shard_batch(mesh, x0, mask, lengths)
            eps = shard_batch(mesh, eps)
        batches.append(reconstruct_batch(
            model, schedule, x0, mask, lengths, eps, is_angular=is_angular, noise_timesteps=noise_timesteps,
            generator=generator, mean_offset=mean_offset, shard=shard, chain=chain,
        ))
    if mesh is not None:  # each rank's rows of every batch, in rank order: the zero-padded batches
        gathered = gather_to_primary(mesh, batches)
        if gathered is None:
            return None
        batches = [[r for g in gathered for r in g[i]][: min(batch_size, n - start)] for i, start in enumerate(starts)]
    return [r for batch in batches for r in batch]


def sample_simple(
    model_dir: str,
    n: int = 10,
    sweep_lengths: Tuple[int, int] = (50, 128),
    seed: int = 0x1234,
    device: torch.device | str = "cuda",
) -> List[Tuple[np.ndarray, List[str]]]:
    """
    Load a model directory (or hub id) onto `device` (the card unless the
    caller asks for the CPU) and sample DDPM over the sweep (reference
    sampling.sample_simple, sampling.py:227-264). Returns one (array, column
    names) pair per structure, where the JAX package returns DataFrames.
    """
    from foldingdiff_tpu_torch.data.datasets import AnglesEmptyDataset
    from foldingdiff_tpu_torch.models import io as model_io

    model_dir = model_io.resolve_model_dir(model_dir)
    model, train_args = model_io.from_dir(model_dir, device=device)
    schedule = DiffusionSchedule.create(train_args["variance_schedule"], train_args["timesteps"], device=device)
    empty = AnglesEmptyDataset.from_dir(model_dir)
    try:
        mean_offset = empty.get_masked_means()
    except NotImplementedError:
        mean_offset = None
    # cart-coords models store their features under "coords", all others "angles"
    ft_key = next(iter(empty.feature_names))
    sampled = sample(
        model, schedule, is_angular=empty.feature_is_angular[ft_key], pad=empty.pad, n=n,
        sweep_lengths=sweep_lengths, angular_variance=train_args.get("variance_scale", 1.0),
        mean_offset=mean_offset, seed=seed,
    )
    cols = list(empty.feature_names[ft_key])
    return [(s, cols) for s in sampled]
