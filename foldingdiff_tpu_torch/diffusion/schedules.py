"""
Variance (beta) schedules and derived alpha terms
(counterpart of foldingdiff_tpu/diffusion/schedules.py).

The schedules are computed in float64 numpy on the host, exactly as in the
JAX package, and stored as float32 tensors on a chosen device.

The reverse chains' per-step scalars are StepTables, built once per chain on
the host (ddpm_table, ddim_table, dpmpp_table): row i holds step i's
timestep and its float32 coefficients. The eager loops read a row on the
host, so they never wait on the device; the graphed loops read the same
values from a device copy through a step counter that lives on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Tuple

import numpy as np
import torch

from foldingdiff_tpu_torch.devices import require_device

SCHEDULES = Literal["linear", "cosine", "quadratic"]


def cosine_beta_schedule(timesteps: int, s: float = 8e-3) -> np.ndarray:
    """Cosine schedule from Nichol & Dhariwal (https://arxiv.org/abs/2102.09672)."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0001, 0.9999)


def linear_beta_schedule(timesteps: int, beta_start: float = 1e-4, beta_end: float = 0.02) -> np.ndarray:
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)


def quadratic_beta_schedule(timesteps: int, beta_start: float = 1e-4, beta_end: float = 0.02) -> np.ndarray:
    x = np.linspace(-6, 6, timesteps, dtype=np.float64)
    sigmoid = 1.0 / (1.0 + np.exp(-x))
    return sigmoid * (beta_end - beta_start) + beta_start


def get_variance_schedule(keyword: SCHEDULES, timesteps: int, **kwargs) -> np.ndarray:
    """Keyword dispatch matching reference beta_schedules.get_variance_schedule."""
    if keyword == "cosine":
        return cosine_beta_schedule(timesteps, **kwargs)
    elif keyword == "linear":
        return linear_beta_schedule(timesteps, **kwargs)
    elif keyword == "quadratic":
        return quadratic_beta_schedule(timesteps, **kwargs)
    raise ValueError(f"Unrecognized variance schedule: {keyword}")


def compute_alphas(betas: np.ndarray) -> dict:
    """All derived alpha terms, as in reference beta_schedules.compute_alphas."""
    betas = np.asarray(betas, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    return {
        "betas": betas,
        "alphas": alphas,
        "alphas_cumprod": alphas_cumprod,
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "posterior_variance": posterior_variance,
    }


ARRAY_NAMES = (
    "betas",
    "alphas",
    "alphas_cumprod",
    "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod",
    "posterior_variance",
    "sqrt_recip_alphas",
    "sqrt_posterior_variance",
)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """
    Precomputed schedule arrays, each (T,) float32 on `device`, plus `host`:
    the same arrays as float32 numpy, for per-step scalars read on the host.
    """

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    sqrt_recip_alphas: torch.Tensor
    sqrt_posterior_variance: torch.Tensor
    host: dict
    timesteps: int
    schedule_name: str

    @classmethod
    def create(
        cls, keyword: SCHEDULES, timesteps: int, device: torch.device | str = "cuda", **kwargs
    ) -> "DiffusionSchedule":
        """`device` is the card unless the caller asks for the CPU; without a
        card the default raises at once (devices.require_device)."""
        device = require_device(device)
        betas = get_variance_schedule(keyword, timesteps, **kwargs)
        terms = compute_alphas(betas)
        terms["sqrt_recip_alphas"] = 1.0 / np.sqrt(terms["alphas"])
        terms["sqrt_posterior_variance"] = np.sqrt(terms["posterior_variance"])
        host = {name: terms[name].astype(np.float32) for name in ARRAY_NAMES}
        return cls(
            **{name: torch.from_numpy(host[name]).to(device) for name in ARRAY_NAMES},
            host=host,
            timesteps=timesteps,
            schedule_name=keyword,
        )


@dataclasses.dataclass(frozen=True)
class StepTable:
    """A reverse chain's per-step scalars: row i of `t` ((N,) int64) is
    step i's timestep and row i of `coefs` ((N, K) float32) its
    coefficients, named by `names`."""

    t: np.ndarray
    coefs: np.ndarray
    names: Tuple[str, ...]

    def __len__(self) -> int:
        return len(self.t)

    def row(self, i: int) -> dict:
        """Step i's coefficients as Python floats (each exactly its float32)."""
        return {name: float(v) for name, v in zip(self.names, self.coefs[i])}

    def to(self, device: torch.device | str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t, coefs) on `device`."""
        return torch.from_numpy(self.t).to(device), torch.from_numpy(self.coefs).to(device)


DDPM_COEFS = ("sqrt_recip_alpha", "beta", "recip_sqrt_one_minus_abar", "sigma")
DDIM_COEFS = ("sqrt_one_minus_a", "recip_sqrt_a", "sqrt_a_prev", "dir_coef", "sigma")
DPMPP_COEFS = ("c_x", "c_d", "c_corr", "sigma_src", "recip_alpha_src")


def ddpm_coefs(schedule: DiffusionSchedule, ts) -> np.ndarray:
    """(len(ts), 4) float32 DDPM coefficients (DDPM_COEFS) at timesteps ts:
    1 / sqrt(alpha_t), beta_t, the float32 reciprocal of sqrt(1 - abar_t)
    (a division by a host scalar on the card is a multiplication by its
    float32 reciprocal) and sqrt(posterior variance_t), which is 0 at t = 0."""
    host, ts = schedule.host, np.atleast_1d(np.asarray(ts, dtype=np.int64))
    return np.stack([host["sqrt_recip_alphas"][ts], host["betas"][ts],
                     np.float32(1.0) / host["sqrt_one_minus_alphas_cumprod"][ts],
                     host["sqrt_posterior_variance"][ts]], axis=1)


def ddpm_table(schedule: DiffusionSchedule, steps: int) -> StepTable:
    """The DDPM chain of `steps` steps from timestep steps - 1 down to 0 (a
    partial chain when steps < T)."""
    ts = np.arange(steps - 1, -1, -1, dtype=np.int64)
    return StepTable(ts, ddpm_coefs(schedule, ts), DDPM_COEFS)


def ddim_table(schedule: DiffusionSchedule, n_steps: int, eta: float) -> StepTable:
    """DDIM over the strided grid linspace(0, T-1, n_steps)[::-1], each step
    jumping to the next grid timestep (abar = 1 after the last), the
    coefficients in float32 numpy as the JAX loop computes them on the
    device (DDIM_COEFS): sqrt(1 - a_t), 1 / sqrt(a_t), sqrt(a_prev), the
    direction's sqrt(1 - a_prev - sigma^2) and sigma."""
    ts = np.linspace(0, schedule.timesteps - 1, num=n_steps, dtype=np.int64)[::-1].copy()
    abar = np.concatenate([schedule.host["alphas_cumprod"], np.ones(1, np.float32)])  # abar[-1] = 1
    one, eta32 = np.float32(1.0), np.float32(eta)
    rows = []
    for i, t in enumerate(ts):
        a_t = abar[t]
        a_prev = abar[ts[i + 1]] if i + 1 < n_steps else abar[-1]
        sigma = eta32 * np.sqrt((one - a_prev) / (one - a_t)) * np.sqrt(max(one - a_t / a_prev, 0))
        rows.append([np.sqrt(one - a_t), one / np.sqrt(a_t), np.sqrt(a_prev),
                     np.sqrt(max(one - a_prev - sigma * sigma, 0)), sigma])
    return StepTable(ts, np.asarray(rows, dtype=np.float32).reshape(n_steps, len(DDIM_COEFS)), DDIM_COEFS)


def dpmpp_nodes(alphas_cumprod: np.ndarray, n_steps: int) -> np.ndarray:
    """
    The n_steps source timesteps of DPM-Solver++, strictly decreasing: the
    discrete timesteps nearest to targets uniform in half-log-SNR
    lambda = log(alpha / sigma), with collisions moved to the next free
    timestep so the chain makes exactly n_steps model evaluations (the JAX
    package's rule, sampling.py:343-366). alphas_cumprod is the schedule's
    float32 array cast to float64, as the JAX package reads it: the float64
    values before the cast can move a node by one timestep.
    """
    T = len(alphas_cumprod)
    lam_all = 0.5 * (np.log(alphas_cumprod) - np.log1p(-alphas_cumprod))
    targets = np.linspace(lam_all[T - 1], lam_all[0], num=n_steps)
    nodes = []
    prev = T
    for k, target in enumerate(targets):
        t = int(np.argmin(np.abs(lam_all - target)))
        t = max(min(t, prev - 1), n_steps - k - 1)
        nodes.append(t)
        prev = t
    return np.asarray(nodes, dtype=np.int64)


def dpmpp_table(schedule: DiffusionSchedule, n_steps: int) -> StepTable:
    """
    DPM-Solver++(2M) on the nodes of dpmpp_nodes plus the clean state
    abar = 1 (DPMPP_COEFS): update i over nodes t_{i-1} -> t_i takes
    x <- c_x x + c_d D with D = x0 + c_corr wrap(x0 - x0_prev), x0 from
    sigma_src and 1 / alpha_src of its source node. c_x = sigma_i /
    sigma_{i-1}, c_d = alpha_i (1 - e^{-h_i}), c_corr = 1 / (2 r_i) with
    r_i = h_{i-1} / h_i, first order (c_corr = 0) on the first and the last
    step, which goes to abar = 1 (x <- D). Computed in float64 and stored as
    float32, as in the JAX package.
    """
    T = schedule.timesteps
    if not 1 <= n_steps <= T:
        raise ValueError(f"n_steps must be in [1, {T}], got {n_steps}")
    ts = dpmpp_nodes(schedule.host["alphas_cumprod"].astype(np.float64), n_steps)
    a_nodes = np.concatenate([schedule.host["alphas_cumprod"].astype(np.float64)[ts], [1.0]])
    alpha = np.sqrt(a_nodes)
    sigma = np.sqrt(1.0 - a_nodes)
    # lambda at the non-final nodes only: sigma = 0 at the clean state
    lam = 0.5 * (np.log(a_nodes[:-1]) - np.log1p(-a_nodes[:-1]))
    h = np.diff(lam)
    c_x = np.zeros(n_steps)
    c_d = np.ones(n_steps)  # the final step to abar = 1: x <- D
    c_corr = np.zeros(n_steps)
    c_x[:-1] = sigma[1:-1] / sigma[:-2]
    c_d[:-1] = alpha[1:-1] * -np.expm1(-h)
    if n_steps >= 3:
        c_corr[1:-1] = h[1:] / (2.0 * h[:-1])
    coefs = np.stack([c_x, c_d, c_corr, sigma[:-1], 1.0 / alpha[:-1]], axis=1).astype(np.float32)
    return StepTable(ts, coefs, DPMPP_COEFS)
