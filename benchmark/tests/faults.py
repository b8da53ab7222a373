"""
Faults planted in the program under test, for the checks' own tests
(test_bench_checks.py) and for reading a fault's numbers on the card
(readings.py --fault). Each is a context manager that patches the program
while it is open:

- state_unchanged: every step leaves the state as it found it (sampling:
  the DDPM step keeps x; training: AdamW's step does nothing);
- half_batch: half of the batch left out (sampling: only the first half of
  a chunk's rows step; training: the loss is the mean over the first half);
- answer_altered: an answer altered where it is made (sampling: every
  returned backbone moved by 0.05 rad as sample() assembles it; training:
  each update made at 1.5 times its learning rate);
- answers_permuted (sampling): sample() returns the backbones of each
  length in another order (rotated by one).
The sampling faults patch the eager step, which the CPU runs, and the
graphed step body, which the card's CUDA graphs capture.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import torch

from foldingdiff_tpu_torch.diffusion import sampling
from foldingdiff_tpu_torch.training import trainer as trainer_mod


def _ddpm_step(keep):
    step = sampling.p_sample_step

    def faulty(model_fn, x, t, noise, attn_mask, schedule, is_angular, noise_scale=1.0):
        return keep(x, step(model_fn, x, t, noise, attn_mask, schedule, is_angular, noise_scale))
    return faulty


def _ddpm_body(keep):
    body = sampling.ddpm_step_body

    def faulty(model_fn, state, *args, **kwargs):
        old = state.x.clone()
        body(model_fn, state, *args, **kwargs)
        state.x.copy_(keep(old, state.x))
    return faulty


@contextlib.contextmanager
def _sampling_step(keep):
    with mock.patch.object(sampling, "p_sample_step", _ddpm_step(keep)), \
            mock.patch.object(sampling, "ddpm_step_body", _ddpm_body(keep)):
        yield


def _half(x_old, x_new):
    out = x_new.clone()
    out[x_new.shape[0] // 2:] = x_old[x_new.shape[0] // 2:]
    return out


@contextlib.contextmanager
def state_unchanged():
    with _sampling_step(lambda x_old, x_new: x_old), \
            mock.patch.object(torch.optim.AdamW, "step", lambda self, closure=None: None):
        yield


@contextlib.contextmanager
def half_batch():
    loss_terms = trainer_mod.Trainer._loss_terms

    def half_loss(self, batch, t=None, noise=None):
        t, noise = self._draw(batch, t, noise)
        n = batch["angles"].shape[0] // 2
        return loss_terms(self, {k: v[:n] for k, v in batch.items()}, t[:n], noise[:n])
    with _sampling_step(_half), mock.patch.object(trainer_mod.Trainer, "_loss_terms", half_loss):
        yield


@contextlib.contextmanager
def answer_altered():
    wrap = sampling.wrap_angles
    step = trainer_mod.optimizer_step

    def altered(x, *args):
        return wrap(x, *args) + (0.05 if isinstance(x, np.ndarray) else 0.0)

    def faster(model, optimizer, loss, gradient_clip, lr, *args, **kwargs):
        return step(model, optimizer, loss, gradient_clip, lr * 1.5, *args, **kwargs)
    with mock.patch.object(sampling, "wrap_angles", altered), \
            mock.patch.object(trainer_mod, "optimizer_step", faster):
        yield


@contextlib.contextmanager
def answers_permuted():
    sample = sampling.sample

    def permuted(*args, **kwargs):
        out = sample(*args, **kwargs)
        by_length = {}
        for i, answer in enumerate(out):
            by_length.setdefault(answer.shape[0], []).append(i)
        moved = list(out)
        for places in by_length.values():
            for i, j in zip(places, places[1:] + places[:1]):
                moved[i] = out[j]
        return moved
    with mock.patch.object(sampling, "sample", permuted):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch, "answer_altered": answer_altered,
          "answers_permuted": answers_permuted}
SAMPLING_ONLY = ("answers_permuted",)
