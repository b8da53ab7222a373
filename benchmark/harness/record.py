"""
What the sampling cells record of the timed path, for the check that
follows the program step by step and for the sweep's chunk metrics.

Recorder is the denoiser as sample() is handed it: a module that holds the
denoiser, so that sample() finds its device through parameters(), builds
its own sampler around it and calls it once per reverse step. At every
call it copies into device buffers, at the slot a device counter names, so
that inside a CUDA graph the copies replay with the step:

- a few rows of the state x_t, of the predicted noise and of the mask,
  with the length of every row of the chunk, in a ring of `capacity`
  calls (the rows of each chunk size are drawn from the seed);
- the chunk's (B, L) and its real positions, in a ring of `shape_capacity`
  calls.

The driver marks each job's start (a copy of the counter), so the calls
split into jobs, and a job's calls into chunks of `steps` calls each, in
the order sample() ran them: the chunk's index is its place in that order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import seeds


@dataclasses.dataclass
class Chunk:
    job: int
    index: int  # the chunk's place in its job's order of calls
    first_call: int  # the Recorder's number of the chunk's first call
    b: int
    l: int
    real: int  # positions inside the mask


class Recorder(torch.nn.Module):
    def __init__(self, model: torch.nn.Module, rows: int, pad: int, n_ft: int, width: int, seed: int, device):
        super().__init__()
        self.model = model
        self.n_rows, self.seed, self.row_shape, self.width = rows, seed, (rows, pad, n_ft), width
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)
        self.rows: Dict[int, torch.Tensor] = {}
        self.resize(1, 1)
        self.eval()

    def resize(self, capacity: int, shape_capacity: int) -> None:
        """New, empty buffers, the counter at 0 and no job marked: before
        any capture that is to record into them."""
        device = self.counter.device
        self.capacity, self.shape_capacity = capacity, shape_capacity
        self.x = torch.zeros(capacity, *self.row_shape, device=device)
        self.eps = torch.zeros_like(self.x)
        self.valid = torch.zeros(self.x.shape[:3], device=device)
        self.lengths = torch.zeros(capacity, self.width, device=device)
        self.shapes = torch.zeros(shape_capacity, 3, device=device)
        self.counter.zero_()
        self.job_starts: List[torch.Tensor] = []

    def start_job(self) -> None:
        self.job_starts.append(self.counter.clone())

    def rows_of(self, b: int) -> torch.Tensor:
        """The recorded rows of a chunk of b rows, made at the shape's first
        (eager) call, before any capture of it."""
        if b not in self.rows:
            picked = np.sort(seeds.rng(self.seed, "rows", b).choice(b, size=min(self.n_rows, b), replace=False))
            picked = np.resize(picked, self.n_rows)  # a chunk of fewer rows repeats them
            self.rows[b] = torch.from_numpy(picked).to(self.counter.device)
        return self.rows[b]

    def forward(self, x: torch.Tensor, t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        eps = self.model(x, t, mask)
        (b, l), rows = mask.shape, self.rows_of(x.shape[0])
        slot = self.counter.remainder(self.capacity)
        self.x[:, :, :l].index_copy_(0, slot, x.index_select(0, rows)[None])
        self.eps[:, :, :l].index_copy_(0, slot, eps.index_select(0, rows)[None])
        self.valid[:, :, :l].index_copy_(0, slot, mask.index_select(0, rows)[None].to(self.valid.dtype))
        per_row = mask.sum(1, dtype=torch.float32)
        self.lengths[:, :b].index_copy_(0, slot, per_row[None])
        shape = torch.stack([per_row.new_full((), b), per_row.new_full((), l), per_row.sum()])
        self.shapes.index_copy_(0, self.counter.remainder(self.shape_capacity), shape[None])
        self.counter.add_(1)
        return eps

    def calls(self) -> int:
        return int(self.counter)

    def held(self, call: int) -> bool:
        """Whether the ring of rows still holds call number `call`."""
        return self.calls() - self.capacity <= call < self.calls()

    def row_lengths(self, chunk: Chunk) -> List[int]:
        """The length of each of the chunk's rows, in order (its ring slot
        held)."""
        return self.lengths[chunk.first_call % self.capacity, :chunk.b].long().tolist()

    def chunks(self, steps: int) -> List[Chunk]:
        """Every chunk of every marked job whose shape the ring holds, in
        order. A job whose calls are not whole chunks of `steps` gives none,
        and the check then reads nothing of it."""
        total = self.calls()
        starts = [int(s) for s in self.job_starts] + [total]
        shapes = self.shapes.long().cpu()
        out = []
        for job, (start, end) in enumerate(zip(starts, starts[1:])):
            if (end - start) % steps or start < total - self.shape_capacity:
                continue
            for index, first in enumerate(range(start, end, steps)):
                b, l, real = shapes[first % self.shape_capacity].tolist()
                out.append(Chunk(job, index, first, b, l, real))
        return out
