"""
The correctness check of the sampling cells. A reverse chain over random
weights is chaotic (a change of 1e-6 in the weights moves a 20-step
DPM-Solver++ sample by 4e-4 rad, bf16 GEMMs move it by whole radians), so
the reference follows the program step by step from the program's own
states, which the Recorder took inside the timed path, and the start and
the end of each chain are checked by themselves:

- start_gap: each recorded row's x_T against the reference's draw of the
  chunk's noise (the job's seed, the chunk's index and shape);
- eps_gap: the denoiser, the reference's predicted noise at each recorded
  state against the program's: the relative RMS gap over a chunk's
  recorded rows, steps and valid positions, the largest over the chunks;
- step_gap: the reverse loop, the program's next state against the
  reference's DDPM step (its own predicted noise, the chunk's noise) from
  the program's state, over the step's factor on the predicted noise, so in
  units of predicted noise: the largest over steps and rows of a row's
  median over its positions;
- answer_gap: the answers, the reference's last step from each recorded
  row's last state (plus the job's mean offset, wrapped) against the
  backbone that sample() returned for that row's request, in the same
  units. A chunk's rows are its requests in request order: the k-th row of
  length l over a job's chunks, in the order they ran, is the k-th request
  of length l;
- answer_own_gap (read, not compared): the same against the program's own
  last step, from its recorded state and prediction;
and `missing` counts the requested backbones not returned at their length.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.harness.record import Chunk, Recorder
from benchmark.reference import denoiser
from benchmark.reference.diffusion import chunk_noise, ddpm_coefficients, ddpm_step, wrap


@contextlib.contextmanager
def ieee_float32():
    """IEEE float32 GEMMs while the reference runs, then the caller's."""
    if not torch.cuda.is_available():
        yield
        return
    saved = torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.fp32_precision
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.fp32_precision = "ieee"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.fp32_precision = saved


def circular(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return wrap(a - b).abs()


def missing(requested: Sequence[Sequence[int]], returned: Sequence[Sequence[np.ndarray]]) -> int:
    """Requested backbones with no answer of their length in their place."""
    n = 0
    for want, got in zip(requested, returned):
        n += sum(1 for i, l in enumerate(want) if got is None or i >= len(got) or got[i].shape[0] != l)
    return n


def requests_of(requested: Sequence[int], rows: Sequence[Sequence[int]]) -> Optional[List[List[int]]]:
    """The request of each row of a job's chunks (each chunk's row lengths,
    in the order the chunks ran): the k-th row of length l is the k-th
    request of length l. None unless the rows are the requests, each once."""
    queues = collections.defaultdict(collections.deque)
    for i, length in enumerate(requested):
        queues[length].append(i)
    out = []
    for lengths in rows:
        out.append([])
        for length in lengths:
            if not queues[length]:
                return None
            out[-1].append(queues[length].popleft())
    return out if not any(queues.values()) else None


def _row_medians(gap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(R,) the median of each row's gaps over its valid positions."""
    return torch.stack([g[v > 0].median() for g, v in zip(gap, valid)])


def check(params: Dict[str, torch.Tensor], config: dict, recorder: Recorder, chunks: List[Chunk],
          requested: Sequence[int], returned: Dict[int, List[np.ndarray]], offsets: Dict[int, np.ndarray],
          seeds: Dict[int, int]) -> Dict[str, float]:
    """The gaps over the jobs whose every chunk the ring holds."""
    steps = config["timesteps"]
    device = recorder.x.device
    ts, coefs = ddpm_coefficients(steps)
    coefs = torch.from_numpy(coefs).to(device)
    per_eps = float(coefs[-1, 0] * coefs[-1, 1] * coefs[-1, 2])  # the last step's factor on the noise
    gaps, info = collections.defaultdict(float), []
    n_ft = recorder.x.shape[-1]
    by_job = collections.defaultdict(list)
    for chunk in chunks:
        by_job[chunk.job].append(chunk)
    for job, job_chunks in sorted(by_job.items()):
        if not all(recorder.held(c.first_call) and recorder.held(c.first_call + steps - 1) for c in job_chunks):
            continue
        requests = requests_of(requested, [recorder.row_lengths(c) for c in job_chunks])
        if requests is None:
            gaps["answer_gap"] = max(gaps["answer_gap"], 2 * np.pi / per_eps)
            info.append(f"job {job}: its chunks' rows are not its requests, each once")
        for chunk in job_chunks:
            b, l = chunk.b, chunk.l
            rows = recorder.rows[b]
            slots = torch.arange(chunk.first_call, chunk.first_call + steps, device=device) % recorder.capacity
            x, eps = recorder.x[slots][:, :, :l], recorder.eps[slots][:, :, :l]  # (S, R, L, F)
            valid = recorder.valid[slots[0]][:, :l]  # (R, L)
            noise = chunk_noise(seeds[job], chunk.index, (b, l, n_ft), config["variance_scale"], device)
            start = circular(x[0], next(noise)[rows]) * valid[..., None]
            gaps["start_gap"] = max(gaps["start_gap"], float(start.max()))

            r = rows.shape[0]
            t_rec = torch.from_numpy(np.repeat(ts, r)).to(device)
            with ieee_float32():
                ref = denoiser.forward_blocks(params, config, x.reshape(steps * r, l, n_ft), t_rec,
                                              valid.repeat(steps, 1)).view(steps, r, l, n_ft)
            weight = valid[None, :, :, None]
            sq_err, sq_ref = ((eps - ref) ** 2 * weight).sum((2, 3)), ((ref ** 2) * weight).sum((2, 3))  # (S, R)
            gaps["eps_gap"] = max(gaps["eps_gap"], float((sq_err.sum() / sq_ref.sum()).sqrt()))
            per_record = (sq_err / sq_ref).sqrt()
            info.append(f"job {job} chunk {chunk.index} {b}x{l}: eps gap of a record median "
                        f"{float(per_record.median()):.3g}, largest {float(per_record.max()):.3g}")

            step_gaps = []
            for s in range(steps):
                c = coefs[s]
                out = ddpm_step(x[s], ref[s], c, next(noise)[rows] if s < steps - 1 else None)
                if s < steps - 1:
                    step_gaps.append(_row_medians(circular(x[s + 1], out), valid).max() / (c[0] * c[1] * c[2]))
            gaps["step_gap"] = max(gaps["step_gap"], float(torch.stack(step_gaps).max()) if step_gaps else 0.0)
            if requests is None:
                continue
            own = ddpm_step(x[-1], eps[-1], coefs[-1], None)
            for name, last in (("answer_gap", out), ("answer_own_gap", own)):
                final = wrap(last.cpu().numpy() + offsets[job])
                for i, row in enumerate(rows.tolist()):
                    request, length = requests[chunk.index][row], int(valid[i].sum())
                    answer = returned[job][request] if request < len(returned[job]) else None
                    gap = 2 * np.pi if answer is None or answer.shape[0] != length else \
                        float(np.abs(wrap(answer - final[i, :length])).max())
                    gaps[name] = max(gaps[name], gap / per_eps)
        gaps["jobs_checked"] += 1
    return dict(gaps) | {"info": "; ".join(info[:8])} if gaps["jobs_checked"] else {}
