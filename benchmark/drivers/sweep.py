"""
Traffic kind "sweep": a closed loop of DDPM sampling jobs, each one
sample() call as bin/sample_torch.py makes it at its defaults: n backbones
per length over [lo, hi), the job's own seed and a seeded mean offset,
the chunking and the sampler left to sample() (so every job builds and
captures its graphs, as every run of the command does). The model that
sample() is handed is the Recorder around the denoiser. Jobs start while
less than the window's seconds have passed; the rate counts their
backbones over the time from the first start to the last end.

Parameters (traffic/<name>.json): n_per_length, lengths [lo, hi),
record_rows (rows of each chunk the check follows), record_jobs (jobs the
ring of rows holds).
"""
from __future__ import annotations

import time

from benchmark.harness import chains, program, seeds, weights
from benchmark.harness.record import Recorder
from benchmark.harness.trace import span
from benchmark.reference import denoiser
from foldingdiff_tpu_torch.diffusion import sampling

SHAPE_JOBS = 64  # jobs whose chunk shapes the Recorder keeps for the readers


class Driver:
    def __init__(self, ctx):
        self.ctx, self.config, self.traffic = ctx, ctx.cell.config, ctx.cell.traffic
        self.steps = self.config["timesteps"]
        lo, hi = self.traffic["lengths"]
        self.lengths = [l for l in range(lo, hi) for _ in range(self.traffic["n_per_length"])]
        self.is_angular = list(denoiser.FEATURES[self.config["angles_definitions"]])
        if not all(self.is_angular):
            raise ValueError("the reference chains wrap every feature: angular feature sets only")
        self.returned, self.offsets, self.seeds = {}, {}, {}

    def job(self, schedule, seed: int, offset):
        self.recorder.start_job()
        lo, hi = self.traffic["lengths"]
        return sampling.sample(self.recorder, schedule, is_angular=self.is_angular, pad=self.config["max_seq_len"],
                               n=self.traffic["n_per_length"], sweep_lengths=(lo, hi),
                               angular_variance=self.config["variance_scale"], mean_offset=offset, seed=seed,
                               method="ddpm")

    def setup(self) -> None:
        ctx = self.ctx
        model = program.model(self.config, weights.make(self.config, ctx.seed, ctx.device), ctx.device)
        self.schedule = program.schedule(self.config, ctx.device)
        self.recorder = Recorder(model, self.traffic["record_rows"], self.config["max_seq_len"],
                                 len(self.is_angular), len(self.lengths), ctx.seed, ctx.device)
        # warm-up: a job of two steps, which builds and captures each of the job's chunk shapes once
        self.job(program.schedule(self.config | {"timesteps": 2}, ctx.device), 0, None)
        calls = self.recorder.calls() // 2 * self.steps
        self.recorder.resize(self.traffic["record_jobs"] * calls, SHAPE_JOBS * calls)

    def window(self, seconds: float) -> None:
        ctx, n = self.ctx, 0
        launches0 = program.launches_by_instance()
        self.t0 = time.perf_counter()
        while time.perf_counter() - self.t0 < seconds:
            with span("sweep.job"):
                self.offsets[n] = seeds.rng(ctx.seed, "offset", n).normal(0.0, 1.0, len(self.is_angular))
                self.seeds[n] = seeds.derive(ctx.seed, "jobs", n)
                self.returned[n] = self.job(self.schedule, self.seeds[n], self.offsets[n])
            n += 1
        self.t1 = time.perf_counter()
        self.jobs = n
        self.launches = {k: v - launches0.get(k, 0) for k, v in program.launches_by_instance().items()}
        self.chunks = self.recorder.chunks(self.steps)

    def end_to_end(self) -> dict:
        return {"ddpm_backbones_per_s": self.jobs * len(self.lengths) / (self.t1 - self.t0)}

    def counts(self):
        return self.jobs * len(self.lengths), chains.missing([self.lengths] * self.jobs,
                                                             [self.returned[j] for j in range(self.jobs)])

    def facts(self) -> dict:
        return {"kind": "sweep", "window_s": self.t1 - self.t0, "jobs": self.jobs,
                "chunks": [(c.b, c.l, c.real, c.job) for c in self.chunks], "steps_run": self.recorder.calls(),
                "steps_per_chunk": self.steps, "config": self.config, "launches": self.launches,
                "flops": self.jobs * self.steps * sum(denoiser.matmul_flops(self.config, l) for l in self.lengths)}

    def release(self) -> None:
        self.recorder.model = None

    def check(self) -> dict:
        params = weights.make(self.config, self.ctx.seed, self.ctx.device)
        return chains.check(params, self.config, self.recorder, self.chunks, self.lengths, self.returned,
                            self.offsets, self.seeds)
