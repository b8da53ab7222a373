#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (foldingdiff_tpu_torch) on one NVIDIA GPU.

Phases, each printing lines of its own:
  0. the card, as nvidia-smi names it with its power limit; fails without CUDA
  1. build both attention kernels (csrc/rel_attention.cu, the v2 entry, and
     csrc/gathered_attention.cu, the v1 entry) with nvcc, one process per
     part of each source (ops/attention.py's CudaLibrary.parts), started
     together
  1. (also) fails if ptxas reports a spill in any kernel instance
  2. each kernel against its plain PyTorch version on the card, with and
     without relative scores (v1: e_lr gathered from arange and from a
     permuted position vector, and random), at the denoiser's shapes and
     head sizes 16 and 64; both on contiguous q, k, v and on strided
     (B, L, H, D) views of the projections, each returning a view of a
     (B, L, H, D) buffer (v1 without e_lr launches the v2 kernel's rel-off
     instance); masked-key invariance; the instances on the views.
     Each instance by matmul precision against the plain version in its
     mode: FMA within 1e-4 (float32); TF32 (tensor cores) within 5e-3
     relative RMS of float32; bf16 within a tenth of the plain bf16
     version's relative-RMS distance from float32 and within 5e-2 of
     float32; the multi-pass instances (tf32x3, bf16x3, bf16x6, bf16x9:
     the presets' products of TF32 or bf16 parts) within 1e-5 relative RMS
     of the plain version in their mode and within a tenth of the TF32
     instance's distance from float32 on the same inputs (v2 and v1 alike;
     v1's at every e_lr kind, with masked-key invariance); at H = 12, D = 32
     and (B, L) = (64, 128), (64, 64), (15, 64), the f64 instances within
     1e-6 relative RMS of the plain version in their mode (float64
     products, each dot rounded to float32) and the 16-bit ones (f16,
     f16f16, bf16bf16: F16_F16_F32, F16_F16_F16, BF16_BF16_BF16) within a
     tenth of their plain version's distance from float32 (above 0) and
     within 5e-2 of float32. Kernel, plain
     (in the instance's mode) and library times (SDPA for rel-off, in each
     instance's precision: IEEE float32, TF32 GEMMs, bf16, f16 or float64
     copies; IEEE float32 beside the multi-pass rows, float32's products,
     not the split ones), all instances taken in turns in one call, at
     H = 12, D = 32 and (B, L) = (64, 128), (64, 64), (15, 64), each beside
     its bound: the larger of its FLOPs (times the instance's products of
     parts) over the peak for its operands' type (67 TFLOP/s FMA, 67
     float64 for f64, the FP64 tensor cores' peak, 495 TF32 for tf32 and
     tf32x3, 989 bf16 or f16 for bf16,
     the 16-bit instances and the bf16 multi-pass instances) and its bytes
     over 3.35 TB/s; each kernel's TF32 instance must beat
     its FMA one at B = 64, L = 128 with relative scores
  3. the trained torch fixture loaded through models.io.from_dir onto the
     card under attention_impl "auto" (v2) and "pallas" (v1), against its
     recorded predictions (parity.npz)
  4. the flagship denoiser (12 layers x 384, 12 heads of 32, relative_key,
     M = 128) with seeded random weights, read back from a model directory,
     "auto" (12 v2 launches), "pallas" (12 v1) and "auto" with permuted
     position_ids (12 v1, no v2) against "plain" at B = 64, L = 128, timed;
     and a 12 x 384 `absolute` config under "pallas" (the v1 entry without
     e_lr: 12 launches of the v2 kernel's rel-off instance) against "plain"
  5. the DDPM slice: bin/sample_torch.py's main() over that model directory,
     DDPM T = 1000 over lengths 50..127 once each at batch 64, its chains
     replayed as CUDA graphs; every layer of every reverse step must launch
     the v2 kernel (12 per step); then torch.profiler windows of a few
     eager DDPM steps (p_sample_step) under "auto" and "pallas" at both
     chunk shapes, read from the most complete of three (the profiler now
     and then loses a record): device operations, busy time and kernel
     groups per step; "auto" must run 14 fewer device operations per step than
     "pallas" at B = 64, L = 128 (pallas's 12 e_lr gathers and 2 index
     operations: no layout copies around either kernel)
  6. the new paths at full width: the flagship under "pallas" through
     sampling.sample (DDPM T = 1000, the same sweep), every layer of every
     step launching the v1 kernel and none the v2; then bin/sample_torch.py
     with --method ddim --ddim_steps 50 and --method dpmpp --ddim_steps 20,
     each launching the v2 kernel on every layer of every step
  7. training at the flagship config (config_jsons/
     synthetic24k_full_angles_cosine.json: 12 x 384, pad 128, T = 1000
     cosine, randomcrop, batch 64, AdamW 1e-4, LinearWarmup, dropout 0.1)
     through bin/train_torch.py on a corpus of 384 synthetic backbones with
     CATH-like lengths written in a temporary directory: 2 epochs saving the
     train state each epoch, then a resume for a third; finite losses, 3 CSV
     rows, checkpoints by validation and by training loss, and the v2 kernel
     launched 12 times per validation batch and never in a train step; one
     train step at B = 8 on the card against the same step on the CPU
     (dropout 0); remat against no remat (equal loss, peak memory of each);
     ms per train step at B = 64, L = 128 (median of 25 synchronised steps),
     with and without the pdist loss, and a torch.profiler breakdown of a
     step; then DDIM-50 from the trained directory through
     bin/sample_torch.py
  8. the rest of the single-device surface: (a) partial-noise reconstruction
     through bin/partial_noise_reconstruct_torch.py's main() on phase 7's
     trained directory and corpus (t = 250, the whole test split at batch
     64: 12 v2 launches per reverse step, TM scores finite in (0, 1], the
     JSON's keys, the native TM-align built; chain and host-scoring seconds
     apart); (b) one reconstruction batch of 4 test structures on the card
     against the CPU from the same x0, eps and step noise at t = 25, within
     1e-3 circular; (c) bin/sample_torch.py --method ddim --ddim_steps 50
     --fullhistory over the sweep from phase 4's flagship directory (50
     history CSVs per structure, the last equal to the final CSV,
     model_snapshot/); (d) a cart-coords model at
     config_jsons/synthetic_raw_coordinates.json's widths with seeded random
     weights, DDPM T = 1000 through the CLI over lengths 50..59: CA-trace
     PDBs written plus those the 1000 A guard skipped make 10; (e)
     bin/train_torch.py --debug_single_time for 1 epoch on phase 7's corpus
     at the flagship config (finite losses, neither kernel launched) and
     ms per pre-corrupted step at B = 64, L = 128
  9. the baselines, on phase 7's corpus: (a) the autoregressive (AR)
     baseline trained through bin/train_autoregressive_torch.py on
     config_jsons/synthetic_full_angles_cosine.json (12 x 384,
     relative_key, pad 128, batch 64) for 2 epochs: finite losses, 2 CSV
     rows, checkpoints, the v2 kernel launched 12 times per validation
     batch and never in a train step; ms per AR train step at B = 64,
     L = 128 (median of 25 synchronised steps after 3); (b) one AR train
     step at B = 8 on the card against the CPU (dropout 0, causal lengths
     injected; loss within 1e-6, parameters within 1e-4 + 1e-3 |p|);
     (c) bin/sample_autoregressive_torch.py -n 64 --numseed 4 from (a)'s
     directory: exactly 12 x (max(lengths) - 4) v2 launches, angles finite
     in [-pi, pi), the PDBs written, seconds and ms per forward, and the
     device operations of a forward from a torch.profiler window; (d) a
     seeded random AR directory at bin/train_autoregressive_torch.py's
     defaults (12 x 384, `absolute`) through the same CLI, launching only the
     v2 kernel's rel-off instance, 12 per forward; one AR forward of each
     model at B = 64 under "auto" against "plain" with prefixes of 4 and
     100 keys, timed; (e) ar_sample of 4 chains on the card against the CPU
     from the same seeds, within 1e-3 circular; (f) the random-angle
     baseline (bin/sample_random_angles_torch.py -n 64), and the KS max
     statistic, mean P-SEA helix and strand elements and mean clashes of
     (c)'s and (f)'s sets and of the test split, against the test split
     (printed, no thresholds)

 10. N ranks held equal to one rank, after phase 9, on phase 7's corpus and
     phase 4's flagship directory. One launch of 2 ranks of
     `python -m foldingdiff_tpu_torch.parallel.multihost` that share the
     card through gloo (NCCL refuses two ranks on one device) runs
     phase10_rank: (a) one data-parallel flagship train step at B = 64,
     L = 128 on a ragged batch, dropout 0, t and noise injected, against
     one process (loss within 1e-5, parameters within 1e-4 + 1e-3 |p| where
     the gradient clears 10x the two runs' gradient difference), and ms per
     DP step; (b) bin/sample_torch.py's main() over phase 5's sweep (DDPM
     T = 1000, -n 1 -l 50 128 -b 64) with each chunk's rows split over the
     ranks: 12 x 1000 x chunks v2 launches per rank, rank 0's CSVs within
     1e-3 (circular) of phase 5's one process, backbones/s; (d) the flagship
     forward in eval under "auto" on a (1, 2) TP mesh: 12 v2 launches per
     rank, each at H = 6, within 1e-3 of one rank, and one TP train step at
     B = 8 against one rank within phase 7's tolerances. (c)
     bin/train_torch.py --multihost as one NCCL rank for 1 epoch on phase
     7's config and corpus, then --resume for a second: finite losses, one
     metrics.csv with epochs 0 and 1. Any rank's failure fails the phase.
 11. the evaluation path, on phase 7's trained directory and corpus: (a)
     bin/sample_torch.py --method ddim --ddim_steps 50 over the sweep with
     the report (--testcomparison on the corpus) and --profile, after the
     same run without either (the profiler's overhead): exactly 1,200 v2
     launches, plots/ks_tests.json (six features) and ss_counts.json, the
     Chrome trace's events of the v2 kernel and of cuBLAS GEMMs, [phase]
     sampling seconds, and where matplotlib is missing one warning before
     sampling and no PDF; (b) three refolds per backbone (N/CA/C moved by
     0.3 (j + 1) A), bin/lddt_torch.py's JSON, and lddt_torch in float32 on
     the card per backbone (B = 3, N = 3L) within 1e-4 of it, device ms
     beside the host's lddt_np ms; (c) bin/sctm_torch.py, novelty against
     64 training structures, hclust of 20 (symmetric, unit diagonal); (d)
     oxygens and a random sequence's side chains on one PDB; (e) the
     native featurizer against the numpy path on 32 corpus files within
     1e-9, and the path the dataset layer logs; (f) PositionalEncoding on
     the card against the CPU within 1e-6; (g) the job lock names this
     process inside and is gone after, and bin/train_torch.py --epochs 1
     without --dryrun logs the KL diagnostics (without matplotlib its only
     diagnostics warning names it); (h) without matplotlib,
     bin/pdb_vis_torch.py exits at once naming it. Phases 5-10 pass
     --noplot and --dryrun to the CLIs, so they do the work they did
     before the report and the diagnostics became the defaults.
 12. CUDA graphs (the reverse chains and the train step as captured graphs,
     which the samplers and the single-device trainer replay by default on
     the card, so phases 5-8 and 11 ran them), each held against the same
     call with cuda_graphs=False on the card: the first 10 draws of a
     chunk's generator replayed in a graph, bitwise, at B = 15, L = 64 and
     B = 64, L = 128; DDPM T = 1000, DDIM-50 and DPM-Solver++-20 over the
     sweep through sample() (chunks 15 x 64 and 63 x 128), eager, then
     graphed twice (capture, replay): bitwise, 12 v2 launches per step each
     run (24,000 for DDPM), ms per step per chunk, capture seconds,
     backbones/s; DDPM under "pallas" (v1 in the graphs) for 200 steps at
     B = 15, L = 64 (at "high": the v1 TF32 instance, every launch of it)
     and a reconstruction chain from start_t = 250 with its
     history at B = 64, L = 128, graphed twice against eager, bitwise; the
     kernels of a graphed DDPM step's graph (read through the driver API)
     against the eager step's device operations: 2 more (the table reads
     and the counter in place of torch.full), at both chunk shapes, and its
     nodes of each kernel instance (12 of the v2 FMA instance; under
     "pallas" 12 of v1's; at "high" 12 of the v2 TF32 instance), named by
     the driver, equal to the launches the graph's accounting adds per
     replay; wall per step
     and a torch.profiler window's busy share beside phase 5's eager step,
     the step graph's memory pool; the flagship train step (dropout 0.1, clip 1.0,
     one-cycle lr) in a process with torch.use_deterministic_algorithms and
     CUBLAS_WORKSPACE_CONFIG=:4096:8: 8 graphed steps and 2 replays of
     fused_steps = 4 against 8 steps of the cuda_graphs=False trainer (the
     same capturable AdamW: every trainer on the card has it), and 2 steps
     with config_jsons/cath_full_angles_cosine_pdist.json's pdist loss,
     bitwise; there too Trainer.fit for 2 epochs over 5 batches and a
     ragged tail with fused_steps = 2 (a fused graph, the single-step graphs
     of the full and of the tail shape) against fit with cuda_graphs=False,
     every metrics row and parameter bitwise; with the default algorithms
     (the distance embedding's backward accumulates with atomics, so eager
     differs from eager) 4 steps graphed and fused_steps = 2 within 1e-6 of
     eager; ms per train step and structures/s eager, graphed and
     fused_steps = 4, and with pdist, the first step's capture seconds.
     The bitwise gates run the models at matmul_precision "high" (a TF32
     scope, which the captures must hold); the step graphs' nodes (held
     against phase 5's float32 profile), the 1e-6 gate and the timings at
     "default" under this script's IEEE float32 setting.
 13. matmul_precision: the flagship at "highest" (IEEE float32), "default"
     (under TF32 for the process, as the command-line programs set it:
     precision.set_process_default), "BF16_BF16_F32" (bf16 operands,
     float32 sums and output), the multi-pass presets TF32_TF32_F32_X3,
     BF16_BF16_F32_X3, _X6 and _X9 (products of TF32 or bf16 parts),
     F64_F64_F64 (float64 products) and the 16-bit presets F16_F16_F32,
     F16_F16_F16 and BF16_BF16_BF16 (f16 or bf16 operands; the last two
     round each dot's output). (a) the graphed DDPM step at the sweep's
     chunks (15 x 64, 63 x 128), the -n 1 DDPM sweep in backbones/s (not
     at F64_F64_F64 and the 16-bit presets, whose 66 graphed steps' 792
     v2 launches are counted instead) and the graphed train step at
     B = 64, L = 128; (b) against "highest" on the same inputs: one flagship
     forward (relative RMS of the difference above 0 and at most 1e-2 at
     TF32 and F16_F16_F32, 2e-2 at F16_F16_F16, 5e-2 at bf16 and
     BF16_BF16_BF16, 1e-4 at the multi-pass presets (5e-4 at
     BF16_BF16_F32_X3) and 1e-5 at F64_F64_F64, these two also at most a
     tenth of TF32's: the gate), a full DDPM chain
     of the trained torch
     fixture with the same draws (mean |d angle|) and the loss curve of 20
     train steps on a linear schedule; (c) the GEMM kernels of a DDPM
     step's graph and of the train step's graph, named by cuFuncGetName:
     all float32 FMA under "highest", all float64 under F64_F64_F64, all
     TF32 tensor cores under the rest (bf16 or f16 values or parts in TF32
     GEMMs) but the one GEMM with a 6-wide
     operand (FEATURE_GEMMS), the GEMM nodes in the count GEMM_NODES
     states (one GEMM per dot, a multi-pass preset's over its parts), and the step
     graph's 12 v2 nodes all of the precision's instance, as are the
     sweep's 24,000 launches; under every precision but "highest" also a
     "pallas" step's graph at 63 x 128 (12 nodes of v1's instance of the
     precision, no other v1 node), 13 steps replayed with the launches
     counted, and its time per graphed step; (d) the process's
     fp32_precision unchanged after every forward, train step and capture;
     (e) bin/sample_torch.py's main() over the sweep on a copy of the
     flagship directory whose config.json names TF32_TF32_F32_X3, every
     launch of the v2 tf32x3 instance.
     Phases 2-12 run with IEEE float32 GEMMs for the process, so their
     "default" models hold their float32 gates.

The line before the last is {"kernels": [...]}, one entry per kernel
instance: the v2 FMA instance's launches are phase 5's, phase 9's, phase
10's (b) and (d) on both ranks and phase 11's (a) (phase 9 prints its
rel-off launches apart), v1 FMA's phase 6's, the other v2 instances'
phase 13's sweeps at their precisions ("default" for TF32; the f64 and
16-bit instances' phase 13's graphed steps), the other v1
instances' phase 13's "pallas" steps, each counted under the graphs by their launch
accounting (graphs.py); the last is {"ok": true, "device": {...}}. Any
failure raises, so the script exits non-zero and prints neither.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import csv
import ctypes
import dataclasses
import gzip
import importlib.util
import json
import logging
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from examples.synthetic_proteins_torch import cath_like_lengths, synth_angles  # noqa: E402
from foldingdiff_tpu_torch.data import datasets as dsets  # noqa: E402
from foldingdiff_tpu_torch import utils_platform  # noqa: E402
from foldingdiff_tpu_torch.data import featurize_native  # noqa: E402
from foldingdiff_tpu_torch.data.datasets import AnglesEmptyDataset  # noqa: E402
from foldingdiff_tpu_torch.diffusion import sampling  # noqa: E402
from foldingdiff_tpu_torch.diffusion.noise import sample_wrapped_noise  # noqa: E402
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule  # noqa: E402
from foldingdiff_tpu_torch.geometry import sidechains  # noqa: E402
from foldingdiff_tpu_torch.graphs import CapturedLaunches, StepGraph, collector_paused  # noqa: E402
from foldingdiff_tpu_torch.geometry.featurize import (  # noqa: E402
    EXHAUSTIVE_ANGLES,
    EXHAUSTIVE_DISTS,
    canonical_distances_and_dihedrals,
    create_new_chain_nerf,
)
from foldingdiff_tpu_torch.geometry.pdb import extract_backbone_coords, read_pdb, write_coords_to_pdb  # noqa: E402
from foldingdiff_tpu_torch.metrics import clashes, kl, lddt, ss  # noqa: E402
from foldingdiff_tpu_torch.models import bert as models_bert  # noqa: E402
from foldingdiff_tpu_torch.models import io as model_io  # noqa: E402
from foldingdiff_tpu_torch.models.ar import BertForAutoregressive, ar_sample  # noqa: E402
from foldingdiff_tpu_torch.models.config import ModelConfig  # noqa: E402
from foldingdiff_tpu_torch.models.time_embed import PositionalEncoding  # noqa: E402
from foldingdiff_tpu_torch.ops import attention  # noqa: E402
from foldingdiff_tpu_torch.parallel import tp  # noqa: E402
from foldingdiff_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from foldingdiff_tpu_torch import precision  # noqa: E402
from foldingdiff_tpu_torch.precision import set_process_default  # noqa: E402
from foldingdiff_tpu_torch.training.ar_trainer import ARTrainer  # noqa: E402
from foldingdiff_tpu_torch.training.trainer import Trainer, TrainConfig  # noqa: E402
from foldingdiff_tpu_torch.utils_profiling import phase_totals  # noqa: E402

DEVICE = "cuda"
SEED = 1234
RUN_START = time.perf_counter()
KERNEL_TOL = 1e-4  # kernel vs plain, one attention call (float32, other summation order)
# The tensor-core instances against the plain versions (relative RMS): TF32
# within TF32_TOL of the float32 plain version; bf16 within BF16_SHARE of the
# plain bf16 version's own distance from float32, and within BF16_TOL of float32
TF32_TOL, BF16_SHARE, BF16_TOL = 5e-3, 0.1, 5e-2
# The multi-pass instances (the presets TF32_TF32_F32_X3, BF16_BF16_F32_X3,
# _X6, _X9: products of TF32 or bf16 parts) within SPLIT_TOL relative RMS of
# the plain version in their mode (the same products, summed in another
# order), and at most SPLIT_SHARE of the TF32 instance's distance from
# float32 on the same inputs
MULTI_PASS = ("tf32x3", "bf16x3", "bf16x6", "bf16x9")
TENSOR_CORE = ("tf32", "bf16", *MULTI_PASS)
SPLIT_TOL, SPLIT_SHARE = 1e-5, 0.1
# The f64 instances (F64_F64_F64) within F64_TOL relative RMS of the plain
# version in their mode; the 16-bit ones (F16_F16_F32, F16_F16_F16,
# BF16_BF16_BF16) within BF16_SHARE of their plain version's distance from
# float32 and within BF16_TOL of float32, as bf16's; each at the timed shapes
SIXTEEN_BIT = ("f16", "f16f16", "bf16bf16")
WIDE_AND_16 = ("f64", *SIXTEEN_BIT)
F64_TOL = 1e-6
DENOISER_TOL = 1e-3  # kernel vs plain through 12 layers
FIXTURE = REPO / "tests" / "torch_trained_model_for_testing"
FLAGSHIP = ModelConfig(
    hidden_size=384, num_hidden_layers=12, num_attention_heads=12, intermediate_size=768,
    max_position_embeddings=128, position_embedding_type="relative_key",
)
ABSOLUTE = dataclasses.replace(FLAGSHIP, position_embedding_type="absolute")
FLAGSHIP_TRAIN_ARGS = {
    "angles_definitions": "canonical-full-angles", "max_seq_len": 128, "min_seq_len": 40,
    "timesteps": 1000, "variance_schedule": "cosine", "variance_scale": 1.0,
    "time_encoding": "gaussian_fourier", "num_hidden_layers": 12, "hidden_size": 384,
    "intermediate_size": 768, "num_heads": 12, "position_embedding_type": "relative_key",
    "dropout_p": 0.1, "decoder": "mlp",
}
SWEEP, BATCH, BUCKET = (50, 128), 64, 64  # bin/sample_torch.py -l 50 128 -b 64 (bucket: sample()'s default)
# (B, H, L, D, M) of the kernel checks: the flagship at its buckets, the
# sweep's two chunks (15 lengths at 64, 63 at 128) and a ragged length, the
# fixtures' head size 16 with M = 64, and head size 64 with B * H = 15 (a
# ragged group of pairs for v1)
V2, V1 = attention.REL_ATTENTION, attention.GATHERED_ATTENTION
KERNEL_SHAPES = [(64, 12, 128, 32, 128), (64, 12, 64, 32, 128), (15, 12, 64, 32, 128), (63, 12, 128, 32, 128),
                 (64, 12, 50, 32, 128), (16, 6, 64, 16, 64), (16, 6, 33, 16, 64), (3, 5, 99, 64, 128)]
# (B, L) of the timed calls at H = 12, D = 32: the flagship at the sweep's
# two buckets, and sample()'s small chunk of the sweep (15 lengths at 64)
TIMED = [(64, 128), (64, 64), (15, 64)]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() in milliseconds, by CUDA events over iters calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50) -> float:
    """Mean device time of fn() in milliseconds: iters calls captured in one
    CUDA graph and replayed, timed by CUDA events, so the host's launch cost
    is left out."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with collector_paused(), torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: dict) -> dict:
    """{name: device ms} of each fn, the mean of two graph_ms runs taken in
    turns, forwards then backwards (plain, kernel, library, library, kernel,
    plain)."""
    times = {name: [graph_ms(fn)] for name, fn in fns.items()}
    for name, fn in reversed(fns.items()):
        times[name].append(graph_ms(fn))
    return {name: sum(t) / 2 for name, t in times.items()}


# H100 SXM dense peaks per instance, by the type of its operands: float32
# outside the tensor cores (FMA), float64 on the FP64 tensor cores (f64:
# the card's float64 peak, which its resident bodies run on, DMMA; the
# float64 FMA design past L = 128 and at D = 64 peaks at half of it), TF32
# (tf32, tf32x3), bf16 or f16 (bf16, the 16-bit instances and the bf16
# multi-pass instances: their products are of bf16 or f16 values); HBM3
PEAK_FLOPS = {"fma": 67e12, "f64": 67e12, **{i: 495e12 if precision.SPLITS.get(i, ("tf32",))[0] == "tf32" else 989e12
                                             for i in (*TENSOR_CORE, *SIXTEEN_BIT)}}
PEAK_BYTES = 3.35e12
# the products each instance computes per product of the function
PRODUCTS = {"fma": 1, "tf32": 1, "f64": 1, **{i: len(split[2]) for i, split in precision.SPLITS.items()}}


def bound(entry: str, rel: bool, b: int, h: int, l: int, d: int, m: int, instance: str = "fma") -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take for one call,
    the larger of its FLOPs (q.k, q.E and p.v products, 2 per FMA, times the
    instance's products of parts) over the instance's peak and its bytes
    (q, k, v, bias and the table or e_lr read once, out written once) over
    the memory rate."""
    flops = 2 * b * h * l * l * d * (3 if rel else 2) * PRODUCTS[instance]
    floats = 4 * b * h * l * d + b * l + (((2 * m - 1) * d if entry == "v2" else l * l * d) if rel else 0)
    ops_ms, bytes_ms = flops / PEAK_FLOPS[instance] * 1e3, 4 * floats / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def alternate_ms(plain, kernel, **kw) -> tuple[float, float]:
    """(plain ms, kernel ms), each the mean of two runs taken in turns:
    plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain, **kw), cuda_ms(kernel, **kw), cuda_ms(kernel, **kw), cuda_ms(plain, **kw)
    return (p1 + p2) / 2, (k1 + k2) / 2


def attention_inputs(b, h, l, d, m, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v = (torch.randn(b, h, l, d, generator=g, device=DEVICE) for _ in range(3))
    lengths = torch.randint(l // 2, l + 1, (b,), generator=g, device=DEVICE)
    bias = torch.where(torch.arange(l, device=DEVICE)[None, :] < lengths[:, None], 0.0, -10000.0)
    table = torch.randn(2 * m - 1, d, generator=g, device=DEVICE) * 0.5
    return q, k, v, bias, table


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU")
    # IEEE float32 GEMMs, where a "default" model runs them (precision.py): phases 2-12 hold float32 gates
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.fp32_precision = "ieee"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log("[0] card (nvidia-smi name, power.limit):")
    log(card)
    log(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: {torch.cuda.get_device_name(0)}")
    return card


def phase_build() -> None:
    start = time.perf_counter()
    reports = attention.build()
    seconds = time.perf_counter() - start
    spills = []
    for lib in attention.LIBRARIES:
        report = reports[lib.name]
        for part in range(len(lib.parts)):
            log(f"[1] {lib.library_path(part).relative_to(REPO)}" + ("" if report else " (already built)"))
        name = lib.name
        for line in report.splitlines():
            found = re.search(rf"Function properties for \S*?\d({lib.name}(?:_[a-z0-9]+)?_kernel)ILi(\d+)E"
                              r"(?:Lb(\d)E)?(?:Li(\d+)E)?", line)
            if found:  # the kernel instance the next lines report on
                name = "{} D={}".format(*found.groups()[:2]) + (f" rel={found[3]}" if found[3] else "") + (
                    f" keys={found[4]}" if found[4] else "")
            if "registers" in line or "spill" in line:
                log(f"[1]   {name}: {line.strip()}")
            if re.search(r"[1-9]\d* bytes spill", line):
                spills.append(f"{name}: {line.strip()}")
    log(f"[1] built both libraries in {seconds:.3f} s (one nvcc per part, "
        f"{sum(len(lib.parts) for lib in attention.LIBRARIES)} in parallel)")
    if spills:
        raise RuntimeError("ptxas spilled registers:\n" + "\n".join(spills))


def check_err(tag: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    err = (out - ref).abs().max().item()
    log(f"[2] {tag}: max abs err {err:.3e}")
    if not err <= KERNEL_TOL:
        raise RuntimeError(f"{tag}: kernel disagrees with the plain version: {err} > {KERNEL_TOL}")
    return err


def check_masked_keys(tag: str, run, q, k, v, bias, out) -> None:
    """Values at masked keys must not reach the output."""
    masked = (bias < -1.0)[:, None, :, None]
    drift = (run(q, k + 7.0 * masked, v - 3.0 * masked) - out).abs().max().item()
    log(f"[2] {tag}: masked-key drift {drift:.3e}")
    if not drift <= 1e-5:
        raise RuntimeError(f"{tag}: masked keys change the kernel's output by {drift}")


def gathered(table: torch.Tensor, l: int, m: int, permuted: bool) -> torch.Tensor:
    """e_lr[l, r] = table[pos[l] - pos[r] + M - 1], pos arange or a permutation of it."""
    pos = torch.arange(l, device=DEVICE)
    if permuted:
        pos = pos[torch.randperm(l, generator=torch.Generator().manual_seed(SEED + l)).to(DEVICE)]
    return table[pos[:, None] - pos[None, :] + m - 1]


def projection_views(b: int, h: int, l: int, d: int, seed: int):
    """q, k, v as the denoiser hands them to the v2 kernel: the
    .view(B, L, H, D).transpose(1, 2) of (B, L, H * D) projections."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn(b, l, h * d, generator=g, device=DEVICE).view(b, l, h, d).transpose(1, 2) for _ in range(3)]


def check_layout(tag: str, out: torch.Tensor, b: int, h: int, l: int, d: int) -> None:
    """The v2 kernel returns a (B, H, L, D) view of a contiguous (B, L, H, D) buffer."""
    if out.shape != (b, h, l, d) or out.stride() != (l * h * d, d, h * d, 1):
        raise RuntimeError(f"{tag}: output {tuple(out.shape)} strides {out.stride()}, "
                           f"expected a (B, H, L, D) view of a (B, L, H, D) buffer")


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).square().mean().sqrt() / b.square().mean().sqrt()).item()


def instance_reading(mode: str, out: torch.Tensor, plain, tf32_drift: float | None = None,
                     share: float = BF16_SHARE) -> tuple:
    """(whether out passes the gate of an instance in `mode`, what it read,
    the max abs err against the plain version in that mode (float32's for
    TF32, whose plain version on the card is cuBLAS's TF32, another
    rounding), the relative RMS against float32), plain(mode) being the
    plain version in a mode. The gates: TF32 within TF32_TOL relative RMS
    of float32's (and above 0: the instance took effect); bf16 and the
    16-bit modes within `share` (BF16_SHARE) of the plain version's
    relative-RMS distance from float32 in their mode (above 0), and within
    BF16_TOL of float32; f64 within F64_TOL of the plain version in its
    mode; a multi-pass mode within SPLIT_TOL of it and within SPLIT_SHARE
    of tf32_drift, the TF32 instance's distance from float32 on the same
    inputs."""
    f32 = plain("ieee")
    if mode == "tf32":
        rms = rel_rms(out, f32)
        err = (out - f32).abs().max().item()
        return (0 < rms <= TF32_TOL, f"relative RMS against float32 {rms:.3e} (gate: above 0, at most {TF32_TOL}), "
                f"max abs err {err:.3e}", err, rms)
    ref = plain(mode)
    rms, drift, err = rel_rms(out, ref), rel_rms(out, f32), (out - ref).abs().max().item()
    if mode == "f64":
        return (rms <= F64_TOL, f"relative RMS against the plain f64 version {rms:.3e} (gate: {F64_TOL}), against "
                f"float32 {drift:.3e}; max abs err {err:.3e}", err, drift)
    if mode in MULTI_PASS:
        return (rms <= SPLIT_TOL and drift <= SPLIT_SHARE * tf32_drift,
                f"relative RMS against the plain {mode} version {rms:.3e} (gate: {SPLIT_TOL}), against float32 "
                f"{drift:.3e} (gate: {SPLIT_SHARE} of the TF32 instance's {tf32_drift:.3e}); max abs err {err:.3e}",
                err, drift)
    gap = rel_rms(ref, f32)
    return (gap > 0 and rms <= share * gap and drift <= BF16_TOL,
            f"relative RMS against the plain {mode} version {rms:.3e} ({rms / gap if gap else math.inf:.3f} of its "
            f"distance from float32 {gap:.3e}; gate: at most {share} of it), against float32 {drift:.3e} (gate: "
            f"{BF16_TOL}); max abs err {err:.3e}", err, drift)


def check_instance(tag: str, mode: str, out: torch.Tensor, plain, tf32_drift: float | None = None,
                   share: float = BF16_SHARE) -> tuple:
    """instance_reading's gate, logged; raises where it fails. Returns (max
    abs err, relative RMS against float32)."""
    ok, reading, err, drift = instance_reading(mode, out, plain, tf32_drift, share)
    log(f"[2] {tag}: {reading}")
    if not ok:
        raise RuntimeError(f"{tag}: the {mode} instance fails its gate: {reading}")
    return err, drift


def in_mode(mode: str, fn):
    """fn() with cuBLAS's float32 GEMMs as a model in `mode` runs them: TF32
    under "tf32", "bf16", the 16-bit and the multi-pass modes (whose parts
    TF32 holds), the process's IEEE float32 otherwise ("f64" runs float64
    GEMMs)."""
    with precision.matmul_precision("caller" if mode == "ieee" else mode):
        return fn()


def v2_plain(q, k, v, bias, kw: dict, mode: str):
    """The v2 plain version in `mode` (products of parts under "bf16" and
    the multi-pass modes), its einsums as a model in that mode runs them."""
    return in_mode(mode, lambda: attention.fused_attention_v2_reference(q, k, v, bias, mode=mode, **kw))


# The SDPA call each instance is timed beside where it is not its own
# (sdpa_by_instance): the multi-pass rows' is IEEE SDPA, float32's products
# (not the split ones); the output-rounding 16-bit rows' the f16 or bf16
# call, whose output is rounded to that type
LIBRARY_OF = {**{m: "fma" for m in MULTI_PASS}, "f16f16": "f16", "bf16bf16": "bf16"}


def sdpa_by_instance(q, k, v, mask, bias, b: int, l: int) -> dict:
    """{library: one PyTorch call of the rel-off function in an instance's
    precision (LIBRARY_OF)}, the library yardstick (the port never calls it): SDPA (scale
    1/sqrt(D), the mask added) on float32 q, k and v under IEEE float32 and
    under TF32 GEMMs, and on bf16, f16 and float64 copies of them (the
    16-bit instances take the f16 or bf16 call, whose output is rounded to
    that type; f64 the float64 call, whose softmax is float64 too). Each is
    held against the float32 plain version: IEEE and float64 within
    KERNEL_TOL, TF32 within TF32_TOL and bf16 and f16 within BF16_TOL
    relative RMS (bf16 SDPA rounds the unnormalised P, so it is close to,
    not exactly, the JAX bf16 function)."""
    qb, kb, vb, mb = (x.to(torch.bfloat16) for x in (q, k, v, mask))
    qh, kh, vh, mh = (x.to(torch.float16) for x in (q, k, v, mask))
    qd, kd, vd, md = (x.double() for x in (q, k, v, mask))
    sdpa = F.scaled_dot_product_attention
    libraries = {"fma": lambda: sdpa(q, k, v, attn_mask=mask),
                 "tf32": lambda: in_mode("tf32", lambda: sdpa(q, k, v, attn_mask=mask)),
                 "bf16": lambda: sdpa(qb, kb, vb, attn_mask=mb),
                 "f64": lambda: sdpa(qd, kd, vd, attn_mask=md),
                 "f16": lambda: sdpa(qh, kh, vh, attn_mask=mh)}
    f32 = attention.fused_attention_reference(q, k, v, bias)
    check_err(f"SDPA B={b} L={l} rel-off (the library yardstick, IEEE float32)", libraries["fma"](), f32)
    check_err(f"SDPA B={b} L={l} rel-off (float64)", libraries["f64"]().float(), f32)
    for i, tol in (("tf32", TF32_TOL), ("bf16", BF16_TOL), ("f16", BF16_TOL)):
        rms = rel_rms(libraries[i]().float(), f32)
        log(f"[2] SDPA B={b} L={l} rel-off ({i}): relative RMS against float32 {rms:.3e} (at most {tol})")
        if not rms <= tol:
            raise RuntimeError(f"SDPA ({i}) is {rms} from the float32 plain version")
    return libraries


# Controls of the f64 and 16-bit gates: each gate, run on an instance that
# lacks what it holds, must fail, on inputs where that lack shows, and the
# gated instance passes on the same inputs: (gate, control instance, inputs)
CONTROLS = (("f64", "ieee", "cancelling"), ("f16", "tf32", "f16-subnormal v"), ("f16f16", "f16", "normal"),
            ("f16", "f16f16", "normal"), ("bf16bf16", "bf16", "normal"))
CANCEL_SCALE = 64.0  # "cancelling": q.k and q.E sum products of ~64^2 that cancel
TINY_V = 2.0 ** -16  # "f16-subnormal v": v at f16's subnormal size (its spacing 2^-24)
F16_OVERFLOW = 7e4  # past f16's largest finite value, 65504
# The card tests' share for the 16-bit instances (tests/test_torch_cuda.py
# SHARE), read at B = 3, H = 5, L = 99, D = 64 on those tests' inputs (seed
# 13, e_lr's 4) and on a second seed (14, 5), v1 and v2
RAGGED_SHARE = {"f16": 0.2, "f16f16": 0.2, "bf16bf16": 0.1}


def control_inputs(kind: str, b: int, h: int, l: int, d: int, m: int, seed: int):
    """attention_inputs, "normal"; "cancelling": q's first quarter of dims
    repeated in its second, k's and the table's negated there, both
    quarters scaled by CANCEL_SCALE, so that q.k and q.E are the second
    half's O(1) products after partial sums of ~CANCEL_SCALE^2 that cancel
    exactly (float32 sums keep ~1e-3 of them); "f16-subnormal v": v scaled
    by TINY_V."""
    q, k, v, bias, table = attention_inputs(b, h, l, d, m, seed)
    if kind == "cancelling":
        quarter = d // 4
        for x in (q, k, table):
            x[..., :2 * quarter] *= CANCEL_SCALE
        q[..., quarter:2 * quarter] = q[..., :quarter]
        k[..., quarter:2 * quarter] = -k[..., :quarter]
        table[..., quarter:2 * quarter] = -table[..., :quarter]
    elif kind == "f16-subnormal v":
        v = v * TINY_V
    return q, k, v, bias, table


def entry_calls(q, k, v, bias, table, e_lr, m: int) -> dict:
    """{entry: (kernel(mode), plain(mode))}: v2 on (B, L, H, D) views with
    the table, v1 with e_lr (each without relative scores where None)."""
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    kw = dict(rel_table=table, m=m) if table is not None else {}
    return {"v2": (lambda mode: attention.fused_attention_v2(*views, bias, mode=mode, **kw),
                   lambda mode: v2_plain(q, k, v, bias, kw, mode)),
            "v1": (lambda mode: attention.fused_attention(q, k, v, bias, e_lr, mode=mode),
                   lambda mode: in_mode(mode, lambda: attention.fused_attention_reference(q, k, v, bias, e_lr,
                                                                                         mode=mode)))}


def check_controls() -> None:
    """CONTROLS at B = 64, H = 12, L = 128, D = 32 with relative scores, v2
    and v1: the gated instance passes, the control fails; on "normal"
    inputs the FMA instance's reading through the f64 gate and the TF32
    instance's through the f16 gate are logged (float32 sums and TF32's
    rounding of N(0, 1) values come close to both there). Then f16's
    infinities, with and without relative scores (v1 without them runs the
    v2 rel-off instance): one value of v past 65504 at key 0 (inside every row's
    length; q scaled by 0.1, so that no P rounds to 0) makes the f16 and
    f16f16 instances' outputs +inf or -inf in that column, as their plain
    versions' are, and the rest passes their gate; the TF32 instance keeps
    it finite (the control)."""
    b, h, l, d, m = 64, 12, 128, 32, 128
    for gate, control, kind in (*CONTROLS, ("f64", "ieee", "normal"), ("f16", "tf32", "normal")):
        q, k, v, bias, table = control_inputs(kind, b, h, l, d, m, SEED + 7)
        for entry, (kernel, plain) in entry_calls(q, k, v, bias, table, gathered(table, l, m, False), m).items():
            tag = f"control {entry} B={b} L={l} rel, {kind} inputs"
            must_fail = (gate, control, kind) in CONTROLS
            if must_fail:
                check_instance(f"{tag}: the {gate} instance", gate, kernel(gate), plain)
            ok, reading, _, _ = instance_reading(gate, kernel(control), plain)
            log(f"[2] {tag}: the {control} instance through the {gate} gate ("
                + ("a control, which must fail it" if must_fail else "read only") + f"): {reading}")
            if must_fail and ok:
                raise RuntimeError(f"{tag}: the {control} instance passes the {gate} gate: {reading}")
    q, k, v, bias, table = attention_inputs(b, h, l, d, m, SEED + 8)
    q = q * 0.1
    v[:, :, 0, 0], v[:, :, 0, 1] = F16_OVERFLOW, -F16_OVERFLOW
    for rel in (True, False):
        calls = entry_calls(q, k, v, bias, table if rel else None, gathered(table, l, m, False) if rel else None, m)
        for entry, (kernel, plain) in calls.items():
            tag = f"{entry} {'rel' if rel else 'rel-off'}"
            for mode in ("f16", "f16f16", "tf32"):
                out, ref = kernel(mode)[..., :2], plain("f16" if mode == "tf32" else mode)[..., :2]
                infinite = bool((ref[..., 0] == math.inf).all() and (ref[..., 1] == -math.inf).all())
                same = torch.equal(out, ref)
                log(f"[2] f16 infinities, {tag} {mode} instance: v = +-{F16_OVERFLOW} at key 0 gives "
                    f"{out[..., 0].isposinf().sum().item()} +inf and {out[..., 1].isneginf().sum().item()} -inf of "
                    f"{out[..., 0].numel()} each; the plain f16 version all infinite {infinite}, equal to it {same}"
                    + (" (the control: it must differ)" if mode == "tf32" else ""))
                if not infinite or same != (mode != "tf32"):
                    raise RuntimeError(f"[2] f16 infinities, {tag} {mode} instance: equal to the plain version {same}")
                if mode != "tf32":
                    check_instance(f"{tag} {mode} B={b} L={l} with v past 65504, the other columns", mode,
                                   kernel(mode)[..., 2:], lambda mode_: plain(mode_)[..., 2:])


def check_ragged_shares() -> None:
    """The 16-bit instances at B = 3, H = 5, L = 99, D = 64, v1 (e_lr
    random) and v2 (the table), with and without relative scores, on the
    card tests' inputs and a second seed, against RAGGED_SHARE (the card
    tests' shares) of their plain version's distance from float32."""
    b, h, l, d, m = 3, 5, 99, 64, 128
    for seed, e_seed in ((13, 4), (14, 5)):
        q, k, v, bias, table = attention_inputs(b, h, l, d, m, seed)
        e_lr = torch.randn(l, l, d, generator=torch.Generator(device=DEVICE).manual_seed(e_seed), device=DEVICE) * 0.5
        for rel in (True, False):
            calls = entry_calls(q, k, v, bias, table if rel else None, e_lr if rel else None, m)
            for entry, (kernel, plain) in calls.items():
                for mode, share in RAGGED_SHARE.items():
                    check_instance(f"{entry} {mode} B={b} H={h} L={l} D={d} rel={rel} seed {seed} (the card tests' "
                                   f"share)", mode, kernel(mode), plain, share=share)


def phase_kernel() -> dict:
    """Returns {(entry, instance): the kernels line's numbers at B = 64,
    L = 128 with relative scores}."""
    worst = {(entry, i): 0.0 for entry, lib in (("v2", V2), ("v1", V1)) for i in lib.instances}
    with torch.inference_mode():
        check_controls()
        check_ragged_shares()
        for b, h, l, d, m in KERNEL_SHAPES:
            q, k, v, bias, table = attention_inputs(b, h, l, d, m, SEED + l + d)
            views = projection_views(b, h, l, d, SEED + l)
            shape = f"B={b} H={h} L={l} D={d} M={m}"
            # the f64 and 16-bit instances at the timed shapes
            modes = TENSOR_CORE + (WIDE_AND_16 if (b, l) in TIMED and (h, d, m) == (12, 32, 128) else ())
            for rel in (True, False):
                kw = dict(rel_table=table, m=m) if rel else {}
                out = attention.fused_attention_v2(q, k, v, bias, **kw)
                ref = attention.fused_attention_v2_reference(q, k, v, bias, **kw)
                worst["v2", "fma"] = max(worst["v2", "fma"], check_err(f"v2 {shape} rel={rel}", out, ref))
                check_layout(f"v2 {shape}", out, b, h, l, d)
                out_s = attention.fused_attention_v2(*views, bias, **kw)
                ref_s = attention.fused_attention_v2_reference(*views, bias, **kw)
                worst["v2", "fma"] = max(worst["v2", "fma"], check_err(
                    f"v2 {shape} rel={rel} on (B, L, H, D) views", out_s, ref_s))
                check_layout(f"v2 {shape} on views", out_s, b, h, l, d)
                if rel:
                    check_masked_keys(f"v2 {shape}", lambda q_, k_, v_: attention.fused_attention_v2(
                        q_, k_, v_, bias, table, m), q, k, v, bias, out)
                    check_masked_keys(f"v2 {shape} on views", lambda q_, k_, v_: attention.fused_attention_v2(
                        *(x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q_, k_, v_)), bias, table, m),
                        q, k, v, bias, out)
                tf32_drift = None
                for mode in modes:  # the tensor-core and f64 instances, on the projections' views
                    out_t = attention.fused_attention_v2(*views, bias, mode=mode, **kw)
                    check_layout(f"v2 {mode} {shape} on views", out_t, b, h, l, d)
                    err, drift = check_instance(f"v2 {mode} {shape} rel={rel} on (B, L, H, D) views", mode, out_t,
                                                lambda mode_: v2_plain(*views, bias, kw, mode_), tf32_drift)
                    worst["v2", mode] = max(worst["v2", mode], err)
                    tf32_drift = drift if mode == "tf32" else tf32_drift
                    if rel:
                        check_masked_keys(f"v2 {mode} {shape} on views", lambda q_, k_, v_: attention.fused_attention_v2(
                            *(x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q_, k_, v_)), bias, table, m,
                            mode=mode), q, k, v, bias, attention.fused_attention_v2(q, k, v, bias, table, m, mode=mode))
            for e_kind in ("arange", "permuted", "random", None):
                if e_kind == "random":  # not Toeplitz
                    e_lr = torch.randn(l, l, d, generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                                       device=DEVICE) * 0.5
                else:
                    e_lr = gathered(table, l, m, e_kind == "permuted") if e_kind else None
                # without e_lr the v1 entry launches the v2 kernel's rel-off instance: its rows are v2's
                rel = e_kind is not None
                out = attention.fused_attention(q, k, v, bias, e_lr)
                ref = attention.fused_attention_reference(q, k, v, bias, e_lr)
                err = check_err(f"v1 {shape} e_lr={e_kind}", out, ref)
                check_layout(f"v1 {shape} e_lr={e_kind}", out, b, h, l, d)
                out_s = attention.fused_attention(*views, bias, e_lr)
                ref_s = attention.fused_attention_reference(*views, bias, e_lr)
                err = max(err, check_err(f"v1 {shape} e_lr={e_kind} on (B, L, H, D) views", out_s, ref_s))
                check_layout(f"v1 {shape} e_lr={e_kind} on views", out_s, b, h, l, d)
                if rel:
                    worst["v1", "fma"] = max(worst["v1", "fma"], err)
                if e_kind == "permuted":
                    check_masked_keys(f"v1 {shape}", lambda q_, k_, v_: attention.fused_attention(
                        q_, k_, v_, bias, e_lr), q, k, v, bias, out)
                tf32_drift = None
                for mode in modes:  # the tensor-core and f64 instances, on the projections' views
                    out_t = attention.fused_attention(*views, bias, e_lr, mode=mode)
                    check_layout(f"v1 {mode} {shape} e_lr={e_kind} on views", out_t, b, h, l, d)
                    err, drift = check_instance(
                        f"v1 {mode} {shape} e_lr={e_kind} on (B, L, H, D) views", mode, out_t,
                        lambda mode_: in_mode(mode_, lambda: attention.fused_attention_reference(
                            *views, bias, e_lr, mode=mode_)), tf32_drift)
                    if rel:
                        worst["v1", mode] = max(worst["v1", mode], err)
                    tf32_drift = drift if mode == "tf32" else tf32_drift
                    check_masked_keys(f"v1 {mode} {shape} e_lr={e_kind} on views", lambda q_, k_, v_: (
                        attention.fused_attention(*(x.transpose(1, 2).contiguous().transpose(1, 2)
                                                    for x in (q_, k_, v_)), bias, e_lr, mode=mode)),
                        q, k, v, bias, attention.fused_attention(q, k, v, bias, e_lr, mode=mode))

        results = {}
        for b, l in TIMED:
            h, d, m = 12, 32, 128
            q, k, v, bias, table = attention_inputs(b, h, l, d, m, SEED)
            views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]  # (B, L, H, D) storage
            e_lr = gathered(table, l, m, permuted=False)
            mask = bias[:, None, None, :]
            for rel in (True, False):
                kw2 = dict(rel_table=table, m=m) if rel else {}
                e = e_lr if rel else None
                libraries = {} if rel else sdpa_by_instance(q, k, v, mask, bias, b, l)
                # every instance of a kernel and its plain version in that instance's mode, in turns in one call
                fns = {}
                for i in V2.instances:
                    mode = "ieee" if i == "fma" else i
                    fns["v2", i] = (lambda mode=mode: attention.fused_attention_v2(*views, bias, mode=mode, **kw2))
                    fns["v2 plain", i] = (lambda mode=mode: v2_plain(q, k, v, bias, kw2, mode))
                for i in V1.instances:  # without e_lr: the v2 kernel's rel-off instance, through the v1 entry
                    mode = "ieee" if i == "fma" else i
                    fns["v1", i] = (lambda mode=mode: attention.fused_attention(*views, bias, e, mode=mode))
                    fns["v1 plain", i] = (lambda mode=mode: in_mode(mode, lambda: (
                        attention.fused_attention_reference(q, k, v, bias, e, mode=mode))))
                fns.update({("library", i): fn for i, fn in libraries.items()})
                times = in_turns(fns)
                for entry, lib in (("v2", V2), ("v1", V1)):
                    for i in lib.instances:
                        bound_ms, bound_by = bound(entry, rel, b, h, l, d, m, i)
                        ms = times[entry, i]
                        library = LIBRARY_OF.get(i, i)
                        results[entry, i, rel, b, l] = {
                            "kernel": ms, "plain": times[f"{entry} plain", i],
                            "library": times.get(("library", library)), "bound_ms": bound_ms, "bound_by": bound_by}
                        lib_text = "none"
                        if libraries:
                            lib_text = f"{times['library', library]:.4f} ms (SDPA, {library}" + (
                                ": float32's products, not the split ones)" if i in MULTI_PASS else ")")
                        log(f"[2] time {entry} {i} B={b} H={h} L={l} D={d} {'rel' if rel else 'rel-off'} (device, "
                            f"CUDA graph, in turns): kernel {ms:.4f} ms, plain {times[f'{entry} plain', i]:.4f} ms, "
                            f"library {lib_text}; bound {bound_ms * 1e3:.1f} us ({bound_by}), {bound_ms / ms:.1%} of it")
    flagship = {key: results[(*key, True, *TIMED[0])] for key in worst}  # B=64, L=128, rel
    for entry in ("v2", "v1"):
        if not flagship[entry, "tf32"]["kernel"] < flagship[entry, "fma"]["kernel"]:
            raise RuntimeError(f"[2] the {entry} TF32 instance ({flagship[entry, 'tf32']['kernel']} ms) is not faster "
                               f"than the FMA instance ({flagship[entry, 'fma']['kernel']} ms) at B=64 L=128")
    return {key: {"max_abs_err": worst[key], "ms": r["kernel"], "plain_ms": r["plain"],
                  "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}
            for key, r in flagship.items()}


def phase_fixture() -> None:
    parity = np.load(FIXTURE / "parity.npz")
    for impl, lib in (("auto", V2), ("pallas", V1)):
        model, _ = model_io.from_dir(str(FIXTURE), device=DEVICE, attention_impl=impl)
        v2_before, v1_before = V2.launches, V1.launches
        with torch.inference_mode():
            out = model(*(torch.from_numpy(parity[k]).to(DEVICE) for k in ("x", "t", "mask")))
        out = out.cpu().numpy()
        launched = {V2.name: V2.launches - v2_before, V1.name: V1.launches - v1_before}
        expected = {V2.name: 0, V1.name: 0, lib.name: model.config.num_hidden_layers}
        if launched != expected:
            raise RuntimeError(f"fixture forward under {impl!r} launched {launched}, expected {expected}")
        err = float(np.abs(out - parity["predicted_noise"]).max())
        log(f"[3] torch fixture via from_dir on the card, attention_impl={impl!r} ({lib.name}): "
            f"max abs err {err:.3e} (atol 2e-5, rtol 1e-4)")
        np.testing.assert_allclose(out, parity["predicted_noise"], atol=2e-5, rtol=1e-4)


def denoiser_inputs(b: int, l: int):
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    x = (torch.rand(b, l, 6, generator=g, device=DEVICE) * 2 - 1) * math.pi
    t = torch.randint(0, 1000, (b,), generator=g, device=DEVICE)
    lengths = torch.randint(SWEEP[0], l + 1, (b,), generator=g, device=DEVICE)
    mask = (torch.arange(l, device=DEVICE)[None, :] < lengths[:, None]).float()
    return x, t, mask


def phase_denoiser(model_dir: str, absolute_dir: str) -> None:
    """Each kernel route against "plain" on the same inputs. ("auto", perm):
    "auto" given permuted position ids takes the v1 kernel on e_lr gathered
    from them (JAX's einsum path gathers from position_ids[0]), never v2."""
    b, l = BATCH, FLAGSHIP.max_position_embeddings
    x, t, mask = denoiser_inputs(b, l)
    perm = torch.randperm(l, generator=torch.Generator().manual_seed(SEED)).to(DEVICE).expand(b, l)
    layers = FLAGSHIP.num_hidden_layers
    for name, path, routes in (
        ("flagship", model_dir, (("auto", None, V2), ("pallas", None, V1), ("auto", perm, V1))),
        ("absolute 12x384", absolute_dir, (("pallas", None, V2),)),  # the v1 entry without e_lr: v2's rel-off
    ):
        plain, _ = model_io.from_dir(path, device=DEVICE, attention_impl="plain")
        for impl, pos, lib in routes:
            model, _ = model_io.from_dir(path, device=DEVICE, attention_impl=impl)
            what = f"attention_impl={impl!r}" + (", permuted position_ids" if pos is not None else "")
            with torch.inference_mode():
                reset_counts()
                out = model(x, t, mask, pos)
                check_launches(f"[4] {name} {what}", {V2.name: 0, V1.name: 0, lib.name: layers})
                rel_off = layers if name.startswith("absolute") else 0
                if V2.rel_off_launches != rel_off or V1.rel_off_launches:
                    raise RuntimeError(f"[4] {name} {what}: {V2.rel_off_launches} v2 and {V1.rel_off_launches} v1 "
                                       f"rel-off launches, expected {rel_off} and 0")
                err = (out - plain(x, t, mask, pos)).abs().max().item()
                log(f"[4] {name} denoiser B={b} L={l}, {what} vs plain: max abs err {err:.3e}")
                if not err <= DENOISER_TOL:
                    raise RuntimeError(f"{name} denoiser {what} disagrees with plain: {err} > {DENOISER_TOL}")
                plain_ms, kernel_ms = alternate_ms(lambda: plain(x, t, mask, pos), lambda: model(x, t, mask, pos),
                                                   iters=20)
            log(f"[4] time one {name} denoiser call B={b} L={l}, {what}: {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms")


def expected_chunks() -> int:
    """Chunks that sample() makes of the sweep: lengths grouped by their
    bucket, each group cut into batches."""
    per_bucket: dict = {}
    for length in range(*SWEEP):
        bucket = min(FLAGSHIP.max_position_embeddings, -(-length // BUCKET) * BUCKET)
        per_bucket[bucket] = per_bucket.get(bucket, 0) + 1
    return sum(-(-n // BATCH) for n in per_bucket.values())


def load_script(name: str):
    """bin/<name>.py as a module, to call its main() in this process."""
    spec = importlib.util.spec_from_file_location(name, REPO / "bin" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reset_counts() -> None:
    """Every launch count of both kernels to 0: all, rel-off, per instance."""
    for lib in attention.LIBRARIES:
        lib.launches = lib.rel_off_launches = 0
        lib.launches_by_instance = dict.fromkeys(lib.instances, 0)


def check_launches(tag: str, expected: dict, instance: str = "fma") -> None:
    """Each kernel's launches since reset_counts() against `expected`, every
    launch of either kernel of `instance` (the process runs IEEE float32 but
    in phase 13 and phase 12's "high" models)."""
    launched = {V2.name: V2.launches, V1.name: V1.launches}
    by_instance = {lib.name: {i: n for i, n in lib.launches_by_instance.items() if n} for lib in attention.LIBRARIES}
    log(f"{tag} kernel launches: {launched} (by instance {by_instance}), expected {expected}, all {instance}")
    if launched != expected or any(lib.launches_by_instance[instance] != lib.launches for lib in attention.LIBRARIES):
        raise RuntimeError(f"{tag} launched {launched} (by instance {by_instance}), expected {expected}, "
                           f"all {instance}")


def check_angles(tag: str, sampled) -> None:
    """One (length, 6) array per swept length, finite, angles in [-pi, pi)."""
    lengths = list(range(*SWEEP))
    if len(sampled) != len(lengths):
        raise RuntimeError(f"{tag}: {len(sampled)} structures, expected {len(lengths)}")
    for i, (angles, length) in enumerate(zip(sampled, lengths)):
        if angles.shape != (length, 6):
            raise RuntimeError(f"{tag} generated_{i}: shape {angles.shape}, expected {(length, 6)}")
        if not (np.all(np.isfinite(angles)) and angles.min() >= -np.pi and angles.max() < np.pi):
            raise RuntimeError(f"{tag} generated_{i}: angles not finite in [-pi, pi)")


def run_cli(tag: str, model_dir: str, out_dir: str, extra: list, expected: dict, card: str, steps: int,
            instance: str = "fma") -> None:
    """bin/sample_torch.py's main() over the sweep; checks launches (all of
    `instance`), PDBs, CSVs; prints backbones/s."""
    argv = ["-m", model_dir, "-o", out_dir, "-n", "1", "-l", str(SWEEP[0]), str(SWEEP[1]),
            "-b", str(BATCH), "--seed", str(SEED), "--device", DEVICE, "--noplot", *extra]
    reset_counts()
    start = time.perf_counter()
    result = load_script("sample_torch").main(argv)
    wall = time.perf_counter() - start
    check_launches(tag, expected, instance)

    n = len(range(*SWEEP))
    pdbs = sorted(Path(out_dir, "sampled_pdb").glob("generated_*.pdb"))
    if len(pdbs) != n or result["n_structures"] != n:
        raise RuntimeError(f"{tag}: expected {n} PDBs, found {len(pdbs)}")
    check_angles(tag, [np.loadtxt(Path(out_dir, "sampled_angles", f"generated_{i}.csv.gz"), delimiter=",",
                                  skiprows=1, ndmin=2) for i in range(n)])
    seconds = result["sampling_seconds"]
    n_chunks = expected_chunks()
    log(f"{tag} on {card}: {n} backbones, {' '.join(extra) or 'DDPM'}, {steps} steps, batch {BATCH}, "
        f"bucket {BUCKET}, {n_chunks} chunks, CUDA graphs: sampling {seconds:.3f} s, {n / seconds:.3f} backbones/s, "
        f"{seconds / (steps * n_chunks) * 1e3:.4f} ms per reverse step (mean over chunks); "
        f"CLI wall with loading and PDB writing {wall:.3f} s")


def phase_slice(model_dir: str, out_dir: str, card: str) -> int:
    timesteps = FLAGSHIP_TRAIN_ARGS["timesteps"]
    launches = FLAGSHIP.num_hidden_layers * timesteps * expected_chunks()
    run_cli("[5] DDPM slice", model_dir, out_dir, [], {V2.name: launches, V1.name: 0}, card, timesteps)
    return V2.launches


def kernel_group(name: str) -> str:
    """The group of a device event, by its kernel name."""
    low = name.lower()
    for group, keys in (("attention v2", ("rel_attention",)), ("attention v1", ("gathered_attention",)),
                        ("gemm", ("gemm", "xmma", "cutlass", "sm80_", "sm90_", "nvjet")),
                        ("gather", ("gather", "indexselect", "index_select")),
                        ("copy", ("copy",)), ("layer norm", ("layer_norm",))):
        if any(key in low for key in keys):
            return group
    return "other elementwise"


# torch.profiler windows per profile_steps call: now and then a window
# loses a few device records (a DDPM step at 15 x 64 read 174.5 operations
# where every step runs 175), so the window with the most events is read
PROFILE_WINDOWS = 3


def profile_steps(model_dir: str, impl: str, b: int, l: int, steps: int = 10, n_windows: int = PROFILE_WINDOWS,
                  **config) -> dict:
    """DDPM reverse steps of the flagship under `impl` (p_sample_loop's body:
    one normal draw and p_sample_step), at batch b and length l, its config
    fields replaced by `config`. Wall: the
    host clock around `steps` synchronised steps, profiler off, the median of
    three. Then `n_windows` torch.profiler windows of `steps` steps each;
    of the window with the most device events (an eager step's operations
    are fixed; a lost record only lowers the count): device events (kernels,
    memcpy, memset) per step, their busy time (the union of their
    intervals), the busy share of the first-to-last event span, and device
    time per kernel group; and each window's events per step."""
    model, _ = model_io.from_dir(model_dir, device=DEVICE, attention_impl=impl, **config)
    schedule = DiffusionSchedule.create("cosine", 1000, device=DEVICE)
    x, _, mask = denoiser_inputs(b, l)
    is_angular = torch.ones(6, dtype=torch.bool, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def run(n: int) -> None:
        y = x
        for t in range(999, 999 - n, -1):
            z = torch.randn(y.shape, generator=gen, device=DEVICE)
            y = sampling.p_sample_step(model, y, t, z, mask, schedule, is_angular)
        torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        run(3)
        walls = []
        for _ in range(3):
            start = time.perf_counter()
            run(steps)
            walls.append((time.perf_counter() - start) / steps * 1e3)
        windows = []
        for _ in range(n_windows):
            with torch.profiler.profile(activities=activities) as prof:
                run(steps)
            windows.append(sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                                  key=lambda e: e.time_range.start))
    events = max(windows, key=len)
    busy, end, groups = 0.0, -math.inf, {}
    for e in events:
        start, stop = e.time_range.start, e.time_range.end
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        ms, n = groups.get(kernel_group(e.name), (0.0, 0))
        groups[kernel_group(e.name)] = (ms + (stop - start) / 1e3 / steps, n + 1 / steps)
    span = (end - events[0].time_range.start) if events else 0.0
    return {"events": len(events) / steps, "windows": [len(w) / steps for w in windows],
            "copies": groups.get("copy", (0.0, 0))[1],
            "busy_ms": busy / 1e3 / steps, "busy_share": busy / span if span else 0.0,
            "wall_ms": statistics.median(walls), "walls": walls, "groups": groups}


def phase_profile(model_dir: str, card: str) -> dict:
    """Device operations per DDPM step under "auto" (v2 on the projections'
    views) and "pallas" (v1 on the same views, with its e_lr gather), of
    the eager step (p_sample_step, not a graph). Returns the profiles by
    (impl, B, L)."""
    profiles = {}
    for b, l in ((BATCH, 128), (15, 64)):
        for impl in ("auto", "pallas"):
            r = profiles[impl, b, l] = profile_steps(model_dir, impl, b, l)
            groups = ", ".join(f"{g} {ms:.4f} ({n:.0f})" for g, (ms, n) in
                               sorted(r["groups"].items(), key=lambda kv: -kv[1][0]))
            log(f"[5] profile DDPM step on {card}, attention_impl={impl!r} B={b} L={l}: "
                f"{r['events']:.1f} device operations per step ({r['copies']:.1f} copies; windows "
                f"{', '.join(f'{w:.1f}' for w in r['windows'])}), "
                f"busy {r['busy_ms']:.4f} ms, busy share {r['busy_share']:.4f}, "
                f"wall {r['wall_ms']:.4f} ms (profiler off; {', '.join(f'{w:.4f}' for w in r['walls'])}); "
                f"device ms (operations) per step by group: {groups}")
    auto, pallas = profiles["auto", BATCH, 128], profiles["pallas", BATCH, 128]
    if auto["events"] == 0:
        raise RuntimeError("torch.profiler recorded no device events")
    gap = pallas["events"] - auto["events"]
    log(f"[5] device operations per step at B={BATCH} L=128: auto {auto['events']:.1f}, pallas {pallas['events']:.1f}, "
        f"gap {gap:.1f} (expected 14: pallas's 12 gathers and 2 index operations; no layout copies)")
    if gap != 14:
        raise RuntimeError(f"auto runs {gap} fewer device operations per step than pallas, expected 14")
    return profiles


def phase_new_paths(model_dir: str, tmp: str, card: str) -> int:
    layers, n_chunks = FLAGSHIP.num_hidden_layers, expected_chunks()
    timesteps = FLAGSHIP_TRAIN_ARGS["timesteps"]

    # DDPM with the v1 kernel, through sampling.sample as bench.py drives it with BENCH_ATTN=pallas
    model, train_args = model_io.from_dir(model_dir, device=DEVICE, attention_impl="pallas")
    schedule = DiffusionSchedule.create(train_args["variance_schedule"], timesteps, device=DEVICE)
    empty = AnglesEmptyDataset.from_dir(model_dir)
    reset_counts()
    start = time.perf_counter()
    sampled = sampling.sample(
        model, schedule, is_angular=empty.feature_is_angular["angles"], pad=empty.pad, n=1,
        sweep_lengths=SWEEP, batch_size=BATCH, bucket_multiple=BUCKET, mean_offset=empty.get_masked_means(),
        seed=SEED,
    )
    seconds = time.perf_counter() - start
    check_launches("[6] DDPM, attention_impl='pallas'", {V2.name: 0, V1.name: layers * timesteps * n_chunks})
    v1_launches = V1.launches
    check_angles("[6] DDPM pallas", sampled)
    n = len(sampled)
    log(f"[6] DDPM pallas on {card}: {n} backbones, T={timesteps}, batch {BATCH}, bucket {BUCKET}, {n_chunks} chunks, "
        f"CUDA graphs: sampling {seconds:.3f} s, {n / seconds:.3f} backbones/s, "
        f"{seconds / (timesteps * n_chunks) * 1e3:.4f} ms per reverse step (mean over chunks)")
    del model

    for method, steps in (("ddim", 50), ("dpmpp", 20)):
        run_cli(f"[6] {method}-{steps}", model_dir, str(Path(tmp, method)),
                ["--method", method, "--ddim_steps", str(steps)],
                {V2.name: layers * steps * n_chunks, V1.name: 0}, card, steps)
    return v1_launches


TRAIN_CONFIG = REPO / "config_jsons" / "synthetic24k_full_angles_cosine.json"
CORPUS_SIZE = 384
# One train step, card against CPU (float32, other summation orders): loss
# terms within 1e-4, each gradient within 1e-3 of its tensor's largest
# element (the key biases' of the model's largest), and the parameters after the step within 1e-6 where the gradient
# clears 10x the card-CPU gradient difference (elsewhere within 2 lr: a first
# Adam step moves an element by about lr, its sign set by float noise there)
STEP_TERMS_TOL, STEP_GRAD_TOL, STEP_PARAM_TOL = 1e-4, 1e-3, 1e-6


def write_corpus(out_dir: Path, n: int) -> None:
    """n synthetic backbones (segmental helix / strand / loop angles) with
    CATH-like lengths (median ~140, most above the pad of 128), written by
    the port's NeRF."""
    out_dir.mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    for i, length in enumerate(cath_like_lengths(rng, n)):
        if not create_new_chain_nerf(str(out_dir / f"synthprot_{i:04d}.pdb"), synth_angles(rng, int(length)),
                                     EXHAUSTIVE_ANGLES):
            raise RuntimeError(f"corpus structure {i} did not build")


def train_batch(b: int, l: int, seed: int = SEED) -> dict:
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(40, l + 1, (b,), generator=g)
    return {"angles": (torch.rand(b, l, 6, generator=g) * 2 - 1) * math.pi,
            "attn_mask": (torch.arange(l)[None, :] < lengths[:, None]).float(), "lengths": lengths}


def flagship_trainer(device: str, dropout: float = 0.1, mesh=None, cuda_graphs: bool = True,
                     matmul_precision: str = FLAGSHIP.matmul_precision, **cfg) -> Trainer:
    """The flagship denoiser with seeded random weights and its trainer
    (data-parallel over `mesh`, if given; its fit() steps as CUDA graphs on
    the card unless cuda_graphs is off)."""
    config = dataclasses.replace(FLAGSHIP, hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout,
                                 remat=cfg.pop("remat", False), matmul_precision=matmul_precision)
    model = model_io.init_random(config, torch.Generator().manual_seed(SEED)).to(device)
    tcfg = TrainConfig(**{"lr": 1e-4, "batch_size": 64, "max_epochs": 800, "lr_scheduler": "LinearWarmup", **cfg})
    return Trainer(model, DiffusionSchedule.create("cosine", 1000, device=device), tcfg, steps_per_epoch=300,
                   mesh=mesh, cuda_graphs=cuda_graphs)


def phase_train_cli(tmp: str, card: str) -> str:
    """bin/train_torch.py on the flagship config: 2 epochs, then a resume for a third."""
    corpus, results = Path(tmp, "corpus"), Path(tmp, "trained")
    start = time.perf_counter()
    write_corpus(corpus, CORPUS_SIZE)
    log(f"[7] corpus: {CORPUS_SIZE} synthetic backbones written in {time.perf_counter() - start:.3f} s")
    config = {**json.loads(TRAIN_CONFIG.read_text()), "dataset_key": str(corpus), "save_state_every": 1}
    config_file = Path(tmp, "train.json")
    config_file.write_text(json.dumps(config))
    cli = load_script("train_torch")
    layers = FLAGSHIP.num_hidden_layers
    for epochs, extra in ((2, []), (3, ["--resume"])):
        reset_counts()
        start = time.perf_counter()
        rows = cli.main([str(config_file), "-o", str(results), "--epochs", str(epochs), "--device", DEVICE, "--dryrun",
                         *extra])
        wall = time.perf_counter() - start
        n_valid = len((results / "valid_files.txt").read_text().split())
        expected_epochs = list(range(epochs - len(rows), epochs))
        if [r["epoch"] for r in rows] != expected_epochs or len(rows) != (2 if not extra else 1):
            raise RuntimeError(f"[7] epochs {[r['epoch'] for r in rows]}, expected {expected_epochs}")
        # validation: one v2 launch per layer per batch; train steps launch none
        check_launches(f"[7] train_torch --epochs {epochs} {' '.join(extra)}",
                       {V2.name: layers * -(-n_valid // 64) * len(rows), V1.name: 0})
        for r in rows:
            if not all(np.isfinite(v) for k, v in r.items() if "loss" in k):
                raise RuntimeError(f"[7] non-finite loss in {r}")
            log(f"[7] epoch {r['epoch']}: step {r['step']}, train loss {r['train_loss']:.6f}, "
                f"val loss {r['val_loss']:.6f}, lr {r['lr']:.3e}, {r['epoch_seconds']:.3f} s")
        log(f"[7] bin/train_torch.py --epochs {epochs} {' '.join(extra)} on {card}: wall {wall:.3f} s with "
            f"featurization, {n_valid} validation structures")
    with open(results / "logs" / "metrics.csv", newline="") as f:
        csv_rows = list(csv.DictReader(f))
    if [int(r["epoch"]) for r in csv_rows] != [0, 1, 2]:
        raise RuntimeError(f"[7] metrics.csv epochs {[r['epoch'] for r in csv_rows]}, expected [0, 1, 2]")
    for best_by in ("valid", "train"):
        if not list((results / "models" / f"best_by_{best_by}").glob("epoch=*.ckpt")):
            raise RuntimeError(f"[7] no checkpoint under best_by_{best_by}")
    states = sorted(p.name for p in (results / "train_state").glob("*.pt"))
    log(f"[7] metrics.csv rows {len(csv_rows)}, train states {states}")
    return str(results)


def phase_step_card_vs_cpu() -> None:
    """One train step at flagship width, B = 8, dropout 0, on the card and on
    the CPU from the same weights, batch, t and noise."""
    b, l = 8, FLAGSHIP.max_position_embeddings
    batch = train_batch(b, l)
    g = torch.Generator().manual_seed(SEED + 1)
    t, noise = torch.randint(0, 1000, (b,), generator=g), (torch.rand(b, l, 6, generator=g) * 2 - 1) * math.pi
    results = {}
    for device in ("cpu", DEVICE):
        trainer = flagship_trainer(device, dropout=0.0, lr_scheduler=None, cuda_graphs=False)
        dev = {k: v.to(device) for k, v in batch.items()}
        trainer.model.train()
        terms = trainer._loss_terms(dev, t.to(device), noise.to(device))
        terms.mean().backward()
        grads = {n: p.grad.cpu() for n, p in trainer.model.named_parameters()}
        trainer.train_step(dev, t.to(device), noise.to(device))
        results[device] = (terms.detach().cpu(), grads, {n: p.detach().cpu() for n, p in
                                                        trainer.model.named_parameters()})
    check_step_card_vs_cpu(f"[7] one train step B={b} L={l}", results["cpu"], results[DEVICE], 1e-4, STEP_TERMS_TOL,
                           STEP_PARAM_TOL)


def check_step_card_vs_cpu(tag: str, ref: tuple, got: tuple, lr: float, loss_tol: float, param_atol: float,
                           param_rtol: float = 0.0, grad_tol: float | None = STEP_GRAD_TOL,
                           what: str = "card vs CPU") -> None:
    """Hold one train step on the card (got) against the CPU's (ref), or, as
    `what` says, one run against another. Each is (loss or loss terms,
    gradients, parameters after the step), all on the CPU. The gradients are
    held within grad_tol of each tensor's largest element (reported only
    when grad_tol is None). The parameters are held
    within param_atol + param_rtol |p| where the gradient clears 10x the
    card-CPU gradient difference; elsewhere within 2 lr (a first Adam step
    moves an element by about lr, its sign set by float noise there)."""
    (terms_c, grads_c, params_c), (terms_g, grads_g, params_g) = ref, got
    terms_err = (terms_g - terms_c).abs().max().item()
    # The key biases' gradients vanish in exact arithmetic (a bias on the keys
    # shifts every score of a query row alike, and softmax ignores that), so
    # they are float noise on both devices: they are held against the largest
    # gradient of the model, every other tensor against its own largest element
    top = max(g.abs().max().item() for g in grads_c.values())
    grad_errs = {n: ((grads_g[n] - grads_c[n]).abs().max()
                     / (top if n.endswith("self.key.bias") else grads_c[n].abs().max().clamp_min(1e-30))).item()
                 for n in grads_c}
    worst = max(grad_errs, key=grad_errs.get)
    grad_err = grad_errs[worst]
    param_err, param_excess, flips = 0.0, 0.0, 0
    for n, p in params_c.items():
        floor = max(1e-6, 10 * (grads_g[n] - grads_c[n]).abs().max().item())
        big = grads_c[n].abs() > floor
        diff = (params_g[n] - p).abs()
        if big.any():
            param_err = max(param_err, diff[big].max().item())
            param_excess = max(param_excess, (diff[big] - param_rtol * p[big].abs()).max().item())
        if not bool((diff[~big] <= 2 * lr).all()):
            raise RuntimeError(f"{tag}: parameter {n} moved more than 2 lr apart ({what})")
        flips += int((diff[~big] > param_atol).sum())
    log(f"{tag} {what} (dropout 0): loss max abs err {terms_err:.3e} (tol {loss_tol}), gradients max err "
        f"{grad_err:.3e} of each tensor's max ({f'tol {grad_tol}' if grad_tol else 'not gated'}; worst {worst}), "
        f"parameters after the step "
        f"max abs err {param_err:.3e} (tol {param_atol}" + (f" + {param_rtol} |p|" if param_rtol else "") +
        f"); {flips} elements below the gradient floor moved apart (within 2 lr)")
    if not (terms_err <= loss_tol and (grad_tol is None or grad_err <= grad_tol) and param_excess <= param_atol):
        raise RuntimeError(f"{tag}: the train steps disagree ({what})")


def phase_remat() -> None:
    """One train step at B = 64, L = 128 with remat off and on: the same loss
    and gradients, and the peak device memory of each."""
    batch = {k: v.to(DEVICE) for k, v in train_batch(BATCH, FLAGSHIP.max_position_embeddings).items()}
    g = torch.Generator().manual_seed(SEED + 2)
    t = torch.randint(0, 1000, (BATCH,), generator=g).to(DEVICE)
    noise = ((torch.rand(*batch["angles"].shape, generator=g) * 2 - 1) * math.pi).to(DEVICE)
    out = {}
    for remat in (False, True):
        trainer = flagship_trainer(DEVICE, remat=remat)
        trainer.model.train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        torch.manual_seed(SEED)  # the same dropout draws
        loss = trainer._loss_terms(batch, t, noise).mean()
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        out[remat] = (loss.item(), {n: p.grad for n, p in trainer.model.named_parameters()}, peak)
        del trainer, loss
    (l0, g0, m0), (l1, g1, m1) = out[False], out[True]
    grad_err = max((g0[n] - g1[n]).abs().max().item() for n in g0)
    log(f"[7] remat B={BATCH} L=128, dropout 0.1: loss {l0:.7f} without, {l1:.7f} with (diff {abs(l0 - l1):.3e}); "
        f"gradients max abs diff {grad_err:.3e}; peak memory of forward + backward above the weights "
        f"{m0 / 2**20:.1f} MiB without, {m1 / 2**20:.1f} MiB with")
    if not (abs(l0 - l1) <= 1e-6 and grad_err <= 1e-6):
        raise RuntimeError("[7] remat changes the loss or the gradients")


def train_group(chain: list, kernel: str) -> str:
    """The group of a train step's device kernel, from the names of the ops
    that launched it (innermost first) and its own name."""
    if "optimizer" in chain:
        return "optimizer"
    if any("softmax" in n.lower() or "dropout" in n.lower() for n in chain):
        return "softmax and dropout"
    low = kernel.lower()
    if any(key in low for key in ("gemm", "xmma", "cutlass", "sm80_", "sm90_")):
        if "aten::einsum" in chain or any("BmmBackward" in n for n in chain):
            return "einsum attention"
        backward = any(n.startswith("autograd::engine::evaluate_function") for n in chain)
        return "backward GEMMs" if backward else "forward GEMMs"
    return "other"


def phase_train_speed(card: str) -> None:
    """ms per train step at B = 64, L = 128 (flagship config, dropout 0.1,
    AdamW + clip), the median of 25 synchronised steps after 3 of warm-up,
    and of 5 with the pdist loss; peak memory; then a torch.profiler
    breakdown of the step without pdist."""
    batch = {k: v.to(DEVICE) for k, v in train_batch(BATCH, FLAGSHIP.max_position_embeddings).items()}
    trainers = {}
    for pdist, steps in ((0.0, 25), ((0.5, 1.0), 5)):
        trainer = trainers[bool(pdist)] = flagship_trainer(DEVICE, use_pdist_loss=pdist, cuda_graphs=False)
        reset_counts()
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(steps):
            start = time.perf_counter()
            avg, _ = trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        check_launches(f"[7] train steps (pdist {pdist})", {V2.name: 0, V1.name: 0})
        if not math.isfinite(avg.item()):
            raise RuntimeError("[7] non-finite training loss")
        ms = statistics.median(times)
        log(f"[7] train step on {card}, B={BATCH} L=128, flagship, dropout 0.1, pdist {pdist}: median {ms:.4f} ms "
            f"of {steps} (min {min(times):.4f}, max {max(times):.4f}), {BATCH / ms * 1e3:.1f} structures/s, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    n_prof = 3
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n_prof):
            trainers[False].train_step(batch)
        torch.cuda.synchronize()
    groups, attributed = {}, 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        chain, p = [], e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        for k in e.kernels:
            group = train_group(chain, k.name)
            ms_k, n = groups.get(group, (0.0, 0))
            groups[group] = (ms_k + k.duration / 1e3 / n_prof, n + 1 / n_prof)
            attributed += k.duration / 1e3 / n_prof
    device = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    busy, end = 0.0, -math.inf
    for e in device:
        busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
    span = (end - device[0].time_range.start) if device else 0.0
    total = sum(e.time_range.end - e.time_range.start for e in device) / 1e3 / n_prof
    text = ", ".join(f"{g} {ms_g:.4f} ({n:.0f})" for g, (ms_g, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]))
    log(f"[7] profile train step on {card}, B={BATCH} L=128: {len(device) / n_prof:.1f} device operations per "
        f"step, device time {total:.4f} ms ({attributed:.4f} ms attributed to ops), busy {busy / 1e3 / n_prof:.4f} "
        f"ms, busy share {busy / span if span else 0.0:.4f}; device ms (operations) per step by group: {text}")
    if not device:
        raise RuntimeError("torch.profiler recorded no device events in the train step")


@contextlib.contextmanager
def dataset_cache_in(tmp: str):
    """The dataset cache in the temporary directory while the block runs."""
    cache = os.environ.get("FOLDINGDIFF_CACHE_DIR")
    os.environ["FOLDINGDIFF_CACHE_DIR"] = tmp
    try:
        yield
    finally:
        if cache is None:
            os.environ.pop("FOLDINGDIFF_CACHE_DIR")
        else:
            os.environ["FOLDINGDIFF_CACHE_DIR"] = cache


def phase_training(tmp: str, card: str) -> str:
    with dataset_cache_in(tmp):
        trained = timed("phase 7 train CLI", phase_train_cli, tmp, card)
    timed("phase 7 step card vs CPU", phase_step_card_vs_cpu)
    timed("phase 7 remat", phase_remat)
    timed("phase 7 train speed", phase_train_speed, card)
    layers, steps = FLAGSHIP.num_hidden_layers, 50
    run_cli("[7] ddim-50 from the trained directory", trained, str(Path(tmp, "trained_ddim")),
            ["--method", "ddim", "--ddim_steps", str(steps)],
            {V2.name: layers * steps * expected_chunks(), V1.name: 0}, card, steps)
    return trained


RECON_T = 250  # bin/partial_noise_reconstruct_torch.py -t 250
RECON_TOL = 1e-3  # card against CPU through 25 reverse steps of 12 layers (float32, circular)


def check_tm(tag: str, scores) -> None:
    bad = [s for s in scores if not (math.isfinite(s) and 0 < s <= 1)]
    if bad or not scores:
        raise RuntimeError(f"{tag}: TM scores not finite in (0, 1]: {bad[:5]} of {len(scores)}")


def phase_reconstruction(tmp: str, trained: str, card: str) -> None:
    """(a) bin/partial_noise_reconstruct_torch.py over the test split of
    phase 7's corpus, from its trained directory."""
    layers = FLAGSHIP.num_hidden_layers
    out_json = Path(tmp, "reconstruction.json")
    n_test = len(Path(trained, "test_files.txt").read_text().split())
    chunks = -(-n_test // BATCH)
    reset_counts()
    start = time.perf_counter()
    result = load_script("partial_noise_reconstruct_torch").main(
        ["-m", trained, "--data", str(Path(tmp, "corpus")), "-t", str(RECON_T), "-b", str(BATCH),
         "-o", str(out_json), "--device", DEVICE])
    wall = time.perf_counter() - start
    check_launches(f"[8a] reconstruction t={RECON_T}", {V2.name: layers * RECON_T * chunks, V1.name: 0})
    payload = json.loads(out_json.read_text())
    if sorted(payload) != ["noise_timesteps", "tm_scores", "tm_scores_coords"] or payload["noise_timesteps"] != RECON_T:
        raise RuntimeError(f"[8a] JSON keys {sorted(payload)}, noise_timesteps {payload.get('noise_timesteps')}")
    scores = list(payload["tm_scores"].values())
    if len(scores) != n_test or result["n_structures"] != n_test or len(payload["tm_scores_coords"]) != n_test:
        raise RuntimeError(f"[8a] {len(scores)} TM scores, expected {n_test}")
    check_tm("[8a] tm_scores", scores)
    check_tm("[8a] tm_scores_coords", payload["tm_scores_coords"])
    if result["tm_path"] != "native":
        raise RuntimeError("[8a] the native TM-align did not build (g++ and csrc/tmalign.cpp)")
    chain = result["chain_seconds"]
    log(f"[8a] reconstruction on {card}: {n_test} test structures, t={RECON_T}, batch {BATCH}, {chunks} chunk(s) "
        f"at L={FLAGSHIP.max_position_embeddings}: reverse chains {chain:.3f} s, "
        f"{chain / (RECON_T * chunks) * 1e3:.4f} ms per reverse step; host TM scoring "
        f"({result['tm_path']} TM-align, spawned pool of {result['pool_workers']}) {result['scoring_seconds']:.3f} s; "
        f"CLI wall with loading {wall:.3f} s; TM mean {statistics.mean(scores):.4f}, "
        f"median {statistics.median(scores):.4f}, against the PDB files mean "
        f"{statistics.mean(payload['tm_scores_coords']):.4f}")


def phase_reconstruction_card_vs_cpu(tmp: str, trained: str) -> None:
    """(b) One reconstruction batch of 4 test structures at t = 25 on the
    card and on the CPU from the same x0, eps and step noise."""
    n, t = 4, 25
    train_args = json.loads(Path(trained, "training_args.json").read_text())
    ds = dsets.DATASET_CLASSES[train_args["angles_definitions"]](
        pdbs=str(Path(tmp, "corpus")), split="test", pad=train_args["max_seq_len"],
        min_length=train_args["min_seq_len"], trim_strategy=train_args["trim_strategy"])
    offset = np.load(Path(trained, "training_mean_offset.npy"))
    ds.set_masked_means(offset)
    data = {k: v[:n] for k, v in ds.to_arrays().items()}
    is_angular = ds.feature_is_angular["angles"]
    g = torch.Generator().manual_seed(SEED + 3)
    eps = sample_wrapped_noise(g, tuple(data["angles"].shape), is_angular)
    step_noise = torch.randn((t, *data["angles"].shape), generator=g)
    out, seconds = {}, {}
    for device in ("cpu", DEVICE):
        model, _ = model_io.from_dir(trained, device=device)
        schedule = DiffusionSchedule.create(train_args["variance_schedule"], train_args["timesteps"], device=device)
        reset_counts()
        start = time.perf_counter()
        out[device] = sampling.reconstruct_batch(
            model, schedule, data["angles"], data["attn_mask"], data["lengths"], eps.to(device),
            is_angular=is_angular, noise_timesteps=t, step_noise=step_noise.to(device), mean_offset=offset)
        seconds[device] = time.perf_counter() - start
        layers = FLAGSHIP.num_hidden_layers
        check_launches(f"[8b] reconstruction batch on {device}", {V2.name: layers * t if device == DEVICE else 0,
                                                                   V1.name: 0})
    err = max(float(np.abs((a - b + np.pi) % (2 * np.pi) - np.pi).max()) for a, b in zip(out["cpu"], out[DEVICE]))
    log(f"[8b] reconstruction of {n} test structures (lengths {data['lengths'].tolist()}), t={t}, card vs CPU from "
        f"the same x0, eps and step noise: max circular abs err {err:.3e} (tol {RECON_TOL}); "
        f"{seconds['cpu']:.3f} s on the CPU, {seconds[DEVICE]:.3f} s on the card")
    if not err <= RECON_TOL:
        raise RuntimeError(f"[8b] card and CPU reconstructions differ by {err} > {RECON_TOL}")


def phase_history(model_dir: str, tmp: str, card: str) -> None:
    """(c) DDIM-50 with --fullhistory over the sweep."""
    steps, out_dir = 50, Path(tmp, "history")
    run_cli("[8c] ddim-50 --fullhistory", model_dir, str(out_dir),
            ["--method", "ddim", "--ddim_steps", str(steps), "--fullhistory"],
            {V2.name: FLAGSHIP.num_hidden_layers * steps * expected_chunks(), V1.name: 0}, card, steps)
    angles = out_dir / "sampled_angles"
    n = len(range(*SWEEP))
    for i in range(n):
        sub = angles / "sample_history" / f"generated_{i}"
        files = sorted(p.name for p in sub.iterdir())
        if files != sorted(f"timestep_{t}.csv.gz" for t in range(steps)):
            raise RuntimeError(f"[8c] generated_{i}: {len(files)} history files, expected {steps}")
        with gzip.open(sub / f"timestep_{steps - 1}.csv.gz", "rb") as a, \
                gzip.open(angles / f"generated_{i}.csv.gz", "rb") as b:
            if a.read() != b.read():
                raise RuntimeError(f"[8c] generated_{i}: the last history entry is not the final CSV")
    if not (out_dir / "model_snapshot" / "training_args.json").is_file():
        raise RuntimeError("[8c] no model_snapshot/")
    log(f"[8c] history: {n} x {steps} CSVs, each last one equal to its final CSV; model_snapshot/ written")


CART_CONFIG = REPO / "config_jsons" / "synthetic_raw_coordinates.json"
CART_LENGTHS = (50, 60)


def phase_cart_coords(tmp: str, card: str) -> None:
    """(d) DDPM T = 1000 from a cart-coords model with seeded random weights,
    to CA-trace PDBs."""
    train_args = json.loads(CART_CONFIG.read_text())
    config = ModelConfig.from_train_args(train_args)
    model_dir, out_dir = str(Path(tmp, "cart")), str(Path(tmp, "cart_sampled"))
    weights = model_io.init_random(config, torch.Generator().manual_seed(SEED))
    model_io.save_model_dir(model_dir, config, weights.state_dict(), train_args)
    del weights
    n = CART_LENGTHS[1] - CART_LENGTHS[0]
    chunks = -(-n // BATCH)
    reset_counts()
    start = time.perf_counter()
    result = load_script("sample_torch").main(
        ["-m", model_dir, "-o", out_dir, "-n", "1", "-l", *map(str, CART_LENGTHS), "-b", str(BATCH),
         "--seed", str(SEED), "--device", DEVICE, "--noplot"])
    wall = time.perf_counter() - start
    check_launches("[8d] cart-coords DDPM", {V2.name: config.num_hidden_layers * train_args["timesteps"] * chunks,
                                             V1.name: 0})
    written, skipped = result["pdb_files"], result["pdb_skipped"]
    if len(written) + len(skipped) != n or result["n_structures"] != n:
        raise RuntimeError(f"[8d] {len(written)} CA traces written and {len(skipped)} skipped, expected {n} in all")
    for path in written:
        lines = Path(path).read_text().splitlines()
        i = int(Path(path).stem.split("_")[1])
        if sum(line.startswith("ATOM") and line[12:16] == " CA " for line in lines) != CART_LENGTHS[0] + i:
            raise RuntimeError(f"[8d] {path}: not a CA trace of {CART_LENGTHS[0] + i} residues")
    log(f"[8d] cart-coords ({config.num_hidden_layers} x {config.hidden_size}, F={config.n_inputs}, "
        f"T={train_args['timesteps']} {train_args['variance_schedule']}) on {card}: {n} structures, "
        f"{len(written)} CA-trace PDBs written, {len(skipped)} skipped by the 1000 A guard; sampling "
        f"{result['sampling_seconds']:.3f} s, CLI wall {wall:.3f} s")


def phase_debug_training(tmp: str, card: str) -> None:
    """(e) bin/train_torch.py --debug_single_time, 1 epoch, then ms per
    pre-corrupted step."""
    config = {**json.loads(TRAIN_CONFIG.read_text()), "dataset_key": str(Path(tmp, "corpus"))}
    config_file = Path(tmp, "debug.json")
    config_file.write_text(json.dumps(config))
    reset_counts()
    start = time.perf_counter()
    with dataset_cache_in(tmp):
        rows = load_script("train_torch").main(
            [str(config_file), "-o", str(Path(tmp, "debug")), "--epochs", "1", "--debug_single_time",
             "--device", DEVICE, "--dryrun"])
    wall = time.perf_counter() - start
    check_launches("[8e] train_torch --debug_single_time", {V2.name: 0, V1.name: 0})
    if len(rows) != 1 or not math.isfinite(rows[0]["train_loss"]):
        raise RuntimeError(f"[8e] debug rows {rows}")

    one = dict(ft_is_angular=(True,), ft_names=("phi",))  # the debug model: one feature
    model = model_io.init_random(dataclasses.replace(FLAGSHIP, **one), torch.Generator().manual_seed(SEED))
    trainer = Trainer(model.to(DEVICE), DiffusionSchedule.create("cosine", 1000, device=DEVICE),
                      TrainConfig(lr=1e-4, batch_size=BATCH, max_epochs=1, lr_scheduler=None), steps_per_epoch=1)
    clean = train_batch(BATCH, FLAGSHIP.max_position_embeddings)
    g = torch.Generator().manual_seed(SEED + 4)
    batch = {"corrupted": clean["angles"][..., :1], "t": torch.full((BATCH, 1), 100),
             "known_noise": torch.randn(BATCH, FLAGSHIP.max_position_embeddings, 1, generator=g),
             "attn_mask": clean["attn_mask"]}
    batch = {k: v.to(DEVICE) for k, v in batch.items()}
    for _ in range(3):
        trainer.train_step_precorrupted(batch)
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        start = time.perf_counter()
        avg, _ = trainer.train_step_precorrupted(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    check_launches("[8e] pre-corrupted steps", {V2.name: 0, V1.name: 0})
    if not math.isfinite(avg.item()):
        raise RuntimeError("[8e] non-finite pre-corrupted loss")
    log(f"[8e] train_torch --debug_single_time on {card}: 1 epoch, train loss {rows[0]['train_loss']:.6f}, wall "
        f"{wall:.3f} s with featurization; pre-corrupted step B={BATCH} L=128 F=1, flagship, dropout 0.1: median "
        f"{statistics.median(times):.4f} ms of 10 (min {min(times):.4f}, max {max(times):.4f})")


def phase_surface(tmp: str, model_dir: str, trained: str, card: str) -> None:
    with dataset_cache_in(tmp):
        timed("phase 8 reconstruction", phase_reconstruction, tmp, trained, card)
        timed("phase 8 reconstruction card vs CPU", phase_reconstruction_card_vs_cpu, tmp, trained)
    timed("phase 8 history", phase_history, model_dir, tmp, card)
    timed("phase 8 Cartesian coordinates", phase_cart_coords, tmp, card)
    timed("phase 8 debug training", phase_debug_training, tmp, card)


AR_CONFIG = REPO / "config_jsons" / "synthetic_full_angles_cosine.json"  # the AR baseline's training config
AR_DEFAULTS: dict = {}  # bin/train_autoregressive_torch.py's config when none is given: 12 x 384, `absolute`
AR_NUM, AR_NUMSEED = 64, 4  # bin/sample_autoregressive_torch.py -n 64 --numseed 4
AR_CHAIN_LENGTHS = (44, 52, 60, 68)  # (e): the chains held card against CPU (64 forwards on each)
AR_STEP_LOSS_TOL, AR_STEP_PARAM_TOL, AR_STEP_PARAM_RTOL = 1e-6, 1e-4, 1e-3
AR_CHAIN_TOL = 1e-3  # card against CPU through 64 greedy steps of 12 layers (float32, circular)
FT_NAMES = ("phi", "psi", "omega", "tau", "CA:C:1N", "C:1N:1CA")  # canonical-full-angles


def circular_err(a, b) -> float:
    return float(np.abs((np.asarray(a) - np.asarray(b) + np.pi) % (2 * np.pi) - np.pi).max())


def ar_forward_inputs(b: int, l: int, prefix: int):
    g = torch.Generator(device=DEVICE).manual_seed(SEED + prefix)
    x = (torch.rand(b, l, 6, generator=g, device=DEVICE) * 2 - 1) * math.pi
    lengths = torch.randint(40, 2 * l, (b,), generator=g, device=DEVICE)
    mask = (torch.arange(l, device=DEVICE) < prefix).float().expand(b, l)
    return x, mask, lengths


def phase_ar_train(tmp: str, card: str) -> tuple[str, int]:
    """(a) bin/train_autoregressive_torch.py on the AR config for 2 epochs,
    then ms per AR train step at B = 64, L = 128. Returns (the trained
    directory, its v2 launches)."""
    results = Path(tmp, "ar_trained")
    layers = FLAGSHIP.num_hidden_layers
    reset_counts()
    start = time.perf_counter()
    rows = load_script("train_autoregressive_torch").main(
        [str(AR_CONFIG), "--dataset", str(Path(tmp, "corpus")), "--epochs", "2", "-o", str(results),
         "--device", DEVICE])
    wall = time.perf_counter() - start
    n_valid = len(dsets.DATASET_CLASSES["canonical-full-angles"](
        pdbs=str(Path(tmp, "corpus")), split="validation", pad=128, min_length=40, trim_strategy="randomcrop"))
    valid_batches = len(ARTrainer._starts(n_valid, 64))
    # validation: one v2 launch per layer per batch; train steps launch none
    check_launches("[9a] train_autoregressive_torch --epochs 2", {V2.name: layers * valid_batches * 2, V1.name: 0})
    launches = V2.launches
    if V2.rel_off_launches:
        raise RuntimeError("[9a] a relative_key AR model launched the rel-off instance")
    if [r["epoch"] for r in rows] != [0, 1] or not all(math.isfinite(r[k]) for r in rows
                                                      for k in ("train_loss", "val_loss")):
        raise RuntimeError(f"[9a] rows {rows}")
    with open(results / "logs" / "metrics.csv", newline="") as f:
        if len(list(csv.DictReader(f))) != 2:
            raise RuntimeError("[9a] metrics.csv does not hold 2 rows")
    ckpts = sorted(p.name for p in (results / "models" / "best_by_valid").glob("epoch=*.ckpt"))
    if not ckpts:
        raise RuntimeError("[9a] no checkpoint under best_by_valid")
    for r in rows:
        log(f"[9a] epoch {r['epoch']}: step {r['step']}, train loss {r['train_loss']:.6f}, "
            f"val loss {r['val_loss']:.6f}, {r['epoch_seconds']:.3f} s")
    log(f"[9a] bin/train_autoregressive_torch.py --epochs 2 on {card}: wall {wall:.3f} s, {n_valid} validation "
        f"structures in {valid_batches} batch(es), checkpoints {ckpts}")

    model, _ = model_io.from_dir(str(results), device=DEVICE, model_cls=BertForAutoregressive)
    trainer = ARTrainer(model, TrainConfig(lr=1e-4, batch_size=BATCH, max_epochs=800), steps_per_epoch=300)
    batch = {k: v.to(DEVICE) for k, v in train_batch(BATCH, FLAGSHIP.max_position_embeddings).items()}
    reset_counts()
    for _ in range(3):
        trainer.train_step(batch)
    times = []
    for _ in range(25):
        torch.cuda.synchronize()
        start = time.perf_counter()
        loss = trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    check_launches("[9a] AR train steps", {V2.name: 0, V1.name: 0})
    if not math.isfinite(loss.item()):
        raise RuntimeError("[9a] non-finite AR training loss")
    ms = statistics.median(times)
    log(f"[9a] AR train step on {card}, B={BATCH} L=128, 12 x 384 relative_key, dropout 0.1: median {ms:.4f} ms of 25 "
        f"(min {min(times):.4f}, max {max(times):.4f}), {BATCH / ms * 1e3:.1f} structures/s")
    return str(results), launches


def phase_ar_step_card_vs_cpu(trained: str) -> None:
    """(b) One AR train step at B = 8, dropout 0, causal lengths injected, on
    the card and on the CPU from the same weights and batch."""
    b, l = 8, FLAGSHIP.max_position_embeddings
    batch = train_batch(b, l)
    causal = (1 + torch.rand(b, generator=torch.Generator().manual_seed(SEED + 5)) * (batch["lengths"] - 1)).long()
    lr = 1e-4
    results = {}
    for device in ("cpu", DEVICE):
        model, _ = model_io.from_dir(trained, device=device, model_cls=BertForAutoregressive,
                                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        trainer = ARTrainer(model, TrainConfig(lr=lr, batch_size=b, max_epochs=1, lr_scheduler=None), 1)
        dev = {k: v.to(device) for k, v in batch.items()}
        model.train()
        loss = trainer._loss(dev, causal)
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        trainer.train_step(dev, causal)
        results[device] = (loss.detach().cpu(), grads, {n: p.detach().cpu() for n, p in model.named_parameters()})
    # Gated on the loss and the parameters after the step; the gradients are
    # reported: the AR loss reads one row per item, so the last layers'
    # gradients come from 8 rows alone, and on an H100 they differed from the
    # CPU's by 1.5e-3 of their largest element (float32 summation orders)
    check_step_card_vs_cpu(f"[9b] one AR train step B={b} L={l}", results["cpu"], results[DEVICE], lr,
                           AR_STEP_LOSS_TOL, AR_STEP_PARAM_TOL, AR_STEP_PARAM_RTOL, grad_tol=None)


def run_ar_sampling(tag: str, model_dir: str, tmp: str, out: str, card: str) -> tuple[dict, int]:
    """bin/sample_autoregressive_torch.py -n 64 --numseed 4 over the corpus;
    checks the angles, the PDBs and 12 v2 launches per forward. Returns (the
    CLI's result, the v2 launches)."""
    reset_counts()
    start = time.perf_counter()
    result = load_script("sample_autoregressive_torch").main(
        ["-m", model_dir, "--data", str(Path(tmp, "corpus")), "-n", str(AR_NUM), "--numseed", str(AR_NUMSEED),
         "-o", out, "--seed", str(SEED), "--device", DEVICE])
    wall = time.perf_counter() - start
    forwards = max(result["lengths"]) - AR_NUMSEED
    check_launches(tag, {V2.name: FLAGSHIP.num_hidden_layers * forwards, V1.name: 0})
    launches = V2.launches
    for i, (angles, length) in enumerate(zip(result["angles"], result["lengths"])):
        if angles.shape != (min(length, 128), 6) or not np.all(np.isfinite(angles)) \
                or angles.min() < -np.pi or angles.max() >= np.pi:
            raise RuntimeError(f"{tag} ar_generated_{i}: shape {angles.shape} or angles not finite in [-pi, pi)")
    if len(result["pdb_files"]) != AR_NUM:
        raise RuntimeError(f"{tag}: {len(result['pdb_files'])} PDBs written, expected {AR_NUM}")
    seconds = result["generation_seconds"]
    log(f"{tag} on {card}: {AR_NUM} chains, max length {max(result['lengths'])}, {forwards} forwards at B={AR_NUM} "
        f"L=128: generation {seconds:.3f} s, {seconds / forwards * 1e3:.4f} ms per forward; CLI wall with loading "
        f"and PDB writing {wall:.3f} s")
    return result, launches


def ar_profile(model, card: str, tag: str, forwards: int = 5) -> None:
    """Device operations and busy time per AR forward at B = 64, L = 128, from
    a torch.profiler window of a few forwards."""
    x, mask, lengths = ar_forward_inputs(AR_NUM, 128, 100)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        model(x, mask, lengths)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(forwards):
                model(x, mask, lengths)
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        raise RuntimeError(f"{tag}: torch.profiler recorded no device events")
    busy, end, attn = 0.0, -math.inf, 0.0
    for e in events:
        busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
        if kernel_group(e.name) == "attention v2":
            attn += (e.time_range.end - e.time_range.start) / 1e3
    log(f"{tag} profile one AR forward on {card}, B={AR_NUM} L=128: {len(events) / forwards:.1f} device operations, "
        f"busy {busy / 1e3 / forwards:.4f} ms, attention kernel {attn / forwards:.4f} ms")


def phase_ar_absolute(tmp: str, trained: str, card: str) -> tuple[str, int]:
    """(d) A seeded random AR directory at bin/train_autoregressive_torch.py's
    defaults (12 x 384, `absolute`) through the same CLI: only the rel-off
    instance, 12 per forward; then one forward under "auto" against "plain"
    with prefixes of 4 and 100 keys, and both AR models timed."""
    cli = load_script("train_autoregressive_torch")
    config = cli.model_config_from(AR_DEFAULTS, (True,) * len(FT_NAMES), FT_NAMES)
    model_dir = str(Path(tmp, "ar_absolute"))
    weights = model_io.init_random(config, torch.Generator().manual_seed(SEED), model_cls=BertForAutoregressive)
    mean_offset = np.load(Path(trained, "training_mean_offset.npy"))
    model_io.save_model_dir(model_dir, config, weights.state_dict(), cli.train_args_for(AR_DEFAULTS, config),
                            mean_offset)
    del weights
    result, launches = run_ar_sampling("[9d] absolute AR sampling", model_dir, tmp, str(Path(tmp, "ar_abs_sampled")),
                                       card)
    if V2.rel_off_launches != launches:
        raise RuntimeError(f"[9d] {launches} v2 launches, of them {V2.rel_off_launches} rel-off: expected only rel-off")
    log(f"[9d] v2 rel-off instance launches (the `absolute` AR path): {V2.rel_off_launches}")

    layers = config.num_hidden_layers
    models = {}
    for name, path in (("relative_key", trained), ("absolute", model_dir)):
        models[name] = {impl: model_io.from_dir(path, device=DEVICE, model_cls=BertForAutoregressive,
                                                attention_impl=impl)[0] for impl in ("auto", "plain")}
    with torch.inference_mode():
        for prefix in (AR_NUMSEED, 100):
            x, mask, lengths = ar_forward_inputs(AR_NUM, 128, prefix)
            for name, pair in models.items():
                reset_counts()
                out = pair["auto"](x, mask, lengths)
                check_launches(f"[9d] {name} AR forward, prefix {prefix}", {V2.name: layers, V1.name: 0})
                if V2.rel_off_launches != (layers if name == "absolute" else 0):
                    raise RuntimeError(f"[9d] {name}: {V2.rel_off_launches} rel-off launches")
                err = (out - pair["plain"](x, mask, lengths)).abs().max().item()
                log(f"[9d] {name} AR forward B={AR_NUM} L=128, prefix {prefix} keys, auto vs plain: "
                    f"max abs err {err:.3e} (tol {DENOISER_TOL})")
                if not err <= DENOISER_TOL:
                    raise RuntimeError(f"[9d] {name} AR forward disagrees with plain: {err} > {DENOISER_TOL}")
        x, mask, lengths = ar_forward_inputs(AR_NUM, 128, 100)
        for name, pair in models.items():
            plain_ms, kernel_ms = alternate_ms(lambda: pair["plain"](x, mask, lengths),
                                               lambda: pair["auto"](x, mask, lengths), iters=20)
            log(f"[9d] time one {name} AR forward on {card}, B={AR_NUM} L=128: auto {kernel_ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms")
        for name, pair in models.items():
            ar_profile(pair["auto"], card, f"[9d] {name}")
    return model_dir, launches


def phase_ar_chain_card_vs_cpu(tmp: str, trained: str) -> None:
    """(e) ar_sample of 4 chains on the card and on the CPU from the same seeds."""
    train_args = json.loads(Path(trained, "training_args.json").read_text())
    ds = dsets.DATASET_CLASSES[train_args["angles_definitions"]](
        pdbs=str(Path(tmp, "corpus")), split="test", pad=128, min_length=40, trim_strategy="randomcrop")
    ds.set_masked_means(np.load(Path(trained, "training_mean_offset.npy")))
    seeds = np.zeros((len(AR_CHAIN_LENGTHS), 128, 6), np.float32)
    seeds[:, :AR_NUMSEED] = np.stack([ds[i]["angles"][:AR_NUMSEED] for i in range(len(AR_CHAIN_LENGTHS))])
    lengths = torch.tensor(AR_CHAIN_LENGTHS)
    out, seconds = {}, {}
    for device in ("cpu", DEVICE):
        model, _ = model_io.from_dir(trained, device=device, model_cls=BertForAutoregressive)
        start = time.perf_counter()
        out[device] = ar_sample(model, torch.from_numpy(seeds).to(device), lengths.to(device),
                                num_seed=AR_NUMSEED).cpu().numpy()
        seconds[device] = time.perf_counter() - start
    err = max(circular_err(out["cpu"][i, :n], out[DEVICE][i, :n]) for i, n in enumerate(AR_CHAIN_LENGTHS))
    log(f"[9e] ar_sample of {len(AR_CHAIN_LENGTHS)} chains (lengths {list(AR_CHAIN_LENGTHS)}), card vs CPU from the "
        f"same seeds: max circular abs err {err:.3e} (tol {AR_CHAIN_TOL}); {seconds['cpu']:.3f} s on the CPU, "
        f"{seconds[DEVICE]:.3f} s on the card")
    if not err <= AR_CHAIN_TOL:
        raise RuntimeError(f"[9e] card and CPU chains differ by {err} > {AR_CHAIN_TOL}")


def set_statistics(angles: list, pdbs: list, ref: np.ndarray) -> str:
    """The KS max statistic over the features against the reference angles,
    and the mean P-SEA helix and strand elements and clashes of the PDBs."""
    ks = kl.ks_feature_tests(np.concatenate(angles), ref, FT_NAMES)
    worst = max(ks, key=lambda k: ks[k]["stat"])
    counts = np.array([ss.count_structures_in_pdb(f) for f in pdbs])
    n_clash = [clashes.count_clashes(f) for f in pdbs]
    return (f"KS max statistic {ks[worst]['stat']:.4f} ({worst}), mean helices {counts[:, 0].mean():.3f}, "
            f"mean strands {counts[:, 1].mean():.3f}, mean clashes {statistics.mean(n_clash):.3f}")


def phase_baselines(tmp: str, trained: str, ar_result: dict, card: str) -> None:
    """(f) bin/sample_random_angles_torch.py -n 64, then the statistics of
    (c)'s and (f)'s sets against the test split."""
    start = time.perf_counter()
    rand = load_script("sample_random_angles_torch").main(
        ["-m", trained, "--data", str(Path(tmp, "corpus")), "-n", str(AR_NUM), "-o", str(Path(tmp, "random")),
         "--seed", str(SEED), "--device", DEVICE])
    wall = time.perf_counter() - start
    if len(rand["angles"]) != AR_NUM or not rand["pdb_files"]:
        raise RuntimeError(f"[9f] random angles: {len(rand['angles'])} sets, {len(rand['pdb_files'])} PDBs")
    test = dsets.DATASET_CLASSES["canonical-full-angles"](
        pdbs=str(Path(tmp, "corpus")), split="test", pad=128, min_length=40, trim_strategy="randomcrop",
        zero_center=False)
    ref = np.concatenate([it["angles"][: int(it["lengths"])] for it in (test[i] for i in range(len(test)))])
    start = time.perf_counter()
    lines = {"AR (2 epochs)": set_statistics(ar_result["angles"], ar_result["pdb_files"], ref),
             "random angles": set_statistics(rand["angles"], rand["pdb_files"], ref),
             "test split": set_statistics([ref], test.filenames, ref)}
    seconds = time.perf_counter() - start
    log(f"[9f] bin/sample_random_angles_torch.py -n {AR_NUM} on {card}: {len(rand['pdb_files'])} PDBs, "
        f"wall {wall:.3f} s")
    for name, text in lines.items():
        log(f"[9f] {name} against the test split ({len(test)} structures): {text}")
    log(f"[9f] the statistics of the three sets took {seconds:.3f} s on the host")


def phase_baseline_models(tmp: str, card: str) -> int:
    """Phase 9 on phase 7's corpus. Returns its v2 launches."""
    with dataset_cache_in(tmp):
        trained, launches = phase_ar_train(tmp, card)
        phase_ar_step_card_vs_cpu(trained)
        ar_result, sampled = run_ar_sampling("[9c] AR sampling", trained, tmp, str(Path(tmp, "ar_sampled")), card)
        model, _ = model_io.from_dir(trained, device=DEVICE, model_cls=BertForAutoregressive)
        ar_profile(model, card, "[9c]")
        del model
        _, rel_off = phase_ar_absolute(tmp, trained, card)
        phase_ar_chain_card_vs_cpu(tmp, trained)
        phase_baselines(tmp, trained, ar_result, card)
    log(f"[9] v2 launches on the baselines' paths: {launches + sampled} rel ((a) validation and (c) sampling), "
        f"{rel_off} rel-off ((d) sampling)")
    return launches + sampled + rel_off


MP_RANKS = 2  # ranks that share the card through gloo (NCCL refuses two ranks on one device)
MP_TIMEOUT = 600  # seconds for a launch of ranks
MP_STEP_LOSS_TOL, MP_STEP_PARAM_TOL, MP_STEP_PARAM_RTOL = 1e-5, 1e-4, 1e-3  # (a): 2 ranks against 1 process
MP_TIMED_STEPS = 10


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_ranks(tag: str, argvs: list, env: dict | None = None) -> list:
    """Start one process per argv (python arguments) together, from the
    repository's root, and wait for all; raises if any fails or outlasts
    MP_TIMEOUT, after stopping the others. Returns their standard outputs."""
    procs = [subprocess.Popen([sys.executable, *argv], cwd=REPO, env={**os.environ, **(env or {})},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for argv in argvs]
    try:
        outs = [p.communicate(timeout=MP_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{tag}: process {i} exited with {p.returncode}:\n{err[-4000:]}")
    return [o for o, _ in outs]


def mp_step_inputs(b: int, seed: int):
    """A ragged batch (lengths 40..128) with its t and noise, on the card."""
    batch = {k: v.to(DEVICE) for k, v in train_batch(b, FLAGSHIP.max_position_embeddings, seed).items()}
    g = torch.Generator().manual_seed(seed + 1)
    t = torch.randint(0, 1000, (b,), generator=g)
    noise = (torch.rand(*batch["angles"].shape, generator=g) * 2 - 1) * math.pi
    return batch, t.to(DEVICE), noise.to(DEVICE)


def step_result(trainer, avg, tp_mesh=None) -> tuple:
    """(loss, gradients, parameters) after a train step, on the CPU, the
    tensor-parallel shards gathered."""
    def full(name, t):
        return (t if tp_mesh is None else tp.unshard(t, tp.spec_for(name), tp_mesh.model)).detach().cpu()

    named = list(trainer.model.named_parameters())
    return avg.cpu(), {n: full(n, p.grad) for n, p in named}, {n: full(n, p) for n, p in named}


def phase10_rank(argv: list) -> None:
    """One rank of phase 10 (started by the parallel.multihost worker, gloo,
    on the card): (a) a data-parallel flagship train step at B = 64 on
    injected t and noise, then ms per step; (b) bin/sample_torch.py's main()
    over the sweep, sharded; (d) the flagship forward under a (1, 2) TP mesh,
    then one TP train step at B = 8. Writes its counts and times to
    <tmp>/phase10_rank<r>.json and, on rank 0, the results to compare to
    <tmp>/phase10_rank0.pt. argv: tmp, the flagship directory."""
    tmp, model_dir = Path(argv[0]), argv[1]
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.fp32_precision = "ieee"
    mesh = make_mesh()
    rank, report, results = mesh.rank, {}, {}

    trainer = flagship_trainer(DEVICE, dropout=0.0, mesh=mesh, lr_scheduler=None)
    V2.launches = 0
    avg, _ = trainer.train_step(*mp_step_inputs(BATCH, SEED + 20))
    results["a"] = step_result(trainer, avg)
    report["a_launches"] = V2.launches
    timed = flagship_trainer(DEVICE, mesh=mesh)  # dropout 0.1, the trainer's own draws
    batch = mp_step_inputs(BATCH, SEED + 20)[0]
    times = []
    for i in range(3 + MP_TIMED_STEPS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        timed.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    report["a_ms"] = times[3:]
    del trainer, timed

    reset_counts()
    argv_b = ["-m", model_dir, "-o", str(tmp / "mp_sampled"), "-n", "1", "-l", str(SWEEP[0]), str(SWEEP[1]),
              "-b", str(BATCH), "--seed", str(SEED), "--device", DEVICE, "--noplot"]
    report["b"] = {k: v for k, v in load_script("sample_torch").main(argv_b).items() if k != "pdb_files"}
    report["b_launches"] = {V2.name: V2.launches, V1.name: V1.launches}

    tp_mesh = tp.make_mesh_2d(1, MP_RANKS)
    heads = []
    launch = models_bert.fused_attention_v2

    def counted(q, *args, **kwargs):  # the head count of each v2 launch of the TP forward
        heads.append(q.shape[1])
        return launch(q, *args, **kwargs)

    model = model_io.init_random(FLAGSHIP, torch.Generator().manual_seed(SEED)).to(DEVICE)
    runner = tp.TPRunner(model, tp_mesh)
    models_bert.fused_attention_v2 = counted
    V2.launches = 0
    try:
        results["d_forward"] = runner(*denoiser_inputs(BATCH, FLAGSHIP.max_position_embeddings)).cpu()
    finally:
        models_bert.fused_attention_v2 = launch
    report["d_launches"], report["d_heads"] = V2.launches, sorted(set(heads))
    trainer = tp.shard_train_state(flagship_trainer(DEVICE, dropout=0.0, lr_scheduler=None), tp_mesh)
    avg, _ = tp.tp_train_step(trainer, *mp_step_inputs(8, SEED + 21))
    results["d_step"] = step_result(trainer, avg, tp_mesh)
    if rank == 0:
        torch.save(results, tmp / "phase10_rank0.pt")
    (tmp / f"phase10_rank{rank}.json").write_text(json.dumps(report))


def phase10_nccl_cli(tmp: str) -> list:
    """(c) bin/train_torch.py --multihost as one NCCL rank for 1 epoch on
    phase 7's config and corpus, then --resume for a second. Returns its log
    lines."""
    lines, results_dir = [], Path(tmp, "mp_trained")
    for epochs, extra in ((1, []), (2, ["--resume"])):
        start = time.perf_counter()
        launch_ranks("[10c] NCCL rank", [["bin/train_torch.py", str(Path(tmp, "train.json")), "-o", str(results_dir),
                                          "--epochs", str(epochs), "--dryrun", "--multihost", "--coordinator",
                                          f"localhost:{free_port()}", "--nprocs", "1", "--procid", "0", *extra]],
                     env={"FOLDINGDIFF_CACHE_DIR": tmp})
        lines.append(f"[10c] bin/train_torch.py --multihost (1 NCCL rank) --epochs {epochs} {' '.join(extra)}: "
                     f"wall {time.perf_counter() - start:.3f} s with the process's start")
    with open(results_dir / "logs" / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    if [int(r["epoch"]) for r in rows] != [0, 1] or not all(
            math.isfinite(float(v)) for r in rows for k, v in r.items() if "loss" in k):
        raise RuntimeError(f"[10c] metrics.csv rows {rows}")
    return lines + [f"[10c] metrics.csv: epochs 0, 1; train loss {float(rows[-1]['train_loss']):.6f}, val loss "
                    f"{float(rows[-1]['val_loss']):.6f}"]


def phase10_reference_step(b: int, seed: int) -> tuple:
    """The one-process train step of phase 10's (a) and (d) on the card."""
    trainer = flagship_trainer(DEVICE, dropout=0.0, lr_scheduler=None)
    avg, _ = trainer.train_step(*mp_step_inputs(b, seed))
    return step_result(trainer, avg)


def phase_multiprocess(tmp: str, model_dir: str, card: str) -> int:
    """Phase 10: N ranks held equal to one rank. (a), (b) and (d) run in one
    launch of 2 gloo ranks sharing the card (phase10_rank); (c) runs beside
    the checks of their results, which time nothing. Returns the v2
    launches of (b) and (d)."""
    port = free_port()
    start = time.perf_counter()
    launch_ranks("[10] 2 gloo ranks", [
        ["-m", "foldingdiff_tpu_torch.parallel.multihost", "--coordinator", f"localhost:{port}", "--nprocs",
         str(MP_RANKS), "--procid", str(r), "--backend", "gloo", "--device", "cuda", "chip_smoke:phase10_rank", tmp,
         model_dir] for r in range(MP_RANKS)])
    log(f"[10] {MP_RANKS} gloo ranks on {card} (one card): (a), (b), (d) in {time.perf_counter() - start:.3f} s "
        f"with the processes' start")
    reports = [json.loads(Path(tmp, f"phase10_rank{r}.json").read_text()) for r in range(MP_RANKS)]
    results = torch.load(Path(tmp, "phase10_rank0.pt"), weights_only=False)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        nccl = pool.submit(phase10_nccl_cli, tmp)
        launches = phase10_checks(tmp, model_dir, card, reports, results)
        for line in nccl.result():
            log(line)
    return launches


def phase10_checks(tmp: str, model_dir: str, card: str, reports: list, results: dict) -> int:
    """(a), (b) and (d) of phase 10 against one process; returns their v2 launches."""
    # (a) the DP step against one process
    ref = phase10_reference_step(BATCH, SEED + 20)
    check_step_card_vs_cpu(f"[10a] one DP train step B={BATCH} L=128, ragged", ref, results["a"], 1e-4,
                           MP_STEP_LOSS_TOL, MP_STEP_PARAM_TOL, MP_STEP_PARAM_RTOL, grad_tol=None,
                           what=f"{MP_RANKS} ranks vs 1 process")
    for r, rep in enumerate(reports):
        if rep["a_launches"] != 0:
            raise RuntimeError(f"[10a] rank {r}: {rep['a_launches']} v2 launches in a train step")
        ms = statistics.median(rep["a_ms"])
        log(f"[10a] rank {r} on {card}: DP train step B={BATCH} (B={BATCH // MP_RANKS} per rank) L=128, dropout 0.1, "
            f"gloo gradient all-reduce: median {ms:.4f} ms of {MP_TIMED_STEPS} (min {min(rep['a_ms']):.4f}, max "
            f"{max(rep['a_ms']):.4f}), {BATCH / ms * 1e3:.1f} structures/s over the {MP_RANKS} ranks")

    # (b) the sharded sweep: rank 0's CSVs against one process at the ranks'
    # batch shapes, and against phase 5's one process
    n = len(range(*SWEEP))
    want_launches = {V2.name: FLAGSHIP.num_hidden_layers * FLAGSHIP_TRAIN_ARGS["timesteps"] * expected_chunks(),
                     V1.name: 0}
    for r, rep in enumerate(reports):
        if rep["b_launches"] != want_launches:
            raise RuntimeError(f"[10b] rank {r} launched {rep['b_launches']}, expected {want_launches}")
    if reports[0]["b"]["n_structures"] != n or any(rep["b"]["n_structures"] != 0 for rep in reports[1:]):
        raise RuntimeError(f"[10b] structures written by rank: {[rep['b']['n_structures'] for rep in reports]}")

    def csv_angles(out, i):
        return np.loadtxt(Path(tmp, out, "sampled_angles", f"generated_{i}.csv.gz"), delimiter=",", skiprows=1,
                          ndmin=2)

    got = [csv_angles("mp_sampled", i) for i in range(n)]
    check_angles("[10b]", got)
    seconds = reports[0]["b"]["sampling_seconds"]
    log(f"[10b] DDPM sweep over {MP_RANKS} ranks on {card}: {n} backbones, {expected_chunks()} chunks split by rows, "
        f"{want_launches[V2.name]} v2 launches per rank; sampling {seconds:.3f} s, {n / seconds:.3f} backbones/s")
    # One process running each chunk as the ranks run it (their rows, their
    # batch shapes, the chunk's draws): the sharded sweep must equal it
    model, train_args = model_io.from_dir(model_dir, device=DEVICE)
    schedule = DiffusionSchedule.create(train_args["variance_schedule"], train_args["timesteps"], device=DEVICE)
    empty = AnglesEmptyDataset.from_dir(model_dir)
    is_angular = empty.feature_is_angular["angles"]
    views = [sampling.build_sampler(model, schedule, is_angular, train_args["variance_scale"], gen_noise=True,
                                    mesh=Mesh(None, rank=r, size=MP_RANKS)) for r in range(MP_RANKS)]

    def ranks_in_turn(attn_mask, seed, chunk_i):
        return torch.cat([view(attn_mask, seed, chunk_i) for view in views])[: attn_mask.shape[0]]

    same_shapes = sampling.sample(model, schedule, is_angular=is_angular, pad=empty.pad, n=1, sweep_lengths=SWEEP,
                                  batch_size=BATCH, mean_offset=empty.get_masked_means(), seed=SEED,
                                  sampler=ranks_in_turn)
    del model
    err_same = max(circular_err(a, b) for a, b in zip(got, same_shapes))
    # Phase 5 ran each chunk whole: the GEMMs of another batch shape round
    # otherwise, and the cosine schedule's first steps amplify that ~100x
    # (the chain is chaotic after ~20 steps of a random-weight model), so
    # only a chunk whose kernels round alike at both shapes can match it
    small = [i for i, length in enumerate(range(*SWEEP)) if length <= BUCKET]
    errs = [circular_err(a, csv_angles("sampled", i)) for i, a in enumerate(got)]
    err_small = max(errs[i] for i in small)
    err_large = max(e for i, e in enumerate(errs) if i not in small)
    log(f"[10b] rank 0's CSVs: against one process at the ranks' batch shapes max circular err {err_same:.3e} (tol "
        f"1e-5); against phase 5's one process (whole chunks) {err_large:.3e} over the {n - len(small)} structures "
        f"of the large chunk (B={BATCH // MP_RANKS} per rank against 63; tol {DENOISER_TOL}), {err_small:.3e} over "
        f"the {len(small)} of the small chunk (B=8 against 15; not gated)")
    if not (err_same <= 1e-5 and err_large <= DENOISER_TOL):
        raise RuntimeError(f"[10b] the sharded sweep disagrees with one process: {err_same}, {err_large}")

    # (d) the TP forward and train step against one rank
    heads = FLAGSHIP.num_attention_heads // MP_RANKS
    for r, rep in enumerate(reports):
        if rep["d_launches"] != FLAGSHIP.num_hidden_layers or rep["d_heads"] != [heads]:
            raise RuntimeError(f"[10d] rank {r}: {rep['d_launches']} v2 launches at H={rep['d_heads']}, expected "
                               f"{FLAGSHIP.num_hidden_layers} at H={heads}")
    model = model_io.init_random(FLAGSHIP, torch.Generator().manual_seed(SEED)).to(DEVICE).eval()
    with torch.inference_mode():
        want = model(*denoiser_inputs(BATCH, FLAGSHIP.max_position_embeddings)).cpu()
    err = (results["d_forward"] - want).abs().max().item()
    log(f"[10d] flagship forward under a (1, {MP_RANKS}) TP mesh, \"auto\", B={BATCH} L=128: "
        f"{FLAGSHIP.num_hidden_layers} v2 launches per rank at H={heads}; against one rank max abs err {err:.3e} "
        f"(tol {DENOISER_TOL})")
    if not err <= DENOISER_TOL:
        raise RuntimeError(f"[10d] the TP forward disagrees with one rank: {err}")
    check_step_card_vs_cpu("[10d] one TP train step B=8 L=128", phase10_reference_step(8, SEED + 21),
                           results["d_step"], 1e-4, STEP_TERMS_TOL, STEP_PARAM_TOL,
                           what=f"(1, {MP_RANKS}) TP mesh vs 1 rank")
    return sum(rep["b_launches"][V2.name] + rep["d_launches"] for rep in reports)


EVAL_STEPS = 50  # (a) bin/sample_torch.py --method ddim --ddim_steps 50
LDDT_TOL = 1e-4  # lddt_torch in float32 on the card against the float64 host JSON: a pair may flip at a threshold
PE_TOL = 1e-6  # PositionalEncoding on the card against the CPU (float32 add)
SEQ_LETTERS = "ACDEFGHIKLMNPQRSTVWY"


@contextlib.contextmanager
def captured_logs():
    """The logging records of the block, INFO and above."""
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    root, handler = logging.getLogger(), Keep(logging.INFO)
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        yield records
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


def has_package(name: str) -> bool:
    return importlib.util.find_spec(name) is not None


def warnings_of(records) -> list:
    return [r.getMessage() for r in records if r.levelno >= logging.WARNING]


def phase_eval_sampling(tmp: str, trained: str, card: str) -> int:
    """(a) bin/sample_torch.py --method ddim --ddim_steps 50 over the sweep
    from phase 7's trained directory with the report (--testcomparison on
    phase 7's corpus) and --profile; first the same run without profiler or
    report, for the profiler's overhead. Returns the report run's v2
    launches."""
    out, prof, plain = Path(tmp, "eval_sampled"), Path(tmp, "eval_profile"), Path(tmp, "eval_plain")
    argv = ["-m", trained, "-n", "1", "-l", str(SWEEP[0]), str(SWEEP[1]), "-b", str(BATCH), "--seed", str(SEED),
            "--device", DEVICE, "--method", "ddim", "--ddim_steps", str(EVAL_STEPS)]
    cli = load_script("sample_torch")
    unprofiled = cli.main([*argv, "-o", str(plain), "--noplot", "--nopdb"])["sampling_seconds"]
    before = phase_totals().get("sampling", 0.0)
    reset_counts()
    start = time.perf_counter()
    with captured_logs() as records:
        result = cli.main([*argv, "-o", str(out), "--testcomparison", str(Path(tmp, "corpus")), "--profile",
                           str(prof)])
    wall = time.perf_counter() - start
    launches = FLAGSHIP.num_hidden_layers * EVAL_STEPS * expected_chunks()
    check_launches("[11a] ddim-50 with the report and --profile", {V2.name: launches, V1.name: 0})
    n = len(range(*SWEEP))
    if result["n_structures"] != n or len(list(Path(out, "sampled_pdb").glob("*.pdb"))) != n:
        raise RuntimeError(f"[11a] {result['n_structures']} structures, expected {n}")
    ks = json.loads(Path(out, "plots", "ks_tests.json").read_text())
    if list(ks) != list(FT_NAMES) or not all(len(v) == 2 and all(map(math.isfinite, v)) for v in ks.values()):
        raise RuntimeError(f"[11a] ks_tests.json: {ks}")
    counts = json.loads(Path(out, "plots", "ss_counts.json").read_text())
    if not 0 < len(counts["alpha"]) == len(counts["beta"]) <= n:
        raise RuntimeError(f"[11a] ss_counts.json holds {len(counts['alpha'])} structures")
    trace = json.loads(Path(prof, "trace.json").read_text())
    kernels = [e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    v2_events = sum("rel_attention" in k for k in kernels)
    gemm_events = sum(kernel_group(k) == "gemm" for k in kernels)
    if not v2_events or not gemm_events:
        raise RuntimeError(f"[11a] the trace holds {v2_events} v2 kernel and {gemm_events} GEMM events")
    sampling_seconds = phase_totals()["sampling"] - before
    pdfs = sorted(p.name for p in Path(out, "plots").glob("*.pdf"))
    warned = [w for w in warnings_of(records) if "matplotlib" in w]
    if has_package("matplotlib"):
        if len(pdfs) != 4 or warned:
            raise RuntimeError(f"[11a] matplotlib installed: PDFs {pdfs}, warnings {warned}")
    else:
        messages = [r.getMessage() for r in records]
        first_phase = min(i for i, m in enumerate(messages) if m.startswith("[phase] sampling"))
        if pdfs or len(warned) != 1 or messages.index(warned[0]) > first_phase:
            raise RuntimeError(f"[11a] without matplotlib: PDFs {pdfs}, warnings {warned}")
        log(f"[11a] without matplotlib, one warning before sampling: {warned[0]}")
    worst = max(ks, key=lambda k: ks[k][0])
    log(f"[11a] bin/sample_torch.py ddim-{EVAL_STEPS} --testcomparison --profile on {card}: {n} backbones, "
        f"{V2.launches} v2 launches; [phase] sampling {sampling_seconds:.3f} s with the profiler on against "
        f"{unprofiled:.3f} s off ({sampling_seconds / unprofiled:.3f}x); CLI wall {wall:.3f} s with the report and "
        f"the trace's export; trace: {len(kernels)} kernel events, {v2_events} of the v2 kernel, {gemm_events} "
        f"cuBLAS GEMMs; ks_tests.json: max KS statistic {ks[worst][0]:.4f} ({worst}); ss_counts.json: "
        f"{len(counts['alpha'])} structures, mean helices {np.mean(counts['alpha']):.3f}, mean strands "
        f"{np.mean(counts['beta']):.3f}")
    return V2.launches


def write_refolds(sampled: Path, folded: Path) -> None:
    """Three "refolded" copies of each backbone, N/CA/C moved by 0.3 (j + 1)
    A, named as the inverse-fold + refold pipeline names them."""
    folded.mkdir()
    rng = np.random.default_rng(SEED)
    for pdb in sorted(sampled.glob("generated_*.pdb")):
        bb = extract_backbone_coords(str(pdb), atoms=("N", "CA", "C"))
        for j in range(3):
            write_coords_to_pdb(bb + rng.normal(scale=0.3 * (j + 1), size=bb.shape),
                                str(folded / f"{pdb.stem}_{j}_residues_test.pdb"))


def phase_eval_lddt(tmp: str, card: str) -> None:
    """(b) bin/lddt_torch.py's JSON over the refolds, and lddt_torch on the
    card per backbone (B = 3 refolds, N = 3L atoms) against it."""
    sampled, folded = Path(tmp, "eval_sampled", "sampled_pdb"), Path(tmp, "eval_folded")
    write_refolds(sampled, folded)
    start = time.perf_counter()
    scores = load_script("lddt_torch").main([str(sampled), str(folded), "-o", str(Path(tmp, "lddt.json"))])
    wall = time.perf_counter() - start
    n = len(range(*SWEEP))
    if len(scores) != n or any(len(v) != 3 for v in scores.values()):
        raise RuntimeError(f"[11b] lddt.json holds {len(scores)} structures, expected {n} with 3 refolds each")
    err, device_ms, host_ms = 0.0, [], []
    for stem, by_fold in sorted(scores.items()):
        ref = extract_backbone_coords(str(sampled / f"{stem}.pdb"), atoms=("N", "CA", "C"))
        models = np.stack([extract_backbone_coords(str(folded / f"{f}.pdb"), atoms=("N", "CA", "C")) for f in by_fold])
        ri = np.repeat(np.arange(len(ref) // 3), 3)
        m = torch.from_numpy(models).float().to(DEVICE)
        r = torch.from_numpy(ref).float().to(DEVICE).expand_as(m)
        ri_card = torch.from_numpy(ri).to(DEVICE)
        lddt.lddt_torch(m, r, residue_index=ri_card)  # warm-up
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        out = lddt.lddt_torch(m, r, residue_index=ri_card)
        end.record()
        torch.cuda.synchronize()
        device_ms.append(begin.elapsed_time(end))
        err = max(err, float(np.abs(out.cpu().numpy() - np.array(list(by_fold.values()))).max()))
        t0 = time.perf_counter()
        for model in models:
            lddt.lddt_np(model, ref, residue_index=ri)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[11b] bin/lddt_torch.py on the host: {n} x 3 pairs in {wall:.3f} s; lddt_torch float32 on {card} against "
        f"its JSON: max |diff| {err:.3e} (tol {LDDT_TOL}); per backbone (B = 3, N = 3L): device "
        f"{statistics.median(device_ms):.4f} ms (CUDA events, median of {n}) against host lddt_np "
        f"{statistics.median(host_ms):.4f} ms (3 calls, median)")
    if not err <= LDDT_TOL:
        raise RuntimeError(f"[11b] lddt_torch disagrees with the host JSON by {err} > {LDDT_TOL}")


def phase_eval_designability(tmp: str, trained: str, card: str) -> None:
    """(c) bin/sctm_torch.py, bin/tmscore_training_torch.py (64 training
    structures) and bin/hclust_structures_torch.py --nsubset 20."""
    sampled, folded = Path(tmp, "eval_sampled", "sampled_pdb"), Path(tmp, "eval_folded")
    n = len(range(*SWEEP))
    start = time.perf_counter()
    sctm = load_script("sctm_torch").main(["-p", str(sampled), "-f", str(folded), "-o", str(Path(tmp, "sctm"))])
    t_sctm = time.perf_counter() - start
    with open(Path(tmp, "sctm.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    if len(sctm) != n or len(rows) != n or not all(0 < v <= 1 for v in sctm.values()):
        raise RuntimeError(f"[11c] scTM: {len(sctm)} scores, {len(rows)} CSV rows, range "
                           f"{min(sctm.values(), default=None)}-{max(sctm.values(), default=None)}")
    start = time.perf_counter()
    novelty = load_script("tmscore_training_torch").main(
        ["-d", str(sampled), "--trainfiles", str(Path(trained, "train_files.txt")), "--train-subsample", "64"])
    t_novelty = time.perf_counter() - start
    if len(novelty) != n or not all(0 < v <= 1 for v in novelty.values()):
        raise RuntimeError(f"[11c] tmscore_training: {len(novelty)} scores")
    start = time.perf_counter()
    hclust = load_script("hclust_structures_torch").main([str(sampled), "-o", str(Path(tmp, "hclust")),
                                                          "--nsubset", "20"])
    t_hclust = time.perf_counter() - start
    mat = np.load(Path(tmp, "hclust_tm_matrix.npy"))
    if mat.shape != (20, 20) or not np.array_equal(mat, mat.T) or not np.all(np.diag(mat) == 1.0) \
            or len(json.loads(Path(tmp, "hclust_clusters.json").read_text())) != 20:
        raise RuntimeError("[11c] hclust: the TM matrix is not a symmetric 20 x 20 with a unit diagonal")
    log(f"[11c] on the host: scTM of {n} backbones (3 refolds each) {t_sctm:.3f} s, median "
        f"{statistics.median(sctm.values()):.4f}; novelty against 64 training structures {t_novelty:.3f} s, median "
        f"max TM {statistics.median(novelty.values()):.4f}; hclust of 20 {t_hclust:.3f} s, "
        f"{len(set(hclust['clusters'].values()))} clusters")


def phase_eval_structures(tmp: str) -> None:
    """(d) bin/add_oxygen_to_backbone_torch.py and
    bin/splice_aa_onto_backbone_torch.py on one sampled PDB."""
    pdb = str(Path(tmp, "eval_sampled", "sampled_pdb", "generated_0.pdb"))
    length = len(extract_backbone_coords(pdb, atoms=("CA",)))
    oxy = load_script("add_oxygen_to_backbone_torch").main([pdb, "-o", str(Path(tmp, "with_o"))])
    names = [a.name for a in read_pdb(oxy[0]).atoms]
    if names != ["N", "CA", "C", "O"] * length:
        raise RuntimeError(f"[11d] {names.count('O')} oxygens over {length} residues")
    seq = "".join(np.random.default_rng(SEED).choice(list(SEQ_LETTERS), length))
    full = load_script("splice_aa_onto_backbone_torch").main([pdb, seq, "-o", str(Path(tmp, "full.pdb"))])
    library = sidechains.build_aa_sidechain_dict()
    atoms = read_pdb(full).atoms
    expected = [(sidechains.AA_1TO3[aa], name) for aa in seq
                for name in ["N", "CA", "C", *(rel.name for rel in library[aa])]]
    if [(a.res_name, a.name) for a in atoms] != expected:
        raise RuntimeError("[11d] the grafted atoms are not the sequence's side chains")
    log(f"[11d] generated_0 ({length} residues): {length} oxygens placed; {len(atoms) - 3 * length} side-chain atoms "
        f"grafted for a random sequence")


def phase_eval_featurizer(tmp: str) -> None:
    """(e) the native featurizer against the numpy path on 32 corpus files."""
    files = sorted(str(p) for p in Path(tmp, "corpus").glob("*.pdb"))[:32]
    if not featurize_native.available():
        raise RuntimeError("[11e] the native featurizer did not build")
    err, t_native, t_numpy = 0.0, 0.0, 0.0
    for f in files:
        t0 = time.perf_counter()
        native = featurize_native.featurize_pdb_native(f)
        t1 = time.perf_counter()
        values, _ = canonical_distances_and_dihedrals(f, distances=EXHAUSTIVE_DISTS, angles=EXHAUSTIVE_ANGLES)
        t_native, t_numpy = t_native + t1 - t0, t_numpy + time.perf_counter() - t1
        if native.shape != values.shape or not np.array_equal(np.isnan(native), np.isnan(values)):
            raise RuntimeError(f"[11e] {f}: native {native.shape}, numpy {values.shape}")
        err = max(err, float(np.nanmax(np.abs(native - values))))
    dsets._logged_featurizer = False
    with captured_logs() as records:
        dsets._featurize_one(files[0])
    path = [r.getMessage() for r in records if r.getMessage().startswith("Featurization path")]
    log(f"[11e] native featurizer against the numpy path on {len(files)} corpus files: max |diff| {err:.3e} (tol "
        f"1e-9); {t_native / len(files) * 1e3:.3f} against {t_numpy / len(files) * 1e3:.3f} ms per file; the dataset "
        f"layer logged: {path}")
    if not err <= 1e-9 or path != ["Featurization path: native C++ featurizer (csrc/featurize.cpp)"]:
        raise RuntimeError(f"[11e] max |diff| {err}, logged {path}")


def phase_eval_positional(card: str) -> None:
    """(f) PositionalEncoding in eval mode on the card against the CPU."""
    module = PositionalEncoding(384).eval()
    x = torch.randn(64, 128, 384, generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        ref = module(x)
        out = module.to(DEVICE)(x.to(DEVICE)).cpu()
    err = float((out - ref).abs().max())
    log(f"[11f] PositionalEncoding (64, 128, 384) on {card} against the CPU: max |diff| {err:.3e} (tol {PE_TOL})")
    if not err <= PE_TOL:
        raise RuntimeError(f"[11f] PositionalEncoding differs by {err}")


def phase_eval_lock_and_diagnostics(tmp: str, card: str) -> None:
    """(g) the job lock, and one bin/train_torch.py --epochs 1 without
    --dryrun on the corpus's first 64 files at batch 16 (featurized in this
    process: three pools' start would take longer than the files), logging
    the KL diagnostics."""
    with utils_platform.job_lock_if_cuda(DEVICE):
        reason = utils_platform.host_busy_reason() or ""
    if f"live pid {os.getpid()}" not in reason or os.path.exists(utils_platform.JOB_LOCK):
        raise RuntimeError(f"[11g] inside the lock: {reason!r}; after it the lock file exists: "
                           f"{os.path.exists(utils_platform.JOB_LOCK)}")
    results, config = Path(tmp, "diag_trained"), Path(tmp, "diag_train.json")
    config.write_text(json.dumps({**json.loads(Path(tmp, "train.json").read_text()), "multithread": False}))
    start = time.perf_counter()
    with captured_logs() as records:
        rows = load_script("train_torch").main([str(config), "-o", str(results), "--epochs", "1", "--toy", "64",
                                                "--batchsize", "16", "--device", DEVICE])
    wall = time.perf_counter() - start
    kl_lines = [r.getMessage() for r in records if r.getMessage().startswith("KL(noised || noise)")]
    kl_vals = np.load(results / "kl_divergence_timesteps.npy")
    diag = [w for w in warnings_of(records) if any(k in w for k in ("KL", "diagnostics", "matplotlib", "plot"))]
    if len(rows) != 1 or len(kl_lines) != 1 or kl_vals.shape != (FLAGSHIP_TRAIN_ARGS["timesteps"], len(FT_NAMES)):
        raise RuntimeError(f"[11g] {len(rows)} epochs, KL lines {kl_lines}, KL shape {kl_vals.shape}")
    if has_package("matplotlib"):
        if diag or not (results / "plots" / "kl_divergence_timesteps.pdf").is_file():
            raise RuntimeError(f"[11g] matplotlib installed: warnings {diag}")
    elif len(diag) != 1 or not diag[0].startswith("matplotlib not installed"):
        raise RuntimeError(f"[11g] without matplotlib the diagnostics warned {diag}")
    log(f"[11g] job lock: held by this pid inside ({reason}), gone after; bin/train_torch.py --epochs 1 --toy 64 -b 16 "
        f"without --dryrun on {card}: wall {wall:.3f} s; {kl_lines[0]}; diagnostics warnings: {diag}")


def phase_eval_figure_clis(tmp: str) -> None:
    """(h) bin/pdb_vis_torch.py: without matplotlib it exits at once naming
    it; with it, the PNG is written."""
    pdb, png = str(Path(tmp, "eval_sampled", "sampled_pdb", "generated_0.pdb")), Path(tmp, "generated_0.png")
    vis = load_script("pdb_vis_torch")
    if has_package("matplotlib"):
        vis.main(["pdb2png", pdb, "-o", str(png)])
        if png.stat().st_size == 0:
            raise RuntimeError("[11h] empty PNG")
        log(f"[11h] bin/pdb_vis_torch.py pdb2png: {png.stat().st_size} bytes")
        return
    try:
        vis.main(["pdb2png", pdb, "-o", str(png)])
    except SystemExit as e:
        if not e.code or "matplotlib" not in str(e.code) or png.exists():
            raise RuntimeError(f"[11h] bin/pdb_vis_torch.py exited with {e.code!r}") from None
        log(f"[11h] without matplotlib, bin/pdb_vis_torch.py pdb2png exits at once: {e.code}")
        return
    raise RuntimeError("[11h] bin/pdb_vis_torch.py ran without matplotlib")


def phase_evaluation(tmp: str, trained: str, card: str) -> int:
    """Phase 11, the evaluation path on the card, on phase 7's trained
    directory and corpus. Returns (a)'s v2 launches."""
    start = time.perf_counter()
    with dataset_cache_in(tmp):
        launches = timed("phase 11 sampling", phase_eval_sampling, tmp, trained, card)
        timed("phase 11 lDDT", phase_eval_lddt, tmp, card)
        timed("phase 11 designability", phase_eval_designability, tmp, trained, card)
        timed("phase 11 structures", phase_eval_structures, tmp)
        timed("phase 11 featurizer", phase_eval_featurizer, tmp)
        timed("phase 11 positional", phase_eval_positional, card)
        timed("phase 11 lock and diagnostics", phase_eval_lock_and_diagnostics, tmp, card)
        timed("phase 11 figure CLIs", phase_eval_figure_clis, tmp)
    log(f"[11] the evaluation path in {time.perf_counter() - start:.3f} s")
    return launches


GRAPH_SHAPES = ((15, 64), (BATCH, 128))  # (B, L): the sweep's small chunk and a full large one
GRAPH_DRAWS = 10  # the draws held equal before the chains
PALLAS_STEPS = 200  # DDPM under "pallas": a partial chain of 200 steps (start_t), not 1000, for the time limit
# Graphed against eager train steps without deterministic algorithms, over
# GRAPH_TOL_STEPS steps (three replays): the distance embedding's backward
# accumulates with atomics, so eager differs from eager by ~1e-7 per step
GRAPH_STEP_TOL, GRAPH_TOL_STEPS = 1e-6, 4
GRAPH_TRAIN_STEPS = 8  # bitwise: the first runs eagerly at capture, seven replay (fused_steps = 4: one and one)
GRAPH_PDIST_STEPS = 2  # with the pdist loss, whose eager step takes ~1 s
GRAPH_FIT_EPOCHS, GRAPH_FIT_TAIL = 2, 17  # Trainer.fit against its eager self: epochs, the ragged tail's rows
# Kernels a graphed DDPM step's graph holds beyond the eager step's operations
# (phase_graph_profile): the table reads of t and of the coefficients (2) and
# the counter's advance (1) in place of torch.full (-1)
GRAPH_BOOKKEEPING = 2
# The bitwise gates of graphs against cuda_graphs=False run a TF32 scope,
# so that a capture outside the model's scope would show; the step graphs'
# nodes are held against phase 5's float32 eager profile, and the 1e-6 gate
# of the default algorithms is float32's
GRAPH_PRECISION = {"matmul_precision": "high"}


def same(a, b) -> bool:
    """Bit-for-bit equality of two results: tensors, arrays, or lists of them."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.shape == b.shape and torch.equal(a, b)
    return np.array_equal(a, b)


def max_diff(a, b) -> float:
    if isinstance(a, (list, tuple)):
        return max(max_diff(x, y) for x, y in zip(a, b))
    return float((torch.as_tensor(a, dtype=torch.float64) - torch.as_tensor(b, dtype=torch.float64)).abs().max())


def gate_same(tag: str, a, b) -> None:
    equal = same(a, b)
    log(f"{tag}: bitwise equal {equal} (max abs diff {max_diff(a, b):.3e})")
    if not equal:
        raise RuntimeError(f"{tag}: the graphed result differs from the eager one")


def timed_chunks(sampler, times: list):
    """sampler (gen_noise form) with each chunk's wall time appended to
    `times`: synchronised before and after, so the chunks run one by one."""
    def run(attn_mask, seed, chunk_i):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = sampler(attn_mask, seed, chunk_i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
        return out
    return run


def phase_graph_sweeps(model_dir: str, card: str) -> None:
    """DDPM T = 1000, DDIM-50 and DPM-Solver++-20 over the sweep through
    sample(), eager then graphed twice (the first run captures each chunk
    shape's graphs, the second replays them): bit-for-bit equal results,
    the v2 launches of each run, per chunk ms per step, capture seconds and
    the memory the capture reserved, backbones/s."""
    model, train_args = model_io.from_dir(model_dir, device=DEVICE, **GRAPH_PRECISION)
    schedule = DiffusionSchedule.create(train_args["variance_schedule"], train_args["timesteps"], device=DEVICE)
    empty = AnglesEmptyDataset.from_dir(model_dir)
    is_angular = list(empty.feature_is_angular["angles"])
    n, n_chunks, layers = len(range(*SWEEP)), expected_chunks(), FLAGSHIP.num_hidden_layers
    for method, steps in (("ddpm", train_args["timesteps"]), ("ddim", 50), ("dpmpp", 20)):
        graphed = sampling.build_sampler(model, schedule, is_angular, method=method, ddim_steps=steps, gen_noise=True)
        results, walls, chunk_ms = {}, {}, {}
        for run in ("eager", "graphed, capturing", "graphed"):
            sampler = (graphed if run != "eager" else
                       sampling.build_sampler(model, schedule, is_angular, method=method, ddim_steps=steps,
                                              gen_noise=True, cuda_graphs=False))
            times: list = []
            reset_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            results[run] = sampling.sample(
                model, schedule, is_angular=is_angular, pad=empty.pad, n=1, sweep_lengths=SWEEP, batch_size=BATCH,
                bucket_multiple=BUCKET, mean_offset=empty.get_masked_means(), seed=SEED,
                sampler=timed_chunks(sampler, times))
            walls[run] = time.perf_counter() - start
            chunk_ms[run] = [t / steps * 1e3 for t in times]
            check_launches(f"[12] {method}-{steps} sweep, {run}", {V2.name: layers * steps * n_chunks, V1.name: 0},
                           "tf32")
        for run in ("graphed, capturing", "graphed"):
            gate_same(f"[12] {method}-{steps} over the sweep ({n} backbones, chunks 15 x 64 and 63 x 128), {run} "
                      f"against eager", results[run], results["eager"])
        capture = [(a - b) * steps / 1e3 for a, b in zip(chunk_ms["graphed, capturing"], chunk_ms["graphed"])]
        log(f"[12] {method}-{steps} on {card}: ms per step by chunk (15 x 64, 63 x 128): eager "
            f"{', '.join(f'{t:.4f}' for t in chunk_ms['eager'])}; graphed {', '.join(f'{t:.4f}' for t in chunk_ms['graphed'])}"
            f"; capture and first run above a replay {', '.join(f'{t:.3f}' for t in capture)} s; "
            f"backbones/s eager {n / walls['eager']:.3f}, graphed {n / walls['graphed']:.3f} "
            f"(first graphed run {n / walls['graphed, capturing']:.3f})")


def phase_graph_draws() -> None:
    """The first GRAPH_DRAWS normal draws of a sample() chunk's generator,
    eager against a replayed graph of them at each chunk shape: the same
    numbers, and the generator left at the same offset."""
    for b, l in GRAPH_SHAPES:
        shape = (b, l, 6)
        eager_gen = sampling.chunk_generator(SEED, 0, DEVICE)
        eager = [torch.randn(shape, generator=eager_gen, device=DEVICE) for _ in range(GRAPH_DRAWS)]
        graph_gen = torch.Generator(device=DEVICE)
        draws = torch.empty((GRAPH_DRAWS, *shape), device=DEVICE)

        def body():
            for i in range(GRAPH_DRAWS):
                draws[i].copy_(torch.randn(shape, generator=graph_gen, device=DEVICE))

        graph = StepGraph(body, DEVICE, generators=[graph_gen])
        for _ in range(2):  # the eager first call, then a replay
            graph_gen.set_state(sampling.chunk_generator(SEED, 0, DEVICE).get_state())
            graph()
        gate_same(f"[12] the first {GRAPH_DRAWS} draws of a chunk's generator at B={b} L={l}, a replayed graph",
                  list(draws), eager)
        if not torch.equal(graph_gen.get_state(), eager_gen.get_state()):
            raise RuntimeError(f"[12] B={b} L={l}: the graph left its generator elsewhere than the eager draws")


def phase_graph_chains(model_dir: str) -> None:
    """DDPM under "pallas" (v1 inside the graphs) and a reconstruction chain
    with its history."""
    layers = FLAGSHIP.num_hidden_layers
    schedule = DiffusionSchedule.create("cosine", FLAGSHIP_TRAIN_ARGS["timesteps"], device=DEVICE)
    is_angular = [True] * 6
    cases = (
        ("DDPM, attention_impl='pallas'", "pallas", GRAPH_SHAPES[0], dict(start_t=PALLAS_STEPS), PALLAS_STEPS, V1),
        (f"reconstruction chain from start_t={RECON_T} with its history", "auto", GRAPH_SHAPES[1],
         dict(start_t=RECON_T, return_history=True), RECON_T, V2),
    )
    for tag, impl, (b, l), options, steps, lib in cases:
        model, _ = model_io.from_dir(model_dir, device=DEVICE, attention_impl=impl, **GRAPH_PRECISION)
        x, _, mask = denoiser_inputs(b, l)
        out = {}
        samplers = {graphs: sampling.build_sampler(model, schedule, is_angular, cuda_graphs=graphs, **options)
                    for graphs in (False, True)}
        for graphs in (False, True, True):  # the graphed sampler captures, then replays
            reset_counts()
            run = samplers[graphs]
            out.setdefault(graphs, []).append(run(x, mask, generator=torch.Generator(device=DEVICE).manual_seed(SEED)))
            check_launches(f"[12] {tag} B={b} L={l}, graphs {graphs}",
                           {V2.name: 0, V1.name: 0, lib.name: layers * steps}, "tf32")  # v1 too: "high" is TF32
        gate_same(f"[12] {tag} B={b} L={l}, {steps} steps, graphed (twice) against eager", out[True],
                  out[False] * 2)


class KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint), ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def kernel_node_name(driver, node) -> str:
    """The (mangled) name of a kernel node's function, through the driver
    API (cuGraphKernelNodeGetParams, then cuFuncGetName, or cuKernelGetName
    where the node holds a CUkernel)."""
    params, name = KernelNodeParams(), ctypes.c_char_p()
    if driver.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)) != 0:
        raise RuntimeError("cuGraphKernelNodeGetParams failed")
    if params.func:
        rc = driver.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func))
    else:
        rc = driver.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern))
    if rc != 0:
        raise RuntimeError(f"the driver names no function of a kernel node (CUresult {rc})")
    return name.value.decode()


def graph_nodes(body, generators=()) -> tuple:
    """({node type: count}, {kernel name: count}, {(library, instance):
    launches per replay}) of the CUDA graph of body() (drawing from `generators`),
    captured after one eager call on a side stream and kept (keep_graph),
    its nodes read through the driver API (cuGraphGetNodes,
    cuGraphNodeGetType: 0 is a kernel, 1 a copy, 2 a memset), and the
    launches graphs.CapturedLaunches counted at the capture, which it adds
    on every replay. The capture runs nothing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for generator in generators:
        graph.register_generator_state(generator)
    account = CapturedLaunches()
    with collector_paused(), account.capturing(), torch.cuda.graph(graph):
        body()
    driver = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if driver.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    driver.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
    kinds: dict = {}
    names: dict = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds[kind.value] = kinds.get(kind.value, 0) + 1
        if kind.value == 0:
            name = kernel_node_name(driver, node)
            names[name] = names.get(name, 0) + 1
    per_replay = {(lib.name, i): n for lib, by_instance in zip(account.libraries, account.per_replay_by_instance)
                  for i, n in by_instance.items()}
    return kinds, names, per_replay


def gate_kernel_nodes(tag: str, names: dict, per_replay: dict, expected: dict) -> None:
    """Each kernel instance's nodes in a graph, found by the function name
    the driver gives them (CudaLibrary.kernel_name), against the launches
    its accounting adds per replay, and both against `expected`
    {(library, instance): nodes}, every other instance 0."""
    nodes = {(lib.name, i): sum(n for name, n in names.items() if lib.kernel_name(i) in name)
             for lib in (V2, V1) for i in lib.instances}
    want = {key: expected.get(key, 0) for key in nodes}
    shown = {f"{lib} {i}": n for (lib, i), n in nodes.items() if n}
    log(f"{tag}: kernel nodes by the driver's names {shown}, launches added per replay "
        f"{ {f'{lib} {i}': n for (lib, i), n in per_replay.items() if n} }")
    if nodes != per_replay or nodes != want:
        raise RuntimeError(f"{tag}: the graph's kernel nodes {nodes} differ from its counted launches {per_replay} "
                           f"or from {want}")


def step_graph_nodes(model, table, x, mask, is_angular) -> tuple:
    """graph_nodes of one DDPM step (sampling.TableChain's main segment) at
    x's shape, with x and mask in its static buffers."""
    with torch.inference_mode():
        plain = sampling.TableChain("ddpm", table, model, x, mask, is_angular, draws=True, graphed=False)
        plain.state.x.copy_(x)
        plain.state.attn_mask.copy_(mask)
        return graph_nodes(plain.main, [plain.generator])


def replayed_ddpm_steps(model, table, x, mask, is_angular, pool=None):
    """A DDPM chain's step graph (sampling.TableChain's main segment) at x's
    shape, seeded, after its capture and two replays; returns run(steps),
    which replays `steps` steps and synchronises."""
    chain = sampling.TableChain("ddpm", table, model, x, mask, is_angular, draws=True, pool=pool)

    def run(steps: int) -> None:
        with torch.inference_mode():
            for _ in range(steps):
                chain.main()
        torch.cuda.synchronize()

    with torch.inference_mode():
        chain.state.x.copy_(x)
        chain.state.attn_mask.copy_(mask)
        chain.generator.manual_seed(SEED)
    run(3)  # the eager first step and two replays
    return run


def wall_ms_per_step(run, steps: int = 10, windows: int = 3) -> list:
    """ms per step of `windows` windows of run(steps), on the host clock."""
    walls = []
    for _ in range(windows):
        start = time.perf_counter()
        run(steps)
        walls.append((time.perf_counter() - start) / steps * 1e3)
    return walls


def phase_graph_profile(model_dir: str, eager: dict, card: str) -> None:
    """A graphed DDPM step at each chunk shape under "auto": the nodes of
    its one-step graph against the eager step's device operations (phase
    5's profile), which must be GRAPH_BOOKKEEPING more kernels and nothing
    else (the gate, at both shapes), its v2 nodes (and under "pallas", at
    the small shape, its v1 nodes) against the launches its accounting adds
    per replay (gate_kernel_nodes); each replay adds the 2 fills of the
    registered generator's seed and offset. Then wall per step (host clock
    around 10 synchronised replays, the median of three), a torch.profiler
    window of 10 replays (busy share; its count of device events, which
    varies from window to window for graph replays, is printed, not gated)
    and the memory of the step graph's pool."""
    model, _ = model_io.from_dir(model_dir, device=DEVICE)
    schedule = DiffusionSchedule.create("cosine", 1000, device=DEVICE)
    is_angular = torch.ones(6, dtype=torch.bool, device=DEVICE)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for b, l in GRAPH_SHAPES:
        x, _, mask = denoiser_inputs(b, l)
        ref = eager["auto", b, l]
        table = sampling.ddpm_table(schedule, 1000)
        kinds, names, per_replay = step_graph_nodes(model, table, x, mask, is_angular)
        gate_kernel_nodes(f"[12] graphed DDPM step B={b} L={l}", names, per_replay,
                          {(V2.name, "fma"): FLAGSHIP.num_hidden_layers})
        kernels = kinds.get(0, 0)
        log(f"[12] graphed DDPM step B={b} L={l}: its graph holds {kernels} kernels and "
            f"{sum(kinds.values()) - kernels} other nodes ({kinds}); the eager step runs {ref['events']:.1f} "
            f"device operations, + {GRAPH_BOOKKEEPING} expected")
        if kinds != {0: ref["events"] + GRAPH_BOOKKEEPING}:
            raise RuntimeError(f"[12] the graph of a DDPM step at B={b} L={l} holds {kinds}, expected "
                               f"{ref['events']} + {GRAPH_BOOKKEEPING} kernels")

        pool = torch.cuda.graph_pool_handle()
        run = replayed_ddpm_steps(model, table, x, mask, is_angular, pool)
        pool_mib = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                       if tuple(s.get("segment_pool_id", ())) == tuple(pool)) / 2**20
        walls = wall_ms_per_step(run)
        with torch.profiler.profile(activities=activities) as prof:
            run(10)
        events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        busy, end = 0.0, -math.inf
        for e in events:
            busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
            end = max(end, e.time_range.end)
        span = (end - events[0].time_range.start) if events else 0.0
        log(f"[12] profile graphed DDPM step on {card}, B={b} L={l}: {len(events) / 10:.1f} device events per "
            f"replay in the window, busy {busy / 1e3 / 10:.4f} ms, busy share {busy / span if span else 0.0:.4f}; "
            f"wall {statistics.median(walls):.4f} ms (profiler off; {', '.join(f'{w:.4f}' for w in walls)}) "
            f"against eager {ref['wall_ms']:.4f} ms, busy share {ref['busy_share']:.4f}; the step graph's memory "
            f"pool {pool_mib:.1f} MiB")

    (b, l) = GRAPH_SHAPES[0]
    x, _, mask = denoiser_inputs(b, l)
    pallas, _ = model_io.from_dir(model_dir, device=DEVICE, attention_impl="pallas")
    _, names, per_replay = step_graph_nodes(pallas, sampling.ddpm_table(schedule, 1000), x, mask, is_angular)
    gate_kernel_nodes(f"[12] graphed DDPM step B={b} L={l}, attention_impl='pallas'", names, per_replay,
                      {(V1.name, "fma"): FLAGSHIP.num_hidden_layers})
    # at "high" (TF32), the captures of the bitwise gates: the v2 TF32 instance in a step's graph
    high, _ = model_io.from_dir(model_dir, device=DEVICE, **GRAPH_PRECISION)
    _, names, per_replay = step_graph_nodes(high, sampling.ddpm_table(schedule, 1000), x, mask, is_angular)
    gate_kernel_nodes(f"[12] graphed DDPM step B={b} L={l}, matmul_precision 'high'", names, per_replay,
                      {(V2.name, "tf32"): FLAGSHIP.num_hidden_layers})


def graph_train_runs(pdist, steps: int, fused: int = 0, matmul_precision: str = FLAGSHIP.matmul_precision) -> dict:
    """The flagship train step (dropout 0.1, gradient_clip 1.0, one-cycle
    lr) at B = 64, L = 128 from the same weights, generator and dropout
    seed, over `steps` batches: train_step calls of the eager trainer
    (cuda_graphs=False; the same capturable AdamW as the graphed one) twice,
    the step graph (the first step runs eagerly at capture), and if `fused`
    fused_steps = fused. Each run: (the (steps, 1 + F') losses, the
    parameters after)."""
    batches = [{k: v.numpy() for k, v in train_batch(BATCH, FLAGSHIP.max_position_embeddings, SEED + i).items()}
               for i in range(steps)]
    runs = ("eager", "eager again", "graphed") + ((f"fused {fused}",) if fused else ())
    out = {}
    for run in runs:
        trainer = flagship_trainer(DEVICE, lr_scheduler="OneCycleLR", use_pdist_loss=pdist,
                                   fused_steps=fused if run.startswith("fused") else 1,
                                   cuda_graphs=not run.startswith("eager"), matmul_precision=matmul_precision)
        torch.manual_seed(SEED)
        if run.startswith("eager"):
            rows = torch.stack([torch.cat([a[None], t]) for a, t in
                                (trainer.train_step(trainer.to_device(b)) for b in batches)])
        elif run == "graphed":
            rows = torch.cat([trainer.train_steps([b]) for b in batches])
        else:
            rows = torch.cat([trainer.train_steps(batches[i : i + fused]) for i in range(0, steps, fused)])
        out[run] = (rows.cpu(), [p.detach().cpu() for p in trainer.model.parameters()])
        del trainer
    return out


def graph_fit_runs() -> dict:
    """Trainer.fit of the flagship (dropout 0.1, one-cycle lr) for
    GRAPH_FIT_EPOCHS epochs with fused_steps = 2 over 5 full batches of 64
    and a ragged tail of GRAPH_FIT_TAIL rows (per epoch two replays of the
    fused graph of 2 steps, then the full shape's and the tail shape's
    single-step graphs, all in one memory pool), with a validation set,
    with cuda_graphs on and off: each run (its metrics rows without the
    epoch's seconds, the parameters after)."""
    l = FLAGSHIP.max_position_embeddings
    data = [train_batch(5 * BATCH + GRAPH_FIT_TAIL, l, SEED + 7), train_batch(BATCH + GRAPH_FIT_TAIL, l, SEED + 8)]
    train_data, valid_data = ({k: v.numpy() for k, v in d.items()} for d in data)
    out = {}
    for run in ("eager", "graphed"):
        trainer = flagship_trainer(DEVICE, lr_scheduler="OneCycleLR", fused_steps=2, max_epochs=GRAPH_FIT_EPOCHS,
                                   cuda_graphs=run == "graphed", **GRAPH_PRECISION)
        rows = trainer.fit(train_data, valid_data)
        out[run] = ([{k: v for k, v in row.items() if k != "epoch_seconds"} for row in rows],
                    [p.detach().cpu() for p in trainer.model.parameters()])
        del trainer
    return out


def deterministic_train_gates(out_path: str) -> None:
    """graph_train_runs without pdist and with the pdist config's, and
    graph_fit_runs, under torch.use_deterministic_algorithms (with
    CUBLAS_WORKSPACE_CONFIG set by the parent, as PyTorch asks), saved to
    out_path for phase 12's parent. Run in a process of its own: the
    setting must precede cuBLAS's first use."""
    with warnings_recorded() as seen:
        torch.use_deterministic_algorithms(True, warn_only=True)
        runs = {str(pdist): graph_train_runs(pdist, steps, fused, **GRAPH_PRECISION) for pdist, steps, fused in
                ((0.0, GRAPH_TRAIN_STEPS, 4), (graph_pdist(), GRAPH_PDIST_STEPS, 0))}
        fit = graph_fit_runs()
    torch.save({"runs": runs, "fit": fit, "warnings": sorted(set(seen))}, out_path)


@contextlib.contextmanager
def warnings_recorded():
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        seen: list = []
        yield seen
        seen.extend(str(w.message).split("\n")[0][:160] for w in caught)


def graph_pdist():
    """The pdist coefficients of config_jsons/cath_full_angles_cosine_pdist.json."""
    return tuple(json.loads((REPO / "config_jsons" / "cath_full_angles_cosine_pdist.json").read_text())["use_pdist_loss"])


def gate_train_runs(tag: str, runs: dict, tol: float) -> None:
    """Each run against the first eager one, bit for bit (tol 0) or within
    tol. Printed, not gated at tol > 0: eager against eager."""
    ref_rows, ref_params = runs["eager"]
    for run, (rows, params) in runs.items():
        if run == "eager":
            continue
        row_err, param_err = max_diff(rows, ref_rows), max_diff(params, ref_params)
        equal = same(rows, ref_rows) and same(params, ref_params)
        gated = tol == 0 or run != "eager again"
        log(f"{tag}: {run} against eager over {len(rows)} steps: bitwise equal {equal}; loss and terms max "
            f"abs diff {row_err:.3e}, parameters {param_err:.3e}" +
            (f" (tol {tol})" if tol and gated else ", not gated" if tol else ""))
        if gated and (not equal if tol == 0 else max(row_err, param_err) > tol):
            raise RuntimeError(f"{tag}: {run} differs from eager")


def time_train_steps(trainer: Trainer, batches: list, fused: bool, steps: int) -> list:
    """ms per step of `steps` synchronised steps after the first (a
    capture under graphs): eager train_step, one graph replay per step, or
    replays of the graph of len(batches) steps."""
    def one() -> int:
        if fused:
            trainer.train_steps(batches)
            return len(batches)
        if trainer.cuda_graphs:
            trainer.train_steps(batches[:1])
        else:
            trainer.train_step(trainer.to_device(batches[0]))
        return 1

    one()
    torch.cuda.synchronize()
    times: list = []
    while len(times) < steps:
        start = time.perf_counter()
        k = one()
        torch.cuda.synchronize()
        times.extend([(time.perf_counter() - start) * 1e3 / k] * k)
    return times


def phase_graph_training(card: str) -> None:
    """The graphed train step against the eager one (in a process with
    deterministic algorithms, bit for bit; here, within GRAPH_STEP_TOL beside
    eager against eager), then ms per step eager, graphed and fused_steps =
    4, and with the pdist loss."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graphs_") as tmp:
        out = str(Path(tmp, "deterministic.pt"))
        start = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.deterministic_train_gates(sys.argv[1])", out],
            cwd=REPO, env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}, capture_output=True, text=True,
            timeout=MP_TIMEOUT)
        if proc.returncode != 0:
            raise RuntimeError(f"[12] the deterministic train gates failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        result = torch.load(out, weights_only=False)
    log(f"[12] deterministic train gates in {time.perf_counter() - start:.3f} s (a process with "
        f"torch.use_deterministic_algorithms and CUBLAS_WORKSPACE_CONFIG=:4096:8); its warnings: "
        f"{result['warnings'] or 'none'}")
    for pdist, runs in result["runs"].items():
        gate_train_runs(f"[12] flagship train step B={BATCH} L=128, pdist {pdist}, deterministic algorithms", runs, 0.0)
    (eager_rows, eager_params), (rows, params) = result["fit"]["eager"], result["fit"]["graphed"]
    equal = rows == eager_rows and same(params, eager_params)
    log(f"[12] Trainer.fit, {GRAPH_FIT_EPOCHS} epochs of 5 x {BATCH} + {GRAPH_FIT_TAIL} with fused_steps = 2, "
        f"deterministic algorithms: graphed against cuda_graphs=False, metrics rows and parameters bitwise equal "
        f"{equal} (parameters max abs diff {max_diff(params, eager_params):.3e}); train_loss by epoch "
        f"{[r['train_loss'] for r in rows]}, eager {[r['train_loss'] for r in eager_rows]}")
    if not equal:
        raise RuntimeError("[12] the graphed Trainer.fit differs from the eager one")

    runs = graph_train_runs(0.0, GRAPH_TOL_STEPS, fused=2)
    gate_train_runs(f"[12] flagship train step B={BATCH} L=128, default algorithms (the distance embedding's "
                    f"backward accumulates with atomics, so eager differs from eager)", runs, GRAPH_STEP_TOL)

    batches = [{k: v.numpy() for k, v in train_batch(BATCH, FLAGSHIP.max_position_embeddings, SEED + i).items()}
               for i in range(4)]
    for pdist, steps in ((0.0, 20), (graph_pdist(), 4)):
        times = {}
        turns = ("eager", "graphed", "fused 4", "graphed again", "eager again") if not pdist else ("eager", "graphed")
        for run in turns:
            trainer = flagship_trainer(DEVICE, use_pdist_loss=pdist, cuda_graphs=not run.startswith("eager"))
            start = time.perf_counter()
            times[run] = time_train_steps(trainer, batches, run == "fused 4", steps)
            first = time.perf_counter() - start - sum(times[run]) / 1e3
            if run == "graphed":
                log(f"[12] train step graph, pdist {pdist}: first step with its capture {first:.3f} s")
            del trainer
        text = "; ".join(f"{run} {statistics.median(t):.4f} ms ({BATCH / statistics.median(t) * 1e3:.1f} structures/s)"
                         for run, t in times.items())
        log(f"[12] train step on {card}, B={BATCH} L=128, flagship, dropout 0.1, pdist {pdist}, median of {steps}: "
            f"{text}")


def phase_graphs(model_dir: str, eager_profiles: dict, card: str) -> None:
    start = time.perf_counter()
    timed("phase 12 draws", phase_graph_draws)
    timed("phase 12 sweeps", phase_graph_sweeps, model_dir, card)
    timed("phase 12 chains", phase_graph_chains, model_dir)
    timed("phase 12 profile", phase_graph_profile, model_dir, eager_profiles, card)
    timed("phase 12 training", phase_graph_training, card)
    log(f"[12] CUDA graphs in {time.perf_counter() - start:.3f} s")


# -- 13. matmul precision ---------------------------------------------------------

# IEEE float32, TF32, bf16 operands, and the multi-pass presets' products of
# TF32 or bf16 parts (models/config.py)
MULTI_PASS_PRESETS = ("TF32_TF32_F32_X3", "BF16_BF16_F32_X3", "BF16_BF16_F32_X6", "BF16_BF16_F32_X9")
# float64 products, and the 16-bit presets (f16 operands; f16 operands and
# output; bf16 operands and output): run without the sweep and the eager
# profile, their v2 launches counted on the graphed steps instead
WIDE_AND_16_PRESETS = ("F64_F64_F64", "F16_F16_F32", "F16_F16_F16", "BF16_BF16_BF16")
PRECISIONS = ("highest", "default", "BF16_BF16_F32", *MULTI_PASS_PRESETS, *WIDE_AND_16_PRESETS)
# The flagship forward's drift from "highest", as the RMS of the difference
# over the RMS of the output: starting bounds (a reading above one fails the
# run and is reported, never a quietly wider bound); the multi-pass presets'
# also at most PRECISION_TF32_SHARE of "default"'s (TF32) drift, and so is
# F64_F64_F64's; F16_F16_F32 as TF32 (both keep 11 significant bits),
# F16_F16_F16 twice that (its outputs rounded too), BF16_BF16_BF16 as bf16
PRECISION_DRIFT = {"default": 1e-2, "BF16_BF16_F32": 5e-2, "TF32_TF32_F32_X3": 1e-4, "BF16_BF16_F32_X3": 5e-4,
                   "BF16_BF16_F32_X6": 1e-4, "BF16_BF16_F32_X9": 1e-4, "F64_F64_F64": 1e-5, "F16_F16_F32": 1e-2,
                   "F16_F16_F16": 2e-2, "BF16_BF16_BF16": 5e-2}
PRECISION_TF32_SHARE = 0.1
# The v2 instance each precision's model runs here (ops/attention.py): "default" under the process's TF32
PRECISION_INSTANCES = {"highest": "fma", "default": "tf32", "BF16_BF16_F32": "bf16",
                       **{p: precision.mode_of(p) for p in (*MULTI_PASS_PRESETS, *WIDE_AND_16_PRESETS)}}
PRECISION_SHAPES = ((15, 64), (63, 128))  # the sweep's two chunks
PRECISION_STEPS = 20  # timed train steps, and the steps of the loss curves held against "highest"
# The eager profile's steps at each swept precision, in one window: it
# gates nothing, and the profiler's reading of a multi-pass preset's ~1,600
# operations per step took ~30 s a precision at 3 windows of 10
PRECISION_PROFILE_STEPS = 5
GEMM_KERNEL = re.compile(r"gemm|gemv|nvjet|xmma", re.I)
# The input projection's GEMM (K = 6: rows of 24 bytes, which TF32 tensor
# cores do not take), which cuBLAS runs on a float32 FMA kernel under TF32:
# one node in a step's graph and one in the train step's (measured)
FEATURE_GEMMS = {"step": 1, "train": 1}
# The GEMM nodes of a DDPM step's graph at 63 x 128 and of the train step's
# graph, per precision: one cuBLAS call per dot (a multi-pass preset's
# products of parts in one call over the parts), and cuBLAS runs some calls
# of a long contraction as two kernels (a split-K GEMM and its reduction):
# under _X6 12 more train nodes (one per layer; the weight gradients
# contract over 8192 rows times the parts), under _X9 25 more and one more
# in the step, under F64_F64_F64 (float64 GEMMs on the FP64 tensor cores,
# sm90_xmma_gemm_f64f64_*) 73 more train nodes (the card's cuBLAS, measured)
GEMM_NODES = {"highest": (75, 332), "default": (75, 332), "BF16_BF16_F32": (75, 332),
              "TF32_TF32_F32_X3": (75, 332), "BF16_BF16_F32_X3": (75, 332),
              "BF16_BF16_F32_X6": (75, 344), "BF16_BF16_F32_X9": (76, 357), "F64_F64_F64": (75, 405),
              "F16_F16_F32": (75, 332), "F16_F16_F16": (75, 332), "BF16_BF16_BF16": (75, 332)}


# The GEMMs' arithmetic each precision's graphs must hold (gate_gemm_kinds)
GEMM_MATH = {"highest": "ieee", "F64_F64_F64": "f64"}


def gemm_math(name: str) -> str | None:
    """What a kernel's (mangled) name says of the GEMM it runs: "tf32" (TF32
    tensor cores), "bf16" (bf16 operands on tensor cores), "f64" (float64),
    "ieee" (float32 FMA), "unplaced" for a GEMM kernel none of these
    patterns places; None for a kernel that runs no GEMM (split-K's
    reduction included)."""
    if not GEMM_KERNEL.search(name) or "splitKreduce" in name:
        return None
    if re.search(r"f64|dgemm|dmma|double", name, re.I):
        return "f64"
    if re.search(r"bf16|nvjet_tss", name):
        return "bf16"
    if re.search(r"tf32|tensorop_s1688|tensorop_s16816", name):
        return "tf32"
    if re.search(r"ffma|sgemm|gemv|f32f32_f32f32", name):
        return "ieee"
    return "unplaced"


def gemm_kinds(names: dict) -> dict:
    """{math: {kernel name: nodes}} of a graph's GEMM nodes (graph_nodes' names)."""
    kinds: dict = {}
    for name, n in names.items():
        kind = gemm_math(name)
        if kind is not None:
            kinds.setdefault(kind, {})[name] = n
    return kinds


def gate_gemm_kinds(tag: str, matmul_precision: str, kinds: dict, feature_gemms: int, nodes: int) -> None:
    """Under "highest" every GEMM node of the graph runs float32 FMA, under
    "F64_F64_F64" every one float64; under "default" (the process's TF32),
    "BF16_BF16_F32" (bf16 values in TF32 GEMMs), the 16-bit presets (f16 or
    bf16 values in TF32 GEMMs) and the multi-pass presets (their parts in
    TF32 GEMMs) every one TF32 tensor cores but at most `feature_gemms` (the
    input projection's). A backward pass left outside the model's scope
    would put its ~150 GEMMs on float32 FMA under "highest". `nodes`: the
    GEMM nodes the graph holds (GEMM_NODES)."""
    counts = {k: sum(v.values()) for k, v in kinds.items()}
    log(f"{tag}: GEMM nodes by their kernels' names {counts}: " +
        "; ".join(f"{k}: {', '.join(f'{n} x {name[:100]}' for name, n in v.items())}" for k, v in kinds.items()))
    want = GEMM_MATH.get(matmul_precision, "tf32")
    off = sum(n for k, n in counts.items() if k != want) - (feature_gemms if want == "tf32" else 0)
    if off > 0 or not counts:
        raise RuntimeError(f"{tag}: GEMM nodes {counts} under matmul_precision {matmul_precision!r}")
    total = sum(counts.values())
    if total != nodes:
        raise RuntimeError(f"{tag}: {total} GEMM nodes under matmul_precision {matmul_precision!r}, expected {nodes}")


def check_setting_kept(tag: str, before: str) -> None:
    """The process's fp32_precision as it was before the model ran."""
    now = torch.backends.cuda.matmul.fp32_precision
    if now != before:
        raise RuntimeError(f"{tag}: the model left fp32_precision {now!r}, {before!r} before it")


def train_step_graph_nodes(trainer: Trainer, batch: dict) -> dict:
    """graph_nodes' kernel names of the trainer's step graph body (forward,
    backward, clip, AdamW) on one device batch."""
    lrs = torch.full((1,), trainer.cfg.lr, dtype=torch.float32, device=DEVICE)
    return graph_nodes(trainer._steps_body([batch], lrs), [trainer.generator])[1]


def loss_curve(matmul_precision: str, batches: list) -> torch.Tensor:
    """The losses of len(batches) graphed train steps of the flagship
    (dropout 0, constant lr 1e-4) on a linear T = 1000 schedule, from the
    same weights and draws at every precision."""
    config = dataclasses.replace(FLAGSHIP, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                                 matmul_precision=matmul_precision)
    model = model_io.init_random(config, torch.Generator().manual_seed(SEED)).to(DEVICE)
    trainer = Trainer(model, DiffusionSchedule.create("linear", 1000, device=DEVICE),
                      TrainConfig(lr=1e-4, batch_size=BATCH, max_epochs=800, lr_scheduler=None), steps_per_epoch=300)
    return torch.cat([trainer.train_steps([b]) for b in batches])[:, 0].cpu()


def fixture_chain(matmul_precision: str) -> tuple:
    """A full DDPM chain (T = 100, graphed) of the trained fixture (3 x 96)
    at B = 16, L = 64 from the same x_T and the same draws at every
    precision; (x_0, mask)."""
    model, train_args = model_io.from_dir(str(FIXTURE), device=DEVICE, matmul_precision=matmul_precision)
    schedule = DiffusionSchedule.create(train_args["variance_schedule"], train_args["timesteps"], device=DEVICE)
    x, _, mask = denoiser_inputs(16, train_args["max_seq_len"])
    run = sampling.build_sampler(model, schedule, [True] * 6)
    return run(x, mask, generator=torch.Generator(device=DEVICE).manual_seed(SEED)), mask


def precision_cli(model_dir: str, tmp: str, card: str) -> None:
    """bin/sample_torch.py's main() over the sweep on a copy of the flagship
    directory whose config.json names TF32_TF32_F32_X3: every layer of every
    reverse step launches the v2 tf32x3 instance."""
    copy = Path(tmp, "flagship_tf32x3")
    shutil.copytree(model_dir, copy)
    config = json.loads((copy / "config.json").read_text())
    (copy / "config.json").write_text(json.dumps({**config, "matmul_precision": "TF32_TF32_F32_X3"}))
    steps = FLAGSHIP_TRAIN_ARGS["timesteps"]
    run_cli("[13] bin/sample_torch.py, config.json at TF32_TF32_F32_X3", str(copy), str(Path(tmp, "sampled_tf32x3")),
            [], {V2.name: FLAGSHIP.num_hidden_layers * steps * expected_chunks(), V1.name: 0}, card, steps,
            instance="tf32x3")


def phase_precision(model_dir: str, tmp: str, card: str) -> dict:
    """Phase 13: the flagship at matmul_precision "highest", "default"
    (TF32), "BF16_BF16_F32", the multi-pass presets, F64_F64_F64 and the
    16-bit presets. (a) times: a torch.profiler window of eager DDPM steps
    at B = 64, L = 128 by kernel group (phase 5's), the graphed DDPM step
    at the sweep's two chunks, the -n 1 DDPM sweep, the graphed train step
    at B = 64, L = 128 (F64_F64_F64 and the 16-bit presets without the
    profile and the sweep, their graphed steps' launches counted);
    (b) drift from "highest" on the same inputs: one forward (the gate), a
    full DDPM chain of the trained fixture, and the loss curve of 20 train
    steps on a linear schedule; (c) the GEMM kernels that a DDPM step's graph
    and the train step's graph (forward and backward) hold, and its v2
    nodes, all of the precision's instance (PRECISION_INSTANCES); under
    every precision but "highest" a "pallas" step's graph at 63 x 128, its
    v1 nodes all of the precision's instance, replayed 13 steps with the
    launches counted, then timed; both graphs' GEMM nodes in the count
    GEMM_NODES states; (d) the process's fp32_precision after every
    forward, train step and capture; (e) bin/sample_torch.py on a copy of
    the flagship directory whose config.json names TF32_TF32_F32_X3. The
    process runs TF32 GEMMs here, as the command-line programs do. Returns
    the launches of the sweeps or graphed steps (the other v2 instances)
    and of the "pallas" steps (the other v1 instances)."""
    start_phase = time.perf_counter()
    set_process_default()
    before = torch.backends.cuda.matmul.fp32_precision
    schedule = DiffusionSchedule.create("cosine", 1000, device=DEVICE)
    table = sampling.ddpm_table(schedule, 1000)
    is_angular = torch.ones(6, dtype=torch.bool, device=DEVICE)
    empty = AnglesEmptyDataset.from_dir(model_dir)
    features_angular = list(empty.feature_is_angular["angles"])
    n, layers, steps_t = len(range(*SWEEP)), FLAGSHIP.num_hidden_layers, FLAGSHIP_TRAIN_ARGS["timesteps"]
    x, t, mask = denoiser_inputs(BATCH, FLAGSHIP.max_position_embeddings)
    host_batches = [{k: v.numpy() for k, v in train_batch(BATCH, FLAGSHIP.max_position_embeddings, SEED + i).items()}
                    for i in range(PRECISION_STEPS)]
    forward, chains, curves, launches = {}, {}, {}, {}
    for precision in PRECISIONS:
        instance = PRECISION_INSTANCES[precision]
        what = f"[13] matmul_precision {precision!r} on {card}"
        seconds, mark = {}, time.perf_counter()

        def lap(part: str) -> None:  # host seconds of each part of this precision's column
            nonlocal mark
            seconds[part], mark = time.perf_counter() - mark, time.perf_counter()

        model, _ = model_io.from_dir(model_dir, device=DEVICE, matmul_precision=precision)
        with torch.inference_mode():
            forward[precision] = model(x, t, mask)
        check_setting_kept(f"{what}, forward", before)
        lap("forward")
        swept = precision not in WIDE_AND_16_PRESETS
        if swept:
            r = profile_steps(model_dir, "auto", BATCH, FLAGSHIP.max_position_embeddings, PRECISION_PROFILE_STEPS, 1,
                              matmul_precision=precision)
            groups = ", ".join(f"{g} {ms:.4f} ({k:.0f})"
                               for g, (ms, k) in sorted(r["groups"].items(), key=lambda kv: -kv[1][0]))
            log(f"{what}: profile of an eager DDPM step B={BATCH} L=128: {r['events']:.1f} device operations, busy "
                f"{r['busy_ms']:.4f} ms; device ms (operations) per step by group: {groups}")
            lap("profile")

        # (a) the graphed DDPM step at each chunk shape (its launches counted
        # where no sweep runs), and the sweep
        steps = []
        reset_counts()
        for b, l in PRECISION_SHAPES:
            xb, _, mb = denoiser_inputs(b, l)
            walls = wall_ms_per_step(replayed_ddpm_steps(model, table, xb, mb, is_angular))
            steps.append(f"{b} x {l} {statistics.median(walls):.4f} ms ({', '.join(f'{w:.4f}' for w in walls)})")
        check_setting_kept(f"{what}, step graphs", before)
        if not swept:
            # replayed_ddpm_steps' eager step and two replays, then wall_ms_per_step's 3 windows of 10, per shape
            check_launches(f"{what}, graphed DDPM steps", {V2.name: len(PRECISION_SHAPES) * 33 * layers, V1.name: 0},
                           instance)
            launches[V2.name, instance] = V2.launches_by_instance[instance]
            log(f"{what}: graphed DDPM step, median of three windows of 10 replays: {'; '.join(steps)}")
        else:
            sampler = sampling.build_sampler(model, schedule, features_angular, gen_noise=True)
            walls = []
            # the first run captures each chunk shape's graphs; a multi-pass preset's sweep (~25 s) runs once
            for _ in range(1 if precision in MULTI_PASS_PRESETS else 2):
                reset_counts()
                torch.cuda.synchronize()
                start = time.perf_counter()
                sampling.sample(model, schedule, is_angular=features_angular, pad=empty.pad, n=1, sweep_lengths=SWEEP,
                                batch_size=BATCH, bucket_multiple=BUCKET, mean_offset=empty.get_masked_means(),
                                seed=SEED, sampler=sampler)
                walls.append(time.perf_counter() - start)
            check_launches(f"{what}, DDPM sweep", {V2.name: layers * steps_t * expected_chunks(), V1.name: 0},
                           instance)
            launches[V2.name, instance] = V2.launches_by_instance[instance]
            check_setting_kept(f"{what}, sweep", before)
            log(f"{what}: graphed DDPM step, median of three windows of 10 replays: {'; '.join(steps)}; DDPM T=1000 "
                f"sweep (-n 1 -l {SWEEP[0]} {SWEEP[1]} -b {BATCH}, {n} backbones): {n / walls[-1]:.3f} backbones/s "
                + (f"(first run, with its captures: {n / walls[0]:.3f})" if len(walls) > 1 else "(with its captures)"))
            del sampler
        lap("DDPM steps and sweep")

        # (a) the graphed train step; (c) the GEMM kernels of both graphs
        trainer = flagship_trainer(DEVICE, matmul_precision=precision)
        times = time_train_steps(trainer, host_batches[:4], False, PRECISION_STEPS)
        ms = statistics.median(times)
        check_setting_kept(f"{what}, train steps", before)
        log(f"{what}: graphed train step B={BATCH} L=128 (dropout 0.1): median {ms:.4f} ms of {PRECISION_STEPS} "
            f"(min {min(times):.4f}, max {max(times):.4f}), {BATCH / ms * 1e3:.1f} structures/s")
        b, l = PRECISION_SHAPES[1]
        xb, _, mb = denoiser_inputs(b, l)
        _, names, per_replay = step_graph_nodes(model, table, xb, mb, is_angular)
        gate_gemm_kinds(
            f"{what}, a DDPM step's graph at {b} x {l}", precision, gemm_kinds(names), FEATURE_GEMMS["step"],
            GEMM_NODES[precision][0])
        gate_kernel_nodes(f"{what}, a DDPM step's graph at {b} x {l}", names, per_replay, {(V2.name, instance): layers})
        lap("train steps and a step's graph")
        if precision != "highest":  # the v1 kernel's instance in a "pallas" step's graph, replayed and timed
            pallas, _ = model_io.from_dir(model_dir, device=DEVICE, matmul_precision=precision, attention_impl="pallas")
            _, names, per_replay = step_graph_nodes(pallas, table, xb, mb, is_angular)
            gate_kernel_nodes(f"{what}, a 'pallas' DDPM step's graph at {b} x {l}", names, per_replay,
                              {(V1.name, instance): layers})
            reset_counts()
            run = replayed_ddpm_steps(pallas, table, xb, mb, is_angular)
            run(10)  # with the eager first step and two replays: 13 steps
            check_launches(f"{what}, 13 'pallas' DDPM steps at {b} x {l}", {V2.name: 0, V1.name: 13 * layers},
                           instance)
            launches[V1.name, instance] = V1.launches
            walls = wall_ms_per_step(run)
            log(f"{what}: graphed 'pallas' DDPM step at {b} x {l} (the v1 {instance} instance), median of three "
                f"windows of 10 replays: {statistics.median(walls):.4f} ms ({', '.join(f'{w:.4f}' for w in walls)})")
            del pallas, run
            lap("'pallas' steps")
        gate_gemm_kinds(
            f"{what}, the train step's graph (forward and backward)", precision,
            gemm_kinds(train_step_graph_nodes(trainer, trainer.to_device(host_batches[0]))), FEATURE_GEMMS["train"],
            GEMM_NODES[precision][1])
        check_setting_kept(f"{what}, captures", before)
        del trainer, model
        lap("the train step's graph")

        # (b) the fixture's chain and the loss curve
        chains[precision] = fixture_chain(precision)
        lap("fixture chain")
        curves[precision] = loss_curve(precision, host_batches)
        check_setting_kept(f"{what}, fixture chain and loss curve", before)
        lap("loss curve")
        log(f"{what}: host seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))

    ref = forward["highest"]
    (ref_chain, chain_mask), ref_curve = chains["highest"], curves["highest"]
    tf32_drift = rel_rms(forward["default"], ref)
    for precision in PRECISIONS[1:]:
        diff = forward[precision] - ref
        max_abs, rel = diff.abs().max().item(), (diff.square().mean().sqrt() / ref.square().mean().sqrt()).item()
        bound_ = PRECISION_DRIFT[precision]
        if precision in (*MULTI_PASS_PRESETS, "F64_F64_F64"):
            bound_ = min(bound_, PRECISION_TF32_SHARE * tf32_drift)
        angles = (chains[precision][0] - ref_chain + math.pi) % (2 * math.pi) - math.pi
        mean_angle = (angles.abs() * chain_mask[..., None]).sum().item() / (chain_mask.sum().item() * angles.shape[-1])
        curve = (curves[precision] - ref_curve).abs()
        log(f"[13] {precision!r} against 'highest' on {card}: flagship forward B={BATCH} L=128 max abs diff "
            f"{max_abs:.3e}, relative RMS {rel:.3e} (gate: above 0, at most {bound_:.3e}); the "
            f"trained fixture's DDPM chain (T=100, B=16 L=64, the same draws) mean |d angle| {mean_angle:.3e} rad; "
            f"loss over {PRECISION_STEPS} train steps (linear schedule, dropout 0) max abs diff "
            f"{curve.max().item():.3e}, last {curve[-1].item():.3e} (losses {ref_curve[0].item():.5f} -> "
            f"{ref_curve[-1].item():.5f} at 'highest', {curves[precision][-1].item():.5f} here)")
        if not 0 < rel <= bound_:
            raise RuntimeError(f"[13] the {precision!r} forward's drift from 'highest' is {rel}: expected above 0 "
                               f"and at most {bound_} (TF32's {tf32_drift})")
    start_cli = time.perf_counter()
    precision_cli(model_dir, tmp, card)
    log(f"[13] bin/sample_torch.py at TF32_TF32_F32_X3 in {time.perf_counter() - start_cli:.1f} s")
    check_setting_kept("[13] bin/sample_torch.py at TF32_TF32_F32_X3", before)
    log(f"[13] fp32_precision {before!r} after every forward, train step and capture; phase 13 in "
        f"{time.perf_counter() - start_phase:.3f} s")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    return launches


def timed(tag: str, fn, *args):
    """fn(*args), its host seconds logged with the run's seconds so far."""
    start = time.perf_counter()
    out = fn(*args)
    log(f"[time] {tag} in {time.perf_counter() - start:.1f} s; {time.perf_counter() - RUN_START:.1f} s into the run")
    return out


def main() -> None:
    card = phase_card()
    timed("phase 1", phase_build)
    kernels = timed("phase 2", phase_kernel)
    timed("phase 3", phase_fixture)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        model_dir, absolute_dir = str(Path(tmp, "flagship")), str(Path(tmp, "absolute"))
        mean_offset = np.random.default_rng(SEED).uniform(-np.pi, np.pi, 6)
        for config, path in ((FLAGSHIP, model_dir), (ABSOLUTE, absolute_dir)):
            weights = model_io.init_random(config, torch.Generator().manual_seed(SEED))
            train_args = {**FLAGSHIP_TRAIN_ARGS, "position_embedding_type": config.position_embedding_type}
            model_io.save_model_dir(path, config, weights.state_dict(), train_args, mean_offset)
            del weights
        timed("phase 4", phase_denoiser, model_dir, absolute_dir)
        v2_launches = timed("phase 5", phase_slice, model_dir, str(Path(tmp, "sampled")), card)
        eager_profiles = timed("phase 5 profile", phase_profile, model_dir, card)
        v1_launches = timed("phase 6", phase_new_paths, model_dir, tmp, card)
        trained = timed("phase 7", phase_training, tmp, card)
        timed("phase 8", phase_surface, tmp, model_dir, trained, card)
        baseline_launches = timed("phase 9", phase_baseline_models, tmp, card)
        multiprocess_launches = timed("phase 10", phase_multiprocess, tmp, model_dir, card)
        evaluation_launches = timed("phase 11", phase_evaluation, tmp, trained, card)
        timed("phase 12", phase_graphs, model_dir, eager_profiles, card)
        precision_launches = timed("phase 13", phase_precision, model_dir, tmp, card)

    # launches: the FMA instances' from the float32 phases (v2: 5, 9, 10, 11; v1: 6); the other v2
    # instances' from phase 13's DDPM sweeps at their precisions ("default": TF32, as the CLIs set it;
    # the f64 and 16-bit instances' from its graphed steps); the other v1 instances' from phase 13's
    # "pallas" steps at those precisions
    fma_launches = {V2.name: v2_launches + baseline_launches + multiprocess_launches + evaluation_launches,
                    V1.name: v1_launches}
    line = []
    for lib, entry, replaces in ((V2, "fused_attention_v2", 187), (V1, "fused_attention", 78)):
        for i in lib.instances:
            line.append({"name": f"{lib.kernel_name(i)} ({entry}, {i})", "route": "cuda",
                         "source": f"foldingdiff_tpu_torch/csrc/{lib.name}.cu",
                         "replaces": f"foldingdiff_tpu/ops/pallas_attention.py:{replaces}",
                         "launches": fma_launches[lib.name] if i == "fma" else precision_launches[lib.name, i],
                         **kernels["v2" if lib is V2 else "v1", i]})
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
