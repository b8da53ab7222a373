#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (foldingdiff_tpu_torch) on one NVIDIA GPU.

Phases, each printing lines of its own:
  0. the card, as nvidia-smi names it with its power limit; fails without CUDA
  1. build both attention kernels (csrc/rel_attention.cu, the v2 entry, and
     csrc/gathered_attention.cu, the v1 entry) with nvcc, one process each,
     started together
  2. each kernel against its plain PyTorch version on the card, with and
     without relative scores (v1: e_lr gathered from arange and from a
     permuted position vector, and random), at the denoiser's shapes and
     head sizes 16 and 64; masked-key invariance; kernel and plain times of
     all four kernel instances (v1, v2; rel, rel-off) at B = 64, H = 12,
     D = 32, L = 128 and 64
  3. the trained torch fixture loaded through models.io.from_dir onto the
     card under attention_impl "auto" (v2) and "pallas" (v1), against its
     recorded predictions (parity.npz)
  4. the flagship denoiser (12 layers x 384, 12 heads of 32, relative_key,
     M = 128) with seeded random weights, read back from a model directory,
     "auto" (12 v2 launches), "pallas" (12 v1) and "auto" with permuted
     position_ids (12 v1, no v2) against "plain" at B = 64, L = 128, timed;
     and a 12 x 384 `absolute` config under "pallas" (v1 without e_lr)
     against "plain"
  5. the DDPM slice: bin/sample_torch.py's main() over that model directory,
     DDPM T = 1000 over lengths 50..127 once each at batch 64; every layer of
     every reverse step must launch the v2 kernel
  6. the new paths at full width: the flagship under "pallas" through
     sampling.sample (DDPM T = 1000, the same sweep), every layer of every
     step launching the v1 kernel and none the v2; then bin/sample_torch.py
     with --method ddim --ddim_steps 50 and --method dpmpp --ddim_steps 20,
     each launching the v2 kernel on every layer of every step

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Any failure raises, so the script exits
non-zero and prints neither.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from foldingdiff_tpu_torch.data.datasets import AnglesEmptyDataset  # noqa: E402
from foldingdiff_tpu_torch.diffusion import sampling  # noqa: E402
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule  # noqa: E402
from foldingdiff_tpu_torch.models import io as model_io  # noqa: E402
from foldingdiff_tpu_torch.models.config import ModelConfig  # noqa: E402
from foldingdiff_tpu_torch.ops import attention  # noqa: E402

DEVICE = "cuda"
SEED = 1234
KERNEL_TOL = 1e-4  # kernel vs plain, one attention call (float32, other summation order)
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
# (B, H, L, D, M) of the kernel checks: the flagship at its buckets and a
# ragged length, the fixtures' head size 16 with M = 64, and head size 64
# with B * H = 15 (a ragged group of pairs for v1)
V2, V1 = attention.REL_ATTENTION, attention.GATHERED_ATTENTION
KERNEL_SHAPES = [(64, 12, 128, 32, 128), (64, 12, 64, 32, 128), (64, 12, 50, 32, 128),
                 (16, 6, 64, 16, 64), (16, 6, 33, 16, 64), (3, 5, 99, 64, 128)]


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    for lib in attention.LIBRARIES:
        report = reports[lib.name]
        log(f"[1] {lib.library_path().relative_to(REPO)}" + ("" if report else " (already built)"))
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[1]   {line.strip()}")
    log(f"[1] built both libraries in {seconds:.3f} s (one nvcc each, in parallel)")


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


def phase_kernel() -> dict:
    worst = {"v2": 0.0, "v1": 0.0}
    with torch.inference_mode():
        for b, h, l, d, m in KERNEL_SHAPES:
            q, k, v, bias, table = attention_inputs(b, h, l, d, m, SEED + l + d)
            shape = f"B={b} H={h} L={l} D={d} M={m}"
            for rel in (True, False):
                kw = dict(rel_table=table, m=m) if rel else {}
                out = attention.fused_attention_v2(q, k, v, bias, **kw)
                ref = attention.fused_attention_v2_reference(q, k, v, bias, **kw)
                worst["v2"] = max(worst["v2"], check_err(f"v2 {shape} rel={rel}", out, ref))
                if rel:
                    check_masked_keys(f"v2 {shape}", lambda q_, k_, v_: attention.fused_attention_v2(
                        q_, k_, v_, bias, table, m), q, k, v, bias, out)
            for e_kind in ("arange", "permuted", "random", None):
                if e_kind == "random":  # not Toeplitz
                    e_lr = torch.randn(l, l, d, generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                                       device=DEVICE) * 0.5
                else:
                    e_lr = gathered(table, l, m, e_kind == "permuted") if e_kind else None
                out = attention.fused_attention(q, k, v, bias, e_lr)
                ref = attention.fused_attention_reference(q, k, v, bias, e_lr)
                worst["v1"] = max(worst["v1"], check_err(f"v1 {shape} e_lr={e_kind}", out, ref))
                if e_kind == "permuted":
                    check_masked_keys(f"v1 {shape}", lambda q_, k_, v_: attention.fused_attention(
                        q_, k_, v_, bias, e_lr), q, k, v, bias, out)

        times = {}
        for l in (128, 64):
            q, k, v, bias, table = attention_inputs(64, 12, l, 32, 128, SEED)
            e_lr = gathered(table, l, 128, permuted=False)
            for rel in (True, False):
                kw2 = dict(rel_table=table, m=128) if rel else {}
                e = e_lr if rel else None
                times["v2", rel, l] = alternate_ms(
                    lambda: attention.fused_attention_v2_reference(q, k, v, bias, **kw2),
                    lambda: attention.fused_attention_v2(q, k, v, bias, **kw2),
                )
                times["v1", rel, l] = alternate_ms(
                    lambda: attention.fused_attention_reference(q, k, v, bias, e),
                    lambda: attention.fused_attention(q, k, v, bias, e),
                )
                for entry in ("v2", "v1"):
                    plain_ms, kernel_ms = times[entry, rel, l]
                    log(f"[2] time {entry} B=64 H=12 L={l} D=32 {'rel' if rel else 'rel-off'}: "
                        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {entry: {"max_abs_err": worst[entry], "ms": times[entry, True, 128][1],
                    "plain_ms": times[entry, True, 128][0]} for entry in ("v2", "v1")}


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
        ("absolute 12x384", absolute_dir, (("pallas", None, V1),)),
    ):
        plain, _ = model_io.from_dir(path, device=DEVICE, attention_impl="plain")
        for impl, pos, lib in routes:
            model, _ = model_io.from_dir(path, device=DEVICE, attention_impl=impl)
            what = f"attention_impl={impl!r}" + (", permuted position_ids" if pos is not None else "")
            with torch.inference_mode():
                V2.launches = V1.launches = 0
                out = model(x, t, mask, pos)
                check_launches(f"[4] {name} {what}", {V2.name: 0, V1.name: 0, lib.name: layers})
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


def load_cli():
    spec = importlib.util.spec_from_file_location("sample_torch", REPO / "bin" / "sample_torch.py")
    sample_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sample_torch)
    return sample_torch


def check_launches(tag: str, expected: dict) -> None:
    launched = {V2.name: V2.launches, V1.name: V1.launches}
    log(f"{tag} kernel launches: {launched}, expected {expected}")
    if launched != expected:
        raise RuntimeError(f"{tag} launched {launched}, expected {expected}")


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


def run_cli(tag: str, model_dir: str, out_dir: str, extra: list, expected: dict, card: str, steps: int) -> None:
    """bin/sample_torch.py's main() over the sweep; checks launches, PDBs, CSVs; prints backbones/s."""
    argv = ["-m", model_dir, "-o", out_dir, "-n", "1", "-l", str(SWEEP[0]), str(SWEEP[1]),
            "-b", str(BATCH), "--seed", str(SEED), "--device", DEVICE, *extra]
    V2.launches = V1.launches = 0
    start = time.perf_counter()
    result = load_cli().main(argv)
    wall = time.perf_counter() - start
    check_launches(tag, expected)

    n = len(range(*SWEEP))
    pdbs = sorted(Path(out_dir, "sampled_pdb").glob("generated_*.pdb"))
    if len(pdbs) != n or result["n_structures"] != n:
        raise RuntimeError(f"{tag}: expected {n} PDBs, found {len(pdbs)}")
    check_angles(tag, [np.loadtxt(Path(out_dir, "sampled_angles", f"generated_{i}.csv.gz"), delimiter=",",
                                  skiprows=1, ndmin=2) for i in range(n)])
    seconds = result["sampling_seconds"]
    n_chunks = expected_chunks()
    log(f"{tag} on {card}: {n} backbones, {' '.join(extra) or 'DDPM'}, {steps} steps, batch {BATCH}, "
        f"bucket {BUCKET}, {n_chunks} chunks, eager loop: sampling {seconds:.3f} s, {n / seconds:.3f} backbones/s, "
        f"{seconds / (steps * n_chunks) * 1e3:.4f} ms per reverse step (mean over chunks); "
        f"CLI wall with loading and PDB writing {wall:.3f} s")


def phase_slice(model_dir: str, out_dir: str, card: str) -> int:
    timesteps = FLAGSHIP_TRAIN_ARGS["timesteps"]
    launches = FLAGSHIP.num_hidden_layers * timesteps * expected_chunks()
    run_cli("[5] DDPM slice", model_dir, out_dir, [], {V2.name: launches, V1.name: 0}, card, timesteps)
    return V2.launches


def phase_new_paths(model_dir: str, tmp: str, card: str) -> int:
    layers, n_chunks = FLAGSHIP.num_hidden_layers, expected_chunks()
    timesteps = FLAGSHIP_TRAIN_ARGS["timesteps"]

    # DDPM with the v1 kernel, through sampling.sample as bench.py drives it with BENCH_ATTN=pallas
    model, train_args = model_io.from_dir(model_dir, device=DEVICE, attention_impl="pallas")
    schedule = DiffusionSchedule.create(train_args["variance_schedule"], timesteps, device=DEVICE)
    empty = AnglesEmptyDataset.from_dir(model_dir)
    V2.launches = V1.launches = 0
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
        f"eager loop: sampling {seconds:.3f} s, {n / seconds:.3f} backbones/s, "
        f"{seconds / (timesteps * n_chunks) * 1e3:.4f} ms per reverse step (mean over chunks)")
    del model

    for method, steps in (("ddim", 50), ("dpmpp", 20)):
        run_cli(f"[6] {method}-{steps}", model_dir, str(Path(tmp, method)),
                ["--method", method, "--ddim_steps", str(steps)],
                {V2.name: layers * steps * n_chunks, V1.name: 0}, card, steps)
    return v1_launches


def main() -> None:
    card = phase_card()
    phase_build()
    kernels = phase_kernel()
    phase_fixture()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        model_dir, absolute_dir = str(Path(tmp, "flagship")), str(Path(tmp, "absolute"))
        mean_offset = np.random.default_rng(SEED).uniform(-np.pi, np.pi, 6)
        for config, path in ((FLAGSHIP, model_dir), (ABSOLUTE, absolute_dir)):
            weights = model_io.init_random(config, torch.Generator().manual_seed(SEED))
            train_args = {**FLAGSHIP_TRAIN_ARGS, "position_embedding_type": config.position_embedding_type}
            model_io.save_model_dir(path, config, weights.state_dict(), train_args, mean_offset)
            del weights
        phase_denoiser(model_dir, absolute_dir)
        v2_launches = phase_slice(model_dir, str(Path(tmp, "sampled")), card)
        v1_launches = phase_new_paths(model_dir, tmp, card)

    log(json.dumps({"kernels": [
        {"name": "rel_attention_kernel (fused_attention_v2)", "route": "cuda",
         "source": "foldingdiff_tpu_torch/csrc/rel_attention.cu",
         "replaces": "foldingdiff_tpu/ops/pallas_attention.py:187",
         "launches": v2_launches, **kernels["v2"]},
        {"name": "gathered_attention_kernel (fused_attention)", "route": "cuda",
         "source": "foldingdiff_tpu_torch/csrc/gathered_attention.cu",
         "replaces": "foldingdiff_tpu/ops/pallas_attention.py:78",
         "launches": v1_launches, **kernels["v1"]},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
