#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (foldingdiff_tpu_torch) on one NVIDIA GPU.

Phases, each printing lines of its own:
  0. the card, as nvidia-smi names it with its power limit; fails without CUDA
  1. build the relative_key attention kernel (csrc/rel_attention.cu) with nvcc
  2. the kernel against its plain PyTorch version on the card, with and
     without relative scores, at the denoiser's shapes; masked-key
     invariance; kernel and plain times at the flagship shape
  3. the trained torch fixture loaded through models.io.from_dir onto the
     card (kernel path), against its recorded predictions (parity.npz)
  4. the flagship denoiser (12 layers x 384, 12 heads of 32, relative_key,
     M = 128) with seeded random weights, read back from a model directory,
     kernel path against attention_impl="plain" at B = 64, L = 128
  5. the slice: bin/sample_torch.py's main() over that model directory,
     DDPM T = 1000 over lengths 50..127 once each at batch 64; every layer of
     every reverse step must launch the kernel

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Any failure raises, so the script exits
non-zero and prints neither.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

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
FLAGSHIP_TRAIN_ARGS = {
    "angles_definitions": "canonical-full-angles", "max_seq_len": 128, "min_seq_len": 40,
    "timesteps": 1000, "variance_schedule": "cosine", "variance_scale": 1.0,
    "time_encoding": "gaussian_fourier", "num_hidden_layers": 12, "hidden_size": 384,
    "intermediate_size": 768, "num_heads": 12, "position_embedding_type": "relative_key",
    "dropout_p": 0.1, "decoder": "mlp",
}
SWEEP, BATCH, BUCKET = (50, 128), 64, 64  # bin/sample_torch.py -l 50 128 -b 64 (bucket: sample()'s default)
# (B, H, L, D, M) of the kernel checks: the flagship at its buckets and a
# ragged length, and the fixtures' head size 16 with M = 64
KERNEL_SHAPES = [(64, 12, 128, 32, 128), (64, 12, 64, 32, 128), (64, 12, 50, 32, 128),
                 (16, 6, 64, 16, 64), (16, 6, 33, 16, 64)]


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
    report = attention.build()
    seconds = time.perf_counter() - start
    log(f"[1] built {attention.library_path().relative_to(REPO)} in {seconds:.3f} s"
        + ("" if report else " (already built)"))
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[1]   {line.strip()}")


def phase_kernel() -> dict:
    worst = 0.0
    with torch.inference_mode():
        for b, h, l, d, m in KERNEL_SHAPES:
            q, k, v, bias, table = attention_inputs(b, h, l, d, m, SEED + l + d)
            for rel in (True, False):
                kw = dict(rel_table=table, m=m) if rel else {}
                out = attention.fused_attention_v2(q, k, v, bias, **kw)
                ref = attention.fused_attention_v2_reference(q, k, v, bias, **kw)
                err = (out - ref).abs().max().item()
                log(f"[2] B={b} H={h} L={l} D={d} M={m} rel={rel}: max abs err {err:.3e}")
                if not err <= KERNEL_TOL:
                    raise RuntimeError(f"kernel disagrees with the plain version: {err} > {KERNEL_TOL}")
                worst = max(worst, err)
                if rel:
                    out_rel = out
            # Values at masked keys must not reach the output
            masked = (bias < -1.0)[:, None, :, None]
            out2 = attention.fused_attention_v2(
                q, k + 7.0 * masked, v - 3.0 * masked, bias, rel_table=table, m=m)
            drift = (out2 - out_rel).abs().max().item()
            log(f"[2] B={b} H={h} L={l} D={d}: masked-key drift {drift:.3e}")
            if not drift <= 1e-5:
                raise RuntimeError(f"masked keys change the kernel's output by {drift}")

        times = {}
        for l in (128, 64):
            q, k, v, bias, table = attention_inputs(64, 12, l, 32, 128, SEED)
            plain_ms, kernel_ms = alternate_ms(
                lambda: attention.fused_attention_v2_reference(q, k, v, bias, table, 128),
                lambda: attention.fused_attention_v2(q, k, v, bias, table, 128),
            )
            times[l] = (kernel_ms, plain_ms)
            log(f"[2] time B=64 H=12 L={l} D=32 rel: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": times[128][0], "plain_ms": times[128][1]}


def phase_fixture() -> None:
    model, _ = model_io.from_dir(str(FIXTURE), device=DEVICE)
    parity = np.load(FIXTURE / "parity.npz")
    before = attention.launches
    with torch.inference_mode():
        out = model(*(torch.from_numpy(parity[k]).to(DEVICE) for k in ("x", "t", "mask")))
    out = out.cpu().numpy()
    launched = attention.launches - before
    if launched != model.config.num_hidden_layers:
        raise RuntimeError(f"fixture forward launched the kernel {launched} times")
    err = float(np.abs(out - parity["predicted_noise"]).max())
    log(f"[3] torch fixture via from_dir on the card: max abs err {err:.3e} (atol 2e-5, rtol 1e-4)")
    np.testing.assert_allclose(out, parity["predicted_noise"], atol=2e-5, rtol=1e-4)


def phase_denoiser(model_dir: str) -> None:
    model, _ = model_io.from_dir(model_dir, device=DEVICE)
    plain, _ = model_io.from_dir(model_dir, device=DEVICE, attention_impl="plain")
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    b, l = BATCH, FLAGSHIP.max_position_embeddings
    x = (torch.rand(b, l, 6, generator=g, device=DEVICE) * 2 - 1) * math.pi
    t = torch.randint(0, 1000, (b,), generator=g, device=DEVICE)
    lengths = torch.randint(SWEEP[0], l + 1, (b,), generator=g, device=DEVICE)
    mask = (torch.arange(l, device=DEVICE)[None, :] < lengths[:, None]).float()
    with torch.inference_mode():
        err = (model(x, t, mask) - plain(x, t, mask)).abs().max().item()
        log(f"[4] flagship denoiser B={b} L={l}, kernel vs plain attention: max abs err {err:.3e}")
        if not err <= DENOISER_TOL:
            raise RuntimeError(f"denoiser kernel path disagrees with plain: {err} > {DENOISER_TOL}")
        plain_ms, kernel_ms = alternate_ms(lambda: plain(x, t, mask), lambda: model(x, t, mask), iters=20)
    log(f"[4] time one denoiser call B={b} L={l}: kernel path {kernel_ms:.4f} ms, plain path {plain_ms:.4f} ms")


def expected_chunks() -> int:
    """Chunks that sample() makes of the sweep: lengths grouped by their
    bucket, each group cut into batches."""
    per_bucket: dict = {}
    for length in range(*SWEEP):
        bucket = min(FLAGSHIP.max_position_embeddings, -(-length // BUCKET) * BUCKET)
        per_bucket[bucket] = per_bucket.get(bucket, 0) + 1
    return sum(-(-n // BATCH) for n in per_bucket.values())


def phase_slice(model_dir: str, out_dir: str, card: str) -> int:
    spec = importlib.util.spec_from_file_location("sample_torch", REPO / "bin" / "sample_torch.py")
    sample_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sample_torch)
    argv = ["-m", model_dir, "-o", out_dir, "-n", "1", "-l", str(SWEEP[0]), str(SWEEP[1]),
            "-b", str(BATCH), "--seed", str(SEED), "--device", DEVICE]
    attention.launches = 0
    start = time.perf_counter()
    result = sample_torch.main(argv)
    wall = time.perf_counter() - start
    launched = attention.launches

    n_chunks = expected_chunks()
    timesteps = FLAGSHIP_TRAIN_ARGS["timesteps"]
    expected = FLAGSHIP.num_hidden_layers * timesteps * n_chunks
    log(f"[5] kernel launches in the slice: {launched} (12 layers x {timesteps} steps x {n_chunks} chunks = {expected})")
    if launched != expected:
        raise RuntimeError(f"the slice launched the kernel {launched} times, expected {expected}")

    lengths = list(range(*SWEEP))
    pdbs = sorted(Path(out_dir, "sampled_pdb").glob("generated_*.pdb"))
    if len(pdbs) != len(lengths) or result["n_structures"] != len(lengths):
        raise RuntimeError(f"expected {len(lengths)} PDBs, found {len(pdbs)}")
    for i, length in enumerate(lengths):
        angles = np.loadtxt(Path(out_dir, "sampled_angles", f"generated_{i}.csv.gz"), delimiter=",", skiprows=1, ndmin=2)
        if angles.shape != (length, 6):
            raise RuntimeError(f"generated_{i}: shape {angles.shape}, expected {(length, 6)}")
        if not (np.all(np.isfinite(angles)) and angles.min() >= -np.pi and angles.max() < np.pi):
            raise RuntimeError(f"generated_{i}: angles not finite in [-pi, pi)")

    seconds = result["sampling_seconds"]
    log(f"[5] slice on {card}: {len(lengths)} backbones, DDPM T={timesteps}, batch {BATCH}, bucket {BUCKET}, "
        f"{n_chunks} chunks, eager loop: sampling {seconds:.3f} s, {len(lengths) / seconds:.3f} backbones/s, "
        f"{seconds / (timesteps * n_chunks) * 1e3:.4f} ms per reverse step (mean over chunks); "
        f"CLI wall with loading and PDB writing {wall:.3f} s")
    return launched


def main() -> None:
    card = phase_card()
    phase_build()
    kernel = phase_kernel()
    phase_fixture()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        model_dir = str(Path(tmp, "flagship"))
        weights = model_io.init_random(FLAGSHIP, torch.Generator().manual_seed(SEED))
        mean_offset = np.random.default_rng(SEED).uniform(-np.pi, np.pi, 6)
        model_io.save_model_dir(model_dir, FLAGSHIP, weights.state_dict(), FLAGSHIP_TRAIN_ARGS, mean_offset)
        del weights
        phase_denoiser(model_dir)
        launches = phase_slice(model_dir, str(Path(tmp, "sampled")), card)

    log(json.dumps({"kernels": [{
        "name": "rel_attention_kernel (fused_attention_v2)",
        "route": "cuda",
        "source": "foldingdiff_tpu_torch/csrc/rel_attention.cu",
        "replaces": "foldingdiff_tpu/ops/pallas_attention.py:187",
        "launches": launches,
        **kernel,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
