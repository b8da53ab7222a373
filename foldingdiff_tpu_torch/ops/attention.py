"""
Fused BERT attention with `relative_key` scores
(counterpart of foldingdiff_tpu/ops/pallas_attention.py:fused_attention_v2).

`fused_attention_v2` launches the hand-written CUDA kernel of
csrc/rel_attention.cu for CUDA tensors and runs the plain PyTorch version,
`fused_attention_v2_reference`, for CPU tensors. There is no fallback: a CUDA
tensor the kernel does not take raises.

The kernel is built with nvcc at first use, from the repository's source only,
into `foldingdiff_tpu_torch/_build/`; the library name carries a hash of the
source and the flags, so an edited source or flag set builds anew. It has a
plain C interface and is loaded with ctypes.

`launches` counts kernel launches, so a run can show that it went through
the kernel; nothing else changes it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "rel_attention.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIMS = (16, 32, 64)  # D values the kernel is instantiated for

launches = 0
_lib = None


def fused_attention_v2_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_bias: torch.Tensor,
    rel_table: torch.Tensor | None = None,
    m: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: gather e_lr = table[l - r + M - 1] and run the
    einsums of the JAX package's attention_reference."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bhld,bhmd->bhlm", q, k)
    if rel_table is not None:
        pos = torch.arange(q.shape[2], device=q.device)
        e_lr = rel_table[pos[:, None] - pos[None, :] + m - 1]  # (L, L, D)
        scores = scores + torch.einsum("bhld,lrd->bhlr", q, e_lr)
    scores = scores * scale + mask_bias[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhlm,bhmd->bhld", probs, v)


def fused_attention_v2(
    q: torch.Tensor,  # (B, H, L, D)
    k: torch.Tensor,
    v: torch.Tensor,
    mask_bias: torch.Tensor,  # (B, L) additive bias per key (-10000 masked)
    rel_table: torch.Tensor | None = None,  # (2M-1, D) distance embedding table
    m: int | None = None,  # max_position_embeddings
) -> torch.Tensor:
    """
    softmax((q k^T + rel) / sqrt(D) + mask_bias) v with the HF relative_key
    term rel[l, j] = q[l] . rel_table[l - j + m - 1] (omitted when rel_table
    is None). Forward only: the kernel records no autograd graph.
    """
    if q.device.type == "cpu":
        return fused_attention_v2_reference(q, k, v, mask_bias, rel_table, m)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_v2 takes CPU or CUDA tensors, got {q.device}")
    b, h, l, d = _check_inputs(q, k, v, mask_bias, rel_table, m)
    has_rel = rel_table is not None
    out = torch.empty_like(q)
    err = load_library().rel_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_bias.data_ptr(),
        rel_table.data_ptr() if has_rel else None, out.data_ptr(),
        b, h, l, d, m if has_rel else l, int(has_rel), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"rel_attention launch failed (B={b} H={h} L={l} D={d}): "
            f"{_lib.rel_attention_error_string(err).decode()}"
        )
    global launches
    launches += 1
    return out


def _check_inputs(q, k, v, mask_bias, rel_table, m):
    tensors = {"q": q, "k": k, "v": v, "mask_bias": mask_bias}
    if rel_table is not None:
        tensors["rel_table"] = rel_table
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise RuntimeError("the attention kernel is forward-only; call it under torch.inference_mode()")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, D), got {tuple(q.shape)}")
    b, h, l, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if mask_bias.shape != (b, l):
        raise ValueError(f"mask_bias must be {(b, l)}, got {tuple(mask_bias.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} not in the kernel's {HEAD_DIMS}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit of 65535")
    if rel_table is not None:
        if m is None or rel_table.shape != (2 * m - 1, d):
            raise ValueError(f"rel_table must be (2m-1, {d}) with m given, got {tuple(rel_table.shape)}, m={m}")
        if l > m:
            raise ValueError(f"sequence length {l} exceeds max_position_embeddings {m}")
    return b, h, l, d


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise FileNotFoundError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librel_attention_{digest}.so"


def build() -> str:
    """Compile the kernel library unless this source and flag set is built.
    Returns the compiler's output (ptxas register and shared-memory report),
    or "" when the library already existed."""
    path = library_path()
    if path.is_file():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        ptr = ctypes.c_void_p
        lib.rel_attention_forward.argtypes = [ptr] * 6 + [ctypes.c_int] * 7 + [ptr]
        lib.rel_attention_forward.restype = ctypes.c_int
        lib.rel_attention_error_string.argtypes = [ctypes.c_int]
        lib.rel_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
