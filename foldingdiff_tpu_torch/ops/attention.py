"""
Fused BERT attention (counterpart of foldingdiff_tpu/ops/pallas_attention.py).

Two entries, as in the JAX package, each with a plain PyTorch version beside it:
- `fused_attention_v2` (the raw (2M-1, D) `relative_key` table, arange
  positions) launches the CUDA kernel of csrc/rel_attention.cu, which reads
  q, k and v in the projections' layout (strided (B, H, L, D) views of
  (B, L, H, D) storage) and returns such a view; `fused_attention_v2_reference`
  is its plain version.
- `fused_attention` (any gathered (L, L, D) tensor e_lr) launches the CUDA
  kernel of csrc/gathered_attention.cu; `fused_attention_reference` is its
  plain version, the einsums of the JAX package's attention_reference.

Each entry launches its kernel for CUDA tensors and runs its plain version
for CPU tensors. There is no fallback: a CUDA tensor the kernel does not take
raises, and so does a tensor on any other device.

Each entry takes the model's matmul mode (precision.py: "caller", "ieee",
"tf32", "bf16"), resolved on the host at the call by precision.kernel_mode,
and launches the kernel's instance that computes the products of the JAX
model's einsums in that mode:

| kernel mode | v2 instance (rel_attention.cu) | v1 instance (gathered_attention.cu) |
| --- | --- | --- |
| "ieee" | "fma": float32 FMA | "fma": float32 FMA |
| "tf32" | "tf32": TF32 tensor cores | "tf32": TF32 tensor cores |
| "bf16" | "bf16": bf16 values on TF32 tensor cores | "bf16": bf16 values on TF32 tensor cores |

The plain versions compute every product on bf16-rounded operands under
"bf16" (precision.bf16_einsum) and in float32 otherwise, at the caller's
cuBLAS setting; softmax stays float32 in both.

Each kernel source is built with nvcc at first use, from the repository's
sources only, into `foldingdiff_tpu_torch/_build/`; the library name carries
a hash of the source, the shared headers and the flags, so an edited source
or flag set builds anew. The libraries have a plain C interface and are
loaded with ctypes. `build()` compiles several at once, one nvcc each.

`REL_ATTENTION.launches` and `GATHERED_ATTENTION.launches` count each
kernel's launches, so a run can show which kernel it went through,
`.rel_off_launches` the launches without relative scores and
`.launches_by_instance` those of each instance; nothing else changes them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

from foldingdiff_tpu_torch import precision

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIMS = (16, 32, 64)  # D values the kernels are instantiated for

_ptr, _int = ctypes.c_void_p, ctypes.c_int


class CudaLibrary:
    """One kernel source, csrc/<name>.cu, built into a ctypes library whose
    C entry is <name>_forward and whose error text is <name>_error_string.
    The entry's last three arguments are the instance's index in
    `instances`, the device index and the stream; the instance "fma" runs
    the kernel <name>_kernel, any other <name>_<instance>_kernel."""

    def __init__(self, name: str, argtypes: Sequence, instances: Sequence[str] = ("fma",)):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self.argtypes = list(argtypes)  # the entry's arguments before the instance, device and stream
        self.instances = tuple(instances)
        self.launches = 0
        self.rel_off_launches = 0  # of these, the instance without relative scores (HAS_REL false)
        self.launches_by_instance = dict.fromkeys(self.instances, 0)
        self._lib = None

    def kernel_name(self, instance: str) -> str:
        """The __global__ function of an instance, as the driver names its
        graph nodes (inside the mangled name)."""
        return f"{self.name}_kernel" if instance == "fma" else f"{self.name}_{instance}_kernel"

    def library_path(self) -> Path:
        inputs = [self.source, *sorted(CSRC_DIR.glob("*.cuh"))]
        blob = b"".join(p.read_bytes() for p in inputs) + " ".join(NVCC_FLAGS).encode()
        return BUILD_DIR / f"lib{self.name}_{hashlib.sha256(blob).hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            build([self])
            lib = ctypes.CDLL(str(self.library_path()))
            forward = getattr(lib, f"{self.name}_forward")
            forward.argtypes = [*self.argtypes, _int, _int, _ptr]
            forward.restype = _int
            error_string = getattr(lib, f"{self.name}_error_string")
            error_string.argtypes = [_int]
            error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, what: str, has_rel: bool, instance: str, device: torch.device, *args) -> None:
        """Call the C entry with args, the instance, the device and its
        current stream; raise on a non-zero cudaError_t; count the launch
        (the rel-off and each instance's apart)."""
        lib = self.load()
        err = getattr(lib, f"{self.name}_forward")(
            *args, self.instances.index(instance), device.index, torch.cuda.current_stream(device).cuda_stream)
        if err:
            msg = getattr(lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name} launch failed ({what}, {instance}): {msg}")
        self.launches += 1
        self.rel_off_launches += not has_rel
        self.launches_by_instance[instance] += 1


# (q, k, v, bias, table, out, batch, head and row strides of q, k and v, B, H, L, D, M, has_rel), then the
# instance, device and stream
REL_ATTENTION = CudaLibrary("rel_attention", [_ptr] * 6 + [ctypes.c_longlong] * 3 + [_int] * 6,
                            ("fma", "tf32", "bf16"))
# (q, k, v, bias, e_lr, out, B, H, L, D, has_rel), then the instance, device and stream
GATHERED_ATTENTION = CudaLibrary("gathered_attention", [_ptr] * 6 + [_int] * 5, ("fma", "tf32", "bf16"))
LIBRARIES = (REL_ATTENTION, GATHERED_ATTENTION)
# kernel mode (precision.kernel_mode) -> the instance each kernel runs in it
V2_INSTANCES = {"ieee": "fma", "tf32": "tf32", "bf16": "bf16"}
V1_INSTANCES = {"ieee": "fma", "tf32": "tf32", "bf16": "bf16"}


def fused_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_bias: torch.Tensor,
    e_lr: torch.Tensor | None = None,
    key_term: bool = False,
    dropout_p: float = 0.0,
    bf16: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version: the einsums of the JAX package's attention_reference.
    key_term adds k[r] . e_lr[l, r] as well: the relative_key_query scores,
    which the denoiser runs on this plain path only, as the JAX package does.
    dropout_p drops attention probabilities, as the denoiser's train mode
    does (JAX's bert.py:186); the kernels' plain versions leave it 0. bf16
    takes every einsum on bf16 operands with a float32 output, as a model
    at matmul_precision "BF16_BF16_F32" does (precision.bf16_einsum); the
    softmax stays float32."""
    einsum = precision.bf16_einsum if bf16 else torch.einsum
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = einsum("bhld,bhmd->bhlm", q, k)
    if e_lr is not None:
        scores = scores + einsum("bhld,lrd->bhlr", q, e_lr)
        if key_term:
            scores = scores + einsum("bhrd,lrd->bhlr", k, e_lr)
    scores = scores * scale + mask_bias[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    if dropout_p:
        probs = torch.nn.functional.dropout(probs, dropout_p)
    return einsum("bhlm,bhmd->bhld", probs, v)


def fused_attention(
    q: torch.Tensor,  # (B, H, L, D)
    k: torch.Tensor,
    v: torch.Tensor,
    mask_bias: torch.Tensor,  # (B, L) additive bias per key (-10000 masked)
    e_lr: torch.Tensor | None = None,  # (L, L, D) gathered distance embeddings
    mode: str = "caller",  # the model's matmul mode (precision.py)
) -> torch.Tensor:
    """
    softmax((q k^T + rel) / sqrt(D) + mask_bias) v with rel[l, j] =
    q[l] . e_lr[l, j] (omitted when e_lr is None), e_lr any (L, L, D) tensor,
    each product in `mode` (the module docstring's table). Forward only: the
    kernel records no autograd graph.

    The kernel reads e_lr contiguous, as the denoiser's gather writes it; a
    view in another layout is copied here first.
    """
    kernel_mode = precision.kernel_mode(mode)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, mask_bias, e_lr, bf16=kernel_mode == "bf16")
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention takes CPU or CUDA tensors, got {q.device}")
    b, h, l, d = _check_inputs(q, k, v, mask_bias)
    if e_lr is not None:
        if e_lr.shape != (l, l, d):
            raise ValueError(f"e_lr must be {(l, l, d)}, got {tuple(e_lr.shape)}")
        _check_tensor("e_lr", e_lr, q.device)
        e_lr = e_lr.contiguous()
    for name, t in {"q": q, "k": k, "v": v, "e_lr": e_lr}.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel copies it in 16-byte pieces)")
    out = torch.empty_like(q)
    GATHERED_ATTENTION.launch(
        f"B={b} H={h} L={l} D={d}", e_lr is not None, V1_INSTANCES[kernel_mode], q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_bias.data_ptr(),
        e_lr.data_ptr() if e_lr is not None else None, out.data_ptr(),
        b, h, l, d, int(e_lr is not None),
    )
    return out


def fused_attention_v2_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_bias: torch.Tensor,
    rel_table: torch.Tensor | None = None,
    m: int | None = None,
    mode: str = "caller",
) -> torch.Tensor:
    """Plain PyTorch version: gather e_lr = table[l - r + M - 1] and run
    fused_attention_reference, on bf16 operands where `mode` is "bf16"."""
    e_lr = None
    if rel_table is not None:
        pos = torch.arange(q.shape[2], device=q.device)
        e_lr = rel_table[pos[:, None] - pos[None, :] + m - 1]  # (L, L, D)
    return fused_attention_reference(q, k, v, mask_bias, e_lr, bf16=precision.kernel_mode(mode) == "bf16")


def fused_attention_v2(
    q: torch.Tensor,  # (B, H, L, D)
    k: torch.Tensor,
    v: torch.Tensor,
    mask_bias: torch.Tensor,  # (B, L) additive bias per key (-10000 masked)
    rel_table: torch.Tensor | None = None,  # (2M-1, D) distance embedding table
    m: int | None = None,  # max_position_embeddings
    mode: str = "caller",  # the model's matmul mode (precision.py)
) -> torch.Tensor:
    """
    softmax((q k^T + rel) / sqrt(D) + mask_bias) v with the HF relative_key
    term rel[l, j] = q[l] . rel_table[l - j + m - 1] (omitted when rel_table
    is None), each product in `mode` (the module docstring's table). Forward
    only: the kernel records no autograd graph.

    The kernel reads q, k and v in any layout whose last dimension has
    stride 1 and whose rows start on 16 bytes, such as the
    `.view(B, L, H, D).transpose(1, 2)` of the projections, and returns a
    (B, H, L, D) view of a contiguous (B, L, H, D) buffer, so that the
    caller's transpose back to (B, L, H * D) is free. Other layouts raise;
    nothing is copied.
    """
    kernel_mode = precision.kernel_mode(mode)
    if q.device.type == "cpu":
        return fused_attention_v2_reference(q, k, v, mask_bias, rel_table, m, kernel_mode)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_v2 takes CPU or CUDA tensors, got {q.device}")
    b, h, l, d = _check_inputs(q, k, v, mask_bias, strided=True)
    has_rel = rel_table is not None
    if has_rel:
        _check_tensor("rel_table", rel_table, q.device)
        if not rel_table.is_contiguous() or rel_table.data_ptr() % 16:
            raise ValueError("rel_table must be contiguous and start on a 16-byte boundary")
        if m is None or rel_table.shape != (2 * m - 1, d):
            raise ValueError(f"rel_table must be (2m-1, {d}) with m given, got {tuple(rel_table.shape)}, m={m}")
        if l > m:
            raise ValueError(f"sequence length {l} exceeds max_position_embeddings {m}")
    if b * h * -(-l // 64) > 2**31 - 1:
        raise ValueError(f"B={b} H={h} L={l} exceeds the kernel's grid limit of 2^31 - 1 blocks")
    out = torch.empty(b, l, h, d, device=q.device)
    sb, sh, sl, _ = q.stride()
    REL_ATTENTION.launch(
        f"B={b} H={h} L={l} D={d}", has_rel, V2_INSTANCES[kernel_mode], q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_bias.data_ptr(),
        rel_table.data_ptr() if has_rel else None, out.data_ptr(), sb, sh, sl,
        b, h, l, d, m if has_rel else l, int(has_rel),
    )
    return out.transpose(1, 2)


def _check_tensor(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError("the attention kernels are forward-only; call them under torch.inference_mode()")


def _check_inputs(q, k, v, mask_bias, strided: bool = False):
    """Checks shared by both kernels: device, dtype, layout and shapes of q,
    k, v and the bias, and the head size. The v1 kernel takes contiguous q,
    k, v. With `strided` (the v2 kernel) q, k and v share any strides whose
    last is 1 and whose rows start on 16 bytes. Kept lean: the sampler's
    small chunks are bound by the host."""
    device = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("mask_bias", mask_bias)):
        _check_tensor(name, t, device)
        if (t is mask_bias or not strided) and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, D), got {tuple(q.shape)}")
    shape = q.shape
    b, h, l, d = shape
    if k.shape != shape or v.shape != shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if mask_bias.shape != (b, l):
        raise ValueError(f"mask_bias must be {(b, l)}, got {tuple(mask_bias.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} not in the kernel's {HEAD_DIMS}")
    if not strided:
        return b, h, l, d
    st = q.stride()
    if k.stride() != st or v.stride() != st:
        raise ValueError(f"q, k and v must share strides, got {st} {k.stride()} {v.stride()}")
    if st[3] != 1:
        raise ValueError(f"q, k and v must have a last-dimension stride of 1, got strides {st}")
    if (st[0] | st[1] | st[2]) & 3 or (q.data_ptr() | k.data_ptr() | v.data_ptr()) & 15:
        raise ValueError(f"every row of q, k and v must start on a 16-byte boundary "
                         f"(the kernel copies rows in 16-byte pieces); strides {st}")
    return b, h, l, d


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise FileNotFoundError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(libraries: Sequence[CudaLibrary] = LIBRARIES) -> Dict[str, str]:
    """
    Compile each library whose source and flag set is not built yet, one
    nvcc per source, all started together. Returns {name: the compiler's
    output (ptxas register and shared-memory report)}, "" for a library that
    already existed. Raises if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for lib in libraries:
        path = lib.library_path()
        if path.is_file():
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(lib.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[lib.name] = (proc, cmd, tmp, path)
    reports = {lib.name: "" for lib in libraries}
    failures = []
    for name, (proc, cmd, tmp, path) in running.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({' '.join(cmd)}):\n{output}")
            continue
        os.replace(tmp, path)
        reports[name] = output
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports
