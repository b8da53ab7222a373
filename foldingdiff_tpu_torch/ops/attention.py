"""
Fused BERT attention (counterpart of foldingdiff_tpu/ops/pallas_attention.py).

Two entries, as in the JAX package, each with a plain PyTorch version beside it:
- `fused_attention_v2` (the raw (2M-1, D) `relative_key` table, arange
  positions) launches the CUDA kernel of csrc/rel_attention.cu;
  `fused_attention_v2_reference` is its plain version.
- `fused_attention` (any gathered (L, L, D) tensor e_lr) launches the CUDA
  kernel of csrc/gathered_attention.cu; without e_lr it launches the v2
  kernel's rel-off instance of the same mode, which computes the same
  function (the JAX package's _attn_kernel and _attn_kernel_v2 do too).
  `fused_attention_reference` is its plain version, the einsums of the JAX
  package's attention_reference.
Both kernels read q, k and v in the projections' layout (strided (B, H, L, D)
views of (B, L, H, D) storage) and return such a view.

Each entry launches its kernel for CUDA tensors and runs its plain version
for CPU tensors. There is no fallback: a CUDA tensor the kernel does not take
raises, and so does a tensor on any other device.

Each entry takes the model's matmul mode (precision.py: "caller" or one of
precision.KERNEL_MODES), resolved on the host at the call by
precision.kernel_mode, and launches the kernel's instance that computes the
products of the JAX model's einsums in that mode:

| kernel mode | v2 instance (rel_attention.cu) | v1 instance (gathered_attention.cu), and its body |
| --- | --- | --- |
| "ieee" | "fma": float32 FMA | "fma": float32 FMA |
| "tf32" | "tf32": TF32 tensor cores | "tf32": TF32 tensor cores; resident |
| "bf16" | "bf16": bf16 values on bf16 tensor cores (TF32 ones in the chunked design), no dot's output rounded, the relative term float32 | "bf16": bf16 values on bf16 tensor cores in the resident body (16-bit operands, m16n8k16), TF32 ones in the chunked, no dot's output rounded, the relative term float32; resident |
| "tf32x3" | "tf32x3": 3 products of TF32 parts on TF32 tensor cores | "tf32x3": the same; resident |
| "bf16x3" | "bf16x3": 3 products of bf16 parts on bf16 tensor cores | "bf16x3": the same; chunked |
| "bf16x6" | "bf16x6": 6 products of bf16 parts on bf16 tensor cores | "bf16x6": the same; resident |
| "bf16x9" | "bf16x9": 9 products of bf16 parts on bf16 tensor cores | "bf16x9": the same; resident |
| "f64" | "f64": float64 products on the FP64 tensor cores (DMMA), each dot's output rounded to float32 | "f64": the same; resident |
| "f16" | "f16": f16 values on f16 tensor cores (TF32 ones in the chunked design), no dot's output rounded, the relative term float32 | "f16": f16 values on TF32 tensor cores; resident |
| "f16f16" | "f16f16": f16 values on f16 tensor cores (TF32 ones in the chunked design), each dot's output rounded to f16 | "f16f16": f16 values on TF32 tensor cores, each dot's output rounded to f16; resident |
| "bf16bf16" | "bf16bf16": bf16 values on bf16 tensor cores (TF32 ones in the chunked design), each dot's output rounded to bf16 | "bf16bf16": bf16 values on bf16 tensor cores in the resident body (16-bit operands, m16n8k16), TF32 ones in the chunked, each dot's output rounded to bf16; resident |

The v1 tensor-core instances run one of two bodies (csrc/gathered_attention.cu's
note): "resident" (persistent blocks, one pass over the keys, every row's
maximum and sum over all keys before P is rounded) at L <= 128 and D <= 32,
"chunked" (32-key chunks, a first pass over the keys for the row statistics
where P is rounded or split) beyond, and for bf16x3 at every length. The
f64 instances of both kernels run their kernel's resident design on the
FP64 tensor cores at L <= 128 and D <= 32, and float64 FMA on the CUDA
cores beyond. The v2 bf16, f16, f16f16 and bf16bf16 instances
and the v1 bf16 and bf16bf16 ones run their resident design on 16-bit
operands (m16n8k16) at L <= 128 and D <= 32, and the chunked design on TF32
tensor cores beyond (each source's note). Without e_lr, v1 runs the v2
column's instance.

The plain versions compute every product as precision.einsum does in the
mode: the preset's products of parts under "bf16", the 16-bit modes and the
multi-pass modes (under "f16f16" and "bf16bf16" each product's output
rounded on its own: q.k and q.E, then their sum), float64's under "f64",
float32 otherwise, at the caller's cuBLAS setting; softmax stays float32 in
all of them. No mode runs another mode's instance, and a build or launch
that fails raises.

Each kernel source is built with nvcc at first use, from the repository's
sources only, into `foldingdiff_tpu_torch/_build/`; the library name carries
a hash of the source, the shared headers and the flags, so an edited source
or flag set builds anew. The libraries have a plain C interface and are
loaded with ctypes. A source is built in parts (CudaLibrary.parts), one
library each: the same source compiled for a group of its instances and head
sizes (-DATTN_INSTANCES, -DATTN_HEAD_DIMS), so that the multi-pass
instances' long compiles run side by side. `build()` compiles every part
of several sources at once, one nvcc each.

`REL_ATTENTION.launches` and `GATHERED_ATTENTION.launches` count each
kernel's launches, so a run can show which kernel it went through,
`.rel_off_launches` the launches without relative scores and
`.launches_by_instance` those of each instance; nothing else changes them.
`fused_attention` without e_lr counts on REL_ATTENTION (its
`rel_off_launches`), whose kernel it launches: GATHERED_ATTENTION counts
only launches with relative scores.
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
    """One kernel source, csrc/<name>.cu, built into ctypes libraries whose
    C entry is <name>_forward and whose error text is <name>_error_string.
    The entry's last three arguments are the instance's index in
    `instances`, the device index and the stream; the instance "fma" runs
    the kernel <name>_kernel, any other <name>_<instance>_kernel. `parts`
    groups (instances, head sizes) into libraries of their own, built side
    by side; one part of everything by default."""

    def __init__(self, name: str, argtypes: Sequence, instances: Sequence[str] = ("fma",),
                 parts: Sequence[tuple] | None = None):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self.argtypes = list(argtypes)  # the entry's arguments before the instance, device and stream
        self.instances = tuple(instances)
        self.parts = tuple((tuple(i), tuple(d)) for i, d in parts) if parts else ((self.instances, HEAD_DIMS),)
        if sorted((i, d) for p in self.parts for i in p[0] for d in p[1]) != sorted(
                (i, d) for i in self.instances for d in HEAD_DIMS):
            raise ValueError(f"{name}: the parts must hold every (instance, head size) once")
        self.launches = 0
        self.rel_off_launches = 0  # of these, the instance without relative scores (HAS_REL false)
        self.launches_by_instance = dict.fromkeys(self.instances, 0)
        self._libs = None

    def kernel_name(self, instance: str) -> str:
        """The __global__ function of an instance, as the driver names its
        graph nodes (inside the mangled name)."""
        return f"{self.name}_kernel" if instance == "fma" else f"{self.name}_{instance}_kernel"

    def defines(self, part: int) -> list[str]:
        """nvcc's -D flags of a part: bit i of ATTN_INSTANCES for instance i,
        bit j of ATTN_HEAD_DIMS for HEAD_DIMS[j]."""
        instances, dims = self.parts[part]
        return [f"-DATTN_INSTANCES={sum(1 << self.instances.index(i) for i in instances):#x}",
                f"-DATTN_HEAD_DIMS={sum(1 << HEAD_DIMS.index(d) for d in dims):#x}"]

    def library_path(self, part: int = 0) -> Path:
        inputs = [self.source, *sorted(CSRC_DIR.glob("*.cuh"))]
        blob = b"".join(p.read_bytes() for p in inputs) + " ".join([*NVCC_FLAGS, *self.defines(part)]).encode()
        return BUILD_DIR / f"lib{self.name}_{hashlib.sha256(blob).hexdigest()[:16]}.so"

    def load(self) -> dict:
        """{(instance, head size): the loaded library of its part}, every
        part built first."""
        if self._libs is None:
            build([self])
            libs = {}
            for part, (instances, dims) in enumerate(self.parts):
                lib = ctypes.CDLL(str(self.library_path(part)))
                forward = getattr(lib, f"{self.name}_forward")
                forward.argtypes = [*self.argtypes, _int, _int, _ptr]
                forward.restype = _int
                error_string = getattr(lib, f"{self.name}_error_string")
                error_string.argtypes = [_int]
                error_string.restype = ctypes.c_char_p
                libs.update({(i, d): lib for i in instances for d in dims})
            self._libs = libs
        return self._libs

    def launch(self, what: str, has_rel: bool, instance: str, device: torch.device, d: int, *args) -> None:
        """Call the C entry of the part holding (instance, head size d) with
        args, the instance, the device and its current stream; raise on a
        non-zero cudaError_t; count the launch (the rel-off and each
        instance's apart)."""
        lib = self.load()[instance, d]
        err = getattr(lib, f"{self.name}_forward")(
            *args, self.instances.index(instance), device.index, torch.cuda.current_stream(device).cuda_stream)
        if err:
            msg = getattr(lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name} launch failed ({what}, {instance}): {msg}")
        self.launches += 1
        self.rel_off_launches += not has_rel
        self.launches_by_instance[instance] += 1


# Each kernel's instances in the order of its C `instance` index: 0 FMA, 1 TF32, 2 bf16, 3-6 the multi-pass
# modes, 7 f64, 8-10 the 16-bit modes f16, f16f16 and bf16bf16 (precision.KERNEL_MODES' order)
INSTANCES = ("fma", "tf32", "bf16", "tf32x3", "bf16x3", "bf16x6", "bf16x9", "f64", "f16", "f16f16", "bf16bf16")
# The parts each source is built in, side by side: FMA and TF32 together,
# each multi-pass instance of v2 apart and its flagship head size apart from
# the other two, v1's tf32x3 and bf16x3 apart and its bf16x6 and bf16x9
# together; v2's bf16, f64 and f16 each apart and its output-rounding pair
# together; v1's f64 with f16, f16f16 apart, and bf16 with bf16bf16 (the two
# instances of its 16-bit-plane body).
# On an 8-core H100 host both sources (seven instances) built in 145 s as
# one nvcc each, 77 s with --split-compile=0, 166 s with
# --split-compile-extended=0, and 39 s as 12 parts (scripts/nvcc_build_forms.py).
# A part's SASS text is padded to its widest instruction: v1's bf16x3 built
# beside tf32x3's resident kernels read the same instructions one column
# wider (scripts/sass_two_trees.py compares the text)
_MULTI_PASS = INSTANCES[3:7]
# (q, k, v, bias, table, out, batch, head and row strides of q, k and v, B, H, L, D, M, has_rel), then the
# instance, device and stream
REL_ATTENTION = CudaLibrary(
    "rel_attention", [_ptr] * 6 + [ctypes.c_longlong] * 3 + [_int] * 6, INSTANCES,
    [(("fma", "tf32"), HEAD_DIMS), (("bf16",), HEAD_DIMS), (("f64",), HEAD_DIMS), (("f16",), HEAD_DIMS),
     (("f16f16", "bf16bf16"), HEAD_DIMS)]
    + [((i,), dims) for i in _MULTI_PASS for dims in ((32,), (16, 64))])
# (q, k, v, bias, e_lr, out, batch, head and row strides of q, k and v, B, H, L, D), then the instance, device
# and stream
GATHERED_ATTENTION = CudaLibrary("gathered_attention", [_ptr] * 6 + [ctypes.c_longlong] * 3 + [_int] * 4, INSTANCES,
                                 [(("fma", "tf32"), HEAD_DIMS), (("f64", "f16"), HEAD_DIMS), (("f16f16",), HEAD_DIMS),
                                  (("bf16", "bf16bf16"), HEAD_DIMS), (_MULTI_PASS[:1], HEAD_DIMS),
                                  (_MULTI_PASS[1:2], HEAD_DIMS), (_MULTI_PASS[2:], HEAD_DIMS)])
LIBRARIES = (REL_ATTENTION, GATHERED_ATTENTION)
# kernel mode (precision.kernel_mode) -> the instance each kernel runs in it
V2_INSTANCES = {"ieee": "fma", **{mode: mode for mode in precision.KERNEL_MODES[1:]}}
V1_INSTANCES = dict(V2_INSTANCES)


def fused_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_bias: torch.Tensor,
    e_lr: torch.Tensor | None = None,
    key_term: bool = False,
    dropout_p: float = 0.0,
    mode: str = "caller",
) -> torch.Tensor:
    """Plain PyTorch version: the einsums of the JAX package's attention_reference.
    key_term adds k[r] . e_lr[l, r] as well: the relative_key_query scores,
    which the denoiser runs on this plain path only, as the JAX package does.
    dropout_p drops attention probabilities, as the denoiser's train mode
    does (JAX's bert.py:186); the kernels' plain versions leave it 0. Every
    einsum runs in the model's `mode` (precision.einsum): under "bf16" and
    the multi-pass modes the preset's products of parts with a float32
    output, as a model at that matmul_precision computes them; the softmax
    stays float32. Under "f16f16" and "bf16bf16" each product's output is
    rounded on its own, q.k and q.e_lr before their sum, as the JAX einsums
    at those presets round them."""

    def einsum(eq, a, b):
        return precision.einsum(eq, a, b, mode)

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

    The kernel reads q, k and v in any layout whose last dimension has
    stride 1 and whose rows start on 16 bytes, such as the
    `.view(B, L, H, D).transpose(1, 2)` of the projections, and returns a
    (B, H, L, D) view of a contiguous (B, L, H, D) buffer, as
    fused_attention_v2 does. It reads e_lr contiguous, as the denoiser's
    gather writes it; a view in another layout is copied here first.
    Without e_lr this is fused_attention_v2 without a table: the v2 kernel's
    rel-off instance, counted on REL_ATTENTION.
    """
    kernel_mode = precision.kernel_mode(mode)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, mask_bias, e_lr, mode=kernel_mode)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention takes CPU or CUDA tensors, got {q.device}")
    if e_lr is None:
        return fused_attention_v2(q, k, v, mask_bias, mode=mode)
    b, h, l, d, e_lr = _check_gathered_inputs(q, k, v, mask_bias, e_lr)
    out = torch.empty(b, l, h, d, device=q.device)
    sb, sh, sl, _ = q.stride()
    GATHERED_ATTENTION.launch(
        f"B={b} H={h} L={l} D={d}", True, V1_INSTANCES[kernel_mode], q.device, d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_bias.data_ptr(), e_lr.data_ptr(), out.data_ptr(),
        sb, sh, sl, b, h, l, d,
    )
    return out.transpose(1, 2)


def _check_gathered_inputs(q, k, v, mask_bias, e_lr):
    """The v1 kernel's host-side checks: _check_inputs' (strided q, k and v)
    and e_lr's device, dtype and (L, L, D) shape; returns (B, H, L, D) and
    e_lr contiguous (a view in another layout copied), 16-byte aligned."""
    b, h, l, d = _check_inputs(q, k, v, mask_bias)
    if e_lr.shape != (l, l, d):
        raise ValueError(f"e_lr must be {(l, l, d)}, got {tuple(e_lr.shape)}")
    _check_tensor("e_lr", e_lr, q.device)
    e_lr = e_lr.contiguous()
    if e_lr.data_ptr() % 16:
        raise ValueError("e_lr must start on a 16-byte boundary (the kernel copies it in 16-byte pieces)")
    if b * h * -(-l // 16) > 2**31 - 1:
        raise ValueError(f"B={b} H={h} L={l} exceeds the kernel's grid limit of 2^31 - 1 blocks")
    if q.stride(2) * l > 2**31 - 1:
        raise ValueError(f"a row stride of {q.stride(2)} floats over L={l} rows exceeds the kernel's 32-bit "
                         "row offsets")
    return b, h, l, d, e_lr


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
    fused_attention_reference in `mode`."""
    e_lr = None
    if rel_table is not None:
        pos = torch.arange(q.shape[2], device=q.device)
        e_lr = rel_table[pos[:, None] - pos[None, :] + m - 1]  # (L, L, D)
    return fused_attention_reference(q, k, v, mask_bias, e_lr, mode=mode)


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
    b, h, l, d = _check_inputs(q, k, v, mask_bias)
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
        f"B={b} H={h} L={l} D={d}", has_rel, V2_INSTANCES[kernel_mode], q.device, d,
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


def _check_inputs(q, k, v, mask_bias):
    """Checks shared by both kernels: device, dtype, layout and shapes of q,
    k, v and the bias, and the head size. q, k and v share any strides whose
    last is 1 and whose rows start on 16 bytes; the bias is contiguous. Kept
    lean: the sampler's small chunks are bound by the host."""
    device = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("mask_bias", mask_bias)):
        _check_tensor(name, t, device)
    if not mask_bias.is_contiguous():
        raise ValueError("mask_bias must be contiguous")
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
    Compile each part of each library whose source and flag set is not
    built yet, one nvcc per part, all started together. Returns {name: the
    compiler's output of its parts (ptxas register and shared-memory
    report)}, "" for a library whose parts all existed. Raises if any build
    fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for lib in libraries:
        for part in range(len(lib.parts)):
            path = lib.library_path(part)
            if path.is_file():
                continue
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, *lib.defines(part), "-o", str(tmp), str(lib.source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running.append((lib.name, proc, cmd, tmp, path))
    reports = {lib.name: "" for lib in libraries}
    failures = []
    for name, proc, cmd, tmp, path in running:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({' '.join(cmd)}):\n{output}")
            continue
        os.replace(tmp, path)
        reports[name] += output
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports
