"""
The port's fused_attention_v2 and fused_attention (ops/attention.py) against
the JAX package's Pallas entries (interpret mode on the CPU) and its jnp
reference, as tests/test_pallas_attention.py runs them. On a CPU tensor the
port runs each entry's plain PyTorch version; the CUDA kernels are compared
with those versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
The kernels' build (one nvcc per source, started together) is checked here
with a stand-in for nvcc.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldingdiff_tpu.ops.pallas_attention import attention_reference
from foldingdiff_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from foldingdiff_tpu.ops.pallas_attention import fused_attention_v2 as jax_fused_attention_v2
from foldingdiff_tpu_torch.ops import attention


def _inputs(b, h, l, d, m, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(3))
    lengths = rng.integers(l // 2, l + 1, size=b)
    bias = np.where(np.arange(l)[None, :] < lengths[:, None], 0.0, -10000.0).astype(np.float32)
    table = (rng.normal(size=(2 * m - 1, d)) * 0.5).astype(np.float32)
    return q, k, v, bias, table


def _gathered(table, l, m):
    pos = np.arange(l)
    return table[pos[:, None] - pos[None, :] + m - 1]


# (L, M, D, rel): L == M and L < M windows, a ragged length, no rel; D = 16 and 32
CASES = [(64, 64, 16, True), (32, 64, 16, True), (50, 64, 32, True), (64, 64, 32, False), (33, 64, 16, False)]


@pytest.mark.parametrize("l,m,d,rel", CASES)
def test_plain_matches_jax_pallas_and_reference(l, m, d, rel):
    q, k, v, bias, table = _inputs(2, 4, l, d, m, seed=l + d)
    m_arg = m if rel else None
    with jax.default_matmul_precision("highest"):
        jq, jk, jv, jb = map(jnp.asarray, (q, k, v, bias))
        pallas = jax_fused_attention_v2(jq, jk, jv, jb, jnp.asarray(table) if rel else None, m=m_arg,
                                        interpret=True)
        ref = attention_reference(jq, jk, jv, jb, jnp.asarray(_gathered(table, l, m)) if rel else None)
    ours = attention.fused_attention_v2(*map(torch.from_numpy, (q, k, v, bias)),
                                        torch.from_numpy(table) if rel else None, m_arg)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_masked_keys_do_not_change_output():
    q, k, v, bias, table = map(torch.from_numpy, _inputs(3, 4, 48, 16, 64, seed=5))
    masked = (bias < -1.0)[:, None, :, None]
    out1 = attention.fused_attention_v2(q, k, v, bias, rel_table=table, m=64)
    out2 = attention.fused_attention_v2(q, k + 7.0 * masked, v - 3.0 * masked, bias, rel_table=table, m=64)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)


def _projection_views(q, k, v):
    """q, k, v (B, H, L, D) as the denoiser hands them to the v2 kernel: views
    of (B, L, H * D) buffers, `.view(B, L, H, D).transpose(1, 2)`."""
    b, h, l, d = q.shape
    return [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).view(b, l, h * d)
            .view(b, l, h, d).transpose(1, 2) for x in (q, k, v)]


@pytest.mark.parametrize("rel", [True, False])
def test_v2_on_projection_views_equals_the_contiguous_call(rel):
    q, k, v, bias, table = _inputs(2, 3, 50, 32, 64, seed=9)
    kw = dict(rel_table=torch.from_numpy(table), m=64) if rel else {}
    views = _projection_views(q, k, v)
    assert not views[0].is_contiguous() and views[0].stride() == (50 * 3 * 32, 32, 3 * 32, 1)
    ours = attention.fused_attention_v2(*views, torch.from_numpy(bias), **kw)
    ref = attention.fused_attention_v2(*map(torch.from_numpy, (q, k, v, bias)), **kw)
    torch.testing.assert_close(ours, ref, rtol=0, atol=1e-6)


def test_v2_layout_checks():
    """What the v2 kernel takes, checked on the host before any launch:
    strided views whose last stride is 1 and whose rows start on 16 bytes."""
    q, k, v, bias, _ = _inputs(2, 3, 16, 32, 16, seed=10)
    views = _projection_views(q, k, v)
    bias = torch.from_numpy(bias)
    assert attention._check_inputs(*views, bias, strided=True) == (2, 3, 16, 32)
    with pytest.raises(ValueError, match="contiguous"):  # the v1 kernel takes contiguous q, k, v only
        attention._check_inputs(*views, bias)
    wide = torch.zeros(2, 3, 16, 64)[..., ::2]  # last-dimension stride 2
    with pytest.raises(ValueError, match="last-dimension stride of 1"):
        attention._check_inputs(wide, wide, wide, bias, strided=True)
    with pytest.raises(ValueError, match="share strides"):
        attention._check_inputs(wide, *views[1:], bias, strided=True)
    shifted = torch.zeros(2 * 16 * 3 * 32 + 1)[1:].view(2, 16, 3, 32).transpose(1, 2)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        attention._check_inputs(views[0], shifted, views[2], bias, strided=True)
    odd_rows = torch.zeros(2, 16, 3, 34)[..., :32].transpose(1, 2)  # rows 34 floats apart
    with pytest.raises(ValueError, match="16-byte"):
        attention._check_inputs(odd_rows, odd_rows, odd_rows, bias, strided=True)
    with pytest.raises(ValueError, match="mask_bias must be contiguous"):
        attention._check_inputs(*views, torch.zeros(16, 2).t(), strided=True)


def _v1_inputs(seed, masked=True, b=4, h=6, l=64, d=16):
    """tests/test_pallas_attention.py's inputs: e_lr random normal (L, L, D) * 0.05, not Toeplitz."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(3))
    if masked:
        lengths = rng.integers(l // 2, l + 1, size=b)
        bias = np.where(np.arange(l)[None, :] < lengths[:, None], 0.0, -10000.0).astype(np.float32)
    else:
        bias = np.zeros((b, l), dtype=np.float32)
    e_lr = (rng.normal(size=(l, l, d)) * 0.05).astype(np.float32)
    return q, k, v, bias, e_lr


def _permuted_e_lr(l, d, m, seed):
    """e_lr gathered from a distance table through a permutation of arange(L), L <= M."""
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=(2 * m - 1, d)) * 0.5).astype(np.float32)
    pos = rng.permutation(l)
    return table[pos[:, None] - pos[None, :] + m - 1]


# e_lr: none; random (JAX's with_rel case, seed 3); gathered from permuted
# positions; and the JAX no_rel case (seed 0)
V1_CASES = [("random", 3, True), ("permuted", 4, True), ("random", 6, False), (None, 0, True)]


@pytest.mark.parametrize("e_lr_kind,seed,masked", V1_CASES)
def test_v1_plain_matches_jax_pallas_and_reference(e_lr_kind, seed, masked):
    q, k, v, bias, e_lr = _v1_inputs(seed, masked)
    if e_lr_kind == "permuted":
        e_lr = _permuted_e_lr(64, 16, 64, seed)
    elif e_lr_kind is None:
        e_lr = None
    with jax.default_matmul_precision("highest"):
        jargs = [jnp.asarray(a) for a in (q, k, v, bias)] + [jnp.asarray(e_lr) if e_lr is not None else None]
        pallas = jax_fused_attention(*jargs, interpret=True)
        ref = attention_reference(*jargs)
    ours = attention.fused_attention(*map(torch.from_numpy, (q, k, v, bias)),
                                     torch.from_numpy(e_lr) if e_lr is not None else None)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("e_lr_kind,seed,masked", V1_CASES)
def test_v1_at_tf32_on_cpu_tensors_runs_the_plain_version(e_lr_kind, seed, masked):
    """mode "tf32" picks the v1 kernel's TF32 instance on the card; on CPU
    tensors the entry runs the plain version, launches nothing, and agrees
    with the JAX package's Pallas entry in interpret mode."""
    q, k, v, bias, e_lr = _v1_inputs(seed, masked)
    if e_lr_kind == "permuted":
        e_lr = _permuted_e_lr(64, 16, 64, seed)
    elif e_lr_kind is None:
        e_lr = None
    with jax.default_matmul_precision("highest"):
        pallas = jax_fused_attention(*[jnp.asarray(a) for a in (q, k, v, bias)],
                                     jnp.asarray(e_lr) if e_lr is not None else None, interpret=True)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)] + [torch.from_numpy(e_lr) if e_lr is not None else None]
    before = dict(attention.GATHERED_ATTENTION.launches_by_instance)
    ours = attention.fused_attention(*args, mode="tf32")
    assert attention.GATHERED_ATTENTION.launches_by_instance == before
    torch.testing.assert_close(ours, attention.fused_attention_reference(*args), rtol=0, atol=0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), atol=1e-5)


def _instance_table() -> dict:
    """{kernel mode: (v2 instance, v1 instance)} from the table of
    ops/attention.py's docstring."""
    rows = {}
    for line in attention.__doc__.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) == 3 and cells[0].startswith('"'):
            rows[cells[0].strip('"')] = tuple(c.split('"')[1] for c in cells[1:])
    return rows


@pytest.mark.parametrize("mode", ["ieee", "tf32", "bf16"])
def test_instance_maps_are_the_docstring_table(mode):
    table = _instance_table()
    assert set(table) == set(attention.V2_INSTANCES) == set(attention.V1_INSTANCES)
    assert (attention.V2_INSTANCES[mode], attention.V1_INSTANCES[mode]) == table[mode]
    assert attention.V2_INSTANCES[mode] in attention.REL_ATTENTION.instances
    assert attention.V1_INSTANCES[mode] in attention.GATHERED_ATTENTION.instances


@pytest.mark.parametrize("library,instance", [(lib.name, i) for lib in attention.LIBRARIES for i in lib.instances])
def test_every_listed_instance_has_its_kernel_in_the_source(library, instance):
    """The __global__ function that CudaLibrary.kernel_name names (and the
    card's checks find in a graph's nodes) is in the library's source."""
    lib = next(lib for lib in attention.LIBRARIES if lib.name == library)
    name = lib.kernel_name(instance)
    assert re.search(rf"__global__ void\s+(__launch_bounds__\([^)]*\)\s+)?{name}\(", lib.source.read_text())


def test_v1_masked_keys_do_not_change_output():
    """tests/test_pallas_attention.py's mask case (seed 5) through the port."""
    q, k, v, bias, e_lr = map(torch.from_numpy, _v1_inputs(5))
    masked = (bias < -1.0)[:, None, :, None]
    out1 = attention.fused_attention(q, k, v, bias, e_lr)
    out2 = attention.fused_attention(q, k + 7.0 * masked, v - 3.0 * masked, bias, e_lr)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)


def test_v2_reference_is_v1_reference_on_the_arange_gather():
    q, k, v, bias, table = map(torch.from_numpy, _inputs(2, 3, 20, 16, 32, seed=7))
    e_lr = torch.from_numpy(_gathered(table.numpy(), 20, 32))
    torch.testing.assert_close(attention.fused_attention_v2_reference(q, k, v, bias, table, 32),
                               attention.fused_attention_reference(q, k, v, bias, e_lr), rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, k, v, bias, table = map(torch.from_numpy, _inputs(2, 2, 16, 16, 16, seed=6))
    e_lr = torch.from_numpy(_gathered(table.numpy(), 16, 16))
    before = {lib.name: lib.launches for lib in attention.LIBRARIES}
    out = attention.fused_attention_v2(q, k, v, bias, rel_table=table, m=16)
    out_v1 = attention.fused_attention(q, k, v, bias, e_lr)
    assert {lib.name: lib.launches for lib in attention.LIBRARIES} == before
    torch.testing.assert_close(out, attention.fused_attention_v2_reference(q, k, v, bias, table, 16),
                               rtol=0, atol=0)
    torch.testing.assert_close(out_v1, attention.fused_attention_reference(q, k, v, bias, e_lr), rtol=0, atol=0)


def test_other_devices_raise():
    q = torch.empty(1, 1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        attention.fused_attention_v2(q, q, q, torch.empty(1, 4, device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        attention.fused_attention(q, q, q, torch.empty(1, 4, device="meta"))


def test_library_path_is_keyed_by_source_and_flags(monkeypatch):
    paths = {lib.name: lib.library_path() for lib in attention.LIBRARIES}
    assert len(set(paths.values())) == len(paths)
    for lib in attention.LIBRARIES:
        assert lib.source.is_file()
        assert paths[lib.name].parent == attention.BUILD_DIR and paths[lib.name].suffix == ".so"
    monkeypatch.setattr(attention, "NVCC_FLAGS", attention.NVCC_FLAGS + ("-DEXTRA",))
    assert all(lib.library_path() != paths[lib.name] for lib in attention.LIBRARIES)


class _FakeNvcc:
    """subprocess.Popen stand-in: records the order of starts and waits, and
    writes the output file named after -o."""

    events = []

    def __init__(self, cmd, **kwargs):
        self.cmd = cmd
        self.returncode = None
        self.events.append(("start", cmd[-1]))

    def communicate(self):
        self.events.append(("wait", self.cmd[-1]))
        if "bad" in self.cmd[-1]:
            self.returncode = 1
            return "error: bad source", None
        with open(self.cmd[self.cmd.index("-o") + 1], "w") as f:
            f.write("so")
        self.returncode = 0
        return "ptxas info    : Used 1 registers", None


def test_build_starts_one_nvcc_per_source_together(monkeypatch, tmp_path):
    monkeypatch.setattr(attention, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(attention, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(attention.subprocess, "Popen", _FakeNvcc)
    _FakeNvcc.events = []
    reports = attention.build()
    sources = [str(lib.source) for lib in attention.LIBRARIES]
    assert _FakeNvcc.events == [("start", s) for s in sources] + [("wait", s) for s in sources]
    assert all("registers" in reports[lib.name] for lib in attention.LIBRARIES)
    assert all(lib.library_path().is_file() for lib in attention.LIBRARIES)
    _FakeNvcc.events = []
    assert attention.build() == {lib.name: "" for lib in attention.LIBRARIES}  # built: nothing runs
    assert _FakeNvcc.events == []

    bad = attention.CudaLibrary("bad", [])
    monkeypatch.setattr(bad, "source", tmp_path / "bad.cu")
    bad.source.write_text("")
    with pytest.raises(RuntimeError, match=r"(?s)nvcc failed.*bad source"):
        attention.build([bad])
