"""
The port's fused_attention_v2 and fused_attention (ops/attention.py) against
the JAX package's Pallas entries (interpret mode on the CPU) and its jnp
reference, as tests/test_pallas_attention.py runs them. On a CPU tensor the
port runs each entry's plain PyTorch version; the CUDA kernels are compared
with those versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
The kernels' build (one nvcc per source, started together) is checked here
with a stand-in for nvcc, and the variant scripts' substitutions against the
kernel sources.
"""
import ast
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldingdiff_tpu.ops.pallas_attention import attention_reference
from foldingdiff_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from foldingdiff_tpu.ops.pallas_attention import fused_attention_v2 as jax_fused_attention_v2
from foldingdiff_tpu_torch import precision
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
    assert attention._check_inputs(*views, bias) == (2, 3, 16, 32)
    assert attention._check_inputs(*map(torch.from_numpy, (q, k, v)), bias) == (2, 3, 16, 32)
    wide = torch.zeros(2, 3, 16, 64)[..., ::2]  # last-dimension stride 2
    with pytest.raises(ValueError, match="last-dimension stride of 1"):
        attention._check_inputs(wide, wide, wide, bias)
    with pytest.raises(ValueError, match="share strides"):
        attention._check_inputs(wide, *views[1:], bias)
    shifted = torch.zeros(2 * 16 * 3 * 32 + 1)[1:].view(2, 16, 3, 32).transpose(1, 2)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        attention._check_inputs(views[0], shifted, views[2], bias)
    odd_rows = torch.zeros(2, 16, 3, 34)[..., :32].transpose(1, 2)  # rows 34 floats apart
    with pytest.raises(ValueError, match="16-byte"):
        attention._check_inputs(odd_rows, odd_rows, odd_rows, bias)
    with pytest.raises(ValueError, match="mask_bias must be contiguous"):
        attention._check_inputs(*views, torch.zeros(16, 2).t())


def test_v1_layout_checks():
    """What the v1 kernel takes, checked on the host before any launch, as
    v2's: the projections' strided views (or contiguous q, k, v) whose last
    stride is 1 and whose rows start on 16 bytes, and e_lr (L, L, D) float32,
    a view in another layout copied to the contiguous tensor the kernel
    reads."""
    q, k, v, bias, _ = _inputs(2, 3, 16, 32, 16, seed=11)
    views = _projection_views(q, k, v)
    bias = torch.from_numpy(bias)
    e_lr = torch.from_numpy(_v1_inputs(11, b=2, h=3, l=16, d=32)[4])
    b, h, l, d, got = attention._check_gathered_inputs(*views, bias, e_lr)
    assert (b, h, l, d) == (2, 3, 16, 32) and got is e_lr
    b, h, l, d, got = attention._check_gathered_inputs(*map(torch.from_numpy, (q, k, v)), bias, e_lr)
    assert (b, h, l, d) == (2, 3, 16, 32) and got is e_lr
    permuted = e_lr.permute(2, 1, 0).contiguous().permute(2, 1, 0)  # (L, L, D) view of a (D, L, L) tensor
    got = attention._check_gathered_inputs(*views, bias, permuted)[4]
    assert got.is_contiguous() and torch.equal(got, e_lr)
    wide = torch.zeros(2, 3, 16, 64)[..., ::2]  # last-dimension stride 2
    with pytest.raises(ValueError, match="last-dimension stride of 1"):
        attention._check_gathered_inputs(wide, wide, wide, bias, e_lr)
    with pytest.raises(ValueError, match="share strides"):
        attention._check_gathered_inputs(views[0], torch.from_numpy(k), views[2], bias, e_lr)
    shifted = torch.zeros(2 * 16 * 3 * 32 + 1)[1:].view(2, 16, 3, 32).transpose(1, 2)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        attention._check_gathered_inputs(views[0], shifted, views[2], bias, e_lr)
    with pytest.raises(ValueError, match="e_lr must be"):
        attention._check_gathered_inputs(*views, bias, e_lr[:8])
    with pytest.raises(TypeError, match="float32"):
        attention._check_gathered_inputs(*views, bias, e_lr.double())
    with pytest.raises(ValueError, match="head size"):
        attention._check_gathered_inputs(*(x[..., :24] for x in views), bias, e_lr[..., :24])


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
def test_v1_on_projection_views_matches_jax_pallas(e_lr_kind, seed, masked):
    """The "pallas" route's call on the CPU: the v1 entry on the
    projections' (B, L, H, D) views, as the denoiser now hands them over,
    against the JAX package's Pallas entry (interpret mode) on the same
    numpy inputs; equal to the call on contiguous q, k, v."""
    q, k, v, bias, e_lr = _v1_inputs(seed, masked)
    if e_lr_kind == "permuted":
        e_lr = _permuted_e_lr(64, 16, 64, seed)
    elif e_lr_kind is None:
        e_lr = None
    with jax.default_matmul_precision("highest"):
        pallas = jax_fused_attention(*[jnp.asarray(a) for a in (q, k, v, bias)],
                                     jnp.asarray(e_lr) if e_lr is not None else None, interpret=True)
    views = _projection_views(q, k, v)
    assert not views[0].is_contiguous()
    e = torch.from_numpy(e_lr) if e_lr is not None else None
    ours = attention.fused_attention(*views, torch.from_numpy(bias), e)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), atol=1e-5)
    contiguous = attention.fused_attention(*map(torch.from_numpy, (q, k, v, bias)), e)
    torch.testing.assert_close(ours, contiguous, rtol=0, atol=1e-6)


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


@pytest.mark.parametrize("mode", ["ieee", "tf32", "bf16", "tf32x3", "bf16x3", "bf16x6", "bf16x9"])
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


@pytest.mark.parametrize("mode,tol", [("tf32x3", 1e-5), ("bf16x3", 5e-5), ("bf16x6", 1e-5), ("bf16x9", 1e-5)])
@pytest.mark.parametrize("l,m,d,rel", CASES)
def test_multi_pass_plain_versions_are_float32_grade(l, m, d, rel, mode, tol):
    """Both entries' plain versions in a multi-pass mode (on the CPU): the v2
    one equals the v1 one on the arange gather bit for bit, and both are
    within `tol` relative RMS of the JAX package's Pallas entry (interpret
    mode) at "highest": parts of 16 bits (bf16x3) or more keep the products
    near float32's, where "bf16" is about 3e-3 away."""
    q, k, v, bias, table = _inputs(2, 4, l, d, m, seed=l + d + 1)
    m_arg = m if rel else None
    with jax.default_matmul_precision("highest"):
        jq, jk, jv, jb = map(jnp.asarray, (q, k, v, bias))
        pallas = np.asarray(jax_fused_attention_v2(jq, jk, jv, jb, jnp.asarray(table) if rel else None, m=m_arg,
                                                   interpret=True))
    tq, tk, tv, tb = map(torch.from_numpy, (q, k, v, bias))
    v2 = attention.fused_attention_v2(tq, tk, tv, tb, torch.from_numpy(table) if rel else None, m_arg, mode=mode)
    e_lr = torch.from_numpy(_gathered(table, l, m)) if rel else None
    v1 = attention.fused_attention(tq, tk, tv, tb, e_lr, mode=mode)
    torch.testing.assert_close(v2, v1, rtol=0, atol=0)
    rms = float(np.sqrt(np.mean((v2.numpy() - pallas) ** 2) / np.mean(pallas ** 2)))
    bf16 = attention.fused_attention(tq, tk, tv, tb, e_lr, mode="bf16").numpy()
    assert 0 < rms <= tol and rms < 0.01 * np.sqrt(np.mean((bf16 - pallas) ** 2) / np.mean(pallas ** 2))


def test_v1_masked_keys_do_not_change_output():
    """tests/test_pallas_attention.py's mask case (seed 5) through the port."""
    q, k, v, bias, e_lr = map(torch.from_numpy, _v1_inputs(5))
    masked = (bias < -1.0)[:, None, :, None]
    out1 = attention.fused_attention(q, k, v, bias, e_lr)
    out2 = attention.fused_attention(q, k + 7.0 * masked, v - 3.0 * masked, bias, e_lr)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)


F64_TOL = 1e-6  # chip_smoke.py's gate: the f64 instances against the plain version in their mode
CANCEL_SCALE = 64.0


def _cancelling_inputs(b, h, l, d, m, seed):
    """chip_smoke.control_inputs' "cancelling" inputs, from numpy: q's first
    quarter of dims repeated in its second, k's and the table's negated
    there, both quarters scaled by CANCEL_SCALE, so that q.k and q.E are the
    second half's O(1) products after partial sums of ~CANCEL_SCALE^2 that
    cancel exactly (float32 sums keep ~1e-3 of them)."""
    q, k, v, bias, table = _inputs(b, h, l, d, m, seed)
    quarter = d // 4
    for x in (q, k, table):
        x[..., :2 * quarter] *= CANCEL_SCALE
    q[..., quarter:2 * quarter] = q[..., :quarter]
    k[..., quarter:2 * quarter] = -k[..., :quarter]
    table[..., quarter:2 * quarter] = -table[..., :quarter]
    return q, k, v, bias, table


def _rel_rms(a, b) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def _f64_plain_and_jax(entry, rel, l, d, mode):
    """(the port's plain version of `entry` in `mode`, JAX's
    attention_reference at F64_F64_F64 on XLA:CPU) on cancelling inputs; v2
    hands JAX e_lr gathered from the table."""
    m = 64
    q, k, v, bias, table = _cancelling_inputs(2, 3, l, d, m, seed=l + d)
    e_lr = _gathered(table, l, m) if rel else None
    tq, tk, tv, tb = map(torch.from_numpy, (q, k, v, bias))
    if entry == "v2":
        ours = attention.fused_attention_v2_reference(tq, tk, tv, tb, torch.from_numpy(table) if rel else None,
                                                      m if rel else None, mode=mode)
    else:
        ours = attention.fused_attention_reference(tq, tk, tv, tb, torch.from_numpy(e_lr) if rel else None, mode=mode)
    with jax.default_matmul_precision("F64_F64_F64"):
        ref = attention_reference(*map(jnp.asarray, (q, k, v, bias)), jnp.asarray(e_lr) if rel else None)
    return ours.numpy(), np.asarray(ref)


F64_CASES = [(entry, rel, l, d) for entry in ("v1", "v2") for rel in (True, False) for l, d in ((33, 16), (64, 32))]


@pytest.mark.parametrize("entry,rel,l,d", F64_CASES)
def test_f64_plain_versions_match_jax_at_f64_on_cancelling_inputs(entry, rel, l, d):
    """The oracle of the f64 instances: each plain version in mode "f64"
    (float64 products, each dot rounded to float32 on its own) within
    F64_TOL relative RMS of JAX's einsums at F64_F64_F64, on inputs whose
    dots cancel partial sums of ~64^2."""
    ours, ref = _f64_plain_and_jax(entry, rel, l, d, "f64")
    assert _rel_rms(ours, ref) <= F64_TOL


@pytest.mark.parametrize("entry,rel,l,d", F64_CASES)
def test_float32_plain_version_misses_the_f64_gate_on_cancelling_inputs(entry, rel, l, d):
    """The control: the float32 plain version on the same inputs stands
    outside F64_TOL of JAX at F64_F64_F64, so the gate sees float32 sums."""
    ours, ref = _f64_plain_and_jax(entry, rel, l, d, "ieee")
    assert _rel_rms(ours, ref) > F64_TOL


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
    commands = []

    def __init__(self, cmd, **kwargs):
        self.cmd = cmd
        self.returncode = None
        self.events.append(("start", cmd[-1]))
        self.commands.append(cmd)

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
    """One nvcc per part of each source (CudaLibrary.parts: the source with
    the part's -D flags), all started before any is waited for; every
    (instance, head size) of a library in exactly one part."""
    monkeypatch.setattr(attention, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(attention, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(attention.subprocess, "Popen", _FakeNvcc)
    _FakeNvcc.events, _FakeNvcc.commands = [], []
    reports = attention.build()
    sources = [str(lib.source) for lib in attention.LIBRARIES for _ in lib.parts]
    assert len(sources) > len(attention.LIBRARIES)
    assert _FakeNvcc.events == [("start", s) for s in sources] + [("wait", s) for s in sources]
    assert [c[c.index("-o") - 2:c.index("-o")] for c in _FakeNvcc.commands] == [
        lib.defines(p) for lib in attention.LIBRARIES for p in range(len(lib.parts))]
    assert all("registers" in reports[lib.name] for lib in attention.LIBRARIES)
    assert all(lib.library_path(p).is_file() for lib in attention.LIBRARIES for p in range(len(lib.parts)))
    assert len({lib.library_path(p) for lib in attention.LIBRARIES for p in range(len(lib.parts))}) == len(sources)
    for lib in attention.LIBRARIES:
        held = [(i, d) for instances, dims in lib.parts for i in instances for d in dims]
        assert sorted(held) == sorted((i, d) for i in lib.instances for d in attention.HEAD_DIMS)
    _FakeNvcc.events = []
    assert attention.build() == {lib.name: "" for lib in attention.LIBRARIES}  # built: nothing runs
    assert _FakeNvcc.events == []

    bad = attention.CudaLibrary("bad", [])
    monkeypatch.setattr(bad, "source", tmp_path / "bad.cu")
    bad.source.write_text("")
    with pytest.raises(RuntimeError, match=r"(?s)nvcc failed.*bad source"):
        attention.build([bad])


@pytest.mark.parametrize("library", attention.LIBRARIES, ids=lambda lib: lib.name)
def test_the_output_rounding_instances_build_in_a_part_of_their_own(library):
    """f16f16 and bf16bf16 build in parts that hold no instance of another
    body, at every head size: a change to their bodies leaves the machine
    code of every other instance as it was (scripts/sass_two_trees.py
    compares it). v2's pair shares attention_half and one part; v1's
    bf16bf16 shares its attention_half with bf16 and builds beside it, and
    v1's f16f16, still on the TF32 body, in a part of its own."""
    parts = [(instances, dims) for instances, dims in library.parts if {"f16f16", "bf16bf16"} & set(instances)]
    assert parts == {"rel_attention": [(("f16f16", "bf16bf16"), attention.HEAD_DIMS)],
                     "gathered_attention": [(("f16f16",), attention.HEAD_DIMS),
                                            (("bf16", "bf16bf16"), attention.HEAD_DIMS)]}[library.name]


def test_the_f16_instance_builds_in_a_part_of_its_own():
    """v2's f16 instance builds in a part that holds no other instance, at
    every head size, beside f64's and the output-rounding pair's own parts:
    its resident body (attention_half with float32 QE slices) changes
    without touching their machine code, whose SASS text a shared part
    would pad to the widest instruction of all of them. v1's f16 keeps its
    part beside f64, since its kernel is not changed with v2's."""
    parts = attention.REL_ATTENTION.parts
    assert [p for p in parts if "f16" in p[0]] == [(("f16",), attention.HEAD_DIMS)]
    assert [p for p in parts if "f64" in p[0]] == [(("f64",), attention.HEAD_DIMS)]


def test_the_bf16_instance_builds_in_a_part_of_its_own():
    """v2's bf16 instance builds in a part that holds no other instance, at
    every head size, and FMA and TF32 keep theirs without it: its resident
    body (attention_half with float32 QE slices) changes without touching
    their machine code, whose SASS text a shared part would pad to the
    widest instruction of all of them. v1's bf16 builds beside bf16bf16
    alone, the other instance of v1's attention_half, and v1's FMA and TF32
    keep a part without it."""
    parts = attention.REL_ATTENTION.parts
    assert [p for p in parts if "bf16" in p[0]] == [(("bf16",), attention.HEAD_DIMS)]
    assert [p for p in parts if {"fma", "tf32"} & set(p[0])] == [(("fma", "tf32"), attention.HEAD_DIMS)]
    parts = attention.GATHERED_ATTENTION.parts
    assert [p for p in parts if "bf16" in p[0]] == [(("bf16", "bf16bf16"), attention.HEAD_DIMS)]
    assert [p for p in parts if {"fma", "tf32"} & set(p[0])] == [(("fma", "tf32"), attention.HEAD_DIMS)]


def _substitutions(script: Path) -> dict:
    """The SUBSTITUTIONS of a variant script, read from its AST: the
    assignment and the module-level constants it names, evaluated with no
    builtins (the scripts import chip_smoke, so they are not imported)."""
    tree = ast.parse(script.read_text())
    assigns = {node.targets[0].id: node for node in tree.body
               if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)}
    needed, todo = set(), ["SUBSTITUTIONS"]
    while todo:
        name = todo.pop()
        if name in needed or name not in assigns:
            continue
        needed.add(name)
        todo += [n.id for n in ast.walk(assigns[name].value) if isinstance(n, ast.Name)]
    namespace = {"__builtins__": {}}
    for name, node in sorted(assigns.items(), key=lambda kv: kv[1].lineno):
        if name in needed:
            exec(compile(ast.Module([node], type_ignores=[]), str(script), "exec"), namespace)
    return namespace["SUBSTITUTIONS"]


@pytest.mark.parametrize("script,library", [("rel_attention_variants.py", attention.REL_ATTENTION),
                                            ("gathered_attention_variants.py", attention.GATHERED_ATTENTION)])
def test_variant_substitutions_are_in_the_kernel_source(script, library):
    """Every text a variant script substitutes is found in the current
    kernel source, in the order the script applies it (a stale one stops
    the script's chip run), and every variant but "final" changes it."""
    substitutions = _substitutions(Path(__file__).resolve().parent.parent / "scripts" / script)
    source = library.source.read_text()
    assert substitutions["final"] == []
    for name, pairs in substitutions.items():
        text = source
        for old, new in pairs:
            assert old in text, f"{script}: {name}: {old!r} is not in {library.source.name}"
            text = text.replace(old, new)
        assert (text != source) == (name != "final"), name


MULTI_PASS = ("tf32x3", "bf16x3", "bf16x6", "bf16x9")
SPLIT_TOL = 1e-5  # chip_smoke.py's gate: a multi-pass instance against the plain version in its mode


def _products_of_device_cuh() -> dict:
    """{Arith name: (products as (i, j), their order as listed, smallest
    first)} parsed from csrc/device.cuh's products_of, and {Arith name:
    rounding} from its kBF16Parts."""
    text = (attention.CSRC_DIR / "device.cuh").read_text()
    body = text[text.index("constexpr Products products_of(Arith a) {"):]
    body = body[:body.index("\n}\n")]
    table = {}
    for names, n, ij in re.findall(r"((?:a == Arith::\w+\s*(?:\|\|\s*)?)+)\?\s*Products\{(\d+), \{([\d, ]+)\}\}", body):
        products = tuple(divmod(int(x), 10) for x in ij.split(","))
        assert len(products) == int(n)
        for name in re.findall(r"Arith::(\w+)", names):
            table[name] = products
    bf16 = re.search(r"constexpr bool kBF16Parts = ([^;]+);", text).group(1)
    rounding = {name: "bf16" if re.search(rf"A == Arith::{name}\b", bf16) else "tf32" for name in table}
    return {name: (table[name], rounding[name]) for name in table}


def _arith_of_instance(library) -> dict:
    """{C instance index: Arith name} from the source's dispatch_instance."""
    found = re.findall(r"case (\d): if constexpr \(kBuiltInstance<\1>\) return launch\w*<[^>]*Arith::(\w+)>",
                       library.source.read_text())
    return {int(i): name for i, name in found}


@pytest.mark.parametrize("mode", MULTI_PASS)
def test_the_kernels_table_of_products_is_the_presets(mode):
    """One arithmetic for the card and the CPU: each kernel's instance for a
    multi-pass mode (ops/attention.py's tables, the C `instance` index)
    dispatches the Arith whose row of device.cuh's products_of lists
    precision.SPLITS' products of the mode, in its order (smallest first),
    over as many parts, rounded alike."""
    rounding, n_parts, products = precision.SPLITS[mode]
    rows = _products_of_device_cuh()
    for library, instances in ((attention.REL_ATTENTION, attention.V2_INSTANCES),
                               (attention.GATHERED_ATTENTION, attention.V1_INSTANCES)):
        instance = instances[mode]
        arith = _arith_of_instance(library)[library.instances.index(instance)]
        assert arith.lower() == mode == instance, (library.name, arith)
        listed, arith_rounding = rows[arith]
        assert listed == products, (library.name, listed)
        assert 1 + max(max(ij) for ij in listed) == n_parts
        assert arith_rounding == rounding


def _model_einsum(eq: str, a: torch.Tensor, b: torch.Tensor, mode: str, init=None) -> torch.Tensor:
    """torch.einsum(eq, a, b) summed as the multi-pass instances sum it: the
    operands split once (precision.parts), the contracted index taken in
    k-steps of 16 values for bf16 and f16 parts and 8 for TF32 parts, in order;
    per k-step the preset's products of parts, the smallest first, each
    k-step's product summed exactly and added to the float32 accumulator
    (started at init)."""
    rounding, _, products = precision.SPLITS[mode]
    step = 8 if rounding == "tf32" else 16
    (sa, sb), so = eq.split("->")[0].split(","), eq.split("->")[1]
    c = next(x for x in sa if x in sb and x not in so)
    pa, pb = precision.parts(a, mode), precision.parts(b, mode)
    acc = None if init is None else init.clone()
    for k0 in range(0, a.shape[sa.index(c)], step):
        for i, j in products:
            term = torch.einsum(eq, pa[i].narrow(sa.index(c), k0, min(step, a.shape[sa.index(c)] - k0)).double(),
                                pb[j].narrow(sb.index(c), k0, min(step, b.shape[sb.index(c)] - k0)).double())
            acc = term.float() if acc is None else (acc.double() + term).float()
    return acc


def _resident_softmax(s: torch.Tensor, bias: torch.Tensor, d: int) -> torch.Tensor:
    """P as the resident bodies make it from float32 scores s at head size
    d: scale and bias in log2 units by one fused multiply-add, each row's
    exact maximum and sum over every key, P = exp2(s - max) times the sum's
    reciprocal."""
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    scale2 = log2e / torch.tensor(float(d)).sqrt()  # the kernels' a.scale2, float32
    s2 = (s.double() * scale2.double() + (bias * log2e)[:, None, None, :].double()).float()  # fmaf
    p = torch.exp2(s2 - s2.amax(-1, keepdim=True))
    return p * (1.0 / p.sum(-1, keepdim=True))


def _model_attention(q, k, v, bias, e_lr, mode, resident=False):
    """The kernels' order of sums in a multi-pass mode: the score
    accumulator starts at the relative term (its own accumulator) and takes
    q.k's products; P, normalised in float32, and V split once; p.v by
    k-steps of keys. resident: the softmax as the resident bodies take it in
    one pass over every key (scale and bias in log2 units by one fused
    multiply-add, each row's exact maximum and sum, P = exp2(s - max) times
    the sum's reciprocal, then split); else torch's softmax."""
    s = _model_einsum("bhld,lrd->bhlr", q, e_lr, mode) if e_lr is not None else None
    s = _model_einsum("bhld,bhmd->bhlm", q, k, mode, init=s)
    if resident:
        p = _resident_softmax(s, bias, q.shape[-1])
    else:
        p = torch.softmax(s / q.shape[-1] ** 0.5 + bias[:, None, None, :], dim=-1)
    return _model_einsum("bhlm,bhmd->bhld", p, v, mode)


@pytest.mark.parametrize("mode", MULTI_PASS)
@pytest.mark.parametrize("rel", [True, False])
@pytest.mark.parametrize("kernel", ["v2", "v1"])
def test_the_kernels_order_of_sums_meets_the_split_gate(kernel, rel, mode):
    """An eager float32 model of the multi-pass instances' accumulation
    (_model_attention: split once, k-steps of 16 bf16 or 8 TF32 values,
    per k-step the products smallest first) within SPLIT_TOL relative RMS
    of each kernel's plain version in the mode, and at most a tenth of
    TF32's distance from float32: the order of sums can meet chip_smoke.py's
    phase-2 gate. v1 with a random (not Toeplitz) e_lr. TF32x3 as its
    resident bodies take it at this L (v1's one pass, v2's split at the
    load), and v1's bf16x6 and bf16x9 with e_lr as v1's resident body takes
    them (without it v1 runs v2's rel-off instance, the chunked body's
    sums): exact row statistics before P is split."""
    q, k, v, bias, table = map(torch.from_numpy, _inputs(2, 3, 40, 32, 48, seed=31))
    if kernel == "v2":
        e_lr = torch.from_numpy(_gathered(table.numpy(), 40, 48)) if rel else None
        plain = attention.fused_attention_v2_reference(q, k, v, bias, table if rel else None, 48 if rel else None,
                                                       mode=mode)
    else:
        rng = np.random.default_rng(32)
        e_lr = torch.from_numpy((rng.normal(size=(40, 40, 32)) * 0.5).astype(np.float32)) if rel else None
        plain = attention.fused_attention_reference(q, k, v, bias, e_lr, mode=mode)
    resident = mode == "tf32x3" or (kernel == "v1" and rel and mode in ("bf16x6", "bf16x9"))
    model = _model_attention(q, k, v, bias, e_lr, mode, resident=resident)
    f32 = attention.fused_attention_reference(q, k, v, bias, e_lr)
    tf32 = attention.fused_attention_reference(*(precision.to_tf32_values(x) for x in (q, k, v)), bias,
                                               precision.to_tf32_values(e_lr) if rel else None)

    def rel_rms(x, y):
        return float((x - y).square().mean().sqrt() / y.square().mean().sqrt())

    assert 0 < rel_rms(model, plain) <= SPLIT_TOL
    assert rel_rms(model, f32) <= 0.1 * rel_rms(tf32, f32)


# (kernel, L, rel, mode): every kernel, length and rel flag in tf32x3 (ids without the mode), and v1's bf16x6 and
# bf16x9 with e_lr (without it v1 runs v2's rel-off instance)
_RESIDENT_CASES = ([pytest.param(kernel, l, rel, "tf32x3", id=f"{kernel}-{l}-{rel}")
                    for kernel in ("v2", "v1") for l in (17, 64, 65, 128) for rel in (True, False)]
                   + [pytest.param("v1", l, True, mode, id=f"v1-{l}-True-{mode}")
                      for mode in ("bf16x6", "bf16x9") for l in (17, 64, 65, 128)])


@pytest.mark.parametrize("kernel,l,rel,mode", _RESIDENT_CASES)
def test_the_resident_tf32x3_order_of_sums_meets_the_split_gate(kernel, l, rel, mode):
    """The resident multi-pass bodies' order of sums (_model_attention with
    resident=True: one pass over the keys, each row's exact maximum and sum
    in exp2 units before P is split, q.k's products on top of the relative
    term, each k-step's products smallest first, by k-steps of 8 values for
    TF32 parts and 16 for bf16 parts; interleaving n-tiles does not reorder
    any accumulator's sums) within SPLIT_TOL relative RMS of the plain
    version in the mode, and at most a tenth of TF32's distance from
    float32, on either side of the resident designs' key counts (64, 128),
    some keys masked: in tf32x3 v1 with a random (not Toeplitz) e_lr (or
    without it, the v2 rel-off instance) and v2 with its table (or
    without); in bf16x6 and bf16x9 v1 with a random e_lr."""
    q, k, v, bias, table = map(torch.from_numpy, _inputs(2, 3, l, 32, 128, seed=50 + l))
    assert (bias < 0).any()
    if kernel == "v2":
        e_lr = torch.from_numpy(_gathered(table.numpy(), l, 128)) if rel else None
        plain = attention.fused_attention_v2_reference(q, k, v, bias, table if rel else None, 128 if rel else None,
                                                       mode=mode)
    else:
        rng = np.random.default_rng(51 + l)
        e_lr = torch.from_numpy((rng.normal(size=(l, l, 32)) * 0.5).astype(np.float32)) if rel else None
        plain = attention.fused_attention_reference(q, k, v, bias, e_lr, mode=mode)
    model = _model_attention(q, k, v, bias, e_lr, mode, resident=True)
    f32 = attention.fused_attention_reference(q, k, v, bias, e_lr)
    tf32 = attention.fused_attention_reference(*(precision.to_tf32_values(x) for x in (q, k, v)), bias,
                                               precision.to_tf32_values(e_lr) if rel else None)

    def rel_rms(x, y):
        return float((x - y).square().mean().sqrt() / y.square().mean().sqrt())

    assert 0 < rel_rms(model, plain) <= SPLIT_TOL
    assert rel_rms(model, f32) <= 0.1 * rel_rms(tf32, f32)


@pytest.mark.parametrize("rel", [True, False])
@pytest.mark.parametrize("l", [17, 64, 65, 128])
@pytest.mark.parametrize("d", [16, 32])
def test_the_half_body_order_of_sums_meets_the_bf16_gate(d, l, rel):
    """The order of sums of v2's bf16 instance on attention_half
    (_model_attention with resident=True: q, k, v and the table rounded to
    bf16 values once, QE in float32 by k-steps of 16 values,
    each score accumulator seeded with it and q.k's products added on top,
    the row statistics in one pass, P normalised then rounded, p.v by
    k-steps of 16 keys) within BF16_SHARE of the plain version's distance
    from float32 and within BF16_TOL of float32 (chip_smoke.py's gate),
    on either side of the resident design's key counts (64, 128) at both
    of its head sizes, some keys masked. With relative scores the same
    order with QE rounded to bf16, as bf16bf16 rounds it, fails that gate:
    the relative term stays float32 (kF32Rel)."""
    mode, share, tol = "bf16", 0.1, 5e-2  # chip_smoke.py's BF16_SHARE and BF16_TOL
    q, k, v, bias, table = map(torch.from_numpy, _inputs(2, 3, l, d, 128, seed=70 + l + d))
    assert (bias < 0).any()
    e_lr = torch.from_numpy(_gathered(table.numpy(), l, 128)) if rel else None
    plain = attention.fused_attention_v2_reference(q, k, v, bias, table if rel else None, 128 if rel else None,
                                                   mode=mode)
    f32 = attention.fused_attention_reference(q, k, v, bias, e_lr)

    def rel_rms(x, y):
        return float((x - y).square().mean().sqrt() / y.square().mean().sqrt())

    gap = rel_rms(plain, f32)
    model = _model_attention(q, k, v, bias, e_lr, mode, resident=True)
    assert 0 < rel_rms(model, plain) <= share * gap
    assert rel_rms(model, f32) <= tol
    if rel:
        rounded_qe = precision.ROUNDINGS[mode](_model_einsum("bhld,lrd->bhlr", q, e_lr, mode))
        s = _model_einsum("bhld,bhmd->bhlm", q, k, mode, init=rounded_qe)
        control = _model_einsum("bhlm,bhmd->bhld", _resident_softmax(s, bias, d), v, mode)
        assert rel_rms(control, plain) > share * gap


def _model_v1_half(q, k, v, bias, e_lr, mode: str, rel_as: str) -> torch.Tensor:
    """v1's attention_half (csrc/gathered_attention.cu) in `mode` ("bf16" or
    "bf16bf16"), its relative term taken as `rel_as` does: "seeded", q.e_lr
    in float32 by k-steps of 16 values, each score accumulator seeded with
    it and q.k's products added on top (bf16's form); "rounded", q.e_lr and
    q.k each from zero and rounded to bf16 on its own, then summed in
    float32 (bf16bf16's form). Then the resident softmax, P normalised and
    rounded, p.v by k-steps of 16 keys, its output rounded to bf16 under
    "bf16bf16"."""
    to_bf16 = precision.ROUNDINGS["bf16"]
    qe = _model_einsum("bhld,lrd->bhlr", q, e_lr, mode)
    if rel_as == "seeded":
        s = _model_einsum("bhld,bhmd->bhlm", q, k, mode, init=qe)
    else:
        s = to_bf16(_model_einsum("bhld,bhmd->bhlm", q, k, mode)) + to_bf16(qe)
    out = _model_einsum("bhlm,bhmd->bhld", _resident_softmax(s, bias, q.shape[-1]), v, mode)
    return to_bf16(out) if mode == "bf16bf16" else out


@pytest.mark.parametrize("l", [17, 64, 65, 128])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("mode", ["bf16", "bf16bf16"])
def test_the_v1_half_body_order_of_sums_meets_the_bf16_gate(mode, d, l):
    """The order of sums of v1's bf16 and bf16bf16 instances on their
    16-bit-plane resident body (_model_v1_half: q, k, v and e_lr rounded to
    bf16 once, every product by k-steps of 16 values; bf16 seeds each score
    accumulator with its float32 relative term, bf16bf16 rounds q.e_lr and
    q.k each on its own and sums them) within BF16_SHARE of the plain
    version's distance from float32 and within BF16_TOL of float32
    (chip_smoke.py's gate), against v1's plain version with a random (not
    Toeplitz) e_lr, on either side of the resident design's key counts (64,
    128) at both of its head sizes, some keys masked. Each instance's
    control, its relative term taken as the other instance takes it (bf16's
    rounded to bf16, bf16bf16's seeded), fails that gate."""
    share, tol = 0.1, 5e-2  # chip_smoke.py's BF16_SHARE and BF16_TOL
    q, k, v, bias, _ = map(torch.from_numpy, _inputs(2, 3, l, d, 128, seed=90 + l + d))
    assert (bias < 0).any()
    rng = np.random.default_rng(91 + l + d)
    e_lr = torch.from_numpy((rng.normal(size=(l, l, d)) * 0.5).astype(np.float32))
    plain = attention.fused_attention_reference(q, k, v, bias, e_lr, mode=mode)
    f32 = attention.fused_attention_reference(q, k, v, bias, e_lr)

    def rel_rms(x, y):
        return float((x - y).square().mean().sqrt() / y.square().mean().sqrt())

    gap = rel_rms(plain, f32)
    forms = {"bf16": ("seeded", "rounded"), "bf16bf16": ("rounded", "seeded")}[mode]
    model, control = (_model_v1_half(q, k, v, bias, e_lr, mode, form) for form in forms)
    assert gap > 0 and rel_rms(model, plain) <= share * gap
    assert rel_rms(model, f32) <= tol
    assert rel_rms(control, plain) > share * gap
