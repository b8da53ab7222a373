"""
Tests that need an NVIDIA GPU: the two CUDA attention kernels
(csrc/rel_attention.cu, csrc/gathered_attention.cu) against their plain
PyTorch versions, each instance (float32 FMA, TF32 and bf16 tensor cores,
the multi-pass presets' products of parts on them, float64, and the 16-bit
presets' f16 or bf16 values on TF32 tensor cores, v2 and v1 alike) against
the plain version in its mode, the wrappers' input checks, a
reverse step on the card, the CUDA graphs of the reverse chains and the
train step against the eager ones (bitwise, with the kernels' launches
counted), and matmul_precision on the card (TF32, bf16 and the multi-pass
presets against "highest", "default" at the caller's setting, the
caller's setting kept; the split Linears against their CPU twins). They skip without a
card; they run with cuBLAS's float32 GEMMs in IEEE float32 outside the
models.
They import no JAX, so they also run on a machine that has none, without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

from foldingdiff_tpu_torch import precision
from foldingdiff_tpu_torch.diffusion import sampling
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.graphs import StepGraph
from foldingdiff_tpu_torch.models import io as model_io
from foldingdiff_tpu_torch.models.config import ModelConfig
from foldingdiff_tpu_torch.ops import attention
from foldingdiff_tpu_torch.training.trainer import Trainer, TrainConfig, build_optimizer

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    return torch.device("cuda")


def _inputs(device, b, h, l, d, m, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, h, l, d, generator=g, device=device) for _ in range(3))
    lengths = torch.randint(l // 2, l + 1, (b,), generator=g, device=device)
    bias = torch.where(torch.arange(l, device=device)[None, :] < lengths[:, None], 0.0, -10000.0)
    table = torch.randn(2 * m - 1, d, generator=g, device=device) * 0.5
    return q, k, v, bias, table


# (B, H, L, D, M): flagship buckets and ragged lengths, head sizes 16, 32, 64
SHAPES = [(8, 12, 128, 32, 128), (8, 12, 64, 32, 128), (8, 12, 127, 32, 128), (4, 6, 33, 16, 64),
          (4, 6, 64, 16, 64), (2, 4, 100, 64, 128), (3, 2, 1, 32, 128)]


@pytest.mark.parametrize("rel", [True, False])
@pytest.mark.parametrize("b,h,l,d,m", SHAPES)
def test_kernel_matches_plain(device, b, h, l, d, m, rel):
    q, k, v, bias, table = _inputs(device, b, h, l, d, m)
    table, m = (table, m) if rel else (None, None)
    with torch.inference_mode():
        before = attention.REL_ATTENTION.launches
        out = attention.fused_attention_v2(q, k, v, bias, table, m)
        torch.cuda.synchronize()
        assert attention.REL_ATTENTION.launches == before + 1
        ref = attention.fused_attention_v2_reference(q, k, v, bias, table, m)
    assert out.shape == q.shape and out.device == q.device
    assert (out - ref).abs().max().item() <= 1e-4


def _projection_views(*tensors):
    """(B, H, L, D) tensors as the denoiser hands them to the v2 kernel:
    `.view(B, L, H, D).transpose(1, 2)` of (B, L, H * D) buffers."""
    return [t.transpose(1, 2).contiguous().view(t.shape[0], t.shape[2], -1)
            .view(t.shape[0], t.shape[2], t.shape[1], t.shape[3]).transpose(1, 2) for t in tensors]


# (B, H, L, D, M) of the strided v2 cases: ragged L (33, 50, 99, 1) inside a
# 64-row tile and a 64-key chunk; L = 200 over four chunks; D 16, 32, 64;
# odd H, whose last two-head block has one head; and the sampler's small
# chunk (B = 15, H = 12, L = 64)
STRIDED_SHAPES = [(8, 12, 128, 32, 128), (8, 12, 50, 32, 128), (4, 6, 33, 16, 64), (2, 4, 99, 64, 128),
                  (64, 12, 64, 32, 128), (100, 5, 99, 64, 128), (140, 3, 33, 16, 64), (2, 3, 200, 32, 256),
                  (3, 2, 1, 32, 128), (15, 12, 64, 32, 128)]


@pytest.mark.parametrize("rel", [True, False])
@pytest.mark.parametrize("b,h,l,d,m", STRIDED_SHAPES)
def test_kernel_on_projection_views_matches_plain(device, b, h, l, d, m, rel):
    q, k, v, bias, table = _inputs(device, b, h, l, d, m, seed=5)
    table, m = (table, m) if rel else (None, None)
    views = _projection_views(q, k, v)
    assert views[0].stride()[2] == h * d  # rows H * D floats apart
    with torch.inference_mode():
        before = attention.REL_ATTENTION.launches
        out = attention.fused_attention_v2(*views, bias, table, m)
        torch.cuda.synchronize()
        assert attention.REL_ATTENTION.launches == before + 1
        ref = attention.fused_attention_v2_reference(q, k, v, bias, table, m)
    assert out.shape == (b, h, l, d) and out.transpose(1, 2).is_contiguous()  # stored as (B, L, H, D)
    assert (out - ref).abs().max().item() <= 1e-4


def test_kernel_on_projection_views_ignores_masked_keys(device):
    q, k, v, bias, table = _inputs(device, 64, 12, 96, 32, 128, seed=6)
    masked = (bias < -1.0)[:, None, :, None]
    with torch.inference_mode():
        out1 = attention.fused_attention_v2(*_projection_views(q, k, v), bias, table, 128)
        out2 = attention.fused_attention_v2(*_projection_views(q, k + 7.0 * masked, v - 3.0 * masked),
                                            bias, table, 128)
    assert (out1 - out2).abs().max().item() <= 1e-5


def test_wrapper_refuses_layouts_the_kernel_does_not_take(device):
    q, k, v, bias, table = _inputs(device, 2, 3, 16, 32, 16)
    views = _projection_views(q, k, v)
    before = attention.REL_ATTENTION.launches
    with torch.inference_mode():
        with pytest.raises(ValueError, match="last-dimension stride of 1"):
            wide = torch.zeros(2, 3, 16, 64, device=device)[..., ::2]
            attention.fused_attention_v2(wide, wide, wide, bias)
        with pytest.raises(ValueError, match="share strides"):
            attention.fused_attention_v2(q, *views[1:], bias)
        shifted = torch.zeros(2 * 16 * 3 * 32 + 1, device=device)[1:].view(2, 16, 3, 32).transpose(1, 2)
        with pytest.raises(ValueError, match="16-byte"):
            attention.fused_attention_v2(views[0], shifted, views[2], bias, table, 16)
        odd_rows = torch.zeros(2, 16, 3, 34, device=device)[..., :32].transpose(1, 2)  # rows 34 floats apart
        with pytest.raises(ValueError, match="16-byte"):
            attention.fused_attention_v2(odd_rows, odd_rows, odd_rows, bias, table, 16)
        with pytest.raises(ValueError, match="16-byte"):
            attention.fused_attention_v2(*views, bias, torch.zeros(31 * 32 + 1, device=device)[1:].view(31, 32), 16)
    assert attention.REL_ATTENTION.launches == before  # refused on the host: nothing launched


def test_kernel_ignores_masked_keys(device):
    q, k, v, bias, table = _inputs(device, 4, 6, 96, 32, 128, seed=1)
    masked = (bias < -1.0)[:, None, :, None]
    with torch.inference_mode():
        out1 = attention.fused_attention_v2(q, k, v, bias, table, 128)
        out2 = attention.fused_attention_v2(q, k + 7.0 * masked, v - 3.0 * masked, bias, table, 128)
    assert (out1 - out2).abs().max().item() <= 1e-5


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    q, k, v, bias, table = _inputs(device, 2, 2, 16, 32, 16)
    with torch.inference_mode():
        with pytest.raises(TypeError, match="float32"):
            attention.fused_attention_v2(q.double(), k, v, bias)
        with pytest.raises(ValueError, match="shapes differ"):
            attention.fused_attention_v2(q.transpose(1, 2), k, v, bias)
        with pytest.raises(ValueError, match="mask_bias must be contiguous"):
            attention.fused_attention_v2(q, k, v, bias.t().contiguous().t())
        with pytest.raises(ValueError, match="head size"):
            attention.fused_attention_v2(q[..., :24].contiguous(), k[..., :24].contiguous(),
                                         v[..., :24].contiguous(), bias)
        with pytest.raises(ValueError, match="exceeds"):
            attention.fused_attention_v2(q, k, v, bias, table[:15].contiguous(), 8)
        with pytest.raises(ValueError, match="on cpu"):
            attention.fused_attention_v2(q, k, v, bias.cpu())
    with pytest.raises(RuntimeError, match="forward-only"):
        attention.fused_attention_v2(q.requires_grad_(), k, v, bias)


def _rel_rms(a, b) -> float:
    return ((a - b).square().mean().sqrt() / b.square().mean().sqrt()).item()


# the multi-pass modes (precision.SPLITS but "bf16" and the 16-bit modes)
MULTI_PASS = ("tf32x3", "bf16x3", "bf16x6", "bf16x9")
# the 16-bit modes (F16_F16_F32, F16_F16_F16, BF16_BF16_BF16): one rounding
# of each operand, and under f16f16 and bf16bf16 of each product's output
SIXTEEN_BIT = ("f16", "f16f16", "bf16bf16")
TENSOR_CORE_MODES = ("tf32", "bf16", *MULTI_PASS, *SIXTEEN_BIT)
# every instance but FMA's: the tensor-core ones and the float64 one
INSTANCE_MODES = (*TENSOR_CORE_MODES, "f64")
# The share of the plain version's distance from float32 that a bf16 or
# 16-bit instance may stand from the plain version: the kernel's P and sums
# differ from the plain version's by float32 ulps, which move an operand by
# a rounding step where they meet a boundary; f16's steps are 8 times as
# frequent as bf16's and 8 times smaller, so such moves weigh about three
# times as much against f16's distance (measured on an H100: 0.107 for v1
# f16 at B = 3, H = 5, L = 99, D = 64 with e_lr, 0.077 for v1 f16f16 there,
# at most 0.05 at every other shape here; on a second seed there 0.025 and
# 0.044, and v2 0.020-0.052 on both: chip_smoke.py phase 2 reads that shape
# against these shares (RAGGED_SHARE) and holds every instance to a tenth
# at its other shapes)
SHARE = {"bf16": 0.1, "f16": 0.2, "f16f16": 0.2, "bf16bf16": 0.1}


def _check_instance(out, run_plain, mode, run_kernel=None):
    """An instance's output against the plain version: FMA within 1e-4 of
    float32's; TF32 within 5e-3 relative RMS of float32's; bf16 and the
    16-bit instances within SHARE of the plain version's own relative-RMS
    distance from float32 in their mode (above 0), and within 5e-2 of
    float32; f64 within 1e-6 relative RMS of the plain version in
    its mode (float64 products, each dot rounded to float32); a multi-pass
    instance within 1e-5 relative RMS of the plain version in its mode (the
    same products of parts, summed in another order), and at most a tenth
    of the TF32 instance's distance from float32 (run_kernel("tf32"), the
    same inputs)."""
    f32 = run_plain("ieee")
    if mode == "ieee":
        assert (out - f32).abs().max().item() <= 1e-4
    elif mode == "tf32":
        assert 0 < _rel_rms(out, f32) <= 5e-3
    elif mode == "f64":
        assert _rel_rms(out, run_plain("f64")) <= 1e-6
    elif mode in ("bf16", *SIXTEEN_BIT):
        with precision.matmul_precision(mode):  # the plain version's GEMMs as the model runs them: TF32
            plain = run_plain(mode)
        gap = _rel_rms(plain, f32)
        assert gap > 0 and _rel_rms(out, plain) <= SHARE[mode] * gap and _rel_rms(out, f32) <= 5e-2, mode
    else:
        with precision.matmul_precision(mode):  # the plain version's GEMMs as the model runs them: TF32 on parts
            plain = run_plain(mode)
        assert _rel_rms(out, plain) <= 1e-5, mode
        assert _rel_rms(out, f32) <= 0.1 * _rel_rms(run_kernel("tf32"), f32), mode


# (B, H, L, D, M) of the instances' checks: the flagship and the sweep's two
# chunks; ragged L inside a 16-row warp tile and an 8-key tile (50, 127, 33,
# 99); L = 200 over four chunks of keys (the chunked design past L = 128, the
# bf16 instance's two passes); L = 1; D 16, 32, 64 (64 on the chunked design);
# fewer (b, h) pairs than SMs (1 x 1, 3 x 5) and more than one item per
# persistent block (130 x 12)
INSTANCE_SHAPES = [(8, 12, 128, 32, 128), (15, 12, 64, 32, 128), (63, 12, 128, 32, 128), (8, 12, 50, 32, 128),
                   (8, 12, 127, 32, 128), (4, 6, 33, 16, 64), (2, 4, 99, 64, 128), (2, 3, 200, 32, 256),
                   (3, 2, 1, 32, 128), (1, 1, 128, 32, 128), (3, 5, 64, 32, 128), (130, 12, 128, 32, 128)]


@pytest.mark.parametrize("mode", ["ieee", *INSTANCE_MODES])
@pytest.mark.parametrize("rel", [True, False])
@pytest.mark.parametrize("b,h,l,d,m", INSTANCE_SHAPES)
def test_v2_instance_on_projection_views_matches_its_plain_version(device, b, h, l, d, m, rel, mode):
    q, k, v, bias, table = _inputs(device, b, h, l, d, m, seed=11)
    kw = dict(rel_table=table, m=m) if rel else {}
    views = _projection_views(q, k, v)
    instance = attention.V2_INSTANCES[mode]
    with torch.inference_mode():
        before = dict(attention.REL_ATTENTION.launches_by_instance)
        out = attention.fused_attention_v2(*views, bias, mode=mode, **kw)
        torch.cuda.synchronize()
        after = attention.REL_ATTENTION.launches_by_instance
        assert {i: n - before[i] for i, n in after.items()} == {i: int(i == instance) for i in after}
        assert out.shape == (b, h, l, d) and out.transpose(1, 2).is_contiguous()  # stored as (B, L, H, D)
        _check_instance(out, lambda mode_: attention.fused_attention_v2_reference(q, k, v, bias, mode=mode_, **kw),
                        mode, lambda mode_: attention.fused_attention_v2(*views, bias, mode=mode_, **kw))


@pytest.mark.parametrize("mode", ["ieee", *INSTANCE_MODES])
@pytest.mark.parametrize("rel", [True, False])
@pytest.mark.parametrize("b,h,l,d,m", [(4, 12, 128, 32, 128), (5, 3, 50, 64, 128), (2, 6, 200, 16, 256)])
def test_v2_instance_on_a_slice_of_a_larger_buffer(device, b, h, l, d, m, rel, mode):
    """q, k and v sliced from one (B, L + 5, 3, H, D) buffer, as a fused
    projection would leave them: rows 3 H D floats apart, a batch stride of
    3 (L + 5) H D, beyond L H D."""
    q, k, v, bias, table = _inputs(device, b, h, l, d, m, seed=17)
    kw = dict(rel_table=table, m=m) if rel else {}
    buf = torch.randn(b, l + 5, 3, h, d, generator=torch.Generator(device=device).manual_seed(18), device=device)
    for i, x in enumerate((q, k, v)):
        buf[:, :l, i] = x.transpose(1, 2)
    views = [buf[:, :l, i].transpose(1, 2) for i in range(3)]
    assert views[0].stride() == (3 * (l + 5) * h * d, d, 3 * h * d, 1)
    with torch.inference_mode():
        out = attention.fused_attention_v2(*views, bias, mode=mode, **kw)
        _check_instance(out, lambda mode_: attention.fused_attention_v2_reference(q, k, v, bias, mode=mode_, **kw),
                        mode, lambda mode_: attention.fused_attention_v2(*views, bias, mode=mode_, **kw))


def test_v2_back_to_back_launches_of_different_shapes(device):
    """Launches of every instance at different shapes (each instance's
    design re-arms its barriers per launch) on one stream with no
    synchronisation between them, each held against its plain version
    after one synchronisation."""
    shapes = [(64, 12, 128, 32, 128), (15, 12, 64, 32, 128), (3, 2, 1, 32, 128), (130, 12, 128, 32, 128),
              (2, 4, 99, 64, 128), (2, 3, 200, 32, 256), (1, 1, 128, 32, 128), (4, 6, 33, 16, 64)]
    runs = []
    with torch.inference_mode():
        for i, (b, h, l, d, m) in enumerate(shapes):
            q, k, v, bias, table = _inputs(device, b, h, l, d, m, seed=20 + i)
            views = _projection_views(q, k, v)
            for j, mode in enumerate((*INSTANCE_MODES, "ieee")):
                kw = dict(rel_table=table, m=m) if (i + j) % 2 else {}
                runs.append((attention.fused_attention_v2(*views, bias, mode=mode, **kw), (views, bias), kw, mode))
        torch.cuda.synchronize()
        for out, (views, bias), kw, mode in runs:
            _check_instance(out, lambda mode_: attention.fused_attention_v2_reference(*views, bias, mode=mode_, **kw),
                            mode, lambda mode_: attention.fused_attention_v2(*views, bias, mode=mode_, **kw))


@pytest.mark.parametrize("mode", INSTANCE_MODES)
def test_v2_instance_ignores_masked_keys(device, mode):
    q, k, v, bias, table = _inputs(device, 64, 12, 96, 32, 128, seed=6)
    masked = (bias < -1.0)[:, None, :, None]
    with torch.inference_mode():
        out1 = attention.fused_attention_v2(*_projection_views(q, k, v), bias, table, 128, mode=mode)
        out2 = attention.fused_attention_v2(*_projection_views(q, k + 7.0 * masked, v - 3.0 * masked),
                                            bias, table, 128, mode=mode)
    assert (out1 - out2).abs().max().item() <= 1e-5


@pytest.mark.parametrize("mode", INSTANCE_MODES)
def test_v2_instances_refuse_what_they_do_not_take(device, mode):
    """The checks come before the instance: a wrong dtype, layout or
    alignment raises for every mode, and so does a mode the port does not
    have; nothing launches."""
    q, k, v, bias, table = _inputs(device, 2, 3, 16, 32, 16)
    views = _projection_views(q, k, v)
    before = attention.REL_ATTENTION.launches
    with torch.inference_mode():
        with pytest.raises(TypeError, match="float32"):
            attention.fused_attention_v2(q.double(), k, v, bias, mode=mode)
        with pytest.raises(ValueError, match="share strides"):
            attention.fused_attention_v2(q, *views[1:], bias, mode=mode)
        shifted = torch.zeros(2 * 16 * 3 * 32 + 1, device=device)[1:].view(2, 16, 3, 32).transpose(1, 2)
        with pytest.raises(ValueError, match="16-byte"):
            attention.fused_attention_v2(views[0], shifted, views[2], bias, table, 16, mode=mode)
        with pytest.raises(ValueError, match="is not one of the port's"):
            attention.fused_attention_v2(*views, bias, table, 16, mode="highest")
    assert attention.REL_ATTENTION.launches == before


@pytest.mark.parametrize("setting,instance", [("ieee", "fma"), ("tf32", "tf32"), ("none", "fma")])
def test_default_model_attention_follows_the_callers_setting(device, setting, instance):
    """A "default" model's v2 attention runs the instance that its GEMMs'
    setting names at the call: TF32 under a caller's TF32, FMA otherwise;
    a "high" model's TF32, a "BF16_BF16_F32" model's bf16 and a multi-pass,
    float64 or 16-bit preset's model its own instance whatever the caller's
    setting."""
    x, mask = _chain_inputs(device)
    t = torch.zeros(x.shape[0], dtype=torch.long, device=device)
    torch.backends.cuda.matmul.fp32_precision = setting
    try:
        for name, want in (("default", instance), ("high", "tf32"), ("BF16_BF16_F32", "bf16"),
                           *{p: m for p, m in precision.MODES.items() if m in (*MULTI_PASS, *SIXTEEN_BIT, "f64")}.items()):
            config = dataclasses.replace(GRAPH_CONFIG, matmul_precision=name)
            model = model_io.init_random(config, torch.Generator().manual_seed(1)).to(device).eval()
            before = dict(attention.REL_ATTENTION.launches_by_instance)
            with torch.inference_mode():
                model(x, t, mask)
            added = {i: n - before[i] for i, n in attention.REL_ATTENTION.launches_by_instance.items()}
            assert added == {i: GRAPH_CONFIG.num_hidden_layers * (i == want) for i in added}, (name, added)
            assert torch.backends.cuda.matmul.fp32_precision == setting
    finally:
        torch.backends.cuda.matmul.fp32_precision = "ieee"


def _e_lr(table, l, m, positions):
    """e_lr[l, r] = table[pos[l] - pos[r] + M - 1] for arange or a permutation of it."""
    pos = torch.arange(l, device=table.device)
    if positions == "permuted":
        pos = pos[torch.randperm(l, generator=torch.Generator().manual_seed(l)).to(table.device)]
    return table[pos[:, None] - pos[None, :] + m - 1]


@pytest.mark.parametrize("e_lr_kind", ["arange", "permuted", "random", None])
@pytest.mark.parametrize("b,h,l,d,m", SHAPES)
def test_gathered_kernel_matches_plain(device, b, h, l, d, m, e_lr_kind):
    q, k, v, bias, table = _inputs(device, b, h, l, d, m)
    if e_lr_kind == "random":  # not Toeplitz
        e_lr = torch.randn(l, l, d, generator=torch.Generator(device=device).manual_seed(2), device=device) * 0.5
    else:
        e_lr = _e_lr(table, l, m, e_lr_kind) if e_lr_kind else None
    # without e_lr the v1 entry launches the v2 kernel's rel-off instance, counted there
    lib = attention.GATHERED_ATTENTION if e_lr is not None else attention.REL_ATTENTION
    with torch.inference_mode():
        before = lib.launches
        out = attention.fused_attention(q, k, v, bias, e_lr)
        torch.cuda.synchronize()
        assert lib.launches == before + 1
        ref = attention.fused_attention_reference(q, k, v, bias, e_lr)
    assert out.shape == q.shape and out.device == q.device
    assert out.stride() == (l * h * d, d, h * d, 1)  # a view of a (B, L, H, D) buffer
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("e_lr_kind", ["permuted", "random", None])
@pytest.mark.parametrize("b,h,l,d,m", [(8, 12, 128, 32, 128), (15, 12, 64, 32, 128), (4, 6, 33, 16, 64),
                                       (2, 4, 99, 64, 128), (3, 2, 1, 32, 128)])
def test_gathered_bf16_instance_matches_its_plain_version(device, b, h, l, d, m, e_lr_kind):
    """v1 under "bf16": bf16 values on TF32 tensor cores (q, k, v, e_lr and
    the normalised P rounded) against the plain version's bf16 products;
    under "tf32" the TF32 instance against float32; under the multi-pass
    modes their products of parts against the plain version's."""
    q, k, v, bias, table = _inputs(device, b, h, l, d, m, seed=12)
    if e_lr_kind == "random":
        e_lr = torch.randn(l, l, d, generator=torch.Generator(device=device).manual_seed(2), device=device) * 0.5
    else:
        e_lr = _e_lr(table, l, m, e_lr_kind) if e_lr_kind else None
    with torch.inference_mode():
        for mode in ("bf16", "tf32", *MULTI_PASS, "f64", *SIXTEEN_BIT):
            out = _gathered_instance_call(q, k, v, bias, e_lr, mode)
            _check_instance(out, lambda mode_: attention.fused_attention_reference(
                q, k, v, bias, e_lr, mode=mode_), mode, lambda mode_: attention.fused_attention(
                q, k, v, bias, e_lr, mode=mode_))


def _gathered_instance_call(q, k, v, bias, e_lr, mode):
    """fused_attention in `mode`, which must launch V1_INSTANCES[mode] once
    and no other instance; without e_lr the v2 kernel's V2_INSTANCES[mode],
    its rel-off instance, and nothing of the v1 kernel."""
    libs = (attention.GATHERED_ATTENTION, attention.REL_ATTENTION)
    before = [dict(lib.launches_by_instance) for lib in libs]
    rel_off = attention.REL_ATTENTION.rel_off_launches
    out = attention.fused_attention(q, k, v, bias, e_lr, mode=mode)
    torch.cuda.synchronize()
    launched = libs[0] if e_lr is not None else libs[1]
    want = attention.V1_INSTANCES[mode] if e_lr is not None else attention.V2_INSTANCES[mode]
    for lib, was in zip(libs, before):
        added = {i: n - was[i] for i, n in lib.launches_by_instance.items()}
        assert added == {i: int(lib is launched and i == want) for i in added}
    assert attention.REL_ATTENTION.rel_off_launches == rel_off + (e_lr is None)
    b, h, l, d = q.shape
    assert out.shape == q.shape and out.stride() == (l * h * d, d, h * d, 1)
    return out


# (B, H, L, D) of the v1 kernel's edges: B * H = 15, 3, 35, 33, 18 and 7
# leave the last group of 8 pairs (16 in the tensor-core instances) ragged;
# L = 1, 16, 17, 33, 63, 64, 65, 99, 127, 128 end at or inside a tile of 16
# query rows and a chunk of keys, and on either side of the resident
# design's two key counts (64, 128); L = 129 and 1000 run the chunked design
# past them; D = 16, 32, 64 (FMA chunks of 8, 4, 2 keys; on tensor cores 32,
# 32, 16; D = 64 on the chunked design); L = 1000 needs more than the 227 KB
# of shared memory that K and V of one pair took in the first design
# (2 L D + L floats)
GATHERED_SHAPES = [(3, 5, 1, 32), (3, 5, 33, 16), (3, 5, 99, 64), (1, 3, 127, 32), (1, 2, 1000, 32),
                   (5, 7, 16, 32), (5, 7, 17, 32), (3, 11, 63, 32), (3, 11, 64, 16), (3, 6, 65, 32),
                   (1, 7, 128, 32), (1, 7, 129, 32)]


@pytest.mark.parametrize("layout", ["contiguous", "permuted view", "projection views"])
@pytest.mark.parametrize("b,h,l,d", GATHERED_SHAPES)
def test_gathered_kernel_ragged_shapes_and_layouts(device, b, h, l, d, layout):
    """e_lr random (not Toeplitz), contiguous or a permuted view of a
    (D, L_key, L_query) tensor, which the wrapper copies; or q, k and v as
    the projections' (B, L, H, D) views, which the kernel reads as they are."""
    q, k, v, bias, _ = _inputs(device, b, h, l, d, l)
    e_lr = torch.randn(l, l, d, generator=torch.Generator(device=device).manual_seed(3), device=device) * 0.5
    if layout == "permuted view":
        e_lr = e_lr.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    qkv = _projection_views(q, k, v) if layout == "projection views" else (q, k, v)
    with torch.inference_mode():
        before = attention.GATHERED_ATTENTION.launches
        out = attention.fused_attention(*qkv, bias, e_lr)
        torch.cuda.synchronize()
        assert attention.GATHERED_ATTENTION.launches == before + 1
        ref = attention.fused_attention_reference(q, k, v, bias, e_lr)
    assert out.shape == q.shape and out.device == q.device
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("layout", ["contiguous", "projection views"])
@pytest.mark.parametrize("mode", INSTANCE_MODES)
@pytest.mark.parametrize("b,h,l,d", GATHERED_SHAPES)
def test_gathered_tensor_core_instances_on_ragged_shapes(device, b, h, l, d, mode, layout):
    """Every instance at the v1 kernel's edges (GATHERED_SHAPES: ragged
    groups of pairs, L inside a tile of 16 rows and a chunk of keys and on
    either side of the resident design's limits, L = 1000 over 32 chunks,
    D = 16, 32, 64), on contiguous q, k, v and on the projections' views,
    e_lr random (not Toeplitz) and none (the v2 kernel's rel-off instance)."""
    q, k, v, bias, _ = _inputs(device, b, h, l, d, l, seed=13)
    e_lr = torch.randn(l, l, d, generator=torch.Generator(device=device).manual_seed(4), device=device) * 0.5
    if layout == "projection views":
        q, k, v = _projection_views(q, k, v)
    with torch.inference_mode():
        for e in (e_lr, None):
            out = _gathered_instance_call(q, k, v, bias, e, mode)
            _check_instance(out, lambda mode_: attention.fused_attention_reference(
                q, k, v, bias, e, mode=mode_), mode, lambda mode_: attention.fused_attention(
                q, k, v, bias, e, mode=mode_))


@pytest.mark.parametrize("l", [17, 65, 96, 128, 160])
@pytest.mark.parametrize("mode", INSTANCE_MODES)
def test_gathered_tensor_core_instances_ignore_masked_keys(device, mode, l):
    """e_lr from permuted positions (not Toeplitz), at lengths of both
    tensor-core designs."""
    q, k, v, bias, table = _inputs(device, 4, 6, l, 32, 256, seed=1)
    e_lr = _e_lr(table, l, 256, "permuted")
    masked = (bias < -1.0)[:, None, :, None]
    with torch.inference_mode():
        out1 = attention.fused_attention(q, k, v, bias, e_lr, mode=mode)
        out2 = attention.fused_attention(q, k + 7.0 * masked, v - 3.0 * masked, bias, e_lr, mode=mode)
    assert (out1 - out2).abs().max().item() <= 1e-5


# (L, D) of the f64 instances' resident boundary: L = 64 and 65 on either
# side of the resident design's two key counts, 128 and 129 on either side
# of its limit; D = 64 and L = 129 run the float64 FMA design
F64_EDGES = [(l, d) for l in (64, 65, 128, 129) for d in (16, 32, 64)]


def _e_lr_of(kind, table, l, m, d, device):
    if kind == "random":  # not Toeplitz
        return torch.randn(l, l, d, generator=torch.Generator(device=device).manual_seed(5), device=device) * 0.5
    return _e_lr(table, l, m, kind) if kind else None


@pytest.mark.parametrize("layout", ["contiguous", "projection views"])
@pytest.mark.parametrize("l,d", F64_EDGES)
def test_f64_instances_at_the_resident_boundary(device, l, d, layout):
    """The f64 instances on either side of their resident design's limits
    (B * H = 15: a ragged last item of v1's 16 pairs and of v2's two at
    L <= 64): v2 with and without the table, v1 with e_lr from arange, from
    permuted positions and random, and without it (the v2 rel-off
    instance), each launched once and within 1e-6 relative RMS of the plain
    version in mode "f64"."""
    b, h, m = 3, 5, 256
    q, k, v, bias, table = _inputs(device, b, h, l, d, m, seed=17)
    qkv = _projection_views(q, k, v) if layout == "projection views" else (q, k, v)
    with torch.inference_mode():
        for kw in (dict(rel_table=table, m=m), {}):
            before = attention.REL_ATTENTION.launches_by_instance["f64"]
            out = attention.fused_attention_v2(*qkv, bias, mode="f64", **kw)
            torch.cuda.synchronize()
            assert attention.REL_ATTENTION.launches_by_instance["f64"] == before + 1
            assert out.stride() == (l * h * d, d, h * d, 1)
            assert _rel_rms(out, attention.fused_attention_v2_reference(q, k, v, bias, mode="f64", **kw)) <= 1e-6
        for kind in ("arange", "permuted", "random", None):
            e_lr = _e_lr_of(kind, table, l, m, d, device)
            out = _gathered_instance_call(*qkv, bias, e_lr, "f64")
            assert _rel_rms(out, attention.fused_attention_reference(q, k, v, bias, e_lr, mode="f64")) <= 1e-6, kind


@pytest.mark.parametrize("l,d", [(64, 32), (65, 16), (128, 32), (129, 32)])
def test_f64_instances_ignore_masked_keys(device, l, d):
    """Values at masked keys do not reach the f64 instances' output: v2 with
    and without the table, v1 with e_lr from permuted positions."""
    q, k, v, bias, table = _inputs(device, 4, 6, l, d, 256, seed=2)
    e_lr = _e_lr(table, l, 256, "permuted")
    masked = (bias < -1.0)[:, None, :, None]
    runs = (lambda k_, v_: attention.fused_attention_v2(q, k_, v_, bias, table, 256, mode="f64"),
            lambda k_, v_: attention.fused_attention_v2(q, k_, v_, bias, mode="f64"),
            lambda k_, v_: attention.fused_attention(q, k_, v_, bias, e_lr, mode="f64"))
    with torch.inference_mode():
        for run in runs:
            assert (run(k, v) - run(k + 7.0 * masked, v - 3.0 * masked)).abs().max().item() <= 1e-5


# (L, D) of the TF32x3 instances' resident boundary: L = 64 and 65 on either
# side of the resident designs' two key counts (v2's split-at-load body at
# L <= 64, its planes of parts beyond; v1's one-pass body at both), 128 and
# 129 on either side of their limit; D = 64 and L = 129 run the chunked
# designs
TF32X3_EDGES = [(l, d) for l in (64, 65, 128, 129) for d in (16, 32, 64)]
SPLIT_TOL = 1e-5  # a multi-pass instance against the plain version in its mode (_check_instance)


@pytest.mark.parametrize("layout", ["contiguous", "projection views"])
@pytest.mark.parametrize("l,d", TF32X3_EDGES)
def test_tf32x3_instances_at_the_resident_boundary(device, l, d, layout):
    """The tf32x3 instances on either side of their resident designs' limits
    (B * H = 15: a ragged last item of v1's 16 pairs and of v2's two at
    L <= 64): v2 with and without the table, v1 with e_lr from arange, from
    permuted positions and random, each launched once and within SPLIT_TOL
    relative RMS of the plain version in mode "tf32x3"; and v1's bf16x6 and
    bf16x9, which run the same resident body with bf16 parts on m16n8k16
    (the chunked one past it), the same way in their modes."""
    b, h, m = 3, 5, 256
    q, k, v, bias, table = _inputs(device, b, h, l, d, m, seed=23)
    qkv = _projection_views(q, k, v) if layout == "projection views" else (q, k, v)
    with torch.inference_mode(), precision.matmul_precision("tf32x3"):  # the plain versions' GEMMs: TF32 on parts
        for kw in (dict(rel_table=table, m=m), {}):
            before = attention.REL_ATTENTION.launches_by_instance["tf32x3"]
            out = attention.fused_attention_v2(*qkv, bias, mode="tf32x3", **kw)
            torch.cuda.synchronize()
            assert attention.REL_ATTENTION.launches_by_instance["tf32x3"] == before + 1
            assert out.stride() == (l * h * d, d, h * d, 1)
            plain = attention.fused_attention_v2_reference(q, k, v, bias, mode="tf32x3", **kw)
            assert _rel_rms(out, plain) <= SPLIT_TOL, bool(kw)
    for mode in ("tf32x3", "bf16x6", "bf16x9"):
        with torch.inference_mode(), precision.matmul_precision(mode):
            for kind in ("arange", "permuted", "random"):
                e_lr = _e_lr_of(kind, table, l, m, d, device)
                out = _gathered_instance_call(*qkv, bias, e_lr, mode)
                plain = attention.fused_attention_reference(q, k, v, bias, e_lr, mode=mode)
                assert _rel_rms(out, plain) <= SPLIT_TOL, (mode, kind)


# (L, D) of the 16-bit instances' resident boundary: L = 63, 64,
# 65, 127, 128 and 129 on either side of the resident design's two key
# counts (v2's 16-bit planes at L <= 64 and L <= 128, two pairs or one per
# item), D = 16 and 32; D = 64 and L = 129 run the chunked design
ROUNDING_EDGES = [(l, d) for l in (63, 64, 65, 127, 128, 129) for d in (16, 32)] + [(64, 64), (128, 64)]


@pytest.mark.parametrize("mode", ["bf16", "f16", "f16f16", "bf16bf16"])
@pytest.mark.parametrize("layout", ["contiguous", "projection views"])
@pytest.mark.parametrize("l,d", ROUNDING_EDGES)
def test_rounding_instances_at_the_resident_boundary(device, l, d, layout, mode):
    """The 16-bit instances that run v2's attention_half (bf16 and f16,
    with their float32 QE slices, f16f16 and bf16bf16) on either side of their
    resident design's limits (B * H = 15: a ragged last item of v2's two
    pairs at L <= 64): v2 with and without the table, each launched once and
    within SHARE of the plain version's distance from float32
    (_check_instance)."""
    b, h, m = 3, 5, 256
    q, k, v, bias, table = _inputs(device, b, h, l, d, m, seed=29)
    qkv = _projection_views(q, k, v) if layout == "projection views" else (q, k, v)
    with torch.inference_mode():
        for kw in (dict(rel_table=table, m=m), {}):
            before = dict(attention.REL_ATTENTION.launches_by_instance)
            out = attention.fused_attention_v2(*qkv, bias, mode=mode, **kw)
            torch.cuda.synchronize()
            after = attention.REL_ATTENTION.launches_by_instance
            assert {i: n - before[i] for i, n in after.items()} == {i: int(i == mode) for i in after}
            assert out.stride() == (l * h * d, d, h * d, 1)
            _check_instance(out, lambda mode_: attention.fused_attention_v2_reference(q, k, v, bias, mode=mode_,
                                                                                       **kw), mode)



@pytest.mark.parametrize("mode", ["bf16", "bf16bf16"])
@pytest.mark.parametrize("layout", ["contiguous", "projection views"])
@pytest.mark.parametrize("l,d", ROUNDING_EDGES)
def test_v1_bf16_instances_at_the_resident_boundary(device, l, d, layout, mode):
    """v1's bf16 and bf16bf16 instances, which run the kernel's
    attention_half (16-bit operands on m16n8k16; bf16 with its float32
    relative term) in the resident design and the TF32 chunked body past it,
    on either side of the resident design's limits (B * H = 15: a ragged
    last item of 16 pairs): e_lr from arange, from permuted positions and
    random, each call launching the v1 instance once and no other, within
    SHARE of the plain version's distance from float32 (_check_instance)."""
    b, h, m = 3, 5, 256
    q, k, v, bias, table = _inputs(device, b, h, l, d, m, seed=31)
    qkv = _projection_views(q, k, v) if layout == "projection views" else (q, k, v)
    with torch.inference_mode():
        for kind in ("arange", "permuted", "random"):
            e_lr = _e_lr_of(kind, table, l, m, d, device)
            out = _gathered_instance_call(*qkv, bias, e_lr, mode)
            _check_instance(out, lambda mode_: attention.fused_attention_reference(q, k, v, bias, e_lr, mode=mode_),
                            mode)

F16_OVERFLOW = 7e4  # past f16's largest finite value, 65504 (chip_smoke.py's)


@pytest.mark.parametrize("entry", ["v2", "v1"])
@pytest.mark.parametrize("rel", [True, False])
@pytest.mark.parametrize("l", [64, 128])
def test_f16_instances_keep_f16_infinities(device, l, rel, entry):
    """chip_smoke.py's f16 infinities, with and without relative scores: one
    value of v past 65504 at key 0 (inside every row's length; q scaled by
    0.1, so that no P rounds to 0) makes the f16 and f16f16 instances'
    outputs +inf or -inf in that column, equal to their plain versions',
    and the other columns pass their gate; the TF32 instance keeps it finite
    (the control). v1 without relative scores is the v2 rel-off instance."""
    b, h, d, m = 8, 12, 32, 128
    q, k, v, bias, table = _inputs(device, b, h, l, d, m, seed=31)
    q = q * 0.1
    v[:, :, 0, 0], v[:, :, 0, 1] = F16_OVERFLOW, -F16_OVERFLOW
    if entry == "v2":
        kw = dict(rel_table=table, m=m) if rel else {}
        kernel = lambda mode: attention.fused_attention_v2(*_projection_views(q, k, v), bias, mode=mode, **kw)
        plain = lambda mode: attention.fused_attention_v2_reference(q, k, v, bias, mode=mode, **kw)
    else:
        e_lr = _e_lr(table, l, m, "permuted") if rel else None
        kernel = lambda mode: _gathered_instance_call(q, k, v, bias, e_lr, mode)
        plain = lambda mode: attention.fused_attention_reference(q, k, v, bias, e_lr, mode=mode)
    with torch.inference_mode():
        for mode in ("f16", "f16f16", "tf32"):
            with precision.matmul_precision(mode):  # the plain version's GEMMs as the model runs them: TF32
                ref = plain("f16" if mode == "tf32" else mode)[..., :2]
            assert (ref[..., 0] == np.inf).all() and (ref[..., 1] == -np.inf).all()
            out = kernel(mode)
            assert torch.equal(out[..., :2], ref) == (mode != "tf32"), mode
            if mode != "tf32":
                _check_instance(out[..., 2:], lambda mode_: plain(mode_)[..., 2:], mode)


@pytest.mark.parametrize("l", [17, 65, 128])
def test_tf32x3_instances_ignore_masked_keys(device, l):
    """Values at masked keys do not reach the tf32x3 instances' output: v2
    with and without the table, v1 with e_lr from permuted positions; nor
    v1's bf16x6 and bf16x9 instances', which share v1's resident body."""
    q, k, v, bias, table = _inputs(device, 4, 6, l, 32, 256, seed=3)
    bias[0, l // 2 + 1:] = -10000.0  # at least one masked key
    e_lr = _e_lr(table, l, 256, "permuted")
    masked = (bias < -1.0)[:, None, :, None]
    runs = (lambda k_, v_: attention.fused_attention_v2(q, k_, v_, bias, table, 256, mode="tf32x3"),
            lambda k_, v_: attention.fused_attention_v2(q, k_, v_, bias, mode="tf32x3"),
            *(lambda k_, v_, mode=mode: attention.fused_attention(q, k_, v_, bias, e_lr, mode=mode)
              for mode in ("tf32x3", "bf16x6", "bf16x9")))
    with torch.inference_mode():
        for run in runs:
            assert (run(k, v) - run(k + 7.0 * masked, v - 3.0 * masked)).abs().max().item() <= 1e-5


def _cancelling_inputs(device, b, h, l, d, m, seed):
    """chip_smoke.control_inputs' "cancelling" inputs: q's first quarter of
    dims repeated in its second, k's and the table's negated there, both
    quarters scaled by 64, so that q.k and q.E are the second half's O(1)
    products after partial sums of ~64^2 that cancel exactly (float32 sums
    keep ~1e-3 of them)."""
    q, k, v, bias, table = _inputs(device, b, h, l, d, m, seed)
    quarter = d // 4
    for x in (q, k, table):
        x[..., :2 * quarter] *= 64.0
    q[..., quarter:2 * quarter] = q[..., :quarter]
    k[..., quarter:2 * quarter] = -k[..., :quarter]
    table[..., quarter:2 * quarter] = -table[..., :quarter]
    return q, k, v, bias, table


@pytest.mark.parametrize("b,h,l,d", [(4, 6, 64, 32), (3, 5, 99, 16), (2, 3, 128, 32)])
def test_f64_instances_hold_the_f64_gate_on_cancelling_inputs(device, b, h, l, d):
    """On cancelling inputs the f64 instances (v2 with and without the
    table, v1 with e_lr) stand within 1e-6 relative RMS of the plain
    version in mode "f64"; at D = 32, where eight cancelled terms of ~64^2
    meet in each dot, the FMA instance, whose float32 sums keep ~1e-3 of
    them, outside it (the control, as chip_smoke.py runs it). At D = 16
    four such terms leave the FMA instance inside the gate (2.6e-7 at
    B = 3, H = 5, L = 99 on an H100), so there it is no control."""
    m = 128
    q, k, v, bias, table = _cancelling_inputs(device, b, h, l, d, m, seed=19)
    e_lr = _e_lr(table, l, m, "permuted")
    calls = (lambda mode: attention.fused_attention_v2(q, k, v, bias, table, m, mode=mode),
             lambda mode: attention.fused_attention_v2(q, k, v, bias, mode=mode),
             lambda mode: attention.fused_attention(q, k, v, bias, e_lr, mode=mode))
    plains = (attention.fused_attention_v2_reference(q, k, v, bias, table, m, mode="f64"),
              attention.fused_attention_v2_reference(q, k, v, bias, mode="f64"),
              attention.fused_attention_reference(q, k, v, bias, e_lr, mode="f64"))
    with torch.inference_mode():
        for call, plain in zip(calls, plains):
            assert _rel_rms(call("f64"), plain) <= 1e-6
            if d == 32:
                assert _rel_rms(call("ieee"), plain) > 1e-6


def _at_edge(x: torch.Tensor, edge: str, mode: str) -> torch.Tensor:
    """x moved to an edge of its parts: "two parts", its first two bf16 parts
    alone (the third 0); "ties", halfway between two values of the mode's
    first part (bf16: rounded to even; TF32: away from zero)."""
    if edge == "ties":
        bits = x.view(torch.int32)
        if precision.SPLITS[mode][0] == "bf16":
            return ((bits & -0x10000) | 0x8000).view(torch.float32)
        return ((bits & -0x2000) | 0x1000).view(torch.float32)
    x0 = x.to(torch.bfloat16).float()
    return x0 + (x - x0).to(torch.bfloat16).float()


# The multi-pass instances' inputs at the edges of their parts: q, k and the
# table (e_lr) two bf16 parts long and V's third part subnormal (V scaled by
# 2^-111 ~ 3.9e-34); every value at a rounding tie of the mode's first part;
# magnitudes near 1e30 (q scaled by 2^50 ~ 1.1e15, k and the table by 2^-50,
# V by 2^100 ~ 1.3e30). The outputs are compared divided by V's scale, exact
# for a power of two: squared at that scale they leave float32's range
PART_EDGES = ("two parts, V's third subnormal", "ties", "near 1e30")


@pytest.mark.parametrize("edge", PART_EDGES)
@pytest.mark.parametrize("mode", MULTI_PASS)
@pytest.mark.parametrize("kernel", ["v2", "v1"])
def test_multi_pass_instances_take_their_parts_exactly_at_the_edges(device, kernel, mode, edge):
    """Each multi-pass instance of both kernels against its plain version
    (the existing gates: 1e-5 relative RMS of the plain version in its mode,
    a tenth of the TF32 instance's distance from float32) where a part is
    zero or subnormal, where every value rounds at a tie, and near 1e30:
    the tensor cores take the parts as the plain version's products do."""
    b, h, l, d, m = 3, 4, 100, 32, 128
    q, k, v, bias, table = _inputs(device, b, h, l, d, m, seed=40)
    e_lr = torch.randn(l, l, d, generator=torch.Generator(device=device).manual_seed(41), device=device) * 0.5
    scale = 1.0  # V's
    if edge == "near 1e30":
        scale = 2.0 ** 100
        q, k, v, table, e_lr = q * 2.0 ** 50, k * 2.0 ** -50, v * scale, table * 2.0 ** -50, e_lr * 2.0 ** -50
    else:
        q, k, table, e_lr = (_at_edge(x, edge, mode) for x in (q, k, table, e_lr))
        if edge == "ties":
            v = _at_edge(v, edge, mode)
        else:
            scale = 2.0 ** -111
            v = v * scale
    with torch.inference_mode():
        if kernel == "v2":
            views = _projection_views(q, k, v)
            kernel_out = lambda mode_: attention.fused_attention_v2(*views, bias, table, m, mode=mode_)  # noqa: E731
            plain_out = lambda mode_: attention.fused_attention_v2_reference(  # noqa: E731
                q, k, v, bias, table, m, mode=mode_)
        else:
            kernel_out = lambda mode_: attention.fused_attention(q, k, v, bias, e_lr, mode=mode_)  # noqa: E731
            plain_out = lambda mode_: attention.fused_attention_reference(q, k, v, bias, e_lr, mode=mode_)  # noqa: E731
        out = kernel_out(mode)
        assert torch.isfinite(out).all() and out.abs().max() > 0
        _check_instance(out / scale, lambda mode_: plain_out(mode_) / scale, mode,
                        lambda mode_: kernel_out(mode_) / scale)


def test_gathered_kernel_ignores_masked_keys(device):
    q, k, v, bias, table = _inputs(device, 4, 6, 96, 32, 128, seed=1)
    e_lr = _e_lr(table, 96, 128, "permuted")
    masked = (bias < -1.0)[:, None, :, None]
    with torch.inference_mode():
        out1 = attention.fused_attention(q, k, v, bias, e_lr)
        out2 = attention.fused_attention(q, k + 7.0 * masked, v - 3.0 * masked, bias, e_lr)
    assert (out1 - out2).abs().max().item() <= 1e-5


def test_gathered_wrapper_rejects_what_the_kernel_does_not_take(device):
    q, k, v, bias, table = _inputs(device, 2, 2, 16, 32, 16)
    e_lr = _e_lr(table, 16, 16, "arange")
    with torch.inference_mode():
        with pytest.raises(TypeError, match="float32"):
            attention.fused_attention(q, k, v, bias, e_lr.double())
        with pytest.raises(ValueError, match="share strides"):
            attention.fused_attention(q, _projection_views(q, k, v)[1], v, bias, e_lr)
        with pytest.raises(ValueError, match="head size"):
            attention.fused_attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                                      v[..., :24].contiguous(), bias)
        with pytest.raises(ValueError, match="e_lr must be"):
            attention.fused_attention(q, k, v, bias, e_lr[:8])
        with pytest.raises(ValueError, match="on cpu"):
            attention.fused_attention(q, k, v, bias, e_lr.cpu())
        # contiguous, but one float past a 16-byte boundary: the kernel copies in 16-byte pieces
        shifted = torch.zeros(k.numel() + 1, device=device)[1:].view_as(k)
        with pytest.raises(ValueError, match="16-byte"):
            attention.fused_attention(q, shifted, v, bias, e_lr)
    with pytest.raises(RuntimeError, match="forward-only"):
        attention.fused_attention(q.requires_grad_(), k, v, bias, e_lr)


@pytest.mark.parametrize("noise_scale", [0.7, (0.5, 1.0, 1.5, 2.0, 1.0, 0.8)])
def test_p_sample_step_on_the_card_matches_the_host(device, noise_scale):
    """A per-feature noise scale made on the host is used on the card."""
    g = torch.Generator().manual_seed(4)
    x, eps, noise = (torch.randn(2, 10, 6, generator=g) for _ in range(3))
    mask = torch.ones(2, 10)
    is_angular = torch.tensor([True, True, True, True, True, False])
    scale = torch.tensor(noise_scale) if isinstance(noise_scale, tuple) else noise_scale

    def step(dev):
        schedule = DiffusionSchedule.create("cosine", 100, device=dev)
        return sampling.p_sample_step(lambda *_: eps.to(dev), x.to(dev), 37, noise.to(dev), mask.to(dev),
                                      schedule, is_angular.to(dev), scale)

    ours = step(device)
    assert ours.device.type == "cuda"
    assert (ours.cpu() - step("cpu")).abs().max().item() <= 1e-6


# A small relative_key denoiser (2 x 64, 4 heads of 16): "auto" launches the v2 kernel in every layer
GRAPH_CONFIG = ModelConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
                           max_position_embeddings=64)


def _chain_inputs(device, b=4, l=64):
    g = torch.Generator().manual_seed(9)
    x = ((torch.rand(b, l, 6, generator=g) * 2 - 1) * np.pi).to(device)
    lengths = torch.tensor([64, 50, 41, 33])[:b]
    mask = (torch.arange(l)[None, :] < lengths[:, None]).float().to(device)
    return x, mask


@pytest.mark.parametrize("method", ["ddpm", "ddim"])
def test_graphed_chain_matches_eager_bitwise(device, method):
    """One chain at B = 4, L = 64, T = 50 (DDIM-10 at eta 0.5, so both draw
    inside the graph): x_0, the generator's state after the chain and the v2
    launches equal the eager chain's."""
    model = model_io.init_random(GRAPH_CONFIG, torch.Generator().manual_seed(1)).to(device).eval()
    schedule = DiffusionSchedule.create("cosine", 50, device=device)
    x, mask = _chain_inputs(device)
    out, states, launches = {}, {}, {}
    for graphed in (False, True):
        gen = torch.Generator(device=device).manual_seed(5)
        v2 = attention.REL_ATTENTION.launches
        run = sampling.build_sampler(model, schedule, [True] * 6, method=method, ddim_steps=10, ddim_eta=0.5,
                                     cuda_graphs=graphed)
        out[graphed] = run(x, mask, generator=gen)
        out[graphed, "again"] = run(x, mask, generator=torch.Generator(device=device).manual_seed(5))
        torch.cuda.synchronize()
        states[graphed], launches[graphed] = gen.get_state(), attention.REL_ATTENTION.launches - v2
    assert torch.equal(out[True], out[False]) and torch.equal(out[True, "again"], out[False])
    assert torch.equal(states[True], states[False])
    steps = 50 if method == "ddpm" else 10
    assert launches[True] == launches[False] == 2 * 2 * steps  # two chains, two layers per step


@pytest.fixture
def deterministic():
    """torch.use_deterministic_algorithms while the test runs: the backward
    of the denoiser's distance embedding accumulates with atomics otherwise,
    so that two eager steps differ in their last bits."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def _trainer(device, cuda_graphs, fused=1, pdist=(0.5, 1.0), matmul_precision="default"):
    config = dataclasses.replace(GRAPH_CONFIG, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                                 matmul_precision=matmul_precision)
    model = model_io.init_random(config, torch.Generator().manual_seed(2)).to(device)
    cfg = TrainConfig(lr=1e-3, batch_size=8, max_epochs=10, lr_scheduler="OneCycleLR", fused_steps=fused,
                      use_pdist_loss=pdist)
    return Trainer(model, DiffusionSchedule.create("cosine", 50, device=device), cfg, steps_per_epoch=4,
                   cuda_graphs=cuda_graphs)


def _host_batches(n, b=8, l=64):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        lengths = rng.integers(40, l + 1, b)
        out.append({"angles": rng.uniform(-np.pi, np.pi, (b, l, 6)).astype(np.float32),
                    "attn_mask": (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32),
                    "lengths": lengths.astype(np.int64)})
    return out


def test_graphed_train_steps_match_the_eager_steps_bitwise(device, deterministic):
    """Six updates (dropout 0.1, pdist, one-cycle lr) through the step
    graph (the first runs eagerly at capture, five replay) against six
    train_step calls of the eager trainer (cuda_graphs=False, whose AdamW is
    the same capturable one), from the same weights, generator and dropout
    seed: every loss and parameter bit for bit; then two calls of the graph
    of three steps (fused_steps = 3) against them."""
    batches = _host_batches(6)
    results = []
    for run in ("eager", "graphs", "fused"):
        trainer = _trainer(device, cuda_graphs=run != "eager", fused=3 if run == "fused" else 1)
        torch.manual_seed(7)
        if run == "eager":
            rows = [torch.cat([a[None], t]) for a, t in (trainer.train_step(trainer.to_device(b)) for b in batches)]
            rows = torch.stack(rows)
        elif run == "graphs":
            rows = torch.cat([trainer.train_steps([b]) for b in batches])
        else:
            rows = torch.cat([trainer.train_steps(batches[:3]), trainer.train_steps(batches[3:])])
        results.append((rows, [p.detach().clone() for p in trainer.model.parameters()], trainer.step))
    for rows, params, step in results[1:]:
        assert step == 6 and torch.equal(rows, results[0][0])
        assert all(torch.equal(p, q) for p, q in zip(params, results[0][1]))


def optax_adamw_f32(params, grads, lrs, weight_decay, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adamw's updates (scale_by_adam, add_decayed_weights,
    scale_by_learning_rate, apply_updates) in float32 numpy, step by step:
    params a list of arrays, grads one list like it per step, lrs one
    learning rate per step. Returns the parameters after the last step.
    tests/test_torch_graphs.py holds it against optax itself."""
    f32 = np.float32
    params = [np.array(p, dtype=f32) for p in params]
    mu, nu = [np.zeros_like(p) for p in params], [np.zeros_like(p) for p in params]
    for count, (step_grads, lr) in enumerate(zip(grads, lrs), start=1):
        bc1, bc2 = f32(1) - f32(b1) ** f32(count), f32(1) - f32(b2) ** f32(count)
        for i, g in enumerate(step_grads):
            g = np.asarray(g, dtype=f32)
            mu[i] = f32(1 - b1) * g + f32(b1) * mu[i]
            nu[i] = f32(1 - b2) * (g * g) + f32(b2) * nu[i]
            update = (mu[i] / bc1) / (np.sqrt(nu[i] / bc2) + f32(eps)) + f32(weight_decay) * params[i]
            params[i] = params[i] + f32(-lr) * update
    return params


def test_adamw_on_the_card_is_capturable_and_matches_optax(device):
    """Every trainer's AdamW on the card is the capturable one (graphed or
    not: one arithmetic), its learning rate, step counts and bias
    corrections float32 on the card, as optax's are float32: three updates
    at a changing learning rate within 1e-6 of optax_adamw_f32 (the two
    order the decay and the update differently, so they differ in the last
    bits of a parameter near 1)."""
    g = torch.Generator(device=device).manual_seed(6)
    shapes = [(64, 48), (48,), (7, 3, 5)]
    start = [torch.randn(s, generator=g, device=device) for s in shapes]
    grads = [[torch.randn(s, generator=g, device=device) * 10.0 ** -k for s in shapes] for k in range(3)]
    lrs = [1e-3, 5e-4, 2e-3]
    cfg = TrainConfig(lr=1e-3, l2_norm=0.01)
    ps = [torch.nn.Parameter(p.clone()) for p in start]
    optimizer = build_optimizer(cfg, ps)
    group = optimizer.param_groups[0]
    assert group["capturable"] and torch.is_tensor(group["lr"]) and group["lr"].device.type == "cuda"
    for step_grads, lr in zip(grads, lrs):
        for p, grad in zip(ps, step_grads):
            p.grad = grad.clone()
        group["lr"].fill_(lr)
        optimizer.step()
    assert all(s["step"].device.type == "cuda" for s in optimizer.state.values())
    ref = optax_adamw_f32([p.cpu().numpy() for p in start], [[x.cpu().numpy() for x in gs] for gs in grads], lrs,
                          cfg.l2_norm)
    assert max(np.abs(p.detach().cpu().numpy() - r).max() for p, r in zip(ps, ref)) <= 1e-6
    for cuda_graphs in (False, True):
        assert _trainer(device, cuda_graphs).optimizer.param_groups[0]["capturable"]


MULTI_PASS_DRIFT = {"TF32_TF32_F32_X3": 1e-4, "BF16_BF16_F32_X3": 5e-4, "BF16_BF16_F32_X6": 1e-4,
                    "BF16_BF16_F32_X9": 1e-4}


def test_tf32_and_bf16_forwards_differ_from_highest_within_bounds(device):
    """The same weights at "high" (TF32), "BF16_BF16_F32" and at "default"
    under a caller's TF32 (set_process_default, as the command-line
    programs set it) differ from "highest" by more than 0 (the mode took
    effect) and by at most chip_smoke.py phase 13's bounds (relative RMS 1e-2
    and 5e-2); the multi-pass presets by more than 0, at most 1e-4 (5e-4 at
    BF16_BF16_F32_X3) and at most a tenth of TF32's drift; "default" under
    the caller's IEEE setting is "highest" bit for bit. The caller's setting
    is kept."""
    x, mask = _chain_inputs(device)
    t = torch.arange(x.shape[0], device=device) * 7
    outs = {}
    for name, caller in (("highest", "ieee"), ("high", "ieee"), ("BF16_BF16_F32", "ieee"), ("default", "ieee"),
                         ("default", "tf32"), *((p, "ieee") for p in MULTI_PASS_DRIFT)):
        torch.backends.cuda.matmul.fp32_precision = caller
        config = dataclasses.replace(GRAPH_CONFIG, matmul_precision=name)
        model = model_io.init_random(config, torch.Generator().manual_seed(1)).to(device).eval()
        with torch.inference_mode():
            outs[name, caller] = model(x, t, mask)
        assert torch.backends.cuda.matmul.fp32_precision == caller
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    ref = outs["highest", "ieee"]
    assert torch.equal(outs["default", "ieee"], ref)
    for key, bound in ((("high", "ieee"), 1e-2), (("default", "tf32"), 1e-2), (("BF16_BF16_F32", "ieee"), 5e-2)):
        rel = ((outs[key] - ref).square().mean().sqrt() / ref.square().mean().sqrt()).item()
        assert 0 < rel <= bound, (key, rel)
    tf32 = _rel_rms(outs["high", "ieee"], ref)
    for name, bound in MULTI_PASS_DRIFT.items():
        rel = _rel_rms(outs[name, "ieee"], ref)
        assert 0 < rel <= min(bound, 0.1 * tf32), (name, rel, tf32)


@pytest.mark.parametrize("mode", ["bf16", "ieee"])
def test_bf16_linear_on_the_card_matches_its_plain_version(device, mode):
    """The bf16 Linear (forward and both backward products: float32 GEMMs of
    bf16-rounded values) on the card, under the bf16 mode's TF32 scope and
    under IEEE float32, against the same on the CPU: the same exact
    products, summed in another order."""
    g = torch.Generator().manual_seed(3)
    x, w, b = torch.randn(64, 128, 384, generator=g), torch.randn(768, 384, generator=g), torch.randn(768, generator=g)
    grad = torch.randn(64, 128, 768, generator=g)
    results = {}
    for dev in ("cpu", device):
        xs, ws, bs = (t.detach().to(dev).requires_grad_() for t in (x, w, b))
        with precision.matmul_precision(mode):
            out = precision.linear(xs, ws, bs, "bf16")
            out.backward(grad.to(dev))
        results[dev] = [t.detach().cpu() for t in (out, xs.grad, ws.grad, bs.grad)]
    assert results[device][0].dtype == torch.float32
    assert not torch.equal(results[device][0], results[device][0].bfloat16().float())  # not rounded to bf16
    for ours, ref in zip(results[device], results["cpu"]):
        assert (ours - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("mode", MULTI_PASS)
def test_multi_pass_linear_on_the_card_matches_its_cpu_twin(device, mode):
    """The split Linear (forward and both backward products: one TF32 GEMM
    over the parts of each) on the card under its mode's scope against the
    same on the CPU: the same exact products, summed in another order; and
    nearer float32's product than the TF32 GEMM is. Each within 1e-5 of its
    largest element at up to 8,192 summed products (the bf16 Linear's
    bound above), and sqrt(K / 8,192) times that at K products, as float32
    sums of random terms drift: the weight's gradient sums the parts'
    products over 64 x 128 tokens, K = 24,576 to 73,728."""
    g = torch.Generator().manual_seed(4)
    x, w, b = torch.randn(64, 128, 384, generator=g), torch.randn(768, 384, generator=g), torch.randn(768, generator=g)
    grad = torch.randn(64, 128, 768, generator=g)
    results = {}
    for dev in ("cpu", device):
        xs, ws, bs = (t.detach().to(dev).requires_grad_() for t in (x, w, b))
        with precision.matmul_precision(mode):
            out = precision.linear(xs, ws, bs, mode)
            out.backward(grad.to(dev))
        results[dev] = [t.detach().cpu() for t in (out, xs.grad, ws.grad, bs.grad)]
    products = len(precision.SPLITS[mode][2])
    summed = (products * 384, products * 768, products * 64 * 128, 64 * 128)  # out, x's, w's and b's gradients
    for ours, ref, k in zip(results[device], results["cpu"], summed):
        assert (ours - ref).abs().max().item() <= 1e-5 * max(1.0, k / 8192) ** 0.5 * ref.abs().max().item()
    f32 = torch.nn.functional.linear(x.double(), w.double(), b.double()).float()
    with precision.matmul_precision("tf32"):
        tf32 = torch.nn.functional.linear(x.to(device), w.to(device), b.to(device)).cpu()
    assert _rel_rms(results[device][0], f32) < 0.1 * _rel_rms(tf32, f32)


def test_models_and_captures_keep_the_callers_setting(device):
    """A "high" model's forward, its graphed train steps (the capture and
    the replays) and an exception inside its forward leave the caller's
    fp32_precision as it was."""
    matmul = torch.backends.cuda.matmul
    for caller in ("ieee", "none"):
        matmul.fp32_precision = caller
        trainer = _trainer(device, cuda_graphs=True, matmul_precision="high")
        trainer.train_steps(_host_batches(2)[:1])
        trainer.train_steps(_host_batches(2)[1:])
        assert matmul.fp32_precision == caller
        x, mask = _chain_inputs(device)
        with pytest.raises(RuntimeError):
            trainer.model(x[..., :5], torch.zeros(x.shape[0], dtype=torch.long, device=device), mask)
        assert matmul.fp32_precision == caller
    matmul.fp32_precision = "ieee"


def test_the_collector_is_paused_while_a_step_graph_captures(device):
    """A collection inside a capture may destroy a dead graph held in a
    reference cycle (a trainer and its step graphs form one), which breaks
    the capture: the collector is off while the body is captured, and as it
    was after."""
    x = torch.zeros(4, device=device)
    seen = []

    def body():
        seen.append((torch.cuda.is_current_stream_capturing(), gc.isenabled()))
        return x.add_(1)

    assert gc.isenabled()
    graph = StepGraph(body, device)
    graph()
    graph()
    assert seen == [(False, True), (True, False)] and gc.isenabled()
    assert x.tolist() == [2.0] * 4  # the eager first call and one replay
