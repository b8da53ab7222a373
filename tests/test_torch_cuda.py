"""
Tests that need an NVIDIA GPU: the two CUDA attention kernels
(csrc/rel_attention.cu, csrc/gathered_attention.cu) against their plain
PyTorch versions, each instance (v2: float32 FMA, TF32 and bf16 tensor
cores; v1: FMA and bf16) against the plain version in its mode, the
wrappers' input checks, a reverse step on the card,
the CUDA graphs of the reverse chains and the train step against the
eager ones (bitwise, with the kernels' launches counted), and
matmul_precision on the card (TF32 and bf16 against "highest", "default"
at the caller's setting, the caller's setting kept). They skip without a
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


def _check_instance(out, run_plain, mode):
    """An instance's output against the plain version: FMA within 1e-4 of
    float32's; TF32 within 5e-3 relative RMS of float32's; bf16 within a
    tenth of the plain bf16 version's own relative-RMS distance from
    float32, and within 5e-2 of float32."""
    f32 = run_plain("ieee")
    if mode == "ieee":
        assert (out - f32).abs().max().item() <= 1e-4
    elif mode == "tf32":
        assert 0 < _rel_rms(out, f32) <= 5e-3
    else:
        plain = run_plain("bf16")
        gap = _rel_rms(plain, f32)
        assert gap > 0 and _rel_rms(out, plain) <= 0.1 * gap and _rel_rms(out, f32) <= 5e-2


# (B, H, L, D, M) of the instances' checks: the flagship and the sweep's two
# chunks; ragged L inside a 16-row warp tile and an 8-key tile (50, 127, 33,
# 99); L = 200 over four chunks of keys (the bf16 instance's two passes);
# L = 1; D 16, 32, 64
INSTANCE_SHAPES = [(8, 12, 128, 32, 128), (15, 12, 64, 32, 128), (63, 12, 128, 32, 128), (8, 12, 50, 32, 128),
                   (8, 12, 127, 32, 128), (4, 6, 33, 16, 64), (2, 4, 99, 64, 128), (2, 3, 200, 32, 256),
                   (3, 2, 1, 32, 128)]


@pytest.mark.parametrize("mode", ["ieee", "tf32", "bf16"])
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
                        mode)


@pytest.mark.parametrize("mode", ["tf32", "bf16"])
def test_v2_instance_ignores_masked_keys(device, mode):
    q, k, v, bias, table = _inputs(device, 64, 12, 96, 32, 128, seed=6)
    masked = (bias < -1.0)[:, None, :, None]
    with torch.inference_mode():
        out1 = attention.fused_attention_v2(*_projection_views(q, k, v), bias, table, 128, mode=mode)
        out2 = attention.fused_attention_v2(*_projection_views(q, k + 7.0 * masked, v - 3.0 * masked),
                                            bias, table, 128, mode=mode)
    assert (out1 - out2).abs().max().item() <= 1e-5


@pytest.mark.parametrize("mode", ["tf32", "bf16"])
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
    a "high" model's TF32 and a "BF16_BF16_F32" model's bf16 whatever the
    caller's setting."""
    x, mask = _chain_inputs(device)
    t = torch.zeros(x.shape[0], dtype=torch.long, device=device)
    torch.backends.cuda.matmul.fp32_precision = setting
    try:
        for name, want in (("default", instance), ("high", "tf32"), ("BF16_BF16_F32", "bf16")):
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
    with torch.inference_mode():
        before = attention.GATHERED_ATTENTION.launches
        out = attention.fused_attention(q, k, v, bias, e_lr)
        torch.cuda.synchronize()
        assert attention.GATHERED_ATTENTION.launches == before + 1
        ref = attention.fused_attention_reference(q, k, v, bias, e_lr)
    assert out.shape == q.shape and out.device == q.device
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("e_lr_kind", ["permuted", "random", None])
@pytest.mark.parametrize("b,h,l,d,m", [(8, 12, 128, 32, 128), (15, 12, 64, 32, 128), (4, 6, 33, 16, 64),
                                       (2, 4, 99, 64, 128), (3, 2, 1, 32, 128)])
def test_gathered_bf16_instance_matches_its_plain_version(device, b, h, l, d, m, e_lr_kind):
    """v1 under "bf16": bf16 values on TF32 tensor cores (q, k, v, e_lr and
    the normalised P rounded) against the plain version's bf16 products;
    under "tf32" the TF32 instance against float32."""
    q, k, v, bias, table = _inputs(device, b, h, l, d, m, seed=12)
    if e_lr_kind == "random":
        e_lr = torch.randn(l, l, d, generator=torch.Generator(device=device).manual_seed(2), device=device) * 0.5
    else:
        e_lr = _e_lr(table, l, m, e_lr_kind) if e_lr_kind else None
    with torch.inference_mode():
        for mode in ("bf16", "tf32"):
            out = _gathered_instance_call(q, k, v, bias, e_lr, mode)
            _check_instance(out, lambda mode_: attention.fused_attention_reference(
                q, k, v, bias, e_lr, bf16=mode_ == "bf16"), mode)


def _gathered_instance_call(q, k, v, bias, e_lr, mode):
    """fused_attention in `mode`, which must launch V1_INSTANCES[mode] once
    and no other instance."""
    before = dict(attention.GATHERED_ATTENTION.launches_by_instance)
    out = attention.fused_attention(q, k, v, bias, e_lr, mode=mode)
    torch.cuda.synchronize()
    added = {i: n - before[i] for i, n in attention.GATHERED_ATTENTION.launches_by_instance.items()}
    assert added == {i: int(i == attention.V1_INSTANCES[mode]) for i in added}
    return out


# (B, H, L, D) of the v1 kernel's edges: B * H = 15 and 3 leave the last group
# of 8 pairs (16 in the tensor-core instances) ragged; L = 1, 33, 99, 127 end
# inside a tile of 16 query rows and inside a chunk of keys; D = 16, 32, 64
# (FMA chunks of 8, 4, 2 keys; on tensor cores 32, 32, 16); L = 1000 needs
# more than the 227 KB of shared memory that K and V of one pair took in the
# first design (2 L D + L floats)
GATHERED_SHAPES = [(3, 5, 1, 32), (3, 5, 33, 16), (3, 5, 99, 64), (1, 3, 127, 32), (1, 2, 1000, 32)]


@pytest.mark.parametrize("layout", ["contiguous", "permuted view"])
@pytest.mark.parametrize("b,h,l,d", GATHERED_SHAPES)
def test_gathered_kernel_ragged_shapes_and_layouts(device, b, h, l, d, layout):
    """e_lr random (not Toeplitz), contiguous or a permuted view of a
    (D, L_key, L_query) tensor, which the wrapper copies."""
    q, k, v, bias, _ = _inputs(device, b, h, l, d, l)
    e_lr = torch.randn(l, l, d, generator=torch.Generator(device=device).manual_seed(3), device=device) * 0.5
    if layout == "permuted view":
        e_lr = e_lr.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    with torch.inference_mode():
        before = attention.GATHERED_ATTENTION.launches
        out = attention.fused_attention(q, k, v, bias, e_lr)
        torch.cuda.synchronize()
        assert attention.GATHERED_ATTENTION.launches == before + 1
        ref = attention.fused_attention_reference(q, k, v, bias, e_lr)
    assert out.shape == q.shape and out.device == q.device
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("mode", ["tf32", "bf16"])
@pytest.mark.parametrize("b,h,l,d", GATHERED_SHAPES)
def test_gathered_tensor_core_instances_on_ragged_shapes(device, b, h, l, d, mode):
    """The TF32 and bf16 instances at the v1 kernel's edges (a ragged group
    of 16 pairs, L inside a tile of 16 rows and a chunk of keys, L = 1000
    over 32 chunks, D = 16, 32, 64), e_lr random (not Toeplitz) and none."""
    q, k, v, bias, _ = _inputs(device, b, h, l, d, l, seed=13)
    e_lr = torch.randn(l, l, d, generator=torch.Generator(device=device).manual_seed(4), device=device) * 0.5
    with torch.inference_mode():
        for e in (e_lr, None):
            out = _gathered_instance_call(q, k, v, bias, e, mode)
            _check_instance(out, lambda mode_: attention.fused_attention_reference(
                q, k, v, bias, e, bf16=mode_ == "bf16"), mode)


@pytest.mark.parametrize("mode", ["tf32", "bf16"])
def test_gathered_tensor_core_instances_ignore_masked_keys(device, mode):
    q, k, v, bias, table = _inputs(device, 4, 6, 96, 32, 128, seed=1)
    e_lr = _e_lr(table, 96, 128, "permuted")
    masked = (bias < -1.0)[:, None, :, None]
    with torch.inference_mode():
        out1 = attention.fused_attention(q, k, v, bias, e_lr, mode=mode)
        out2 = attention.fused_attention(q, k + 7.0 * masked, v - 3.0 * masked, bias, e_lr, mode=mode)
    assert (out1 - out2).abs().max().item() <= 1e-5


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
        with pytest.raises(ValueError, match="contiguous"):
            attention.fused_attention(q, k.transpose(1, 2), v, bias, e_lr)
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


def test_tf32_and_bf16_forwards_differ_from_highest_within_bounds(device):
    """The same weights at "high" (TF32), "BF16_BF16_F32" and at "default"
    under a caller's TF32 (set_process_default, as the command-line
    programs set it) differ from "highest" by more than 0 (the mode took
    effect) and by at most chip_smoke.py phase 13's bounds (relative RMS 1e-2
    and 5e-2); "default" under the caller's IEEE setting is "highest" bit
    for bit. The caller's setting is kept."""
    x, mask = _chain_inputs(device)
    t = torch.arange(x.shape[0], device=device) * 7
    outs = {}
    for name, caller in (("highest", "ieee"), ("high", "ieee"), ("BF16_BF16_F32", "ieee"), ("default", "ieee"),
                         ("default", "tf32")):
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
