"""
Tests that need an NVIDIA GPU: the two CUDA attention kernels
(csrc/rel_attention.cu, csrc/gathered_attention.cu) against their plain
PyTorch versions, the wrappers' input checks, and a reverse step on the card. They skip without a card.
They import no JAX, so they also run on a machine that has none, without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import pytest
import torch

from foldingdiff_tpu_torch.diffusion import sampling
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.ops import attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
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


# (B, H, L, D) of the v1 kernel's edges: B * H = 15 and 3 leave the last group
# of 8 pairs ragged; L = 1, 33, 99, 127 end inside a tile of 16 query rows and
# inside a chunk of keys; D = 16, 32, 64 (chunks of 8, 4, 2 keys); L = 1000
# needs more than the 227 KB of shared memory that K and V of one pair took in
# the first design (2 L D + L floats)
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
