"""
Tests that need an NVIDIA GPU: the CUDA attention kernel
(csrc/rel_attention.cu) against its plain PyTorch version, the wrapper's
input checks, and a reverse step on the card. They skip without a card.
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
        before = attention.launches
        out = attention.fused_attention_v2(q, k, v, bias, table, m)
        torch.cuda.synchronize()
        assert attention.launches == before + 1
        ref = attention.fused_attention_v2_reference(q, k, v, bias, table, m)
    assert out.shape == q.shape and out.device == q.device
    assert (out - ref).abs().max().item() <= 1e-4


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
        with pytest.raises(ValueError, match="contiguous"):
            attention.fused_attention_v2(q.transpose(1, 2), k, v, bias)
        with pytest.raises(ValueError, match="head size"):
            attention.fused_attention_v2(q[..., :24].contiguous(), k[..., :24].contiguous(),
                                         v[..., :24].contiguous(), bias)
        with pytest.raises(ValueError, match="exceeds"):
            attention.fused_attention_v2(q, k, v, bias, table[:15].contiguous(), 8)
        with pytest.raises(ValueError, match="on cpu"):
            attention.fused_attention_v2(q, k, v, bias.cpu())
    with pytest.raises(RuntimeError, match="forward-only"):
        attention.fused_attention_v2(q.requires_grad_(), k, v, bias)


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
