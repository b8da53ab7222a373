"""
The port's fused_attention_v2 (ops/attention.py) against the JAX package's
Pallas entry (interpret mode on the CPU) and its jnp reference, as
tests/test_pallas_attention.py runs them. On a CPU tensor the port runs its
plain PyTorch version; the CUDA kernel is compared with that version on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldingdiff_tpu.ops.pallas_attention import attention_reference
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


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, k, v, bias, table = map(torch.from_numpy, _inputs(2, 2, 16, 16, 16, seed=6))
    before = attention.launches
    out = attention.fused_attention_v2(q, k, v, bias, rel_table=table, m=16)
    assert attention.launches == before
    torch.testing.assert_close(out, attention.fused_attention_v2_reference(q, k, v, bias, table, 16),
                               rtol=0, atol=0)


def test_other_devices_raise():
    q = torch.empty(1, 1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        attention.fused_attention_v2(q, q, q, torch.empty(1, 4, device="meta"))


def test_library_path_is_keyed_by_source_and_flags(monkeypatch):
    path = attention.library_path()
    assert path.parent == attention.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setattr(attention, "NVCC_FLAGS", attention.NVCC_FLAGS + ("-DEXTRA",))
    assert attention.library_path() != path
