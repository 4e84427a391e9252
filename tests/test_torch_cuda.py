"""Card-only tests of the port's CUDA kernels against their plain PyTorch
versions. They import neither jax nor runbooks_tpu, so they run on a
machine without JAX, skipping the JAX-pinning tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a GPU each test skips (the kernels have no CPU mode).
"""

import pytest
import torch

from runbooks_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_reference,
)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The CUDA kernel against its plain version at the serving prefill's
    shapes (bf16, GQA 32/8, d=128, ragged kv of 2049). out within
    1e-2 + 1e-2 * |plain| (bf16 output, one ulp is 2**-7 relative, and bf16
    P in the value product), lse within 1e-3 (f32 throughout)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for rows, sq, sk, start, hk in ((1, 256, 2049, 0, 8),
                                    (2, 128, 2049, 100, 8),
                                    (1, 64, 300, 7, 32)):
        q = torch.randn((rows, sq, 32, 128), generator=g, device=dev,
                        dtype=torch.bfloat16)
        k = torch.randn((rows, sk, hk, 128), generator=g, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn_like(k)
        q_pos = (start + torch.arange(sq, device=dev,
                                      dtype=torch.int32)).expand(rows, sq)
        kv_pos = torch.arange(sk, device=dev,
                              dtype=torch.int32).expand(rows, sk)
        out, lse = flash_attention_fwd(q, k, v, q_pos, kv_pos,
                                       block_skip=False)
        ref, ref_lse = flash_attention_reference(
            q, k, v, q_pos, kv_pos, block_skip=False)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                                   rtol=1e-2)
        assert torch.isfinite(out.float()).all()
        assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.cuda
def test_kernel_launch_is_counted_and_checked():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    dev = torch.device("cuda")
    q = torch.zeros((1, 16, 4, 128), device=dev, dtype=torch.bfloat16)
    k = torch.zeros((1, 16, 2, 128), device=dev, dtype=torch.bfloat16)
    pos = torch.arange(16, device=dev, dtype=torch.int32)[None]
    before = flash_attention.launches
    flash_attention(q, k, k, pos, pos)
    assert flash_attention.launches == before + 1
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), k.float(), pos, pos)
    with pytest.raises(ValueError):
        flash_attention(q[..., :96], k[..., :96], k[..., :96], pos, pos)
    assert flash_attention.launches == before + 1
