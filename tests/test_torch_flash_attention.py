"""The port's flash attention against the JAX package's Pallas kernel.

Inputs come from numpy with a seed and reach both sides as numpy arrays.
On the CPU the JAX kernel runs in Pallas interpret mode (as
tests/test_flash_attention.py runs it) and the port's wrapper takes its
plain version, so these hold the plain version's algorithm (64-wide tiles,
online softmax, masks, GQA mapping, lse convention) to the reference; the
JAX side blocks by `block`, so the two sum in different orders. Several
shapes run past one 64-wide tile and end in a ragged one. The CUDA kernel
is held to the plain version in tests/test_torch_cuda.py.

Tolerances. float32: out and lse within 1e-5 absolute (both sides do f32
arithmetic in another summation order). bfloat16 inputs: both sides upcast
to f32 inside; out is rounded to bf16 at the end, so out agrees within
bf16 rounding of values of magnitude <= ~3 (2**-8 * 4 = 1.6e-2) and lse,
which stays f32, within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from runbooks_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd

from runbooks_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_fwd,
    flash_attention_reference,
)

torch.set_num_threads(2)

F32_ATOL = 1e-5
BF16_OUT_ATOL = 1.6e-2


def _inputs(seed, b, sq, sk, h, kvh, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, kvh, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, kvh, d), dtype=np.float32)
    return q, k, v


def _both(q, k, v, q_pos, kv_pos, q_seg=None, kv_seg=None, causal=True,
          block=32, block_skip=True, dtype="float32"):
    scale = q.shape[-1] ** -0.5
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    j_out, j_lse = jax_flash_fwd(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(q_pos), jnp.asarray(kv_pos),
        None if q_seg is None else jnp.asarray(q_seg),
        None if kv_seg is None else jnp.asarray(kv_seg),
        scale, causal, block, block, block_skip)
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    t_out, t_lse = flash_attention_fwd(
        t(q).to(td), t(k).to(td), t(v).to(td), t(q_pos), t(kv_pos),
        t(q_seg), t(kv_seg), causal, None, block_skip)
    return (np.asarray(j_out, np.float32), np.asarray(j_lse),
            t_out.float().numpy(), t_lse.numpy())


def _arange(b, n, start=0):
    return np.broadcast_to(np.arange(start, start + n, dtype=np.int32),
                           (b, n)).copy()


@pytest.mark.parametrize("kvh", [4, 2, 1])   # n_rep 1, 2, 4
def test_causal_block_skip_gqa(kvh):
    b, s, h, d = 2, 160, 4, 32
    q, k, v = _inputs(0, b, s, s, h, kvh, d)
    pos = _arange(b, s)
    j_out, j_lse, t_out, t_lse = _both(q, k, v, pos, pos, block=32)
    np.testing.assert_allclose(t_out, j_out, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(t_lse, j_lse, atol=F32_ATOL, rtol=0)


def test_offset_queries_ragged_kv():
    # The serving prefill's shape: queries start mid-cache (sq != sk), the
    # kv length is no tile multiple, block skip is off, and two padding
    # query rows sit at the trash position and see every key.
    b, sq, sk, h, kvh, d = 2, 24, 150, 4, 2, 32
    q, k, v = _inputs(1, b, sq, sk, h, kvh, d)
    q_pos = _arange(b, sq, start=11)
    q_pos[:, -2:] = sk - 1
    kv_pos = _arange(b, sk)
    j_out, j_lse, t_out, t_lse = _both(q, k, v, q_pos, kv_pos, block=16,
                                       block_skip=False)
    np.testing.assert_allclose(t_out, j_out, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(t_lse, j_lse, atol=F32_ATOL, rtol=0)


def test_segments_and_fully_masked_rows():
    b, s, h, kvh, d = 2, 48, 4, 2, 32
    q, k, v = _inputs(2, b, s, s, h, kvh, d)
    seg = np.ones((b, s), np.int32)
    seg[:, 20:36] = 2
    seg[:, 36:] = 0                       # padding: fully masked rows
    pos = np.concatenate([np.arange(20), np.arange(16), np.arange(12)])
    pos = np.broadcast_to(pos, (b, s)).astype(np.int32).copy()
    j_out, j_lse, t_out, t_lse = _both(q, k, v, pos, pos, seg, seg,
                                       block=16)
    np.testing.assert_allclose(t_out, j_out, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(t_lse, j_lse, atol=F32_ATOL, rtol=0)
    assert np.all(t_out[:, 36:] == 0.0)
    assert np.all(t_lse[:, :, 36:] == np.float32(NEG_INF))


def test_query_before_every_key_is_fully_masked():
    b, sq, sk, h, d = 1, 16, 20, 2, 32
    q, k, v = _inputs(3, b, sq, sk, h, h, d)
    q_pos = _arange(b, sq)
    kv_pos = _arange(b, sk, start=8)       # rows 0..7 see no key
    j_out, j_lse, t_out, t_lse = _both(q, k, v, q_pos, kv_pos, block=16,
                                       block_skip=False)
    np.testing.assert_allclose(t_out, j_out, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(t_lse, j_lse, atol=F32_ATOL, rtol=0)
    assert np.all(t_out[:, :8] == 0.0) and not np.isnan(t_out).any()
    assert np.all(t_lse[:, :, :8] == np.float32(NEG_INF))


def test_noncausal_with_padding_keys():
    b, s, h, d = 2, 40, 2, 32
    q, k, v = _inputs(4, b, s, s, h, h, d)
    pos = _arange(b, s)
    kv_pos = pos.copy()
    kv_pos[:, -5:] = 2 ** 30               # PAD_POS keys are always masked
    j_out, j_lse, t_out, t_lse = _both(q, k, v, pos, kv_pos, causal=False,
                                       block=16)
    np.testing.assert_allclose(t_out, j_out, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(t_lse, j_lse, atol=F32_ATOL, rtol=0)


def test_bf16_inputs():
    b, sq, sk, h, kvh, d = 2, 32, 100, 4, 1, 32
    q, k, v = _inputs(5, b, sq, sk, h, kvh, d)
    q_pos = _arange(b, sq, start=13)
    kv_pos = _arange(b, sk)
    j_out, j_lse, t_out, t_lse = _both(q, k, v, q_pos, kv_pos, block=16,
                                       block_skip=False, dtype="bfloat16")
    np.testing.assert_allclose(t_out, j_out, atol=BF16_OUT_ATOL, rtol=0)
    np.testing.assert_allclose(t_lse, j_lse, atol=F32_ATOL, rtol=0)


def test_public_op_returns_out_only():
    b, s, h, d = 1, 16, 2, 32
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, b, s, s, h, h, d))
    pos = torch.from_numpy(_arange(b, s))
    out = flash_attention(q, k, v, pos, pos)
    ref, _ = flash_attention_reference(q, k, v, pos, pos)
    assert torch.equal(out, ref)


def test_cpu_tensor_never_launches_the_kernel():
    before = flash_attention.launches
    b, s, h, d = 1, 16, 2, 32
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, b, s, s, h, h, d))
    pos = torch.from_numpy(_arange(b, s))
    flash_attention(q.to(torch.bfloat16), k.to(torch.bfloat16),
                    v.to(torch.bfloat16), pos, pos)
    assert flash_attention.launches == before
