"""The port's flash attention backward against the JAX package's.

Inputs come from numpy with a seed and reach both sides as numpy arrays.
The JAX backward kernels run in Pallas interpret mode (as
tests/test_flash_attention.py runs them) and the port's wrapper takes its
plain version for CPU tensors, so these hold the plain version's algorithm
(64-wide tiles, masks, the NEG_INF guard on lse, the causal skip, the GQA
fold) to the reference. Both backward passes get the same (out, lse), the
JAX forward's. The CUDA kernels are held to the plain version in
tests/test_torch_cuda.py.

Tolerance: float32 throughout, so gradients agree within 1e-5 absolute
plus 1e-5 relative (the two sum in other orders: the JAX side blocks by
`block`, the port by 64, and folds the GQA group in f32 too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbooks_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd
from runbooks_tpu.ops.flash_attention import flash_attention as jax_flash
from runbooks_tpu.ops.flash_attention import (
    flash_attention_bwd as jax_flash_bwd,
)

from runbooks_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
)

torch.set_num_threads(2)

ATOL = 1e-5
RTOL = 1e-5


def _inputs(seed, b, sq, sk, h, kvh, d):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return f(b, sq, h, d), f(b, sk, kvh, d), f(b, sk, kvh, d), f(b, sq, h, d)


def _arange(b, n, start=0):
    return np.broadcast_to(np.arange(start, start + n, dtype=np.int32),
                           (b, n)).copy()


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a).copy())


def _both_bwd(q, k, v, do, q_pos, kv_pos, q_seg=None, kv_seg=None,
              block=32, block_skip=True, dtype=jnp.float32,
              grad_dtype=None):
    """(JAX dq, dk, dv), (port dq, dk, dv) as f32 numpy, from the same
    inputs and the same forward residuals."""
    scale = q.shape[-1] ** -0.5
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    out, lse = jax_flash_fwd(jq, jk, jv, j(q_pos), j(kv_pos), j(q_seg),
                             j(kv_seg), scale, True, block, block,
                             block_skip)
    jg = jax_flash_bwd(jq, jk, jv, j(q_pos), j(kv_pos), j(q_seg), j(kv_seg),
                       out, lse, jdo, causal=True, scale=scale,
                       block_q=block, block_k=block, block_skip=block_skip,
                       grad_dtype=grad_dtype)
    td = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tt = lambda a: _t(np.asarray(a, np.float32)).to(td)  # noqa: E731
    tg = flash_attention_bwd(
        tt(q), tt(k), tt(v), _t(q_pos), _t(kv_pos), _t(q_seg), _t(kv_seg),
        tt(out), _t(np.asarray(lse)), tt(do), block_skip=block_skip,
        grad_dtype=None if grad_dtype is None else torch.float32)
    return ([np.asarray(g, np.float32) for g in jg],
            [g.float().numpy() for g in tg], tg)


def _close(jg, tg):
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("h,kvh,d", [
    pytest.param(4, 4, 32, id="4"),     # n_rep 1, 2, 4
    pytest.param(4, 2, 32, id="2"),
    pytest.param(4, 1, 32, id="1"),
    pytest.param(2, 1, 256, id="gemma2b_d256"),   # 2 on 1 at gemma's 256
])
def test_causal_skip_gqa_ragged(h, kvh, d):
    # 100 rows: a ragged last tile on both sides (JAX blocks 32, port 64).
    b, s = 2, 100
    q, k, v, do = _inputs(0, b, s, s, h, kvh, d)
    pos = _arange(b, s)
    jg, tg, _ = _both_bwd(q, k, v, do, pos, pos)
    _close(jg, tg)


def test_segments_with_padding_rows():
    _segments_with_padding_rows(4, 2, 32)


def test_segments_with_padding_rows_at_head_dim_256():
    """Gemma's head_dim: 2 query heads on 1 kv head."""
    _segments_with_padding_rows(2, 1, 256)


def _segments_with_padding_rows(h, kvh, d):
    b, s = 2, 96
    q, k, v, do = _inputs(1, b, s, s, h, kvh, d)
    seg = np.ones((b, s), np.int32)
    seg[:, 30:70] = 2
    seg[:, 70:] = 0                         # padding: fully masked rows
    pos = np.concatenate([np.arange(30), np.arange(40), np.arange(26)])
    pos = np.broadcast_to(pos, (b, s)).astype(np.int32).copy()
    jg, tg, _ = _both_bwd(q, k, v, do, pos, pos, seg, seg)
    _close(jg, tg)
    assert np.all(tg[0][:, 70:] == 0.0)           # padding rows: dq 0
    assert np.all(tg[1][:, 70:] == 0.0) and np.all(tg[2][:, 70:] == 0.0)


def test_more_keys_than_queries_gives_zeros_on_unseen_keys():
    # Queries at positions 40..63 see keys 0..63; keys 64..149 are seen by
    # none and get exactly 0. The skip is off (sq != sk).
    b, sq, sk, h, kvh, d = 1, 24, 150, 4, 2, 32
    q, k, v, do = _inputs(2, b, sq, sk, h, kvh, d)
    jg, tg, _ = _both_bwd(q, k, v, do, _arange(b, sq, start=40),
                          _arange(b, sk), block=16, block_skip=False)
    _close(jg, tg)
    assert np.all(tg[1][:, 64:] == 0.0) and np.all(tg[2][:, 64:] == 0.0)


def test_grad_dtype_f32_from_bf16_inputs():
    b, s, h, kvh, d = 1, 64, 4, 1, 32
    q, k, v, do = _inputs(3, b, s, s, h, kvh, d)
    pos = _arange(b, s)
    jg, tg, raw = _both_bwd(q, k, v, do, pos, pos, dtype=jnp.bfloat16,
                            grad_dtype=jnp.float32)
    assert all(g.dtype == torch.float32 for g in raw)
    _close(jg, tg)


def test_autograd_function_matches_jax_grad():
    """Gradients through the port's autograd Function (forward and
    backward plain versions on the CPU) against jax.grad of the JAX
    flash_attention (custom VJP over the Pallas kernels)."""
    b, s, h, kvh, d = 2, 80, 4, 2, 32
    q, k, v, w = _inputs(4, b, s, s, h, kvh, d)
    seg = np.ones((b, s), np.int32)
    seg[:, 50:] = 2
    pos = np.concatenate([np.arange(50), np.arange(30)])
    pos = np.broadcast_to(pos, (b, s)).astype(np.int32).copy()

    def jloss(q, k, v):
        out = jax_flash(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                        jnp.asarray(seg), jnp.asarray(seg), block_q=32,
                        block_k=32)
        return jnp.sum(out * jnp.asarray(w))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, _t(pos), _t(pos), _t(seg), _t(seg))
    tg = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    _close([np.asarray(g) for g in jg], [g.numpy() for g in tg])
