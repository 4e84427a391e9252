"""Plain multi-head attention with GQA/MQA, packed-sequence masking and
ALiBi slopes (as ``runbooks_tpu.ops.attention``).

``dot_product_attention`` is the decode attention of the serving path and
the numerical oracle of the flash kernel. Masking model: query q may attend
key k iff positions[k] <= positions[q] (causal, by absolute position), the
segment ids match, and the key's segment id is not 0 (padding).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def make_attention_mask(
    q_positions: torch.Tensor,                     # [b, q_len]
    kv_positions: torch.Tensor,                    # [b, kv_len]
    q_segment_ids: Optional[torch.Tensor] = None,  # [b, q_len]
    kv_segment_ids: Optional[torch.Tensor] = None,  # [b, kv_len]
    causal: bool = True,
) -> torch.Tensor:
    """Boolean mask [b, 1, q_len, kv_len]; True = may attend."""
    b, sq = q_positions.shape
    mask = torch.ones((b, sq, kv_positions.shape[1]), dtype=torch.bool,
                      device=q_positions.device)
    if causal:
        mask &= kv_positions[:, None, :] <= q_positions[:, :, None]
    if q_segment_ids is not None and kv_segment_ids is not None:
        mask &= q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        mask &= kv_segment_ids[:, None, :] != 0
    return mask[:, None, :, :]


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """ALiBi per-head slopes (geometric sequence), [num_heads] float32."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        vals = pow2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        vals = pow2_slopes(closest)
        vals += pow2_slopes(2 * closest)[0::2][: num_heads - closest]
    return torch.tensor(vals, dtype=torch.float32)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[b, s, kv_heads, d] -> [b, s, kv_heads*n_rep, d] for GQA broadcast."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def dot_product_attention(
    q: torch.Tensor,                       # [b, q_len, heads, d]
    k: torch.Tensor,                       # [b, kv_len, kv_heads, d]
    v: torch.Tensor,                       # [b, kv_len, kv_heads, d]
    mask: Optional[torch.Tensor] = None,   # [b, 1|h, q_len, kv_len] bool
    bias: Optional[torch.Tensor] = None,   # [b|1, h, q_len, kv_len]
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention: f32 logits and softmax, output in q's dtype.

    GQA groups the query heads by kv head in a reshape (query head i reads
    kv head i // n_rep, as ``repeat_kv`` would arrange), so K and V are
    never copied n_rep times; the arithmetic is the repeated version's."""
    b, sq, num_heads, head_dim = q.shape
    kv_heads = k.shape[-2]
    n_rep = num_heads // kv_heads
    scale = scale if scale is not None else head_dim ** -0.5

    qg = q.float().reshape(b, sq, kv_heads, n_rep, head_dim)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
    logits = logits.reshape(b, num_heads, sq, k.shape[1]) * scale
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # Fully masked query rows (padding) softmax to uniform; zero them so
    # padding contributes nothing downstream.
    if mask is not None:
        probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    # The reference rounds the probabilities to v's dtype before the
    # value product, with f32 accumulation.
    probs = probs.to(v.dtype).float().reshape(
        b, kv_heads, n_rep, sq, k.shape[1])
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(b, sq, num_heads, head_dim).to(q.dtype)
