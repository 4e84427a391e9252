"""Token sampling: greedy / temperature / top-k / top-p over a batch with
per-row parameters (the port of ``runbooks_tpu.ops.sampling.sample``).

Same construction as the reference: top-k and top-p act on a static
``max_top_k``-wide sorted lane; a row with top_k=0 and top_p=1.0 samples
the full vocabulary. Randomness comes from an explicit torch.Generator
(Gumbel-max over the logits), so draws differ from the reference's for the
same seed; greedy rows are the argmax and agree exactly.
"""

from __future__ import annotations

from typing import Optional

import torch


def _gumbel_argmax(logits: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row from unnormalized log-probs."""
    u = torch.rand(logits.shape, generator=generator,
                   device=logits.device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample(
    logits: torch.Tensor,              # [batch, vocab] float32
    generator: Optional[torch.Generator],
    temperature,                       # [batch] or scalar; 0 => greedy
    top_k,                             # [batch] int; 0 => disabled
    top_p,                             # [batch] float; 1.0 => disabled
    max_top_k: int = 64,
    gmask: Optional[torch.Tensor] = None,   # [batch, vocab] bool
) -> torch.Tensor:
    """Sampled token ids [batch] (int64). ``gmask`` rows mark the allowed
    tokens (a -inf logit mask applied before every path); None or all-True
    rows change nothing."""
    if gmask is not None:
        logits = torch.where(gmask, logits, float("-inf"))
    n, vocab = logits.shape
    dev = logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev).expand(n)
    top_k = torch.as_tensor(top_k, dtype=torch.int32, device=dev).expand(n)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(n)

    greedy = torch.argmax(logits, dim=-1)
    temp_safe = torch.where(temperature <= 0.0, 1.0, temperature)
    scaled = logits / temp_safe[:, None]

    # Top-k over a static-width sorted lane.
    k_cap = min(max_top_k, vocab)
    top_vals, top_idx = torch.topk(scaled, k_cap, dim=-1)
    ranks = torch.arange(k_cap, dtype=torch.int32, device=dev)[None, :]
    k_eff = torch.where(top_k <= 0, k_cap, torch.clamp(top_k, max=k_cap))
    keep_k = ranks < k_eff[:, None]

    # Top-p on the sorted lane: the smallest prefix with cumprob >= p
    # (the first token always kept).
    probs = torch.softmax(torch.where(keep_k, top_vals, float("-inf")),
                          dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = keep_k & ((cum - probs) < top_p[:, None])
    keep[:, 0] = True

    masked = torch.where(keep, top_vals, float("-inf"))
    choice = _gumbel_argmax(masked, generator)
    lane_sampled = torch.gather(top_idx, 1, choice[:, None])[:, 0]

    # top_k=0 and top_p=1.0: unrestricted sampling over the full vocab.
    full_sampled = _gumbel_argmax(scaled, generator)
    restricted = (top_k > 0) | (top_p < 1.0)
    sampled = torch.where(restricted, lane_sampled, full_sampled)
    return torch.where(temperature <= 0.0, greedy, sampled)
