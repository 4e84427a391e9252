"""Token sampling: greedy / temperature / top-k / top-p over a batch with
per-row parameters, and the speculative verify verdicts distribution-exact
with respect to it (the port of ``runbooks_tpu.ops.sampling``).

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


def _lane(scaled: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
          max_top_k: int):
    """The sorted lane ``sample`` draws from: (its logits, -inf where top-k
    or top-p drop them; the vocab ids of its columns; the kept mask)."""
    k_cap = min(max_top_k, scaled.shape[-1])
    top_vals, top_idx = torch.topk(scaled, k_cap, dim=-1)
    ranks = torch.arange(k_cap, dtype=torch.int32,
                         device=scaled.device)[None, :]
    k_eff = torch.where(top_k <= 0, k_cap, torch.clamp(top_k, max=k_cap))
    keep_k = ranks < k_eff[:, None]
    # Top-p on the sorted lane: the smallest prefix with cumprob >= p
    # (the first token always kept).
    probs = torch.softmax(torch.where(keep_k, top_vals, float("-inf")),
                          dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = keep_k & ((cum - probs) < top_p[:, None])
    keep[:, 0] = True
    return torch.where(keep, top_vals, float("-inf")), top_idx, keep


def _row_params(n: int, dev, temperature, top_k, top_p):
    return (torch.as_tensor(temperature, dtype=torch.float32,
                            device=dev).expand(n),
            torch.as_tensor(top_k, dtype=torch.int32, device=dev).expand(n),
            torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(n))


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
    temperature, top_k, top_p = _row_params(
        logits.shape[0], logits.device, temperature, top_k, top_p)

    greedy = torch.argmax(logits, dim=-1)
    temp_safe = torch.where(temperature <= 0.0, 1.0, temperature)
    scaled = logits / temp_safe[:, None]

    masked, top_idx, _ = _lane(scaled, top_k, top_p, max_top_k)
    choice = _gumbel_argmax(masked, generator)
    lane_sampled = torch.gather(top_idx, 1, choice[:, None])[:, 0]

    # top_k=0 and top_p=1.0: unrestricted sampling over the full vocab.
    full_sampled = _gumbel_argmax(scaled, generator)
    restricted = (top_k > 0) | (top_p < 1.0)
    sampled = torch.where(restricted, lane_sampled, full_sampled)
    return torch.where(temperature <= 0.0, greedy, sampled)


def _filtered_draft_stats(logits, draft, generator, temperature, top_k,
                          top_p, max_top_k):
    """(p_draft, resid) for flattened rows: the draft token's probability
    under the filtered distribution ``sample`` draws from, and a draw from
    that distribution with the draft masked out (the normalized residual
    ``(pi - q)+`` of a point-mass proposal q)."""
    temp_safe = torch.where(temperature <= 0.0, 1.0, temperature)
    scaled = logits / temp_safe[:, None]

    # The lane is sample()'s own, so exactness is with respect to the
    # engine's sampler, lane truncation included.
    masked, top_idx, keep = _lane(scaled, top_k, top_p, max_top_k)
    lane_probs = torch.softmax(masked, dim=-1)
    is_draft = top_idx == draft[:, None]
    p_lane = torch.where(is_draft & keep, lane_probs, 0.0).sum(dim=-1)

    # Unrestricted path (top_k=0, top_p=1.0): the full-vocab softmax.
    full_probs = torch.softmax(scaled, dim=-1)
    p_full = torch.gather(full_probs, 1, draft[:, None])[:, 0]

    restricted = (top_k > 0) | (top_p < 1.0)
    p_draft = torch.where(restricted, p_lane, p_full)

    choice = _gumbel_argmax(torch.where(is_draft, float("-inf"), masked),
                            generator)
    lane_resid = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
    full_resid = _gumbel_argmax(
        torch.where(vocab_ids[None, :] == draft[:, None], float("-inf"),
                    scaled), generator)
    resid = torch.where(restricted, lane_resid, full_resid)
    return p_draft, resid


def speculative_verify(
    logits: torch.Tensor,              # [batch, s, vocab] float32
    drafts: torch.Tensor,              # [batch, s-1] int drafted tokens
    generator: Optional[torch.Generator],
    temperature,                       # [batch]; 0 => greedy
    top_k,                             # [batch] int; 0 => disabled
    top_p,                             # [batch] float; 1.0 => disabled
    max_top_k: int = 64,
    gmask: Optional[torch.Tensor] = None,   # [batch, s, vocab] bool
):
    """Draft-verify verdicts for speculative decoding, exact with respect
    to ``sample``. ``logits[b, i]`` is the next-token distribution after
    verify input i; ``drafts[b, i]`` is the token proposed at input i + 1,
    so logits row i verifies drafts row i and the last row only feeds
    ``full``. Returns ``(accept, resid, full)``:

    - ``accept [b, s-1] bool``: greedy rows ``draft == argmax``;
      temperature rows ``u < pi(draft)`` with ``pi`` the filtered
      distribution ``sample`` draws from (a prompt-lookup proposal is a
      point mass, so the accept probability is ``pi(draft)``).
    - ``resid [b, s-1] int64``: the replacement token when position i is
      the first rejection. Greedy: the argmax; temperature: a draw from
      ``pi`` with the draft masked, so the emitted token's marginal is
      ``sample``'s: P(y != draft) = (1 - pi(draft)) pi(y) / (1 -
      pi(draft)).
    - ``full [b, s] int64``: a ``sample`` draw at every position: the
      bonus token after a fully accepted draft, and the plain one-token
      decode of a slot that drafted nothing.

    ``gmask[b, i]`` is the grammar mask at verify position i (the state
    after the draft prefix ``drafts[b, :i]``), applied to the logits
    first: the math is exact with respect to the masked distribution, and
    the engine cuts drafts to legal prefixes so every drafted token has
    mass under its row's mask.

    The generator is drawn in a fixed order: the accept uniforms, the
    residual draws, then the ``full`` draws."""
    if gmask is not None:
        logits = torch.where(gmask, logits, float("-inf"))
    b, s, vocab = logits.shape
    temperature, top_k, top_p = _row_params(b, logits.device, temperature,
                                             top_k, top_p)
    # Row-major flattening keeps [b, s] aligned with the per-slot
    # parameters repeated s times.
    vlogits = logits[:, :-1].reshape(b * (s - 1), vocab)
    vdraft = drafts.reshape(b * (s - 1)).long()
    vt = temperature.repeat_interleave(s - 1)
    vk = top_k.repeat_interleave(s - 1)
    vp = top_p.repeat_interleave(s - 1)
    u = torch.rand(vdraft.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    p_draft, resid = _filtered_draft_stats(vlogits, vdraft, generator, vt,
                                           vk, vp, max_top_k)
    full = sample(logits.reshape(b * s, vocab), generator,
                  temperature.repeat_interleave(s),
                  top_k.repeat_interleave(s), top_p.repeat_interleave(s),
                  max_top_k).reshape(b, s)
    greedy = torch.argmax(vlogits, dim=-1)
    accept = torch.where(vt <= 0.0, vdraft == greedy, u < p_draft)
    resid = torch.where(vt <= 0.0, greedy, resid)
    return accept.reshape(b, s - 1), resid.reshape(b, s - 1), full
