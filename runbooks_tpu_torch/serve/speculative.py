"""Model-free prompt-lookup drafting for speculative decoding (the port's
copy of ``runbooks_tpu.serve.speculative``; host code only).

A verify forward scores K drafted tokens per slot as one ``[B, K+1]``
forward, which launches the same kernels as the ``[B, 1]`` decode step:
every accepted draft token saves a decode step. Prompt-lookup drafting
(n-gram lookup over the request's own prompt and generated tokens, no
second model) pays off on repetitive traffic: code edits, answers that
quote their context, multi-turn chat, templated completions.

``NgramDraftIndex`` is the per-slot index the engine drives
(serve/engine.py): the trailing n-gram of a slot's context is matched
against its most recent PREVIOUS occurrence (longest n wins, ``n`` from
``ngram_max`` down to ``ngram_min``) and the tokens that followed it are
proposed as the draft. Maintenance is O(ngram_max - ngram_min + 1) per
generated token and O(context) per admission; drafting is O(1)
dictionary lookups. The verify forward, not this index, guarantees
correctness: a bad draft costs a rejected position, never a wrong token
(ops/sampling.speculative_verify).
"""

from __future__ import annotations

from typing import Dict, List, Tuple


class NgramDraftIndex:
    """Per-slot prompt-lookup index over prompt + generated tokens.

    For each tracked n in [ngram_min, ngram_max], a dict maps every
    n-gram of the slot's context to the position FOLLOWING its most
    recent occurrence whose continuation is already known. Registration
    is delayed by one token (the n-gram ending at token j is indexed
    only once token j+1 exists), so a lookup hit always yields at least
    one proposable token and the trailing n-gram never matches itself.

    Single-threaded like the engine that owns it; no locking.
    """

    def __init__(self, max_slots: int, ngram_max: int, ngram_min: int):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError(
                f"ngram sizes must satisfy 1 <= ngram_min <= ngram_max, "
                f"got ngram_min={ngram_min} ngram_max={ngram_max}")
        self.max_slots = max_slots
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self._ns = tuple(range(ngram_max, ngram_min - 1, -1))
        self._ctx: List[List[int]] = [[] for _ in range(max_slots)]
        self._maps: List[Dict[int, Dict[Tuple[int, ...], int]]] = [
            {} for _ in range(max_slots)]

    def _register_ending_at(self, slot: int, j: int) -> None:
        """Index every tracked n-gram ending at context index j (its
        continuation, index j+1, must already exist)."""
        ctx = self._ctx[slot]
        maps = self._maps[slot]
        for n in self._ns:
            if j + 1 >= n:
                maps.setdefault(n, {})[tuple(ctx[j + 1 - n:j + 1])] = j + 1

    def begin(self, slot: int, prompt_tokens) -> None:
        """Start tracking a slot at admission: context = the prompt,
        every in-prompt n-gram with a known continuation indexed."""
        ctx = [int(t) for t in prompt_tokens]
        self._ctx[slot] = ctx
        self._maps[slot] = {}
        for j in range(len(ctx) - 1):
            self._register_ending_at(slot, j)

    def extend(self, slot: int, token: int) -> None:
        """Append one generated token; the n-grams ending at the
        previously last token become indexable."""
        ctx = self._ctx[slot]
        ctx.append(int(token))
        if len(ctx) >= 2:
            self._register_ending_at(slot, len(ctx) - 2)

    def draft(self, slot: int, max_tokens: int) -> List[int]:
        """Up to ``max_tokens`` proposed continuation tokens for the
        slot's context: what followed the most recent previous occurrence
        of the trailing n-gram, longest tracked n first. Empty when
        nothing matches."""
        if max_tokens < 1:
            return []
        ctx = self._ctx[slot]
        maps = self._maps[slot]
        for n in self._ns:
            if len(ctx) < n:
                continue
            pos = maps.get(n, {}).get(tuple(ctx[-n:]))
            if pos is not None:
                return ctx[pos:pos + max_tokens]
        return []

    def clear(self, slot: int) -> None:
        self._ctx[slot] = []
        self._maps[slot] = {}

    def reset(self) -> None:
        for slot in range(self.max_slots):
            self.clear(slot)

    def context_len(self, slot: int) -> int:
        return len(self._ctx[slot])


def legal_draft_prefix(cursor, tokens: List[int]) -> List[int]:
    """The longest prefix of a drafted continuation that the slot's
    grammar cursor (serve/grammar.py) accepts, WITHOUT advancing it. The
    engine cuts drafts here before dispatch, so ``speculative_verify``'s
    accept/reject math never sees a token with zero mass under its
    position's mask. A draft that crosses a terminal accept state is cut
    there too: the slot finishes with ``grammar_complete`` and must not
    propose past it."""
    if cursor is None or not tokens:
        return tokens
    states = cursor.walk(tokens)
    keep = len(states)
    for i, state in enumerate(states):
        if cursor.dfa.terminal[state]:
            keep = i + 1
            break
    return tokens[:keep]
