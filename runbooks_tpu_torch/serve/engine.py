"""Slot-based continuous-batching inference engine (the port of
``runbooks_tpu.serve.engine``, dense KV path).

- A fixed pool of ``max_slots`` slots over one dense KV cache of
  ``max_seq_len + 1`` positions per slot (the last is the trash slot that
  padding writes to).
- Continuous batching at slot granularity: between decode chunks, finished
  slots free and queued requests prefill into free slots; each decode step
  advances every active slot at once.
- Prefill is batched: requests admitted in one tick are grouped by length
  bucket and prefilled as one [rows, bucket] forward, rows being 1 or
  max_slots. Prefill routes through the hand-written flash kernel on CUDA
  (models/transformer.use_flash_cached_prefill).
- Decode runs ``decode_chunk`` steps per host round-trip with per-slot
  liveness (EOS, token budget, cache room) tracked on the device; the host
  replays the chunk's validity mask so its bookkeeping matches
  step-at-a-time exactly. One host sync per chunk.
- Sampling takes per-slot temperature/top_k/top_p, so mixed request
  parameters batch together.
- Admission orders the queue by QoS class (PRIORITY_RANK, FIFO within a
  class), bounds each class by its share of ``max_queue``, and gives shed
  requests a load-derived Retry-After hint.
- Shared-prefix cache: registered prompt prefixes (chat system prompts)
  keep their per-layer K/V on the device in an LRU; an admission whose
  prompt starts with one prefills only its suffix, at positions from the
  prefix's length, over scratch rows that hold the prefix's K/V.
- Speculative decoding (``speculative="ngram"``): a prompt-lookup index
  (serve/speculative.py) drafts up to ``draft_tokens`` tokens per slot and
  one ``[B, K+1]`` verify forward scores every slot's drafts at once;
  steps with no draft anywhere run the plain decode chunk.
- Grammar-constrained output (``grammar="on"``): a request's
  ``response_format`` compiles into a token DFA (serve/grammar.py), and
  every dispatch takes a per-row allowed-token mask (all-True rows for
  unconstrained slots).

- QoS preemption hooks: ``preemption="swap"`` is served by the paged
  engine (serve/paging.py), which displaces a worse-class slot at a step
  boundary and resumes it later from its own adopted pages; this module
  holds the request state and the resume branch they share.

Later slices add the LoRA pool, quantization, the mesh and the
observability planes; their knobs are absent here, and requests that need
them are refused by ``validate``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from runbooks_tpu_torch.models.config import ModelConfig, check_speculative
from runbooks_tpu_torch.models.transformer import (
    KVCache,
    Params,
    check_supported,
    forward,
    lm_head,
)
from runbooks_tpu_torch.ops.sampling import sample, speculative_verify
from runbooks_tpu_torch.serve.grammar import GrammarCache, TokenVocab
from runbooks_tpu_torch.serve.speculative import (
    NgramDraftIndex,
    legal_draft_prefix,
)
from runbooks_tpu_torch.utils import cuda_build
from runbooks_tpu_torch.utils.hw import backend_tuning

# QoS classes, best first: admission orders the queue by class (FIFO
# within a class). The strings are the public API (the HTTP `priority`
# field and the X-Priority header).
PRIORITY_RANK = {"interactive": 0, "standard": 1, "batch": 2}

# spec_stats' accept-rate buckets (verify steps by their accepted share of
# drafted tokens).
_ACCEPT_RATE_BUCKETS = ("0-25%", "25-50%", "50-75%", "75-100%")


class EngineOverloaded(RuntimeError):
    """Typed admission rejection: the bounded queue is full (an HTTP front
    end maps it to 429 with Retry-After)."""


class EngineDraining(EngineOverloaded):
    """The server is draining (SIGTERM): no new admissions; in-flight
    requests finish before exit. Maps to HTTP 503."""


class EngineStepFailed(RuntimeError):
    """An engine step raised: the KV cache may be half-written and the
    slot bookkeeping half-applied, so the engine needs a full reset()
    before it serves again."""


@dataclasses.dataclass
class Request:
    """One generation request (engine-internal)."""
    prompt_tokens: List[int]
    max_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    # Multi-turn hint: once this request finishes, the serving worker
    # registers its prompt's K/V as a shared prefix straight from the slot
    # (the next turn's prompt extends this one). No effect in the engine.
    auto_prefix: bool = False
    # Wall-clock budget in seconds from submit(), enforced between decode
    # chunks: an expired request finishes with finish_reason "deadline"
    # and the tokens it has; a queued one finishes empty-handed.
    deadline_s: Optional[float] = None
    request_id: str = ""
    # Name or path of a LoRA adapter to decode through. Only a pooled
    # engine serves it (not ported): validate() refuses any non-None.
    adapter: Optional[str] = None
    # QoS class (PRIORITY_RANK): orders the admission queue.
    priority: str = "standard"
    # Grammar-constrained output: {"type": "json_schema"|"ebnf", ...}.
    # validate() compiles it (through the LRU cache) into a token DFA and
    # pins the cursor below; None decodes unconstrained.
    response_format: Optional[dict] = None
    # Filled by the engine:
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: str = ""
    # Streaming hook, called after each generated token lands in
    # output_tokens. It runs inside the decode loop: keep it cheap.
    on_token: Optional[Callable[[int], None]] = None
    _submitted: float = 0.0   # monotonic submit time (deadline anchor)
    _admitted: float = 0.0    # monotonic admission time
    _slot: int = -1           # the slot it was admitted to
    # The compiled DFA's cursor (serve/grammar.GrammarCursor) when
    # response_format is set.
    _grammar: Any = None
    # Preempted and re-queued (paged engine, preemption="swap"): the
    # tokens generated so far stay in output_tokens and the written pages
    # live on in the radix tree, so re-admission resumes from a radix match
    # on the request's own history with no token lost or resampled.
    _preempted: bool = False


def _parse_swap_fault(spec: str) -> Optional[int]:
    """K of ``RBT_FAULT_INJECT=swapfail:K`` (the K-th host-tier page copy
    fails), None for any other value."""
    if not spec.startswith("swapfail:"):
        return None
    try:
        k = int(spec.split(":", 1)[1])
    except ValueError as exc:
        raise ValueError(
            f"RBT_FAULT_INJECT={spec!r}: expected swapfail:K") from exc
    if k < 1:
        raise ValueError(f"RBT_FAULT_INJECT={spec!r}: K must be >= 1")
    return k


def _buckets(max_prefill: int) -> List[int]:
    out, b = [], 16
    while b < max_prefill:
        out.append(b)
        b *= 2
    out.append(max_prefill)
    return out


def bucket_for(buckets: List[int], n: int) -> int:
    """Smallest bucket covering n tokens (last bucket when none do)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def view_buckets_for(max_seq_len: int) -> List[int]:
    """Decode cache-view buckets for a context window: decode reads only
    the smallest view covering current occupancy."""
    return sorted({v for v in (256, 1024) if v < max_seq_len}
                  | {max_seq_len})


def auto_prefix_plens(buckets: List[int], max_seq_len: int) -> List[int]:
    """The prefix lengths the auto-prefix path can register: prefill
    buckets that leave >= 16 prompt tokens."""
    return [b for b in buckets if b <= max_seq_len - 16]


def _scratch_rows(cfg: ModelConfig, rows: int, cache_len: int,
                  device) -> KVCache:
    shape = (cfg.num_layers, rows, cache_len, cfg.num_kv_heads,
             cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.activation_dtype,
                                 device=device),
                   v=torch.zeros(shape, dtype=cfg.activation_dtype,
                                 device=device))


def make_prefill_fn(cfg: ModelConfig, cache_len: int):
    """Batched prefill + splice + first-token sample for one admission
    group. ``pool`` is the slot cache, updated in place and returned.
    With ``prefix`` = (pk, pv, n): a registered shared prefix's K/V
    [L, plen, kv_h, d] goes into slots [0, plen) of the first n scratch
    rows (the real ones; padding rows get none), and ``tokens`` holds only
    the suffixes, at positions from plen. Returns the sampled first
    tokens, the pool, and each row's last-position logits [rows, vocab]
    f32. ``gmask`` [rows, vocab] bool (grammar on): each row's allowed
    first tokens."""

    def prefill_fn(params, pool: KVCache, tokens, positions, slots,
                   last_pos, generator, temps, top_ks, top_ps,
                   prefix=None, gmask=None):
        # Prefill `rows` requests into fresh zero rows, then splice each
        # row into the pool. Stale data from a slot's previous occupant
        # needs no clearing: these queries attend only slots <= their own
        # position, all (re)written by this prefill or later decode.
        # Padding rows carry slots[0] as their destination; the splice
        # runs in DESCENDING row order so the real row 0 lands last.
        rows = tokens.shape[0]
        scratch = _scratch_rows(cfg, rows, cache_len, tokens.device)
        if prefix is not None:
            # Exactly plen slots: no padding key a suffix query could
            # attend.
            pk, pv, n = prefix
            plen = pk.shape[1]
            scratch.k[:, :n, :plen] = pk[:, None]
            scratch.v[:, :n, :plen] = pv[:, None]
        x, scratch = forward(cfg, params, tokens, positions=positions,
                             cache=scratch, return_activations=True)
        for r in range(rows - 1, -1, -1):
            pool.k[:, slots[r]] = scratch.k[:, r]
            pool.v[:, slots[r]] = scratch.v[:, r]
        # The head runs on each row's last real position only: the
        # [rows, bucket, vocab] f32 logits are never built.
        rows_idx = torch.arange(rows, device=tokens.device)
        last_logits = lm_head(cfg, params, x[rows_idx, last_pos])
        first = sample(last_logits, generator, temps, top_ks, top_ps,
                       gmask=gmask)
        return first, pool, last_logits

    return prefill_fn


def make_prefix_build_fn(cfg: ModelConfig, cache_len: int):
    """The prefix-K/V build: one bucket-width row (padding at the trash
    slot), K/V [L, cache_len, kv_h, d] returned whole; the caller slices
    to the prefix's length. Its launch shapes are the one-row prefill's
    at each bucket."""

    def prefix_build_fn(params, tokens, positions):
        scratch = _scratch_rows(cfg, 1, cache_len, tokens.device)
        _, scratch = forward(cfg, params, tokens, positions=positions,
                             cache=scratch, return_activations=True)
        return scratch.k[:, 0], scratch.v[:, 0]

    return prefix_build_fn


def make_decode_fn(cfg: ModelConfig, chunk: int, max_len: int,
                   pad_slot: int, view: int):
    """`chunk` decode steps with per-slot liveness tracked on the device by
    exactly the host's finish rules (EOS, max_tokens budget, cache out of
    room), so the host can replay (tokens, valid) and land in the same
    slot state as chunk=1 stepping. Nothing here waits for the device.

    ``gmask`` [B, vocab] (grammar on) is each slot's allowed-token row at
    the chunk's start. It stays fixed over the chunk, so it is exact for
    the first step only: the host takes one token per chunk from a
    constrained slot (InferenceEngine._replay_chunk)."""

    def decode_fn(params, cache, tokens, positions, generator,
                  temperature, top_k, top_p, eos_ids, remaining, active,
                  gmask=None):
        tok, pos, alive = tokens, positions, active
        emitted = torch.zeros_like(remaining)
        toks, valid = [], []
        for _ in range(chunk):
            p = torch.where(alive, pos, pad_slot)
            logits, cache = forward(cfg, params, tok[:, None],
                                    positions=p[:, None], cache=cache,
                                    cache_view=view)
            nxt = sample(logits[:, -1], generator, temperature, top_k,
                         top_p, gmask=gmask).to(tok.dtype)
            nxt = torch.where(alive, nxt, tok)
            toks.append(nxt)
            valid.append(alive)
            emitted = emitted + alive.to(emitted.dtype)
            pos = pos + alive.to(pos.dtype)
            hit_eos = (eos_ids >= 0) & (nxt == eos_ids)
            alive = alive & ~hit_eos & (emitted < remaining) & (pos < max_len)
            tok = nxt
        return torch.stack(toks), torch.stack(valid), cache

    return decode_fn


def make_verify_fn(cfg: ModelConfig, draft_tokens: int, pad_slot: int,
                   view: int):
    """One batched draft-verify forward for speculative decoding: K
    drafted tokens per slot scored in a single ``[B, K+1]`` forward.
    ``tokens[:, 0]`` is each slot's carry-in token (the last sampled one,
    whose K/V the cache is still owed) and ``tokens[:, 1:1+d]`` its d
    drafts; positions past a row's draft length, and inactive rows, park
    at the trash slot, so slots drafting K tokens and slots drafting none
    run as one forward.

    The forward writes K/V at every live position. The host accepts the
    longest verified prefix per slot and does not advance ``lengths``
    past it: the rejected drafts' K/V beyond the cursor is rewritten by
    the next dispatch before anything attends it, so rollback costs no
    device work. Verdicts come from ops/sampling.speculative_verify
    (greedy: exact argmax matches; temperature: rejection sampling against
    the engine's own filtered distribution). ``gmask`` [B, K+1, vocab]
    (grammar on): the allowed tokens at each verify position."""
    K = draft_tokens

    def verify_fn(params, cache, tokens, positions, draft_len, generator,
                  temperature, top_k, top_p, active, gmask=None):
        offs = torch.arange(K + 1, dtype=positions.dtype,
                            device=positions.device)[None, :]
        live = active[:, None] & (offs <= draft_len[:, None])
        pos = torch.where(live, positions[:, None] + offs, pad_slot)
        logits, cache = forward(cfg, params, tokens, positions=pos,
                                cache=cache, cache_view=view)
        accept, resid, full = speculative_verify(
            logits, tokens[:, 1:], generator, temperature, top_k, top_p,
            gmask=gmask)
        return accept, resid, full, cache

    return verify_fn


class InferenceEngine:
    """Batched generation over a fixed slot pool. Thread-unsafe by design;
    drive it from one loop."""

    # Pages are the unit a preempted slot's state swaps at, so only the
    # paged engine (serve/paging.py) supports preemption="swap".
    _supports_preemption = False

    def __init__(self, cfg: ModelConfig, params: Params, *,
                 max_slots: int = 8, max_seq_len: Optional[int] = None,
                 seed: int = 0, prefill_budget: Optional[int] = None,
                 decode_chunk: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 queue_shares: Optional[dict] = None,
                 prefix_cache_size: Optional[int] = None,
                 speculative: Optional[str] = None,
                 draft_tokens: Optional[int] = None,
                 ngram_max: Optional[int] = None,
                 ngram_min: Optional[int] = None,
                 grammar: str = "off",
                 grammar_cache_size: Optional[int] = None,
                 tokenizer=None,
                 preemption: str = "off"):
        """params live on the engine's device (CUDA, or the CPU when the
        caller put them there); every tensor the engine makes follows.

        prefill_budget: max bucket-padded prompt tokens admitted per step
        (default max_seq_len); a single over-budget request still admits
        alone. decode_chunk: decode steps per host round-trip (default 8
        on CUDA, 1 on the CPU). max_queue: bound on waiting requests;
        submit() past it raises EngineOverloaded (default
        max(16, 4 * max_slots)). queue_shares: {class: share in (0, 1]}
        bounding the queued requests of each QoS class to that share of
        max_queue (missing classes: the whole queue). prefix_cache_size:
        registered shared prefixes kept (LRU; default max(4, 2 *
        max_slots), so every live conversation under auto-prefix chat can
        hold an entry between its turns); each costs [L, plen, kv_h, d]
        x 2 of device memory.

        speculative / draft_tokens / ngram_max / ngram_min: speculative
        decoding. None follows the config (cfg.speculative etc.;
        draft_tokens then defaults through utils/hw.backend_tuning).
        "ngram" drafts up to draft_tokens tokens per slot from a
        prompt-lookup index over n-grams of ngram_min..ngram_max tokens
        and verifies them in one [B, K+1] forward; greedy outputs are the
        same with it on or off.

        grammar / grammar_cache_size / tokenizer: grammar-constrained
        output. "on" compiles each request's `response_format` (a
        JSON-schema subset or EBNF) into a token DFA over the tokenizer's
        vocabulary, kept in an LRU of grammar_cache_size entries (default
        64) keyed on (grammar hash, tokenizer fingerprint); every dispatch
        then takes a [rows, vocab] allowed-token mask (all-True rows for
        unconstrained slots). Constrained requests finish with
        "grammar_complete" when their grammar admits nothing but EOS.

        preemption: "off" (default) or "swap" (paged engine only). With
        "swap", a queue head blocked on pages or slots preempts the
        lowest-class active slot at a step boundary: the victim's written
        pages are adopted into the radix tree (and may later swap to the
        host tier), the request re-queues with its generated tokens, and
        it resumes from a radix match on its own history.

        RBT_FAULT_INJECT=swapfail:K (environment) makes the K-th host-tier
        page copy fail once, so the degrade-to-drop and
        degrade-to-recompute paths can be exercised."""
        check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        tuning = backend_tuning(self.device)
        if decode_chunk is None:
            decode_chunk = tuning["decode_chunk"]
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        self.decode_chunk = decode_chunk
        self.speculative = check_speculative(
            speculative if speculative is not None else cfg.speculative)
        self.draft_tokens = int(
            draft_tokens if draft_tokens is not None
            else cfg.draft_tokens if cfg.draft_tokens is not None
            else tuning["draft_tokens"])
        if self.draft_tokens < 1:
            raise ValueError(
                f"draft_tokens must be >= 1, got {self.draft_tokens}")
        self.ngram_max = int(ngram_max if ngram_max is not None
                             else cfg.ngram_max)
        self.ngram_min = int(ngram_min if ngram_min is not None
                             else cfg.ngram_min)
        # The index checks 1 <= ngram_min <= ngram_max: built even with
        # speculation off, so a bad config fails here, not when someone
        # turns speculation on.
        self._spec_index: Optional[NgramDraftIndex] = NgramDraftIndex(
            max_slots, self.ngram_max, self.ngram_min)
        if self.speculative == "off":
            self._spec_index = None
        self.spec_drafted = 0        # draft tokens proposed
        self.spec_accepted = 0       # draft tokens accepted
        self.spec_verify_steps = 0   # verify dispatches
        # accept-rate bucket -> [tokens emitted, dispatch seconds]
        self._spec_rate_buckets = {b: [0, 0.0]
                                   for b in _ACCEPT_RATE_BUCKETS}
        if grammar not in ("off", "on"):
            raise ValueError(
                f"grammar must be 'off' or 'on', got {grammar!r}")
        self.grammar = grammar
        self._grammar_cache: Optional[GrammarCache] = None
        self.grammar_requests = 0           # requests with a compiled DFA
        self.grammar_completed = 0          # grammar_complete finishes
        self.grammar_draft_truncations = 0  # drafts cut at an illegal token
        # Host seconds of each gmask build (one per dispatch).
        self.grammar_mask_seconds: collections.deque = collections.deque(
            maxlen=4096)
        if grammar == "on":
            if tokenizer is None:
                raise ValueError(
                    "grammar: on needs the tokenizer (the DFA compiler "
                    "maps grammar bytes onto token ids); pass tokenizer=")
            self._grammar_cache = GrammarCache(
                TokenVocab.from_tokenizer(tokenizer), cfg.vocab_size,
                capacity=(int(grammar_cache_size)
                          if grammar_cache_size is not None else 64))
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self._pad_slot = self.max_seq_len  # trash slot index
        self.prefill_budget = (prefill_budget if prefill_budget is not None
                               else self.max_seq_len)
        self.max_queue = (max_queue if max_queue is not None
                          else max(16, 4 * max_slots))
        shares = dict(queue_shares or {})
        for cls, share in shares.items():
            if cls not in PRIORITY_RANK:
                raise ValueError(
                    f"queue_shares: unknown class {cls!r} (expected one "
                    f"of {sorted(PRIORITY_RANK)})")
            if not 0.0 < float(share) <= 1.0:
                raise ValueError(
                    f"queue_shares[{cls!r}] must be in (0, 1], got "
                    f"{share}")
        self.queue_shares = {
            cls: float(shares.get(cls, 1.0)) for cls in PRIORITY_RANK}
        self._class_bounds = {
            cls: max(1, int(np.ceil(self.max_queue * s)))
            for cls, s in self.queue_shares.items()}
        if preemption not in ("off", "swap"):
            raise ValueError(
                f"preemption must be 'off' or 'swap', got {preemption!r}")
        if preemption == "swap" and not self._supports_preemption:
            raise ValueError(
                "preemption: swap needs the paged engine (pages are the "
                "unit a preempted slot swaps at); set kv_paging: paged")
        self.preemption = preemption
        self.preemptions = 0          # slots preempted
        self.preempted_resumed = 0    # preempted requests re-admitted
        self._swap_fault = _parse_swap_fault(
            os.environ.get("RBT_FAULT_INJECT", ""))
        self.cache = self._new_cache()
        self.deadline_expired = 0
        self.prefill_dispatches = 0
        # Host seconds inside prefill, decode and verify dispatches, each
        # ending in its host sync; the profiler sees the same spans by
        # these names.
        self.dispatch_seconds = {"prefill": 0.0, "decode": 0.0,
                                 "verify": 0.0}
        # Time to first token (submit to the first sampled token, host
        # clock) of the latest requests.
        self.ttft_seconds: collections.deque = collections.deque(
            maxlen=4096)
        self.lengths = np.zeros(max_slots, np.int32)       # tokens in cache
        self.active = np.zeros(max_slots, bool)
        self.last_token = np.zeros(max_slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.queue: List[Request] = []
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.prefill_buckets = _buckets(self.max_seq_len)
        self.view_buckets = view_buckets_for(self.max_seq_len)
        self.steps = 0
        self._prefill = make_prefill_fn(cfg, self.max_seq_len + 1)
        self._prefix_build = make_prefix_build_fn(cfg, self.max_seq_len + 1)
        self._decode_fns: dict = {}
        self._verify_fns: dict = {}
        self.prefix_cache_size = (prefix_cache_size
                                  if prefix_cache_size is not None
                                  else max(4, 2 * max_slots))
        # Insertion order is the LRU order: the last key is the most
        # recently used (registrations and admission hits refresh it), the
        # first is evicted. Keys are token tuples, values (k, v) tensors
        # of their own [L, plen, kv_h, d].
        self._prefix_cache: "dict[tuple, tuple]" = {}
        self.prefix_tokens_reused = 0
        # Admissions that looked for a registered prefix, and that found
        # one.
        self.prefix_lookups = 0
        self.prefix_hits = 0

    def _new_cache(self) -> KVCache:
        return KVCache.create(self.cfg, self.max_slots, self.max_seq_len,
                              self.device, trash_slot=True)

    def _decode_for(self, view: int):
        if view not in self._decode_fns:
            self._decode_fns[view] = make_decode_fn(
                self.cfg, self.decode_chunk, self.max_seq_len,
                self._pad_slot, view)
        return self._decode_fns[view]

    def _verify_for(self, view: int):
        if view not in self._verify_fns:
            self._verify_fns[view] = make_verify_fn(
                self.cfg, self.draft_tokens, self._pad_slot, view)
        return self._verify_fns[view]

    @contextlib.contextmanager
    def _dispatch(self, kind: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"{kind}_dispatch"):
            yield
        self.dispatch_seconds[kind] += time.perf_counter() - t0

    def _view_for(self, max_pos: int) -> int:
        """Smallest view bucket covering every query position this chunk
        can reach (caller passes max active length + chunk)."""
        for v in self.view_buckets:
            if max_pos <= v:
                return v
        return self.view_buckets[-1]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        # A copy: the host keeps mutating its slot arrays while the device
        # may still read the operand.
        return torch.tensor(a, device=self.device)

    def validate(self, req: Request) -> None:
        """Raise ValueError for requests that can never be served."""
        if not req.prompt_tokens:
            raise ValueError("empty prompt")
        if len(req.prompt_tokens) >= self.max_seq_len:
            raise ValueError(
                f"prompt of {len(req.prompt_tokens)} tokens exceeds the "
                f"engine's context window ({self.max_seq_len})")
        bad = [t for t in req.prompt_tokens
               if not 0 <= int(t) < self.cfg.vocab_size]
        if bad:
            raise ValueError(f"prompt token ids {bad[:4]} outside the "
                             f"vocabulary [0, {self.cfg.vocab_size})")
        if req.priority not in PRIORITY_RANK:
            raise ValueError(
                f"priority must be one of {sorted(PRIORITY_RANK)}, got "
                f"{req.priority!r}")
        if req.adapter is not None:
            raise ValueError(
                "this server has no adapter pool (adapter_pool: 0); "
                "request-level `adapter` needs a pooled engine or a "
                "dedicated server with the adapter folded at load")
        if req.response_format is not None:
            if self._grammar_cache is None:
                raise ValueError(
                    "this server has grammar-constrained decoding off "
                    "(grammar: off); `response_format` needs grammar: on")
            # Compiled (or an LRU hit) here, at the 400 boundary: a
            # GrammarError names the unsupported construct and the request
            # never enters the queue. The cursor holds the DFA, so a cache
            # eviction cannot strand the slot.
            req._grammar = self._grammar_cache.cursor(req.response_format)
            self.grammar_requests += 1

    def submit(self, req: Request) -> None:
        self.validate(req)
        if len(self.queue) >= self.max_queue:
            raise EngineOverloaded(
                f"admission queue full ({len(self.queue)} waiting, "
                f"bound {self.max_queue}); retry later")
        bound = self._class_bounds[req.priority]
        queued = sum(1 for q in self.queue if q.priority == req.priority)
        if queued >= bound:
            # A flood of one class cannot fill the whole queue against
            # the others.
            raise EngineOverloaded(
                f"{req.priority} queue share full ({queued} waiting, "
                f"class bound {bound} of {self.max_queue}); retry later")
        req._submitted = time.monotonic()
        self._queue_insert(req)

    def _queue_insert(self, req: Request) -> None:
        """Behind every queued request of the same or a better class,
        ahead of strictly worse ones."""
        rank = PRIORITY_RANK[req.priority]
        idx = len(self.queue)
        for i, q in enumerate(self.queue):
            if PRIORITY_RANK[q.priority] > rank:
                idx = i
                break
        self.queue.insert(idx, req)

    def retry_after_hint(self) -> int:
        """Retry-After seconds for a shed request: the queue depth in
        units of slot drains (each freed slot admits one queued request),
        clamped to [1, 30]."""
        backlog = len(self.queue)
        hint = -(-backlog // max(self.max_slots, 1))
        return int(min(max(hint, 1), 30))

    def reset(self) -> None:
        """Recover from a failed step: drop every queued and active
        request and reallocate the cache, which the step may have left
        half-written. Registered prefixes stay: their K/V are tensors of
        their own, which no step writes."""
        self.cache = None
        self.cache = self._new_cache()
        self.lengths[:] = 0
        self.active[:] = False
        self.last_token[:] = 0
        self.slot_req = [None] * self.max_slots
        self.queue.clear()
        if self._spec_index is not None:
            self._spec_index.reset()

    # -- grammar masks -------------------------------------------------
    #
    # Empty when grammar is off. When on, every dispatch takes a mask:
    # all-True rows for unconstrained slots, where masking is the identity.

    def _mask_kwargs(self, mask: np.ndarray, t0: float) -> dict:
        self.grammar_mask_seconds.append(time.perf_counter() - t0)
        return {"gmask": self._tensor(mask)}

    def _grammar_prefill_kwargs(self, group: List[tuple], rows: int) -> dict:
        """[rows, vocab] allowed first tokens of one admission group."""
        if self._grammar_cache is None:
            return {}
        t0 = time.perf_counter()
        mask = np.ones((rows, self.cfg.vocab_size), bool)
        for i, (_, req) in enumerate(group):
            # A resumed (preempted) row's prefill-sampled token is
            # discarded (_activate_slot), so its row stays all-True.
            if req._grammar is not None and not (req._preempted
                                                 and req.output_tokens):
                mask[i] = req._grammar.mask_row()
        return self._mask_kwargs(mask, t0)

    def _grammar_decode_kwargs(self) -> dict:
        """[max_slots, vocab] allowed tokens at each slot's cursor."""
        if self._grammar_cache is None:
            return {}
        t0 = time.perf_counter()
        mask = np.ones((self.max_slots, self.cfg.vocab_size), bool)
        for slot in range(self.max_slots):
            req = self.slot_req[slot]
            if self.active[slot] and req is not None \
                    and req._grammar is not None:
                mask[slot] = req._grammar.mask_row()
        return self._mask_kwargs(mask, t0)

    def _grammar_verify_kwargs(self, drafts: dict) -> dict:
        """[max_slots, K+1, vocab] verify masks: position 0 is the slot's
        cursor state, position i the state after the draft prefix d[:i].
        Drafts were cut to legal prefixes (_collect_drafts), so the walk
        covers every drafted position; rows past a slot's draft stay
        all-True (their samples are never emitted)."""
        if self._grammar_cache is None:
            return {}
        t0 = time.perf_counter()
        mask = np.ones((self.max_slots, self.draft_tokens + 1,
                        self.cfg.vocab_size), bool)
        for slot, d in drafts.items():
            req = self.slot_req[slot]
            cur = None if req is None else req._grammar
            if cur is None:
                continue
            for i, state in enumerate([cur.state] + cur.walk(d)):
                mask[slot, i] = cur.dfa.masks[state]
        return self._mask_kwargs(mask, t0)

    def _grammar_warm_kwargs(self, shape: tuple) -> dict:
        """An all-True mask for warmup's dispatches, so they launch what
        the masked dispatches of traffic launch."""
        if self._grammar_cache is None:
            return {}
        return {"gmask": torch.ones(shape, dtype=torch.bool,
                                    device=self.device)}

    def grammar_stats(self) -> dict:
        """Grammar-mode snapshot: the compile cache's hits, misses, size
        and compile seconds, and the engine's counters."""
        out = {"mode": self.grammar}
        if self._grammar_cache is None:
            return out
        out.update(self._grammar_cache.stats())
        out.update({"requests_total": self.grammar_requests,
                    "completed_total": self.grammar_completed,
                    "draft_truncations_total":
                        self.grammar_draft_truncations})
        return out

    def warmup(self) -> None:
        """Build the kernels, then run one prefill per bucket at both row
        counts (1 and max_slots) and one decode chunk per cache view
        (and, with speculation on, one verify forward per view) before
        traffic, so the first request pays for no kernel build and no
        first launch. Slot state is reset afterwards; the engine's
        sampling stream is untouched.

        This covers shared prefixes too: the prefix-K/V build launches the
        one-row prefill's shapes at the prefix's bucket, and a suffix
        prefill the plain prefill's. Eager PyTorch compiles nothing per
        shape; what a first launch pays is the kernel build and the
        library's first call at a shape (cuBLAS's kernel choice and
        module load)."""
        if self.device.type == "cuda":
            cuda_build.build(["flash_fwd"])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        t = self._tensor
        vocab = self.cfg.vocab_size
        for bucket in self.prefill_buckets:
            for rows in sorted({1, self.max_slots}):
                positions = np.full((rows, bucket), self._pad_slot,
                                    np.int32)
                positions[:, :2] = [0, 1]
                first, self.cache, _ = self._prefill(
                    self.params, self.cache,
                    t(np.zeros((rows, bucket), np.int32)), t(positions),
                    [0] * rows, t(np.ones(rows, np.int64)), gen,
                    t(np.zeros(rows, np.float32)),
                    t(np.zeros(rows, np.int32)),
                    t(np.ones(rows, np.float32)),
                    **self._grammar_warm_kwargs((rows, vocab)))
        n = self.max_slots
        idle = np.zeros(n, np.int32)
        for view in self.view_buckets:
            first, _, self.cache = self._decode_for(view)(
                self.params, self.cache, t(idle),
                t(np.full(n, self._pad_slot, np.int32)), gen,
                t(np.zeros(n, np.float32)), t(idle),
                t(np.ones(n, np.float32)), t(np.full(n, -1, np.int32)),
                t(idle), t(np.zeros(n, bool)),
                **self._grammar_warm_kwargs((n, vocab)))
            if self._spec_index is not None:
                first, _, _, self.cache = self._verify_for(view)(
                    self.params, self.cache,
                    t(np.zeros((n, self.draft_tokens + 1), np.int32)),
                    t(idle), t(idle), gen, t(np.zeros(n, np.float32)),
                    t(idle), t(np.ones(n, np.float32)),
                    t(np.zeros(n, bool)),
                    **self._grammar_warm_kwargs(
                        (n, self.draft_tokens + 1, vocab)))
        first.cpu()
        self.reset()

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any())

    def kv_occupancy(self) -> dict:
        """Token-level occupancy of the dense slot pool: the [max_slots,
        max_seq_len] reservation against the tokens actually cached."""
        capacity = self.max_slots * self.max_seq_len
        tokens = int(self.lengths[self.active].sum())
        nbytes = sum(t.numel() * t.element_size()
                     for t in (self.cache.k, self.cache.v))
        return {"slots_total": self.max_slots,
                "slots_active": int(self.active.sum()),
                "kv_tokens": tokens,
                "kv_capacity_tokens": capacity,
                "kv_pool_bytes": nbytes,
                # One device holds the whole pool (no mesh in the port).
                "kv_pool_bytes_per_device": nbytes,
                "occupancy_ratio": tokens / capacity if capacity else 0.0}

    def _free_slots(self, exclude=()) -> List[int]:
        return [i for i in range(self.max_slots)
                if not self.active[i] and i not in exclude]

    @staticmethod
    def _admit_tokens(req: Request) -> List[int]:
        """The token history admission plans against: the prompt, or for
        a preempted request the prompt plus every generated token already
        written to the cache (all outputs but the last, the carry token
        that lives in last_token; see _activate_slot)."""
        if req._preempted and req.output_tokens:
            return req.prompt_tokens + req.output_tokens[:-1]
        return req.prompt_tokens

    @staticmethod
    def _admit_budget(req: Request) -> int:
        """Token budget past _admit_tokens for page reservation: a resumed
        request's generated tokens moved into the effective prompt, so the
        budget shrinks by as many (+1 for the carry token) and the total
        reserve stays prompt + max_tokens."""
        if req._preempted and req.output_tokens:
            return req.max_tokens - len(req.output_tokens) + 1
        return req.max_tokens

    def _swap_fault_hit(self) -> bool:
        """RBT_FAULT_INJECT=swapfail:K: True exactly once, on the K-th
        host-tier copy attempt (swap-outs and swap-ins count together).
        The caller degrades as for a failed copy: drop instead of
        swap-out, recompute instead of swap-in."""
        if self._swap_fault is None:
            return False
        self._swap_fault -= 1
        if self._swap_fault <= 0:
            self._swap_fault = None
            return True
        return False

    def _bucket_for(self, n: int) -> int:
        return bucket_for(self.prefill_buckets, n)

    # -- shared-prefix cache -------------------------------------------

    def _prefix_len_for(self, n: int, quantize: bool = False) -> int:
        """Usable prefix length for an n-token prompt, leaving >= 16
        tokens to prefill. Explicit registrations round down to a multiple
        of 16; the per-turn auto-prefix path (quantize=True) floors to the
        prefill bucket set, so the prefix lengths stay a bounded set when
        every chat turn registers a new one."""
        n = min(n, self.max_seq_len - 16)
        if not quantize:
            return n // 16 * 16
        best = 0
        for b in self.prefill_buckets:
            if b <= n:
                best = b
        return best

    def _prefix_cache_hit(self, key: tuple) -> None:
        """LRU refresh: the most recently used key moves to the end."""
        self._prefix_cache[key] = self._prefix_cache.pop(key)

    def _prefix_cache_put(self, key: tuple, kv: tuple) -> None:
        self._prefix_cache[key] = kv
        if len(self._prefix_cache) > self.prefix_cache_size:
            self._prefix_cache.pop(next(iter(self._prefix_cache)))

    def register_prefix(self, tokens: List[int]) -> int:
        """Compute and cache the K/V of a shared prompt prefix (a chat
        system prompt). Returns the cached length (0: too short).

        The length rounds down to a multiple of 16 and leaves at least 16
        prompt tokens past it. Later requests whose prompt starts with the
        cached tokens prefill only their suffix."""
        plen = self._prefix_len_for(len(tokens))
        if plen < 16:
            return 0
        key = tuple(int(t) for t in tokens[:plen])
        if key in self._prefix_cache:
            self._prefix_cache_hit(key)
            return plen
        bucket = self._bucket_for(plen)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = key
        pos = np.full((1, bucket), self._pad_slot, np.int32)
        pos[0, :plen] = np.arange(plen)
        pk, pv = self._prefix_build(self.params, self._tensor(toks),
                                    self._tensor(pos))
        # Copies: the cache keeps [L, plen, kv_h, d], not the whole row.
        self._prefix_cache_put(key, (pk[:, :plen].clone(),
                                     pv[:, :plen].clone()))
        return plen

    def register_prefix_from_slot(self, slot: int,
                                  tokens: List[int]) -> int:
        """Register tokens[:plen] as a prefix by copying its K/V out of a
        slot's cache, with no forward pass: a finished request's prompt
        K/V is still in its slot (prefill wrote positions 0..m-1; decode
        writes later positions), and the next chat turn's prompt extends
        it. Call between the request finishing and the slot's next
        admission. Returns the cached length (0: too short, or already
        cached)."""
        plen = self._prefix_len_for(len(tokens), quantize=True)
        if plen < 16:
            return 0
        key = tuple(int(t) for t in tokens[:plen])
        if key in self._prefix_cache:
            self._prefix_cache_hit(key)
            return 0
        # Copies, not views of the pool, which a failed step may leave
        # broken and reset() replaces.
        self._prefix_cache_put(key, (self.cache.k[:, slot, :plen].clone(),
                                     self.cache.v[:, slot, :plen].clone()))
        return plen

    def has_prefix(self, tokens: List[int]) -> bool:
        """True when register_prefix(tokens) would be a cache hit."""
        plen = self._prefix_len_for(len(tokens))
        return (plen >= 16
                and tuple(int(t) for t in tokens[:plen])
                in self._prefix_cache)

    def _find_prefix(self, prompt: List[int]) -> Optional[tuple]:
        """Longest registered prefix this prompt starts with, leaving at
        least one suffix token; None if none matches."""
        best = None
        for key in self._prefix_cache:
            if len(key) < len(prompt) and (best is None
                                           or len(key) > len(best)):
                if tuple(prompt[:len(key)]) == key:
                    best = key
        return best

    def _admit(self, exclude_slots=()) -> None:
        budget = self.prefill_budget
        admitted: List[tuple] = []
        for slot in self._free_slots(exclude_slots):
            if not self.queue:
                break
            # Budget in bucket-padded tokens (what the prefill computes:
            # only the suffix when a registered prefix covers the front of
            # the prompt). The first admission always goes through so an
            # over-budget prompt cannot starve. Adapter requests never
            # match a prefix: its K/V came from the base weights.
            head = self.queue[0]
            pkey = (None if head.adapter is not None
                    else self._find_prefix(head.prompt_tokens))
            need = self._bucket_for(
                len(head.prompt_tokens) - (len(pkey) if pkey else 0))
            if admitted and need > budget:
                break
            req = self.queue.pop(0)
            req._admitted = time.monotonic()
            budget -= need
            admitted.append((slot, req, pkey))
        # One [rows, bucket] prefill dispatch per (bucket, prefix).
        by_group: dict = {}
        for slot, req, pkey in admitted:
            b = self._bucket_for(
                len(req.prompt_tokens) - (len(pkey) if pkey else 0))
            by_group.setdefault((b, pkey), []).append((slot, req))
        for (bucket, pkey), group in by_group.items():
            with self._dispatch("prefill"):
                self._prefill_group(bucket, group, pkey)

    def _prefill_group(self, bucket: int, group: List[tuple],
                       pkey: Optional[tuple] = None) -> None:
        """Prefill same-bucket requests as one batched forward. The row
        count is 1 (single request) or max_slots (any burst), the
        reference's two compiled shapes. Padding rows aim at group[0]'s
        slot and are overwritten by the real row 0 (descending splice).
        With pkey (a registered prefix), rows hold only the suffixes, at
        positions from the prefix's length, over the prefix's K/V."""
        n = len(group)
        plen = len(pkey) if pkey else 0
        self.prefix_lookups += n
        if pkey:
            self.prefix_hits += n
        rows = 1 if n == 1 else self.max_slots
        tokens = np.zeros((rows, bucket), np.int32)
        # Real tokens at positions plen..len-1; padding scatters to the
        # trash slot of each row's scratch cache.
        positions = np.full((rows, bucket), self._pad_slot, np.int32)
        slots = [group[0][0]] * rows
        last_pos = np.zeros(rows, np.int64)
        temps = np.zeros(rows, np.float32)
        top_ks = np.zeros(rows, np.int32)
        top_ps = np.ones(rows, np.float32)
        for i, (slot, req) in enumerate(group):
            m = len(req.prompt_tokens) - plen
            tokens[i, :m] = req.prompt_tokens[plen:]
            positions[i, :m] = np.arange(plen, plen + m)
            slots[i] = slot
            last_pos[i] = m - 1
            temps[i] = req.temperature
            top_ks[i] = req.top_k
            top_ps[i] = req.top_p
        prefix = None
        if pkey:
            # An admission hit refreshes the LRU: the prefix serving live
            # traffic is not the one evicted.
            pk, pv = self._prefix_cache[pkey]
            self._prefix_cache_hit(pkey)
            prefix = (pk, pv, n)
        first, self.cache, _ = self._prefill(
            self.params, self.cache, self._tensor(tokens),
            self._tensor(positions), slots, self._tensor(last_pos),
            self.generator, self._tensor(temps), self._tensor(top_ks),
            self._tensor(top_ps), prefix=prefix,
            **self._grammar_prefill_kwargs(group, rows))
        self.prefix_tokens_reused += plen * n
        self.prefill_dispatches += 1
        # The first tokens must reach the host to stream: the dispatch's
        # one sync.
        first = first.cpu().numpy()
        for i, (slot, req) in enumerate(group):
            self._activate_slot(slot, req, int(first[i]))

    def _activate_slot(self, slot: int, req: Request,
                       first_tok: int) -> None:
        """Post-prefill slot activation: bookkeeping, the draft index's
        context (the whole prompt, a shared prefix included), and the
        first token's recording (which may immediately finish a
        max_tokens=1 request)."""
        resumed = bool(req._preempted and req.output_tokens)
        eff = self._admit_tokens(req)
        self.active[slot] = True
        self.lengths[slot] = len(eff)
        self.slot_req[slot] = req
        req._slot = slot
        if resumed:
            # Resume after preemption: the cache again holds the written
            # history (prompt + outputs[:-1]). The carry token, sampled
            # and streamed before preemption but never written, goes back
            # into last_token so the next decode writes it at
            # lengths[slot]. The prefill's freshly sampled token is
            # discarded: that position's token was already recorded.
            carry = int(req.output_tokens[-1])
            self.last_token[slot] = carry
            if self._spec_index is not None:
                self._spec_index.begin(slot, eff)
                self._spec_index.extend(slot, carry)
            req._preempted = False
            self.preempted_resumed += 1
            return
        self.last_token[slot] = first_tok
        if self._spec_index is not None:
            self._spec_index.begin(slot, req.prompt_tokens)
        self._record_token(slot, first_tok)

    def _finish(self, slot: int, req: Request, reason: str) -> None:
        req.finished = True
        req.finish_reason = reason
        self.active[slot] = False
        self.slot_req[slot] = None
        self._on_slot_finished(slot, req)

    def _on_slot_finished(self, slot: int, req: Request) -> None:
        """Called once per slot whose request just finished (any reason,
        deadline expiry included), after its bookkeeping is cleared and
        before the slot can be admitted again. The dense pool needs no
        cache work; the paged engine also releases the slot's pages and
        adopts its written ones into the radix tree."""
        if self._spec_index is not None:
            self._spec_index.clear(slot)

    def _record_token(self, slot: int, tok: int) -> None:
        req = self.slot_req[slot]
        if req is None:
            raise RuntimeError(f"token recorded for empty slot {slot}")
        req.output_tokens.append(tok)
        if self._spec_index is not None:
            self._spec_index.extend(slot, tok)
        if len(req.output_tokens) == 1:
            self.ttft_seconds.append(time.monotonic() - req._submitted)
        if req.on_token is not None:
            req.on_token(tok)
        hit_eos = req.eos_id is not None and tok == req.eos_id
        # The grammar cursor advances here and only here (draft gating and
        # verify masks preview with the non-mutating walk). EOS is not a
        # grammar token: masks allow it exactly at accepting states, and it
        # finishes through "stop". A terminal state (accepting, nothing
        # may follow) finishes the slot here, so its mask row, which
        # allows only EOS, is never dispatched.
        grammar_done = False
        if req._grammar is not None and not hit_eos:
            if not req._grammar.advance(tok):
                # Masked sampling makes this unreachable; one request's
                # error must not take the engine down.
                self._finish(slot, req, "error")
                return
            grammar_done = req._grammar.at_terminal
        # lengths[slot] counts tokens written to the cache; the next decode
        # writes at position lengths[slot], which must stay < max_seq_len
        # (slot max_seq_len is the trash slot).
        out_of_room = self.lengths[slot] >= self.max_seq_len
        if hit_eos:
            self._finish(slot, req, "stop")
        elif grammar_done:
            self.grammar_completed += 1
            self._finish(slot, req, "grammar_complete")
        elif len(req.output_tokens) >= req.max_tokens or out_of_room:
            self._finish(slot, req, "length")

    def _expire_deadlines(self) -> List[int]:
        """Finish requests whose deadline passed (between decode chunks).
        Returns the slots freed by expiry, which the same step's admission
        must not reuse."""
        now = time.monotonic()

        def expired(r: Request) -> bool:
            return (r.deadline_s is not None
                    and now >= r._submitted + r.deadline_s)

        n = 0
        keep = []
        for r in self.queue:
            if expired(r):
                r.finished = True
                r.finish_reason = "deadline"
                n += 1
            else:
                keep.append(r)
        self.queue[:] = keep
        freed: List[int] = []
        for slot in range(self.max_slots):
            req = self.slot_req[slot]
            if self.active[slot] and req is not None and expired(req):
                self._finish(slot, req, "deadline")
                freed.append(slot)
                n += 1
        self.deadline_expired += n
        return freed

    def _sampling_operands(self):
        """Per-slot sampling and device-side finish-tracking operands for
        one decode chunk (inactive rows get inert values)."""
        reqs = [self.slot_req[i] if self.active[i] else None
                for i in range(self.max_slots)]
        temps = np.array([r.temperature if r else 0.0 for r in reqs],
                         np.float32)
        top_ks = np.array([r.top_k if r else 0 for r in reqs], np.int32)
        top_ps = np.array([r.top_p if r else 1.0 for r in reqs], np.float32)
        eos_ids = np.array([r.eos_id if r and r.eos_id is not None else -1
                            for r in reqs], np.int32)
        remaining = np.array([r.max_tokens - len(r.output_tokens) if r
                              else 0 for r in reqs], np.int32)
        return temps, top_ks, top_ps, eos_ids, remaining

    def _replay_chunk(self, toks: np.ndarray, valid: np.ndarray) -> int:
        """Replay one decode chunk on the host: `valid[k]` is exactly the
        set of slots alive at device step k, so this lands in the same
        bookkeeping state as chunk=1 stepping. Returns tokens generated.

        A grammar-constrained slot takes only the chunk's first token: its
        mask was exact for step 0 only, so later steps may have sampled
        illegal tokens. Skipped steps do not advance `lengths`; their K/V
        lies past the cursor and the next dispatch rewrites it. The device
        cannot see a grammar_complete finish either, so a slot the host
        just finished skips the rest of its chunk."""
        generated = 0
        taken: set = set()
        for k in range(toks.shape[0]):
            for slot in np.nonzero(valid[k])[0]:
                if not self.active[slot]:
                    continue
                req = self.slot_req[slot]
                if req is not None and req._grammar is not None:
                    if slot in taken:
                        continue
                    taken.add(slot)
                generated += 1
                self.lengths[slot] += 1
                tok = int(toks[k, slot])
                self.last_token[slot] = tok
                self._record_token(slot, tok)
        return generated

    def step(self) -> int:
        """Admit queued requests, then advance every active slot: one
        verify forward when speculation is on and any slot has a draft
        (slots without one ride the same forward and advance one token),
        else one decode chunk. Returns the number of tokens generated."""
        self._admit(exclude_slots=self._expire_deadlines())
        if not self.active.any():
            return 0
        generated: Optional[int] = None
        if self._spec_index is not None:
            drafts = self._collect_drafts()
            if drafts is not None:
                with self._dispatch("verify"):
                    generated = self._verify_step(drafts)
        if generated is None:
            with self._dispatch("decode"):
                generated = self._decode_chunk_step()
        self.steps += 1
        return generated

    # -- speculative decoding ------------------------------------------

    def _draft_for(self, slot: int, max_tokens: int) -> List[int]:
        """Draft proposal for one slot (<= max_tokens tokens): the
        prompt-lookup index's. Overridable, so a test or a measurement can
        substitute drafts of known accuracy and still run the real verify
        path."""
        return self._spec_index.draft(slot, max_tokens)

    def _collect_drafts(self) -> Optional[dict]:
        """{active slot: draft}, each capped so that a verify step can
        neither overrun the request's budget (emitting d + 1 tokens must
        fit max_tokens) nor write past the context window (positions
        L..L+d stay below the trash slot). None when no slot drafts
        anything: the caller then runs the plain decode chunk."""
        K = self.draft_tokens
        drafts: dict = {}
        any_draft = False
        for slot in range(self.max_slots):
            if not self.active[slot]:
                continue
            req = self.slot_req[slot]
            cap = min(K, self.max_seq_len - 1 - int(self.lengths[slot]),
                      req.max_tokens - len(req.output_tokens) - 1)
            d = self._draft_for(slot, cap) if cap >= 1 else []
            d = [int(t) for t in d[:max(cap, 0)]]
            if req._grammar is not None and d:
                # Cut at the first token the grammar refuses (and at a
                # terminal state) before dispatch, so every drafted token
                # has mass under its verify position's mask.
                legal = legal_draft_prefix(req._grammar, d)
                if len(legal) < len(d):
                    self.grammar_draft_truncations += 1
                d = legal
            drafts[slot] = d
            any_draft = any_draft or bool(d)
        return drafts if any_draft else None

    def _verify_step(self, drafts: dict) -> int:
        """One batched verify step: the [B, K+1] operands (carry-in token
        and each slot's draft), the verify forward, and each slot's
        verdict replayed on the host: the longest accepted prefix, then
        the correction or bonus token; `lengths` advances only past what
        was emitted."""
        B, K = self.max_slots, self.draft_tokens
        tokens = np.zeros((B, K + 1), np.int32)
        draft_len = np.zeros(B, np.int32)
        for slot, d in drafts.items():
            tokens[slot, 0] = self.last_token[slot]
            if d:
                tokens[slot, 1:1 + len(d)] = d
                draft_len[slot] = len(d)
        positions = np.where(self.active, self.lengths, 0).astype(np.int32)
        temps, top_ks, top_ps, _, _ = self._sampling_operands()
        step_drafted = int(draft_len.sum())
        gkw = self._grammar_verify_kwargs(drafts)
        t_dispatch = time.perf_counter()
        accept, resid, full = self._verify_dispatch(
            tokens, positions, draft_len, temps, top_ks, top_ps, gkw)
        wall = time.perf_counter() - t_dispatch
        generated = 0
        step_accepted = 0
        for slot, d in drafts.items():
            if not self.active[slot] or self.slot_req[slot] is None:
                continue
            nd = len(d)
            a = 0
            while a < nd and bool(accept[slot, a]):
                a += 1
            # The accepted drafts, then the model's own next token: the
            # residual at the first rejection, or the bonus sample after
            # a clean sweep (nd == 0: a plain one-token decode).
            emitted = d[:a] + [int(resid[slot, a]) if a < nd
                               else int(full[slot, nd])]
            self.spec_drafted += nd
            self.spec_accepted += a
            step_accepted += a
            for tok in emitted:
                if not self.active[slot]:
                    break   # EOS, budget or room finished it mid-replay
                generated += 1
                self.lengths[slot] += 1
                self.last_token[slot] = tok
                self._record_token(slot, tok)
        self.spec_verify_steps += 1
        if step_drafted:
            idx = min(int(step_accepted / step_drafted * 4), 3)
            bucket = self._spec_rate_buckets[_ACCEPT_RATE_BUCKETS[idx]]
            bucket[0] += generated
            bucket[1] += wall
        return generated

    def _verify_dispatch(self, tokens, positions, draft_len, temps,
                         top_ks, top_ps, gkw: dict):
        """The verify forward at the smallest view covering every position
        this step can write (L + K), with the verdicts on the host."""
        view = self._view_for(int(self.lengths[self.active].max())
                              + self.draft_tokens + 1)
        t = self._tensor
        accept, resid, full, self.cache = self._verify_for(view)(
            self.params, self.cache, t(tokens), t(positions), t(draft_len),
            self.generator, t(temps), t(top_ks), t(top_ps), t(self.active),
            **gkw)
        # One host sync per verify step.
        return accept.cpu().numpy(), resid.cpu().numpy(), full.cpu().numpy()

    def spec_stats(self) -> dict:
        """Speculation snapshot: draft volume, accept rate, verify steps
        and decode tokens/s by accept-rate bucket."""
        out = {"mode": self.speculative}
        if self.speculative == "off":
            return out
        out.update({
            "draft_tokens": self.draft_tokens,
            "ngram_max": self.ngram_max,
            "ngram_min": self.ngram_min,
            "drafted_total": self.spec_drafted,
            "accepted_total": self.spec_accepted,
            "accept_rate": (round(self.spec_accepted / self.spec_drafted,
                                  4) if self.spec_drafted else None),
            "verify_steps": self.spec_verify_steps,
            "tokens_per_sec_by_accept_rate": {
                name: {"tokens": tok, "seconds": round(sec, 6),
                       "tokens_per_sec": (round(tok / sec, 1)
                                          if sec > 0 else None)}
                for name, (tok, sec) in self._spec_rate_buckets.items()},
        })
        return out

    def _decode_chunk_step(self) -> int:
        # Inactive rows decode into the trash slot; mid-chunk, rows that
        # finish are parked there by the device mask.
        positions = np.where(self.active, self.lengths,
                             self._pad_slot).astype(np.int32)
        temps, top_ks, top_ps, eos_ids, remaining = self._sampling_operands()
        view = self._view_for(int(self.lengths[self.active].max())
                              + self.decode_chunk)
        toks, valid, self.cache = self._decode_for(view)(
            self.params, self.cache, self._tensor(self.last_token),
            self._tensor(positions), self.generator, self._tensor(temps),
            self._tensor(top_ks), self._tensor(top_ps),
            self._tensor(eos_ids), self._tensor(remaining),
            self._tensor(self.active), **self._grammar_decode_kwargs())
        # One host sync per chunk.
        toks = toks.cpu().numpy()            # [chunk, slots]
        valid = valid.cpu().numpy()          # [chunk, slots] bool
        return self._replay_chunk(toks, valid)

    def generate(self, requests: List[Request],
                 timeout_s: float = 600.0) -> List[Request]:
        for r in requests:
            self.submit(r)
        deadline = time.monotonic() + timeout_s
        while self.has_work() and time.monotonic() < deadline:
            self.step()
        return requests
