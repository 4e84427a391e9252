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
- Multi-tenant LoRA (``adapter_pool`` > 0): a device-resident pool of
  adapters (serve/lora_pool.AdapterPool); a request's ``adapter`` pins a
  pool lane at admission, and every prefill, decode and verify dispatch
  takes each row's lane, so tenants and base-only rows share one batch.

- Quantized serving: weight-only int8/int4 params (QuantizedArray
  leaves, ops/quantization.py) run through the forward as they are, and
  ``quantize_kv`` stores the slot pool as int8 with one f32 scale per
  (layer, slot, position, kv head). Prefill still attends full-precision
  scratch rows (K1 unchanged); each row is quantized once at the splice,
  and decode dequantizes the read view.

- Observability (runbooks_tpu_torch/obs): the latency histograms (queue
  wait, TTFT, inter-token, end to end, dispatch seconds, speculation and
  grammar), the queue_wait / prefill / decode / verify spans with the
  reference's names and arguments, tail sampling at each request's end,
  the program census (each prefill, decode and verify entry point, its
  FLOPs and bytes measured at warmup's first dispatch) and the build
  sentinel's steady mark after warmup.

- Sharded serving (``mesh=``, a DeviceMesh whose ``expert`` x ``tensor``
  ranks are more than one; parallel/): one process per GPU, each engine
  holding its rank's shard of the weights and of the KV cache
  (parallel/sharding.TensorPlan: heads, the MLP and the vocabulary over
  ``tensor``, an MoE model's experts over ``expert``). Rank 0 of the
  serving group (every rank of the mesh) alone runs the scheduler, the
  queue, the prefix cache's LRU, the page tables and the HTTP front end:
  every device program goes through one choke point (``_program``),
  where rank 0 sends the program's name and host operands to every
  follower, which runs the same program on its shard
  (``serve_follower``). Every rank so runs each dispatch on the same
  rows (an MoE layer's capacity counts them all). Sampled ids are rank
  0's (broadcast over the serving group inside the decode loop), so
  every rank feeds the same tokens forward. The adapter pool (each rank
  its shard of every lane; rank 0's pool decides residency and every
  lane write is a program), quantized weights (cut by whole blocks) and
  the int8 KV cache (each rank its kv heads' values and scales) are
  served under a mesh too; so are the paged engine's host tier and
  preemption (serve/paging.py).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
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
from runbooks_tpu_torch.obs import device as obs_device
from runbooks_tpu_torch.obs import flight as obs_flight
from runbooks_tpu_torch.obs import metrics as obs_metrics
from runbooks_tpu_torch.obs.trace import complete as trace_complete
from runbooks_tpu_torch.obs.trace import record_enabled, span
from runbooks_tpu_torch.ops.lora import write_lane
from runbooks_tpu_torch.ops.quantization import dequantize_kv, quantize_kv
from runbooks_tpu_torch.ops.sampling import sample, speculative_verify
from runbooks_tpu_torch.parallel.mesh import (
    check_mesh_model,
    check_serving_mesh,
    mesh_config_of,
    serving_axes,
)
from runbooks_tpu_torch.parallel.sharding import (
    TensorParallel,
    serve_plan,
    shard_leaf,
    shard_params,
)
from runbooks_tpu_torch.serve.grammar import (
    GrammarCache,
    GrammarError,
    TokenVocab,
)
from runbooks_tpu_torch.serve.lora_pool import AdapterLoadError, AdapterPool
from runbooks_tpu_torch.serve.speculative import (
    NgramDraftIndex,
    legal_draft_prefix,
)
from runbooks_tpu_torch.utils import cuda_build
from runbooks_tpu_torch.utils.hw import backend_tuning
from runbooks_tpu_torch.utils.tree import tree_map

# QoS classes, best first: admission orders the queue by class (FIFO
# within a class). The strings are the public API (the HTTP `priority`
# field and the X-Priority header).
PRIORITY_RANK = {"interactive": 0, "standard": 1, "batch": 2}

# spec_stats' accept-rate buckets (verify steps by their accepted share of
# drafted tokens).
_ACCEPT_RATE_BUCKETS = ("0-25%", "25-50%", "50-75%", "75-100%")

# Accept-length histogram buckets (tokens accepted per slot per verify
# step), fixed so the exposition compares across draft windows.
_ACCEPT_LEN_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)

# Inter-token gaps run from microseconds (host replay inside a decode
# chunk) to chunk wall time; the default buckets start at 1 ms.
_INTER_TOKEN_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5)


_DISPATCH_HELP = {
    "decode": "Decode-chunk dispatch+sync wall time, labeled by cache view "
              "bucket.",
    "verify": "Speculative verify dispatch+sync wall time, labeled by "
              "cache view bucket.",
}


def _observe_request_done(req: "Request", now: float) -> None:
    """A request's end (any finish reason, deadline expiry included): its
    end-to-end latency by finish reason, and the tail-sampling decision
    (obs/flight.py) that promotes a slow, expired or failed request's
    ring timeline to trace.jsonl."""
    obs_metrics.REGISTRY.observe(
        "serve_request_duration_seconds", now - req._submitted,
        reason=req.finish_reason or "stop",
        help_text="End-to-end request latency (submit to finish).")
    obs_flight.tail_sample(req.request_id, now - req._submitted,
                           req.finish_reason or "stop")


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
    # Name or path of a LoRA adapter to decode through (a pooled engine
    # only): admission pins the adapter's pool lane, paging it in if
    # needed, and the slot decodes through that lane.
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
    _last_token_t: float = 0.0  # monotonic time of the latest token
    _slot: int = -1           # the slot it was admitted to
    _adapter_lane: int = -1   # pool lane pinned at admission (-1: base)
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


# Seconds a tensor-parallel leader may stay silent before it tells its
# followers it is alive (each follower waits for the next program call
# inside a collective, which carries the group's finite timeout).
HEARTBEAT_S = 5.0

# What collective_matmul "auto" resolves to under mesh_tensor > 1. The
# reference leaves "auto" free to choose; the port keeps its one
# all-reduce after each sharded sublayer (the ring collective matmul,
# ops/collective_matmul.py, is not ported, so "ring" is refused).
COLLECTIVE_MATMUL_AUTO = "all_reduce"


def local_kv_heads(cfg: ModelConfig, tp: Optional[TensorParallel]) -> int:
    """The kv heads one rank's cache holds (all of them without ``tp``)."""
    if tp is None:
        return cfg.num_kv_heads
    return len(tp.plan.kv_head_ids(tp.rank))


def _scratch_rows(cfg: ModelConfig, rows: int, cache_len: int,
                  device, tp: Optional[TensorParallel] = None) -> KVCache:
    shape = (cfg.num_layers, rows, cache_len, local_kv_heads(cfg, tp),
             cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.activation_dtype,
                                 device=device),
                   v=torch.zeros(shape, dtype=cfg.activation_dtype,
                                 device=device))


def make_prefill_fn(cfg: ModelConfig, cache_len: int,
                    tp: Optional[TensorParallel] = None):
    """Batched prefill + splice + first-token sample for one admission
    group. ``pool`` is the slot cache, updated in place and returned.
    With ``prefix`` = (pk, pv, n): a registered shared prefix's K/V
    [L, plen, kv_h, d] goes into slots [0, plen) of the first n scratch
    rows (the real ones; padding rows get none), and ``tokens`` holds only
    the suffixes, at positions from plen. Returns the sampled first
    tokens, the pool, and each row's last-position logits [rows, vocab]
    f32. ``gmask`` [rows, vocab] bool (grammar on): each row's allowed
    first tokens. ``adapters`` (a pooled engine): (adapter pool, each
    row's lane [rows], -1 for base-only and padding rows).

    The scratch rows stay in the activation dtype when the pool is int8,
    so prefill attention runs at full precision; each row is quantized
    exactly once at the splice. ``tp``: one tensor-parallel rank's
    program, on its shards (the logits come back whole)."""

    def prefill_fn(params, pool: KVCache, tokens, positions, slots,
                   last_pos, generator, temps, top_ks, top_ps,
                   prefix=None, gmask=None, adapters=None):
        # Prefill `rows` requests into fresh zero rows, then splice each
        # row into the pool. Stale data from a slot's previous occupant
        # needs no clearing: these queries attend only slots <= their own
        # position, all (re)written by this prefill or later decode.
        # Padding rows carry slots[0] as their destination; the splice
        # runs in DESCENDING row order so the real row 0 lands last.
        rows = tokens.shape[0]
        scratch = _scratch_rows(cfg, rows, cache_len, tokens.device, tp)
        if prefix is not None:
            # Exactly plen slots: no padding key a suffix query could
            # attend.
            pk, pv, n = prefix
            plen = pk.shape[1]
            scratch.k[:, :n, :plen] = pk[:, None]
            scratch.v[:, :n, :plen] = pv[:, None]
        x, scratch = forward(cfg, params, tokens, positions=positions,
                             cache=scratch, return_activations=True,
                             adapters=adapters, tp=tp)
        for r in range(rows - 1, -1, -1):
            k, v = scratch.k[:, r], scratch.v[:, r]
            if pool.quantized:
                k, pool.k_scale[:, slots[r]] = quantize_kv(k)
                v, pool.v_scale[:, slots[r]] = quantize_kv(v)
            pool.k[:, slots[r]] = k
            pool.v[:, slots[r]] = v
        # The head runs on each row's last real position only: the
        # [rows, bucket, vocab] f32 logits are never built.
        rows_idx = torch.arange(rows, device=tokens.device)
        last_logits = lm_head(cfg, params, x[rows_idx, last_pos], tp)
        first = sample(last_logits, generator, temps, top_ks, top_ps,
                       gmask=gmask)
        return first, pool, last_logits

    return prefill_fn


def make_prefix_build_fn(cfg: ModelConfig, cache_len: int,
                         tp: Optional[TensorParallel] = None):
    """The prefix-K/V build: one bucket-width row (padding at the trash
    slot), K/V [L, cache_len, kv_h, d] returned whole; the caller slices
    to the prefix's length. Its launch shapes are the one-row prefill's
    at each bucket."""

    def prefix_build_fn(params, tokens, positions):
        scratch = _scratch_rows(cfg, 1, cache_len, tokens.device, tp)
        _, scratch = forward(cfg, params, tokens, positions=positions,
                             cache=scratch, return_activations=True, tp=tp)
        return scratch.k[:, 0], scratch.v[:, 0]

    return prefix_build_fn


def make_decode_fn(cfg: ModelConfig, chunk: int, max_len: int,
                   pad_slot: int, view: int,
                   tp: Optional[TensorParallel] = None):
    """`chunk` decode steps with per-slot liveness tracked on the device by
    exactly the host's finish rules (EOS, max_tokens budget, cache out of
    room), so the host can replay (tokens, valid) and land in the same
    slot state as chunk=1 stepping. Nothing here waits for the device.

    ``gmask`` [B, vocab] (grammar on) is each slot's allowed-token row at
    the chunk's start. It stays fixed over the chunk, so it is exact for
    the first step only: the host takes one token per chunk from a
    constrained slot (InferenceEngine._replay_chunk). ``adapters`` (a
    pooled engine): (adapter pool, each slot's lane [B]). ``tp``: one
    tensor-parallel rank's program; each step's sampled ids are rank 0's
    (``sample_ids``)."""

    def decode_fn(params, cache, tokens, positions, generator,
                  temperature, top_k, top_p, eos_ids, remaining, active,
                  gmask=None, adapters=None):
        tok, pos, alive = tokens, positions, active
        emitted = torch.zeros_like(remaining)
        toks, valid = [], []
        for _ in range(chunk):
            p = torch.where(alive, pos, pad_slot)
            logits, cache = forward(cfg, params, tok[:, None],
                                    positions=p[:, None], cache=cache,
                                    cache_view=view, adapters=adapters,
                                    tp=tp)
            nxt = sample_ids(tp, logits[:, -1], generator, temperature,
                             top_k, top_p, gmask).to(tok.dtype)
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


def sample_ids(tp: Optional[TensorParallel], logits, generator, temperature,
               top_k, top_p, gmask=None) -> torch.Tensor:
    """``ops/sampling.sample``; under a serving mesh the ids rank 0
    drew, broadcast over the serving group, so every rank feeds the same
    tokens forward (each rank's logits are the same gathered logits, but
    its generator is its own)."""
    ids = sample(logits, generator, temperature, top_k, top_p, gmask=gmask)
    if tp is not None and tp.world > 1:
        ids = tp.broadcast(ids)
    return ids


def make_verify_fn(cfg: ModelConfig, draft_tokens: int, pad_slot: int,
                   view: int, tp: Optional[TensorParallel] = None):
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
    (grammar on): the allowed tokens at each verify position. ``adapters``
    (a pooled engine): (adapter pool, each slot's lane [B])."""
    K = draft_tokens

    def verify_fn(params, cache, tokens, positions, draft_len, generator,
                  temperature, top_k, top_p, active, gmask=None,
                  adapters=None):
        offs = torch.arange(K + 1, dtype=positions.dtype,
                            device=positions.device)[None, :]
        live = active[:, None] & (offs <= draft_len[:, None])
        pos = torch.where(live, positions[:, None] + offs, pad_slot)
        logits, cache = forward(cfg, params, tokens, positions=pos,
                                cache=cache, cache_view=view,
                                adapters=adapters, tp=tp)
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
                 preemption: str = "off",
                 adapter_pool: Optional[int] = None,
                 lora_rank: Optional[int] = None,
                 adapter_dir: Optional[str] = None,
                 quantize_kv: Optional[bool] = None,
                 mesh=None):
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

        adapter_pool / lora_rank / adapter_dir: multi-tenant LoRA
        serving. adapter_pool > 0 (None follows cfg.adapter_pool) keeps
        that many adapters resident on the device as a stacked pool
        (serve/lora_pool.AdapterPool), each padded to the rank bucket
        lora_rank (None: cfg.lora_rank) over cfg.lora_targets; a request's
        `adapter` (a name under adapter_dir, or a path) pins a lane at
        admission, paged in from its artifact and evicted by LRU when no
        request pins it, and mixed-tenant traffic batches in one dispatch.
        With the pool off, a request naming an adapter is refused.

        quantize_kv: store the KV cache as int8 with one f32 scale per
        (layer, slot, position, kv head), about half the bytes of a bf16
        cache. None follows cfg.quantize_kv, and when that is None too,
        the weights: a quantized-weight tier (cfg.quantize != "none")
        quantizes its cache as well. Pairs with weight-only quantized
        params (ops/quantization.py), which the forward takes as they are.

        RBT_FAULT_INJECT=swapfail:K (environment) makes the K-th host-tier
        page copy fail once, so the degrade-to-drop and
        degrade-to-recompute paths can be exercised.

        mesh: a torch.distributed.device_mesh.DeviceMesh (parallel/mesh
        .make_mesh) to serve one replica over its ``expert`` and
        ``tensor`` axes, one process per device. ``params`` is then the
        full tree or the rank's shard (serve/api.load_model's
        ``shard``), on any device: each rank keeps its shard
        (parallel/sharding.serve_plan, shard_params) on its own device.
        Every rank builds the engine with the same arguments; rank 0
        drives it and the others run ``serve_follower``. The adapter
        pool, quantized weights and the int8 KV cache are served under it
        (a quantized weight whose contraction rows a rank would cut off a
        block raises by name); other axes above 1 and collective_matmul
        "ring" are refused by name; collective_matmul "auto" resolves to
        the port's one all-reduce after each sharded sublayer
        (``self.collective_matmul``, COLLECTIVE_MATMUL_AUTO)."""
        check_supported(cfg)
        self.cfg = cfg
        if quantize_kv is None:
            quantize_kv = (cfg.quantize_kv if cfg.quantize_kv is not None
                           else cfg.quantize != "none")
        self.quantize_kv = bool(quantize_kv)
        # The sharded state: this rank's view of the mesh (None without a
        # mesh of more than one rank), whether this engine drives
        # followers, and the choke point's nesting depth.
        self.mesh = mesh
        self.tp: Optional[TensorParallel] = None
        # What the sharded forward's collectives are: None on one device.
        self.collective_matmul: Optional[str] = None
        self._leader = False
        self._program_depth = 0
        self._last_send = time.monotonic()
        if mesh is not None:
            params = self._mesh_params(params, mesh)
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
        self.tokenizer = tokenizer
        self._token_vocab: Optional[TokenVocab] = None
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
            self._token_vocab = TokenVocab.from_tokenizer(tokenizer)
            self._grammar_cache = GrammarCache(
                self._token_vocab, cfg.vocab_size,
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
        pool_size = int(adapter_pool if adapter_pool is not None
                        else cfg.adapter_pool)
        if pool_size < 0:
            raise ValueError(f"adapter_pool must be >= 0, got {pool_size}")
        # None when off: requests that carry an `adapter` 400 at
        # validation.
        self.adapters: Optional[AdapterPool] = (
            AdapterPool(cfg, pool_size=pool_size, rank=lora_rank,
                        root=adapter_dir, device=self.device,
                        cut=None if self.tp is None else functools.partial(
                            shard_leaf, plan=self.tp.plan,
                            rank=self.tp.rank),
                        write=None if self.tp is None
                        else self._adapter_write)
            if pool_size else None)
        # Each slot's adapter lane (-1: base only), the operand every
        # pooled dispatch gathers A/B by.
        self.adapter_slots = np.full(max_slots, -1, np.int32)
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
        self._prefill = make_prefill_fn(cfg, self.max_seq_len + 1, self.tp)
        self._prefix_build = make_prefix_build_fn(cfg, self.max_seq_len + 1,
                                                  self.tp)
        self._decode_fns: dict = {}
        self._verify_fns: dict = {}
        # Device-level observability (obs/device.py): a kernel build after
        # warmup is a serve-time stall the sentinel flags; the program
        # census carries each entry point's first-dispatch costs.
        obs_device.SENTINEL.install()
        self.warmup_census: Optional[dict] = None
        self._marked_steady = False   # one steady claim per engine
        self._register_programs()
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

    def _mesh_params(self, params: Params, mesh) -> Params:
        """Validate a serving mesh, set up this rank's TensorParallel and
        return its shard of ``params`` on its device."""
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise ValueError(
                f"mesh must be a torch.distributed.device_mesh.DeviceMesh, "
                f"got {type(mesh).__name__}")
        mc = mesh_config_of(mesh)
        check_serving_mesh(mc)
        check_mesh_model(self.cfg, mc, serving=True)
        world = mc.expert * mc.tensor
        if world > 1 and self.cfg.collective_matmul not in ("off", "auto"):
            raise NotImplementedError(
                f"collective_matmul={self.cfg.collective_matmul!r} under a "
                f"mesh ({serving_axes(mc)}): not ported yet (ROADMAP.md "
                f"§1); serve without it or on one device")
        dev = (torch.device("cuda", torch.cuda.current_device())
               if mesh.device_type == "cuda" else torch.device("cpu"))
        if world > 1:
            import torch.distributed as dist

            if world != dist.get_world_size():
                raise ValueError(
                    f"a serving mesh of {world} ranks in a group of "
                    f"{dist.get_world_size()}: the mesh spans the group "
                    "(parallel/mesh.make_mesh)")
            rank = (mesh.get_local_rank("expert") * mc.tensor
                    + mesh.get_local_rank("tensor"))
            self.tp = TensorParallel(
                serve_plan(self.cfg, mc.tensor, mc.expert), rank,
                mesh.get_group("tensor"), dist.group.WORLD)
            self.collective_matmul = COLLECTIVE_MATMUL_AUTO
            self._leader = rank == 0
            params = shard_params(params, self.tp.plan, rank)
        return tree_map(lambda t: t.to(dev), params)

    def _new_cache(self) -> KVCache:
        return KVCache.create(self.cfg, self.max_slots, self.max_seq_len,
                              self.device, trash_slot=True,
                              quantize_kv=self.quantize_kv,
                              kv_heads=local_kv_heads(self.cfg, self.tp))

    def _register_programs(self) -> None:
        """The entry points of the census: prefill (its prefix splice is
        the same function, counted apart as the reference's two programs)
        and the prefix build; decode and verify register per view as they
        are made."""
        obs_device.PROGRAMS.register("serve", "prefill", self._prefill)
        obs_device.PROGRAMS.register("serve", "prefill_prefix",
                                     self._prefill)
        obs_device.PROGRAMS.register("serve", "prefix_build",
                                     self._prefix_build)

    def _decode_for(self, view: int):
        if view not in self._decode_fns:
            self._decode_fns[view] = make_decode_fn(
                self.cfg, self.decode_chunk, self.max_seq_len,
                self._pad_slot, view, self.tp)
            obs_device.PROGRAMS.register("serve", f"decode_v{view}",
                                         self._decode_fns[view])
        return self._decode_fns[view]

    def _verify_for(self, view: int):
        if view not in self._verify_fns:
            self._verify_fns[view] = make_verify_fn(
                self.cfg, self.draft_tokens, self._pad_slot, view, self.tp)
            obs_device.PROGRAMS.register("serve", f"verify_v{view}",
                                         self._verify_fns[view])
        return self._verify_fns[view]

    @contextlib.contextmanager
    def _dispatch(self, kind: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"{kind}_dispatch"):
            yield
        self.dispatch_seconds[kind] += time.perf_counter() - t0

    # -- the choke point of every device program -----------------------

    def _program(self, name: str, *args, **kwargs):
        """Run device program ``name`` (the method ``_p_<name>``) on host
        operands. A tensor-parallel leader first sends the call to every
        follower, which runs the same method on its shards; a call made
        inside another (warmup's) rides the outer one."""
        if self._leader and self._program_depth == 0:
            self._send((name, args, kwargs))
        self._program_depth += 1
        try:
            return getattr(self, "_p_" + name)(*args, **kwargs)
        finally:
            self._program_depth -= 1

    def _exchange(self, msg=None):
        """Rank 0's ``msg`` on every rank of the serving group (host
        objects, pickled; the leader sends, a follower receives)."""
        import torch.distributed as dist

        box = [msg]
        group = self.tp.serve_group
        kw = ({"device": self.device} if self.device.type == "cuda"
              and dist.get_backend(group) == "nccl" else {})
        dist.broadcast_object_list(box, src=self.tp._leader(), group=group,
                                   **kw)
        return box[0]

    def _send(self, msg) -> None:
        self._exchange(msg)
        self._last_send = time.monotonic()

    def heartbeat(self) -> None:
        """Called by an idle serving loop: a leader silent for HEARTBEAT_S
        tells its followers it is alive, so their wait for the next call
        never reaches the group's timeout while the server idles."""
        if self._leader and time.monotonic() - self._last_send > HEARTBEAT_S:
            self._send(("noop", (), {}))

    def stop_followers(self) -> None:
        """Release the followers' loops (a leader's last message)."""
        if self._leader:
            self._send(("stop", (), {}))
            self._leader = False

    def serve_follower(self) -> None:
        """A follower rank's life: run each program call rank 0 sends, on
        this rank's shards, until rank 0 says stop (which releases the
        steady claim its warmup made). Rank 0's host state (queue, slots,
        page tables, the prefix LRU) has no copy here."""
        if not self._follower:
            raise RuntimeError("serve_follower runs on a follower rank of "
                               "a serving mesh")
        with torch.no_grad():
            while True:
                name, args, kwargs = self._exchange()
                if name == "stop":
                    self.release_steady()
                    return
                if name != "noop":
                    self._program(name, *args, **kwargs)

    def _dev(self, a):
        return a if isinstance(a, torch.Tensor) else self._tensor(a)

    @property
    def _follower(self) -> bool:
        """A follower rank of a serving mesh (rank 0's program calls are
        its only work)."""
        return self.tp is not None and self.tp.rank != 0

    def _lane_kwargs(self) -> dict:
        """A pooled engine's slot lanes as a decode or verify program's
        operand: a follower holds no slot state of its own."""
        return {} if self.adapters is None else {"aslots": self.adapter_slots}

    def _operand_kwargs(self, gmask=None, aslots=None) -> dict:
        """A program's optional operands on the device: the grammar mask
        and, on a pooled engine, the adapter lanes (default each slot's)."""
        kw = {} if gmask is None else {"gmask": self._dev(gmask)}
        kw.update(self._adapter_kwargs(aslots))
        return kw

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
            if self.adapters is None:
                raise ValueError(
                    "this server has no adapter pool (adapter_pool: 0); "
                    "request-level `adapter` needs a pooled engine or a "
                    "dedicated server with the adapter folded at load")
            err = self.adapters.can_resolve(req.adapter)
            if err is not None:
                raise ValueError(err)
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
            reg = obs_metrics.REGISTRY
            reg.inc("serve_grammar_requests_total",
                    help_text="Requests admitted with a compiled "
                              "response_format constraint.")
            st = self._grammar_cache.stats()
            reg.set_counter("serve_grammar_cache_hits_total", st["hits"],
                            help_text="Grammar DFA compile-cache hits.")
            reg.set_counter("serve_grammar_cache_misses_total",
                            st["misses"],
                            help_text="Grammar DFA compile-cache misses "
                                      "(each is one host-side compile).")

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
        if req.adapter is not None and self.adapters is not None:
            self.adapters.count_request(req.adapter)
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
        self._program("reset_cache")
        self.lengths[:] = 0
        self.active[:] = False
        self.last_token[:] = 0
        self.slot_req = [None] * self.max_slots
        self.queue.clear()
        if self._spec_index is not None:
            self._spec_index.reset()
        self._reset_adapters()

    def _p_reset_cache(self) -> None:
        self.cache = None
        self.cache = self._new_cache()

    def _reset_adapters(self) -> None:
        """Every in-flight request is gone, so no adapter lane stays
        pinned. Residency survives (no step writes the pool): the next
        admission of a resident adapter hits instead of reloading."""
        self.adapter_slots[:] = -1
        if self.adapters is not None:
            self.adapters.reset_refs()

    # -- adapter pool --------------------------------------------------

    def _adapter_kwargs(self, aslots: Optional[np.ndarray] = None) -> dict:
        """A pooled engine's extra operand on every dispatch: (pool, each
        row's lane), default the slots' lanes (-1: the trash lane). Empty
        with the pool off."""
        if self.adapters is None:
            return {}
        if aslots is None:
            aslots = self.adapter_slots
        return {"adapters": (self.adapters.tree, self._tensor(aslots))}

    def _adapter_write(self, adapter, lane: int, path: str) -> None:
        """The leader's lane write under a mesh (the pool's ``write``): it
        sends the artifact's path and the lane to every follower
        (_p_adapter_write) and writes its own loaded shard."""
        if self._leader:
            self._send(("adapter_write", (path, lane), {}))
        write_lane(self.adapters.tree, adapter, lane)

    def _p_adapter_write(self, path: str, lane: int) -> None:
        """A follower's lane write: the same artifact, read and cut to
        this rank's shard of the pool."""
        write_lane(self.adapters.tree, self.adapters.load(path), lane)

    def adapter_stats(self) -> Optional[dict]:
        """Adapter pool snapshot (residency, loads, evictions, hits,
        requests per adapter); None with the pool off."""
        return None if self.adapters is None else self.adapters.stats()

    def _acquire_adapter(self, req: Request) -> bool:
        """Pin the request's adapter lane ahead of admission. True:
        proceed (lane pinned, or no adapter involved). False: every lane
        is pinned; the caller stops admitting (queue backpressure). A
        load failure finishes the request with finish_reason "error" and
        returns True with req.finished set: the caller drops it from the
        queue."""
        if req.adapter is None or self.adapters is None:
            return True
        if req._adapter_lane >= 0:
            return True
        try:
            lane = self.adapters.acquire(req.adapter)
        except AdapterLoadError as exc:
            req.finished = True
            req.finish_reason = "error"
            print(f"serve: adapter {req.adapter!r} failed to load at "
                  f"admission: {exc}", flush=True)
            _observe_request_done(req, time.monotonic())
            return True
        if lane is None:
            return False
        req._adapter_lane = lane
        return True

    def _release_adapter(self, req: Request) -> None:
        if self.adapters is not None and req._adapter_lane >= 0:
            self.adapters.release(req._adapter_lane)
            req._adapter_lane = -1

    # -- grammar masks -------------------------------------------------
    #
    # Empty when grammar is off. When on, every dispatch takes a mask:
    # all-True rows for unconstrained slots, where masking is the identity.

    def _mask_kwargs(self, mask: np.ndarray, t0: float) -> dict:
        dt = time.perf_counter() - t0
        self.grammar_mask_seconds.append(dt)
        obs_metrics.REGISTRY.observe(
            "serve_grammar_mask_build_seconds", dt,
            buckets=_INTER_TOKEN_BUCKETS,
            help_text="Host-side gmask operand build time per dispatch "
                      "(grammar-constrained decoding).")
        return {"gmask": mask}

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

    @property
    def tokenizer_fingerprint(self) -> Optional[str]:
        """The vocabulary's content hash (serve/grammar.TokenVocab), built
        at first use: /debug/programs shows it so that replicas can be
        checked to serve one vocabulary. None without a tokenizer."""
        if self._token_vocab is None:
            if self.tokenizer is None:
                return None
            try:
                self._token_vocab = TokenVocab.from_tokenizer(self.tokenizer)
            except GrammarError:
                return None
        return self._token_vocab.fingerprint

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
        """Run ``_p_warmup`` (on every rank of a tensor-parallel mesh)."""
        self._program("warmup")

    def _p_warmup(self) -> None:
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
        module load). A pooled engine runs every one of them through the
        adapter delta (on trash lanes) and warms the lane write
        (AdapterPool.warm).

        Each of these dispatches is its entry point's first at its shape:
        it runs under obs/device's counting mode (FLOPs and bytes into the
        program census; RBT_DEVICE_OBS=0 skips it). The builds here are the
        expected ones; afterwards the engine is steady, and a kernel build
        is a stall the sentinel flags."""
        t_warm, before = self._warmup_begin()
        cost = obs_device.program_cost
        with obs_device.SENTINEL.expected():
            if self.device.type == "cuda":
                cuda_build.build(["flash_fwd"])
            if self.adapters is not None:
                self.adapters.warm()
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            t = self._tensor
            vocab = self.cfg.vocab_size
            rows_set = sorted({1, self.max_slots})
            for bucket in self.prefill_buckets:
                for rows in rows_set:
                    positions = np.full((rows, bucket), self._pad_slot,
                                        np.int32)
                    positions[:, :2] = [0, 1]
                    first, self.cache, _ = cost(
                        "serve", "prefill", f"b{bucket}r{rows}",
                        self._prefill, self.params, self.cache,
                        t(np.zeros((rows, bucket), np.int32)),
                        t(positions), [0] * rows,
                        t(np.ones(rows, np.int64)), gen,
                        t(np.zeros(rows, np.float32)),
                        t(np.zeros(rows, np.int32)),
                        t(np.ones(rows, np.float32)),
                        **self._grammar_warm_kwargs((rows, vocab)),
                        **self._adapter_kwargs(np.full(rows, -1, np.int32)))
            n = self.max_slots
            idle = np.zeros(n, np.int32)
            akw = self._adapter_kwargs(np.full(n, -1, np.int32))
            for view in self.view_buckets:
                first, _, self.cache = cost(
                    "serve", f"decode_v{view}", f"v{view}",
                    self._decode_for(view), self.params, self.cache,
                    t(idle), t(np.full(n, self._pad_slot, np.int32)), gen,
                    t(np.zeros(n, np.float32)), t(idle),
                    t(np.ones(n, np.float32)), t(np.full(n, -1, np.int32)),
                    t(idle), t(np.zeros(n, bool)),
                    **self._grammar_warm_kwargs((n, vocab)), **akw)
                if self._spec_index is not None:
                    first, _, _, self.cache = cost(
                        "serve", f"verify_v{view}", f"v{view}",
                        self._verify_for(view), self.params, self.cache,
                        t(np.zeros((n, self.draft_tokens + 1), np.int32)),
                        t(idle), t(idle), gen, t(np.zeros(n, np.float32)),
                        t(idle), t(np.ones(n, np.float32)),
                        t(np.zeros(n, bool)),
                        **self._grammar_warm_kwargs(
                            (n, self.draft_tokens + 1, vocab)), **akw)
            first.cpu()
        self._warmup_end(t_warm, before, rows_set, list(self.view_buckets))
        self.reset()

    def _warmup_begin(self) -> tuple:
        s = obs_device.SENTINEL
        return time.perf_counter(), (s.total, s.compile_seconds)

    def _warmup_end(self, t_warm: float, before: tuple, rows: list,
                    views: list, **extra) -> None:
        """The warmup census (what /debug/programs shows beside the
        programs: the shapes walked, the builds they took, the seconds)
        and this engine's one steady claim, released by release_steady."""
        sentinel = obs_device.SENTINEL
        census = obs_device.PROGRAMS.census("serve")
        n_verify = len(views) if self._spec_index is not None else 0
        self.warmup_census = {
            "prefill_programs": len(self.prefill_buckets) * len(rows),
            "prefill_buckets": list(self.prefill_buckets),
            "rows": rows,
            "decode_views": views,
            "verify_programs": n_verify,
            "speculative": self.speculative,
            "draft_tokens": self.draft_tokens,
            "adapter_pool": (self.adapters.pool_size
                             if self.adapters is not None else 0),
            "lora_rank": (self.adapters.rank
                          if self.adapters is not None else None),
            "grammar": self.grammar,
            "grammar_cache_size": (self._grammar_cache.capacity
                                   if self._grammar_cache is not None
                                   else None),
            **extra,
            "compiles": sentinel.total - before[0],
            "compile_seconds": round(
                sentinel.compile_seconds - before[1], 3),
            "warmup_seconds": round(time.perf_counter() - t_warm, 3),
            "programs": [{"name": c["name"], "programs": c["programs"]}
                         for c in census],
        }
        if not self._marked_steady:
            # Every rank claims steady in its own process (a follower's
            # build after warmup is as unexpected as rank 0's); rank 0
            # alone reports.
            self._marked_steady = True
            sentinel.mark_steady("serve")
        if self._follower:
            return
        print(f"serve: warmup census: {self.warmup_census['prefill_programs']}"
              f" prefill shapes (buckets {self.prefill_buckets} x rows "
              f"{rows}), {len(views)} decode views {views}, {n_verify} "
              f"verify shapes; {self.warmup_census['compiles']} kernel "
              f"builds in {self.warmup_census['compile_seconds']}s; "
              f"{self.warmup_census['warmup_seconds']}s", flush=True)

    def release_steady(self) -> None:
        """Release this engine's steady claim (the worker calls it at
        stop). Idempotent; pairs with warmup()'s one mark."""
        if self._marked_steady:
            self._marked_steady = False
            obs_device.SENTINEL.clear_steady("serve")

    def memory_groups(self) -> dict:
        """Named tensor groups for obs/device.memory_snapshot: the
        weights, the slot-pool KV cache, the shared-prefix cache (copied
        first: an HTTP thread reads it while the worker registers and
        evicts) and, on a pooled engine, the adapter pool. Under a mesh
        these are this rank's shards: its device's bytes, as the
        reference's census counts each device's shard."""
        groups = {"weights": self.params,
                  "kv_cache": self.cache,
                  "prefix_cache": list(self._prefix_cache.copy().values())}
        if self.adapters is not None:
            groups["adapter_pool"] = self.adapters.tree
        return groups

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any())

    def kv_occupancy(self) -> dict:
        """Token-level occupancy of the dense slot pool: the [max_slots,
        max_seq_len] reservation against the tokens actually cached; its
        bytes count an int8 pool's scales."""
        capacity = self.max_slots * self.max_seq_len
        tokens = int(self.lengths[self.active].sum())
        nbytes = self.cache.nbytes
        return {"slots_total": self.max_slots,
                "slots_active": int(self.active.sum()),
                "kv_tokens": tokens,
                "kv_capacity_tokens": capacity,
                "kv_pool_bytes": self._logical_kv_bytes(nbytes),
                # This device's share: its kv heads under a mesh.
                "kv_pool_bytes_per_device": nbytes,
                "occupancy_ratio": tokens / capacity if capacity else 0.0}

    def _logical_kv_bytes(self, local: int) -> int:
        """The whole pool's bytes (every kv head) from this rank's."""
        return (local * self.cfg.num_kv_heads
                // local_kv_heads(self.cfg, self.tp))

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

    def _prefix_evictions(self, key: tuple) -> list:
        """The keys that putting ``key`` evicts: the least recently used
        past prefix_cache_size. Decided by the host that owns the LRU
        order (rank 0 of a mesh) and carried in the program call."""
        order = list(self._prefix_cache) + [key]
        return order[:max(0, len(order) - self.prefix_cache_size)]

    def _prefix_cache_put(self, key: tuple, kv: tuple, drop: list) -> None:
        self._prefix_cache[key] = kv
        for k in drop:
            self._prefix_cache.pop(k, None)

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
        self._program("prefix_build", toks, pos, key,
                      self._prefix_evictions(key))
        return plen

    def _p_prefix_build(self, toks, pos, key: tuple, drop: list) -> None:
        pk, pv = self._prefix_build(self.params, self._tensor(toks),
                                    self._tensor(pos))
        # Copies: the cache keeps [L, plen, kv_h, d], not the whole row.
        plen = len(key)
        self._prefix_cache_put(key, (pk[:, :plen].clone(),
                                     pv[:, :plen].clone()), drop)

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
        self._program("prefix_from_slot", slot, key,
                      self._prefix_evictions(key))
        return plen

    def _p_prefix_from_slot(self, slot: int, key: tuple, drop: list) -> None:
        # Copies, not views of the pool, which a failed step may leave
        # broken and reset() replaces. An int8 pool's rows are
        # dequantized: the prefix cache stays in the activation dtype (the
        # splice prefill quantizes it again on admission).
        plen = len(key)
        c = self.cache
        pk, pv = c.k[:, slot, :plen], c.v[:, slot, :plen]
        if c.quantized:
            ad = self.cfg.activation_dtype
            pk = dequantize_kv(pk, c.k_scale[:, slot, :plen], ad)
            pv = dequantize_kv(pv, c.v_scale[:, slot, :plen], ad)
        else:
            pk, pv = pk.clone(), pv.clone()
        self._prefix_cache_put(key, (pk, pv), drop)

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
            if not self._acquire_adapter(head):
                # Every pool lane is pinned by an in-flight request: the
                # head waits (FIFO) and the queue backs up until submit()
                # sheds with the typed 429.
                break
            if head.finished:
                # Its adapter failed to load: finished with an error.
                self.queue.pop(0)
                continue
            req = self.queue.pop(0)
            self._observe_admission(req, slot)
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

    def _observe_admission(self, req: Request, slot: int) -> None:
        """Admission: the queue wait's histogram and its backdated span,
        so a request's timeline reads queue_wait -> prefill -> decode."""
        req._admitted = time.monotonic()
        wait = req._admitted - req._submitted
        obs_metrics.REGISTRY.observe(
            "serve_queue_wait_seconds", wait,
            help_text="Admission-queue wait (submit to slot assignment).")
        if record_enabled():
            trace_complete("queue_wait", wait, request_id=req.request_id,
                           slot=slot)

    @contextlib.contextmanager
    def _prefill_span(self, bucket: int, rows: int, prefix: int,
                      group: List[tuple]):
        """The prefill dispatch's span and its dispatch-seconds histogram,
        labeled by (bucket, rows): the two row counts are different
        programs. Request ids materialize only when something records."""
        attrs = ({"request_ids": [r.request_id for _, r in group]}
                 if record_enabled() else {})
        t0 = time.perf_counter()
        with span("prefill", bucket=bucket, rows=rows, prefix=prefix,
                  **attrs):
            yield
        obs_metrics.REGISTRY.observe(
            "serve_prefill_dispatch_seconds", time.perf_counter() - t0,
            bucket=str(bucket), rows=str(rows),
            help_text="Prefill dispatch+sync wall time per admission "
                      "group, labeled by prompt bucket and row count.")

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
        # Padding rows take the trash lane.
        aslots = np.full(rows, -1, np.int32)
        for i, (slot, req) in enumerate(group):
            aslots[i] = req._adapter_lane
            m = len(req.prompt_tokens) - plen
            tokens[i, :m] = req.prompt_tokens[plen:]
            positions[i, :m] = np.arange(plen, plen + m)
            slots[i] = slot
            last_pos[i] = m - 1
            temps[i] = req.temperature
            top_ks[i] = req.top_k
            top_ps[i] = req.top_p
        if pkey:
            # An admission hit refreshes the LRU: the prefix serving live
            # traffic is not the one evicted.
            self._prefix_cache_hit(pkey)
        with self._prefill_span(bucket, rows, plen, group):
            first = self._program(
                "prefill", tokens, positions, slots, last_pos, temps,
                top_ks, top_ps, pkey, n, aslots=aslots,
                **self._grammar_prefill_kwargs(group, rows))
        self.prefix_tokens_reused += plen * n
        self.prefill_dispatches += 1
        for i, (slot, req) in enumerate(group):
            self._activate_slot(slot, req, int(first[i]))

    def _p_prefill(self, tokens, positions, slots, last_pos, temps, top_ks,
                   top_ps, pkey: Optional[tuple] = None, n: int = 0,
                   gmask=None, aslots=None):
        t = self._tensor
        prefix = None
        if pkey:
            pk, pv = self._prefix_cache[pkey]
            prefix = (pk, pv, n)
        first, self.cache, _ = self._prefill(
            self.params, self.cache, t(tokens), t(positions), slots,
            t(last_pos), self.generator, t(temps), t(top_ks), t(top_ps),
            prefix=prefix, **self._operand_kwargs(gmask, aslots))
        # The first tokens must reach the host to stream: the dispatch's
        # one sync.
        return first.cpu().numpy()

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
        self.adapter_slots[slot] = req._adapter_lane
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
        _observe_request_done(req, time.monotonic())
        self._on_slot_finished(slot, req)

    def _on_slot_finished(self, slot: int, req: Request) -> None:
        """Called once per slot whose request just finished (any reason,
        deadline expiry included), after its bookkeeping is cleared and
        before the slot can be admitted again. The dense pool needs no
        cache work; the paged engine also releases the slot's pages and
        adopts its written ones into the radix tree."""
        if self._spec_index is not None:
            self._spec_index.clear(slot)
        self.adapter_slots[slot] = -1
        self._release_adapter(req)

    def _record_token(self, slot: int, tok: int) -> None:
        req = self.slot_req[slot]
        if req is None:
            raise RuntimeError(f"token recorded for empty slot {slot}")
        req.output_tokens.append(tok)
        if self._spec_index is not None:
            self._spec_index.extend(slot, tok)
        # Host-observed latency: TTFT on the first token, inter-token gaps
        # after. A decode chunk's tokens replay in one host loop, so gaps
        # inside a chunk are microseconds and its first token carries the
        # chunk's wall time, the burst cadence a streaming client sees.
        now = time.monotonic()
        reg = obs_metrics.REGISTRY
        if len(req.output_tokens) == 1:
            self.ttft_seconds.append(now - req._submitted)
            reg.observe("serve_ttft_seconds", now - req._submitted,
                        help_text="Time to first generated token "
                                  "(submit to first sampled token).")
        else:
            reg.observe("serve_inter_token_seconds",
                        now - req._last_token_t,
                        buckets=_INTER_TOKEN_BUCKETS,
                        help_text="Host-observed gap between consecutive "
                                  "generated tokens of one request.")
        req._last_token_t = now
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
                # A queued request may already hold a lane pin (acquired
                # while it waited for a slot or pages, or kept across a
                # preemption): release it, or the lane is never evictable.
                self._release_adapter(r)
                _observe_request_done(r, now)
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
                    obs_metrics.REGISTRY.inc(
                        "serve_grammar_draft_truncations_total",
                        help_text="Speculative drafts truncated at a "
                                  "grammar-illegal token before verify "
                                  "dispatch.")
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
            if nd:
                obs_metrics.REGISTRY.observe(
                    "serve_spec_accept_len", float(a),
                    buckets=_ACCEPT_LEN_BUCKETS,
                    help_text="Draft tokens accepted per slot per verify "
                              "step.")
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
        with self._step_span("verify", view, drafted=int(draft_len.sum())):
            return self._program("verify", view, tokens, positions,
                                 draft_len, temps, top_ks, top_ps,
                                 self.active, **gkw, **self._lane_kwargs())

    def _p_verify(self, view, tokens, positions, draft_len, temps, top_ks,
                  top_ps, active, gmask=None, aslots=None):
        t = self._tensor
        accept, resid, full, self.cache = self._verify_for(view)(
            self.params, self.cache, t(tokens), t(positions), t(draft_len),
            self.generator, t(temps), t(top_ks), t(top_ps), t(active),
            **self._operand_kwargs(gmask, aslots))
        # One host sync per verify step.
        return (accept.cpu().numpy(), resid.cpu().numpy(),
                full.cpu().numpy())

    def _decode_span_attrs(self) -> dict:
        """Decode and verify span attributes, built only when something
        records (the decode loop must not pay for a list per chunk)."""
        if not record_enabled():
            return {}
        return {"active": int(self.active.sum()),
                "request_ids": [self.slot_req[i].request_id
                                for i in range(self.max_slots)
                                if self.active[i]]}

    @contextlib.contextmanager
    def _step_span(self, kind: str, view: int, **args):
        """A decode chunk's or verify step's span and its dispatch-seconds
        histogram, labeled by the cache view (tokens)."""
        t0 = time.perf_counter()
        with span(kind, view=view, **args, **self._decode_span_attrs()):
            yield
        obs_metrics.REGISTRY.observe(
            f"serve_{kind}_dispatch_seconds", time.perf_counter() - t0,
            view=str(view), help_text=_DISPATCH_HELP[kind])

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
        with self._step_span("decode", view):
            toks, valid = self._program(
                "decode", view, self.last_token, positions, temps, top_ks,
                top_ps, eos_ids, remaining, self.active,
                **self._grammar_decode_kwargs(), **self._lane_kwargs())
        return self._replay_chunk(toks, valid)

    def _p_decode(self, view, last_token, positions, temps, top_ks, top_ps,
                  eos_ids, remaining, active, gmask=None, aslots=None):
        t = self._tensor
        toks, valid, self.cache = self._decode_for(view)(
            self.params, self.cache, t(last_token), t(positions),
            self.generator, t(temps), t(top_ks), t(top_ps), t(eos_ids),
            t(remaining), t(active), **self._operand_kwargs(gmask, aslots))
        # One host sync per chunk: [chunk, slots] ids and validity.
        return toks.cpu().numpy(), valid.cpu().numpy()

    def generate(self, requests: List[Request],
                 timeout_s: float = 600.0) -> List[Request]:
        for r in requests:
            self.submit(r)
        deadline = time.monotonic() + timeout_s
        while self.has_work() and time.monotonic() < deadline:
            self.step()
        return requests
