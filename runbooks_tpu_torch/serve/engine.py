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

Later slices add the shared-prefix cache, speculation, grammar, the LoRA
pool, preemption, paged KV, quantization, the mesh and the observability
planes; their knobs are absent here, and requests that need them are
refused by ``validate``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from runbooks_tpu_torch.models.config import ModelConfig
from runbooks_tpu_torch.models.transformer import (
    KVCache,
    Params,
    check_supported,
    forward,
    lm_head,
)
from runbooks_tpu_torch.ops.sampling import sample
from runbooks_tpu_torch.utils import cuda_build
from runbooks_tpu_torch.utils.hw import backend_tuning

# QoS classes, best first: admission orders the queue by class (FIFO
# within a class). The strings are the public API (the HTTP `priority`
# field and the X-Priority header).
PRIORITY_RANK = {"interactive": 0, "standard": 1, "batch": 2}


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
    # Grammar-constrained output; grammar is not ported, so validate()
    # refuses any non-None.
    response_format: Optional[dict] = None
    # Filled by the engine:
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: str = ""
    # Streaming hook, called after each generated token lands in
    # output_tokens. It runs inside the decode loop: keep it cheap.
    on_token: Optional[Callable[[int], None]] = None
    _submitted: float = 0.0   # monotonic submit time (deadline anchor)


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


def make_prefill_fn(cfg: ModelConfig, cache_len: int):
    """Batched prefill + splice + first-token sample for one admission
    group. ``pool`` is the slot cache, updated in place and returned."""

    def prefill_fn(params, pool: KVCache, tokens, positions, slots,
                   last_pos, generator, temps, top_ks, top_ps):
        # Prefill `rows` requests into fresh zero rows, then splice each
        # row into the pool. Stale data from a slot's previous occupant
        # needs no clearing: these queries attend only slots <= their own
        # position, all (re)written by this prefill or later decode.
        # Padding rows carry slots[0] as their destination; the splice
        # runs in DESCENDING row order so the real row 0 lands last.
        rows = tokens.shape[0]
        row_shape = (cfg.num_layers, rows, cache_len, cfg.num_kv_heads,
                     cfg.head_dim)
        scratch = KVCache(
            k=torch.zeros(row_shape, dtype=cfg.activation_dtype,
                          device=tokens.device),
            v=torch.zeros(row_shape, dtype=cfg.activation_dtype,
                          device=tokens.device))
        x, scratch = forward(cfg, params, tokens, positions=positions,
                             cache=scratch, return_activations=True)
        for r in range(rows - 1, -1, -1):
            pool.k[:, slots[r]] = scratch.k[:, r]
            pool.v[:, slots[r]] = scratch.v[:, r]
        # The head runs on each row's last real position only: the
        # [rows, bucket, vocab] f32 logits are never built.
        rows_idx = torch.arange(rows, device=tokens.device)
        last_logits = lm_head(cfg, params, x[rows_idx, last_pos])
        first = sample(last_logits, generator, temps, top_ks, top_ps)
        return first, pool

    return prefill_fn


def make_decode_fn(cfg: ModelConfig, chunk: int, max_len: int,
                   pad_slot: int, view: int):
    """`chunk` decode steps with per-slot liveness tracked on the device by
    exactly the host's finish rules (EOS, max_tokens budget, cache out of
    room), so the host can replay (tokens, valid) and land in the same
    slot state as chunk=1 stepping. Nothing here waits for the device."""

    def decode_fn(params, cache, tokens, positions, generator,
                  temperature, top_k, top_p, eos_ids, remaining, active):
        tok, pos, alive = tokens, positions, active
        emitted = torch.zeros_like(remaining)
        toks, valid = [], []
        for _ in range(chunk):
            p = torch.where(alive, pos, pad_slot)
            logits, cache = forward(cfg, params, tok[:, None],
                                    positions=p[:, None], cache=cache,
                                    cache_view=view)
            nxt = sample(logits[:, -1], generator, temperature, top_k,
                         top_p).to(tok.dtype)
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


class InferenceEngine:
    """Batched generation over a fixed slot pool. Thread-unsafe by design;
    drive it from one loop."""

    def __init__(self, cfg: ModelConfig, params: Params, *,
                 max_slots: int = 8, max_seq_len: Optional[int] = None,
                 seed: int = 0, prefill_budget: Optional[int] = None,
                 decode_chunk: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 queue_shares: Optional[dict] = None):
        """params live on the engine's device (CUDA, or the CPU when the
        caller put them there); every tensor the engine makes follows.

        prefill_budget: max bucket-padded prompt tokens admitted per step
        (default max_seq_len); a single over-budget request still admits
        alone. decode_chunk: decode steps per host round-trip (default 8
        on CUDA, 1 on the CPU). max_queue: bound on waiting requests;
        submit() past it raises EngineOverloaded (default
        max(16, 4 * max_slots)). queue_shares: {class: share in (0, 1]}
        bounding the queued requests of each QoS class to that share of
        max_queue (missing classes: the whole queue)."""
        check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        if decode_chunk is None:
            decode_chunk = backend_tuning(self.device)["decode_chunk"]
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        self.decode_chunk = decode_chunk
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
        self.cache = self._new_cache()
        self.deadline_expired = 0
        self.prefill_dispatches = 0
        # Host seconds inside prefill and decode dispatches, each ending in
        # its host sync; the profiler sees the same spans by these names.
        self.dispatch_seconds = {"prefill": 0.0, "decode": 0.0}
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
        self._decode_fns: dict = {}

    def _new_cache(self) -> KVCache:
        return KVCache.create(self.cfg, self.max_slots, self.max_seq_len,
                              self.device, trash_slot=True)

    def _decode_for(self, view: int):
        if view not in self._decode_fns:
            self._decode_fns[view] = make_decode_fn(
                self.cfg, self.decode_chunk, self.max_seq_len,
                self._pad_slot, view)
        return self._decode_fns[view]

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
            raise ValueError(
                "this server has grammar-constrained decoding off "
                "(grammar: off); `response_format` needs grammar: on")

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
        half-written."""
        self.cache = None
        self.cache = self._new_cache()
        self.lengths[:] = 0
        self.active[:] = False
        self.last_token[:] = 0
        self.slot_req = [None] * self.max_slots
        self.queue.clear()

    def warmup(self) -> None:
        """Build the kernels, then run one prefill per bucket at both row
        counts (1 and max_slots) and one decode chunk per cache view
        before traffic, so the first request pays for no kernel build and
        no first launch. Slot state is reset afterwards; the engine's
        sampling stream is untouched."""
        if self.device.type == "cuda":
            cuda_build.build(["flash_fwd"])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        t = self._tensor
        for bucket in self.prefill_buckets:
            for rows in sorted({1, self.max_slots}):
                positions = np.full((rows, bucket), self._pad_slot,
                                    np.int32)
                positions[:, :2] = [0, 1]
                first, self.cache = self._prefill(
                    self.params, self.cache,
                    t(np.zeros((rows, bucket), np.int32)), t(positions),
                    [0] * rows, t(np.ones(rows, np.int64)), gen,
                    t(np.zeros(rows, np.float32)),
                    t(np.zeros(rows, np.int32)),
                    t(np.ones(rows, np.float32)))
        n = self.max_slots
        idle = np.zeros(n, np.int32)
        for view in self.view_buckets:
            first, _, self.cache = self._decode_for(view)(
                self.params, self.cache, t(idle),
                t(np.full(n, self._pad_slot, np.int32)), gen,
                t(np.zeros(n, np.float32)), t(idle),
                t(np.ones(n, np.float32)), t(np.full(n, -1, np.int32)),
                t(idle), t(np.zeros(n, bool)))
        first.cpu()
        self.reset()

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any())

    def _free_slots(self, exclude=()) -> List[int]:
        return [i for i in range(self.max_slots)
                if not self.active[i] and i not in exclude]

    def _bucket_for(self, n: int) -> int:
        return bucket_for(self.prefill_buckets, n)

    def _admit(self, exclude_slots=()) -> None:
        budget = self.prefill_budget
        admitted: List[tuple] = []
        for slot in self._free_slots(exclude_slots):
            if not self.queue:
                break
            # Budget in bucket-padded tokens (what the prefill computes).
            # The first admission always goes through so an over-budget
            # prompt cannot starve.
            need = self._bucket_for(len(self.queue[0].prompt_tokens))
            if admitted and need > budget:
                break
            req = self.queue.pop(0)
            budget -= need
            admitted.append((slot, req))
        # One [rows, bucket] prefill dispatch per bucket.
        by_bucket: dict = {}
        for slot, req in admitted:
            by_bucket.setdefault(self._bucket_for(len(req.prompt_tokens)),
                                 []).append((slot, req))
        for bucket, group in by_bucket.items():
            with self._dispatch("prefill"):
                self._prefill_group(bucket, group)

    def _prefill_group(self, bucket: int, group: List[tuple]) -> None:
        """Prefill same-bucket requests as one batched forward. The row
        count is 1 (single request) or max_slots (any burst), the
        reference's two compiled shapes. Padding rows aim at group[0]'s
        slot and are overwritten by the real row 0 (descending splice)."""
        n = len(group)
        rows = 1 if n == 1 else self.max_slots
        tokens = np.zeros((rows, bucket), np.int32)
        # Real tokens at positions 0..len-1; padding scatters to the trash
        # slot of each row's scratch cache.
        positions = np.full((rows, bucket), self._pad_slot, np.int32)
        slots = [group[0][0]] * rows
        last_pos = np.zeros(rows, np.int64)
        temps = np.zeros(rows, np.float32)
        top_ks = np.zeros(rows, np.int32)
        top_ps = np.ones(rows, np.float32)
        for i, (slot, req) in enumerate(group):
            m = len(req.prompt_tokens)
            tokens[i, :m] = req.prompt_tokens
            positions[i, :m] = np.arange(m)
            slots[i] = slot
            last_pos[i] = m - 1
            temps[i] = req.temperature
            top_ks[i] = req.top_k
            top_ps[i] = req.top_p
        first, self.cache = self._prefill(
            self.params, self.cache, self._tensor(tokens),
            self._tensor(positions), slots, self._tensor(last_pos),
            self.generator, self._tensor(temps), self._tensor(top_ks),
            self._tensor(top_ps))
        self.prefill_dispatches += 1
        # The first tokens must reach the host to stream: the dispatch's
        # one sync.
        first = first.cpu().numpy()
        for i, (slot, req) in enumerate(group):
            self._activate_slot(slot, req, int(first[i]))

    def _activate_slot(self, slot: int, req: Request,
                       first_tok: int) -> None:
        """Post-prefill slot activation and the first token's recording
        (which may immediately finish a max_tokens=1 request)."""
        self.active[slot] = True
        self.lengths[slot] = len(req.prompt_tokens)
        self.slot_req[slot] = req
        self.last_token[slot] = first_tok
        self._record_token(slot, first_tok)

    def _record_token(self, slot: int, tok: int) -> None:
        req = self.slot_req[slot]
        if req is None:
            raise RuntimeError(f"token recorded for empty slot {slot}")
        req.output_tokens.append(tok)
        if len(req.output_tokens) == 1:
            self.ttft_seconds.append(time.monotonic() - req._submitted)
        if req.on_token is not None:
            req.on_token(tok)
        hit_eos = req.eos_id is not None and tok == req.eos_id
        # lengths[slot] counts tokens written to the cache; the next decode
        # writes at position lengths[slot], which must stay < max_seq_len
        # (slot max_seq_len is the trash slot).
        out_of_room = self.lengths[slot] >= self.max_seq_len
        if hit_eos or len(req.output_tokens) >= req.max_tokens \
                or out_of_room:
            req.finished = True
            req.finish_reason = "stop" if hit_eos else "length"
            self.active[slot] = False
            self.slot_req[slot] = None

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
                req.finished = True
                req.finish_reason = "deadline"
                self.active[slot] = False
                self.slot_req[slot] = None
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
        bookkeeping state as chunk=1 stepping. Returns tokens generated."""
        generated = 0
        for k in range(toks.shape[0]):
            for slot in np.nonzero(valid[k])[0]:
                if not self.active[slot]:
                    continue
                generated += 1
                self.lengths[slot] += 1
                tok = int(toks[k, slot])
                self.last_token[slot] = tok
                self._record_token(slot, tok)
        return generated

    def step(self) -> int:
        """Admit queued requests, then run one decode chunk over every
        active slot. Returns the number of tokens generated."""
        self._admit(exclude_slots=self._expire_deadlines())
        if not self.active.any():
            return 0
        with self._dispatch("decode"):
            generated = self._decode_chunk_step()
        self.steps += 1
        return generated

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
            self._tensor(self.active))
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
