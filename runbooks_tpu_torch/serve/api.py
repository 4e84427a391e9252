"""OpenAI-compatible HTTP serving on the container contract (the port of
``runbooks_tpu.serve.api``).

The surface a Server resource expects of its container: readiness at
``GET /`` on port 8080, ``/v1/completions`` and ``/v1/chat/completions``
(``"stream": true`` answers with server-sent events), ``/v1/prefix`` to
register a shared prompt prefix, and weights from the contract's model
mount. One worker thread owns the engine (the dense InferenceEngine, or
with ``kv_paging`` the PagedInferenceEngine of serve/paging.py) and makes
every device call, prefix registrations included; HTTP handler threads
(the standard library's ``ThreadingHTTPServer``) only parse, enqueue and
wait.

Run: ``python -m runbooks_tpu_torch.serve.api`` (reads
``{RBT_CONTENT_DIR}/params.json``: model, model_overrides, seed,
checkpoint, adapter, port, tokenizer and the engine knobs, speculation,
grammar, paging, the host tier, preemption and the multi-tenant adapter
pool among them), or build one with ``create_server``. With
``adapter_pool`` a body's ``"adapter"`` names the tenant's LoRA adapter
(under ``adapter_dir``, or a path) and the engine serves it from its pool;
without one, ``adapter:`` in params folds one adapter at load.
``quantize: int8|int4`` serves weight-only quantized weights and
``quantize_kv`` an int8 KV cache (on by default with quantized weights).

Telemetry (runbooks_tpu_torch/obs), as the reference serves it:
``GET /metrics`` (the Prometheus exposition, the engine's totals mirrored
at scrape time), ``POST /debug/profile?seconds=N`` (a torch.profiler
capture under ``{artifacts}/profiles/``; 409 while one runs), ``GET
/debug/memory``, ``GET /debug/programs``, ``GET
/debug/flight[?request_id=]``, ``POST /debug/incident`` and ``GET
/debug/incidents[?name=]``; a failed engine step captures an incident
bundle.

Sharded serving: ``mesh_tensor: N`` (and, for an MoE model,
``mesh_expert: E``) serves one replica over E x N processes, one per GPU
(rank r on ``cuda:r``, NCCL). ``main`` is rank 0: it starts the other
ranks itself (``torch.multiprocessing``, spawn), and alone runs HTTP,
the worker, the scheduler and the page tables; each follower replays
rank 0's program calls on its shard (serve/engine.py). SIGTERM drains,
stops every follower and exits 0; a follower that dies ends rank 0 with
a non-zero code. Other mesh axes, a multi-host mesh, and quantization,
the adapter pool, the host tier, preemption and collective_matmul "ring"
under a mesh of more than one rank are refused by name;
collective_matmul "auto" resolves to the port's one all-reduce after each
sharded sublayer, which ``main`` logs at startup.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import queue
import shutil
import signal
import threading
import time
import traceback
import uuid
from concurrent.futures import Future
from concurrent.futures import wait as wait_futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple, Union
from urllib.parse import parse_qs, urlsplit

import torch

from runbooks_tpu_torch.models.config import ModelConfig, get_config
from runbooks_tpu_torch.models.transformer import check_supported, init_params
from runbooks_tpu_torch.obs import device as obs_device
from runbooks_tpu_torch.obs import flight as obs_flight
from runbooks_tpu_torch.obs import incident as obs_incident
from runbooks_tpu_torch.obs import metrics as obs_metrics
from runbooks_tpu_torch.obs import profile as obs_profile
from runbooks_tpu_torch.obs.trace import request_scope
from runbooks_tpu_torch.ops.flash_attention import flash_attention
from runbooks_tpu_torch.parallel import distributed
from runbooks_tpu_torch.parallel.mesh import (
    MeshConfig,
    check_mesh_model,
    check_serving_mesh,
    make_mesh,
    serving_axes,
)
from runbooks_tpu_torch.parallel.sharding import (
    serve_plan,
    shard_leaf,
    shard_params,
)
from runbooks_tpu_torch.ops.quantization import (
    quantize_params,
    resolve_quantize_mode,
    tree_quantize_mode,
)
from runbooks_tpu_torch.serve.engine import (
    COLLECTIVE_MATMUL_AUTO,
    PRIORITY_RANK,
    EngineDraining,
    EngineOverloaded,
    EngineStepFailed,
    InferenceEngine,
    Request,
)
from runbooks_tpu_torch.serve.paging import PagedInferenceEngine
from runbooks_tpu_torch.serve.lora_pool import load_merge_adapter
from runbooks_tpu_torch.train.checkpoint import restore_params
from runbooks_tpu_torch.train.data import load_tokenizer
from runbooks_tpu_torch.utils import contract, cuda_build
from runbooks_tpu_torch.utils.hw import device_peaks, resolve_device
from runbooks_tpu_torch.utils.tree import tree_map

# Top-level body fields /v1/completions understands (the chat endpoint
# adds messages and the internal _chat marker before delegating).
# Anything else 400s by name: a typo'd constraint field must never
# silently serve unconstrained text.
_KNOWN_BODY_FIELDS = frozenset({
    "prompt", "messages", "max_tokens", "temperature", "top_p", "top_k",
    "timeout", "adapter", "priority", "stream", "response_format",
    "model", "user", "_chat",
})
# A generation that has not finished after this long answers 504.
_GENERATION_TIMEOUT_S = 600
_MAX_BODY_BYTES = 1 << 20

# One reply: (status, JSON payload, extra headers).
Reply = Tuple[int, dict, Dict[str, str]]


def _encode(tok, text: str) -> list:
    """One tokenize path for completions and prefix registration: they
    must agree exactly, or registered prefixes never match prompts."""
    ids = tok.encode(text, add_bos=True, add_eos=False) \
        if hasattr(tok, "bos_id") else tok.encode(text)
    return list(ids)


def _eos_id(tok) -> Optional[int]:
    """Tokenizer EOS id (ByteTokenizer's eos_id, HF's eos_token_id); an
    EOS id of 0 is legitimate and must not read as missing."""
    for attr in ("eos_id", "eos_token_id"):
        val = getattr(tok, attr, None)
        if val is not None:
            return int(val)
    return None


def _param_any(params: dict, *keys: str, default=None):
    """First present spelling of a params key (snake_case params.json,
    camelCase spec style, the PARAM_* environment's lowercase)."""
    for k in keys:
        if params.get(k) is not None:
            return params[k]
    return default


def _param_on(value) -> bool:
    """A params switch: bools as they are; the strings "0", "off",
    "false", "none" and "" are off."""
    return str(value).lower() not in ("0", "off", "false", "none", "")


# ---------------------------------------------------------------------------
# Model loading
# ---------------------------------------------------------------------------

def load_model(params: dict,
               device: Optional[Union[str, torch.device]] = None,
               shard: Optional[Tuple[int, ...]] = None
               ) -> Tuple[ModelConfig, Any]:
    """(cfg, model params) from a params.json-style dict: a named config
    plus ``model_overrides``; the params of the newest intact checkpoint
    under ``{checkpoint or model mount}/checkpoints``, else (nothing there)
    a random init seeded by ``seed``; then ``adapter: <path>`` folded in.
    With ``adapter_pool`` set the base is returned as it is (the pooled
    engine serves the adapters per request); setting both raises. A
    checkpoint that is present but unreadable raises. Runs on CUDA unless
    ``device`` names another; raises when no device is named and no GPU
    exists.

    ``quantize`` ("none"|"int8"|"int4": params, else the config's field)
    selects weight-only quantization: a checkpoint the loader packed
    restores packed; anything else is quantized here, after the adapter
    fold, one stacked weight at a time on the device. A packed checkpoint
    at another mode than the one asked for serves its stored mode and
    says so. ``quantize_kv`` in params sets the config's field, which the
    engines read (default: on with quantized weights).

    ``shard`` = (tensor, rank) or (tensor, rank, expert): only rank
    ``rank``'s shard of the serving plan over ``expert`` x ``tensor``
    ranks (parallel/sharding.serve_plan; rank r at expert index r //
    tensor, tensor index r % tensor: its heads, MLP columns and
    vocabulary rows by the tensor index, an MoE model's experts by the
    expert index) is materialised: a checkpoint is cut while it is mapped, a
    random init cuts each leaf as it is drawn (the same draws as the full
    tree's), an adapter's pairs are cut to the shard's columns before the
    fold. The full tree is never held."""
    dev = resolve_device(device)
    adapter = params.get("adapter")
    pool = int(_param_any(params, "adapter_pool", "adapterPool",
                          "adapterpool", default=0) or 0)
    if adapter and pool:
        raise RuntimeError(
            "params set both `adapter` and `adapter_pool`: the load-time "
            "fold and the pooled engine are mutually exclusive serving "
            "modes — drop `adapter` (clients pass it per request) or the "
            "pool")
    cfg = get_config(params.get("model", "debug"),
                     **params.get("model_overrides", {}))
    quantize = resolve_quantize_mode(params, cfg)
    overrides = {"quantize": quantize}
    quantize_kv = _param_any(params, "quantize_kv", "quantizeKv",
                             "quantizekv")
    if quantize_kv is not None:
        overrides["quantize_kv"] = _param_on(quantize_kv)
    if _param_any(params, "collective_matmul", "collectiveMatmul",
                  "collectivematmul") is not None:
        # The engine resolves it under a mesh (COLLECTIVE_MATMUL_AUTO).
        cm = collective_matmul_param(params)
        if cm not in COLLECTIVE_MATMUL_MODES:
            raise ValueError(f"unknown collective_matmul {cm!r}; expected "
                             f"{'|'.join(COLLECTIVE_MATMUL_MODES)}")
        overrides["collective_matmul"] = cm
    cfg = dataclasses.replace(cfg, **overrides)
    check_supported(cfg)
    cut = None
    if shard is not None:
        tensor, rank, expert = (*shard, 1)[:3]
        check_mesh_model(cfg, MeshConfig(expert=expert, fsdp=1,
                                         tensor=tensor), serving=True)
        plan = serve_plan(cfg, tensor, expert)
        cut = functools.partial(shard_leaf, plan=plan, rank=rank)
    ckpt_dir = params.get("checkpoint") or contract.model_dir()

    def fit_and_cut(tree):
        # On the mapped tree: nothing is read for the check, and a shard
        # reads only its columns.
        _check_params_fit(cfg, tree, ckpt_dir)
        return tree if shard is None else shard_params(tree, plan, rank)

    restored = restore_params(ckpt_dir, dev, fit_and_cut)
    if restored is not None:
        model_params, step = restored
        print(f"serve: restored params of step {step} from {ckpt_dir}",
              flush=True)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(params.get("seed", 0)))
        model_params = init_params(cfg, gen, dev, cut)
    if adapter:
        # The fold goes in before quantization, so the quantizer sees the
        # merged weights; packed weights have no headroom to fold into.
        if tree_quantize_mode(model_params) != "none":
            raise RuntimeError(
                "cannot fold adapter into a pre-quantized checkpoint "
                "(packed int8/int4 weights have no headroom); serve it "
                "with adapter_pool >= 1 instead")
        model_params = load_merge_adapter(str(adapter), cfg, model_params,
                                          cut)
    stored = tree_quantize_mode(model_params)
    if stored == "none" and quantize != "none":
        model_params = quantize_params(model_params, quantize)
    elif stored != quantize:
        # A packed checkpoint cannot be re-quantized to another tier
        # (int4 -> int8 has nothing to recover): serve what is stored,
        # and say so.
        print(f"serve: checkpoint is quantized {stored} but params "
              f"requested quantize={quantize}; serving the stored "
              f"{stored} weights", flush=True)
        cfg = dataclasses.replace(cfg, quantize=stored)
    return cfg, model_params


def _check_params_fit(cfg: ModelConfig, params: Any, where: str) -> None:
    """Raise unless ``params`` has the layout and shapes of ``cfg``'s
    (say, a LoRA run's checkpoint holds an adapter tree, not a model)."""
    want = init_params(cfg, None, torch.device("meta"))

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(shapes(v, f"{prefix}{k}."))
            return out
        return {prefix[:-1]: tuple(getattr(tree, "shape", ()))}

    got, need = shapes(params), shapes(want)
    if got != need:
        diff = sorted(set(got.items()) ^ set(need.items()))[:4]
        raise RuntimeError(
            f"checkpoint {where} does not hold {cfg.name!r} params "
            f"(differing leaves: {diff}); a LoRA run's checkpoint is an "
            "adapter: serve it with `adapter:` over its base")


# ---------------------------------------------------------------------------
# The engine worker
# ---------------------------------------------------------------------------

class WorkerStopped(RuntimeError):
    """The engine worker stopped before it ran this job. Maps to HTTP
    503; a failure of the job itself is an engine failure (500)."""


class EngineWorker:
    """The one thread that owns the engine: it runs warmup, admits
    requests, registers prefixes, steps the decode loop and resolves the
    futures of finished requests. HTTP threads only call submit_many,
    register_prefix, drain and stop."""

    def __init__(self, engine: InferenceEngine, warmup: bool = False):
        self.engine = engine
        self._pending: List[Tuple[Request, Future]] = []   # guarded-by: _lock
        self._inflight: List[Tuple[Request, Future]] = []  # guarded-by: _lock
        self._prefix_jobs: List[Tuple[list, Future]] = []  # guarded-by: _lock
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._draining = False
        self._warmup = warmup
        self.warmup_error: Optional[BaseException] = None
        self.ready = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="engine-worker")
        self._thread.start()

    def submit(self, req: Request) -> Future:
        return self.submit_many([req])[0]

    def submit_many(self, reqs: List[Request]) -> List[Future]:
        """Admit a batch atomically: every request is accepted or none is
        (a multi-prompt body must not leave some prompts decoding after a
        429). Validation runs first (ValueError -> 400); then a draining
        server raises EngineDraining (503) and a full queue
        EngineOverloaded (429)."""
        if self._draining:
            raise EngineDraining(
                "server is draining (shutdown in progress); "
                "not accepting new requests")
        for req in reqs:
            self.engine.validate(req)
        with self._lock:
            backlog = len(self.engine.queue) + len(self._pending)
            if backlog + len(reqs) > self.engine.max_queue:
                raise EngineOverloaded(
                    f"admission queue full ({backlog} waiting, bound "
                    f"{self.engine.max_queue}); retry later")
            futs = []
            for req in reqs:
                fut: Future = Future()
                self._pending.append((req, fut))
                futs.append(fut)
        self._wake.set()
        return futs

    def register_prefix(self, tokens: list) -> Future:
        """Queue a shared prompt prefix for registration on the worker
        thread (the engine is single-threaded: registering from a handler
        thread would race the step loop). Resolves to the cached
        length."""
        fut: Future = Future()
        with self._lock:
            if self._stop:
                # stop() has failed the queued jobs, or is about to: a job
                # queued now would never run.
                fut.set_exception(WorkerStopped("engine worker stopped"))
                return fut
            self._prefix_jobs.append((tokens, fut))
        self._wake.set()
        return fut

    def _run(self) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        with torch.no_grad():
            if self._warmup:
                try:
                    self.engine.warmup()
                except BaseException as exc:  # noqa: BLE001 - re-raised
                    # by create_server on the caller's thread
                    self.warmup_error = exc
                    self.ready.set()
                    return
            self.ready.set()
            while not self._stop:
                try:
                    self._tick()
                except Exception as exc:  # noqa: BLE001 - engine blew up
                    self._contain(exc)

    def _tick(self) -> None:
        with self._lock:
            prefix_jobs, self._prefix_jobs = self._prefix_jobs, []
            for req, fut in self._pending:
                try:
                    self.engine.submit(req)
                except (EngineOverloaded, ValueError) as exc:
                    # A race between the admission check on the HTTP
                    # thread and this enqueue: reject this request only.
                    fut.set_exception(exc)
                    continue
                self._inflight.append((req, fut))
            self._pending.clear()
        for i, (tokens, fut) in enumerate(prefix_jobs):
            # The dense prefix build writes only tensors of its own, so a
            # failed registration fails its job alone. The paged one steps
            # the engine: its EngineStepFailed poisons the engine like a
            # failed step, so the jobs not reached fail with it and the
            # error goes to _contain (doom every request, reset).
            try:
                fut.set_result(self.engine.register_prefix(tokens))
            except EngineStepFailed as exc:
                for _, f in prefix_jobs[i:]:
                    if not f.done():
                        f.set_exception(exc)
                raise
            except Exception as exc:  # noqa: BLE001 - the job's own error
                fut.set_exception(exc)
        if self.engine.has_work():
            self.engine.step()
        else:
            # A tensor-parallel leader tells idle followers it is alive.
            self.engine.heartbeat()
            self._wake.wait(timeout=0.05)
            self._wake.clear()
        # A paged registration steps the engine too, so requests may
        # finish on either branch.
        with self._lock:
            done = [(r, f) for r, f in self._inflight if r.finished]
            if done:
                self._inflight = [(r, f) for r, f in self._inflight
                                  if not r.finished]
        for req, fut in done:
            if req.auto_prefix and req._slot >= 0 and req.adapter is None:
                # Multi-turn chat: lift the prompt's K/V out of the slot
                # before the next admission (at the next step) can reuse
                # it. Adapter requests never seed the cache: their K/V
                # came through the adapter's deltas.
                try:
                    self.engine.register_prefix_from_slot(
                        req._slot, req.prompt_tokens)
                except Exception as exc:  # noqa: BLE001 - best effort
                    print(f"serve: auto-prefix registration failed: "
                          f"{exc!r}", flush=True)
            fut.set_result(req)

    def _contain(self, exc: Exception) -> None:
        """Fail every waiting request and queued prefix job with the error
        (a hanging future would wedge its HTTP handler), then reset the
        engine so later requests get a clean one."""
        print("serve: engine step failed; failing every waiting request "
              "and resetting the engine:\n" + traceback.format_exc(),
              flush=True)
        with self._lock:
            doomed = self._inflight + self._pending
            jobs = self._prefix_jobs
            self._inflight, self._pending, self._prefix_jobs = [], [], []
        now = time.monotonic()
        for req, fut in doomed:
            if not fut.done():
                fut.set_exception(exc)
            # Error tail sampling: a doomed request's flight timeline is
            # the trace a postmortem needs.
            obs_flight.tail_sample(
                req.request_id,
                now - req._submitted if req._submitted else 0.0,
                req.finish_reason or "error", error=True)
        for _, fut in jobs:
            if not fut.done():
                fut.set_exception(exc)
        # The incident bundle (debounced; capture never raises) before
        # reset() reallocates the cache, so its memory census shows the
        # failed state.
        try:
            groups = self.engine.memory_groups()
        except Exception:  # noqa: BLE001 - torn engine state
            groups = None
        obs_incident.capture(
            "engine_crash", component="serve", memory_groups=groups,
            extra={"error": repr(exc),
                   "doomed_requests": [r.request_id for r, _ in doomed],
                   "doomed_prefix_jobs": len(jobs)})
        self.engine.reset()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful drain: stop admitting (submit raises EngineDraining)
        and wait up to timeout_s for every queued and in-flight request to
        finish. Returns True when fully drained; call stop() afterwards."""
        self._draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                busy = bool(self._pending or self._inflight)
            if not busy and not self.engine.has_work():
                return True
            time.sleep(0.02)
        return False

    def stop(self) -> None:
        """Stop the thread; requests it never finished fail, so no HTTP
        handler waits on them."""
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=30)
        self.engine.release_steady()
        with self._lock:
            doomed = self._inflight + self._pending + self._prefix_jobs
            self._inflight, self._pending, self._prefix_jobs = [], [], []
        for _, fut in doomed:
            if not fut.done():
                fut.set_exception(WorkerStopped("engine worker stopped"))


# ---------------------------------------------------------------------------
# The HTTP API
# ---------------------------------------------------------------------------

def _error(status: int, message: str, **extra) -> Reply:
    return status, {"error": {"message": message, **extra}}, {}


class _Api:
    """The routes' logic, apart from the socket handling: parse a body
    into engine requests, submit them through the worker, and shape the
    reference's JSON and SSE answers; count what the front end answered,
    and answer the telemetry routes."""

    def __init__(self, worker: EngineWorker, tokenizer, model_name: str,
                 request_timeout_s: Optional[float],
                 auto_prefix_chat: bool = False):
        self.worker = worker
        self.tokenizer = tokenizer
        self.eos = _eos_id(tokenizer)
        self.model_name = model_name
        self.request_timeout_s = request_timeout_s
        self.auto_prefix_chat = auto_prefix_chat
        self.started = time.time()
        # The front end's totals, mirrored into /metrics at scrape time.
        self._count_lock = threading.Lock()
        self.counts = {"requests_total": 0,           # guarded-by: _count_lock
                       "requests_failed_total": 0,
                       "requests_rejected_total": 0,
                       "tokens_total": 0}

    def count(self, key: str, n: int = 1) -> None:
        with self._count_lock:
            self.counts[key] += n

    def readiness(self) -> Reply:
        return 200, {"status": "ok", "model": self.model_name,
                     "uptime_s": round(time.time() - self.started, 1)}, {}

    def reject(self, exc: EngineOverloaded, n: int = 1) -> Reply:
        """Backpressure: draining = 503 (terminal for this process),
        overloaded = 429 with a load-derived Retry-After."""
        self.count("requests_rejected_total", n)
        if isinstance(exc, EngineDraining):
            return 503, {"error": {"message": str(exc),
                                   "type": "draining"}}, {"Retry-After": "5"}
        return 429, {"error": {"message": str(exc), "type": "overloaded"}}, \
            {"Retry-After": str(self.worker.engine.retry_after_hint())}

    def parse(self, body: dict, default_priority: Optional[str] = None
              ) -> Tuple[Optional[List[Request]], Optional[Reply]]:
        """body -> (requests, None) or (None, a 400 reply). The body field
        `priority` beats the X-Priority header beats "standard"."""
        unknown = sorted(set(body) - _KNOWN_BODY_FIELDS)
        if unknown:
            return None, _error(400, "unknown body field(s): "
                                + ", ".join(unknown), type="unknown_field",
                                fields=unknown)
        prompt = body.get("prompt")
        if prompt is None:
            return None, _error(400, "missing required field: prompt")
        prompts = prompt if isinstance(prompt, list) else [prompt]
        if not prompts or not all(isinstance(p, str) for p in prompts):
            return None, _error(400, "prompt must be a string or a "
                                     "non-empty list of strings")
        try:
            max_tokens = int(body.get("max_tokens", 16))
            temperature = float(body.get("temperature", 1.0))
            top_p = float(body.get("top_p", 1.0))
            top_k = int(body.get("top_k", 0))
            deadline = (float(body["timeout"]) if body.get("timeout")
                        is not None else self.request_timeout_s)
        except (TypeError, ValueError):
            return None, _error(400, "malformed sampling parameters")
        if max_tokens < 1:
            return None, _error(400, "max_tokens must be >= 1")
        if deadline is not None and deadline <= 0:
            return None, _error(400, "timeout must be > 0 seconds")
        adapter = body.get("adapter")
        if adapter is not None and not isinstance(adapter, str):
            return None, _error(400, "adapter must be a string")
        priority = body.get("priority")
        if priority is None:
            priority = default_priority or "standard"
        if (not isinstance(priority, str)
                or priority.lower() not in PRIORITY_RANK):
            return None, _error(400, "priority must be one of "
                                     "interactive, standard, batch")
        response_format = body.get("response_format")
        if response_format is not None and not isinstance(response_format,
                                                          dict):
            return None, _error(400, "response_format must be an object")
        return [Request(
            prompt_tokens=_encode(self.tokenizer, p), max_tokens=max_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_id=self.eos, deadline_s=deadline, adapter=adapter,
            priority=priority.lower(), response_format=response_format)
            for p in prompts], None

    def register_prefix(self, body: dict) -> Reply:
        """Register a shared prompt prefix (a deployment's chat system
        prompt) so that later requests starting with it prefill only their
        suffix. Body: {"prompt": "..."} (tokenized like /v1/completions)
        or {"tokens": [...]}. Answers {"cached_prefix_len": n} (0: too
        short to cache)."""
        tokens = body.get("tokens")
        if tokens is None:
            prompt = body.get("prompt")
            if not isinstance(prompt, str):
                return _error(400, "provide prompt (string) or tokens "
                                   "(list of ints)")
            tokens = _encode(self.tokenizer, prompt)
        if not (isinstance(tokens, list)
                and all(isinstance(t, int) for t in tokens)):
            return _error(400, "tokens must be a list of ints")
        vocab = self.worker.engine.cfg.vocab_size
        bad = [t for t in tokens if not 0 <= t < vocab]
        if bad:
            # An id past the embedding would fault the device.
            return _error(400, f"token ids {bad[:4]} outside the "
                               f"vocabulary [0, {vocab})")
        fut = self.worker.register_prefix(tokens)
        try:
            plen = fut.result(timeout=_GENERATION_TIMEOUT_S)
        except TimeoutError:
            return _error(504, "prefix registration timed out")
        except WorkerStopped as exc:
            return _error(503, str(exc))
        except Exception as exc:  # noqa: BLE001 - answered, not raised
            return _error(500, f"prefix registration failed: {exc}")
        return 200, {"cached_prefix_len": plen}, {}

    def submit(self, reqs: List[Request]
               ) -> Tuple[Optional[List[Future]], Optional[Reply]]:
        self.count("requests_total", len(reqs))
        try:
            return self.worker.submit_many(reqs), None
        except EngineOverloaded as exc:    # draining (503) / full (429)
            return None, self.reject(exc, len(reqs))
        except ValueError as exc:          # e.g. prompt past the window
            self.count("requests_failed_total", len(reqs))
            return None, _error(400, str(exc))

    def complete(self, reqs: List[Request]) -> Reply:
        """Run a non-streamed completion to its JSON reply."""
        futs, err = self.submit(reqs)
        if err is not None:
            return err
        _, not_done = wait_futures(futs, timeout=_GENERATION_TIMEOUT_S)
        if not_done:
            self.count("requests_failed_total", len(reqs))
            return _error(504, "generation timed out")
        for fut in futs:
            exc = fut.exception()
            if isinstance(exc, EngineOverloaded):
                return self.reject(exc, len(reqs))
            if exc is not None:
                self.count("requests_failed_total", len(reqs))
                if isinstance(exc, ValueError):
                    return _error(400, str(exc))
                return _error(500, f"engine failure: {exc}")
        choices = []
        prompt_tokens = completion_tokens = 0
        for i, done in enumerate(f.result() for f in futs):
            choices.append({"index": i,
                            "text": self.tokenizer.decode(
                                self._text_ids(done.output_tokens)),
                            "finish_reason": done.finish_reason,
                            "logprobs": None})
            prompt_tokens += len(reqs[i].prompt_tokens)
            completion_tokens += len(done.output_tokens)
        self.count("tokens_total", completion_tokens)
        return 200, {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": choices,
            "usage": {"prompt_tokens": prompt_tokens,
                      "completion_tokens": completion_tokens,
                      "total_tokens": prompt_tokens + completion_tokens},
        }, {}

    def _text_ids(self, ids: List[int]) -> List[int]:
        """Output ids without a final EOS: clients get text, not the stop
        token's bytes."""
        if self.eos is not None and ids and ids[-1] == self.eos:
            return ids[:-1]
        return ids

    def stream(self, reqs: List[Request], chat: bool,
               write) -> Optional[Reply]:
        """SSE (OpenAI `stream: true`): one chunk per text delta, a finish
        chunk per choice, then `data: [DONE]`. Returns a reply when the
        request is refused before the stream starts, else writes the whole
        stream through ``write(bytes)`` (the first call sends the 200
        headers) and returns None.

        The engine's on_token hook runs on the worker thread and only puts
        the choice's index on a queue this thread drains. Each delta is the
        decoded text of all the choice's ids so far past what was already
        sent, less a tail that later ids may still change (``_settled``):
        the streamed deltas add up to the unstreamed text. (The reference
        decodes each chunk of ids alone, which drops the leading space a
        sentencepiece decoder strips from every chunk.)"""
        events: queue.Queue = queue.Queue()
        for i, r in enumerate(reqs):
            r.on_token = lambda _t, i=i: events.put(i)
        futs, err = self.submit(reqs)
        if err is not None:
            return err
        for i, f in enumerate(futs):
            f.add_done_callback(lambda fut, i=i: events.put(("done", i, fut)))
        rid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if chat
               else f"cmpl-{uuid.uuid4().hex[:24]}")
        created = int(time.time())
        role_sent = [False] * len(reqs)
        sent = [""] * len(reqs)   # the text streamed so far, per choice

        def chunk(i, text=None, finish=None):
            if chat:
                delta = {} if text is None else {"content": text}
                if not role_sent[i]:
                    role_sent[i] = True
                    delta = {"role": "assistant", **delta}
                choice = {"index": i, "delta": delta,
                          "finish_reason": finish}
            else:
                choice = {"index": i, "text": text or "",
                          "finish_reason": finish}
            payload = {"id": rid, "created": created,
                       "model": self.model_name,
                       "object": ("chat.completion.chunk" if chat
                                  else "text_completion"),
                       "choices": [choice]}
            return f"data: {json.dumps(payload)}\n\n".encode()

        def next_delta(i, flush=False):
            ids = self._text_ids(list(reqs[i].output_tokens))
            text = (self.tokenizer.decode(ids) if flush
                    else _settled(self.tokenizer, ids))
            if len(text) <= len(sent[i]) or not text.startswith(sent[i]):
                return None
            delta = text[len(sent[i]):]
            sent[i] = text
            return delta

        remaining = len(reqs)
        try:
            write(None)   # the 200 and its headers
            while remaining:
                ev = events.get(timeout=_GENERATION_TIMEOUT_S)
                if isinstance(ev, tuple):   # ("done", i, future)
                    _, i, fut = ev
                    remaining -= 1
                    exc = fut.exception()
                    if exc is not None:
                        # The status is already 200: signal in-band.
                        self.count("requests_failed_total")
                        write(b"data: " + json.dumps({"error": {
                            "message": str(exc), "index": i}}).encode()
                            + b"\n\n")
                        continue
                    delta = next_delta(i, flush=True)
                    if delta is not None:
                        write(chunk(i, text=delta))
                    self.count("tokens_total", len(reqs[i].output_tokens))
                    write(chunk(i, finish=reqs[i].finish_reason or "stop"))
                    continue
                delta = next_delta(ev)
                if delta is not None:
                    write(chunk(ev, text=delta))
            write(b"data: [DONE]\n\n")
        except (queue.Empty, OSError):
            # Generation stalled or the client went away: stop writing;
            # the engine finishes the requests on its own.
            self.count("requests_failed_total", remaining)
        return None

    # -- telemetry (the reference's handlers, on the stdlib server) --

    def metrics(self) -> str:
        """The Prometheus exposition: the front end's and the engine's
        totals set as absolute values at scrape time, beside the latency
        histograms the engine records as it serves."""
        reg = obs_metrics.REGISTRY
        eng = self.worker.engine
        with self._count_lock:
            counts = dict(self.counts)
        reg.set_counter("serve_requests_total", counts["requests_total"],
                        help_text="Requests accepted by the HTTP API.")
        reg.set_counter("serve_requests_failed_total",
                        counts["requests_failed_total"],
                        help_text="Requests that errored or timed out.")
        reg.set_counter("serve_tokens_generated_total",
                        counts["tokens_total"],
                        help_text="Completion tokens returned to clients.")
        reg.set_counter("serve_decode_steps_total", eng.steps,
                        help_text="Engine decode chunks executed.")
        reg.set_gauge("serve_active_slots", int(eng.active.sum()),
                      help_text="Slots currently decoding.")
        reg.set_gauge("serve_queue_depth", len(eng.queue),
                      help_text="Requests waiting for a slot.")
        reg.set_gauge("serve_queue_limit", eng.max_queue,
                      help_text="Admission queue bound (429 past this).")
        reg.set_counter("serve_requests_rejected_total",
                        counts["requests_rejected_total"],
                        help_text="Requests shed with 429/503.")
        reg.set_counter("serve_preemptions_total", eng.preemptions,
                        help_text="Active slots preempted for a higher-"
                                  "priority queue head (pages swapped to "
                                  "the radix tree / host tier).")
        reg.set_counter("serve_preempted_resumed_total",
                        eng.preempted_resumed,
                        help_text="Preempted requests re-admitted and "
                                  "resumed from their cached history.")
        reg.set_counter("serve_deadline_expired_total", eng.deadline_expired,
                        help_text="Requests finished by wall-clock "
                                  "deadline.")
        reg.set_gauge("serve_draining", int(self.worker._draining),
                      help_text="1 while the server drains for shutdown.")
        reg.set_counter("serve_prefix_tokens_reused_total",
                        eng.prefix_tokens_reused,
                        help_text="Prompt tokens served from the shared-"
                                  "prefix KV cache instead of prefill.")
        occ = eng.kv_occupancy()
        reg.set_gauge("serve_slots_total", occ["slots_total"],
                      help_text="Engine slot-pool size (max concurrent "
                                "decodes).")
        reg.set_gauge("serve_kv_cache_tokens", occ["kv_tokens"],
                      help_text="Tokens currently held in active KV "
                                "slots.")
        reg.set_gauge("serve_kv_cache_capacity_tokens",
                      occ["kv_capacity_tokens"],
                      help_text="Dense KV reservation: max_slots x "
                                "max_seq_len.")
        reg.set_gauge("serve_kv_occupancy_ratio",
                      round(occ["occupancy_ratio"], 6),
                      help_text="Cached tokens / dense KV reservation "
                                "(the paged-KV headroom signal).")
        reg.set_gauge("serve_kv_pool_bytes", occ["kv_pool_bytes"],
                      help_text="KV pool HBM bytes, aggregate across "
                                "the serving mesh (logical size).")
        reg.set_gauge("serve_kv_pool_bytes_per_device",
                      occ["kv_pool_bytes_per_device"],
                      help_text="KV pool HBM bytes each device holds "
                                "(its shard under the serving mesh; "
                                "equals the aggregate unsharded).")
        reg.set_counter("serve_prefix_lookups_total", eng.prefix_lookups,
                        help_text="Admissions that checked the shared-"
                                  "prefix cache.")
        reg.set_counter("serve_prefix_hits_total", eng.prefix_hits,
                        help_text="Admissions whose prompt matched a "
                                  "registered prefix.")
        if eng.speculative != "off":
            reg.set_counter("serve_spec_drafted_total", eng.spec_drafted,
                            help_text="Draft tokens proposed by the "
                                      "prompt-lookup drafter.")
            reg.set_counter("serve_spec_accepted_total",
                            eng.spec_accepted,
                            help_text="Draft tokens verified-accepted "
                                      "by the batched verify forward.")
        if eng.grammar != "off":
            gs = eng.grammar_stats()
            reg.set_counter("serve_grammar_requests_total",
                            gs["requests_total"],
                            help_text="Requests admitted with a "
                                      "response_format grammar "
                                      "constraint.")
            reg.set_counter("serve_grammar_cache_hits_total", gs["hits"],
                            help_text="Grammar compiles served from the "
                                      "token-DFA LRU cache.")
            reg.set_counter("serve_grammar_cache_misses_total",
                            gs["misses"],
                            help_text="Grammar compiles that built a "
                                      "fresh token DFA (host-side).")
            reg.set_counter("serve_grammar_draft_truncations_total",
                            gs["draft_truncations_total"],
                            help_text="Speculative drafts cut at the "
                                      "first grammar-illegal token "
                                      "before verify dispatch.")
        adapters = eng.adapter_stats()
        if adapters is not None:
            reg.set_counter("serve_adapter_loads_total", adapters["loads"],
                            help_text="Adapters paged into the HBM pool "
                                      "from artifact storage.")
            reg.set_counter("serve_adapter_evictions_total",
                            adapters["evictions"],
                            help_text="Resident adapters displaced from "
                                      "their pool lane (LRU, unpinned "
                                      "lanes only).")
            reg.set_counter("serve_adapter_hits_total", adapters["hits"],
                            help_text="Adapter acquisitions served from "
                                      "residency (no artifact read).")
            reg.set_gauge("serve_adapters_resident",
                          len(adapters["resident"]),
                          help_text="Adapters currently resident in the "
                                    "HBM pool.")
            for name, count in adapters["requests"].items():
                reg.set_counter(
                    "serve_adapter_requests_total", count, adapter=name,
                    help_text="Requests accepted per adapter name "
                              "(base-model requests are not counted).")
        if occ.get("paged"):
            reg.set_gauge("serve_kv_pages_free", occ["pages_free"],
                          help_text="Allocatable KV pages currently on "
                                    "the free list.")
            reg.set_gauge("serve_kv_pages_used", occ["pages_used"],
                          help_text="KV pages held by live slots or the "
                                    "radix prefix tree.")
            reg.set_gauge("serve_kv_pages_shared", occ["pages_shared"],
                          help_text="KV pages owned by the radix prefix "
                                    "tree (shareable across requests).")
            reg.set_counter("serve_prefix_pages_reused_total",
                            occ["pages_reused_total"],
                            help_text="Physical KV pages mapped from the "
                                      "radix tree into admissions instead "
                                      "of being re-prefilled (counted per "
                                      "page, not per admission).")
            if occ.get("host_pages_total"):
                reg.set_gauge("serve_kv_host_pages_used",
                              occ["host_pages_used"],
                              help_text="Host-tier page slots holding "
                                        "swapped-out KV pages.")
                reg.set_gauge("serve_kv_host_pages_free",
                              occ["host_pages_free"],
                              help_text="Host-tier page slots on the "
                                        "free list.")
                reg.set_counter("serve_kv_swap_out_pages_total",
                                occ["swap_out_pages_total"],
                                help_text="KV pages copied HBM -> host "
                                          "at radix eviction instead of "
                                          "being dropped.")
                reg.set_counter("serve_kv_swap_in_pages_total",
                                occ["swap_in_pages_total"],
                                help_text="KV pages copied host -> HBM "
                                          "at admission (radix match on "
                                          "the host tier).")
                reg.set_counter("serve_kv_swap_dropped_pages_total",
                                occ["swap_dropped_pages_total"],
                                help_text="Evicted pages dropped because "
                                          "the host tier was full or the "
                                          "copy failed (recompute on "
                                          "return).")
        obs_device.set_memory_gauges(reg)
        obs_device.PROGRAMS.set_gauges(reg, component="serve")
        reg.set_gauge("flight_ring_events",
                      obs_flight.RING.stats()["events"],
                      help_text="Events currently held in the in-memory "
                                "flight-recorder ring.")
        inc_age = obs_incident.MANAGER.last_age()
        if inc_age is not None:
            reg.set_gauge("serve_incident_age_seconds", round(inc_age, 1),
                          help_text="Seconds since this process captured "
                                    "its last incident bundle.")
        return reg.render()

    def profile(self, query: dict, body: Optional[dict]) -> Reply:
        """A timed profiler capture of N seconds (query ``seconds``, else
        the body's, default 3) into {artifacts}/profiles/<stamp>-serve;
        409 while another capture runs. This handler thread sleeps
        through it; the engine keeps serving."""
        seconds = query.get("seconds")
        if seconds is None and body:
            seconds = body.get("seconds")
        try:
            seconds = float(seconds if seconds is not None else 3.0)
        except (TypeError, ValueError):
            return _error(400, "seconds must be a number")
        if not 0 < seconds <= 300:
            return _error(400, "seconds must be in (0, 300]")
        log_dir = obs_profile.capture_dir(tag="serve")
        try:
            obs_profile.PROFILER.capture(log_dir, seconds)
        except obs_profile.ProfilerBusy as exc:
            return _error(409, str(exc))
        except Exception as exc:  # noqa: BLE001 - answered, not raised
            return _error(500, f"profile capture failed: {exc}")
        return 200, {"path": log_dir, "seconds": seconds,
                     "trace": f"{log_dir}/{obs_profile.TRACE_FILE}"}, {}

    def memory(self) -> Reply:
        """The allocator's stats and the bytes of the engine's named
        groups (weights, KV cache, prefix cache, adapter pool)."""
        eng = self.worker.engine
        try:
            snap = obs_device.memory_snapshot(eng.memory_groups())
        except Exception as exc:  # noqa: BLE001 - diagnostics, not serving
            return _error(500, f"memory snapshot failed: {exc}")
        snap["kv_occupancy"] = eng.kv_occupancy()
        return 200, snap, {}

    def programs(self) -> Reply:
        """The program census with each shape's roofline attribution, and
        the analytic MFU of programs whose dispatch-time histogram has
        samples; the warmup census, speculation, adapter and grammar
        state; the build sentinel's."""
        eng = self.worker.engine
        peak_flops, hbm_bps = device_peaks()
        reg = obs_metrics.REGISTRY
        census = obs_device.PROGRAMS.census("serve")
        for entry in census:
            for sig, cost in entry["costs"].items():
                stats = None
                name = entry["name"]
                if name.startswith(("decode_v", "verify_v")):
                    kind, _, view = name.partition("_v")
                    stats = reg.histogram_stats(
                        f"serve_{kind}_dispatch_seconds", view=view)
                elif name in ("prefill", "paged_prefill") \
                        and sig.startswith("b"):
                    bucket, _, rows = sig[1:].partition("r")
                    stats = reg.histogram_stats(
                        "serve_prefill_dispatch_seconds", bucket=bucket,
                        rows=rows)
                if stats and stats[0]:
                    mean_s = stats[1] / stats[0]
                    cost["measured_mean_seconds"] = round(mean_s, 6)
                    cost["analytic_mfu"] = round(
                        cost["flops"] / (mean_s * peak_flops), 9)
                    cost["achieved_gbps"] = round(
                        cost["hbm_bytes"] / mean_s / 1e9, 3)
        sentinel = obs_device.SENTINEL
        return 200, {
            "programs": census,
            "warmup_census": eng.warmup_census,
            "speculative": eng.spec_stats(),
            "adapters": eng.adapter_stats(),
            "grammar": eng.grammar_stats(),
            "tokenizer_fingerprint": eng.tokenizer_fingerprint,
            "compiles": {"total": sentinel.total,
                         "unexpected": sentinel.unexpected,
                         "compile_seconds": round(
                             sentinel.compile_seconds, 3),
                         "steady": sentinel.steady_components(),
                         "last_unexpected": sentinel.recent_unexpected()},
            "peaks": {"flops_per_sec": peak_flops,
                      "hbm_bytes_per_sec": hbm_bps,
                      "ridge_flops_per_byte": round(
                          peak_flops / hbm_bps, 3)},
        }, {}

    def flight(self, query: dict) -> Reply:
        """The flight-recorder ring, one request's timeline when
        ``request_id`` is given, with the process identity."""
        rid = query.get("request_id")
        return 200, {**obs_flight.identity(),
                     "stats": obs_flight.RING.stats(),
                     "events": obs_flight.RING.snapshot(
                         request_id=rid or None)}, {}

    def incident(self, body: Optional[dict]) -> Reply:
        """Capture an incident bundle on demand (debounced: a repeat
        inside the window answers {"debounced": true})."""
        reason = str((body or {}).get("reason") or "manual")
        try:
            groups = self.worker.engine.memory_groups()
        except Exception:  # noqa: BLE001 - diagnostics, not serving
            groups = None
        path = obs_incident.capture(reason, component="serve",
                                    memory_groups=groups,
                                    extra={"source": "http"})
        return 200, {"path": path, "debounced": path is None}, {}

    def incidents(self, query: dict) -> Reply:
        """The captured bundles, newest first; ``name`` fetches one."""
        name = query.get("name")
        if name:
            bundle = obs_incident.read_incident(name)
            if bundle is None:
                return _error(404, f"no incident bundle {name!r}")
            return 200, bundle, {}
        return 200, {"incidents": obs_incident.list_incidents(),
                     "last_path": obs_incident.MANAGER.last_path()}, {}


def _settled(tokenizer, ids: List[int]) -> str:
    """The decoded text of ``ids`` that no later id can change: without
    the trailing ids the tokenizer says are still open (a byte-fallback
    run), without trailing U+FFFD (a multibyte character still
    incomplete) and, for a tokenizer that cleans up tokenization spaces
    (" ." -> "."), without the tail from the first space among its last 8
    characters, where a clean-up rule may still match."""
    tail = getattr(tokenizer, "unsettled_tail", None)
    if tail is not None:
        ids = ids[:len(ids) - tail(ids)]
    text = tokenizer.decode(ids).rstrip("\ufffd")
    if getattr(tokenizer, "clean_up_tokenization_spaces", False):
        cut = text.find(" ", max(0, len(text) - 8))
        if cut >= 0:
            text = text[:cut]
    return text


def _chat_prompt(tokenizer, messages: list) -> str:
    """The tokenizer's chat template when it has one, else a plain
    role-prefix template."""
    if hasattr(tokenizer, "apply_chat_template"):
        try:
            return tokenizer.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        except Exception:  # noqa: BLE001 - fall back to the plain template
            pass
    parts = [f"{m.get('role', 'user')}: {m.get('content', '')}"
             for m in messages]
    return "\n".join(parts) + "\nassistant:"


_GET_ROUTES = ("/", "/healthz", "/metrics", "/debug/memory",
               "/debug/programs", "/debug/flight", "/debug/incidents")
_POST_ROUTES = ("/v1/completions", "/v1/chat/completions", "/v1/prefix",
                "/debug/profile", "/debug/incident")


def _make_handler(api: _Api):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.0: every response closes its connection, which is what
        # ends an SSE stream.
        protocol_version = "HTTP/1.0"

        def log_message(self, fmt, *args):   # one access line of our own
            pass

        def _send(self, reply: Reply, scope: Tuple[str, Optional[str]] =
                  ("", None)) -> None:
            status, payload, headers = reply
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers.items():
                self.send_header(k, v)
            self._scope_headers(scope)
            self.end_headers()
            self.wfile.write(data)

        def _scope_headers(self, scope) -> None:
            rid, tp_out = scope
            if rid:
                self.send_header("X-Request-Id", rid)
            if tp_out:
                self.send_header("traceparent", tp_out)

        def _route(self, routes) -> Optional[str]:
            """The request's path when ``routes`` serve it, else None
            after a 405 (another method's route) or a 404."""
            path = urlsplit(self.path).path
            if path in routes:
                return path
            other = _POST_ROUTES if routes is _GET_ROUTES else _GET_ROUTES
            self._send(_error(405, "method not allowed") if path in other
                       else _error(404, "not found"))
            return None

        def _query(self) -> dict:
            return {k: v[-1] for k, v in
                    parse_qs(urlsplit(self.path).query).items()}

        def do_GET(self):
            path = self._route(_GET_ROUTES)
            if path == "/":
                self._send(api.readiness())
            elif path == "/healthz":
                self._send((200, {"ok": True}, {}))
            elif path == "/metrics":
                data = api.metrics().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", obs_metrics.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path == "/debug/memory":
                self._send(api.memory())
            elif path == "/debug/programs":
                self._send(api.programs())
            elif path == "/debug/flight":
                self._send(api.flight(self._query()))
            elif path == "/debug/incidents":
                self._send(api.incidents(self._query()))

        def do_POST(self):
            path = self._route(_POST_ROUTES)
            if path is None:
                return
            body = self._body()
            if body is None:
                return
            if path == "/v1/prefix":
                self._send(api.register_prefix(body))
                return
            if path == "/debug/profile":
                self._send(api.profile(self._query(), body))
                return
            if path == "/debug/incident":
                self._send(api.incident(body))
                return
            chat = path == "/v1/chat/completions"
            if chat:
                messages = body.get("messages")
                if not isinstance(messages, list) or not messages:
                    self._send(_error(400, "missing required field: "
                                           "messages"))
                    return
                body["prompt"] = _chat_prompt(api.tokenizer, messages)
                body["_chat"] = True
            self._complete(body, chat)

        def _body(self) -> Optional[dict]:
            try:
                n = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                n = -1
            if not 0 <= n <= _MAX_BODY_BYTES:
                self._send(_error(413, f"body must be 0 to "
                                       f"{_MAX_BODY_BYTES} bytes"))
                return None
            if n == 0 and urlsplit(self.path).path.startswith("/debug/"):
                return {}   # the debug routes take an empty body
            try:
                body = json.loads(self.rfile.read(n))
            except (ValueError, UnicodeDecodeError):
                self._send(_error(400, "invalid JSON body"))
                return None
            if not isinstance(body, dict):
                self._send(_error(400, "JSON body must be an object"))
                return None
            return body

        def _complete(self, body: dict, chat: bool) -> None:
            scope = request_scope(self.headers)
            t0 = time.monotonic()
            status = self._complete_scoped(body, chat, scope)
            print(f"serve: access {self.path} rid={scope[0]} "
                  f"status={status} "
                  f"dur_ms={(time.monotonic() - t0) * 1000:.1f}",
                  flush=True)

        def _complete_scoped(self, body: dict, chat: bool, scope) -> int:
            reqs, err = api.parse(body, self.headers.get("X-Priority"))
            if err is not None:
                self._send(err, scope)
                return err[0]
            rid = scope[0]
            for i, r in enumerate(reqs):
                r.request_id = rid if len(reqs) == 1 else f"{rid}/{i}"
                # Multi-turn chat: this turn's prompt K/V becomes the next
                # turn's prefix (the rendered history extends it).
                r.auto_prefix = api.auto_prefix_chat and chat
            if body.get("stream"):
                err = api.stream(reqs, chat, self._sse_writer(scope))
                if err is not None:
                    self._send(err, scope)
                    return err[0]
                return 200
            reply = api.complete(reqs)
            status, payload, headers = reply
            if chat and status == 200:
                payload["object"] = "chat.completion"
                payload["choices"] = [{
                    "index": c["index"],
                    "message": {"role": "assistant", "content": c["text"]},
                    "finish_reason": c["finish_reason"],
                } for c in payload["choices"]]
            self._send((status, payload, headers), scope)
            return status

        def _sse_writer(self, scope):
            def write(data: Optional[bytes]) -> None:
                if data is None:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("X-Accel-Buffering", "no")
                    self.send_header("Connection", "close")
                    self._scope_headers(scope)
                    self.end_headers()
                else:
                    self.wfile.write(data)
                self.wfile.flush()
            return write

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # Handler threads are joined by server_close, so a graceful shutdown
    # lets every stream write its last chunk.
    daemon_threads = False


class Server:
    """A running HTTP front end over one EngineWorker. ``serve_forever``
    answers requests until ``shutdown`` (from another thread) drains and
    stops it."""

    def __init__(self, httpd: ThreadingHTTPServer, worker: EngineWorker,
                 drain_timeout_s: float):
        self.httpd = httpd
        self.worker = worker
        self.drain_timeout_s = drain_timeout_s
        self._serving = threading.Event()

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self) -> None:
        self._serving.set()
        self.httpd.serve_forever(poll_interval=0.1)

    def shutdown(self) -> bool:
        """Graceful stop (the SIGTERM path): new requests get 503 while
        every in-flight one finishes (bounded by drain_timeout_s); then
        the listener, the worker and the handler threads stop. Call from
        a thread other than serve_forever's. Returns whether the drain
        completed."""
        print("serve: draining (no new admissions; finishing in-flight "
              "requests)", flush=True)
        drained = self.worker.drain(self.drain_timeout_s)
        if not drained:
            print(f"serve: drain timed out after {self.drain_timeout_s} s; "
                  "abandoning remaining requests", flush=True)
        if self._serving.is_set():
            self.httpd.shutdown()
        self.worker.stop()
        # The worker thread is gone: release a tensor-parallel engine's
        # followers (no-op on one device).
        self.worker.engine.stop_followers()
        self.httpd.server_close()   # joins the handler threads
        return drained


def create_server(cfg: ModelConfig, model_params, tokenizer=None, *,
                  host: str = "0.0.0.0", port: int = contract.SERVE_PORT,
                  device: Optional[Union[str, torch.device]] = None,
                  max_slots: int = 8, max_seq_len: Optional[int] = None,
                  warmup: bool = False,
                  prefill_budget: Optional[int] = None,
                  decode_chunk: Optional[int] = None,
                  max_queue: Optional[int] = None,
                  request_timeout_s: Optional[float] = None,
                  drain_timeout_s: float = 30.0,
                  queue_shares: Optional[dict] = None,
                  warm_prefix: bool = False,
                  auto_prefix_chat: bool = False,
                  prefix_cache_size: Optional[int] = None,
                  speculative: Optional[str] = None,
                  draft_tokens: Optional[int] = None,
                  ngram_max: Optional[int] = None,
                  ngram_min: Optional[int] = None,
                  grammar: str = "off",
                  grammar_cache_size: Optional[int] = None,
                  kv_paging: bool = False,
                  page_size: int = 16,
                  num_pages: Optional[int] = None,
                  kv_host_pages: int = 0,
                  preemption: str = "off",
                  adapter_pool: Optional[int] = None,
                  lora_rank: Optional[int] = None,
                  adapter_dir: Optional[str] = None,
                  mesh=None) -> Server:
    """An HTTP server bound to (host, port; 0 picks a free port) over an
    InferenceEngine on ``device`` (CUDA unless the caller names another;
    params move there): the dense one, or with ``kv_paging`` the paged
    one. With ``warmup`` the worker builds the
    kernels and runs every prefill bucket and decode view before this
    returns, so readiness flips only when the first request is cheap; a
    warmup failure raises here.

    max_queue bounds the admission queue (full -> 429 with Retry-After);
    request_timeout_s is the default per-request deadline (the body's
    "timeout" overrides it; 0/None = none); drain_timeout_s bounds the
    graceful drain of ``Server.shutdown``; queue_shares bounds each QoS
    class's share of the queue.

    Shared prefixes: warm_prefix is accepted for parity with the
    reference and adds nothing to ``warmup``: eager PyTorch has no
    compile to hoist, and the prefix build and the suffix prefill launch
    the shapes warmup already runs (so with warmup, a /v1/prefix
    registration under traffic pays no first launch). auto_prefix_chat registers each finished
    chat turn's prompt K/V from its slot, so the next turn prefills only
    what it adds. prefix_cache_size bounds the prefixes kept (LRU).

    speculative="ngram" drafts up to draft_tokens tokens per slot from an
    n-gram index (ngram_max/ngram_min) over each request's own context and
    verifies them in one batched forward; None follows the model config.
    grammar="on" lets bodies carry `response_format` (a JSON-schema subset
    or EBNF), compiled into a token DFA over this tokenizer's vocabulary
    (an LRU of grammar_cache_size entries) that masks sampling;
    constrained requests finish with finish_reason "grammar_complete".

    kv_paging=True serves from the paged engine (serve/paging.py): the
    cache is num_pages pages of page_size tokens (default num_pages: the
    dense worst case, max_slots * max_seq_len / page_size) with radix-tree
    prefix sharing across requests, and admission gates on free pages.
    kv_host_pages >= 1 (paged only) adds the host swap tier: evicted pages
    copy to pinned host buffers, and a returning session copies them back
    instead of re-prefilling. preemption="swap" (paged only) lets a queue
    head of a better QoS class displace the worst-class active slot, which
    resumes later with its generated tokens intact. With the paged engine,
    /v1/prefix registrations run through normal admission, and auto-prefix
    chat needs no registration (finished turns seed the tree).

    adapter_pool > 0 (None follows cfg.adapter_pool) serves many LoRA
    tenants on these base params from one device-resident pool of that
    many adapters, padded to the rank bucket lora_rank: a body's
    "adapter" (a name under adapter_dir, or a path) selects the tenant,
    an adapter the pool cannot resolve answers 400, and tenants batch
    with each other and with base-only requests (serve/lora_pool.py).

    mesh (a DeviceMesh, parallel/mesh.make_mesh): this process is rank 0
    of a tensor-parallel replica. ``model_params`` is then the full tree
    or this rank's shard (load_model's ``shard``; on any device: the
    engine keeps this rank's shard on the rank's device), and every other
    rank runs the same engine through
    ``make_engine`` and its ``serve_follower`` loop (``main`` starts
    them)."""
    tokenizer = tokenizer or load_tokenizer(None)
    engine = make_engine(
        cfg, model_params, tokenizer, device=device, mesh=mesh,
        max_slots=max_slots, max_seq_len=max_seq_len,
        prefill_budget=prefill_budget, decode_chunk=decode_chunk,
        max_queue=max_queue, queue_shares=queue_shares,
        prefix_cache_size=prefix_cache_size, speculative=speculative,
        draft_tokens=draft_tokens, ngram_max=ngram_max,
        ngram_min=ngram_min, grammar=grammar,
        grammar_cache_size=grammar_cache_size, kv_paging=kv_paging,
        page_size=page_size, num_pages=num_pages,
        kv_host_pages=kv_host_pages, preemption=preemption,
        adapter_pool=adapter_pool, lora_rank=lora_rank,
        adapter_dir=adapter_dir)
    # This process's events label as the serving tier in merged timelines
    # and /debug/flight envelopes.
    obs_flight.set_component("serve")
    worker = EngineWorker(engine, warmup=warmup)
    worker.ready.wait()
    if worker.warmup_error is not None:
        raise RuntimeError("serve: engine warmup failed") \
            from worker.warmup_error
    api = _Api(worker, tokenizer, cfg.name, request_timeout_s or None,
               auto_prefix_chat)
    try:
        httpd = _HTTPServer((host, port), _make_handler(api))
    except OSError:
        worker.stop()
        engine.stop_followers()
        raise
    return Server(httpd, worker, drain_timeout_s)


def make_engine(cfg: ModelConfig, model_params, tokenizer, *,
                device: Optional[Union[str, torch.device]] = None,
                mesh=None, kv_paging: bool = False, page_size: int = 16,
                num_pages: Optional[int] = None, kv_host_pages: int = 0,
                **engine_kw) -> InferenceEngine:
    """The engine ``create_server`` serves: the dense one, or with
    ``kv_paging`` the paged one, on ``device`` (CUDA unless named; params
    move there) or, with ``mesh``, on this rank's device with this rank's
    shard of ``model_params`` (the full tree or the shard). A tensor-parallel follower builds
    its engine here with rank 0's arguments."""
    if mesh is None:
        dev = resolve_device(device)
        model_params = tree_map(lambda t: t.to(dev), model_params)
    engine_kw = dict(engine_kw, tokenizer=tokenizer)
    if kv_paging:
        return PagedInferenceEngine(cfg, model_params, page_size=page_size,
                                    num_pages=num_pages,
                                    kv_host_pages=kv_host_pages, mesh=mesh,
                                    **engine_kw)
    return InferenceEngine(cfg, model_params, mesh=mesh, **engine_kw)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def serve_mesh(params: dict) -> Optional[MeshConfig]:
    """The ``mesh_*`` params as a MeshConfig (the reference's reading), or
    None when none is set. A replica is one pod: the mesh spans exactly
    the processes its fixed axes name (a -1 axis fills to 1), one per
    GPU. Any axis but ``expert`` and ``tensor`` above 1 is refused by name
    (mesh.check_serving_mesh), and so is an unknown ``mesh_`` key."""
    fields = {f.name for f in dataclasses.fields(MeshConfig)}
    args = {}
    for k, v in params.items():
        if not k.startswith("mesh_"):
            continue
        if k[len("mesh_"):] not in fields:
            raise ValueError(f"params {k!r}: unknown mesh axis (expected "
                             f"mesh_ + one of {sorted(fields)})")
        args[k[len("mesh_"):]] = int(v)
    if not args:
        return None
    mc = MeshConfig(**args)
    mc = mc.resolve(math.prod(s for s in dataclasses.astuple(mc) if s != -1))
    check_serving_mesh(mc)
    return mc


# The reference's collective_matmul modes (runbooks_tpu.models.config).
COLLECTIVE_MATMUL_MODES = ("off", "ring", "auto")


def collective_matmul_param(params: dict) -> str:
    """params.json's collective_matmul (any spelling), lower-cased; "off"
    when unset or false."""
    cm = str(_param_any(params, "collective_matmul", "collectiveMatmul",
                        "collectivematmul", default="off")).lower()
    return "off" if cm in ("false", "0") else cm


def collective_matmul_choice(params: dict) -> Optional[str]:
    """The startup line naming what collective_matmul "auto" resolves to
    under ``mesh_tensor`` > 1 (None otherwise)."""
    mc = serve_mesh(params)
    if (mc is None or mc.tensor == 1
            or collective_matmul_param(params) != "auto"):
        return None
    return (f"serve: collective_matmul='auto' under mesh_tensor={mc.tensor} "
            f"resolves to {COLLECTIVE_MATMUL_AUTO!r}: one all-reduce after "
            "each sharded sublayer (the ring collective matmul is not "
            "ported)")


def refuse_unported(params: dict) -> None:
    """Raise naming every params knob whose feature this port does not
    serve yet (serving without it would silently change what the
    deployment asked for): serving axes other than ``expert`` and
    ``tensor``, and under a mesh of more than one rank the features the
    sharded engines refuse."""
    mc = serve_mesh(params)
    if mc is None or mc.expert * mc.tensor == 1:
        return
    check_mesh_model(get_config(params.get("model", "debug"),
                                **params.get("model_overrides", {})), mc,
                     serving=True)
    info = distributed.env_process_info()
    if info is not None and info["num_processes"] > 1:
        raise NotImplementedError(
            f"{serving_axes(mc)} over {info['num_processes']} hosts: "
            "a serving replica is one pod (one process per GPU of one "
            "host); multi-host serving meshes are refused")
    overrides = params.get("model_overrides", {})
    bad = []
    quantize = params.get("quantize", overrides.get("quantize", "none"))
    if quantize not in (None, "none"):
        bad.append(f"quantize={quantize!r}")
    if _param_on(_param_any(params, "quantize_kv", "quantizeKv",
                            "quantizekv", default=False)):
        bad.append("quantize_kv")
    if int(_param_any(params, "adapter_pool", "adapterPool", "adapterpool",
                      default=0) or 0) > 0:
        bad.append("adapter_pool")
    if int(_param_any(params, "kv_host_pages", "kvHostPages",
                      "kvhostpages", default=0) or 0) > 0:
        bad.append("kv_host_pages")
    if (params.get("preemption") or "off") != "off":
        bad.append("preemption")
    if collective_matmul_param(params) not in ("off", "auto"):
        bad.append("collective_matmul")
    if bad:
        raise NotImplementedError(
            f"params {bad} under {serving_axes(mc)}: not ported to the "
            "sharded server yet (ROADMAP.md §1); serve them on one device")


def _server_options(params: dict) -> dict:
    """create_server's keyword arguments from a params.json dict."""
    queue_shares = {}
    for cls in PRIORITY_RANK:
        camel = f"queueShare{cls.capitalize()}"
        raw = _param_any(params, f"queue_share_{cls}", camel, camel.lower())
        if raw is not None:
            queue_shares[cls] = float(raw)

    def opt(key, kind, *spellings):
        raw = _param_any(params, key, *spellings)
        return kind(raw) if raw is not None else None

    return dict(
        port=int(params.get("port", contract.SERVE_PORT)),
        max_slots=int(params.get("max_slots", 8)),
        max_seq_len=opt("max_seq_len", int),
        warmup=bool(params.get("warmup", True)),
        prefill_budget=opt("prefill_budget", int),
        decode_chunk=opt("decode_chunk", int),
        max_queue=opt("max_queue", int),
        request_timeout_s=opt("request_timeout_s", float),
        drain_timeout_s=float(params.get("drain_timeout_s", 30.0)),
        queue_shares=queue_shares or None,
        warm_prefix=bool(params.get("warm_prefix", False)),
        auto_prefix_chat=bool(params.get("auto_prefix_chat", False)),
        prefix_cache_size=opt("prefix_cache_size", int),
        # The engine validates both modes before it allocates anything.
        speculative=opt("speculative", str),
        draft_tokens=opt("draft_tokens", int, "draftTokens", "drafttokens"),
        ngram_max=opt("ngram_max", int, "ngramMax", "ngrammax"),
        ngram_min=opt("ngram_min", int, "ngramMin", "ngrammin"),
        grammar=opt("grammar", str) or "off",
        grammar_cache_size=opt("grammar_cache_size", int,
                               "grammarCacheSize", "grammarcachesize"),
        # `kv_paging: paged` is the validated spelling; bools are taken
        # for hand-written params.json.
        kv_paging=str(_param_any(params, "kv_paging", "kvPaging",
                                 "kvpaging", default="off")).lower()
        in ("paged", "on", "true", "1"),
        page_size=int(_param_any(params, "page_size", "pageSize",
                                 "pagesize", default=16)),
        num_pages=opt("num_pages", int, "numPages", "numpages"),
        kv_host_pages=opt("kv_host_pages", int, "kvHostPages",
                          "kvhostpages") or 0,
        preemption=opt("preemption", str) or "off",
        # The multi-tenant adapter pool: its size, the rank bucket and the
        # root of relative adapter names. (A pool-less `adapter: <path>`
        # was folded by load_model.)
        adapter_pool=opt("adapter_pool", int, "adapterPool", "adapterpool"),
        lora_rank=opt("lora_rank", int, "loraRank", "lorarank"),
        adapter_dir=opt("adapter_dir", str, "adapterDir", "adapterdir"))


# create_server's arguments that are the front end's, not the engine's.
_FRONT_END_OPTIONS = ("port", "warmup", "request_timeout_s",
                      "drain_timeout_s", "warm_prefix", "auto_prefix_chat")

# The tensor-parallel group's timeout: a collective a dead rank never
# joins fails within it (gloo fails at once on a closed connection).
TP_TIMEOUT_S = 300


def _join_mesh(rank: int, mc: MeshConfig, store_path: str, backend: str):
    """Form the replica's process group (a FileStore rendezvous) and its
    DeviceMesh over the expert and tensor axes. (mesh, this rank's
    device: cuda:rank under NCCL, the CPU under gloo.)"""
    import torch.distributed as dist

    world = mc.expert * mc.tensor
    distributed.initialize(TP_TIMEOUT_S, backend=backend, rank=rank,
                           world_size=world,
                           store=dist.FileStore(store_path, world))
    dev = (torch.device("cuda", rank) if backend == "nccl"
           else torch.device("cpu"))
    return make_mesh(MeshConfig(expert=mc.expert, fsdp=1,
                                tensor=mc.tensor)), dev


def _follower_main(rank: int, world: int, store_path: str,
                   backend: str) -> None:
    """A follower rank of the sharded server: its own shard of the model,
    the same engine as rank 0's, and rank 0's program calls until rank 0
    stops it. Signals are rank 0's to handle."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    params = contract.load_params()
    cuda_build.use_kernel_cache(
        cuda_build.kernel_cache_dir(contract.artifacts_dir()))
    mc = serve_mesh(params)
    mesh, dev = _join_mesh(rank, mc, store_path, backend)
    cfg, model_params = load_model(params, device=dev,
                                   shard=(mc.tensor, rank, mc.expert))
    opts = _server_options(params)
    for k in _FRONT_END_OPTIONS:
        opts.pop(k)
    engine = make_engine(cfg, model_params,
                         load_tokenizer(params.get("tokenizer")), mesh=mesh,
                         **opts)
    engine.serve_follower()
    distributed.shutdown()


def _watch_followers(procs: list, stopping: threading.Event,
                     served: threading.Event, rendezvous: str) -> None:
    """Rank 0's guard: a follower that exits before rank 0 stops it, or
    with a non-zero code at any time (killed, crashed), ends rank 0 at
    once with a non-zero code, after killing the others, so no rank
    outlives the replica. ``stopping`` is set once the shutdown began,
    ``served`` once it ended (the guard then returns, and rank 0 joins the
    followers itself)."""
    from multiprocessing.connection import wait

    live = list(procs)
    while live and not served.is_set():
        for sentinel in wait([p.sentinel for p in live], timeout=0.2):
            p = next(q for q in live if q.sentinel == sentinel)
            live.remove(p)
            # The sentinel closes as the process exits, a moment before
            # it can be reaped: wait for its exit code.
            p.join(5)
            if p.exitcode == 0 and stopping.is_set():
                continue
            print(f"serve: tensor-parallel {p.name} exited with code "
                  f"{p.exitcode}; stopping the replica", flush=True)
            for q in procs:
                if q.is_alive():
                    q.kill()
            shutil.rmtree(rendezvous, ignore_errors=True)
            os._exit(1)


def _serve(srv: Server, cfg: ModelConfig,
           stopping: Optional[threading.Event] = None) -> None:
    """Answer until SIGTERM or SIGINT, then drain and stop (setting
    ``stopping`` first)."""
    stopper: List[threading.Thread] = []

    def on_signal(signum, frame):
        if not stopper:
            print(f"serve: caught {signal.Signals(signum).name}", flush=True)
            if stopping is not None:
                stopping.set()
            stopper.append(threading.Thread(target=srv.shutdown,
                                            name="serve-shutdown"))
            stopper[0].start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, on_signal)
    print(f"serve: {cfg.name} ready on port {srv.port}", flush=True)
    srv.serve_forever()
    stopper[0].join()


def main(backend: Optional[str] = None) -> int:
    """The serving container's entry point. ``mesh_expert: E`` x
    ``mesh_tensor: N`` above one rank serves one sharded replica over E x
    N processes, one per GPU: this process is rank 0 (HTTP, the worker,
    the scheduler) and starts the others itself. ``backend``: "nccl"
    (default, rank r on cuda:r) or, when the caller asks, "gloo" on the
    CPU."""
    params = contract.load_params()
    refuse_unported(params)
    choice = collective_matmul_choice(params)
    if choice is not None:
        print(choice, flush=True)
    mc = serve_mesh(params)
    if mc is not None and mc.expert * mc.tensor > 1:
        return _main_tensor_parallel(params, mc.expert * mc.tensor,
                                     backend or "nccl")
    # Kernels build into and load from <artifacts>/kernel_cache: a
    # restarted server loads K1 instead of running nvcc again.
    cuda_build.use_kernel_cache(
        cuda_build.kernel_cache_dir(contract.artifacts_dir()))
    cfg, model_params = load_model(params)
    tokenizer = load_tokenizer(params.get("tokenizer"))
    srv = create_server(cfg, model_params, tokenizer,
                        **_server_options(params))
    _serve(srv, cfg)
    # The flash forward kernel's launches over the process's life, for a
    # caller that reads the log (its wrapper counts only CUDA launches).
    print(json.dumps({"stopped": True,
                      "flash_fwd_launches": flash_attention.launches}),
          flush=True)
    return 0


def _main_tensor_parallel(params: dict, world: int, backend: str) -> int:
    """Rank 0 of a sharded replica of ``world`` ranks (params' mesh):
    start the followers, serve, and on SIGTERM drain, release and join
    every follower, exit 0."""
    import tempfile

    import torch.multiprocessing as mp

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    mc = serve_mesh(params)
    if backend == "nccl":
        n = torch.cuda.device_count()
        if world > n:
            raise RuntimeError(
                f"{serving_axes(mc)} needs {world} GPUs (one process per "
                f"GPU) but torch.cuda.device_count() is {n}")
    cuda_build.use_kernel_cache(
        cuda_build.kernel_cache_dir(contract.artifacts_dir()))
    rendezvous = tempfile.mkdtemp(prefix="rbt-tp-")
    store_path = os.path.join(rendezvous, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_follower_main,
                         args=(r, world, store_path, backend),
                         name=f"rank {r}", daemon=True)
             for r in range(1, world)]
    for p in procs:
        p.start()
    stopping, served = threading.Event(), threading.Event()
    guard = threading.Thread(target=_watch_followers,
                             args=(procs, stopping, served, rendezvous),
                             name="tp-watch", daemon=True)
    guard.start()
    try:
        mesh, dev = _join_mesh(0, mc, store_path, backend)
        cfg, model_params = load_model(params, device=dev,
                                       shard=(mc.tensor, 0, mc.expert))
        srv = create_server(cfg, model_params,
                            load_tokenizer(params.get("tokenizer")),
                            mesh=mesh, **_server_options(params))
        print(f"serve: sharded replica of {world} ranks ({serving_axes(mc)}; "
              f"{backend}); plan {srv.worker.engine.tp.plan.describe()}",
              flush=True)
        _serve(srv, cfg, stopping)
        served.set()
        guard.join()
        for p in procs:
            p.join(30)
        alive = [p.name for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
        codes = [p.exitcode for p in procs]
        print(json.dumps({"stopped": True, "ranks": world,
                          "follower_exit_codes": codes,
                          "flash_fwd_launches": flash_attention.launches}),
              flush=True)
        return 0 if not alive and all(c == 0 for c in codes) else 1
    finally:
        stopping.set()
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        distributed.shutdown()
        shutil.rmtree(rendezvous, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
