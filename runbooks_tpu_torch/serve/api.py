"""OpenAI-compatible HTTP serving on the container contract (the port of
``runbooks_tpu.serve.api``).

The surface a Server resource expects of its container: readiness at
``GET /`` on port 8080, ``/v1/completions`` and ``/v1/chat/completions``
(``"stream": true`` answers with server-sent events), and weights from the
contract's model mount. One worker thread owns the dense InferenceEngine
and makes every device call; HTTP handler threads (the standard library's
``ThreadingHTTPServer``) only parse, enqueue and wait.

Run: ``python -m runbooks_tpu_torch.serve.api`` (reads
``{RBT_CONTENT_DIR}/params.json``: model, model_overrides, seed,
checkpoint, adapter, port, tokenizer and the engine knobs), or build one
with ``create_server``. Features the port has not ported yet (the
shared-prefix cache, speculation, grammar, paging, the adapter pool,
quantization, the mesh, ``/metrics`` and ``/debug/*``) are refused by
name rather than ignored.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import re
import signal
import threading
import time
import traceback
import uuid
from concurrent.futures import Future
from concurrent.futures import wait as wait_futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple, Union
from urllib.parse import urlsplit

import torch

from runbooks_tpu_torch.models.config import ModelConfig, get_config
from runbooks_tpu_torch.models.transformer import check_supported, init_params
from runbooks_tpu_torch.serve.engine import (
    PRIORITY_RANK,
    EngineDraining,
    EngineOverloaded,
    InferenceEngine,
    Request,
)
from runbooks_tpu_torch.serve.lora_pool import load_merge_adapter
from runbooks_tpu_torch.train.checkpoint import restore_params
from runbooks_tpu_torch.train.data import load_tokenizer
from runbooks_tpu_torch.utils import contract
from runbooks_tpu_torch.utils.hw import resolve_device
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


# ---------------------------------------------------------------------------
# Request scope (W3C trace context and X-Request-Id)
# ---------------------------------------------------------------------------

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")
# Client-supplied ids flow into response headers and logs: strip anything
# that could split a header or forge a log line.
_RID_UNSAFE_RE = re.compile(r"[^A-Za-z0-9._:/-]")


def request_scope(headers) -> Tuple[str, Optional[str]]:
    """(request_id, traceparent_out) for one HTTP request: X-Request-Id
    verbatim (sanitized); else a W3C ``traceparent``'s trace-id; else a
    generated id. A valid traceparent gets a child (same trace-id, fresh
    parent-id) to echo back."""
    rid = headers.get("X-Request-Id") if headers else None
    tp_out = None
    tp = (headers.get("traceparent", "") if headers else "").strip().lower()
    m = _TRACEPARENT_RE.match(tp)
    if m:
        tp_out = (f"{m.group(1)}-{m.group(2)}-"
                  f"{uuid.uuid4().hex[:16]}-{m.group(4)}")
        if not rid:
            rid = m.group(2)
    if rid:
        rid = _RID_UNSAFE_RE.sub("", str(rid))[:128]
    if not rid:
        rid = f"req-{uuid.uuid4().hex[:16]}"
    return rid, tp_out


# ---------------------------------------------------------------------------
# Model loading
# ---------------------------------------------------------------------------

def load_model(params: dict,
               device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[ModelConfig, Any]:
    """(cfg, model params) from a params.json-style dict: a named config
    plus ``model_overrides``; the params of the newest intact checkpoint
    under ``{checkpoint or model mount}/checkpoints``, else (nothing there)
    a random init seeded by ``seed``; then ``adapter: <path>`` folded in.
    A checkpoint that is present but unreadable raises. Runs on CUDA
    unless ``device`` names another; raises when no device is named and
    no GPU exists."""
    dev = resolve_device(device)
    quantize = params.get("quantize", "none")
    if quantize not in (None, "none"):
        raise NotImplementedError(
            f"weight quantization ({quantize!r}) is not ported yet")
    adapter = params.get("adapter")
    pool = int(_param_any(params, "adapter_pool", "adapterPool",
                          "adapterpool", default=0) or 0)
    if adapter and pool:
        raise RuntimeError(
            "params set both `adapter` and `adapter_pool`: the load-time "
            "fold and the pooled engine are mutually exclusive serving "
            "modes — drop `adapter` (clients pass it per request) or the "
            "pool")
    if pool:
        raise NotImplementedError(
            f"adapter_pool: {pool}: the multi-tenant adapter pool is not "
            "ported yet; fold one adapter at load with `adapter:`")
    cfg = get_config(params.get("model", "debug"),
                     **params.get("model_overrides", {}))
    cfg = dataclasses.replace(cfg, quantize="none")
    check_supported(cfg)
    ckpt_dir = params.get("checkpoint") or contract.model_dir()
    restored = restore_params(ckpt_dir, dev)
    if restored is not None:
        model_params, step = restored
        _check_params_fit(cfg, model_params, f"{ckpt_dir} step {step}")
        print(f"serve: restored params of step {step} from {ckpt_dir}",
              flush=True)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(params.get("seed", 0)))
        model_params = init_params(cfg, gen, dev)
    if adapter:
        model_params = load_merge_adapter(str(adapter), cfg, model_params)
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

class EngineWorker:
    """The one thread that owns the engine: it runs warmup, admits
    requests, steps the decode loop and resolves the futures of finished
    requests. HTTP threads only call submit_many, drain and stop."""

    def __init__(self, engine: InferenceEngine, warmup: bool = False):
        self.engine = engine
        self._pending: List[Tuple[Request, Future]] = []   # guarded-by: _lock
        self._inflight: List[Tuple[Request, Future]] = []  # guarded-by: _lock
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
        if not self.engine.has_work():
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            return
        self.engine.step()
        with self._lock:
            done = [(r, f) for r, f in self._inflight if r.finished]
            if done:
                self._inflight = [(r, f) for r, f in self._inflight
                                  if not r.finished]
        for req, fut in done:
            fut.set_result(req)

    def _contain(self, exc: Exception) -> None:
        """Fail every waiting request with the error (a hanging future
        would wedge its HTTP handler), then reset the engine so later
        requests get a clean one."""
        print("serve: engine step failed; failing every waiting request "
              "and resetting the engine:\n" + traceback.format_exc(),
              flush=True)
        with self._lock:
            doomed = self._inflight + self._pending
            self._inflight, self._pending = [], []
        for _, fut in doomed:
            if not fut.done():
                fut.set_exception(exc)
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
        with self._lock:
            doomed = self._inflight + self._pending
            self._inflight, self._pending = [], []
        for _, fut in doomed:
            if not fut.done():
                fut.set_exception(RuntimeError("engine worker stopped"))


# ---------------------------------------------------------------------------
# The HTTP API
# ---------------------------------------------------------------------------

def _error(status: int, message: str, **extra) -> Reply:
    return status, {"error": {"message": message, **extra}}, {}


class _Api:
    """The routes' logic, apart from the socket handling: parse a body
    into engine requests, submit them through the worker, and shape the
    reference's JSON and SSE answers."""

    def __init__(self, worker: EngineWorker, tokenizer, model_name: str,
                 request_timeout_s: Optional[float]):
        self.worker = worker
        self.tokenizer = tokenizer
        self.eos = _eos_id(tokenizer)
        self.model_name = model_name
        self.request_timeout_s = request_timeout_s
        self.started = time.time()

    def readiness(self) -> Reply:
        return 200, {"status": "ok", "model": self.model_name,
                     "uptime_s": round(time.time() - self.started, 1)}, {}

    def reject(self, exc: EngineOverloaded) -> Reply:
        """Backpressure: draining = 503 (terminal for this process),
        overloaded = 429 with a load-derived Retry-After."""
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

    def submit(self, reqs: List[Request]
               ) -> Tuple[Optional[List[Future]], Optional[Reply]]:
        try:
            return self.worker.submit_many(reqs), None
        except EngineOverloaded as exc:    # draining (503) / full (429)
            return None, self.reject(exc)
        except ValueError as exc:          # e.g. prompt past the window
            return None, _error(400, str(exc))

    def complete(self, reqs: List[Request]) -> Reply:
        """Run a non-streamed completion to its JSON reply."""
        futs, err = self.submit(reqs)
        if err is not None:
            return err
        _, not_done = wait_futures(futs, timeout=_GENERATION_TIMEOUT_S)
        if not_done:
            return _error(504, "generation timed out")
        for fut in futs:
            exc = fut.exception()
            if isinstance(exc, EngineOverloaded):
                return self.reject(exc)
            if isinstance(exc, ValueError):
                return _error(400, str(exc))
            if exc is not None:
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
        the choice's index on a queue this thread drains. Deltas come from
        an incremental decoder: only tokens since the last committed delta
        are decoded, and a trailing U+FFFD (a multibyte character still
        incomplete) is held back until its continuation lands."""
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
        start = [0] * len(reqs)   # first output token not yet committed

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
            pending = ids[start[i]:]
            if not pending:
                return None
            text = self.tokenizer.decode(pending)
            if not flush and text.endswith("�"):
                return None
            start[i] = len(ids)
            return text or None

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
                        write(b"data: " + json.dumps({"error": {
                            "message": str(exc), "index": i}}).encode()
                            + b"\n\n")
                        continue
                    delta = next_delta(i, flush=True)
                    if delta is not None:
                        write(chunk(i, text=delta))
                    write(chunk(i, finish=reqs[i].finish_reason or "stop"))
                    continue
                delta = next_delta(ev)
                if delta is not None:
                    write(chunk(ev, text=delta))
            write(b"data: [DONE]\n\n")
        except (queue.Empty, OSError):
            # Generation stalled or the client went away: stop writing;
            # the engine finishes the requests on its own.
            pass
        return None


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


_GET_ROUTES = ("/", "/healthz")
_POST_ROUTES = ("/v1/completions", "/v1/chat/completions", "/v1/prefix")


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

        def do_GET(self):
            path = self._route(_GET_ROUTES)
            if path == "/":
                self._send(api.readiness())
            elif path == "/healthz":
                self._send((200, {"ok": True}, {}))

        def do_POST(self):
            path = self._route(_POST_ROUTES)
            if path is None:
                return
            body = self._body()
            if body is None:
                return
            if path == "/v1/prefix":
                self._send(_error(
                    501, "the shared-prefix cache (/v1/prefix) is not "
                         "ported to this server yet",
                    type="not_implemented"))
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
                  queue_shares: Optional[dict] = None) -> Server:
    """An HTTP server bound to (host, port; 0 picks a free port) over a
    dense InferenceEngine on ``device`` (CUDA unless the caller names
    another; params move there). With ``warmup`` the worker builds the
    kernels and runs every prefill bucket and decode view before this
    returns, so readiness flips only when the first request is cheap; a
    warmup failure raises here.

    max_queue bounds the admission queue (full -> 429 with Retry-After);
    request_timeout_s is the default per-request deadline (the body's
    "timeout" overrides it; 0/None = none); drain_timeout_s bounds the
    graceful drain of ``Server.shutdown``; queue_shares bounds each QoS
    class's share of the queue."""
    dev = resolve_device(device)
    model_params = tree_map(lambda t: t.to(dev), model_params)
    tokenizer = tokenizer or load_tokenizer(None)
    engine = InferenceEngine(cfg, model_params, max_slots=max_slots,
                             max_seq_len=max_seq_len,
                             prefill_budget=prefill_budget,
                             decode_chunk=decode_chunk, max_queue=max_queue,
                             queue_shares=queue_shares)
    worker = EngineWorker(engine, warmup=warmup)
    worker.ready.wait()
    if worker.warmup_error is not None:
        raise RuntimeError("serve: engine warmup failed") \
            from worker.warmup_error
    api = _Api(worker, tokenizer, cfg.name, request_timeout_s or None)
    try:
        httpd = _HTTPServer((host, port), _make_handler(api))
    except OSError:
        worker.stop()
        raise
    return Server(httpd, worker, drain_timeout_s)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def refuse_unported(params: dict) -> None:
    """Raise NotImplementedError naming every params knob whose feature
    this port does not serve yet (serving without it would silently
    change what the deployment asked for)."""
    def on(*keys):
        v = _param_any(params, *keys)
        return v is not None and str(v).lower() not in (
            "0", "off", "false", "none", "")

    bad = []
    if on("kv_paging", "kvPaging", "kvpaging"):
        bad.append("kv_paging")
    if on("speculative"):
        bad.append("speculative")
    if str(params.get("grammar", "off")).lower() == "on":
        bad.append("grammar: on")
    if on("adapter_pool", "adapterPool", "adapterpool"):
        bad.append("adapter_pool")
    for key in ("auto_prefix_chat", "warm_prefix", "prefix_cache_size"):
        if on(key):
            bad.append(key)
    if str(params.get("preemption", "off")).lower() == "swap":
        bad.append("preemption: swap")
    if on("kv_host_pages", "kvHostPages", "kvhostpages"):
        bad.append("kv_host_pages")
    bad += [k for k, v in sorted(params.items())
            if k.startswith("mesh_") and int(v) > 1]
    if bad:
        raise NotImplementedError(
            f"params {bad}: not ported to this server yet (the shared-"
            "prefix cache, speculation, grammar, paging, preemption, the "
            "adapter pool and the mesh wait for later work)")


def main() -> int:
    params = contract.load_params()
    refuse_unported(params)
    cfg, model_params = load_model(params)
    tokenizer = load_tokenizer(params.get("tokenizer"))
    queue_shares = {}
    for cls in PRIORITY_RANK:
        camel = f"queueShare{cls.capitalize()}"
        raw = _param_any(params, f"queue_share_{cls}", camel, camel.lower())
        if raw is not None:
            queue_shares[cls] = float(raw)

    def opt(key, kind):
        return kind(params[key]) if params.get(key) is not None else None

    srv = create_server(
        cfg, model_params, tokenizer,
        port=int(params.get("port", contract.SERVE_PORT)),
        max_slots=int(params.get("max_slots", 8)),
        max_seq_len=opt("max_seq_len", int),
        warmup=bool(params.get("warmup", True)),
        prefill_budget=opt("prefill_budget", int),
        decode_chunk=opt("decode_chunk", int),
        max_queue=opt("max_queue", int),
        request_timeout_s=opt("request_timeout_s", float),
        drain_timeout_s=float(params.get("drain_timeout_s", 30.0)),
        queue_shares=queue_shares or None)
    stopper: List[threading.Thread] = []

    def on_signal(signum, frame):
        if not stopper:
            print(f"serve: caught {signal.Signals(signum).name}", flush=True)
            stopper.append(threading.Thread(target=srv.shutdown,
                                            name="serve-shutdown"))
            stopper[0].start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, on_signal)
    print(f"serve: {cfg.name} ready on port {srv.port}", flush=True)
    srv.serve_forever()
    stopper[0].join()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
