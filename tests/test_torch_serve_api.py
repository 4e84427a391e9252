"""The port's HTTP front end against the JAX package's.

Both servers serve the ``debug`` config at float32 with the reference's
``init_params`` weights (carried over by models/bridge.py): the JAX
``create_server`` under aiohttp's test server, the port's stdlib server on
the CPU. The same request bodies, sent over HTTP with the same client,
must give the same greedy JSON (ids and timestamps aside), the same
streamed text and finish reasons, and the same error statuses and types.
The engine-level QoS queue order and Retry-After hint are held to the JAX
engine's, and the port's worker is checked for crash containment and its
graceful drain.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.serve.api import create_server as jax_create_server
from runbooks_tpu.serve.engine import EngineOverloaded as JaxOverloaded
from runbooks_tpu.serve.engine import InferenceEngine as JaxEngine
from runbooks_tpu.serve.engine import Request as JaxRequest

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.obs.metrics import parse_exposition
from runbooks_tpu_torch.serve import api
from runbooks_tpu_torch.serve.engine import (
    EngineOverloaded,
    EngineStepFailed,
    InferenceEngine,
    Request,
)

torch.set_num_threads(2)

MAX_SEQ = 64
MAX_SLOTS = 4
MAX_QUEUE = 4
HTTP_TIMEOUT = 120


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("debug", dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tcfg = get_config("debug", dtype="float32")
    tparams = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


class _JaxServer:
    """The JAX app under aiohttp's TestClient, on an event loop of its own
    thread, so the test sends it plain HTTP like the port's server."""

    def __init__(self, app):
        from aiohttp.test_utils import TestClient, TestServer

        self.app = app
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

        async def start():
            client = TestClient(TestServer(app, host="127.0.0.1"))
            await client.start_server()
            return client

        self.client = self._run(start())
        self.base = str(self.client.make_url("")).rstrip("/")

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            HTTP_TIMEOUT)

    def close(self):
        try:
            self._run(self.client.close())   # drains and stops the worker
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=30)
            self.loop.close()


class _TorchServer:
    def __init__(self, srv: api.Server):
        self.srv = srv
        self.thread = threading.Thread(target=srv.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{srv.port}"

    def close(self):
        self.srv.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _torch_server(tcfg, tparams, **kw):
    return _TorchServer(api.create_server(
        tcfg, tparams, host="127.0.0.1", port=0, device="cpu",
        max_slots=MAX_SLOTS, max_seq_len=MAX_SEQ, **kw))


@pytest.fixture(scope="module")
def servers(weights):
    jcfg, jparams, tcfg, tparams = weights
    jax_srv = torch_srv = None
    try:
        jax_srv = _JaxServer(jax_create_server(
            jcfg, jparams, max_slots=MAX_SLOTS, max_seq_len=MAX_SEQ,
            max_queue=MAX_QUEUE))
        torch_srv = _torch_server(tcfg, tparams, max_queue=MAX_QUEUE)
        yield jax_srv, torch_srv
    finally:
        for s in (torch_srv, jax_srv):
            if s is not None:
                s.close()


def _call(base, path, body=None, headers=None, raw=None):
    """(status, headers, text) of one HTTP call."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(
        base + path, data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.headers, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode()


def _both(servers, path, body=None, headers=None, raw=None):
    return [_call(s.base, path, body, headers, raw) for s in servers]


def _stable(payload):
    return {k: v for k, v in payload.items() if k not in ("id", "created")}


GREEDY = {"temperature": 0}

BODIES = {
    "completion": ("/v1/completions",
                   {"prompt": "the kernel serves a token", "max_tokens": 8,
                    **GREEDY}),
    "completion_long_prompt": ("/v1/completions",
                               {"prompt": "abc " * 9, "max_tokens": 12,
                                **GREEDY}),
    "completion_defaults_max_tokens": ("/v1/completions",
                                       {"prompt": "hi", **GREEDY}),
    "chat": ("/v1/chat/completions",
             {"messages": [{"role": "system", "content": "be brief"},
                           {"role": "user", "content": "hi"}],
              "max_tokens": 6, **GREEDY}),
    "multi_prompt": ("/v1/completions",
                     {"prompt": ["a", "bb cc", "a much longer prompt here"],
                      "max_tokens": 5, **GREEDY}),
    "past_the_window": ("/v1/completions",
                        {"prompt": "x" * 50, "max_tokens": 30, **GREEDY}),
}


@pytest.mark.parametrize("case", sorted(BODIES))
def test_greedy_json_matches_jax_server(servers, case):
    path, body = BODIES[case]
    (js, jh, jt), (ts, th, tt) = _both(servers, path, body,
                                       {"X-Request-Id": f"rid-{case}"})
    assert js == ts == 200, (jt, tt)
    assert jh["X-Request-Id"] == th["X-Request-Id"] == f"rid-{case}"
    jp, tp = json.loads(jt), json.loads(tt)
    assert _stable(tp) == _stable(jp)
    assert tp["id"].startswith("cmpl-")


def _sse(text):
    events = [line[len("data: "):] for line in text.split("\n")
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def _streamed(chunks, chat):
    """Per choice: (concatenated text, finish reasons in order, number of
    role announcements)."""
    out = {}
    for c in chunks:
        ch = c["choices"][0]
        text, finishes, roles = out.get(ch["index"], ("", [], 0))
        if chat:
            text += ch["delta"].get("content", "")
            roles += "role" in ch["delta"]
        else:
            text += ch["text"]
        if ch["finish_reason"] is not None:
            finishes = finishes + [ch["finish_reason"]]
        out[ch["index"]] = (text, finishes, roles)
    return out


@pytest.mark.parametrize("case", ["completion", "chat", "multi_prompt"])
def test_stream_matches_jax_server(servers, case):
    path, body = BODIES[case]
    chat = path.endswith("chat/completions")
    results = []
    for status, headers, text in _both(servers, path, {**body,
                                                       "stream": True}):
        assert status == 200
        assert headers["Content-Type"].startswith("text/event-stream")
        chunks = _sse(text)
        obj = "chat.completion.chunk" if chat else "text_completion"
        assert all(c["object"] == obj for c in chunks)
        results.append(_streamed(chunks, chat))
    assert results[1] == results[0]
    # The streamed text is the non-streamed answer's.
    _, _, plain = _call(servers[1].base, path, body)
    for i, choice in enumerate(json.loads(plain)["choices"]):
        text = choice["message"]["content"] if chat else choice["text"]
        assert results[1][i][:2] == (text, [choice["finish_reason"]])
        if chat:
            assert results[1][i][2] == 1   # the role, announced once


ERRORS = {
    "unknown_field": {"prompt": "x", "respose_format": {}},
    "malformed_sampling": {"prompt": "x", "temperature": "hot"},
    "max_tokens_0": {"prompt": "x", "max_tokens": 0},
    "missing_prompt": {"max_tokens": 3},
    "prompt_not_strings": {"prompt": [1, 2]},
    "nonpositive_timeout": {"prompt": "x", "timeout": -1},
    "adapter_without_pool": {"prompt": "x", "adapter": "tenant-a"},
    "adapter_not_string": {"prompt": "x", "adapter": 3},
    "response_format_grammar_off": {"prompt": "x",
                                    "response_format": {"type": "json"}},
    "bad_priority": {"prompt": "x", "priority": "urgent"},
    "over_the_queue_bound": {"prompt": ["a"] * (MAX_QUEUE + 1),
                             "max_tokens": 2},
}


def _error_of(text):
    err = json.loads(text)["error"]
    return err.get("type"), err.get("fields")


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_status_and_type_match_jax_server(servers, case):
    (js, jh, jt), (ts, th, tt) = _both(servers, "/v1/completions",
                                       ERRORS[case])
    assert js == ts and js in (400, 429), (js, jt, ts, tt)
    assert _error_of(tt) == _error_of(jt)
    if js == 429:
        assert _error_of(tt)[0] == "overloaded"
        assert th["Retry-After"] == jh["Retry-After"] == "1"


def test_bad_bodies_and_routes(servers):
    (js, _, _), (ts, _, _) = _both(servers, "/v1/completions",
                                   raw=b"{not json")
    assert js == ts == 400
    (js, _, _), (ts, _, tt) = _both(servers, "/v1/chat/completions", {})
    assert js == ts == 400 and "messages" in tt
    (js, _, jt), (ts, _, tt) = _both(servers, "/")
    assert js == ts == 200
    assert (json.loads(tt).keys() == json.loads(jt).keys()
            == {"status", "model", "uptime_s"})
    assert json.loads(tt)["model"] == "debug"
    assert _call(servers[1].base, "/healthz")[0] == 200
    # A prompt too short to cache registers nothing, on both servers.
    (js, _, jt), (ts, _, tt) = _both(servers, "/v1/prefix", {"prompt": "x"})
    assert js == ts == 200
    assert json.loads(tt) == json.loads(jt) == {"cached_prefix_len": 0}
    (js, jh, jt), (ts, th, tt) = _both(servers, "/metrics")
    assert js == ts == 200
    assert th["Content-Type"] == jh["Content-Type"] == \
        "text/plain; version=0.0.4; charset=utf-8"
    assert "serve_requests_total" in parse_exposition(tt)


def test_traceparent_becomes_request_id(servers):
    trace = "0af7651916cd43dd8448eb211c80319c"
    tp = f"00-{trace}-b7ad6b7169203331-01"
    (_, jh, _), (_, th, _) = _both(
        servers, "/v1/completions", {"prompt": "x", "max_tokens": 1},
        {"traceparent": tp})
    assert th["X-Request-Id"] == jh["X-Request-Id"] == trace
    for h in (jh, th):
        parts = h["traceparent"].split("-")
        assert parts[1] == trace and parts[2] != "b7ad6b7169203331"
    (_, jh, _), (_, th, _) = _both(
        servers, "/v1/completions", {"prompt": "x", "max_tokens": 1},
        {"X-Request-Id": "bad id;<x>"})
    assert th["X-Request-Id"] == jh["X-Request-Id"] == "badidx"


def test_draining_answers_503(weights):
    jcfg, jparams, tcfg, tparams = weights
    jax_srv = _JaxServer(jax_create_server(jcfg, jparams, max_slots=2,
                                           max_seq_len=MAX_SEQ))
    torch_srv = _torch_server(tcfg, tparams)
    try:
        jax_srv.app["worker"].drain(0)
        torch_srv.srv.worker.drain(0)
        (js, jh, jt), (ts, th, tt) = _both(
            (jax_srv, torch_srv), "/v1/completions", {"prompt": "x"})
        assert js == ts == 503
        assert _error_of(tt) == _error_of(jt) == ("draining", None)
        assert th["Retry-After"] == jh["Retry-After"] == "5"
    finally:
        torch_srv.close()
        jax_srv.close()


# ---------------------------------------------------------------------------
# Engine-level QoS against the JAX engine
# ---------------------------------------------------------------------------

CLASSES = ["batch", "standard", "interactive", "batch", "standard",
           "interactive", "batch", "interactive", "standard"]


def _admission_trace(engine, request_cls, overloaded):
    trace = []
    for i, cls in enumerate(CLASSES):
        try:
            engine.submit(request_cls(prompt_tokens=[1, 2, 3], max_tokens=2,
                                      priority=cls, request_id=str(i)))
            trace.append(("ok", engine.retry_after_hint()))
        except overloaded as exc:
            trace.append((str(exc), engine.retry_after_hint()))
    return trace, [r.request_id for r in engine.queue]


@pytest.mark.parametrize("shares", [None, {"batch": 0.25},
                                    {"interactive": 0.5, "batch": 0.1}])
def test_priority_order_and_retry_hint_match_jax_engine(weights, shares):
    jcfg, jparams, tcfg, tparams = weights
    jeng = JaxEngine(jcfg, jparams, max_slots=2, max_seq_len=MAX_SEQ,
                     max_queue=8, queue_shares=shares)
    teng = InferenceEngine(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ,
                           max_queue=8, queue_shares=shares)
    assert (_admission_trace(teng, Request, EngineOverloaded)
            == _admission_trace(jeng, JaxRequest, JaxOverloaded))
    assert teng._class_bounds == jeng._class_bounds


@pytest.mark.parametrize("shares", [{"urgent": 0.5}, {"batch": 0.0},
                                    {"batch": 1.5}])
def test_bad_queue_shares_raise_like_jax_engine(weights, shares):
    jcfg, jparams, tcfg, tparams = weights
    with pytest.raises(ValueError) as jexc:
        JaxEngine(jcfg, jparams, max_slots=2, max_seq_len=MAX_SEQ,
                  queue_shares=shares)
    with pytest.raises(ValueError) as texc:
        InferenceEngine(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ,
                        queue_shares=shares)
    assert str(texc.value) == str(jexc.value)


def test_warmup_resets_and_keeps_the_sampling_stream(weights):
    _, _, tcfg, tparams = weights
    outs = []
    for warm in (False, True):
        eng = InferenceEngine(tcfg, tparams, max_slots=2,
                              max_seq_len=MAX_SEQ, seed=5)
        if warm:
            eng.warmup()
            assert not eng.active.any() and not eng.queue
        reqs = [Request(prompt_tokens=[5, 9, 17], max_tokens=6,
                        temperature=t) for t in (0.0, 0.9)]
        eng.generate(reqs)
        outs.append([r.output_tokens for r in reqs])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# The port's worker: crash containment and graceful drain
# ---------------------------------------------------------------------------

def test_worker_contains_a_failed_step(weights):
    _, _, tcfg, tparams = weights
    engine = InferenceEngine(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ)
    worker = api.EngineWorker(engine)
    try:
        armed = {"on": True}
        step = engine.step

        def exploding_step():
            if armed["on"]:
                armed["on"] = False
                raise EngineStepFailed("synthetic device failure")
            return step()

        engine.step = exploding_step
        futs = worker.submit_many([Request(prompt_tokens=[1, 2],
                                           max_tokens=3) for _ in range(3)])
        for fut in futs:
            with pytest.raises(EngineStepFailed, match="synthetic device"):
                fut.result(timeout=HTTP_TIMEOUT)
        done = worker.submit(Request(prompt_tokens=[1, 2], max_tokens=3)
                             ).result(timeout=HTTP_TIMEOUT)
        assert len(done.output_tokens) == 3
        # The reset dropped the doomed requests: only the last one ran.
        assert not engine.queue and engine.prefill_dispatches == 1
    finally:
        worker.stop()
    assert not worker._thread.is_alive()


def test_engine_failure_answers_500(weights):
    _, _, tcfg, tparams = weights
    srv = _torch_server(tcfg, tparams)
    try:
        engine = srv.srv.worker.engine
        step = engine.step

        def failing_step():
            engine.step = step
            raise RuntimeError("synthetic device failure")

        engine.step = failing_step
        status, _, text = _call(srv.base, "/v1/completions",
                                {"prompt": "x", "max_tokens": 2})
        assert status == 500 and "synthetic device failure" in text
        assert _call(srv.base, "/v1/completions",
                     {"prompt": "x", "max_tokens": 2})[0] == 200
    finally:
        srv.close()


def test_shutdown_drains_in_flight_requests(weights):
    _, _, tcfg, tparams = weights
    srv = _torch_server(tcfg, tparams)
    results = {}
    slow_step = srv.srv.worker.engine.step
    started = threading.Event()

    def step():
        # Slow enough that both requests are still decoding when the
        # drain starts.
        started.set()
        time.sleep(0.05)
        return slow_step()

    srv.srv.worker.engine.step = step

    def client(name, body):
        results[name] = _call(srv.base, "/v1/completions", body)

    body = {"prompt": "drain me", "max_tokens": 40, **GREEDY}
    streaming = threading.Thread(target=client,
                                 args=("stream", {**body, "stream": True}))
    plain = threading.Thread(target=client, args=("plain", body))
    streaming.start()
    plain.start()
    assert started.wait(HTTP_TIMEOUT)
    # The first step starts once one request is in; the drain may begin
    # only when the worker holds both.
    worker = srv.srv.worker
    deadline = time.monotonic() + HTTP_TIMEOUT
    while time.monotonic() < deadline:
        with worker._lock:
            if len(worker._pending) + len(worker._inflight) == 2:
                break
        time.sleep(0.01)
    closer = threading.Thread(target=srv.close)
    closer.start()
    deadline = time.monotonic() + HTTP_TIMEOUT
    while not srv.srv.worker._draining and time.monotonic() < deadline:
        time.sleep(0.01)
    status, _, text = _call(srv.base, "/v1/completions", body)
    assert status == 503 and _error_of(text) == ("draining", None)
    for t in (streaming, plain, closer):
        t.join(timeout=HTTP_TIMEOUT)
        assert not t.is_alive()
    assert results["plain"][0] == 200
    assert json.loads(results["plain"][2])["usage"]["completion_tokens"] \
        in range(1, 41)
    assert results["stream"][0] == 200
    chunks = _sse(results["stream"][2])
    assert chunks[-1]["choices"][0]["finish_reason"] in ("length", "stop")


# mesh_tensor is ported; what stays refused under it (quantized weights
# here) is refused by name with it.
@pytest.mark.parametrize("knob", [{"mesh_data": 2},
                                  {"mesh_tensor": 2, "quantize": "int8"}])
def test_main_refuses_unported_knobs_by_name(tmp_path, monkeypatch, knob):
    (tmp_path / "params.json").write_text(json.dumps({"model": "debug",
                                                      **knob}))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    name = next(iter(knob)).replace("kvPaging", "kv_paging")
    with pytest.raises(NotImplementedError, match=name):
        api.main()


@pytest.mark.parametrize("knob", [
    {"speculative": "ngram", "draft_tokens": 4, "ngram_max": 3},
    {"grammar": "on", "grammar_cache_size": 8},
    {"kv_paging": "paged", "page_size": 16, "num_pages": 64},
    {"kvPaging": True, "kv_host_pages": 8},
    {"kv_paging": "paged", "preemption": "swap"},
    {"kv_paging": "on", "kvHostPages": 64, "preemption": "swap"},
    {"adapter_pool": 2, "lora_rank": 16, "adapter_dir": "/srv/adapters"}],
    ids=["speculative", "grammar", "kv_paging", "kvPaging_host_pages",
         "preemption", "host_tier_and_preemption", "adapter_pool"])
def test_main_takes_ported_knobs(tmp_path, monkeypatch, knob):
    """Speculation, grammar, paging, the host tier, preemption and the
    adapter pool are ported: main passes them on and stops only where
    every CPU run of main stops, at the missing GPU."""
    params = {"model": "debug", **knob}
    (tmp_path / "params.json").write_text(json.dumps(params))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    api.refuse_unported(params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.main()


@pytest.mark.parametrize("knob,kv,mode", [
    ({"quantize_kv": True}, True, "none"),
    ({"quantizeKv": "on", "quantize": "int8"}, True, "int8"),
    ({"quantize": "int4", "quantize_kv": False}, False, "int4")])
def test_main_serves_quantize_and_quantize_kv(tmp_path, monkeypatch, knob,
                                              kv, mode):
    """main serves quantize and quantize_kv (no longer refused): the
    config it hands create_server carries them, and the engine create_server
    builds on it keeps the cache they ask for."""
    params = {"model": "debug", **knob}
    (tmp_path / "params.json").write_text(json.dumps(params))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    api.refuse_unported(params)
    load = api.load_model
    monkeypatch.setattr(api, "load_model",
                        lambda p: load(p, device="cpu"))
    got = {}

    class Stop(Exception):
        pass

    def fake_create_server(cfg, model_params, tokenizer, **kw):
        got.update(cfg=cfg, params=model_params, kw=kw)
        raise Stop

    monkeypatch.setattr(api, "create_server", fake_create_server)
    with pytest.raises(Stop):
        api.main()
    cfg = got["cfg"]
    assert (cfg.quantize_kv, cfg.quantize) == (kv, mode)
    eng = api.InferenceEngine(cfg, got["params"], max_slots=2,
                              max_seq_len=32)
    assert eng.cache.quantized is kv


def test_main_passes_speculation_and_grammar_knobs(tmp_path, monkeypatch):
    """The params' spellings reach create_server typed."""
    params = {"model": "debug", "speculative": "ngram", "draftTokens": 3,
              "ngram_max": 4, "ngramMin": 2, "grammar": "on",
              "grammarCacheSize": 8}
    (tmp_path / "params.json").write_text(json.dumps(params))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    got = {}

    class Stop(Exception):
        pass

    def fake_create_server(cfg, model_params, tokenizer, **kw):
        got.update(kw)
        raise Stop

    monkeypatch.setattr(api, "load_model", lambda p: ("cfg", "params"))
    monkeypatch.setattr(api, "create_server", fake_create_server)
    with pytest.raises(Stop):
        api.main()
    assert {k: got[k] for k in ("speculative", "draft_tokens", "ngram_max",
                                "ngram_min", "grammar",
                                "grammar_cache_size")} == {
        "speculative": "ngram", "draft_tokens": 3, "ngram_max": 4,
        "ngram_min": 2, "grammar": "on", "grammar_cache_size": 8}


def test_main_passes_adapter_pool_knobs(tmp_path, monkeypatch):
    """The pool's params spellings reach create_server typed."""
    params = {"model": "debug", "adapterPool": "3", "lorarank": 16,
              "adapter_dir": "/srv/adapters"}
    (tmp_path / "params.json").write_text(json.dumps(params))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    got = {}

    class Stop(Exception):
        pass

    def fake_create_server(cfg, model_params, tokenizer, **kw):
        got.update(kw)
        raise Stop

    monkeypatch.setattr(api, "load_model", lambda p: ("cfg", "params"))
    monkeypatch.setattr(api, "create_server", fake_create_server)
    with pytest.raises(Stop):
        api.main()
    assert {k: got[k] for k in ("adapter_pool", "lora_rank",
                                "adapter_dir")} == {
        "adapter_pool": 3, "lora_rank": 16, "adapter_dir": "/srv/adapters"}


def test_main_takes_knobs_that_are_off(tmp_path, monkeypatch):
    off = {"model": "debug", "kv_paging": "off", "speculative": "off",
           "grammar": "off", "adapter_pool": 0, "preemption": "off",
           "kv_host_pages": 0, "mesh_tensor": 1, "prefix_cache_size": 0}
    (tmp_path / "params.json").write_text(json.dumps(off))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    api.refuse_unported(off)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.main()


def test_main_passes_paging_knobs(tmp_path, monkeypatch):
    """The params' spellings of the paging knobs reach create_server
    typed; paging stays off unless asked for."""
    got = {}

    class Stop(Exception):
        pass

    def fake_create_server(cfg, model_params, tokenizer, **kw):
        got.update(kw)
        raise Stop

    monkeypatch.setattr(api, "load_model", lambda p: ("cfg", "params"))
    monkeypatch.setattr(api, "create_server", fake_create_server)
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    keys = ("kv_paging", "page_size", "num_pages", "kv_host_pages",
            "preemption")
    for params, want in (
            ({"kvPaging": "paged", "pageSize": 32, "numPages": "96",
              "kvHostPages": "128", "preemption": "swap"},
             (True, 32, 96, 128, "swap")),
            ({"kv_paging": "off"}, (False, 16, None, 0, "off"))):
        (tmp_path / "params.json").write_text(json.dumps(
            {"model": "debug", **params}))
        with pytest.raises(Stop):
            api.main()
        assert tuple(got[k] for k in keys) == want


def test_paged_server_answers_like_jax_paged(weights):
    """create_server(kv_paging=True, kv_host_pages=..., preemption="swap")
    on both sides: the same greedy completion with X-Priority:
    interactive, the same /v1/prefix registration through admission, the
    request carried at the header's class."""
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(kv_paging=True, kv_host_pages=8, preemption="swap")
    jax_srv = _JaxServer(jax_create_server(jcfg, jparams, max_slots=2,
                                           max_seq_len=MAX_SEQ, **kw))
    torch_srv = _TorchServer(api.create_server(
        tcfg, tparams, host="127.0.0.1", port=0, device="cpu", max_slots=2,
        max_seq_len=MAX_SEQ, **kw))
    engine = torch_srv.srv.worker.engine
    seen = []
    submit = engine.submit

    def recording_submit(req):
        seen.append(req.priority)
        submit(req)

    engine.submit = recording_submit
    try:
        assert type(engine).__name__ == "PagedInferenceEngine"
        assert engine.preemption == "swap" and engine.host_pool is not None
        body = {"prompt": "the kernel serves a token " * 2, "max_tokens": 8,
                **GREEDY}
        (js, _, jt), (ts, _, tt) = _both(
            (jax_srv, torch_srv), "/v1/completions", body,
            {"X-Priority": "interactive"})
        assert js == ts == 200
        assert _stable(json.loads(tt)) == _stable(json.loads(jt))
        assert seen == ["interactive"]
        prefix = {"tokens": list(range(1, 40))}
        (js, _, jt), (ts, _, tt) = _both((jax_srv, torch_srv),
                                         "/v1/prefix", prefix)
        assert js == ts == 200
        assert json.loads(tt) == json.loads(jt) == {"cached_prefix_len": 32}
        assert engine.has_prefix(prefix["tokens"])
    finally:
        torch_srv.close()
        jax_srv.close()


def test_paged_prefix_failure_resets_the_engine(weights):
    """A paged registration steps the engine; a step failure there fails
    the job (500) and every waiting request, and resets the engine, which
    then serves again."""
    _, _, tcfg, tparams = weights
    srv = _TorchServer(api.create_server(
        tcfg, tparams, host="127.0.0.1", port=0, device="cpu", max_slots=2,
        max_seq_len=MAX_SEQ, kv_paging=True))
    engine = srv.srv.worker.engine
    resets = []
    reset, prefill = engine.reset, engine._prefill_group_paged

    def counting_reset():
        resets.append(1)
        reset()

    def broken_prefill(*args):
        raise RuntimeError("device fault")

    engine.reset = counting_reset
    engine._prefill_group_paged = broken_prefill
    try:
        status, _, text = _call(srv.base, "/v1/prefix",
                                {"tokens": list(range(1, 40))})
        assert status == 500 and "prefix registration failed" in text
        # The job fails first; the worker then resets the engine.
        deadline = time.monotonic() + HTTP_TIMEOUT
        while not resets and time.monotonic() < deadline:
            time.sleep(0.01)
        assert resets == [1] and not engine.has_work()
        engine._prefill_group_paged = prefill
        status, _, _ = _call(srv.base, "/v1/completions",
                             {"prompt": "x", "max_tokens": 2, **GREEDY})
        assert status == 200
    finally:
        srv.close()
