"""The port's shared-prefix KV cache against the JAX package's.

Both engines serve the ``debug`` config at float32 with the reference's
``init_params`` weights (carried over by models/bridge.py). With a
registered prefix, requests prefill only their suffix over the prefix's
cached K/V; their greedy tokens must equal the JAX engine's with the same
prefix and both engines' without any prefix, and the reuse counters
(``prefix_tokens_reused``, ``prefix_lookups``, ``prefix_hits``) and the
LRU's order must be the JAX engine's. Over HTTP, ``/v1/prefix`` answers
the JAX server's statuses and lengths, and ``auto_prefix_chat`` reuses
each chat turn's K/V in the next as the JAX server does.
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
from runbooks_tpu.serve.engine import InferenceEngine as JaxEngine
from runbooks_tpu.serve.engine import Request as JaxRequest

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.serve import api
from runbooks_tpu_torch.serve.engine import (
    EngineStepFailed,
    InferenceEngine,
    Request,
    auto_prefix_plens,
)

torch.set_num_threads(2)

MAX_SEQ = 64
HTTP_TIMEOUT = 120
PREFIX = [int(t) for t in np.random.default_rng(0).integers(1, 512, 16)]


def _weights(impl):
    jcfg = jax_get_config("debug", dtype="float32", attention_impl=impl)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tcfg = get_config("debug", dtype="float32", attention_impl=impl)
    tparams = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def weights():
    return _weights("xla")


def _counters(eng):
    return (eng.prefix_tokens_reused, eng.prefix_lookups, eng.prefix_hits)


def _register(eng, tokens):
    """register_prefix on either engine; the JAX one without its per-shape
    compile sweep, which these tests do not need."""
    if isinstance(eng, JaxEngine):
        return eng.register_prefix(tokens, warmup=False)
    return eng.register_prefix(tokens)


def _run(weights, jax_side, prompts, prefixes=(), max_slots=4,
         max_tokens=8):
    """(greedy outputs, counters, engine) of one engine with ``prefixes``
    registered before the requests."""
    jcfg, jparams, tcfg, tparams = weights
    if jax_side:
        eng = JaxEngine(jcfg, jparams, max_slots=max_slots,
                        max_seq_len=MAX_SEQ)
        req = JaxRequest
    else:
        eng = InferenceEngine(tcfg, tparams, max_slots=max_slots,
                              max_seq_len=MAX_SEQ)
        req = Request
    for p in prefixes:
        _register(eng, p)
    reqs = [req(prompt_tokens=list(p), max_tokens=max_tokens)
            for p in prompts]
    eng.generate(reqs)
    return [r.output_tokens for r in reqs], _counters(eng), eng


# The flash case runs the reference's Pallas kernel in interpret mode and
# the port's plain version of K1 on the suffix rows at offset positions.
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_reuse_equals_full_prefill_and_jax(impl):
    w = _weights(impl)
    prompts = [PREFIX + s for s in ([7, 9], [11], [3, 5, 8, 13], [2] * 20)]
    want, none, _ = _run(w, False, prompts)
    got, counters, eng = _run(w, False, prompts, [PREFIX])
    jgot, jcounters, _ = _run(w, True, prompts, [PREFIX])
    assert got == want == jgot
    assert none == (0, 4, 0)
    assert counters == jcounters == (16 * 4, 4, 4)
    # The cached K/V are the prefix's own slots of a full prefill.
    pk, pv = eng._prefix_cache[tuple(PREFIX)]
    assert pk.shape == (2, 16, 2, 32) and pk.dtype == torch.float32
    if impl == "xla":
        jwant, _, _ = _run(w, True, prompts)
        assert jwant == want


def test_register_rounds_and_lru_evicts_like_jax(weights):
    engines = [_run(weights, side, [], max_slots=2)[2]
               for side in (False, True)]
    results = []
    for eng in engines:
        out = [_register(eng, [1, 2, 3]),
               _register(eng, list(range(1, 20))),
               _register(eng, list(range(1, 20))),
               len(eng._prefix_cache),
               eng.has_prefix(list(range(1, 20))),
               eng.has_prefix([1, 2, 3]),
               eng.prefix_cache_size,
               # Long prompts leave 16 tokens to prefill.
               eng._prefix_len_for(63), eng._prefix_len_for(50, True)]
        for i in range(eng.prefix_cache_size + 1):
            out.append(_register(eng, [100 + i] * 16))
        out.append([k[0] for k in eng._prefix_cache])
        results.append(out)
    assert results[0] == results[1]
    assert results[0][:9] == [0, 16, 16, 1, True, False, 4, 48, 32]
    assert len(engines[0]._prefix_cache) == engines[0].prefix_cache_size
    assert auto_prefix_plens(engines[0].prefill_buckets, MAX_SEQ) == [16, 32]


def test_prefix_cache_size_knob(weights):
    _, _, tcfg, tparams = weights
    eng = InferenceEngine(tcfg, tparams, max_slots=8, max_seq_len=MAX_SEQ)
    assert eng.prefix_cache_size == 16
    eng = InferenceEngine(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ,
                          prefix_cache_size=1)
    for p in ([5] * 16, [6] * 16):
        eng.register_prefix(p)
    assert list(eng._prefix_cache) == [tuple([6] * 16)]


def test_prefix_mixed_with_plain_requests(weights):
    prefix = list(range(2, 18))
    prompts = [prefix + [40, 41], [9, 8, 7], prefix + [50],
               list(range(2, 16))]
    want, _, _ = _run(weights, False, prompts, max_tokens=6)
    got, counters, _ = _run(weights, False, prompts, [prefix], max_tokens=6)
    jgot, jcounters, _ = _run(weights, True, prompts, [prefix],
                              max_tokens=6)
    assert got == want == jgot
    assert counters == jcounters == (32, 4, 2)


def test_longest_matching_prefix_wins(weights):
    short, long_ = list(range(2, 18)), list(range(2, 34))
    prompts = [long_ + [7], short + [9, 9], long_ + list(range(40, 60))]
    want, _, _ = _run(weights, False, prompts)
    got, counters, _ = _run(weights, False, prompts, [short, long_])
    jgot, jcounters, _ = _run(weights, True, prompts, [short, long_])
    assert got == want == jgot
    assert counters == jcounters == (32 + 16 + 32, 3, 3)


def test_register_prefix_from_slot_like_jax(weights):
    turn1 = list(range(2, 20))            # 18 tokens: bucket 16 cached
    turn2 = turn1 + [30, 31, 32]
    (want,), _, _ = _run(weights, False, [turn2], max_slots=2,
                         max_tokens=6)
    out = []
    for side in (False, True):
        _, _, eng = _run(weights, side, [turn1], max_slots=2, max_tokens=4)
        first_slot = 0
        plen = eng.register_prefix_from_slot(first_slot, turn1)
        again = eng.register_prefix_from_slot(first_slot, turn1)
        req = (JaxRequest if side else Request)(prompt_tokens=turn2,
                                                max_tokens=6)
        eng.generate([req])
        out.append((plen, again, req.output_tokens, _counters(eng)))
    assert out[0] == out[1]
    assert out[0][:3] == (16, 0, want)
    assert out[0][3] == (16, 2, 1)


def test_slot_of_a_finished_request(weights):
    _, _, eng = _run(weights, False, [[1, 2, 3], [4, 5]], max_slots=2)
    req = Request(prompt_tokens=[6, 7], max_tokens=2)
    assert req._slot == -1
    eng.generate([req])
    assert req._slot in (0, 1)


def test_prefix_in_use_survives_eviction_pressure(weights):
    hot = list(range(2, 18))
    out = []
    for side in (False, True):
        _, _, eng = _run(weights, side, [], [hot], max_slots=2)
        req_cls = JaxRequest if side else Request
        toks = []
        for i in range(eng.prefix_cache_size):
            r = req_cls(prompt_tokens=hot + [30 + i], max_tokens=2)
            eng.generate([r])
            toks.append(r.output_tokens)
            _register(eng, [100 + i] * 16)
        out.append((toks, _counters(eng), [k[0] for k in eng._prefix_cache]))
        assert tuple(hot) in eng._prefix_cache, "the hot prefix was evicted"
    assert out[0] == out[1]
    assert out[0][1][0] == 16 * 4


def test_reset_keeps_registered_prefixes(weights):
    _, _, tcfg, tparams = weights
    eng = InferenceEngine(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ)
    eng.register_prefix(PREFIX)
    kv = eng._prefix_cache[tuple(PREFIX)]
    eng.reset()
    assert eng._prefix_cache[tuple(PREFIX)] is kv
    assert kv[0].data_ptr() != eng.cache.k.data_ptr()


def _recording_prefill(eng, record):
    """Wrap eng._prefill: record[prompt] = the last-position logits of each
    real row (padding rows sit at the trash slot)."""
    prefill = eng._prefill

    def wrapped(params, pool, tokens, positions, slots, last_pos, *args,
                **kw):
        first, pool, logits = prefill(params, pool, tokens, positions, slots,
                                      last_pos, *args, **kw)
        prefix = kw.get("prefix")
        head = list(PREFIX) if prefix is not None else []
        assert prefix is None or prefix[0].shape[1] == len(PREFIX)
        for r, last in enumerate(last_pos.tolist()):
            if int(positions[r, 0]) != eng._pad_slot:
                row = head + tokens[r, :last + 1].tolist()
                record[tuple(row)] = logits[r].clone()
        return first, pool, logits

    eng._prefill = wrapped


def test_engine_suffix_prefill_logits_equal_full_prefill(weights):
    """The engine's own first-token logits with the prefix spliced (rows
    of a burst and a lone row) against its full prefill, within 1e-5 at
    f32."""
    _, _, tcfg, tparams = weights
    prompts = [PREFIX + s for s in ([7, 9], [11], [3, 5, 8, 13], [2] * 20)]
    got = {}
    for with_prefix in (False, True):
        record = {}
        eng = InferenceEngine(tcfg, tparams, max_slots=4, max_seq_len=MAX_SEQ)
        if with_prefix:
            eng.register_prefix(PREFIX)
        _recording_prefill(eng, record)
        eng.generate([Request(prompt_tokens=p, max_tokens=2)
                      for p in prompts])
        eng.generate([Request(prompt_tokens=prompts[0], max_tokens=2)])
        assert sorted(record) == sorted(tuple(p) for p in prompts)
        assert eng.prefix_hits == (5 if with_prefix else 0)
        got[with_prefix] = record
    for p in got[True]:
        torch.testing.assert_close(got[True][p], got[False][p], rtol=0,
                                   atol=1e-5)


def test_warmup_covers_the_prefix_paths_shapes(weights, monkeypatch):
    """Every forward the prefix path launches (the prefix build, suffix
    prefills of one row and of a burst, their decode) has a shape that
    warmup() already ran: warm_prefix needs no warming of its own."""
    from runbooks_tpu_torch.serve import engine as engine_mod

    _, _, tcfg, tparams = weights
    shapes = set()
    forward = engine_mod.forward

    def recording(cfg, params, tokens, **kw):
        cache = kw.get("cache")
        shapes.add((tuple(tokens.shape),
                    None if cache is None else tuple(cache.k.shape),
                    kw.get("cache_view")))
        return forward(cfg, params, tokens, **kw)

    monkeypatch.setattr(engine_mod, "forward", recording)
    eng = InferenceEngine(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ)
    eng.warmup()
    warmed, shapes = shapes, set()
    eng.register_prefix(PREFIX)
    eng.register_prefix(list(range(1, 40)))
    eng.generate([Request(prompt_tokens=PREFIX + [5], max_tokens=3)])
    eng.generate([Request(prompt_tokens=list(range(1, 40)) + [9] * 20,
                          max_tokens=3),
                  Request(prompt_tokens=PREFIX + [6, 7], max_tokens=3)])
    assert eng.prefix_hits == 3
    assert shapes and shapes <= warmed, shapes - warmed


# ---------------------------------------------------------------------------
# Over HTTP, against the JAX server
# ---------------------------------------------------------------------------

class _JaxServer:
    """The JAX app under aiohttp's test server on a loop of its own."""

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

        self.client = asyncio.run_coroutine_threadsafe(
            start(), self.loop).result(HTTP_TIMEOUT)
        self.base = str(self.client.make_url("")).rstrip("/")
        self.engine = app["worker"].engine

    def close(self):
        try:
            asyncio.run_coroutine_threadsafe(
                self.client.close(), self.loop).result(HTTP_TIMEOUT)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=30)
            self.loop.close()


class _TorchServer:
    def __init__(self, tcfg, tparams, **kw):
        self.srv = api.create_server(tcfg, tparams, host="127.0.0.1",
                                     port=0, device="cpu", **kw)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.srv.port}"
        self.engine = self.srv.worker.engine

    def close(self):
        self.srv.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _call(base, path, body=None, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


PREFIX_BODIES = [
    ("tokens", {"tokens": list(range(2, 22))}),
    ("tokens_again", {"tokens": list(range(2, 22))}),
    ("prompt_text", {"prompt": "You are a terse assistant. " * 2}),
    ("too_short", {"tokens": [1, 2, 3]}),
    ("empty_tokens", {"tokens": []}),
    ("tokens_not_ints", {"tokens": "nope"}),
    ("token_floats", {"tokens": [1.5, 2.0]}),
    ("prompt_not_string", {"prompt": 3}),
    ("neither", {}),
]


def test_prefix_endpoint_matches_jax_server(weights):
    jcfg, jparams, tcfg, tparams = weights
    jax_srv = _JaxServer(jax_create_server(jcfg, jparams, max_slots=2,
                                           max_seq_len=MAX_SEQ))
    torch_srv = _TorchServer(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ)
    try:
        for name, body in PREFIX_BODIES:
            (js, jp), (ts, tp) = [_call(s.base, "/v1/prefix", body)
                                  for s in (jax_srv, torch_srv)]
            assert js == ts, (name, jp, tp)
            if js == 200:
                assert tp == jp, name
            else:
                assert js == 400 and "error" in tp, name
        assert [_call(s.base, "/v1/prefix", raw=b"{no")[0]
                for s in (jax_srv, torch_srv)] == [400, 400]
        assert _call(torch_srv.base, "/v1/prefix",
                     {"tokens": [1, 512]})[0] == 400
        assert list(torch_srv.engine._prefix_cache) \
            == list(jax_srv.engine._prefix_cache)
        # Completions starting with a registered prefix reuse it, and
        # answer what the JAX server answers.
        body = {"prompt": "You are a terse assistant. " * 2 + "Hi!",
                "max_tokens": 6, "temperature": 0}
        (js, jp), (ts, tp) = [_call(s.base, "/v1/completions", body)
                              for s in (jax_srv, torch_srv)]
        assert js == ts == 200
        assert tp["choices"] == jp["choices"]
        assert _counters(torch_srv.engine) == _counters(jax_srv.engine)
        assert torch_srv.engine.prefix_tokens_reused == 48
    finally:
        torch_srv.close()
        jax_srv.close()


def test_prefix_endpoint_503_and_504(weights, monkeypatch):
    _, _, tcfg, tparams = weights
    srv = _TorchServer(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ)
    try:
        engine = srv.engine
        register = engine.register_prefix

        def stalled(tokens):
            time.sleep(1.0)
            return register(tokens)

        monkeypatch.setattr(api, "_GENERATION_TIMEOUT_S", 0.2)
        engine.register_prefix = stalled
        status, payload = _call(srv.base, "/v1/prefix", {"tokens": PREFIX})
        assert status == 504 and "timed out" in payload["error"]["message"]
        monkeypatch.setattr(api, "_GENERATION_TIMEOUT_S", HTTP_TIMEOUT)
        engine.register_prefix = register
        srv.srv.worker.stop()
        status, payload = _call(srv.base, "/v1/prefix", {"tokens": PREFIX})
        assert status == 503 and "stopped" in payload["error"]["message"]
    finally:
        srv.close()


def test_failed_step_fails_queued_prefix_jobs(weights):
    _, _, tcfg, tparams = weights
    engine = InferenceEngine(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ)
    worker = api.EngineWorker(engine)
    try:
        assert worker.register_prefix(PREFIX).result(HTTP_TIMEOUT) == 16
        step = engine.step
        late = []

        def exploding_step():
            engine.step = step
            # A registration that arrives while the step runs.
            late.append(worker.register_prefix(list(range(3, 40))))
            raise EngineStepFailed("synthetic device failure")

        engine.step = exploding_step
        fut = worker.submit(Request(prompt_tokens=[1, 2], max_tokens=3))
        with pytest.raises(EngineStepFailed):
            fut.result(timeout=HTTP_TIMEOUT)
        with pytest.raises(EngineStepFailed):
            late[0].result(timeout=HTTP_TIMEOUT)
        # The reset kept the prefix registered before the failure.
        assert engine.has_prefix(PREFIX)
        done = worker.submit(Request(prompt_tokens=PREFIX + [5],
                                     max_tokens=3)).result(HTTP_TIMEOUT)
        assert len(done.output_tokens) == 3
        assert engine.prefix_tokens_reused == 16
    finally:
        worker.stop()
    assert not worker._thread.is_alive()


def test_failed_prefix_build_answers_500_not_503(weights):
    """A build that fails on the worker (out of device memory here) is an
    engine failure: 500, not the stopped worker's 503 that invites a
    retry into the same fault. The server keeps serving."""
    _, _, tcfg, tparams = weights
    srv = _TorchServer(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ)
    try:
        engine = srv.engine
        register = engine.register_prefix

        def out_of_memory(tokens):
            raise torch.OutOfMemoryError("synthetic: out of device memory")

        engine.register_prefix = out_of_memory
        status, payload = _call(srv.base, "/v1/prefix", {"tokens": PREFIX})
        assert status == 500
        assert "out of device memory" in payload["error"]["message"]
        engine.register_prefix = register
        assert _call(srv.base, "/v1/prefix", {"tokens": PREFIX}) == (
            200, {"cached_prefix_len": 16})
    finally:
        srv.close()


def _chat_turn(base, msgs, stream):
    """The assistant's text of one greedy chat turn."""
    body = {"messages": msgs, "max_tokens": 4, "temperature": 0.0,
            "stream": stream}
    req = urllib.request.Request(base + "/v1/chat/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
        assert r.status == 200
        text = r.read().decode()
    if not stream:
        return json.loads(text)["choices"][0]["message"]["content"]
    events = [ln[6:] for ln in text.split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return "".join(json.loads(e)["choices"][0]["delta"].get("content", "")
                   for e in events[:-1])


def _converse(srv, turns=3):
    """Three turns, the second streamed; each rendered prompt extends the
    one before."""
    msgs = [{"role": "system",
             "content": "Be concise and always answer in English."},
            {"role": "user", "content": "hello there"}]
    answers = []
    for turn in range(turns):
        text = _chat_turn(srv.base, msgs, stream=turn == 1)
        answers.append(text)
        msgs.append({"role": "assistant", "content": text})
        msgs.append({"role": "user", "content": f"and again {turn}"})
    return answers, _counters(srv.engine), list(srv.engine._prefix_cache)


def test_auto_prefix_chat_matches_jax_server(weights):
    jcfg, jparams, tcfg, tparams = weights
    results = {}
    for name, make in (
            ("jax_on", lambda: _JaxServer(jax_create_server(
                jcfg, jparams, max_slots=2, auto_prefix_chat=True))),
            ("torch_on", lambda: _TorchServer(tcfg, tparams, max_slots=2,
                                              auto_prefix_chat=True)),
            ("torch_off", lambda: _TorchServer(tcfg, tparams,
                                               max_slots=2))):
        srv = make()
        try:
            results[name] = _converse(srv)
        finally:
            srv.close()
    assert results["torch_on"] == results["jax_on"]
    assert results["torch_on"][0] == results["torch_off"][0]
    reused, lookups, hits = results["torch_on"][1]
    assert reused > 0 and hits == 2 and lookups == 3
    assert results["torch_off"][1] == (0, 3, 0)


@pytest.mark.parametrize("knob,kwarg,value", [
    ({"auto_prefix_chat": True}, "auto_prefix_chat", True),
    ({"warm_prefix": True}, "warm_prefix", True),
    ({"prefix_cache_size": 8}, "prefix_cache_size", 8)])
def test_main_passes_prefix_knobs(tmp_path, monkeypatch, weights, knob,
                                  kwarg, value):
    _, _, tcfg, tparams = weights
    (tmp_path / "params.json").write_text(json.dumps({"model": "debug",
                                                      **knob}))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    seen = {}

    class Stop(Exception):
        pass

    def fake_create_server(cfg, params, tokenizer, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(api, "load_model", lambda p: (tcfg, tparams))
    monkeypatch.setattr(api, "create_server", fake_create_server)
    with pytest.raises(Stop):
        api.main()
    assert seen[kwarg] == value
    defaults = {"auto_prefix_chat": False, "warm_prefix": False,
                "prefix_cache_size": None}
    assert {k: seen[k] for k in defaults if k != kwarg} == {
        k: v for k, v in defaults.items() if k != kwarg}
