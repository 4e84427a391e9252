"""The port's grammar-constrained output against the JAX package's.

- The compiler: for a bank of JSON schemas and EBNF texts, the port's
  ``GrammarCache`` builds the reference's token DFA (the same vocabulary
  fingerprint, number of states, transition table, accept and terminal
  flags, and mask row per state: all exact, integer and boolean arrays),
  raises the same ``GrammarError`` for unsupported constructs, and keeps
  the same LRU statistics.
- The engine, on the ``debug`` config at float32 with the reference's
  weights (models/bridge.py) and each package's byte tokenizer: greedy
  constrained outputs and finish reasons equal to the JAX engine's with
  speculation off and on; temperature sampling never emits a token its
  DFA state forbids; at ``decode_chunk=4`` a constrained slot takes one
  token per chunk and ends as it does step by step.
- HTTP: a ``response_format`` body gives the JAX server's JSON; an
  unsupported construct gives its 400.
"""

import asyncio
import json
import random
import threading
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
from runbooks_tpu.serve.grammar import GrammarCache as JaxGrammarCache
from runbooks_tpu.serve.grammar import GrammarError as JaxGrammarError
from runbooks_tpu.serve.grammar import TokenVocab as JaxTokenVocab
from runbooks_tpu.train.data import ByteTokenizer as JaxByteTokenizer

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.serve import api
from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
from runbooks_tpu_torch.serve.grammar import (
    GrammarCache,
    GrammarError,
    TokenVocab,
)
from runbooks_tpu_torch.train.data import ByteTokenizer

torch.set_num_threads(2)

MAX_SEQ = 64
HTTP_TIMEOUT = 120
TOK = ByteTokenizer()
EOS = TOK.eos_id


def _schema(schema):
    return {"type": "json_schema", "json_schema": {"schema": schema}}


SCHEMA_RF = _schema({
    "type": "object",
    "properties": {"ok": {"type": "boolean"}, "mode": {"enum": ["a", "b"]}},
    "required": ["ok", "mode"], "additionalProperties": False})

BANK = {
    "object_bool_enum": SCHEMA_RF,
    "object_nested": _schema({
        "type": "object",
        "properties": {
            "id": {"type": "integer"}, "score": {"type": "number"},
            "tags": {"type": "array", "items": {"type": "string"}},
            "meta": {"type": "object", "properties": {
                "k": {"const": "v"}, "n": {"type": "null"}},
                "required": ["k", "n"], "additionalProperties": False}},
        "required": ["id", "score", "tags", "meta"],
        "additionalProperties": False}),
    "array_min1": _schema({"type": "array", "items": {"enum": [1, True]},
                           "minItems": 1}),
    "openai_wrapper": {"type": "json_schema", "json_schema": {
        "name": "answer", "schema": {"type": "string"}}},
    "const_empty_object": _schema({"type": "object", "properties": {}}),
    "ebnf_list": {"type": "ebnf",
                  "grammar": 'root ::= "[" [0-9] ("," [0-9])* "]"'},
    "ebnf_rules": {"type": "ebnf", "grammar": (
        "# a signed integer, then a word\n"
        'root ::= sign? digit digit* " " word\n'
        "sign ::= '-' | '+'\n"
        "digit ::= [0-9]\n"
        'word ::= ("yes" | "no" | [a-c]+)\n')},
    "ebnf_escapes": {"type": "ebnf",
                     "grammar": 'root ::= "a\\"b" [\\-\\]x]? "\\n"'},
}

UNSUPPORTED = {
    "ref": _schema({"type": "object", "properties": {"a": {"$ref": "#/x"}},
                    "required": ["a"], "additionalProperties": False}),
    "oneOf": _schema({"oneOf": [{"type": "null"}]}),
    "pattern": _schema({"type": "string", "pattern": "a+"}),
    "open_object": _schema({"type": "object",
                            "properties": {"a": {"type": "null"}},
                            "additionalProperties": True}),
    "optional_property": _schema({
        "type": "object", "properties": {"a": {"type": "null"}},
        "required": [], "additionalProperties": False}),
    "minItems_2": _schema({"type": "array", "items": {"type": "null"},
                           "minItems": 2}),
    "union_type": _schema({"type": ["string", "null"]}),
    "unknown_type": _schema({"type": "frobnicate"}),
    "unknown_key": _schema({"type": "string", "frob": 1}),
    "json_object": {"type": "json_object"},
    "bad_type": {"type": "jsonschema"},
    "recursive_ebnf": {"type": "ebnf", "grammar": 'root ::= "(" root ")"'},
    "undefined_rule": {"type": "ebnf", "grammar": "root ::= missing"},
    "bad_escape": {"type": "ebnf", "grammar": 'root ::= "\\q"'},
    "unbalanced": {"type": "ebnf", "grammar": 'root ::= ("a"'},
}


def _caches(width, capacity=64):
    port = GrammarCache(TokenVocab.from_tokenizer(TOK), width,
                        capacity=capacity)
    ref = JaxGrammarCache(JaxTokenVocab.from_tokenizer(JaxByteTokenizer()),
                          width, capacity=capacity)
    return port, ref


# ---------------------------------------------------------------------------
# The compiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(BANK))
@pytest.mark.parametrize("width", [258, 512])
def test_dfa_equals_reference(name, width):
    port, ref = _caches(width)
    got, want = port.get(BANK[name]), ref.get(BANK[name])
    assert port.vocab.fingerprint == ref.vocab.fingerprint
    assert got.num_states == want.num_states
    assert got.masks.shape == (got.num_states, width)
    for attr in ("trans", "masks", "accept", "terminal"):
        np.testing.assert_array_equal(getattr(got, attr),
                                      getattr(want, attr), err_msg=attr)
    assert (got.eos_id, got.key) == (want.eos_id, want.key)


def test_dfa_at_full_vocab_width():
    """llama3's logit width: the columns past the byte tokenizer's
    vocabulary never move and are never allowed."""
    port, ref = _caches(128256)
    got, want = port.get(SCHEMA_RF), ref.get(SCHEMA_RF)
    np.testing.assert_array_equal(got.masks, want.masks)
    np.testing.assert_array_equal(got.trans, want.trans)
    assert not got.masks[:, 258:].any()


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_constructs_raise_as_reference(name):
    port, ref = _caches(258)
    with pytest.raises(JaxGrammarError) as want:
        ref.get(UNSUPPORTED[name])
    with pytest.raises(GrammarError) as got:
        port.get(UNSUPPORTED[name])
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_cursor_and_lru_match_reference():
    port, ref = _caches(258, capacity=2)
    rfs = [{"type": "ebnf", "grammar": f'root ::= "{c}"'} for c in "abc"]
    for i in (0, 0, 1, 2, 0, 2):
        port.get(rfs[i])
        ref.get(rfs[i])
    got, want = port.stats(), ref.stats()
    for key in ("size", "capacity", "hits", "misses",
                "tokenizer_fingerprint"):
        assert got[key] == want[key], key
    assert got["compile_seconds_total"] > 0
    with pytest.raises(ValueError, match="grammar_cache_size"):
        GrammarCache(port.vocab, 258, capacity=0)
    cur = port.cursor(SCHEMA_RF)
    for b in b'{"ok":true,"mode":"a"}':
        assert cur.legal(b) and cur.advance(b)
    assert cur.accepting and cur.at_terminal
    assert cur.mask_row()[EOS] and int(cur.mask_row().sum()) == 1
    before = cur.state
    assert not cur.advance(ord("x")) and cur.state == before


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("debug", dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tcfg = get_config("debug", dtype="float32")
    tparams = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


PROMPT = [int(b) for b in b"emit json: "]
ENGINE_RFS = [SCHEMA_RF, BANK["ebnf_list"], BANK["object_nested"],
              BANK["ebnf_rules"]]


def _text(req):
    return bytes(t for t in req.output_tokens if t < 256).decode()


def _constrained(cls, temperature=0.0, max_tokens=24, rfs=ENGINE_RFS):
    return [cls(prompt_tokens=list(PROMPT), max_tokens=max_tokens,
                temperature=temperature, eos_id=EOS, response_format=rf)
            for rf in rfs]


@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_greedy_constrained_outputs_equal_jax_engine(weights, spec):
    jcfg, jparams, tcfg, tparams = weights
    jeng = JaxEngine(jcfg, jparams, max_slots=4, max_seq_len=MAX_SEQ,
                     grammar="on", tokenizer=JaxByteTokenizer(),
                     speculative=spec)
    want = jeng.generate(_constrained(JaxRequest))
    eng = InferenceEngine(tcfg, tparams, max_slots=4, max_seq_len=MAX_SEQ,
                          grammar="on", tokenizer=TOK, speculative=spec)
    got = eng.generate(_constrained(Request))
    assert [r.output_tokens for r in got] == \
        [r.output_tokens for r in want]
    assert [r.finish_reason for r in got] == \
        [r.finish_reason for r in want]
    assert got[0].finish_reason == "grammar_complete"
    assert set(json.loads(_text(got[0]))) == {"ok", "mode"}
    stats = eng.grammar_stats()
    assert stats["mode"] == "on" and stats["requests_total"] == 4
    assert stats["completed_total"] == sum(
        r.finish_reason == "grammar_complete" for r in got)
    assert len(eng.grammar_mask_seconds) > 0


def _random_schema(rng, depth=0):
    leaves = [{"type": "boolean"}, {"type": "null"}, {"type": "integer"},
              {"enum": [rng.choice(["x", "y", 1, True])]},
              {"const": rng.choice([0, "k", False, None])}]
    if depth >= 2 or rng.random() < 0.4:
        return rng.choice(leaves)
    if rng.random() < 0.5:
        props = {f"p{i}": _random_schema(rng, depth + 1)
                 for i in range(rng.randint(1, 3))}
        return {"type": "object", "properties": props,
                "required": sorted(props), "additionalProperties": False}
    return {"type": "array", "items": _random_schema(rng, depth + 1),
            "minItems": rng.randint(0, 1)}


@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_temperature_sampling_is_never_illegal(weights, spec):
    _, _, tcfg, tparams = weights
    eng = InferenceEngine(tcfg, tparams, max_slots=4, max_seq_len=MAX_SEQ,
                          grammar="on", tokenizer=TOK, speculative=spec,
                          seed=1)
    rng = random.Random(0)
    rfs = [_schema(_random_schema(rng)) for _ in range(8)]
    reqs = eng.generate(_constrained(Request, temperature=1.5,
                                     max_tokens=40, rfs=rfs))
    check, _ = _caches(tcfg.vocab_size)
    for r in reqs:
        assert r.finish_reason in ("grammar_complete", "stop", "length")
        cur = check.cursor(r.response_format)
        for t in r.output_tokens:
            if t == EOS:
                assert cur.accepting
                break
            assert cur.advance(t), (r.response_format, _text(r), t)
        if r.finish_reason == "grammar_complete":
            json.loads(_text(r))


def test_constrained_slot_takes_one_token_per_chunk(weights):
    _, _, tcfg, tparams = weights
    step_by_step = InferenceEngine(tcfg, tparams, max_slots=2,
                                   max_seq_len=MAX_SEQ, grammar="on",
                                   tokenizer=TOK, decode_chunk=1)
    want = step_by_step.generate(_constrained(Request, rfs=[SCHEMA_RF]))[0]
    eng = InferenceEngine(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ,
                          grammar="on", tokenizer=TOK, decode_chunk=4)
    con = _constrained(Request, rfs=[SCHEMA_RF])[0]
    free = Request(prompt_tokens=list(PROMPT), max_tokens=13, eos_id=EOS)
    eng.submit(con)
    eng.submit(free)
    eng.step()     # the prefill's token, then one chunk
    assert (len(con.output_tokens), len(free.output_tokens)) == (2, 5)
    while not con.finished:
        n = len(con.output_tokens)
        eng.step()
        assert len(con.output_tokens) == n + 1
    assert con.output_tokens == want.output_tokens
    assert con.finish_reason == want.finish_reason == "grammar_complete"
    assert free.finished and len(free.output_tokens) == 13


def test_grammar_settings_are_validated(weights):
    _, _, tcfg, tparams = weights
    with pytest.raises(ValueError, match="grammar"):
        InferenceEngine(tcfg, tparams, max_slots=1, grammar="maybe")
    with pytest.raises(ValueError, match="tokenizer"):
        InferenceEngine(tcfg, tparams, max_slots=1, grammar="on")
    off = InferenceEngine(tcfg, tparams, max_slots=1)
    with pytest.raises(ValueError, match="grammar: on"):
        off.submit(Request(prompt_tokens=[1, 2], response_format=SCHEMA_RF))
    assert off.grammar_stats() == {"mode": "off"}
    on = InferenceEngine(tcfg, tparams, max_slots=1, grammar="on",
                         tokenizer=TOK)
    with pytest.raises(ValueError, match="unsupported schema construct"):
        on.submit(Request(prompt_tokens=[1, 2],
                          response_format=UNSUPPORTED["oneOf"]))
    assert not on.queue


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

CHAT = [{"role": "user", "content": "emit json"}]
HTTP_BODIES = {
    "completion": ("/v1/completions", {
        "prompt": "emit json: ", "max_tokens": 32, "temperature": 0,
        "response_format": SCHEMA_RF}),
    "chat": ("/v1/chat/completions", {
        "messages": CHAT, "max_tokens": 32, "temperature": 0,
        "response_format": BANK["ebnf_list"]}),
    "unsupported": ("/v1/completions", {
        "prompt": "x", "response_format": UNSUPPORTED["pattern"]}),
}


def _jax_answers(weights):
    jcfg, jparams, _, _ = weights
    from aiohttp.test_utils import TestClient, TestServer

    app = jax_create_server(jcfg, jparams, tokenizer=JaxByteTokenizer(),
                            max_slots=2, max_seq_len=MAX_SEQ, grammar="on",
                            speculative="ngram")

    async def drive():
        out = {}
        async with TestClient(TestServer(app)) as client:
            for name, (path, body) in HTTP_BODIES.items():
                r = await client.post(path, json=body)
                out[name] = (r.status, await r.json())
        return out

    return asyncio.run(drive())


def _post(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _comparable(payload):
    return {k: v for k, v in payload.items()
            if k not in ("id", "created")}


def test_http_response_format_matches_jax_server(weights):
    _, _, tcfg, tparams = weights
    want = _jax_answers(weights)
    srv = api.create_server(tcfg, tparams, host="127.0.0.1", port=0,
                            device="cpu", max_slots=2, max_seq_len=MAX_SEQ,
                            grammar="on", speculative="ngram")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        got = {name: _post(base, path, body)
               for name, (path, body) in HTTP_BODIES.items()}
        path, body = HTTP_BODIES["completion"]
        _, stream = _post(base, path, {**body, "stream": True})
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
    for name in ("completion", "chat"):
        status, text = got[name]
        assert status == want[name][0] == 200
        assert _comparable(json.loads(text)) == _comparable(want[name][1])
    assert json.loads(got["completion"][1])["choices"][0][
        "finish_reason"] == "grammar_complete"
    status, text = got["unsupported"]
    assert status == want["unsupported"][0] == 400
    assert json.loads(text) == want["unsupported"][1]
    assert "pattern" in json.loads(text)["error"]["message"]
    events = [ln[6:] for ln in stream.split("\n") if ln.startswith("data: ")]
    chunks = [json.loads(e)["choices"][0] for e in events[:-1]]
    assert events[-1] == "[DONE]"
    assert chunks[-1]["finish_reason"] == "grammar_complete"
    assert "".join(c["text"] for c in chunks) == \
        json.loads(got["completion"][1])["choices"][0]["text"]
