"""The port's text path against the reference's, on the CPU: tokenizer
loading (raise and fallback), the trainer's batches under a tokenizer
directory, the Prefetcher, the Dataset loader Job, and chat completions
through the tokenizer's template against the JAX server (bridged
``debug`` weights with the vocab widened to cover the tokenizer). Two
faults of the reference that only a real tokenizer shows are checked as
the reference has them and as the port repairs them: the grammar's token
table built from ``decode([i])``, and the stream's per-chunk decode."""

import asyncio
import contextlib
import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.serve import api as jax_api
from runbooks_tpu.serve import grammar as jax_grammar
from runbooks_tpu.train import data as jax_data
from runbooks_tpu.train import dataset_loader as jax_loader
from runbooks_tpu.train import trainer as jax_trainer

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.serve import api
from runbooks_tpu_torch.serve import grammar
from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
from runbooks_tpu_torch.train import data, dataset_loader, trainer
from runbooks_tpu_torch.train.lora import LoraConfig
from runbooks_tpu_torch.train.optimizer import OptimizerConfig
from tests.test_torch_serve_api import (
    _call,
    _JaxServer,
    _sse,
    _streamed,
    _TorchServer,
)
from tests.test_torch_tokenizer import write_llama2_dir, write_llama3_dir

pytest.importorskip("transformers")
torch.set_num_threads(2)

VOCAB = 1280          # covers both test tokenizers, added tokens included
MAX_SEQ = 128
CHAT = [{"role": "system", "content": "Answer in one line."},
        {"role": "user", "content": "What's a kernel? It's 1234567."}]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return {"llama3": write_llama3_dir(tmp_path_factory.mktemp("l3")),
            "llama2": write_llama2_dir(tmp_path_factory.mktemp("l2"))}


@pytest.fixture(scope="module")
def toks(dirs):
    """{kind: (port tokenizer, reference tokenizer)}."""
    return {k: (data.load_tokenizer(p), jax_data.load_tokenizer(p))
            for k, p in dirs.items()}


def _docs(path):
    rng = np.random.default_rng(3)
    words = ["the", "kernel", "it's", "中文", "😀", "1234567", "don't",
             "tile", "\n", "warp", " ", "<|eot_id|>", "café"]
    with open(path, "w") as f:
        for _ in range(40):
            n = int(rng.integers(5, 60))
            f.write(json.dumps({"text": " ".join(rng.choice(words, n))})
                    + "\n")
    return str(path)


# ---------------------------------------------------------------------------
# load_tokenizer
# ---------------------------------------------------------------------------

def test_load_tokenizer_raises_and_falls_back_as_the_reference(dirs,
                                                               tmp_path,
                                                               capsys):
    assert isinstance(data.load_tokenizer(None), data.ByteTokenizer)
    assert isinstance(data.load_tokenizer(""), data.ByteTokenizer)
    missing = str(tmp_path / "missing")
    for load in (data.load_tokenizer, jax_data.load_tokenizer):
        with pytest.raises(RuntimeError, match="could not be loaded"):
            load(missing)
    port = data.load_tokenizer(missing, allow_byte_fallback=True)
    ref = jax_data.load_tokenizer(missing, allow_byte_fallback=True)
    assert isinstance(port, data.ByteTokenizer)
    assert isinstance(ref, jax_data.ByteTokenizer)
    assert "falling back to the byte tokenizer" in capsys.readouterr().out
    # A sentencepiece protobuf alone is refused by name.
    sp = tmp_path / "sp"
    sp.mkdir()
    (sp / "tokenizer.model").write_bytes(b"\x0a\x00")
    with pytest.raises(RuntimeError, match="sentencepiece"):
        data.load_tokenizer(str(sp))
    assert isinstance(data.load_tokenizer(str(sp), allow_byte_fallback=True),
                      data.ByteTokenizer)
    tok = data.load_tokenizer(dirs["llama3"])
    assert tok.encode("hi")[0] == tok.bos_token_id


# ---------------------------------------------------------------------------
# The trainer's batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["llama3", "llama2"])
def test_trainer_batches_match_the_reference(dirs, tmp_path, kind):
    path = _docs(tmp_path / "docs.jsonl")
    job = trainer.TrainJobConfig(model="debug", seq_len=48, batch_size=4,
                                 data_path=path, tokenizer=dirs[kind])
    cfg = get_config("debug", vocab_size=VOCAB)
    mine = trainer._batches(job, cfg)
    ref = jax_data.dataset(path, 48, 4, tokenizer=jax_data.load_tokenizer(
        dirs[kind]), epochs=None)
    for _ in range(4):
        a, b = next(mine), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_vocab_check_reads_vocab_size_as_the_reference(dirs, tmp_path):
    """The check reads vocab_size, which leaves out the added tokens: a
    model as wide as the BPE vocab passes, one narrower raises."""
    path = _docs(tmp_path / "docs.jsonl")
    port_tok, _ = data.load_tokenizer(dirs["llama3"]), None
    assert len(port_tok) > port_tok.vocab_size
    for width, ok in ((port_tok.vocab_size, True),
                      (port_tok.vocab_size - 1, False)):
        job = trainer.TrainJobConfig(model="debug", seq_len=32,
                                     batch_size=2, data_path=path,
                                     tokenizer=dirs["llama3"])
        jjob = jax_trainer.TrainJobConfig(model="debug", seq_len=32,
                                          batch_size=2, data_path=path,
                                          tokenizer=dirs["llama3"])
        for fn, j, c in ((trainer._batches, job,
                          get_config("debug", vocab_size=width)),
                         (jax_trainer._batches, jjob,
                          jax_get_config("debug", vocab_size=width))):
            if ok:
                next(fn(j, c))
            else:
                with pytest.raises(ValueError, match="exceeds"):
                    fn(j, c)


def test_run_training_with_a_tokenizer_and_prefetch(dirs, tmp_path):
    """A LoRA job over the llama3-style tokenizer: the same losses with
    the prefetcher at depth 0 and 2."""
    path = _docs(tmp_path / "docs.jsonl")
    losses = {}
    for depth in (0, 2):
        job = trainer.TrainJobConfig(
            model="debug", model_overrides={"vocab_size": VOCAB},
            seq_len=32, batch_size=4, accumulate_steps=2, steps=3,
            log_every=1, data_path=path, tokenizer=dirs["llama3"],
            prefetch_depth=depth, lora=LoraConfig(rank=4, alpha=8.0),
            optimizer=OptimizerConfig(learning_rate=1e-2, warmup_steps=1,
                                      total_steps=3),
            artifacts_dir=str(tmp_path / f"d{depth}"))
        summary = trainer.run_training(job, device="cpu")
        losses[depth] = [e["loss"] for e in summary["history"]]
        assert all("data_wait_s" in e for e in summary["history"])
    assert losses[0] == losses[2]
    assert all(np.isfinite(losses[0]))
    assert not any(t.name == "rbt-prefetch" for t in threading.enumerate())


# ---------------------------------------------------------------------------
# Prefetcher
# ---------------------------------------------------------------------------

def _items(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise KeyError(f"bad item {i}")
        yield {"x": np.full(3, i)}


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_order_and_error_position_match_the_reference(depth):
    def run(cls, fail_at):
        got = []
        with cls(_items(12, fail_at), depth=depth,
                 place=lambda b: {"x": b["x"] * 2}) as p:
            try:
                for b in p:
                    got.append(int(b["x"][0]))
            except KeyError as exc:
                got.append(str(exc))
        return got
    for fail_at in (None, 0, 5, 11):
        assert run(data.Prefetcher, fail_at) == run(jax_data.Prefetcher,
                                                    fail_at)
    assert run(data.Prefetcher, 5) == [0, 2, 4, 6, 8, "'bad item 5'"]


def test_prefetcher_error_in_place_and_close():
    def place(b):
        if int(b["x"][0]) == 3:
            raise ValueError("place failed")
        return b
    for cls in (data.Prefetcher, jax_data.Prefetcher):
        p = cls(_items(10), depth=2, place=place)
        got = [int(next(p)["x"][0]) for _ in range(3)]
        with pytest.raises(ValueError, match="place failed"):
            next(p)
        p.close()
        assert got == [0, 1, 2]
    for cls in (data.Prefetcher, jax_data.Prefetcher):
        p = cls(_items(1000), depth=2)   # producer blocked on a full queue
        next(p)
        p.close()
        p.close()                        # idempotent
        assert not p._thread.is_alive()
        with pytest.raises(StopIteration):
            next(p)
        with pytest.raises(ValueError):
            cls(_items(1), depth=0)


def test_pinned_placer_gives_tensors():
    batch = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3)}
    out = data.pinned_placer(False)(batch)
    assert torch.equal(out["tokens"], torch.arange(6).reshape(2, 3).int())


# ---------------------------------------------------------------------------
# The Dataset loader Job
# ---------------------------------------------------------------------------

def test_dataset_loader_matches_the_reference(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jsonl").write_text(
        '{"text": "one"}\n{"other": 1}\nnot json\n{"text": "two"}\n')
    (src / "b.txt").write_text("line one\nline two\nline three\n")
    (src / "c.jsonl").write_text('{"body": "x"}\n{"body": "y"}\n')
    (src / "d.bin").write_bytes(bytes(range(256)))
    params = {"urls": f"file://{src / 'c.jsonl'} , file://{src / 'd.bin'}",
              "paths": [str(src / "a.jsonl"), str(src / "b.txt")],
              "text_key": "text"}
    results = {}
    for name, main in (("port", dataset_loader.main),
                       ("ref", jax_loader.main)):
        content = tmp_path / name
        content.mkdir()
        (content / "params.json").write_text(json.dumps(params))
        monkeypatch.setenv("RBT_CONTENT_DIR", str(content))
        assert main() == 0
        art = content / "artifacts"
        manifest = json.loads((art / "dataset.json").read_text())
        files = {f: (art / f).read_bytes() for f in sorted(os.listdir(art))
                 if f != "dataset.json"}
        results[name] = (manifest, files)
    assert results["port"] == results["ref"]
    manifest, files = results["port"]
    assert [f["rows"] for f in manifest["files"]] == [0, 0, 2, 3]
    assert manifest["total_bytes"] == sum(len(b) for b in files.values())
    assert files["d.bin"] == bytes(range(256))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path / "empty"))
    with pytest.raises(SystemExit, match="no 'urls' or 'paths'"):
        dataset_loader.main()


def test_trainer_reads_the_loader_output_directory(tmp_path, monkeypatch):
    """Reference fault (3): the loader writes its manifest dataset.json
    beside the data, and the reference's read_documents parses every
    .json file in the mounted directory as jsonl: the Dataset -> training
    path fails on the manifest's first line. The port's reader passes
    over the manifest and yields the loaded documents."""
    src = tmp_path / "docs.jsonl"
    src.write_text("".join(json.dumps({"text": f"doc {i}"}) + "\n"
                           for i in range(5)))
    content = tmp_path / "content"
    content.mkdir()
    (content / "params.json").write_text(json.dumps({"paths": [str(src)]}))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(content))
    assert dataset_loader.main() == 0
    art = str(content / "artifacts")
    assert sorted(os.listdir(art)) == ["dataset.json", "docs.jsonl"]
    with pytest.raises(json.JSONDecodeError):
        list(jax_data.read_documents(art))
    assert list(data.read_documents(art)) == [f"doc {i}" for i in range(5)]
    assert list(data.read_documents(art)) == list(
        jax_data.read_documents(str(src)))


# ---------------------------------------------------------------------------
# Chat completions through the template, against the JAX server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("debug", dtype="float32", vocab_size=VOCAB)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tcfg = get_config("debug", dtype="float32", vocab_size=VOCAB)
    tparams = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def servers(weights, toks):
    """{kind: (JAX server, port server)} over the same weights."""
    jcfg, jparams, tcfg, tparams = weights
    out = {}
    try:
        for kind, (port_tok, ref_tok) in toks.items():
            out[kind] = (
                _JaxServer(jax_api.create_server(
                    jcfg, jparams, ref_tok, max_slots=4,
                    max_seq_len=MAX_SEQ)),
                _TorchServer(api.create_server(
                    tcfg, tparams, port_tok, host="127.0.0.1", port=0,
                    device="cpu", max_slots=4, max_seq_len=MAX_SEQ)))
        yield out
    finally:
        for pair in out.values():
            for s in reversed(pair):
                s.close()


@pytest.mark.parametrize("kind", ["llama3", "llama2"])
def test_chat_prompt_ids_and_greedy_text_match_the_jax_server(
        servers, toks, weights, kind):
    port_tok, ref_tok = toks[kind]
    ref_prompt = ref_tok.apply_chat_template(CHAT, tokenize=False,
                                             add_generation_prompt=True)
    prompt = api._chat_prompt(port_tok, CHAT)
    assert prompt == ref_prompt
    ids = api._encode(port_tok, prompt)
    assert ids == jax_api._encode(ref_tok, ref_prompt)
    body = {"messages": CHAT, "max_tokens": 12, "temperature": 0}
    (js, _, jt), (ts, _, tt) = [
        _call(s.base, "/v1/chat/completions", body)
        for s in servers[kind]]
    assert js == ts == 200, (jt, tt)
    jp, tp = json.loads(jt), json.loads(tt)
    assert tp["usage"] == jp["usage"]
    assert tp["usage"]["prompt_tokens"] == len(ids)
    assert tp["choices"][0]["message"] == jp["choices"][0]["message"]
    # The text is the decode of generate's ids on those prompt ids.
    _, _, tcfg, tparams = weights
    req = Request(prompt_tokens=ids, max_tokens=12,
                  eos_id=port_tok.eos_token_id)
    InferenceEngine(tcfg, tparams, max_slots=1,
                    max_seq_len=MAX_SEQ).generate([req])
    out = req.output_tokens
    if out and out[-1] == port_tok.eos_token_id:
        out = out[:-1]
    assert tp["choices"][0]["message"]["content"] == port_tok.decode(out)


def _stream_text(base, body):
    status, _, text = _call(base, "/v1/completions", {**body,
                                                      "stream": True})
    assert status == 200
    return _streamed(_sse(text), chat=False)


async def _loop_turns(n: int = 3) -> None:
    for _ in range(n):
        await asyncio.sleep(0)


@contextlib.contextmanager
def _one_token_per_chunk(jax_srv):
    """The reference's stream decodes, as one chunk, every token that
    arrived since its handler last ran, so how many tokens a chunk holds
    is a race between the engine's thread and the server's event loop. On
    a loaded host the handler falls behind, whole streams arrive as one
    chunk, and the per-chunk fault disappears. This holds the JAX engine,
    after each streamed token, until the event loop has run the handler
    that decodes it: one token per chunk, whatever the host's load."""
    engine = jax_srv.app["worker"].engine
    record = engine._record_token

    def record_then_wait(slot, tok):
        req = engine.slot_req[slot]
        streamed = req is not None and req.on_token is not None
        record(slot, tok)
        if streamed:
            jax_srv._run(_loop_turns())

    engine._record_token = record_then_wait
    try:
        yield
    finally:
        del engine._record_token


def test_reference_stream_drops_spaces_and_the_port_does_not(servers,
                                                             toks):
    """Reference fault (2): under a byte-fallback (sentencepiece) BPE the
    reference decodes each streamed chunk alone and the decoder strips
    each chunk's leading space, so its concatenated stream differs from
    its unstreamed text. The port's stream equals the unstreamed text, and
    so does the JAX server's unstreamed answer."""
    port_tok, _ = toks["llama2"]
    jax_srv, torch_srv = servers["llama2"]
    ref_differs = spaces_only = 0
    for prompt in ("the kernel", "tile warp 中文", "It's 1234567"):
        body = {"prompt": prompt, "max_tokens": 16, "temperature": 0}
        plain = json.loads(_call(torch_srv.base, "/v1/completions",
                                 body)[2])["choices"][0]
        jplain = json.loads(_call(jax_srv.base, "/v1/completions",
                                  body)[2])["choices"][0]
        assert plain["text"] == jplain["text"]
        port_stream = _stream_text(torch_srv.base, body)[0]
        with _one_token_per_chunk(jax_srv):
            ref_stream = _stream_text(jax_srv.base, body)[0]
        assert port_stream[:2] == (plain["text"], [plain["finish_reason"]])
        assert ref_stream[1] == port_stream[1]
        if ref_stream[0] != plain["text"]:
            ref_differs += 1
            # Spaces went missing (and a run of byte tokens split across
            # chunks decodes otherwise than whole).
            assert len(ref_stream[0]) < len(plain["text"])
            spaces_only += ref_stream[0].replace(" ", "") == \
                plain["text"].replace(" ", "")
    assert ref_differs >= 1 and spaces_only >= 1


def test_port_stream_equals_text_under_clean_up(servers):
    """llama3's config cleans up tokenization spaces (" ." -> "."), which
    a later token can change: the port holds that tail back until it
    settles."""
    _, torch_srv = servers["llama3"]
    for prompt in ("the kernel .", "it 's , a ! b", "中文 😀 ."):
        body = {"prompt": prompt, "max_tokens": 16, "temperature": 0}
        plain = json.loads(_call(torch_srv.base, "/v1/completions",
                                 body)[2])["choices"][0]
        assert _stream_text(torch_srv.base, body)[0][0] == plain["text"]


def test_settled_holds_back_what_later_ids_can_change(toks):
    """Every prefix's settled text is a prefix of the full decode, for
    random id streams under both tokenizers (cut UTF-8, runs of byte
    tokens, clean-up rules)."""
    rng = np.random.default_rng(5)
    for port_tok, _ in toks.values():
        n = VOCAB   # the model's ids past the tokenizer's decode to nothing
        for _ in range(150):
            ids = [int(i) for i in rng.integers(0, n, size=24)]
            full = port_tok.decode(ids)
            sent = ""
            for k in range(1, len(ids) + 1):
                part = api._settled(port_tok, ids[:k])
                assert full.startswith(part), (ids[:k], part, full)
                if len(part) > len(sent):
                    assert part.startswith(sent)
                    sent = part


# ---------------------------------------------------------------------------
# The grammar's token table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["llama3", "llama2"])
def test_reference_token_table_is_wrong_where_decode_does_not_round_trip(
        toks, kind):
    """Reference fault (1): the reference's table holds decode([i]) as
    UTF-8. Where that decode round-trips, the port's bytes are the
    reference's; elsewhere the reference holds EF BF BD for a byte-level
    token that is a cut UTF-8 sequence (or a lone <0xXX> byte), or drops
    the leading space the decoder (Strip, or the clean-up of " ." and the
    like) takes off a lone token."""
    port_tok, ref_tok = toks[kind]
    mine = grammar.TokenVocab.from_tokenizer(port_tok)
    ref = jax_grammar.TokenVocab.from_tokenizer(ref_tok)
    assert mine.vocab_size == ref.vocab_size == port_tok.vocab_size
    assert mine.eos_id == ref.eos_id
    replacement, stripped = [], []
    for i, (a, b) in enumerate(zip(mine.token_bytes, ref.token_bytes)):
        if a == b:
            continue
        if b is not None and b"\xef\xbf\xbd" in b:
            assert b"\xef\xbf\xbd" not in a
            replacement.append(i)
        else:
            # A lone space (<0x20>, "▁") decodes to nothing: None there.
            assert a is not None and a.startswith(b" "), i
            assert (b or b"") in (a[1:], a.replace(b" ", b"")), i
            stripped.append(i)
    assert replacement, "no cut UTF-8 token: the fixture lost its point"
    if kind == "llama2":
        assert stripped
        assert all(port_tok.convert_ids_to_tokens(i).startswith("▁")
                   or port_tok.convert_ids_to_tokens(i) == "<0x20>"
                   for i in stripped)
    # Both views agree on every id whose decode round-trips.
    for i in range(mine.vocab_size):
        if i in replacement or i in stripped:
            continue
        assert mine.token_bytes[i] == ref.token_bytes[i]
    assert mine.fingerprint != ref.fingerprint


def test_constrained_output_over_the_real_vocab(toks, weights):
    """A response_format request under the llama3-style tokenizer: every
    output token legal under its TokenVocab, the text valid JSON of the
    schema."""
    port_tok, _ = toks["llama3"]
    _, _, tcfg, tparams = weights
    schema = {"type": "json_schema", "json_schema": {"schema": {
        "type": "object", "properties": {
            "ok": {"type": "boolean"}, "mode": {"enum": ["fast", "slow"]}},
        "required": ["mode", "ok"], "additionalProperties": False}}}
    eng = InferenceEngine(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ,
                          grammar="on", tokenizer=port_tok)
    req = Request(prompt_tokens=port_tok.encode("Answer:"), max_tokens=48,
                  eos_id=port_tok.eos_token_id, response_format=schema)
    eng.generate([req])
    vocab = grammar.TokenVocab.from_tokenizer(port_tok)
    cursor = grammar.GrammarCache(vocab, tcfg.vocab_size).cursor(schema)
    out = [t for t in req.output_tokens if t != port_tok.eos_token_id]
    for t in out:
        assert cursor.advance(t), t
    assert cursor.accepting
    value = json.loads(b"".join(vocab.token_bytes[t] for t in out))
    assert value["mode"] in ("fast", "slow") and isinstance(value["ok"],
                                                             bool)
    assert json.loads(port_tok.decode(out)) == value


def test_job_config_takes_prefetch_depth_as_the_reference():
    params = {"prefetch_depth": "0", "tokenizer": "/t"}
    mine = trainer.TrainJobConfig.from_params(params)
    ref = jax_trainer.TrainJobConfig.from_params(params)
    assert mine.prefetch_depth == ref.prefetch_depth == 0
    assert mine.tokenizer == ref.tokenizer == "/t"
    assert dataclasses.replace(mine, prefetch_depth=2).prefetch_depth == 2
