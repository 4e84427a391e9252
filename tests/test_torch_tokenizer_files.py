"""Tokenizer directories without tokenizer.json (models/tokenizer_io.py,
models/sentencepiece_io.py).

- ``vocab.json`` + ``merges.txt`` (GPT-2's and OPT's files): against
  transformers' ``GPT2TokenizerFast(vocab_file=, merges_file=)`` on the
  bare files, and against the reference's ``load_tokenizer`` (transformers'
  AutoTokenizer) on an OPT-style directory with its tokenizer_config.json
  and special_tokens_map.json: the same ids, text, vocabulary sizes and
  special ids.
- Only ``tokenizer.model`` (a sentencepiece BPE with byte fallback, written
  by the test through ``transformers.utils.sentencepiece_model_pb2_new``;
  this image has no ``sentencepiece``): against a ``tokenizers`` BPE built
  in the test from the same pieces (merges by transformers'
  ``generate_merges``, llama2's normalizer and decoder, its specials and
  BOS) and against ids worked out by hand; models the reader cannot run
  exactly are refused by name.
"""

import json
import os

import numpy as np
import pytest

from tests.test_torch_tokenizer import CORPUS, _byte_level_bpe, _train_corpus

from runbooks_tpu_torch.models import sentencepiece_io, tokenizer_io
from runbooks_tpu_torch.train import data as port_data

TEXTS = CORPUS + ["</s>hello<pad> <s>", "<|endoftext|> tail",
                  "the thin hat\n\n  ñandú"]


def _write_vocab_merges(path, vocab_size=700):
    from tokenizers import pre_tokenizers

    tok = _byte_level_bpe(vocab_size, pre_tokenizers.ByteLevel(
        add_prefix_space=False, use_regex=True), ignore_merges=False)
    os.makedirs(path, exist_ok=True)
    tok.model.save(str(path))
    return str(path)


def _opt_dir(path):
    """OPT's layout: <s>, <pad>, </s>, <unk> first in vocab.json, then a
    trained byte-level BPE; OPT's tokenizer_config.json and
    special_tokens_map.json."""
    src = _write_vocab_merges(str(path) + "_src")
    with open(os.path.join(src, "vocab.json"), encoding="utf-8") as f:
        trained = json.load(f)
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for t, _ in sorted(trained.items(), key=lambda kv: kv[1]):
        vocab.setdefault(t, len(vocab))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(src, "merges.txt"), encoding="utf-8") as f:
        merges = f.read()
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write(merges)

    def special(content):
        return {"content": content, "lstrip": False, "normalized": True,
                "rstrip": False, "single_word": False}

    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "GPT2Tokenizer", "errors": "replace",
                   "unk_token": "</s>", "bos_token": "</s>",
                   "eos_token": "</s>", "pad_token": "<pad>",
                   "add_prefix_space": False, "add_bos_token": True}, f)
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": special("</s>"),
                   "eos_token": special("</s>"),
                   "unk_token": special("</s>"),
                   "pad_token": special("<pad>")}, f)
    return str(path)


def _same_encoding(mine, ref):
    for text in TEXTS:
        ids = mine.encode(text)
        assert ids == ref.encode(text), text
        assert mine.decode(ids) == ref.decode(ids), text
        assert mine.decode(ids, skip_special_tokens=True) == ref.decode(
            ids, skip_special_tokens=True), text


def test_vocab_and_merges_match_gpt2_tokenizer_fast(tmp_path):
    from transformers import GPT2TokenizerFast

    path = _write_vocab_merges(tmp_path / "g")
    ref = GPT2TokenizerFast(vocab_file=os.path.join(path, "vocab.json"),
                            merges_file=os.path.join(path, "merges.txt"))
    mine = tokenizer_io.load(path)
    _same_encoding(mine, ref)
    assert (len(mine), mine.vocab_size) == (len(ref), ref.vocab_size)
    assert (mine.bos_token_id, mine.eos_token_id, mine.unk_token_id) == (
        ref.bos_token_id, ref.eos_token_id, ref.unk_token_id)


def test_opt_directory_matches_the_reference_loader(tmp_path):
    from runbooks_tpu.train.data import load_tokenizer as ref_load

    path = _opt_dir(tmp_path / "opt")
    ref = ref_load(path)
    mine = port_data.load_tokenizer(path)
    _same_encoding(mine, ref)
    assert mine.encode("hi")[0] == ref.bos_token_id == 2
    assert (len(mine), mine.vocab_size) == (len(ref), ref.vocab_size)
    for key in ("bos_token_id", "eos_token_id", "unk_token_id",
                "pad_token_id"):
        assert getattr(mine, key) == getattr(ref, key), key


def test_opt_directory_with_a_prefix_space_is_refused(tmp_path):
    path = _opt_dir(tmp_path / "opt")
    cfg_path = os.path.join(path, "tokenizer_config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    with open(cfg_path, "w") as f:
        json.dump(dict(cfg, add_prefix_space=True), f)
    with pytest.raises(tokenizer_io.TokenizerFormatError,
                       match="add_prefix_space"):
        tokenizer_io.load(path)


# ---------------------------------------------------------------------------
# tokenizer.model
# ---------------------------------------------------------------------------

def _model_proto(pieces, model_type="BPE", byte_fallback=True,
                 add_dummy_prefix=True, charsmap=b""):
    """A serialized ModelProto: pieces as (piece, score, type name)."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    m = pb.ModelProto()
    for piece, score, kind in pieces:
        p = m.pieces.add()
        p.piece, p.score = piece, score
        p.type = getattr(pb.ModelProto.SentencePiece.Type, kind)
    ts = m.trainer_spec
    ts.model_type = getattr(pb.TrainerSpec.ModelType, model_type)
    ts.vocab_size = len(pieces)
    ts.byte_fallback = byte_fallback
    ts.unk_id, ts.bos_id, ts.eos_id, ts.pad_id = 0, 1, 2, -1
    ns = m.normalizer_spec
    ns.name = "identity" if not charsmap else "nmt_nfkc"
    ns.precompiled_charsmap = charsmap
    ns.add_dummy_prefix = add_dummy_prefix
    ns.remove_extra_whitespaces = False
    ns.escape_whitespaces = True
    return m.SerializeToString()


def _base_pieces():
    return ([("<unk>", 0.0, "UNKNOWN"), ("<s>", 0.0, "CONTROL"),
             ("</s>", 0.0, "CONTROL")]
            + [(f"<0x{b:02X}>", 0.0, "BYTE") for b in range(256)])


def _trained_pieces(size=900):
    """llama2's layout: the base pieces, then pieces trained by a
    ``tokenizers`` BPE over sentencepiece words, scored -index as
    sentencepiece scores its merged pieces."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from tokenizers.trainers import BpeTrainer

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="always", split=True)
    tok.train_from_iterator(_train_corpus(), BpeTrainer(
        vocab_size=size - 259, show_progress=False, limit_alphabet=120))
    trained = json.loads(tok.to_str())["model"]["vocab"]
    pieces = _base_pieces()
    seen = {p for p, _, _ in pieces}
    for piece, _ in sorted(trained.items(), key=lambda kv: kv[1]):
        if piece not in seen:
            seen.add(piece)
            pieces.append((piece, -float(len(pieces)), "NORMAL"))
    return pieces


def _write_model(path, proto, config=None):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.model"), "wb") as f:
        f.write(proto)
    if config is not None:
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump(config, f)
    return str(path)


def _tokenizers_llama(pieces):
    """The independent twin: a tokenizers BPE from the same pieces, as
    llama2's tokenizer.json is built."""
    from tokenizers import (AddedToken, Tokenizer, decoders, models,
                            normalizers, processors)
    from transformers.convert_slow_tokenizer import generate_merges

    vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
    scores = [(p, 0.0 if i < 3 else s) for i, (p, s, _) in enumerate(pieces)]
    tok = Tokenizer(models.BPE(vocab, generate_merges(vocab, scores),
                               unk_token="<unk>", fuse_unk=True,
                               byte_fallback=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
        decoders.Strip(content=" ", left=1, right=0)])
    tok.add_special_tokens([AddedToken(s, special=True, normalized=False)
                            for s in ("<unk>", "<s>", "</s>")])
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", 1)])
    return tok


def test_tokenizer_model_matches_a_tokenizers_bpe_of_its_pieces(tmp_path):
    pieces = _trained_pieces()
    path = _write_model(tmp_path / "sp", _model_proto(pieces))
    mine = port_data.load_tokenizer(path)
    twin = _tokenizers_llama(pieces)
    for text in TEXTS:
        ids = mine.encode(text)
        assert ids == twin.encode(text).ids, text
        assert mine.decode(ids, skip_special_tokens=True) == twin.decode(
            ids, skip_special_tokens=True), text
    assert mine.vocab_size == len(pieces)
    assert (mine.bos_token_id, mine.eos_token_id, mine.unk_token_id) == (
        1, 2, 0)
    # The pieces, scores and types as written.
    read = sentencepiece_io.read_model(os.path.join(path, "tokenizer.model"))
    assert [(p["piece"], p["score"]) for p in read["pieces"]] == [
        (p, np.float32(s)) for p, s, _ in pieces]
    assert [p["type"] for p in read["pieces"][:4]] == [2, 3, 3, 6]
    assert read["trainer_spec"]["pad_id"] == -1


def test_tokenizer_model_hand_worked_ids(tmp_path):
    """Pieces ▁, h, e, l, o, ▁h (-1), ll (-2), ▁he (-3), llo (-4), ▁hello
    (-5) after the 259 base pieces (ids 259..268). "hello" normalizes to
    "▁hello": ▁+h (score -1) first, then l+l (-2), then ▁h+e (-3), then
    ll+o (-4), then ▁he+llo (-5): one piece. "hole" has no merged piece
    past ▁h: ▁h, o, l, e. "hé": é is no piece, so its two UTF-8 bytes
    take the byte pieces <0xC3> (3 + 0xC3) and <0xA9> (3 + 0xA9)."""
    pieces = _base_pieces() + [
        ("▁", -100.0, "NORMAL"), ("h", -101.0, "NORMAL"),
        ("e", -102.0, "NORMAL"), ("l", -103.0, "NORMAL"),
        ("o", -104.0, "NORMAL"), ("▁h", -1.0, "NORMAL"),
        ("ll", -2.0, "NORMAL"), ("▁he", -3.0, "NORMAL"),
        ("llo", -4.0, "NORMAL"), ("▁hello", -5.0, "NORMAL")]
    path = _write_model(tmp_path / "sp", _model_proto(pieces))
    tok = tokenizer_io.load(path)
    assert tok.encode("hello") == [1, 268]
    assert tok.encode("hole", add_special_tokens=False) == [264, 263, 262,
                                                           261]
    assert tok.encode("hé", add_special_tokens=False) == [
        264, 3 + 0xC3, 3 + 0xA9]
    assert tok.encode("hello hello", add_special_tokens=False) == [268,
                                                                  268]
    assert tok.decode([1, 268, 264, 3 + 0xC3, 3 + 0xA9],
                      skip_special_tokens=True) == "hello▁hé".replace(
                          "▁", " ")
    # Without the dummy prefix the first word carries no ▁: h, e, llo.
    bare = tokenizer_io.load(_write_model(tmp_path / "bare", _model_proto(
        pieces, add_dummy_prefix=False)))
    assert bare.encode("hello", add_special_tokens=False) == [260, 261,
                                                             267]
    assert bare.decode([260, 261, 267]) == "hello"


def test_tokenizer_model_config_overrides_the_defaults(tmp_path):
    pieces = _base_pieces() + [("▁", -1.0, "NORMAL"), ("a", -2.0, "NORMAL")]
    path = _write_model(tmp_path / "sp", _model_proto(pieces), config={
        "tokenizer_class": "LlamaTokenizer", "add_bos_token": False,
        "add_eos_token": True, "bos_token": "<s>", "eos_token": "</s>",
        "unk_token": "<unk>"})
    tok = tokenizer_io.load(path)
    assert tok.encode("a") == [259, 260, 2]
    # The config's special tokens are matched in the text as specials,
    # and the text after one is normalized on its own (legacy: "▁a").
    assert tok.encode("<unk>a", add_special_tokens=False) == [0, 259, 260]


@pytest.mark.parametrize("kw,name", [
    ({"model_type": "UNIGRAM"}, "UNIGRAM"),
    ({"byte_fallback": False}, "byte_fallback"),
    ({"charsmap": b"\x00\x01"}, "charsmap"),
])
def test_tokenizer_model_it_cannot_run_is_refused(tmp_path, kw, name):
    path = _write_model(tmp_path / "sp", _model_proto(_base_pieces(), **kw))
    with pytest.raises(tokenizer_io.TokenizerFormatError, match=name):
        tokenizer_io.load(path)
    with pytest.raises(RuntimeError, match="sentencepiece"):
        port_data.load_tokenizer(path)


def test_wire_format_reader_on_hand_written_bytes():
    """Field 1 (a piece: "a", score -1.5, type 1), field 2 (model_type 2,
    byte_fallback, pad_id -1 as a ten-byte varint), field 3
    (add_dummy_prefix 1): the bytes ModelProto.SerializeToString gives."""
    buf = (b"\n\n\n\x01a\x15\x00\x00\xc0\xbf\x18\x01"
           b"\x12\x11\x18\x02\x98\x02\x01\xd8\x02\xff\xff\xff\xff\xff\xff"
           b"\xff\xff\xff\x01\x1a\x02\x18\x01")
    fields = list(sentencepiece_io._fields(buf))
    assert [(f, w) for f, w, _ in fields] == [(1, 2), (2, 2), (3, 2)]
    piece = sentencepiece_io._message(fields[0][2], sentencepiece_io._PIECE)
    assert piece == {"piece": "a", "score": -1.5, "type": 1}
    trainer = sentencepiece_io._message(fields[1][2],
                                        sentencepiece_io._TRAINER)
    assert (trainer["model_type"], trainer["byte_fallback"],
            trainer["pad_id"], trainer["unk_piece"]) == (2, True, -1,
                                                         "<unk>")
