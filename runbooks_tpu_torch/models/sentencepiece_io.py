"""Read a sentencepiece ``tokenizer.model`` by its format (the
``ModelProto`` protobuf, decoded from the wire format here: the card has
neither ``sentencepiece`` nor ``google.protobuf``), and turn a BPE model
with byte fallback, llama2's kind, into the tokenizer.json form that
models/tokenizer_io.py runs, as transformers' ``LlamaConverter`` builds it:

* the vocabulary is the pieces in order, and the merges come from the
  scores: every split of a piece into two pieces of the vocabulary is a
  merge ranked by the piece's score (higher first; ties by the longer
  left part, then the longer right part; ``generate_merges``);
* control pieces (``<s>``, ``</s>``) and user-defined pieces are added
  tokens, control ones special; unknown pieces fuse (``fuse_unk``);
* the normalizer prepends ``▁`` when ``add_dummy_prefix`` is set and
  replaces spaces by ``▁``; the decoder replaces ``▁`` by a space, turns
  ``<0xXX>`` pieces back into bytes, fuses, and strips the dummy prefix's
  space.

What that form cannot express is refused by name: another model type
(unigram, word, char), BPE without byte fallback, a normalization rule
(a precompiled charsmap other than the identity), ``remove_extra_
whitespaces`` and ``escape_whitespaces`` off.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Tuple

SPIECE = "▁"

# SentencePiece.Type
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
# TrainerSpec.ModelType
MODEL_TYPES = {1: "UNIGRAM", 2: "BPE", 3: "WORD", 4: "CHAR"}


class SentencePieceFormatError(ValueError):
    """A tokenizer.model this reader cannot read or run exactly."""


# ---------------------------------------------------------------------------
# Protobuf wire format
# ---------------------------------------------------------------------------

def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise SentencePieceFormatError("truncated varint")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7
        if shift >= 70:
            raise SentencePieceFormatError("varint longer than 10 bytes")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """(field number, wire type, value) of each field of one message: an
    int for varint and fixed fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
            if len(value) != n:
                raise SentencePieceFormatError("truncated field")
        elif wire == 5:
            value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        else:
            raise SentencePieceFormatError(f"wire type {wire} of field "
                                           f"{field} is not supported")
        yield field, wire, value


def _int32(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def _f32(v: int) -> float:
    return struct.unpack("<f", struct.pack("<I", v))[0]


# Each message's fields read here: number -> (name, kind, default).
_PIECE = {1: ("piece", "str", ""), 2: ("score", "float", 0.0),
          3: ("type", "int", NORMAL)}
_TRAINER = {3: ("model_type", "int", 1), 4: ("vocab_size", "int", 8000),
            35: ("byte_fallback", "bool", False), 40: ("unk_id", "int", 0),
            41: ("bos_id", "int", 1), 42: ("eos_id", "int", 2),
            43: ("pad_id", "int", -1), 45: ("unk_piece", "str", "<unk>"),
            46: ("bos_piece", "str", "<s>"), 47: ("eos_piece", "str", "</s>"),
            48: ("pad_piece", "str", "<pad>")}
_NORMALIZER = {1: ("name", "str", ""),
               2: ("precompiled_charsmap", "bytes", b""),
               3: ("add_dummy_prefix", "bool", True),
               4: ("remove_extra_whitespaces", "bool", True),
               5: ("escape_whitespaces", "bool", True)}


def _message(buf: bytes, schema: dict) -> Dict[str, Any]:
    out = {name: default for name, _, default in schema.values()}
    for field, wire, value in _fields(buf):
        if field not in schema:
            continue
        name, kind, _ = schema[field]
        if kind == "str":
            out[name] = value.decode("utf-8")
        elif kind == "bytes":
            out[name] = bytes(value)
        elif kind == "float":
            out[name] = _f32(value)
        elif kind == "bool":
            out[name] = bool(value)
        else:
            out[name] = _int32(value)
    return out


def read_model(path: str) -> Dict[str, Any]:
    """{"pieces": [{"piece", "score", "type"}], "trainer_spec": {...},
    "normalizer_spec": {...}} from a tokenizer.model file."""
    with open(path, "rb") as f:
        buf = f.read()
    model: Dict[str, Any] = {"pieces": [], "trainer_spec": _message(
        b"", _TRAINER), "normalizer_spec": _message(b"", _NORMALIZER)}
    for field, wire, value in _fields(buf):
        if wire != 2:
            continue
        if field == 1:
            model["pieces"].append(_message(value, _PIECE))
        elif field == 2:
            model["trainer_spec"] = _message(value, _TRAINER)
        elif field == 3:
            model["normalizer_spec"] = _message(value, _NORMALIZER)
    if not model["pieces"]:
        raise SentencePieceFormatError(f"{path}: no pieces")
    return model


# ---------------------------------------------------------------------------
# The tokenizer.json form
# ---------------------------------------------------------------------------

def generate_merges(vocab: Dict[str, int],
                    scores: Dict[str, float]) -> List[Tuple[str, str]]:
    """Merges from piece scores, as transformers' ``generate_merges``:
    every split of a piece into two vocabulary pieces, each piece's splits
    in the order of their parts' ids, all ranked by the piece's score
    (descending), then by the left part's and the right part's length
    (descending); a stable sort keeps equal keys in piece order."""
    merges = []
    for piece, score in scores.items():
        local = [(piece[:i], piece[i:], score) for i in range(1, len(piece))
                 if piece[:i] in vocab and piece[i:] in vocab]
        local.sort(key=lambda m: (vocab[m[0]], vocab[m[1]]))
        merges.extend(local)
    merges.sort(key=lambda m: (m[2], len(m[0]), len(m[1])), reverse=True)
    return [(a, b) for a, b, _ in merges]


def tokenizer_spec(model: Dict[str, Any]) -> Tuple[dict, dict]:
    """(tokenizer.json spec, default tokenizer_config) of a read model."""
    trainer, norm = model["trainer_spec"], model["normalizer_spec"]
    kind = MODEL_TYPES.get(trainer["model_type"], trainer["model_type"])
    if kind != "BPE":
        raise SentencePieceFormatError(
            f"model_type {kind}: only BPE (with byte_fallback) is supported")
    if not trainer["byte_fallback"]:
        raise SentencePieceFormatError(
            "BPE without byte_fallback is not supported")
    charsmap = norm["precompiled_charsmap"]
    if charsmap or norm["name"] not in ("", "identity"):
        raise SentencePieceFormatError(
            f"normalization rule {norm['name']!r} (a precompiled charsmap "
            f"of {len(charsmap)} bytes) is not supported, only identity")
    if norm["remove_extra_whitespaces"]:
        raise SentencePieceFormatError(
            "remove_extra_whitespaces is not supported")
    if not norm["escape_whitespaces"]:
        raise SentencePieceFormatError(
            "escape_whitespaces off is not supported")
    pieces = model["pieces"]
    vocab: Dict[str, int] = {}
    for i, p in enumerate(pieces):
        if p["piece"] in vocab:
            raise SentencePieceFormatError(
                f"piece {p['piece']!r} appears twice (ids "
                f"{vocab[p['piece']]} and {i})")
        vocab[p["piece"]] = i
    # LlamaConverter scores its first three pieces 0.
    scores = {p["piece"]: (0.0 if i < 3 else p["score"])
              for i, p in enumerate(pieces)}
    merges = generate_merges(vocab, scores)
    unk = trainer["unk_piece"]
    if vocab.get(unk) is None:
        raise SentencePieceFormatError(f"unk_piece {unk!r} is not a piece")
    added = [{"id": i, "content": p["piece"], "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": p["type"] == CONTROL}
             for i, p in enumerate(pieces)
             if p["type"] in (CONTROL, USER_DEFINED)]
    normalizers = [{"type": "Replace", "pattern": {"String": " "},
                    "content": SPIECE}]
    decoders = [{"type": "Replace", "pattern": {"String": SPIECE},
                 "content": " "},
                {"type": "ByteFallback"}, {"type": "Fuse"}]
    if norm["add_dummy_prefix"]:
        normalizers.insert(0, {"type": "Prepend", "prepend": SPIECE})
        decoders.append({"type": "Strip", "content": " ", "start": 1,
                         "stop": 0})
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": normalizers},
        "pre_tokenizer": None, "post_processor": None,
        "decoder": {"type": "Sequence", "decoders": decoders},
        "model": {"type": "BPE", "dropout": None, "unk_token": unk,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": [[a, b] for a, b in merges]}}
    config = {"tokenizer_class": "LlamaTokenizerFast",
              "unk_token": unk,
              "bos_token": (trainer["bos_piece"]
                            if trainer["bos_id"] >= 0 else None),
              "eos_token": (trainer["eos_piece"]
                            if trainer["eos_id"] >= 0 else None)}
    return spec, config
