"""Read Hugging Face tokenizer directories by their format (the port's
counterpart of ``transformers.AutoTokenizer.from_pretrained(path,
local_files_only=True)``, as ``safetensors_io`` is of the weights').

A directory holds ``tokenizer.json`` (the ``tokenizers`` serialization:
normalizer, pre-tokenizer, model, post-processor, decoder, added tokens)
and ``tokenizer_config.json`` (the special tokens, the chat template and
the tokenizer class's options). This reader supports what the two llama
families write:

* byte-level BPE (llama3; GPT-2's ``ByteLevel`` with its regex): the
  ``Split`` pre-tokenizer with llama3's pattern or GPT-2's, the byte to
  unicode map, merges by rank with a per-word cache, ``ignore_merges``,
  a ``TemplateProcessing`` post-processor and the ``ByteLevel`` decoder;
* BPE with ``byte_fallback`` (llama2): the ``Prepend("▁")`` and
  ``Replace(" ", "▁")`` normalizers or the ``Metaspace`` pre-tokenizer
  (prepended to the first piece), ``<0xXX>`` fallback and ``fuse_unk``,
  and the ``Replace``, ``ByteFallback``, ``Fuse``, ``Strip`` decoders;
* added tokens, matched on the raw text before the model (on the
  normalized text when ``normalized``), with ``lstrip`` and ``rstrip``;
* ``tokenizer_config.json``'s ``bos_token``, ``eos_token``,
  ``unk_token``, ``pad_token``, ``add_bos_token``/``add_eos_token``
  (which ``LlamaTokenizerFast`` applies over the post-processor),
  ``clean_up_tokenization_spaces`` and ``chat_template`` (or a
  ``chat_template.jinja`` file), rendered by jinja2 as transformers
  renders it.

A directory without ``tokenizer.json`` is read as transformers reads it
when it builds the fast tokenizer from the slow one's files:

* ``vocab.json`` and ``merges.txt`` (GPT-2's and OPT's files): the
  byte-level BPE of ``GPT2Converter``, with the special tokens of
  ``tokenizer_config.json`` and ``special_tokens_map.json`` as added
  tokens and a BOS template when ``add_bos_token`` is set;
* only ``tokenizer.model`` (sentencepiece): the byte-fallback BPE of
  ``LlamaConverter``, read by models/sentencepiece_io.py.

Anything else raises ``TokenizerFormatError`` naming what it met: another
model, normalizer, pre-tokenizer, post-processor or decoder type, another
split pattern.

The split patterns use Unicode classes (``\\p{L}``, ``\\p{N}``) that
Python's ``re`` lacks: they are rebuilt as explicit code point classes
from ``unicodedata`` (letters, numbers, and ``\\s`` as Unicode's
White_Space, which is not ``str.isspace``) and compiled by ``re``, whose
backtracking and leftmost-first alternation are those of the engine the
patterns were written for.
"""

from __future__ import annotations

import functools
import heapq
import json
import os
import re
import sys
import unicodedata
from datetime import datetime
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# tokenizers' pre-tokenizer patterns, as tokenizer.json spells them.
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                  r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                  r"|\s+(?!\S)|\s+")
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
# Unicode's White_Space property: what \s matches in the patterns' engine
# and what Rust's char::is_whitespace tests. str.isspace also takes
# U+001C..U+001F.
WHITE_SPACE = "".join(chr(c) for c in [
    *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000])
_WS = frozenset(WHITE_SPACE)
SPIECE = "▁"   # "▁", sentencepiece's space
_BYTE_TOKEN = re.compile(r"<0x([0-9A-F]{2})>")


class TokenizerFormatError(ValueError):
    """A tokenizer directory this reader cannot read exactly."""


# ---------------------------------------------------------------------------
# Byte-level alphabet and Unicode classes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Tuple[str, ...]:
    """GPT-2's byte -> printable character map: the printable Latin-1
    bytes stand for themselves, the rest map to U+0100 onwards in byte
    order."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    out = {}
    n = 0
    for b in range(256):
        if b in keep:
            out[b] = chr(b)
        else:
            out[b] = chr(256 + n)
            n += 1
    return tuple(out[b] for b in range(256))


@functools.lru_cache(maxsize=None)
def _byte_level_tables() -> Tuple[Dict[int, str], Dict[str, int]]:
    """(str.translate table latin-1 char -> byte-level char, byte-level
    char -> byte)."""
    chars = bytes_to_unicode()
    return ({b: c for b, c in enumerate(chars)},
            {c: b for b, c in enumerate(chars)})


def _class(codepoints: Iterable[int]) -> str:
    """A ``re`` character class body for a set of code points, as
    ranges."""
    parts = []
    run = None
    for c in sorted(codepoints):
        if run and c == run[1] + 1:
            run[1] = c
            continue
        if run:
            parts.append(run)
        run = [c, c]
    if run:
        parts.append(run)

    def esc(c):
        return f"\\U{c:08x}"
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}"
                   for a, b in parts)


@functools.lru_cache(maxsize=None)
def _unicode_classes() -> Tuple[str, str, str]:
    """(\\p{L}, \\p{N}, \\s) class bodies from this Python's Unicode
    database."""
    letters, numbers = [], []
    for c in range(sys.maxunicode + 1):
        cat = unicodedata.category(chr(c))
        if cat[0] == "L":
            letters.append(c)
        elif cat[0] == "N":
            numbers.append(c)
    return (_class(letters), _class(numbers),
            _class(ord(c) for c in WHITE_SPACE))


@functools.lru_cache(maxsize=None)
def split_regex(pattern: str) -> "re.Pattern[str]":
    """llama3's or GPT-2's pre-tokenizer pattern in ``re`` syntax.
    llama3's case-insensitive contractions keep their one non-ASCII case
    fold: the long s (U+017F) matches ``s``."""
    L, N, S = _unicode_classes()
    if pattern == LLAMA3_PATTERN:
        body = (f"'(?:[sSſ]|[tT]|[rR][eE]|[vV][eE]|[mM]|[lL][lL]|[dD])"
                f"|[^\\r\\n{L}{N}]?[{L}]+"
                f"|[{N}]{{1,3}}"
                f"| ?[^{S}{L}{N}]+[\\r\\n]*"
                f"|[{S}]*[\\r\\n]+"
                f"|[{S}]+(?![^{S}])"
                f"|[{S}]+")
    elif pattern == GPT2_PATTERN:
        body = (f"'s|'t|'re|'ve|'m|'ll|'d"
                f"| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+"
                f"|[{S}]+(?![^{S}])|[{S}]+")
    else:
        raise TokenizerFormatError(
            f"split pattern {pattern!r} is not supported (only llama3's "
            "and GPT-2's)")
    return re.compile(body)


def _isolated(rx: "re.Pattern[str]", text: str) -> List[str]:
    """``Split(behavior="Isolated")``: every match and every gap between
    matches is a piece."""
    out = []
    pos = 0
    for m in rx.finditer(text):
        if m.start() > pos:
            out.append(text[pos:m.start()])
        out.append(m.group())
        pos = m.end()
    if pos < len(text):
        out.append(text[pos:])
    return out


# ---------------------------------------------------------------------------
# Pipeline stages
# ---------------------------------------------------------------------------

def _normalizer(spec: Optional[dict]):
    """tokenizer.json's normalizer -> a str -> str function (or None)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]

        def run(text):
            for step in steps:
                if step is not None:
                    text = step(text)
            return text
        return run
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda text: pre + text if text else text
    if kind == "Replace":
        pattern = spec["pattern"]
        if "String" not in pattern:
            raise TokenizerFormatError(
                f"Replace normalizer pattern {pattern!r} is not supported "
                "(only a String)")
        old, new = pattern["String"], spec["content"]
        return lambda text: text.replace(old, new)
    raise TokenizerFormatError(f"normalizer type {kind!r} is not supported")


class _PreTokenizer:
    """tokenizer.json's pre-tokenizer: (piece text, first piece of the
    input) -> the words the model sees."""

    def __init__(self, spec: Optional[dict]):
        self.steps: List[Tuple[str, Any]] = []
        self.byte_level = False
        if spec is not None:
            self._add(spec)

    def _add(self, spec: dict) -> None:
        kind = spec.get("type")
        if kind == "Sequence":
            for s in spec["pretokenizers"]:
                self._add(s)
        elif kind == "Split":
            pattern = spec.get("pattern", {})
            if "Regex" not in pattern:
                raise TokenizerFormatError(
                    f"Split pattern {pattern!r} is not supported (only "
                    "llama3's and GPT-2's regexes)")
            if spec.get("behavior") != "Isolated" or spec.get("invert"):
                raise TokenizerFormatError(
                    f"Split behavior {spec.get('behavior')!r} invert="
                    f"{spec.get('invert')} is not supported (only "
                    "Isolated, not inverted)")
            self.steps.append(("split", split_regex(pattern["Regex"])))
        elif kind == "ByteLevel":
            if spec.get("add_prefix_space"):
                raise TokenizerFormatError(
                    "ByteLevel pre-tokenizer with add_prefix_space is not "
                    "supported")
            if spec.get("use_regex", True):
                self.steps.append(("split", split_regex(GPT2_PATTERN)))
            self.steps.append(("bytes", None))
            self.byte_level = True
        elif kind == "Metaspace":
            # llama2's form: prepend the replacement to the first piece
            # only, and keep each piece whole.
            if (spec.get("prepend_scheme") != "first"
                    or spec.get("split", True)):
                raise TokenizerFormatError(
                    f"Metaspace prepend_scheme={spec.get('prepend_scheme')!r}"
                    f" split={spec.get('split', True)} is not supported "
                    "(only prepend_scheme 'first' without split)")
            self.steps.append(("metaspace", spec.get("replacement", SPIECE)))
        else:
            raise TokenizerFormatError(
                f"pre-tokenizer type {kind!r} is not supported")

    def __call__(self, text: str, at_start: bool) -> List[str]:
        words = [text]
        for kind, arg in self.steps:
            if kind == "split":
                words = [p for w in words for p in _isolated(arg, w)]
            elif kind == "bytes":
                table = _byte_level_tables()[0]
                words = [w.encode("utf-8").decode("latin-1").translate(table)
                         for w in words]
            else:
                words = [w.replace(" ", arg) for w in words]
                if at_start and words and not words[0].startswith(arg):
                    words[0] = arg + words[0]
        return [w for w in words if w]


class _Bpe:
    """The BPE model: vocab, merges by rank, byte fallback, unk fusing,
    ``ignore_merges`` and a per-word cache. The merge loop is the one of
    the ``tokenizers`` crate: a heap of (rank, position), an entry skipped
    when the pair at its position no longer makes its token."""

    CACHE_MAX = 1 << 18
    CACHE_WORD_MAX = 256

    def __init__(self, spec: dict):
        if spec.get("type") != "BPE":
            raise TokenizerFormatError(
                f"model type {spec.get('type')!r} is not supported (only "
                "BPE)")
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise TokenizerFormatError(
                    f"BPE {key}={spec[key]!r} is not supported")
        if spec.get("dropout"):
            raise TokenizerFormatError(
                f"BPE dropout={spec['dropout']} is not supported")
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.id_to_token: Dict[int, str] = {
            i: t for t, i in self.vocab.items()}
        self.unk = spec.get("unk_token")
        self.unk_id = self.vocab.get(self.unk) if self.unk else None
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self._shift = max(20, len(self.vocab).bit_length() + 1)
        self.merges: Dict[int, Tuple[int, int]] = {}
        for rank, merge in enumerate(spec.get("merges", [])):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            try:
                ia, ib, new = (self.vocab[a], self.vocab[b],
                               self.vocab[a + b])
            except KeyError as exc:
                raise TokenizerFormatError(
                    f"merge {a!r} {b!r} (rank {rank}) names a token not in "
                    f"the vocab: {exc}") from None
            self.merges[(ia << self._shift) | ib] = (rank, new)
        self._byte_ids = None
        if self.byte_fallback:
            self._byte_ids = [self.vocab.get(f"<0x{b:02X}>")
                              for b in range(256)]
        self._cache: Dict[str, Tuple[int, ...]] = {}

    def _symbols(self, word: str) -> List[int]:
        ids: List[int] = []
        unk_run = False
        for ch in word:
            i = self.vocab.get(ch)
            if i is not None:
                ids.append(i)
                unk_run = False
                continue
            if self._byte_ids is not None:
                fb = [self._byte_ids[b] for b in ch.encode("utf-8")]
                if None not in fb:
                    ids.extend(fb)
                    continue
            if self.unk_id is not None:
                if not (self.fuse_unk and unk_run):
                    ids.append(self.unk_id)
                unk_run = True
        return ids

    def _merge(self, ids: List[int]) -> List[int]:
        n = len(ids)
        if n < 2:
            return ids
        merges, shift = self.merges, self._shift
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for p in range(n - 1):
            m = merges.get((ids[p] << shift) | ids[p + 1])
            if m is not None:
                heap.append((m[0], p, m[1]))
        heapq.heapify(heap)
        while heap:
            _, p, new = heapq.heappop(heap)
            if not alive[p]:
                continue
            q = nxt[p]
            if q >= n:
                continue
            m = merges.get((ids[p] << shift) | ids[q])
            if m is None or m[1] != new:
                continue
            ids[p] = new
            alive[q] = False
            r = nxt[q]
            nxt[p] = r
            if r < n:
                prv[r] = p
            left = prv[p]
            if left >= 0:
                m = merges.get((ids[left] << shift) | new)
                if m is not None:
                    heapq.heappush(heap, (m[0], left, m[1]))
            if r < n:
                m = merges.get((new << shift) | ids[r])
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
        return [ids[p] for p in range(n) if alive[p]]

    def tokenize(self, word: str) -> Tuple[int, ...]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self.ignore_merges:
            i = self.vocab.get(word)
            if i is not None:
                return (i,)
        out = tuple(self._merge(self._symbols(word)))
        if len(word) < self.CACHE_WORD_MAX:
            if len(self._cache) >= self.CACHE_MAX:
                self._cache.clear()
            self._cache[word] = out
        return out


def _template(spec: Optional[dict]) -> Tuple[List[str], List[str]]:
    """The post-processor's single-sequence template as (tokens before $A,
    tokens after $A)."""
    if spec is None:
        return [], []
    kind = spec.get("type")
    if kind == "Sequence":
        before: List[str] = []
        after: List[str] = []
        for s in spec["processors"]:
            b, a = _template(s)
            before, after = before + b, after + a
        return before, after
    if kind == "ByteLevel":   # offsets only: the ids stay as they are
        return [], []
    if kind == "TemplateProcessing":
        before, after, seen = [], [], False
        for item in spec["single"]:
            if "Sequence" in item:
                if item["Sequence"]["id"] != "A":
                    raise TokenizerFormatError(
                        f"template item {item!r} is not supported")
                seen = True
            elif "SpecialToken" in item:
                name = item["SpecialToken"]["id"]
                toks = spec["special_tokens"][name]["tokens"]
                (after if seen else before).extend(toks)
        return before, after
    raise TokenizerFormatError(
        f"post-processor type {kind!r} is not supported")


def _decoder(spec: Optional[dict]):
    """tokenizer.json's decoder -> a list[str] -> list[str] function (the
    ``decode_chain`` of each step), or None for no decoder."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_decoder(s) for s in spec["decoders"]]

        def run(tokens):
            for step in steps:
                tokens = step(tokens)
            return tokens
        return run
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "Replace":
        pattern = spec["pattern"]
        if "String" not in pattern:
            raise TokenizerFormatError(
                f"Replace decoder pattern {pattern!r} is not supported")
        old, new = pattern["String"], spec["content"]
        return lambda tokens: [t.replace(old, new) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback_decode
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(tokens):
            out = []
            for t in tokens:
                a, b = 0, len(t)
                while a < min(start, b) and t[a] == content:
                    a += 1
                for _ in range(stop):
                    if b > a and t[b - 1] == content:
                        b -= 1
                out.append(t[a:b])
            return out
        return strip
    raise TokenizerFormatError(f"decoder type {kind!r} is not supported")


def _byte_level_decode(tokens: List[str]) -> List[str]:
    """Each token's byte-level characters back to bytes (a token with a
    character outside the map keeps its UTF-8 bytes), the whole decoded
    leniently: an invalid or cut sequence becomes U+FFFD."""
    back = _byte_level_tables()[1]
    data = bytearray()
    for t in tokens:
        try:
            data.extend(back[c] for c in t)
        except KeyError:
            data.extend(t.encode("utf-8"))
    return [data.decode("utf-8", errors="replace")]


def _byte_fallback_decode(tokens: List[str]) -> List[str]:
    """Runs of ``<0xXX>`` tokens to the text their bytes spell; a run that
    is not valid UTF-8 gives one U+FFFD per byte."""
    out: List[str] = []
    run = bytearray()
    n_run = 0

    def flush():
        nonlocal n_run
        if n_run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in range(n_run))
            run.clear()
            n_run = 0
    for t in tokens:
        m = _BYTE_TOKEN.fullmatch(t) if len(t) == 6 else None
        if m:
            run.append(int(m.group(1), 16))
            n_run += 1
        else:
            flush()
            out.append(t)
    flush()
    return out


def clean_up_tokenization(text: str) -> str:
    """transformers' ``clean_up_tokenization``: spaces before English
    punctuation and contractions dropped."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


# ---------------------------------------------------------------------------
# Chat templates
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def compile_chat_template(source: str):
    """A chat template compiled in the environment transformers renders
    it in: a jinja2 ImmutableSandboxedEnvironment with trim_blocks,
    lstrip_blocks and loop controls, ``raise_exception`` and
    ``strftime_now``, and a ``tojson`` that does not escape HTML.
    (transformers' ``{% generation %}`` block, which no llama template
    uses, is not defined here: a template with it fails to compile.)"""
    import jinja2
    from jinja2.ext import loopcontrols
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None,
               sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    def strftime_now(fmt):
        return datetime.now().strftime(fmt)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        extensions=[loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    return env.from_string(source)


# ---------------------------------------------------------------------------
# The tokenizer
# ---------------------------------------------------------------------------

# The special tokens' attributes, in transformers' order
# (SPECIAL_TOKENS_ATTRIBUTES).
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")
_PLAIN_CLASSES = ("PreTrainedTokenizerFast", "GPT2TokenizerFast",
                  "GPT2Tokenizer")
_LLAMA_CLASSES = ("LlamaTokenizerFast", "LlamaTokenizer")


def _token_content(value) -> Optional[str]:
    if value is None or isinstance(value, str):
        return value
    if isinstance(value, dict) and "content" in value:
        return value["content"]
    raise TokenizerFormatError(f"special token {value!r} is not a string "
                               "or an AddedToken")


class _Added:
    __slots__ = ("id", "content", "special", "normalized", "lstrip",
                 "rstrip")

    def __init__(self, spec: dict):
        if spec.get("single_word"):
            raise TokenizerFormatError(
                f"added token {spec['content']!r}: single_word is not "
                "supported")
        self.id = int(spec["id"])
        self.content = spec["content"]
        self.special = bool(spec.get("special", False))
        self.normalized = bool(spec.get("normalized", not self.special))
        self.lstrip = bool(spec.get("lstrip", False))
        self.rstrip = bool(spec.get("rstrip", False))


class _Matcher:
    """Leftmost-longest matching of added tokens, with lstrip/rstrip
    widening a match over the white space beside it."""

    def __init__(self, tokens: Dict[str, _Added]):
        self.tokens = tokens
        self.rx = (re.compile("|".join(
            re.escape(t) for t in sorted(tokens, key=len, reverse=True)))
            if tokens else None)

    def split(self, text: str) -> List[Tuple[str, Optional[int]]]:
        if self.rx is None or not text:
            return [(text, None)]
        out: List[Tuple[str, Optional[int]]] = []
        pos = 0
        for m in self.rx.finditer(text):
            tok = self.tokens[m.group()]
            start, stop = m.start(), m.end()
            if start < pos:
                continue
            if tok.lstrip:
                while start > pos and text[start - 1] in _WS:
                    start -= 1
            if tok.rstrip:
                while stop < len(text) and text[stop] in _WS:
                    stop += 1
            if start > pos:
                out.append((text[pos:start], None))
            out.append((text[start:stop], tok.id))
            pos = stop
        if pos < len(text):
            out.append((text[pos:], None))
        return out


class HFTokenizer:
    """The part of ``PreTrainedTokenizerFast`` that training and serving
    touch, read from a tokenizer directory: ``encode``, ``decode``,
    ``convert_ids_to_tokens``, ``vocab_size`` (the model's vocab, without
    the added tokens) and ``len()`` (with them), the special tokens and
    their ids, ``apply_chat_template``, and ``token_bytes(i)``: the exact
    bytes one id adds to a decoded stream."""

    def __init__(self, path: str):
        spec, cfg = _read_directory(path)
        self.path = path
        if spec.get("truncation") or spec.get("padding"):
            raise TokenizerFormatError(
                "tokenizer.json truncation/padding settings are not "
                "supported")
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre = _PreTokenizer(spec.get("pre_tokenizer"))
        self._model = _Bpe(spec["model"])
        self._decode_chain = _decoder(spec.get("decoder"))
        self._byte_level = self._pre.byte_level

        self._added: Dict[int, _Added] = {}
        for a in spec.get("added_tokens", []):
            tok = _Added(a)
            self._added[tok.id] = tok
        self._added_by_content = {t.content: t for t in self._added.values()}
        # (raw-text matcher, normalized-text matcher), with the special
        # tokens and without them (split_special_tokens).
        self._matchers = {split: self._build_matchers(split)
                          for split in (False, True)}
        self._special_ids = frozenset(
            t.id for t in self._added.values() if t.special)

        cls = cfg.get("tokenizer_class") or "PreTrainedTokenizerFast"
        if cls not in _PLAIN_CLASSES + _LLAMA_CLASSES:
            raise TokenizerFormatError(
                f"tokenizer_class {cls!r} is not supported (only "
                f"{', '.join(_PLAIN_CLASSES + _LLAMA_CLASSES)})")
        llama = cls in _LLAMA_CLASSES
        defaults = ({"bos_token": "<s>", "eos_token": "</s>",
                     "unk_token": "<unk>"} if llama else {})
        self._special_tokens: Dict[str, Optional[str]] = {}
        for key in _SPECIAL_KEYS:
            val = _token_content(cfg.get(key, defaults.get(key)))
            if val is not None and self._lookup(val) is None:
                raise TokenizerFormatError(
                    f"{key} {val!r} is not in the vocabulary")
            self._special_tokens[key] = val
        extra = cfg.get("additional_special_tokens") or []
        self.additional_special_tokens = [_token_content(t) for t in extra]
        self.clean_up_tokenization_spaces = bool(
            cfg.get("clean_up_tokenization_spaces", False))
        if llama and cfg.get("add_prefix_space") is not None:
            raise TokenizerFormatError(
                "add_prefix_space in tokenizer_config.json makes "
                "transformers rebuild the tokenizer from tokenizer.model; "
                "that is not supported")

        before, after = _template(spec.get("post_processor"))
        if llama:
            # LlamaTokenizerFast rewrites the post-processor from its own
            # add_bos_token/add_eos_token (defaults True/False).
            before = [self.bos_token] if cfg.get("add_bos_token", True) \
                else []
            after = [self.eos_token] if cfg.get("add_eos_token", False) \
                else []
        self._prefix = [self._require(t) for t in before]
        self._suffix = [self._require(t) for t in after]

        template = cfg.get("chat_template")
        jinja_file = os.path.join(path, "chat_template.jinja")
        if os.path.isfile(jinja_file):
            with open(jinja_file, encoding="utf-8") as f:
                template = f.read()
        if isinstance(template, list):
            named = {t["name"]: t["template"] for t in template}
            template = named.get("default")
        self.chat_template: Optional[str] = template
        self._token_bytes: Dict[int, Optional[bytes]] = {}

    def _build_matchers(self, split_special: bool):
        raw, norm = {}, {}
        for t in self._added.values():
            if split_special and t.special:
                continue
            if not t.normalized:
                raw[t.content] = t
            else:
                norm[self._normalize(t.content) if self._normalize
                     else t.content] = t
        return _Matcher(raw), _Matcher(norm)

    # -- vocabulary -------------------------------------------------------

    def _lookup(self, token: str) -> Optional[int]:
        added = self._added_by_content.get(token)
        if added is not None:
            return added.id
        return self._model.vocab.get(token)

    def _require(self, token: Optional[str]) -> int:
        i = None if token is None else self._lookup(token)
        if i is None:
            raise TokenizerFormatError(
                f"post-processor token {token!r} is not in the vocabulary")
        return i

    def _id_token(self, i: int) -> Optional[str]:
        added = self._added.get(i)
        if added is not None:
            return added.content
        return self._model.id_to_token.get(i)

    @property
    def vocab_size(self) -> int:
        return len(self._model.vocab)

    def __len__(self) -> int:
        return len(set(self._model.id_to_token) | set(self._added))

    def convert_ids_to_tokens(self, ids, skip_special_tokens: bool = False):
        if isinstance(ids, int):
            return self._id_token(ids)
        return [self._id_token(int(i)) for i in ids
                if not (skip_special_tokens and int(i) in self._special_ids)]

    @property
    def bos_token(self) -> Optional[str]:
        return self._special_tokens["bos_token"]

    @property
    def eos_token(self) -> Optional[str]:
        return self._special_tokens["eos_token"]

    @property
    def unk_token(self) -> Optional[str]:
        return self._special_tokens["unk_token"]

    @property
    def pad_token(self) -> Optional[str]:
        return self._special_tokens["pad_token"]

    def _special_id(self, key: str) -> Optional[int]:
        tok = self._special_tokens[key]
        return None if tok is None else self._lookup(tok)

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._special_id("bos_token")

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._special_id("eos_token")

    @property
    def unk_token_id(self) -> Optional[int]:
        return self._special_id("unk_token")

    @property
    def pad_token_id(self) -> Optional[int]:
        return self._special_id("pad_token")

    @property
    def special_tokens_map(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {k: v for k, v in self._special_tokens.items()
                               if v is not None}
        if self.additional_special_tokens:
            out["additional_special_tokens"] = list(
                self.additional_special_tokens)
        return out

    # -- encode -----------------------------------------------------------

    def _encode_piece(self, text: str, at_start: bool, norm_match,
                      out: List[int]):
        if self._normalize is not None:
            text = self._normalize(text)
        for k, (piece, tid) in enumerate(norm_match.split(text)):
            if tid is not None:
                out.append(tid)
                continue
            for word in self._pre(piece, at_start and k == 0):
                out.extend(self._model.tokenize(word))

    def encode(self, text: str, add_special_tokens: bool = True,
               split_special_tokens: bool = False) -> List[int]:
        """Ids of ``text``: added tokens matched first, the rest through
        normalizer, pre-tokenizer and BPE; with ``add_special_tokens`` the
        post-processor's tokens around them. ``split_special_tokens``
        encodes special tokens' strings in the text as plain text."""
        ids: List[int] = list(self._prefix) if add_special_tokens else []
        raw_match, norm_match = self._matchers[split_special_tokens]
        offset = 0
        for piece, tid in raw_match.split(text):
            if tid is not None:
                ids.append(tid)
            elif piece:
                self._encode_piece(piece, offset == 0, norm_match, ids)
            offset += len(piece)
        if add_special_tokens:
            ids.extend(self._suffix)
        return ids

    # -- decode -----------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        if isinstance(ids, int):
            ids = [ids]
        tokens = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self._special_ids:
                continue
            tok = self._id_token(i)
            if tok is not None:
                tokens.append(tok)
        if self._decode_chain is None:
            text = " ".join(tokens)
        else:
            text = "".join(self._decode_chain(tokens))
        clean = (self.clean_up_tokenization_spaces
                 if clean_up_tokenization_spaces is None
                 else clean_up_tokenization_spaces)
        return clean_up_tokenization(text) if clean else text

    def unsettled_tail(self, ids: Sequence[int]) -> int:
        """How many trailing ids of ``ids`` a later id can still change
        the decoded text of: the run of ``<0xXX>`` tokens at the end under
        a byte-fallback decoder (a run that turns out not to be UTF-8
        decodes to one U+FFFD per byte, its valid bytes included), with
        the ids inside it that decode drops (no token)."""
        if not self._model.byte_fallback:
            return 0
        n = run = 0
        for k, i in enumerate(reversed(ids), 1):
            tok = self._id_token(int(i))
            if tok is None:
                continue
            if len(tok) != 6 or not _BYTE_TOKEN.fullmatch(tok):
                break
            run = k
        return run

    def token_bytes(self, i: int) -> Optional[bytes]:
        """The bytes id ``i`` adds to the decoded stream wherever it
        stands, without the decoder's start-of-text stripping; None for a
        special token and an unknown id. A byte-level token can be a cut
        UTF-8 sequence; ``<0xXX>`` is its one byte."""
        if i in self._token_bytes:
            return self._token_bytes[i]
        tok = None if i in self._special_ids else self._id_token(i)
        data: Optional[bytes] = None
        if tok is not None:
            if i in self._added:
                data = tok.encode("utf-8")
            elif self._byte_level:
                back = _byte_level_tables()[1]
                try:
                    data = bytes(back[c] for c in tok)
                except KeyError:
                    data = tok.encode("utf-8")
            else:
                m = _BYTE_TOKEN.fullmatch(tok)
                if m and self._model.byte_fallback:
                    data = bytes([int(m.group(1), 16)])
                else:
                    data = tok.replace(SPIECE, " ").encode("utf-8")
        self._token_bytes[i] = data
        return data

    # -- chat -------------------------------------------------------------

    def apply_chat_template(self, conversation: Sequence[dict],
                            tokenize: bool = True,
                            add_generation_prompt: bool = False,
                            chat_template: Optional[str] = None, **kwargs):
        """The conversation rendered through the chat template with the
        special tokens and ``add_generation_prompt`` in scope, as
        transformers renders it; with ``tokenize`` its ids, encoded
        without the post-processor's special tokens."""
        source = chat_template or self.chat_template
        if source is None:
            raise ValueError(
                f"{self.path}: the tokenizer has no chat template")
        text = compile_chat_template(source).render(
            messages=list(conversation), tools=None, documents=None,
            add_generation_prompt=add_generation_prompt,
            **{**self.special_tokens_map, **kwargs})
        if tokenize:
            return self.encode(text, add_special_tokens=False)
        return text


def _read_json(path: str) -> Optional[Any]:
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _read_directory(path: str) -> Tuple[dict, dict]:
    """(tokenizer.json spec, tokenizer_config) of a tokenizer directory:
    its tokenizer.json, else the spec transformers builds from
    vocab.json + merges.txt or from tokenizer.model."""
    cfg = _read_json(os.path.join(path, "tokenizer_config.json")) or {}
    spec = _read_json(os.path.join(path, "tokenizer.json"))
    if spec is not None:
        return spec, cfg
    # transformers lets special_tokens_map.json override the config's.
    cfg = {**cfg, **(_read_json(os.path.join(
        path, "special_tokens_map.json")) or {})}
    if all(os.path.isfile(os.path.join(path, n))
           for n in ("vocab.json", "merges.txt")):
        return _gpt2_spec(path, cfg)
    model = os.path.join(path, "tokenizer.model")
    if os.path.isfile(model):
        from runbooks_tpu_torch.models import sentencepiece_io as spm

        try:
            spec, defaults = spm.tokenizer_spec(spm.read_model(model))
        except spm.SentencePieceFormatError as exc:
            raise TokenizerFormatError(
                f"{model} (sentencepiece): {exc}") from None
        cfg = {**defaults, **cfg}
        # The slow-to-fast conversion registers every special token of
        # the config as a special added token, at its piece's id.
        have = {t["content"] for t in spec["added_tokens"]}
        for key in _SPECIAL_KEYS:
            content = _token_content(cfg.get(key))
            if content in spec["model"]["vocab"] and content not in have:
                have.add(content)
                spec["added_tokens"].append({
                    "id": spec["model"]["vocab"][content],
                    "content": content, "single_word": False,
                    "lstrip": False, "rstrip": False, "normalized": False,
                    "special": True})
        spec["added_tokens"].sort(key=lambda t: t["id"])
        return spec, cfg
    raise TokenizerFormatError(
        f"{path}: no tokenizer.json, vocab.json + merges.txt or "
        "tokenizer.model")


def _gpt2_spec(path: str, cfg: dict) -> Tuple[dict, dict]:
    """The byte-level BPE transformers' GPT2Converter builds from
    vocab.json and merges.txt (read as GPT2Tokenizer reads them: the
    first line and the last are dropped), with the special tokens as
    added tokens and the config's add_bos_token and add_prefix_space."""
    with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
        vocab = json.load(f)
    with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
        lines = f.read().split("\n")[1:-1]
    merges = [list(m) for m in dict.fromkeys(
        tuple(line.split()) for line in lines)]
    cfg = {"tokenizer_class": "GPT2TokenizerFast",
           **{k: "<|endoftext|>" for k in ("bos_token", "eos_token",
                                           "unk_token")}, **cfg}
    if cfg.get("add_prefix_space"):
        raise TokenizerFormatError(
            f"{path}: add_prefix_space is not supported")
    # Each special token is an added token: at its vocab id when the
    # vocab has it, else appended after the vocab.
    ids: Dict[str, int] = {}
    extra = [_token_content(t) for t in cfg.get(
        "additional_special_tokens") or []]
    for content in [_token_content(cfg.get(k)) for k in _SPECIAL_KEYS] \
            + extra:
        if content is not None and content not in ids:
            ids[content] = vocab.get(content, len(vocab) + sum(
                1 for c in ids if c not in vocab))
    added = [{"id": i, "content": c, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": True, "special": True}
             for c, i in sorted(ids.items(), key=lambda kv: kv[1])]
    if cfg.get("add_bos_token"):
        bos = _token_content(cfg["bos_token"])
        post = {"type": "TemplateProcessing",
                "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                           {"Sequence": {"id": "A", "type_id": 0}}],
                "special_tokens": {bos: {"id": bos, "ids": [ids[bos]],
                                         "tokens": [bos]}}}
    else:
        post = {"type": "ByteLevel", "trim_offsets": False}
    spec = {"added_tokens": added, "normalizer": None,
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                              "trim_offsets": True, "use_regex": True},
            "post_processor": post, "decoder": {"type": "ByteLevel"},
            "model": {"type": "BPE", "vocab": vocab, "merges": merges,
                      "fuse_unk": False, "byte_fallback": False}}
    return spec, cfg


def load(path: str) -> HFTokenizer:
    """The tokenizer directory at ``path``."""
    if not os.path.isdir(path):
        raise TokenizerFormatError(f"{path}: not a directory")
    return HFTokenizer(path)
