"""Grammar-constrained structured output: host-side compiler from a
per-request ``response_format`` (JSON-schema subset or raw EBNF) to a
token-level DFA over the engine's tokenizer vocabulary (the port's own
copy of ``runbooks_tpu.serve.grammar``; numpy only).

The contract with the engine (serve/engine.py):

- Compilation is host-side and cached: regex-shaped AST -> Thompson NFA
  -> byte-subset DFA -> per-grammar token transition table
  ``[num_states, vocab]`` int32 plus per-state bool mask rows. The engine
  hands mask rows to every dispatch as a ``[B, vocab]`` bool operand
  (``gmask``).
- The LRU compile cache is keyed on (grammar hash, tokenizer
  fingerprint): a model/tokenizer swap changes the fingerprint and can
  never serve a stale mask.
- Per-slot decode state is a :class:`GrammarCursor`, one int, which
  rides the request object.
- EOS is allowed exactly at accepting DFA states; a state with no legal
  continuation token is *terminal* and the engine finishes the slot with
  ``finish_reason: "grammar_complete"`` without dispatching its (empty)
  mask row.

Unsupported constructs raise :class:`GrammarError` (a ``ValueError``),
which the API maps to a typed 400 — silently serving unconstrained
output for a schema we cannot enforce would be a correctness bug.
"""

from __future__ import annotations

import hashlib
import json
import re
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class GrammarError(ValueError):
    """A response_format the compiler cannot enforce (unsupported schema
    construct, malformed EBNF, grammar/tokenizer mismatch). Subclasses
    ValueError so the serve API's validation path turns it into a typed
    400 with the construct named."""


# ---------------------------------------------------------------------------
# Tokenizer vocabulary view + stable fingerprint
# ---------------------------------------------------------------------------

def _token_bytes_table(tokenizer) -> Tuple[List[Optional[bytes]], int]:
    """Per-token-id byte strings (None for specials/unrepresentable) and
    the eos id. The byte tokenizer and a tokenizer with ``token_bytes``
    (an HF directory read by ``models.tokenizer_io``) give each id's exact
    bytes. Others fall back to ``decode([i])``, which is wrong for a
    byte-level token that is a cut UTF-8 sequence (it decodes to U+FFFD)
    and for a sentencepiece piece whose leading space the decoder strips;
    the reference builds every table that way."""
    from runbooks_tpu_torch.train.data import ByteTokenizer

    specials = set()
    for attr in ("bos_id", "eos_id", "bos_token_id", "eos_token_id",
                 "pad_token_id", "unk_token_id"):
        val = getattr(tokenizer, attr, None)
        if val is not None:
            specials.add(int(val))
    eos = getattr(tokenizer, "eos_id", None)
    if eos is None:
        eos = getattr(tokenizer, "eos_token_id", None)
    if eos is None:
        raise GrammarError("tokenizer has no eos id — a grammar could "
                           "never terminate")
    n = int(getattr(tokenizer, "vocab_size"))
    table: List[Optional[bytes]] = [None] * n
    if isinstance(tokenizer, ByteTokenizer):
        for i in range(256):
            table[i] = bytes([i])
    elif hasattr(tokenizer, "token_bytes"):
        for i in range(n):
            if i not in specials:
                table[i] = tokenizer.token_bytes(i) or None
    else:
        for i in range(n):
            if i in specials:
                continue
            text = tokenizer.decode([i])
            data = text.encode("utf-8")
            table[i] = data if data else None
    for i in specials:
        if 0 <= i < n:
            table[i] = None
    return table, int(eos)


class TokenVocab:
    """The tokenizer as the DFA compiler sees it: id -> byte string
    (None for specials), the eos id, and a stable content fingerprint
    (sha256 over the id->bytes map) that keys the compile cache."""

    __slots__ = ("token_bytes", "eos_id", "vocab_size", "fingerprint")

    def __init__(self, token_bytes: Sequence[Optional[bytes]],
                 eos_id: int):
        self.token_bytes = list(token_bytes)
        self.eos_id = int(eos_id)
        self.vocab_size = len(self.token_bytes)
        h = hashlib.sha256()
        for i, data in enumerate(self.token_bytes):
            h.update(b"%d:" % i)
            h.update(data if data is not None else b"\xff<special>")
            h.update(b"\x00")
        h.update(b"eos:%d" % self.eos_id)
        self.fingerprint = h.hexdigest()

    @classmethod
    def from_tokenizer(cls, tokenizer) -> "TokenVocab":
        table, eos = _token_bytes_table(tokenizer)
        return cls(table, eos)


# ---------------------------------------------------------------------------
# Regex-shaped AST -> Thompson NFA -> byte-subset DFA
#
# AST nodes are plain tuples: ("lit", bytes), ("class", frozenset[int]),
# ("seq", [n...]), ("alt", [n...]), ("star", n), ("eps",). plus/opt
# desugar at construction.
# ---------------------------------------------------------------------------

EPS = ("eps",)


def _seq(nodes):
    nodes = [n for n in nodes if n != EPS]
    if not nodes:
        return EPS
    return nodes[0] if len(nodes) == 1 else ("seq", nodes)


def _alt(nodes):
    return nodes[0] if len(nodes) == 1 else ("alt", nodes)


def _plus(node):
    return _seq([node, ("star", node)])


def _opt(node):
    return _alt([node, EPS])


class _NfaBuilder:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.byte: List[Dict[int, List[int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.byte.append({})
        return len(self.eps) - 1

    def add(self, node) -> Tuple[int, int]:
        kind = node[0]
        if kind == "eps":
            s = self.state()
            return s, s
        if kind == "lit":
            start = self.state()
            cur = start
            for b in node[1]:
                nxt = self.state()
                self.byte[cur].setdefault(b, []).append(nxt)
                cur = nxt
            return start, cur
        if kind == "class":
            if not node[1]:
                raise GrammarError("empty character class matches nothing")
            start, end = self.state(), self.state()
            for b in node[1]:
                self.byte[start].setdefault(b, []).append(end)
            return start, end
        if kind == "seq":
            start, end = self.add(node[1][0])
            for sub in node[1][1:]:
                s2, e2 = self.add(sub)
                self.eps[end].append(s2)
                end = e2
            return start, end
        if kind == "alt":
            start, end = self.state(), self.state()
            for sub in node[1]:
                s2, e2 = self.add(sub)
                self.eps[start].append(s2)
                self.eps[e2].append(end)
            return start, end
        if kind == "star":
            start = self.state()
            s2, e2 = self.add(node[1])
            end = self.state()
            self.eps[start] += [s2, end]
            self.eps[e2] += [s2, end]
            return start, end
        raise GrammarError(f"unknown AST node {kind!r}")


# Compiled byte-DFA state cap: a schema within the supported subset
# lands in the tens-to-hundreds; hitting this means a pathological
# grammar that would also make per-step mask rows unreasonably wide.
MAX_DFA_STATES = 4096


def _ast_to_byte_dfa(node) -> Tuple[List[Dict[int, int]], List[bool]]:
    """(transitions per state {byte -> state}, accept flags) via subset
    construction. State 0 is the start."""
    nfa = _NfaBuilder()
    start, accept = nfa.add(node)

    def closure(states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = closure(frozenset([start]))
    index = {start_set: 0}
    order = [start_set]
    trans: List[Dict[int, int]] = [{}]
    accepts = [accept in start_set]
    i = 0
    while i < len(order):
        cur = order[i]
        by_byte: Dict[int, set] = {}
        for s in cur:
            for b, dests in nfa.byte[s].items():
                by_byte.setdefault(b, set()).update(dests)
        for b, dests in sorted(by_byte.items()):
            nxt = closure(frozenset(dests))
            if nxt not in index:
                if len(order) >= MAX_DFA_STATES:
                    raise GrammarError(
                        f"grammar too large: byte DFA exceeds "
                        f"{MAX_DFA_STATES} states")
                index[nxt] = len(order)
                order.append(nxt)
                trans.append({})
                accepts.append(accept in nxt)
            trans[i][b] = index[nxt]
        i += 1
    return trans, accepts


# ---------------------------------------------------------------------------
# Token-level DFA
# ---------------------------------------------------------------------------

class TokenDfa:
    """A byte DFA lifted to the token vocabulary: ``trans[s, t]`` is the
    state after emitting token ``t`` from state ``s`` (-1 = illegal), and
    ``masks[s]`` is the ready-to-dispatch bool row over ``mask_width``
    ids (eos allowed at accepting states). ``terminal[s]`` marks states
    whose only legal move is eos — the engine's ``grammar_complete``."""

    __slots__ = ("trans", "masks", "accept", "terminal", "eos_id",
                 "num_states", "mask_width", "key")

    def __init__(self, byte_trans: List[Dict[int, int]],
                 accepts: List[bool], vocab: TokenVocab,
                 mask_width: int, key: str = ""):
        n_states = len(byte_trans)
        if vocab.eos_id >= mask_width:
            raise GrammarError(
                f"tokenizer eos id {vocab.eos_id} is outside the model's "
                f"logit width {mask_width}")
        # Only tokens that spell bytes can move: the pruning below runs on
        # their columns alone (at a 128256-wide vocab with the byte
        # tokenizer, 256 of them), and the other columns stay -1.
        cols = [tok for tok in range(min(vocab.vocab_size, mask_width))
                if vocab.token_bytes[tok]]
        sub = np.full((n_states, len(cols)), -1, np.int32)
        for j, tok in enumerate(cols):
            data = vocab.token_bytes[tok]
            for s in range(n_states):
                cur = s
                for b in data:
                    cur = byte_trans[cur].get(b, -1)
                    if cur < 0:
                        break
                sub[s, j] = cur
        accept = np.asarray(accepts, bool)
        # Coaccessibility prune at TOKEN level: a byte path may exist
        # where no token spells it (multi-byte tokens). Transitions into
        # states that cannot reach an accepting state via tokens would
        # deadlock a slot mid-generation: cut them, then re-check.
        live = accept.copy()
        changed = True
        while changed:
            changed = False
            reaches = live[np.where(sub >= 0, sub, 0)] & (sub >= 0)
            new_live = live | reaches.any(axis=1)
            if (new_live != live).any():
                live = new_live
                changed = True
        dead_edge = (sub >= 0) & ~live[np.where(sub >= 0, sub, 0)]
        sub[dead_edge] = -1
        trans = np.full((n_states, mask_width), -1, np.int32)
        trans[:, cols] = sub
        if not live[0]:
            raise GrammarError(
                "grammar is not expressible with this tokenizer "
                "vocabulary (no token path reaches an accepting state)")
        masks = trans >= 0
        masks[accept, vocab.eos_id] = True
        has_continuation = (trans >= 0).any(axis=1)
        for s in range(n_states):
            if live[s] and not accept[s] and not has_continuation[s]:
                raise GrammarError(
                    "grammar dead-ends: a reachable state has no legal "
                    "continuation token and is not accepting")
        self.trans = trans
        self.masks = masks
        self.accept = accept
        self.terminal = accept & ~has_continuation
        self.eos_id = vocab.eos_id
        self.num_states = n_states
        self.mask_width = mask_width
        self.key = key

    def cursor(self) -> "GrammarCursor":
        return GrammarCursor(self)


class GrammarCursor:
    """Per-slot decode state: a compiled DFA plus one int, carried on the
    Request object."""

    __slots__ = ("dfa", "state")

    def __init__(self, dfa: TokenDfa, state: int = 0):
        self.dfa = dfa
        self.state = int(state)

    def mask_row(self) -> np.ndarray:
        """Read-only bool [mask_width] row for the current state."""
        return self.dfa.masks[self.state]

    def legal(self, tok: int) -> bool:
        return (tok == self.dfa.eos_id and self.accepting) \
            or self.dfa.trans[self.state, tok] >= 0

    def advance(self, tok: int) -> bool:
        """Consume one emitted token; False (state unchanged) when the
        token is illegal here (the masked sampler makes that a bug)."""
        nxt = self.dfa.trans[self.state, tok]
        if nxt < 0:
            return False
        self.state = int(nxt)
        return True

    def walk(self, tokens: Sequence[int]) -> List[int]:
        """States after each legal token of ``tokens``, stopping at the
        first illegal one. Non-mutating: draft gating and the verify
        forward's per-position masks both preview with this."""
        out: List[int] = []
        cur = self.state
        for tok in tokens:
            nxt = self.dfa.trans[cur, tok]
            if nxt < 0:
                break
            cur = int(nxt)
            out.append(cur)
        return out

    @property
    def accepting(self) -> bool:
        return bool(self.dfa.accept[self.state])

    @property
    def at_terminal(self) -> bool:
        return bool(self.dfa.terminal[self.state])


# ---------------------------------------------------------------------------
# JSON-schema subset front-end (compact JSON, no whitespace)
# ---------------------------------------------------------------------------

# Constructs we refuse rather than silently ignore: each changes the
# accepted language, so dropping one would serve output the caller's
# schema rejects.
_UNSUPPORTED_SCHEMA_KEYS = (
    "$ref", "$defs", "definitions", "oneOf", "anyOf", "allOf", "not",
    "patternProperties", "pattern", "format", "if", "then", "else",
    "minLength", "maxLength", "minimum", "maximum", "exclusiveMinimum",
    "exclusiveMaximum", "multipleOf", "maxItems", "uniqueItems",
    "propertyNames", "dependencies", "dependentSchemas", "contains",
    "prefixItems", "additionalItems", "minProperties", "maxProperties",
)
# Annotation-only keys that do not change the language.
_IGNORED_SCHEMA_KEYS = {"title", "description", "$schema", "examples",
                        "default", "$comment", "name"}

# JSON string body: printable ASCII minus the quote and backslash (no
# escape sequences in the subset).
_STRING_CHARS = frozenset(b for b in range(0x20, 0x7F)
                          if b not in (0x22, 0x5C))
_DIGITS = frozenset(range(0x30, 0x3A))
_DIGITS19 = frozenset(range(0x31, 0x3A))

_INTEGER_AST = _seq([
    _opt(("lit", b"-")),
    _alt([("lit", b"0"),
          _seq([("class", _DIGITS19), ("star", ("class", _DIGITS))])]),
])
_NUMBER_AST = _seq([
    _INTEGER_AST,
    _opt(_seq([("lit", b"."), _plus(("class", _DIGITS))])),
])


def _json_literal_ast(value, path: str):
    if isinstance(value, (str, int, float, bool)) or value is None:
        return ("lit", json.dumps(value, separators=(",", ":"),
                                  ensure_ascii=True).encode("ascii"))
    raise GrammarError(f"{path}: enum/const values must be scalars, "
                       f"got {type(value).__name__}")


def schema_to_ast(schema, path: str = "$"):
    """JSON-schema subset -> regex AST accepting exactly the compact
    (no-whitespace) JSON serializations the schema allows."""
    if not isinstance(schema, dict):
        raise GrammarError(f"{path}: schema must be an object, "
                           f"got {type(schema).__name__}")
    bad = [k for k in _UNSUPPORTED_SCHEMA_KEYS if k in schema]
    if bad:
        raise GrammarError(
            f"{path}: unsupported schema construct(s) "
            f"{', '.join(sorted(bad))} (docs/structured-output.md lists "
            "the supported subset)")
    known = {"type", "properties", "required", "additionalProperties",
             "items", "enum", "const", "minItems"} | _IGNORED_SCHEMA_KEYS
    unknown = sorted(k for k in schema if k not in known)
    if unknown:
        raise GrammarError(f"{path}: unknown schema key(s) "
                           f"{', '.join(unknown)}")
    if "const" in schema:
        return _json_literal_ast(schema["const"], path)
    if "enum" in schema:
        values = schema["enum"]
        if not isinstance(values, list) or not values:
            raise GrammarError(f"{path}: enum must be a non-empty list")
        return _alt([_json_literal_ast(v, path) for v in values])
    t = schema.get("type")
    if isinstance(t, list):
        raise GrammarError(f"{path}: union types are unsupported")
    if t == "object":
        props = schema.get("properties") or {}
        if not isinstance(props, dict):
            raise GrammarError(f"{path}: properties must be an object")
        extra = schema.get("additionalProperties", False)
        if extra is not False:
            raise GrammarError(
                f"{path}: additionalProperties must be false — open "
                "objects are not a regular language")
        required = schema.get("required")
        if required is not None and set(required) != set(props):
            raise GrammarError(
                f"{path}: optional properties are unsupported; "
                "`required` must list every property")
        if not props:
            return ("lit", b"{}")
        parts = [("lit", b"{")]
        for i, (name, sub) in enumerate(props.items()):
            if i:
                parts.append(("lit", b","))
            parts.append(("lit", json.dumps(
                str(name), ensure_ascii=True).encode("ascii") + b":"))
            parts.append(schema_to_ast(sub, f"{path}.{name}"))
        parts.append(("lit", b"}"))
        return _seq(parts)
    if t == "array":
        items = schema.get("items")
        if items is None:
            raise GrammarError(f"{path}: array requires `items`")
        item = schema_to_ast(items, f"{path}[]")
        min_items = schema.get("minItems", 0)
        if min_items not in (0, 1):
            raise GrammarError(f"{path}: minItems must be 0 or 1")
        nonempty = _seq([("lit", b"["), item,
                         ("star", _seq([("lit", b","), item])),
                         ("lit", b"]")])
        if min_items == 1:
            return nonempty
        return _alt([("lit", b"[]"), nonempty])
    if t == "string":
        return _seq([("lit", b'"'), ("star", ("class", _STRING_CHARS)),
                     ("lit", b'"')])
    if t == "integer":
        return _INTEGER_AST
    if t == "number":
        return _NUMBER_AST
    if t == "boolean":
        return _alt([("lit", b"true"), ("lit", b"false")])
    if t == "null":
        return ("lit", b"null")
    if t is None:
        raise GrammarError(f"{path}: schema needs a `type`, `enum`, or "
                           "`const`")
    raise GrammarError(f"{path}: unsupported type {t!r}")


# ---------------------------------------------------------------------------
# EBNF front-end
# ---------------------------------------------------------------------------

_EBNF_TOKEN_RE = re.compile(r"""
    \s+
  | (?P<name>[A-Za-z_][A-Za-z0-9_-]*)
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<class>\[(?:[^\]\\]|\\.)+\])
  | (?P<op>[()|*+?])
""", re.VERBOSE)

_ESCAPES = {"n": 0x0A, "t": 0x09, "r": 0x0D, "\\": 0x5C, '"': 0x22,
            "'": 0x27, "]": 0x5D, "[": 0x5B, "-": 0x2D}


def _unescape(body: str, rule: str) -> bytes:
    out = bytearray()
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == "\\":
            i += 1
            if i >= len(body) or body[i] not in _ESCAPES:
                raise GrammarError(
                    f"rule {rule!r}: bad escape \\{body[i:i+1]}")
            out.append(_ESCAPES[body[i]])
        else:
            out += ch.encode("utf-8")
        i += 1
    return bytes(out)


def _parse_class(body: str, rule: str) -> frozenset:
    """``[a-z0-9_]`` body (brackets stripped) -> byte set."""
    raw = _unescape(body, rule)
    chars: set = set()
    i = 0
    while i < len(raw):
        if i + 2 < len(raw) and raw[i + 1:i + 2] == b"-":
            lo, hi = raw[i], raw[i + 2]
            if lo > hi:
                raise GrammarError(f"rule {rule!r}: bad range in class")
            chars.update(range(lo, hi + 1))
            i += 3
        else:
            chars.add(raw[i])
            i += 1
    if not chars:
        raise GrammarError(f"rule {rule!r}: empty character class")
    return frozenset(chars)


class _EbnfParser:
    """One rule body: alternation of concatenations of postfix atoms."""

    def __init__(self, text: str, rule: str):
        self.rule = rule
        self.toks: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _EBNF_TOKEN_RE.match(text, pos)
            if m is None:
                raise GrammarError(
                    f"rule {rule!r}: cannot tokenize at {text[pos:pos+12]!r}")
            pos = m.end()
            for kind in ("name", "string", "class", "op"):
                if m.group(kind) is not None:
                    self.toks.append((kind, m.group(kind)))
                    break
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def parse(self, refs: List[str]):
        node = self.alternation(refs)
        if self.i != len(self.toks):
            raise GrammarError(f"rule {self.rule!r}: trailing tokens "
                               f"after expression")
        return node

    def alternation(self, refs):
        branches = [self.concat(refs)]
        while self.peek() == ("op", "|"):
            self.i += 1
            branches.append(self.concat(refs))
        return _alt(branches)

    def concat(self, refs):
        parts = []
        while True:
            kind, val = self.peek()
            if kind is None or (kind == "op" and val in ("|", ")")):
                break
            parts.append(self.postfix(refs))
        return _seq(parts) if parts else EPS

    def postfix(self, refs):
        node = self.atom(refs)
        kind, val = self.peek()
        while kind == "op" and val in ("*", "+", "?"):
            self.i += 1
            node = {"*": lambda n: ("star", n), "+": _plus,
                    "?": _opt}[val](node)
            kind, val = self.peek()
        return node

    def atom(self, refs):
        kind, val = self.peek()
        self.i += 1
        if kind == "string":
            data = _unescape(val[1:-1], self.rule)
            return ("lit", data) if data else EPS
        if kind == "class":
            return ("class", _parse_class(val[1:-1], self.rule))
        if kind == "name":
            refs.append(val)
            return ("ref", val)
        if kind == "op" and val == "(":
            node = self.alternation(refs)
            if self.peek() != ("op", ")"):
                raise GrammarError(f"rule {self.rule!r}: unbalanced parens")
            self.i += 1
            return node
        raise GrammarError(f"rule {self.rule!r}: unexpected {val!r}")


def ebnf_to_ast(text: str):
    """``name ::= expr`` rule set -> one AST. References must form a DAG
    (token DFAs are regular languages; recursive rules are the
    context-free frontier and raise)."""
    if not isinstance(text, str) or not text.strip():
        raise GrammarError("ebnf grammar must be a non-empty string")
    bodies: Dict[str, object] = {}
    deps: Dict[str, List[str]] = {}
    order: List[str] = []
    for raw_line in text.splitlines():
        line = raw_line.split("#", 1)[0].strip()
        if not line:
            continue
        if "::=" not in line:
            raise GrammarError(f"expected `name ::= expr`, got {line!r}")
        name, body = (part.strip() for part in line.split("::=", 1))
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_-]*", name):
            raise GrammarError(f"bad rule name {name!r}")
        if name in bodies:
            raise GrammarError(f"rule {name!r} defined twice")
        refs: List[str] = []
        bodies[name] = _EbnfParser(body, name).parse(refs)
        deps[name] = refs
        order.append(name)
    start = "root" if "root" in bodies else order[0]

    resolved: Dict[str, object] = {}
    visiting: set = set()

    def resolve(name: str):
        if name in resolved:
            return resolved[name]
        if name not in bodies:
            raise GrammarError(f"undefined rule {name!r}")
        if name in visiting:
            raise GrammarError(
                f"rule {name!r} is recursive — recursive rules are "
                "unsupported (token DFAs are regular)")
        visiting.add(name)

        def subst(node):
            kind = node[0]
            if kind == "ref":
                return resolve(node[1])
            if kind in ("seq", "alt"):
                return (kind, [subst(n) for n in node[1]])
            if kind == "star":
                return ("star", subst(node[1]))
            return node

        resolved[name] = subst(bodies[name])
        visiting.discard(name)
        return resolved[name]

    return resolve(start)


# ---------------------------------------------------------------------------
# response_format entry point + LRU compile cache
# ---------------------------------------------------------------------------

def response_format_ast(response_format) -> Tuple[object, str]:
    """(AST, canonical grammar key) for a request body's
    ``response_format``. Shapes accepted:
    ``{"type": "json_schema", "json_schema": {...}}`` (optionally with
    the OpenAI-style nested ``{"name", "schema"}`` wrapper) and
    ``{"type": "ebnf", "grammar": "..."}``."""
    if not isinstance(response_format, dict):
        raise GrammarError("response_format must be an object")
    kind = response_format.get("type")
    if kind == "json_schema":
        schema = response_format.get("json_schema")
        if isinstance(schema, dict) and "schema" in schema:
            schema = schema["schema"]
        if schema is None:
            raise GrammarError(
                "response_format.json_schema is required for type "
                "json_schema")
        ast = schema_to_ast(schema)
    elif kind == "ebnf":
        ast = ebnf_to_ast(response_format.get("grammar"))
    elif kind == "json_object":
        raise GrammarError(
            "type json_object (free-form JSON) is not a regular "
            "language; provide a json_schema instead")
    else:
        raise GrammarError(
            f"response_format.type must be json_schema or ebnf, "
            f"got {kind!r}")
    key = hashlib.sha256(json.dumps(
        response_format, sort_keys=True, separators=(",", ":"),
        default=str).encode("utf-8")).hexdigest()
    return ast, key


class GrammarCache:
    """LRU of compiled :class:`TokenDfa`, keyed on (grammar hash,
    tokenizer fingerprint). Thread-safe: the HTTP handler threads validate
    (and so compile) off the engine's worker thread."""

    def __init__(self, vocab: TokenVocab, mask_width: int,
                 capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"grammar_cache_size must be >= 1, "
                             f"got {capacity}")
        self.vocab = vocab
        self.mask_width = int(mask_width)
        self.capacity = int(capacity)
        self._lru: "OrderedDict[Tuple[str, str], TokenDfa]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.compile_seconds_total = 0.0

    def get(self, response_format) -> TokenDfa:
        ast, grammar_key = response_format_ast(response_format)
        key = (grammar_key, self.vocab.fingerprint)
        with self._lock:
            dfa = self._lru.get(key)
            if dfa is not None:
                self._lru.move_to_end(key)
                self.hits += 1
                return dfa
        t0 = time.monotonic()
        byte_trans, accepts = _ast_to_byte_dfa(ast)
        dfa = TokenDfa(byte_trans, accepts, self.vocab, self.mask_width,
                       key=grammar_key)
        dt = time.monotonic() - t0
        with self._lock:
            self.misses += 1
            self.compile_seconds_total += dt
            self._lru[key] = dfa
            self._lru.move_to_end(key)
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)
        return dfa

    def cursor(self, response_format) -> GrammarCursor:
        return self.get(response_format).cursor()

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._lru),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "compile_seconds_total": round(
                    self.compile_seconds_total, 6),
                "tokenizer_fingerprint": self.vocab.fingerprint,
            }
