"""Input pipeline: tokenize -> pack -> batch (the port's copy of
``runbooks_tpu.train.data``, host side).

Numpy in, numpy out: the same files and seed give the same arrays as the
reference. Documents are packed several to a row with ``segment_ids`` (0 =
padding) and positions that restart per document, so the attention masks
keep documents apart. The trainer moves each batch to the device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

Batch = Dict[str, np.ndarray]


class ByteTokenizer:
    """Dependency-free byte-level tokenizer: ids 0..255 = bytes,
    256 = BOS, 257 = EOS."""

    bos_id = 256
    eos_id = 257
    vocab_size = 258

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


def load_tokenizer(name_or_path: Optional[str] = None):
    """No path: the byte tokenizer. A path raises: reading HF tokenizers
    is not ported yet, and silently training on another token space than
    the one asked for would corrupt the run."""
    if not name_or_path:
        return ByteTokenizer()
    raise NotImplementedError(
        f"tokenizer {name_or_path!r}: loading tokenizer files is not ported "
        "yet; omit `tokenizer` to train with the byte tokenizer")


def read_documents(path: str, text_key: str = "text",
                   prompt_template: Optional[str] = None) -> Iterator[str]:
    """Documents from a file or a directory: .jsonl/.json ({text_key: ...}
    per line, or each record rendered through ``prompt_template`` with
    str.format; records missing a field are skipped), .txt (one document
    per file), or a directory of either, in name order."""
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            yield from read_documents(os.path.join(path, name), text_key,
                                      prompt_template)
        return
    if path.endswith((".jsonl", ".json")):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                if prompt_template is not None and isinstance(obj, dict):
                    try:
                        text = prompt_template.format(**obj)
                    except (KeyError, IndexError):
                        continue
                else:
                    text = obj.get(text_key)
                if text:
                    yield text
    elif path.endswith(".txt"):
        with open(path) as f:
            yield f.read()


def pack_documents(token_docs: Iterable[Sequence[int]], seq_len: int,
                   drop_remainder: bool = False) -> Iterator[Batch]:
    """Greedy-pack token documents into rows of seq_len + 1 tokens. Each
    row has (all [seq_len]) tokens, targets (next token), segment_ids
    (1-based per document, 0 = padding), positions (restarting per
    document) and loss_mask (1 where input and target share a non-pad
    segment). A document longer than a row continues in the next row under
    a new segment id, its positions still counting up."""
    row_toks: List[int] = []
    row_segs: List[int] = []
    row_pos: List[int] = []
    seg = 0

    def flush():
        nonlocal row_toks, row_segs, row_pos, seg
        n = seq_len + 1
        toks, segs, pos = row_toks[:n], row_segs[:n], row_pos[:n]
        pad = n - len(toks)
        if pad:
            toks += [0] * pad
            segs += [0] * pad
            pos += [0] * pad
        row = {
            "tokens": np.asarray(toks[:-1], np.int32),
            "targets": np.asarray(toks[1:], np.int32),
            "segment_ids": np.asarray(segs[:-1], np.int32),
            "positions": np.asarray(pos[:-1], np.int32),
            "loss_mask": np.asarray(
                [1.0 if segs[i] != 0 and segs[i] == segs[i + 1] else 0.0
                 for i in range(seq_len)], np.float32),
        }
        row_toks, row_segs, row_pos = row_toks[n:], row_segs[n:], row_pos[n:]
        if row_toks:
            seg += 1
            row_segs = [seg] * len(row_toks)
        return row

    for doc in token_docs:
        doc = list(doc)
        if not doc:
            continue
        seg += 1
        row_toks += doc
        row_segs += [seg] * len(doc)
        row_pos += list(range(len(doc)))
        while len(row_toks) >= seq_len + 1:
            yield flush()
    if row_toks and not drop_remainder:
        yield flush()


def batch_rows(rows: Iterator[Batch], batch_size: int,
               drop_remainder: bool = True) -> Iterator[Batch]:
    buf: List[Batch] = []
    for row in rows:
        buf.append(row)
        if len(buf) == batch_size:
            yield {k: np.stack([r[k] for r in buf]) for k in buf[0]}
            buf = []
    if buf and not drop_remainder:
        while len(buf) < batch_size:
            buf.append({k: np.zeros_like(v) for k, v in buf[0].items()})
        yield {k: np.stack([r[k] for r in buf]) for k in buf[0]}


def dataset(path: str, seq_len: int, batch_size: int, tokenizer=None,
            epochs: Optional[int] = 1, text_key: str = "text",
            prompt_template: Optional[str] = None) -> Iterator[Batch]:
    """Files -> packed numpy batches; epochs=None loops forever."""
    tokenizer = tokenizer or ByteTokenizer()
    epoch = 0
    while epochs is None or epoch < epochs:
        docs = (tokenizer.encode(t)
                for t in read_documents(path, text_key, prompt_template))
        yield from batch_rows(pack_documents(docs, seq_len), batch_size)
        epoch += 1


def skip_batches(it: Iterator[Batch], n: int) -> Iterator[Batch]:
    """``it`` past its first n batches: a run resumed from a checkpoint
    that had consumed n batches sees batch n first, as the uninterrupted
    run would."""
    it = iter(it)
    for _ in range(n):
        try:
            next(it)
        except StopIteration:
            break
    return it


def synthetic_batches(vocab_size: int, seq_len: int, batch_size: int,
                      seed: int = 0) -> Iterator[Batch]:
    """Random-token batches for benchmarks and smoke tests."""
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(1, vocab_size, (batch_size, seq_len + 1),
                            dtype=np.int32)
        yield {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "loss_mask": np.ones((batch_size, seq_len), np.float32),
        }
