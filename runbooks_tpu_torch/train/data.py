"""Input pipeline: tokenize -> pack -> batch (the port's copy of
``runbooks_tpu.train.data``, host side).

Numpy in, numpy out: the same files and seed give the same arrays as the
reference. Documents are packed several to a row with ``segment_ids`` (0 =
padding) and positions that restart per document, so the attention masks
keep documents apart. ``Prefetcher`` runs tokenize/pack (and, through
``pinned_placer``, the copy into pinned host memory) ahead on a thread;
the trainer copies each batch to the device on its own stream.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence)

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


def load_tokenizer(name_or_path: Optional[str] = None,
                   allow_byte_fallback: bool = False):
    """No path: the byte tokenizer. A path is an HF tokenizer directory,
    read by ``models.tokenizer_io``; one that fails to load raises,
    because training or serving on another token space than the one
    asked for corrupts the run. ``allow_byte_fallback=True`` serves the
    byte tokenizer instead (smoke setups only)."""
    if not name_or_path:
        return ByteTokenizer()
    from runbooks_tpu_torch.models import tokenizer_io

    try:
        return tokenizer_io.load(name_or_path)
    except Exception as exc:
        if allow_byte_fallback:
            print(f"data: tokenizer {name_or_path!r} failed to load "
                  f"({exc!r}); falling back to the byte tokenizer",
                  flush=True)
            return ByteTokenizer()
        raise RuntimeError(
            f"tokenizer {name_or_path!r} could not be loaded (is the path "
            "mounted and complete?). Pass allow_byte_fallback=True to "
            f"serve the byte tokenizer instead: {exc}") from exc


# The Dataset loader's manifest in the directory it fills
# (train/dataset_loader.py).
MANIFEST = "dataset.json"


def read_documents(path: str, text_key: str = "text",
                   prompt_template: Optional[str] = None) -> Iterator[str]:
    """Documents from a file or a directory: .jsonl/.json ({text_key: ...}
    per line, or each record rendered through ``prompt_template`` with
    str.format; records missing a field are skipped), .txt (one document
    per file), or a directory of either, in name order. A directory's
    ``dataset.json`` is the loader's manifest, not data: it is skipped
    (the reference parses it as jsonl and fails on its first line)."""
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name == MANIFEST:
                continue
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


class Prefetcher:
    """Bounded background-thread prefetcher: the thread pulls batches from
    ``it`` (everything upstream: read, tokenize, pack), applies ``place``
    and parks the results in a queue of ``depth`` slots, so the training
    loop does not wait on host work while the device computes the
    previous step.

    As the reference's: batches come out in iterator order; exhausting
    ``it`` ends iteration; an exception in the iterator or in ``place`` is
    raised in the consumer at the position it occurred, after every batch
    produced before it; ``close()`` stops the thread and joins it (also on
    ``__exit__``, and safe to call twice)."""

    _DONE = object()

    def __init__(self, it: Iterator[Batch], depth: int = 2,
                 place: Optional[Callable[[Batch], Any]] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(iter(it), place),
            name="rbt-prefetch", daemon=True)
        self._thread.start()

    def _produce(self, it, place):
        try:
            while not self._stop.is_set():
                try:
                    item = next(it)
                except StopIteration:
                    break
                if place is not None:
                    item = place(item)
                if not self._put(item):
                    return
            self._put(self._DONE)
        except BaseException as exc:  # raised again on the consumer side
            self._put(exc)

    def _put(self, item) -> bool:
        """A blocking put that gives up once close() is asked for."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise StopIteration
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        # Drain, so that a producer blocked on a full queue sees the stop.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def pinned_placer(pin: bool) -> Callable[[Batch], Dict[str, Any]]:
    """Batch -> {name: torch tensor} for ``Prefetcher(place=...)``: the
    numpy arrays as CPU tensors, in pinned (page-locked) memory when
    ``pin``, so that the consumer's copy to the GPU is asynchronous."""
    import torch

    def place(batch: Batch) -> Dict[str, Any]:
        out = {k: torch.from_numpy(v) for k, v in batch.items()}
        return {k: v.pin_memory() for k, v in out.items()} if pin else out
    return place


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
