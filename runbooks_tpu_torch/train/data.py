"""Tokenizer for hermetic runs (the port's copy of
``runbooks_tpu.train.data.ByteTokenizer``)."""

from __future__ import annotations

from typing import List, Sequence


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
