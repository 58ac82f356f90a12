"""Tokenizers.

ByteTokenizer — byte-level with specials, for the textual Countries /
Tipsheets generators and the quickstart examples.

SymbolTokenizer — a closed symbolic vocabulary for the contextual-retrieval
task family the communication benchmarks train on (entities, attributes,
structural markers). From-scratch tiny models learn it in a few hundred
steps, which is what makes the paper's Table-1-style protocol comparison
runnable on CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence


class ByteTokenizer:
    PAD, BOS, EOS, SEP = 256, 257, 258, 259

    @property
    def vocab_size(self) -> int:
        return 260

    def encode(self, text: str, bos: bool = False, eos: bool = False
               ) -> List[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", "replace")


@dataclass(frozen=True)
class SymbolTokenizer:
    """Closed vocabulary:
      0..3      : PAD, BOS, Q, ANS
      4..4+E-1  : entities
      4+E..     : attributes
    """
    num_entities: int = 64
    num_attributes: int = 32

    PAD, BOS, Q, ANS = 0, 1, 2, 3

    @property
    def entity_base(self) -> int:
        return 4

    @property
    def attr_base(self) -> int:
        return 4 + self.num_entities

    @property
    def vocab_size(self) -> int:
        return 4 + self.num_entities + self.num_attributes

    def entity(self, i: int) -> int:
        assert 0 <= i < self.num_entities
        return self.entity_base + i

    def attribute(self, i: int) -> int:
        assert 0 <= i < self.num_attributes
        return self.attr_base + i

    def is_attribute(self, tok: int) -> bool:
        return self.attr_base <= tok < self.vocab_size
