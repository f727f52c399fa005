"""Symbol <-> index mapping for ASR targets.

The port's copy of ``myrtlespeech_tpu/data/alphabet.py`` (the reference's
``src/myrtlespeech/data/alphabet.py :: Alphabet``): a bijection between
characters and integer indices.  The blank
symbol is *not* part of the alphabet — blank handling is owned by the loss /
decoder configs (``blank_index``), matching the reference convention.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np


class Alphabet:
    """Bijective mapping between symbols (single characters) and indices.

    Index order follows the order of ``symbols``.  All lookups are O(1).
    """

    def __init__(self, symbols: Iterable[str]):
        self.symbols: List[str] = list(symbols)
        if len(set(self.symbols)) != len(self.symbols):
            raise ValueError("duplicate symbols in alphabet")
        for s in self.symbols:
            if len(s) != 1:
                raise ValueError(f"alphabet symbols must be single chars, got {s!r}")
        self._sym_to_idx = {s: i for i, s in enumerate(self.symbols)}

    def __len__(self) -> int:
        return len(self.symbols)

    def __contains__(self, symbol: str) -> bool:
        return symbol in self._sym_to_idx

    def get_index(self, symbol: str) -> int:
        return self._sym_to_idx[symbol]

    def get_symbol(self, index: int) -> str:
        return self.symbols[index]

    def get_indices(self, sentence: Sequence[str]) -> List[int]:
        """Map a sentence (string / list of chars) to indices.

        Raises ``KeyError`` on out-of-alphabet symbols, like the reference,
        but names the symbol AND the sentence — an OOV transcript deep in a
        corpus is otherwise undebuggable from a bare ``KeyError: '3'``.
        """
        try:
            return [self._sym_to_idx[s] for s in sentence]
        except KeyError as e:
            raise KeyError(
                f"symbol {e.args[0]!r} not in alphabet "
                f"{''.join(self.symbols)!r} (sentence: {str(sentence)[:80]!r})"
            ) from None

    def get_symbols(self, indices: Sequence[int]) -> str:
        """Map indices back to a string."""
        return "".join(self.symbols[i] for i in indices)

    def encode(self, sentence: str, max_len: int) -> np.ndarray:
        """Encode to a fixed-length int32 array padded with 0 (for batching)."""
        idx = self.get_indices(sentence)
        if len(idx) > max_len:
            raise ValueError(f"sentence len {len(idx)} > max_len {max_len}")
        out = np.zeros((max_len,), dtype=np.int32)
        out[: len(idx)] = idx
        return out

    def __repr__(self) -> str:
        return f"Alphabet({''.join(self.symbols)!r})"
