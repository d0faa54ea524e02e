"""Text tokenization for the language encoder (port of
``situation3d_tpu/data/tokenizer.py``).

The reference tokenizes with the HF AutoTokenizer of
``sentence-transformers/all-mpnet-base-v2`` (``lib/sepdataset.py:120-143``).
The JAX package tries that tokenizer first (from a local cache only), then
a local ``vocab.txt`` WordPiece, then a deterministic hash tokenizer. The
port has the last two only: its machines have no ``transformers``, so
``make_tokenizer`` picks WordPiece when given a vocabulary file and the hash
tokenizer otherwise. Where no HF tokenizer is cached, both packages pick
the same strategy and give the same ids.

All strategies emit MPNet conventions: ``<s> ... </s>`` with bos=0, pad=1,
eos=2, unk=3, fixed ``max_len``.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

BOS_ID, PAD_ID, EOS_ID, UNK_ID = 0, 1, 2, 3
_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


class HashTokenizer:
    """Deterministic fallback tokenizer (FNV-1a hash of lowercased words)."""

    def __init__(self, vocab_size: int = 30527):
        self.vocab_size = vocab_size

    def _hash(self, word: str) -> int:
        h = 1469598103934665603
        for ch in word.encode():
            h = ((h ^ ch) * 1099511628211) % (1 << 64)
        # reserve the 4 special ids
        return 4 + h % (self.vocab_size - 4)

    def encode(self, text: str, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        words = _WORD_RE.findall(text.lower())[: max_len - 2]
        ids = [BOS_ID] + [self._hash(w) for w in words] + [EOS_ID]
        out = np.full(max_len, PAD_ID, np.int32)
        out[: len(ids)] = ids
        mask = np.zeros(max_len, np.int32)
        mask[: len(ids)] = 1
        return out, mask


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over a local vocab file."""

    def __init__(self, vocab_path: str):
        self.vocab = {}
        with open(vocab_path) as fh:
            for i, line in enumerate(fh):
                self.vocab[line.rstrip("\n")] = i

    def _word_pieces(self, word: str) -> List[int]:
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [UNK_ID]
            pieces.append(cur)
            start = end
        return pieces

    def encode(self, text: str, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        ids: List[int] = [BOS_ID]
        for w in _WORD_RE.findall(text.lower()):
            ids.extend(self._word_pieces(w))
            if len(ids) >= max_len - 1:
                break
        ids = ids[: max_len - 1] + [EOS_ID]
        out = np.full(max_len, PAD_ID, np.int32)
        out[: len(ids)] = ids
        mask = np.zeros(max_len, np.int32)
        mask[: len(ids)] = 1
        return out, mask


def make_tokenizer(name: str, vocab_path: Optional[str] = None,
                   vocab_size: int = 30527):
    """WordPiece over ``vocab_path`` when it loads, else the hash tokenizer.
    ``name`` (the HF tokenizer the JAX package would try first) is accepted
    for the same call signature and not read."""
    if vocab_path:
        try:
            return WordPieceTokenizer(vocab_path)
        except (OSError, UnicodeDecodeError):
            pass
    return HashTokenizer(vocab_size)
