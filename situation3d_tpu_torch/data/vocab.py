"""Answer vocabulary (the port's own copy of ``situation3d_tpu/data/vocab.py``):
the ``Answer`` class (``lib/sepdataset.py:49-70``), ``get_answer_cands``
filtering by counter frequency / max size (``situation3d/train/train.py:40-52``)
and the binary answer score (``lib/sepdataset.py:38-42``).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional


class AnswerVocab:
    def __init__(self, answers: List[str], unk_token: Optional[str] = None):
        self.unk_token = unk_token
        self.itos_list = list(answers)
        if unk_token is not None and unk_token not in self.itos_list:
            self.itos_list.append(unk_token)
        self._stoi: Dict[str, int] = {a: i for i, a in enumerate(self.itos_list)}

    def stoi(self, token: str) -> int:
        if token in self._stoi:
            return self._stoi[token]
        if self.unk_token is not None:
            return self._stoi[self.unk_token]
        return -1

    def itos(self, idx: int) -> str:
        return self.itos_list[idx]

    def __len__(self) -> int:
        return len(self.itos_list)


def answer_score(freq: int) -> float:
    """Binary answerability score (sepdataset.py:38-42)."""
    return 0.0 if freq == 0 else 1.0


def build_answer_vocab(
    answer_counter: Dict[str, int],
    min_freq: int = 1,
    max_size: Optional[int] = None,
) -> AnswerVocab:
    """Most-frequent-first vocab with frequency floor (train.py:40-52)."""
    items = sorted(answer_counter.items(), key=lambda kv: (-kv[1], kv[0]))
    cands = [a for a, c in items if c >= min_freq]
    if max_size is not None:
        cands = cands[:max_size]
    return AnswerVocab(cands)


def load_answer_counter(path: str) -> Dict[str, int]:
    with open(path) as fh:
        data = json.load(fh)
    if isinstance(data, dict):
        return data
    # list format: count occurrences
    counter: Dict[str, int] = {}
    for a in data:
        counter[a] = counter.get(a, 0) + 1
    return counter
