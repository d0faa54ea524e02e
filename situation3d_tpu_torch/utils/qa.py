"""QA text utilities (port of ``situation3d_tpu/utils/qa.py``): VQA-style
answer normalization (punctuation / digit / article handling) as a copy;
the masked softmax and the ``gelu_new`` activation in torch.
"""
from __future__ import annotations

import math
import re
from typing import Optional

import torch

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "didnt": "didn't", "doesnt": "doesn't",
    "dont": "don't", "hadnt": "hadn't", "hasnt": "hasn't", "havent": "haven't",
    "hed": "he'd", "hes": "he's", "howd": "how'd", "howll": "how'll",
    "hows": "how's", "im": "i'm", "ive": "i've", "isnt": "isn't",
    "itd": "it'd", "itll": "it'll", "lets": "let's", "maam": "ma'am",
    "mightve": "might've", "mustve": "must've", "shant": "shan't",
    "shed": "she'd", "shes": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "somebodyd": "somebody'd",
    "somebodyll": "somebody'll", "somebodys": "somebody's",
    "someoned": "someone'd", "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyll": "they'll",
    "theyre": "they're", "theyve": "they've", "twas": "'twas",
    "wasnt": "wasn't", "wed": "we'd", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "wholl": "who'll", "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't", "wouldve": "would've",
    "wouldnt": "wouldn't", "yall": "y'all", "youd": "you'd", "youll": "you'll",
    "youre": "you're", "youve": "you've",
}
_DIGITS = {"none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
           "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
           "nine": "9", "ten": "10"}
_ARTICLES = {"a", "an", "the"}
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
_PUNCT = [";", "/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
          "-", ">", "<", "@", "`", ",", "?", "!"]


def process_punctuation(text: str) -> str:
    out = text
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) or re.search(
                _COMMA_STRIP, text) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out, re.UNICODE)


def process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = _DIGITS.get(word, word)
        if word not in _ARTICLES:
            out.append(_CONTRACTIONS.get(word, word))
    return " ".join(out)


def normalize_answer(answer: str) -> str:
    """Full VQA normalization pipeline."""
    answer = answer.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(answer))


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    """Softmax where masked (mask==0) positions get zero probability."""
    if mask is None:
        e = torch.exp(logits - torch.amax(logits, dim=dim, keepdim=True))
        return e / e.sum(dim=dim, keepdim=True)
    big_neg = torch.finfo(logits.dtype).min / 2
    masked = torch.where(mask.to(torch.bool), logits, torch.full_like(logits, big_neg))
    p = torch.exp(masked - torch.amax(masked, dim=dim, keepdim=True))
    p = p * mask.to(p.dtype)
    return p / p.sum(dim=dim, keepdim=True).clamp(min=1e-13)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximation GELU (qa_helper.py gelu_new)."""
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))
