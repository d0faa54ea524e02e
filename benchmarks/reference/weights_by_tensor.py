"""Seeded random weights made one tensor at a time, for a model too large for
``weights.py:make_weights``'s one flat float32 draw (LFM2-24B-A2B: 96 GB in
float32).

Each named tensor is drawn by a generator of its own, seeded from the run's
seed and the tensor's name, so any tensor can be made alone, in any order,
on any device that draws alike. The rules by name and shape are
``weights.py``'s (``init_scale`` scales a normal draw's deviation), plus
``init_normal`` (name pattern -> deviation): a tensor that matches is drawn
``N(0, deviation^2)`` whatever its rule (a router's expert bias); and
``init_shared`` (name pattern -> eps): a stack of experts ``[E, ...]`` that
matches is drawn as one matrix shared by all plus ``eps`` times each one's
own, ``(base + eps * own) / sqrt(1 + eps^2)`` at the rule's deviation, as
experts upcycled from one dense feed-forward start (Komatsuzaki et al.,
"Sparse Upcycling", ICLR 2023).

Every value is rounded to bfloat16, the dtype the configurations state for
the parameters: the program holds those values (in bfloat16, or float32
where it keeps a tensor in float32), and the reference gets float32 copies of
the same values.
"""
from __future__ import annotations

import fnmatch
import hashlib
import math
from typing import Dict, Optional, Sequence

import torch

from benchmarks.reference.weights import _rule, sub_seed

STREAM = 11


def tensor_seed(seed: int, name: str) -> int:
    digest = int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "little")
    return (sub_seed(seed, STREAM) ^ digest) % (2 ** 63)


def rule_of(name: str, shape: Sequence[int], init_scale: Optional[Dict[str, float]] = None,
            init_normal: Optional[Dict[str, float]] = None):
    for pattern, std in (init_normal or {}).items():
        if fnmatch.fnmatch(name, pattern):
            return "normal", float(std)
    kind, std = _rule(name, shape)
    if kind == "normal":
        for pattern, factor in (init_scale or {}).items():
            if fnmatch.fnmatch(name, pattern):
                std *= factor
    return kind, std


@torch.no_grad()
def make_tensor(name: str, shape: Sequence[int], seed: int, device,
                dtype: torch.dtype = torch.bfloat16,
                init_scale: Optional[Dict[str, float]] = None,
                init_normal: Optional[Dict[str, float]] = None,
                init_shared: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """The tensor ``name`` of ``shape``: its bfloat16 values, held in ``dtype``."""
    kind, std = rule_of(name, shape, init_scale, init_normal)
    shape = tuple(shape)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
    if kind == "uniform":
        t = torch.rand(shape, generator=g, device=device).add_(0.5)
    else:
        t = torch.randn(shape, generator=g, device=device)
        eps = next((e for p, e in (init_shared or {}).items() if fnmatch.fnmatch(name, p)), None)
        if eps is not None:
            gb = torch.Generator(device=device).manual_seed(tensor_seed(seed, name + "#shared"))
            base = torch.randn(shape[1:], generator=gb, device=device)
            t.mul_(eps).add_(base).div_(math.sqrt(1 + eps * eps))
        t.mul_(std)
    return t.to(torch.bfloat16).to(dtype)


def count(spec: Dict[str, Sequence[int]]) -> int:
    return sum(math.prod(s) for s in spec.values())
