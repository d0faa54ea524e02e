"""Seeded random weights, made by the benchmark and handed alike to the
program and to the reference.

Every tensor of a model is named (the parameter tree's dotted path) and
takes a slice of ONE normal draw (and, for batch-norm variances, one uniform
draw) on the device, laid out in sorted name order, so two sides that name
the same tensors with the same shapes get the same values whatever order
they build them in. Rules, by the name's last part and the shape:

- ``kernel`` (sparse conv, ``[K, C_in, C_out]`` or ``[C_in, C_out]``):
  ``N(0, 2 / fan_in)``;
- ``mean`` (batch-norm running mean): ``N(0, 0.1^2)``; ``var``: ``0.5 + U[0, 1)``;
- any other tensor of two or more axes: ``N(0, 1 / shape[-1])``, which keeps
  activations of order one through a stack (a linear layer's weight is
  ``[out, in]``, an embedding's ``[rows, width]``);
- a vector named ``bias``: 0; any other vector (norm weights, scales): 1;
- a configuration's ``init_scale`` (name pattern -> factor) scales the
  standard deviation of the normal draws it matches: T5 folds its missing
  ``1/sqrt(d_kv)`` attention scaling into the query weights' initial scale,
  and starts its embeddings at unit scale, as its reference initializer does.
"""
from __future__ import annotations

import fnmatch
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

Spec = Dict[str, Tuple[int, ...]]


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each use of the run's seed."""
    return (int(seed) * 1_000_003 + 7919 * int(stream)) % (2 ** 63)


def _rule(name: str, shape: Sequence[int]):
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel":
        fan_in = shape[0] if len(shape) == 2 else shape[0] * shape[1]
        return "normal", math.sqrt(2.0 / fan_in)
    if leaf == "mean" and len(shape) == 1:
        return "normal", 0.1
    if leaf == "var" and len(shape) == 1:
        return "uniform", None
    if len(shape) >= 2:
        return "normal", 1.0 / math.sqrt(shape[-1])
    return ("zeros", None) if leaf == "bias" else ("ones", None)


@torch.no_grad()
def make_weights(spec: Spec, seed: int, device,
                 init_scale: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """float32 tensors for every name of ``spec``: views into two flat
    buffers drawn with a generator on ``device``."""
    names = sorted(spec)
    rules = {n: _rule(n, spec[n]) for n in names}
    for pattern, factor in (init_scale or {}).items():
        for n in fnmatch.filter(names, pattern):
            if rules[n][0] == "normal":
                rules[n] = ("normal", rules[n][1] * factor)
    numel = {n: math.prod(spec[n]) for n in names}
    n_norm = sum(numel[n] for n in names if rules[n][0] == "normal")
    n_unif = sum(numel[n] for n in names if rules[n][0] == "uniform")
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    normal = torch.randn(n_norm, generator=g, device=device)
    uniform = torch.rand(n_unif, generator=g, device=device)
    out, on, ou = {}, 0, 0
    for n in names:
        kind, std = rules[n]
        k = numel[n]
        if kind == "normal":
            t = normal[on:on + k].mul_(std)
            on += k
        elif kind == "uniform":
            t = uniform[ou:ou + k].add_(0.5)
            ou += k
        elif kind == "zeros":
            t = torch.zeros(k, device=device)
        else:
            t = torch.ones(k, device=device)
        out[n] = t.view(spec[n])
    return out
