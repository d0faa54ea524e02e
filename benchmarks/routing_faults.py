"""Faults of the expert layer's routing planted in the port's LFM2
(``models/lfm2.py:MoEFF.route``), to show that the LFM2 cell's check
catches each (``tests/test_torch_lfm2.py`` at a tiny size,
``benchmarks/tests/test_bench_lfm2.py -m chip`` at the cell's own):

- ``no_expert_bias``: the experts chosen by the scores alone;
- ``top_k_minus_1``: one expert fewer a token, the weights normalised over
  those chosen;
- ``unnormalised``: the chosen experts weighted by their scores, not by
  their share of the scores' sum;
- ``expert_off_by_one``: each choice reads the next expert's weights.

``planted(name)`` patches the port for the duration of a ``with`` block;
``None`` plants nothing.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FAULTS = ("no_expert_bias", "top_k_minus_1", "unnormalised", "expert_off_by_one")


@contextlib.contextmanager
def planted(name):
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise KeyError(f"no routing fault {name!r}")
    from situation3d_tpu_torch.models import lfm2
    orig = lfm2.MoEFF.route

    def route(self, x):
        cfg = self.cfg
        s = torch.sigmoid(F.linear(x.float(), self.gate.weight.float()))
        pick = s if name == "no_expert_bias" else s + self.expert_bias.float()
        k = cfg.num_experts_per_tok - (name == "top_k_minus_1")
        idx = torch.topk(pick, k, dim=-1).indices
        w = s.gather(-1, idx)
        if name != "unnormalised":
            w = w / (w.sum(-1, keepdim=True) + 1e-6)
        if name == "expert_off_by_one":
            idx = (idx + 1) % cfg.num_experts
        return idx.to(torch.int32), w * cfg.routed_scaling_factor

    lfm2.MoEFF.route = route
    try:
        yield
    finally:
        lfm2.MoEFF.route = orig
