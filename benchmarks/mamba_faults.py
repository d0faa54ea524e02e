"""Faults of the Mamba-2 mixer planted in the port's Nemotron-H
(``models/nemotron_h.py``), to show that the Nemotron cell's check catches
each (``tests/test_torch_nemotron_h.py`` at a tiny size,
``benchmarks/tests/test_bench_nemotron_h.py -m chip`` at the cell's own):

- ``no_softplus``: the step sizes ``dt + dt_bias`` with no softplus;
- ``state_dropped``: the SSM state not carried from the prefill into the
  decode steps (zeroed after the prefill).

``planted(name)`` patches the port for the duration of a ``with`` block;
``None`` plants nothing.
"""
from __future__ import annotations

import contextlib

FAULTS = ("no_softplus", "state_dropped")


@contextlib.contextmanager
def planted(name):
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise KeyError(f"no Mamba fault {name!r}")
    from situation3d_tpu_torch.models import nemotron_h
    if name == "no_softplus":
        obj, attr = nemotron_h, "step_sizes"

        def new(dt, dt_bias, keep):
            delta = dt + dt_bias.float()
            return delta if keep is None else delta * keep[..., None]
    else:
        obj, attr = nemotron_h.NemotronHForCausalLM, "prefill"
        orig = obj.prefill

        def new(self, inputs_embeds, mask, cache):
            logits = orig(self, inputs_embeds, mask, cache)
            cache.ssm.zero_()
            return logits
    old = getattr(obj, attr)
    setattr(obj, attr, new)
    try:
        yield
    finally:
        setattr(obj, attr, old)
