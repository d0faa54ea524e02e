"""Faults planted in the port's timed path, to show that a cell's check
catches them (``benchmarks/tests/test_bench_faults.py``, ``calibrate.py
--fault``). Each patches the port for the duration of a ``with`` block:

- ``stale_state``: a training step returns its state unchanged (the
  optimizer drops the update);
- ``half_batch``: a training step leaves out half of its batch, its loss the
  mean over the rest;
- ``drop_map_entries``: the SIG3D plan loses one entry in a hundred of
  its level-1 k3 map (a partial map fault: those neighbours read as
  missing);
- ``alter_answer``: one answer score of each SIG3D forward is changed where
  it is produced;
- ``alter_token``: one token of each greedy decode is changed where it is
  produced.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(name):
    if name is None:
        yield
        return
    undo = []

    def patch(obj, attr, new):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    if name == "stale_state":
        from situation3d_tpu_torch.train import optim

        def step(self):
            self.discard()
            return False
        patch(optim.Optimizer, "step", step)
    elif name == "half_batch":
        from situation3d_tpu_torch.train import trainer
        orig = trainer.train_step

        def half(cfg, state, batch, mesh=None):
            n = len(batch["s_ids"]) // 2
            return orig(cfg, state, {k: v[:n] for k, v in batch.items()}, mesh)
        patch(trainer, "train_step", half)
    elif name == "drop_map_entries":
        from situation3d_tpu_torch.models import sig3d
        orig_plan = sig3d.build_unet_plan

        def plan(*a, **k):
            out = orig_plan(*a, **k)
            lvl = out["levels"][1]
            lost = lvl["map_k3"].clone()
            lost.view(-1)[::100] = lost.shape[1]
            lvl["map_k3"] = lost
            return out
        patch(sig3d, "build_unet_plan", plan)
    elif name == "alter_answer":
        from situation3d_tpu_torch.models import sig3d
        orig = sig3d.SIG3D.forward

        def forward(self, *a, **k):
            out = orig(self, *a, **k)
            s = out["answer_scores"].clone()
            s[0, 0] = s[0, 0] + s.abs().max()
            out["answer_scores"] = s
            return out
        patch(sig3d.SIG3D, "forward", forward)
    elif name == "alter_token":
        from situation3d_tpu_torch.models import blip2_t5
        orig = blip2_t5.greedy_decode

        def decode(model, *a, **k):
            out = orig(model, *a, **k).clone()
            out[0, 0] = (out[0, 0] + 7) % model.cfg.vocab_size
            return out
        patch(blip2_t5, "greedy_decode", decode)
    else:
        raise KeyError(f"no fault {name!r}")
    try:
        yield
    finally:
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)

