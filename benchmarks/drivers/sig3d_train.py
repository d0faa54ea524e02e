"""SIG3D training, as the reference recipe runs it: closed-loop steps of
``train/trainer.py:train_step`` on host batches in the data pipeline's
format (the copy to the card is in the step), the scene encoder and MPNet
but its last layer frozen, AdamW, the NaN guard.

Set-up builds ONE train state and drives it through its first
``setup_steps`` steps on batches whose rows all differ; the window goes on
with that same state. The readings of those steps (each loss, the first
gradient as AdamW's first moment holds it, the trained parameters after
them) are held against the reference's three steps from the same weights,
batches, token draws and dropout masks; so are the first step's plan, entry
for entry, and its encoder's ``feat_bottleneck``."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmarks.drivers import _sig3d as common
from benchmarks.flops import sig3d as flops
from benchmarks.harness.cell import Window, closed_loop, sync
from benchmarks.harness.scenes import real_lengths
from benchmarks.reference import sig3d as ref
from benchmarks.reference.precision import make as make_precision
from benchmarks.reference.weights import sub_seed

BETA1 = 0.9


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    norms = torch.stack([tensors[n].detach().float().norm() for n in names]).cpu().tolist()
    return dict(zip(names, norms))


def worst_leaf_gap(prog: Dict[str, float], want: Dict[str, float], leaves) -> float:
    """The largest ``|prog - want|`` over the leaves, each against the larger
    of its reference norm and the median leaf's."""
    med = float(np.median([want[n] for n in leaves]))
    return max(abs(prog[n] - want[n]) / max(want[n], med, 1e-30) for n in leaves)


class Driver:
    units = "samples"

    def __init__(self, files: dict, seed: int, device):
        self.config, self.mix = files["config"], files["traffic"]
        self.s = self.config["settings"]
        self.seed, self.device = seed, torch.device(device)

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from situation3d_tpu_torch.train import trainer
        s, mix, dev = self.s, self.mix, self.device
        B = s["train.batch_size"]
        self.cfg, model = common.build_model(self.config, self.seed, dev)
        scenes = common.Scenes(mix, s, self.seed, dev)
        self.pool = common.make_batches(mix, s, self.seed, scenes, mix["pool_batches"], B)
        opt, _ = trainer.make_sig3d_optimizer(self.cfg, model, self.config["assumed"]["steps_per_epoch"])
        self.state = trainer.TrainState(
            model=model, optimizer=opt, step=0,
            sample_generator=torch.Generator(device=dev).manual_seed(sub_seed(self.seed, common.SAMPLE_GEN)),
            dropout_generator=torch.Generator(device=dev).manual_seed(sub_seed(self.seed, common.DROPOUT_GEN)))
        self.trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.tap = common.EncoderTap(model, 0)
        self.losses = []
        for k in range(mix["setup_steps"]):
            self.tap.key = k if k == 0 else None
            m = trainer.train_step(self.cfg, self.state, self.pool[k][1])
            self.losses.append(float(m["loss"]))
            if k == 0:
                # a step that left the state as it was holds no moment: zero
                moments = {n: opt.adamw.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - BETA1)
                           for n, p in self.trained.items()}
                self.grad_norms = leaf_norms(moments)
        self.after = {n: p.detach().to("cpu", copy=True) for n, p in self.trained.items()}
        sync(dev)

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float, tracer) -> Window:
        from situation3d_tpu_torch.train import trainer
        B, P, first = self.s["train.batch_size"], len(self.pool), self.mix["setup_steps"]
        finite = torch.zeros((), device=self.device)
        self.steps = []

        def body(i: int, win: Window) -> None:
            nonlocal finite
            k = (first + i) % P
            with tracer.batch(B, k):
                m = trainer.train_step(self.cfg, self.state, self.pool[k][1])
            finite = finite + m["grads_finite"]
            self.steps.append(k)
            win.units += B
            win.attempted += B

        win = closed_loop(seconds, body, self.device)
        win.failed = float(len(self.steps) - float(finite)) * B
        win.units -= win.failed
        return win

    def end_to_end(self, win: Window) -> Dict[str, float]:
        return {"train_samples_per_s": win.units / win.seconds}

    # -- per-layer readings ---------------------------------------------------
    def layer_context(self, win: Window, summary) -> dict:
        s, B, dev = self.s, self.s["train.batch_size"], self.device
        lengths = {k: real_lengths(b) for k, (_, b) in enumerate(self.pool)}
        hits = {k: common.batch_hits(s, b, dev) for k, (_, b) in enumerate(self.pool)}
        return {"summary": summary,
                "flops_of": lambda k: flops.batch_flops(s, lengths[k], True, *hits[k]),
                "conv_least_of": lambda k: common.conv_least(s, B, hits[k][0])}

    # -- the check ------------------------------------------------------------
    def readings(self, precision: str = "float32", program: bool = True) -> Dict[str, float]:
        """The numbers compared: the program's (or, with ``program=False``,
        the reference in ``precision`` put in its place) against the float32
        reference's three steps."""
        s, dev = self.s, self.device
        if hasattr(self, "state"):
            del self.state, self.trained
            common.free()
        want = self._reference_steps("float32")
        if program:
            got = {"losses": self.losses, "grad_norms": self.grad_norms, "after": self.after}
        else:
            got = self._reference_steps(precision)
        steps = min(len(got["losses"]), len(want["losses"]))
        loss_gap = max(abs(got["losses"][k] - want["losses"][k]) / abs(want["losses"][k])
                       for k in range(steps))
        leaves = sorted(want["grad_norms"])
        grad_gap = worst_leaf_gap(got["grad_norms"], want["grad_norms"], leaves)
        med = float(np.median([want["grad_norms"][n] for n in leaves]))
        moved = [n for n in leaves if want["grad_norms"][n] >= 1e-3 * med]
        p0 = want["initial"]
        got_change = leaf_norms({n: got["after"][n].to(dev) - p0[n] for n in moved})
        want_change = leaf_norms({n: want["after"][n].to(dev) - p0[n] for n in moved})
        update_gap = worst_leaf_gap(got_change, want_change, moved)
        mask = want["plan"][-1]["mask"]
        if program:
            plan = common.plan_mismatch(want["plan"], self.tap.plan)
            bott = common.bottleneck_err(self.tap.bottleneck[0], want["bottleneck"], mask)
        else:       # the control is the reference: its plan is the reference's own
            plan = 0.0
            bott = common.bottleneck_err(got["bottleneck"], want["bottleneck"], mask)
        return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "update_norm_gap": update_gap,
                "plan_mismatch": plan, "bottleneck_err": bott}

    def _reference_steps(self, precision: str) -> dict:
        s, dev, mix = self.s, self.device, self.mix
        model, w = common.reference(s, self.seed, dev, make_precision(precision))
        initial = {n: t.clone() for n, t in w.items() if ref.trainable(n, s)}
        params = {n: t.clone().requires_grad_(True) for n, t in initial.items()}
        model.w = {**w, **params}
        opt = ref.AdamW(params, s)
        sample_gen = torch.Generator(device=dev).manual_seed(sub_seed(self.seed, common.SAMPLE_GEN))
        dropout_gen = torch.Generator(device=dev).manual_seed(sub_seed(self.seed, common.DROPOUT_GEN))
        losses, grad_norms = [], None
        for k in range(mix["setup_steps"]):
            batch = common.to_device(self.pool[k][1], dev)
            out = model.forward(batch, sample_gen=sample_gen, dropout_gen=dropout_gen, train=True,
                                keep_plan=k == 0)
            if k == 0:
                plan, bottleneck = out.pop("plan"), out["feat_bottleneck"].detach()
            loss = ref.loss(out, batch, s)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            used = opt.step(dict(zip(params, grads)))
            losses.append(float(loss.detach()))
            if k == 0:
                grad_norms = leaf_norms(used)
            del out, loss, grads, used
        return {"losses": losses, "grad_norms": grad_norms, "initial": initial,
                "after": {n: p.detach() for n, p in params.items()}, "plan": plan,
                "bottleneck": bottleneck}
