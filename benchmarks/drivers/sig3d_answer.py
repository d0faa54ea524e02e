"""SIG3D answering as the reference's eval loop runs it: closed-loop batches
of questions, each about its own room, through ``SIG3D.forward`` in
evaluation form; every batch builds its plan and encodes its scenes again.
A question's latency runs from its batch's submission (host arrays in the
data pipeline's format) to its answer scores on the host.

The check: a sample of the answered batches, drawn from the seed, against
the reference's full forward of the same rooms, texts and token draws: the
answer scores and situation outputs, the encoder's ``feat_bottleneck`` of
each sampled batch's last serving, and the plan of one served batch, drawn
from the seed, entry for entry."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmarks.drivers import _sig3d as common
from benchmarks.flops import sig3d as flops
from benchmarks.harness.cell import Window, closed_loop, sync
from benchmarks.harness.scenes import real_lengths
from benchmarks.reference.precision import make as make_precision
from benchmarks.reference.weights import sub_seed


class Driver:
    units = "questions"

    def __init__(self, files: dict, seed: int, device):
        self.config, self.mix = files["config"], files["traffic"]
        self.s = self.config["settings"]
        self.seed, self.device = seed, torch.device(device)

    def setup(self) -> None:
        s, mix, dev = self.s, self.mix, self.device
        self.B = mix["batch_size"]
        self.cfg, self.model = common.build_model(self.config, self.seed, dev)
        self.scenes = common.Scenes(mix, s, self.seed, dev)
        self.pool = common.make_batches(mix, s, self.seed, self.scenes, mix["pool_batches"], self.B)
        self.draws = [self.scenes.draws_of(rooms) for rooms, _ in self.pool]
        plan_call = int(np.random.default_rng(sub_seed(self.seed, common.PLAN)).integers(len(self.pool)))
        self.tap = common.EncoderTap(self.model, plan_call)
        for k in range(min(2, len(self.pool))):          # warm every shape
            self._answer(k)
        sync(dev)

    def _answer(self, k: int) -> dict:
        with torch.inference_mode():
            out = self.model(self.pool[k][1], sample_draws=self.draws[k])
            return {"answer_scores": out["answer_scores"].float().cpu(),
                    "aux_scores": out["aux_scores"].float().cpu()}

    def window(self, seconds: float, tracer) -> Window:
        P = len(self.pool)
        self.served: List[tuple] = []

        def body(i: int, win: Window) -> None:
            k = i % P
            t0 = time.perf_counter()
            self.tap.key = k
            with tracer.batch(self.B, k):
                ans = self._answer(k)
            dt = time.perf_counter() - t0
            self.served.append((k, ans))
            win.latencies_s.extend([dt] * self.B)
            win.units += self.B
            win.attempted += self.B

        win = closed_loop(seconds, body, self.device)
        self.tap.key = None
        return win

    def end_to_end(self, win: Window) -> Dict[str, float]:
        return {"questions_per_s": win.units / win.seconds,
                "question_p95_ms": float(np.percentile(win.latencies_s, 95)) * 1e3}

    def layer_context(self, win: Window, summary) -> dict:
        s, B, dev = self.s, self.B, self.device
        lengths = {k: real_lengths(b) for k, (_, b) in enumerate(self.pool)}
        hits = {k: common.batch_hits(s, b, dev) for k, (_, b) in enumerate(self.pool)}
        return {"summary": summary,
                "flops_of": lambda k: flops.batch_flops(s, lengths[k], False, *hits[k]),
                "conv_least_of": lambda k: common.conv_least(s, B, hits[k][0])}

    def readings(self, precision: str = "float32", program: bool = True) -> Dict[str, float]:
        """A sample of the served batches, drawn from the seed, against the
        reference's forward of the same inputs."""
        s, dev = self.s, self.device
        rng = np.random.default_rng(sub_seed(self.seed, common.PICK))
        picks = rng.permutation(len(self.served))[:self.mix["check_batches"]]
        got = [self.served[i][1] for i in picks]
        ks = [self.served[i][0] for i in picks]
        tap = self.tap
        if hasattr(self, "model"):
            del self.model
            common.free()
        model, _ = common.reference(s, self.seed, dev)
        low = None if program else common.reference(s, self.seed, dev, make_precision(precision))[0]
        want, control, memo = [], [], {}
        # the control is the reference: its plan is the reference's own
        out = {"plan_mismatch": float("inf") if program else 0.0, "bottleneck_err": 0.0}
        with torch.no_grad():
            for k in sorted(set(ks) | {tap.plan_key}):
                batch = common.to_device(self.pool[k][1], dev)
                w = model.forward(batch, sample_draws=self.draws[k], keep_plan=True)
                c = low.forward(batch, sample_draws=self.draws[k]) if low else None
                levels = w.pop("plan")
                if program and k == tap.plan_key:
                    out["plan_mismatch"] = common.plan_mismatch(levels, tap.plan)
                bott = common.bottleneck_err(tap.bottleneck[k] if program else c["feat_bottleneck"],
                                             w["feat_bottleneck"], levels[-1]["mask"])
                out["bottleneck_err"] = max(out["bottleneck_err"], bott)
                del levels
                memo[k] = (w, c)
        for k in ks:
            want.append(memo[k][0])
            control.append(memo[k][1])
        out.update(common.answer_readings(got if program else control, want))
        return out
