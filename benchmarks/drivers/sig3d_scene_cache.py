"""SIG3D answering as an agent in a room sends it: scenes visited in turn,
each under a fresh scene id, ``SceneCache.encode`` once a visit, then
``SceneCache.answer`` on batches of up to ``batch_size`` of that scene's
questions (a short last batch is padded with repeats, as the data
pipeline's last batch is, and only its own questions count). The first
batch of a visit carries the encode: its questions' latency runs from the
encode's submission to their answers on the host.

The check: a sample of the visits, drawn from the seed, against the
reference's full forward (plan, encoder, pooling with the same draws,
language, fusion, heads) of that room and those questions: the answers,
the encoder's ``feat_bottleneck`` of each sampled room's last encode, and
the plan of one visit's encode, drawn from the seed, entry for entry."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmarks.drivers import _sig3d as common
from benchmarks.flops import sig3d as flops
from benchmarks.harness.cell import Window, closed_loop, sync
from benchmarks.harness.scenes import questions, real_lengths, rows
from benchmarks.reference.precision import make as make_precision
from benchmarks.reference.weights import sub_seed

VISITS = 8


class Driver:
    units = "questions"

    def __init__(self, files: dict, seed: int, device):
        self.config, self.mix = files["config"], files["traffic"]
        self.s = self.config["settings"]
        self.seed, self.device = seed, torch.device(device)

    def setup(self) -> None:
        from situation3d_tpu_torch.eval import serving
        s, mix, dev = self.s, self.mix, self.device
        self.B = mix["batch_size"]
        self.cfg, self.model = common.build_model(self.config, self.seed, dev)
        self.scenes = common.Scenes(mix, s, self.seed, dev)
        # every seed visits rooms with the same question counts, spread evenly
        # over the mix's range, in its own order: the seed orders the work and
        # does not change how much there is
        rng = np.random.default_rng(sub_seed(self.seed, VISITS))
        lo, hi = mix["questions_per_scene"]
        self.per_visit = rng.permutation(np.round(np.linspace(lo, hi, mix["rooms"])).astype(int))
        text = questions(self.seed, common.TEXT, int(self.per_visit.sum()), mix, s)
        starts = np.concatenate([[0], np.cumsum(self.per_visit)])
        self.visits = []          # per room: its question batches (host, padded)
        for r in range(mix["rooms"]):
            qs = np.arange(starts[r], starts[r + 1])
            batches = []
            for b0 in range(0, len(qs), self.B):
                idx = qs[b0:b0 + self.B]
                n = len(idx)
                batch = rows(text, np.resize(idx, self.B))
                batch["sample_valid"] = np.arange(self.B) < n
                batches.append((n, batch))
            self.visits.append(batches)
        plan_call = int(np.random.default_rng(sub_seed(self.seed, common.PLAN)).integers(mix["rooms"]))
        self.tap = common.EncoderTap(self.model, plan_call)
        self.cache = serving.SceneCache(self.model, dev)
        self.visit = 0
        for _ in range(2):                       # warm every shape
            self._visit(None)
        sync(dev)

    def _visit(self, record) -> None:
        """One visit of the next room: encode it, answer its questions."""
        v = self.visit
        self.visit += 1
        r = v % self.mix["rooms"]
        sid = f"visit{v}"
        t0 = time.perf_counter()
        timed = record is not None and self.device.type == "cuda"
        if timed:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        self.tap.key = None if record is None else r
        self.cache.encode(sid, self.scenes.voxels_of([r]), sample_draws=self.scenes.draws_of([r]))
        if timed:
            e1.record()
            self.encode_events.append((e0, e1))
        for j, (n, batch) in enumerate(self.visits[r]):
            with torch.inference_mode():
                out = self.cache.answer(sid, batch)
                ans = {"answer_scores": out["answer_scores"].float().cpu(),
                       "aux_scores": out["aux_scores"].float().cpu()}
            t1 = time.perf_counter()
            if record is not None:
                record(r, j, n, ans, t1 - t0)
            t0 = t1

    def window(self, seconds: float, tracer) -> Window:
        self.served: List[tuple] = []
        self.encode_events: List[tuple] = []

        def body(i: int, win: Window) -> None:
            r = self.visit % self.mix["rooms"]
            n_q = int(self.per_visit[r])

            def record(room, j, n, ans, dt):
                self.served.append((room, j, n, ans))
                win.latencies_s.extend([dt] * n)

            with tracer.batch(n_q, r):
                self._visit(record)
            win.units += n_q
            win.attempted += n_q

        win = closed_loop(seconds, body, self.device)
        self.encode_ms = [a.elapsed_time(b) for a, b in self.encode_events]
        return win

    def end_to_end(self, win: Window) -> Dict[str, float]:
        return {"questions_per_s": win.units / win.seconds,
                "question_p95_ms": float(np.percentile(win.latencies_s, 95)) * 1e3}

    def layer_context(self, win: Window, summary) -> dict:
        s, dev = self.s, self.device
        enc = {}

        def flops_of(r):
            if r not in enc:
                enc[r] = common.batch_hits(s, self.scenes.voxels_of([r]), dev)
            qs = [l for n, b in self.visits[r] for l in real_lengths(b)[:n]]
            return flops.batch_flops(s, qs, False, *enc[r])

        def conv_least_of(r):
            flops_of(r)
            return common.conv_least(s, 1, enc[r][0])
        return {"summary": summary, "flops_of": flops_of, "conv_least_of": conv_least_of,
                "encode_ms": getattr(self, "encode_ms", None)}

    def readings(self, precision: str = "float32", program: bool = True) -> Dict[str, float]:
        s, dev = self.s, self.device
        rng = np.random.default_rng(sub_seed(self.seed, common.PICK))
        picks = rng.permutation(len(self.served))[:self.mix["check_batches"]]
        tap = self.tap
        if hasattr(self, "model"):
            del self.model, self.cache
            common.free()
        model, _ = common.reference(s, self.seed, dev)
        low = None if program else common.reference(s, self.seed, dev, make_precision(precision))[0]
        models = [m for m in (model, low) if m is not None]
        # the control is the reference: its plan is the reference's own
        out = {"plan_mismatch": float("inf") if program else 0.0, "bottleneck_err": 0.0}
        got, want, memo, tokens = [], [], {}, {}
        with torch.no_grad():
            # each room's tokens once, then every question on them
            for r in sorted({self.served[i][0] for i in picks} | {tap.plan_key}):
                room = common.to_device(self.scenes.voxels_of([r]), dev)
                towers = [m.scene_tokens(room, self.scenes.draws_of([r])) for m in models]
                levels, bott = towers[0][0], towers[0][1]
                if program and r == tap.plan_key:
                    out["plan_mismatch"] = common.plan_mismatch(levels, tap.plan)
                mine = tap.bottleneck[r] if program else towers[1][1]
                out["bottleneck_err"] = max(out["bottleneck_err"],
                                            common.bottleneck_err(mine, bott, levels[-1]["mask"]))
                tokens[r] = [(tok.expand(self.B, -1, -1), pos.expand(self.B, -1, -1))
                             for _, _, tok, pos in towers]
                del towers, levels
            for i in picks:
                r, j, n, ans = self.served[i]
                if (r, j) not in memo:
                    batch = common.to_device(self.visits[r][j][1], dev)
                    memo[(r, j)] = [{k: o[k][:n].cpu() for k in ("answer_scores", "aux_scores")}
                                    for o in (m.forward(batch, tokens=t)
                                              for m, t in zip(models, tokens[r]))]
                want.append(memo[(r, j)][0])
                got.append({k: v[:n] for k, v in ans.items()} if program else memo[(r, j)][1])
        out.update(common.answer_readings(got, want))
        return out
