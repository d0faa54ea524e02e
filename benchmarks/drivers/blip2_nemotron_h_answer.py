"""The 3D-LLM with a Nemotron-H language model answering SQA3D-like questions
as ``blip2_lfm2_answer.py`` drives LFM2, whose helpers it imports:
closed-loop batches through ``models/blip2_lfm2.py:predict_answers``
(greedy, ``max_len`` tokens, the decode steps replayed from captured CUDA
graphs), each question with its own scene features (a pool of batches on the
card) and its prompt, ``bos`` then the template around situation and question
words, hash-tokenized. A question's latency runs from its batch's
submission to its tokens on the host.

The model's 31.6 B parameters are made on the card one tensor at a time
(``reference/nemotron_h.py:make_weight``) in the dtype the program holds
each in. Set-up serves every batch of the pool once, which captures the
decode steps.

The check, as LFM2's: a sample of the served batches, drawn from the seed and
holding the one that served the most tokens, served once more with every
step eager while each expert layer's choices are recorded; the model, its
graphs and their pool are then freed, and ``reference/nemotron_h.py`` runs
each question alone, a layer at a time, its recurrence position by position.
``logit_gap`` and ``route_flips`` are computed as LFM2's are. The control
computes both with the reference in a lower precision in the program's
place."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmarks.drivers._sig3d import free
from benchmarks.drivers.blip2_lfm2_answer import (DTYPES, FEATS, PICK, Driver as Lfm2Driver,
                                                  prompts, qformer_config, route_flips,
                                                  served_routes)
from benchmarks.flops import nemotron_h as flops
from benchmarks.harness.cell import Window, closed_loop, sync
from benchmarks.reference import nemotron_h as ref
from benchmarks.reference.blip2 import logit_gap, served_positions
from benchmarks.reference.precision import exact_float32
from benchmarks.reference.precision import make as make_precision
from benchmarks.reference.weights import sub_seed

P = ref.PREFIX


def lm_config(s: dict):
    """The port's ``NemotronHConfig`` from the settings' ``nemotron_h.`` keys
    (the published ``config.json``'s, and the assumed special ids)."""
    from situation3d_tpu_torch.models.nemotron_h import NemotronHConfig
    c = ref.lm(s)
    ids = {k: c.pop(k) for k in ("bos_token_id", "eos_token_id", "pad_token_id")}
    return NemotronHConfig.from_published(c, **ids)


def build_model(config: dict, seed: int, device):
    """Blip2NemotronH built on ``meta``, placed on ``device``, every tensor
    of its state made there by name in the dtype the model holds it in."""
    from situation3d_tpu_torch.models.blip2_nemotron_h import Blip2NemotronH
    from situation3d_tpu_torch.models.positional import voxel_position_table
    s = ref.settings(config)
    model = Blip2NemotronH(qformer_config(s), lm_config(s), s["pc_feat_dim"], s["pos_scale"],
                           s["max_txt_len"], DTYPES[config["compute_dtype"]],
                           DTYPES[config["param_dtype"]], device="meta")
    model.to_empty(device=device)
    spec = ref.param_spec(s)
    every = dict(model.named_parameters())
    if set(every) != set(spec) or set(model.state_dict()) != set(spec):
        raise KeyError(f"model and spec differ: {sorted(set(every) ^ set(spec))[:8]}")
    with torch.no_grad():
        for n, p in every.items():
            if tuple(p.shape) != spec[n]:
                raise ValueError(f"{n}: model {tuple(p.shape)}, spec {spec[n]}")
            p.data = ref.make_weight(n, spec[n], seed, device, p.dtype, config)
    model.pos_table = torch.from_numpy(voxel_position_table(s["pc_feat_dim"] // 3)).to(device)
    return model.eval()


def reference_weights(config: dict, seed: int, device):
    """name -> the same values as float32, made when asked."""
    spec = ref.param_spec(ref.settings(config))
    return lambda n: ref.make_weight(n, spec[n], seed, device, torch.float32, config)


def program_routes(model, batch: dict, max_len: int):
    """The program's tokens for ``batch`` with every step eager, and the
    experts each expert layer chose (``blip2_lfm2_answer.program_routes``'
    layout)."""
    from situation3d_tpu_torch.models.blip2_lfm2 import predict_answers
    from situation3d_tpu_torch.models.nemotron_h import NemotronMoE
    ffs = [m for m in model.lm.modules() if isinstance(m, NemotronMoE)]
    for f in ffs:
        f.routes = []
    try:
        tokens = predict_answers(model, batch, max_len=max_len, graphs=False).cpu()
        return tokens, [[r.cpu() for r in f.routes] for f in ffs]
    finally:
        for f in ffs:
            f.routes = None


class Driver(Lfm2Driver):
    units = "questions"

    def __init__(self, files: dict, seed: int, device):
        self.config, self.mix = files["config"], files["traffic"]
        self.s = ref.settings(self.config)
        self.seed, self.device = seed, torch.device(device)

    def setup(self) -> None:
        s, mix, dev = self.s, self.mix, self.device
        self.model = build_model(self.config, self.seed, dev)
        B, Pn, N = mix["batch_size"], mix["pool_batches"], s["qformer.scene_token_capacity"]
        g = torch.Generator(device=dev).manual_seed(sub_seed(self.seed, FEATS))
        ids, mask = prompts(self.seed, B * Pn, mix, s["prompt"], s["max_txt_len"],
                            self.config["tokenizer_vocab"], s[P + "bos_token_id"])
        self.pool = []
        for k in range(Pn):
            self.pool.append({
                "pc_feat": torch.randn((B, N, s["pc_feat_dim"]), generator=g, device=dev),
                "pc": torch.randint(0, 256, (B, N, 3), generator=g, device=dev, dtype=torch.int32),
                "pc_mask": torch.ones((B, N), dtype=torch.int32, device=dev),
                "input_ids": ids[k * B:(k + 1) * B], "input_mask": mask[k * B:(k + 1) * B]})
        self.B = B
        for k in range(Pn):                         # every prompt width; the first captures
            self._answer(k)
        sync(dev)

    def _answer(self, k: int) -> torch.Tensor:
        from situation3d_tpu_torch.models.blip2_lfm2 import predict_answers
        return predict_answers(self.model, self.pool[k], max_len=self.mix["max_len"]).cpu()

    def window(self, seconds: float, tracer) -> Window:
        from situation3d_tpu_torch.ops.cuda import ssm_scan
        from situation3d_tpu_torch.ops.cuda.moe_experts import device_counters
        Pn = len(self.pool)
        self.served: List[tuple] = []
        counters, ssm = device_counters(self.device), ssm_scan.device_counters(self.device)
        counters.zero_()
        ssm.zero_()

        def body(i: int, win: Window) -> None:
            k = i % Pn
            t0 = time.perf_counter()
            with tracer.batch(self.B, (k, i)):
                tokens = self._answer(k)
            dt = time.perf_counter() - t0
            self.served.append((k, tokens))
            win.latencies_s.extend([dt] * self.B)
            win.units += self.B
            win.attempted += self.B

        win = closed_loop(seconds, body, self.device)
        self.rows_routed, self.experts_read = (int(v) for v in counters.tolist())
        self.scanned, self.stepped = (int(v) for v in ssm.tolist())
        return win

    def layer_context(self, win: Window, summary) -> dict:
        s, eos = self.s, self.s[P + "eos_token_id"]
        c = ref.lm(s)
        n_scene = s["qformer.scene_token_capacity"]
        batches = max(len(self.served), 1)
        moe = flops.moe_least_s(self.experts_read / batches, self.rows_routed / batches,
                                c["hidden_size"], c["moe_intermediate_size"],
                                c["num_experts_per_tok"])
        n_ssm = c["hybrid_override_pattern"].count("M")
        ssm = flops.ssm_least_s(s, self.scanned / batches, self.stepped / batches,
                                self.B * n_ssm)

        def flops_of(tag):
            k, i = tag
            gen = served_positions(self.served[i][1], eos).sum(1).tolist()
            prompt = self.pool[k]["input_mask"].sum(1).tolist()
            return sum(flops.question_flops(s, n_scene, n_p, n_g) for n_p, n_g in zip(prompt, gen))
        return {"summary": summary, "flops_of": flops_of, "moe_least_of": lambda tag: moe,
                "ssm_least_of": lambda tag: ssm}

    def readings(self, precision: str = "float32", program: bool = True) -> Dict[str, float]:
        s, dev, eos = self.s, self.device, self.s[P + "eos_token_id"]
        nq, k_top = s["qformer.num_query_tokens"], s[P + "num_experts_per_tok"]
        rng = np.random.default_rng(sub_seed(self.seed, PICK))
        n = len(self.served)
        longest = max(range(n), key=lambda i: int(served_positions(self.served[i][1], eos).sum()))
        picks = [longest] + [i for i in rng.permutation(n).tolist() if i != longest]
        picks = picks[:self.mix["check_batches"]]
        routes = {}
        if hasattr(self, "model"):
            if program:
                for i in picks:
                    k, _ = self.served[i]
                    routes[i] = program_routes(self.model, self.pool[k], self.mix["max_len"])
            del self.model
            free()
        exact_float32()
        weights = reference_weights(self.config, self.seed, dev)
        model = ref.NemotronHReference(s, weights)
        low = None if program else ref.NemotronHReference(s, weights, make_precision(precision))
        gap, flipped, counted = 0.0, 0, 0
        with torch.no_grad():
            for i in picks:
                k, tokens = self.served[i]
                batch = {key: torch.as_tensor(v).to(dev) for key, v in self.pool[k].items()}
                served = served_positions(tokens, eos)
                prompt = [batch["input_ids"][b][batch["input_mask"][b].bool()]
                          for b in range(tokens.shape[0])]
                rows = [tokens[b][served[b]].to(dev) for b in range(tokens.shape[0])]
                model.routes = []
                want = model.logits(batch, prompt, rows)
                lens = [nq + len(p) + len(r) - 1 for p, r in zip(prompt, rows)]
                per_row = list(zip(*[list(zip(idx.cpu().split(lens), pick.cpu().split(lens)))
                                     for idx, pick in model.routes]))
                if low is not None:
                    # the control serves what the lower precision puts first
                    low.routes = []
                    rows = [x.argmax(-1) for x in low.logits(batch, prompt, rows)]
                    got = list(zip(*[idx.cpu().split(lens) for idx, _ in low.routes]))
                    low.routes = None
                else:
                    again, calls = routes[i]
                    got = []
                    for b, r in enumerate(rows):
                        # the positions where the eager run was fed what was served
                        same = (again[b] == tokens[b]).int().cumprod(0).sum()
                        steps = min(len(r) - 1, int(same))
                        got.append(served_routes(calls, b, tokens.shape[0], nq + len(prompt[b]),
                                                 steps))
                for b, (w, r) in enumerate(zip(want, rows)):
                    gap = max(gap, logit_gap(w, r, torch.ones_like(r, dtype=torch.bool)))
                    f, c = route_flips(got[b], [(idx[:len(g)], pick[:len(g)])
                                                for g, (idx, pick) in zip(got[b], per_row[b])],
                                       k_top)
                    flipped, counted = flipped + f, counted + c
                model.routes = None
                del want
        return {"logit_gap": gap, "route_flips": flipped / max(counted, 1)}
