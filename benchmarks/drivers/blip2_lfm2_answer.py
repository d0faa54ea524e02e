"""The 3D-LLM with an LFM2-MoE language model answering SQA3D-like questions
as ``blip2_t5_answer.py`` drives FlanT5: closed-loop batches through
``models/blip2_lfm2.py:lfm2_predict_answers`` (greedy, ``max_len`` tokens),
each question with its own scene features (a pool of batches on the card)
and its prompt, ``bos`` then the template around situation and question
words, hash-tokenized. A question's latency runs from its batch's
submission to its tokens on the host.

The model's 24 B parameters are made on the card one tensor at a time
(``reference/weights_by_tensor.py``) in the dtype the program holds each in.
Set-up serves every batch of the pool once, which captures the decode steps.

The check: a sample of the served batches, drawn from the seed and holding
the one that served the most tokens. The program serves them once more with
every step eager, recording the experts each expert layer chose; the model,
its captured graphs and their memory pool are then freed, and the reference
runs each question alone, a layer at a time, over [queries ; prompt ;
served tokens]. Two numbers are compared:

- ``logit_gap``: the widest gap by which a served token's logit lies below
  the reference's best;
- ``route_flips``: the share of (position, expert layer) choices whose
  experts differ from the reference's, among those where the reference's
  k-th score (sigmoid plus bias) lies more than ``ROUTE_MARGIN`` above its
  next: a near tie may fall either way in bfloat16, a clear choice may not.
  The weights of the experts share a matrix (``init_shared``), so a wrong
  choice moves the logits little; this number sees it.

The control computes both with the reference in a lower precision in the
program's place."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmarks.drivers._sig3d import free
from benchmarks.drivers.blip2_t5_answer import fnv_id
from benchmarks.flops import lfm2 as flops
from benchmarks.flops.moe import moe_least_s
from benchmarks.harness.cell import Window, closed_loop, sync
from benchmarks.reference import lfm2 as ref
from benchmarks.reference.blip2 import logit_gap, served_positions
from benchmarks.reference.precision import exact_float32
from benchmarks.reference.precision import make as make_precision
from benchmarks.reference.weights import sub_seed
from benchmarks.reference.weights_by_tensor import make_tensor

FEATS, TEXT, PICK = 2, 3, 7
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ROUTE_MARGIN = 0.02     # a choice this clear in the reference's scores may not flip


def lfm2_config(s: dict):
    """The port's ``LFM2Config`` from the settings' ``lfm2.`` keys (the
    published ``config.json``'s, and the assumed special ids)."""
    from situation3d_tpu_torch.models.lfm2 import LFM2Config
    c = dict(ref.lm(s))
    c.pop("model_type", None)
    rope = c.pop("rope_parameters")
    if rope.get("rope_type", "default") != "default":
        raise ValueError(f"rope_type {rope['rope_type']!r} is not supported")
    c["rope_theta"] = float(rope["rope_theta"])
    c["layer_types"] = tuple(c["layer_types"])
    return LFM2Config(**c)


def qformer_config(s: dict):
    from situation3d_tpu_torch.config import QFormerConfig
    return QFormerConfig(**{k[8:]: v for k, v in s.items() if k.startswith("qformer.")})


def build_model(config: dict, seed: int, device):
    """Blip2LFM2 built on ``meta``, placed on ``device``, every tensor of its
    state made there by name in the dtype the model holds it in."""
    from situation3d_tpu_torch.models.blip2_lfm2 import Blip2LFM2
    from situation3d_tpu_torch.models.positional import voxel_position_table
    s = ref.settings(config)
    model = Blip2LFM2(qformer_config(s), lfm2_config(s), s["pc_feat_dim"], s["pos_scale"],
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
            p.data = make_tensor(n, spec[n], seed, device, p.dtype, config.get("init_scale"),
                                 config.get("init_normal"), config.get("init_shared"))
    model.pos_table = torch.from_numpy(voxel_position_table(s["pc_feat_dim"] // 3)).to(device)
    return model.eval()


def reference_weights(config: dict, seed: int, device):
    """name -> the same values as float32, made when asked."""
    spec = ref.param_spec(ref.settings(config))
    return lambda n: make_tensor(n, spec[n], seed, device, torch.float32,
                                 config.get("init_scale"), config.get("init_normal"),
                                 config.get("init_shared"))


def prompts(seed: int, n: int, mix: dict, template: str, max_len: int, vocab: int, bos: int):
    """ids of ``bos``, then ``template`` around ``words`` random words,
    right-padded to ``max_len``."""
    rng = np.random.default_rng(sub_seed(seed, TEXT))
    head, tail = (t.lower().replace(":", " :").split() for t in template.split("{}"))
    ids = np.zeros((n, max_len), np.int32)
    mask = np.zeros((n, max_len), np.int32)
    lo, hi = mix["words"]
    for i, w in enumerate(rng.integers(lo, hi + 1, n)):
        row = ([bos] + [fnv_id(t, vocab) for t in head] + rng.integers(4, vocab, w).tolist()
               + [fnv_id(t, vocab) for t in tail])[:max_len]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask


def program_routes(model, batch: dict, max_len: int):
    """The program's tokens for ``batch`` with every step eager, and the
    experts each expert layer chose: a list a layer, of int32 [B * L, k] for
    the prefill (left-padded rows) then [B, k] for each decode step."""
    from situation3d_tpu_torch.models.blip2_lfm2 import lfm2_predict_answers
    from situation3d_tpu_torch.models.lfm2 import MoEFF
    ffs = [m for m in model.lfm2.modules() if isinstance(m, MoEFF)]
    for f in ffs:
        f.routes = []
    try:
        tokens = lfm2_predict_answers(model, batch, max_len=max_len, graphs=False).cpu()
        return tokens, [[r.cpu() for r in f.routes] for f in ffs]
    finally:
        for f in ffs:
            f.routes = None


def chosen(idx: torch.Tensor, experts: int) -> torch.Tensor:
    """bool [n, experts]: the experts of each row of ``idx`` [n, k] (-1 none)."""
    hot = torch.nn.functional.one_hot(idx.clamp(min=0).long(), experts).bool()
    return (hot & (idx >= 0)[..., None]).any(1)


def route_flips(got: List[torch.Tensor], want: List[tuple], k: int) -> tuple:
    """(flipped, counted): over expert layers, ``got[l]`` the experts [n, ·]
    chosen at the n positions that the reference's ``want[l] = (idx, pick)``
    holds; counted, the positions whose reference k-th score lies more than
    ``ROUTE_MARGIN`` above its next; flipped, those of them chosen otherwise."""
    flipped = counted = 0
    for g, (idx, pick) in zip(got, want):
        top = pick.topk(k + 1, -1).values
        clear = (top[:, k - 1] - top[:, k]) > ROUTE_MARGIN
        differ = (chosen(g, pick.shape[1]) != chosen(idx, pick.shape[1])).any(-1)
        flipped += int((differ & clear).sum())
        counted += int(clear.sum())
    return flipped, counted


def served_routes(calls: List[List[torch.Tensor]], b: int, B: int, prefix: int,
                  steps: int) -> List[torch.Tensor]:
    """Row ``b``'s experts at its positions, a tensor a layer: the prefill's
    last ``prefix`` positions (its real ones), then decode steps 1 ..
    ``steps``."""
    out = []
    for layer in calls:
        pre = layer[0].view(B, -1, layer[0].shape[-1])[b]
        out.append(torch.cat([pre[pre.shape[0] - prefix:]]
                             + [layer[j][b:b + 1] for j in range(1, steps + 1)]))
    return out


class Driver:
    units = "questions"

    def __init__(self, files: dict, seed: int, device):
        self.config, self.mix = files["config"], files["traffic"]
        self.s = ref.settings(self.config)
        self.seed, self.device = seed, torch.device(device)

    def setup(self) -> None:
        s, mix, dev = self.s, self.mix, self.device
        self.model = build_model(self.config, self.seed, dev)
        B, P, N = mix["batch_size"], mix["pool_batches"], s["qformer.scene_token_capacity"]
        g = torch.Generator(device=dev).manual_seed(sub_seed(self.seed, FEATS))
        ids, mask = prompts(self.seed, B * P, mix, s["prompt"], s["max_txt_len"],
                            self.config["tokenizer_vocab"], s["lfm2.bos_token_id"])
        self.pool = []
        for k in range(P):
            self.pool.append({
                "pc_feat": torch.randn((B, N, s["pc_feat_dim"]), generator=g, device=dev),
                "pc": torch.randint(0, 256, (B, N, 3), generator=g, device=dev, dtype=torch.int32),
                "pc_mask": torch.ones((B, N), dtype=torch.int32, device=dev),
                "input_ids": ids[k * B:(k + 1) * B], "input_mask": mask[k * B:(k + 1) * B]})
        self.B = B
        for k in range(P):                          # every prompt width; the first captures
            self._answer(k)
        sync(dev)

    def _answer(self, k: int) -> torch.Tensor:
        from situation3d_tpu_torch.models.blip2_lfm2 import lfm2_predict_answers
        return lfm2_predict_answers(self.model, self.pool[k], max_len=self.mix["max_len"]).cpu()

    def window(self, seconds: float, tracer) -> Window:
        from situation3d_tpu_torch.ops.cuda.moe_experts import device_counters
        P = len(self.pool)
        self.served: List[tuple] = []
        counters = device_counters(self.device)
        counters.zero_()

        def body(i: int, win: Window) -> None:
            k = i % P
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
        return win

    def end_to_end(self, win: Window) -> Dict[str, float]:
        return {"questions_per_s": win.units / win.seconds,
                "question_p95_ms": float(np.percentile(win.latencies_s, 95)) * 1e3}

    def layer_context(self, win: Window, summary) -> dict:
        s, eos = self.s, self.s["lfm2.eos_token_id"]
        n_scene = s["qformer.scene_token_capacity"]
        batches = max(len(self.served), 1)
        least = moe_least_s(self.experts_read / batches, self.rows_routed / batches,
                            s["lfm2.hidden_size"], s["lfm2.moe_intermediate_size"],
                            s["lfm2.num_experts_per_tok"])

        def flops_of(tag):
            k, i = tag
            gen = served_positions(self.served[i][1], eos).sum(1).tolist()
            prompt = self.pool[k]["input_mask"].sum(1).tolist()
            return sum(flops.question_flops(s, n_scene, n_p, n_g) for n_p, n_g in zip(prompt, gen))
        return {"summary": summary, "flops_of": flops_of, "moe_least_of": lambda tag: least}

    def readings(self, precision: str = "float32", program: bool = True) -> Dict[str, float]:
        s, dev, eos = self.s, self.device, self.s["lfm2.eos_token_id"]
        nq, k_top = s["qformer.num_query_tokens"], s["lfm2.num_experts_per_tok"]
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
        model = ref.LFM2Reference(s, weights)
        low = None if program else ref.LFM2Reference(s, weights, make_precision(precision))
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
