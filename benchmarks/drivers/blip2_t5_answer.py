"""The 3D-LLM answering SQA3D-like questions as its eval loop does:
closed-loop batches through ``models/blip2_t5.py:predict_answers`` (greedy,
``max_len`` tokens). Each question has its own scene features (``[5120,
1408]`` float32 and voxel coordinates, made on the card from the seed: a
pool of batches that stays on the card, as 3D-LLM's precomputed features
are not in the repository) and its prompt, the template around situation and
question words, hash-tokenized as ``data/threedvqa.py`` does. A question's
latency runs from its batch's submission to its tokens on the host.

The check: a sample of the served batches, drawn from the seed and holding
the one that served the most tokens; the reference runs once over each
prompt with its served tokens, and the widest gap by which a served token's
logit lies below the reference's best is compared."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmarks.drivers._sig3d import free, load_weights
from benchmarks.flops import blip2 as flops
from benchmarks.harness.cell import Window, closed_loop, set_dotted, sync
from benchmarks.reference import blip2 as ref
from benchmarks.reference.precision import exact_float32
from benchmarks.reference.precision import make as make_precision
from benchmarks.reference.weights import make_weights, sub_seed

FEATS, TEXT, PICK = 2, 3, 7


def fnv_id(word: str, vocab: int) -> int:
    """The hash tokenizer's id of a word (FNV-1a, 4 ids reserved)."""
    h = 1469598103934665603
    for ch in word.encode():
        h = ((h ^ ch) * 1099511628211) % (1 << 64)
    return 4 + h % (vocab - 4)


def prompts(seed: int, n: int, mix: dict, template: str, max_len: int, vocab: int):
    """T5 ids of ``template`` around ``words`` random words, then ``</s>``."""
    rng = np.random.default_rng(sub_seed(seed, TEXT))
    head, tail = (t.lower().replace(":", " :").split() for t in template.split("{}"))
    ids = np.zeros((n, max_len), np.int32)
    mask = np.zeros((n, max_len), np.int32)
    lo, hi = mix["words"]
    for i, w in enumerate(rng.integers(lo, hi + 1, n)):
        row = ([fnv_id(t, vocab) for t in head] + rng.integers(4, vocab, w).tolist()
               + [fnv_id(t, vocab) for t in tail])[:max_len - 1] + [1]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask


class Driver:
    units = "questions"

    def __init__(self, files: dict, seed: int, device):
        self.config, self.mix = files["config"], files["traffic"]
        self.s = self.config["settings"]
        self.seed, self.device = seed, torch.device(device)

    def setup(self) -> None:
        from situation3d_tpu_torch.config import Blip2Config
        from situation3d_tpu_torch.models import blip2_t5
        from situation3d_tpu_torch.models.positional import voxel_position_table
        s, mix, dev = self.s, self.mix, self.device
        cfg = Blip2Config()
        for k, v in s.items():
            set_dotted(cfg, k, v)
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.config["compute_dtype"]]
        model = blip2_t5.Blip2T5(cfg, dtype=dtype, device="meta")
        model.to_empty(device=dev)
        load_weights(model, make_weights(ref.param_spec(s), self.seed, dev,
                                         self.config.get("init_scale")))
        model.pos_table = torch.from_numpy(voxel_position_table(cfg.pc_feat_dim // 3)).to(dev)
        model.eval()
        self.model = model
        B, P, N = mix["batch_size"], mix["pool_batches"], s["qformer.scene_token_capacity"]
        g = torch.Generator(device=dev).manual_seed(sub_seed(self.seed, FEATS))
        ids, mask = prompts(self.seed, B * P, mix, s["prompt"], s["max_txt_len"],
                            self.config["tokenizer_vocab"])
        self.pool = []
        for k in range(P):
            self.pool.append({
                "pc_feat": torch.randn((B, N, s["pc_feat_dim"]), generator=g, device=dev),
                "pc": torch.randint(0, 256, (B, N, 3), generator=g, device=dev, dtype=torch.int32),
                "pc_mask": torch.ones((B, N), dtype=torch.int32, device=dev),
                "input_ids": ids[k * B:(k + 1) * B], "input_mask": mask[k * B:(k + 1) * B]})
        self.B = B
        for k in range(min(2, P)):                 # warm every shape
            self._answer(k)
        sync(dev)

    def _answer(self, k: int) -> torch.Tensor:
        from situation3d_tpu_torch.models import blip2_t5
        return blip2_t5.predict_answers(self.model, self.pool[k], max_len=self.mix["max_len"]).cpu()

    def window(self, seconds: float, tracer) -> Window:
        P = len(self.pool)
        self.served: List[tuple] = []

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

        return closed_loop(seconds, body, self.device)

    def end_to_end(self, win: Window) -> Dict[str, float]:
        return {"questions_per_s": win.units / win.seconds,
                "question_p95_ms": float(np.percentile(win.latencies_s, 95)) * 1e3}

    def layer_context(self, win: Window, summary) -> dict:
        s, eos = self.s, self.s["t5.eos_token_id"]
        n_scene = s["qformer.scene_token_capacity"]

        def flops_of(tag):
            k, i = tag
            tokens = self.served[i][1]
            gen = ref.served_positions(tokens, eos).sum(1).tolist()
            prompt = self.pool[k]["input_mask"].sum(1).tolist()
            return sum(flops.question_flops(s, n_scene, n_p, g) for n_p, g in zip(prompt, gen))
        return {"summary": summary, "flops_of": flops_of}

    def readings(self, precision: str = "float32", program: bool = True) -> Dict[str, float]:
        s, dev, eos = self.s, self.device, self.s["t5.eos_token_id"]
        rng = np.random.default_rng(sub_seed(self.seed, PICK))
        n = len(self.served)
        longest = max(range(n), key=lambda i: int(ref.served_positions(self.served[i][1], eos).sum()))
        picks = [longest] + [i for i in rng.permutation(n).tolist() if i != longest]
        picks = picks[:self.mix["check_batches"]]
        if hasattr(self, "model"):
            del self.model
            free()
        exact_float32()
        w = make_weights(ref.param_spec(s), self.seed, dev, self.config.get("init_scale"))
        model = ref.Blip2Reference(s, w)
        low = None if program else ref.Blip2Reference(s, w, make_precision(precision))
        gap = 0.0
        with torch.no_grad():
            for i in picks:
                k, tokens = self.served[i]
                batch = {key: torch.as_tensor(v).to(dev) for key, v in self.pool[k].items()}
                tokens = tokens.to(dev)
                want = model.logits(batch, tokens)
                if low is not None:
                    # the control serves what the lower precision puts first
                    tokens = low.logits(batch, tokens).argmax(-1)
                served = ref.served_positions(self.served[i][1].to(dev), eos)
                gap = max(gap, ref.logit_gap(want, tokens, served))
                del want
        return {"logit_gap": gap}
