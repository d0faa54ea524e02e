"""The 3D-LLM's training, as its SQA3D fine-tuning runs it: closed-loop
steps of ``train/blip2_trainer.py:blip2_train_step`` at the mix's batch,
AdamW with clip by value, T5 frozen but its embeddings
(``train/optim.py:blip2_trainable_mask``), the NaN guard. Each sample has
its own scene features (``[5120, 1408]`` float32 and voxel coordinates,
made on the card from the seed: a pool of batches that stays there), a
prompt hash-tokenized as ``blip2_t5_answer.py`` does, and an answer of a
few words then ``</s>``.

Set-up builds ONE train state and drives it through its first
``setup_steps`` steps on distinct batches; the window goes on with that
same state. The readings of those steps (the first gradient as AdamW's
first moment holds it, the trained parameters after them) are held against
the reference's three steps from the same weights and batches
(``reference/blip2_train.py``). The losses are not compared: bfloat16
products move them up to half as far as float8's do, too near to set a
limit between."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmarks.drivers._sig3d import free, load_weights
from benchmarks.drivers.blip2_t5_answer import prompts
from benchmarks.drivers.sig3d_train import BETA1, leaf_norms, worst_leaf_gap
from benchmarks.flops import blip2_train as flops
from benchmarks.harness.cell import Window, closed_loop, set_dotted, sync
from benchmarks.reference import blip2 as ref
from benchmarks.reference import blip2_train as ref_train
from benchmarks.reference.precision import exact_float32
from benchmarks.reference.precision import make as make_precision
from benchmarks.reference.sig3d import AdamW
from benchmarks.reference.weights import make_weights, sub_seed

FEATS, TEXT, ANSWERS = 2, 3, 8
STEPS_PER_EPOCH = 10 ** 6      # the schedule stays at its first rate over a run


def answers(seed: int, n: int, mix: dict, vocab: int, eos: int):
    """int32 labels [n, max words + 1] (the words, ``eos``, then -100) and
    their mask."""
    rng = np.random.default_rng(sub_seed(seed, ANSWERS))
    lo, hi = mix["answer_words"]
    labels = np.full((n, hi + 1), -100, np.int32)
    mask = np.zeros((n, hi + 1), np.int32)
    for i, w in enumerate(rng.integers(lo, hi + 1, n)):
        labels[i, :w + 1] = rng.integers(4, vocab, w).tolist() + [eos]
        mask[i, :w + 1] = 1
    return labels, mask


class Driver:
    units = "samples"

    def __init__(self, files: dict, seed: int, device):
        self.config, self.mix = files["config"], files["traffic"]
        self.s = self.config["settings"]
        self.seed, self.device = seed, torch.device(device)

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from situation3d_tpu_torch.config import Config
        from situation3d_tpu_torch.models import blip2_t5
        from situation3d_tpu_torch.models.positional import voxel_position_table
        from situation3d_tpu_torch.train import blip2_trainer as bt
        s, mix, dev = self.s, self.mix, self.device
        cfg = Config()
        for k, v in s.items():
            set_dotted(cfg.blip2, k, v)
        for k, v in mix["train"].items():
            set_dotted(cfg, k, v)
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.config["compute_dtype"]]
        model = blip2_t5.Blip2T5(cfg.blip2, dtype=dtype, device="meta")
        model.to_empty(device=dev)
        load_weights(model, make_weights(ref.param_spec(s), self.seed, dev,
                                         self.config.get("init_scale")))
        model.pos_table = torch.from_numpy(voxel_position_table(cfg.blip2.pc_feat_dim // 3)).to(dev)
        B, P, N = mix["batch_size"], mix["pool_batches"], s["qformer.scene_token_capacity"]
        g = torch.Generator(device=dev).manual_seed(sub_seed(self.seed, FEATS))
        ids, mask = prompts(self.seed, B * P, mix, s["prompt"], s["max_txt_len"],
                            self.config["tokenizer_vocab"])
        labels, label_mask = answers(self.seed, B * P, mix, self.config["tokenizer_vocab"],
                                     s["t5.eos_token_id"])
        self.pool = []
        for k in range(P):
            rows = slice(k * B, (k + 1) * B)
            self.pool.append({
                "pc_feat": torch.randn((B, N, s["pc_feat_dim"]), generator=g, device=dev),
                "pc": torch.randint(0, 256, (B, N, 3), generator=g, device=dev, dtype=torch.int32),
                "pc_mask": torch.ones((B, N), dtype=torch.int32, device=dev),
                "input_ids": ids[rows], "input_mask": mask[rows],
                "labels": labels[rows], "label_mask": label_mask[rows]})
        self.cfg, self.B = cfg, B
        opt, _ = bt.make_blip2_optimizer(cfg, model, STEPS_PER_EPOCH)
        self.state = bt.Blip2TrainState(model, opt, 0)
        self.trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
        for k in range(mix["setup_steps"]):
            bt.blip2_train_step(cfg, self.state, self.pool[k])
            if k == 0:
                # a step that left the state as it was holds no moment: zero
                moments = {n: opt.adamw.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - BETA1)
                           for n, p in self.trained.items()}
                self.grad_norms = leaf_norms(moments)
        self.after = {n: p.detach().to("cpu", copy=True) for n, p in self.trained.items()}
        sync(dev)

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float, tracer) -> Window:
        from situation3d_tpu_torch.train import blip2_trainer as bt
        B, P, first = self.B, len(self.pool), self.mix["setup_steps"]
        finite = torch.zeros((), device=self.device)
        self.steps = []

        def body(i: int, win: Window) -> None:
            nonlocal finite
            k = (first + i) % P
            with tracer.batch(B, k):
                m = bt.blip2_train_step(self.cfg, self.state, self.pool[k])
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
        s, n_scene = self.s, self.s["qformer.scene_token_capacity"]

        def flops_of(k):
            b = self.pool[k]
            return sum(flops.sample_flops(s, n_scene, int(n_p), int(n_a)) for n_p, n_a in
                       zip(b["input_mask"].sum(1), b["label_mask"].sum(1)))
        return {"summary": summary, "flops_of": flops_of}

    # -- the check ------------------------------------------------------------
    def readings(self, precision: str = "float32", program: bool = True) -> Dict[str, float]:
        """The numbers compared: the program's (or, with ``program=False``,
        the reference in ``precision`` put in its place) against the float32
        reference's three steps."""
        dev = self.device
        if hasattr(self, "state"):
            del self.state, self.trained
            free()
        want = self._reference_steps("float32")
        if program:
            got = {"grad_norms": self.grad_norms, "after": self.after}
        else:
            got = self._reference_steps(precision)
        leaves = sorted(want["grad_norms"])
        grad_gap = worst_leaf_gap(got["grad_norms"], want["grad_norms"], leaves)
        med = float(np.median([want["grad_norms"][n] for n in leaves]))
        moved = [n for n in leaves if want["grad_norms"][n] >= 1e-3 * med]
        p0 = want["initial"]
        got_change = leaf_norms({n: got["after"][n].to(dev) - p0[n] for n in moved})
        want_change = leaf_norms({n: want["after"][n].to(dev) - p0[n] for n in moved})
        update_gap = worst_leaf_gap(got_change, want_change, moved)
        return {"grad_norm_gap": grad_gap, "update_norm_gap": update_gap}

    def _reference_steps(self, precision: str) -> dict:
        s, dev = self.s, self.device
        exact_float32()
        w = make_weights(ref.param_spec(s), self.seed, dev, self.config.get("init_scale"))
        initial = {n: t.clone() for n, t in w.items() if ref_train.trainable(n)}
        params = {n: t.clone().requires_grad_(True) for n, t in initial.items()}
        model = ref.Blip2Reference(s, {**w, **params}, make_precision(precision))
        opt = AdamW(params, self.mix["train"])
        grad_norms = None
        for k in range(self.mix["setup_steps"]):
            batch = {key: torch.as_tensor(v).to(dev) for key, v in self.pool[k].items()}
            loss = ref_train.loss(model, batch)
            grads = torch.autograd.grad(loss, list(params.values()))
            used = opt.step(dict(zip(params, grads)))
            if k == 0:
                grad_norms = leaf_norms(used)
            del loss, grads, used
        return {"grad_norms": grad_norms, "initial": initial,
                "after": {n: p.detach() for n, p in params.items()}}
