"""3D-LLM (Blip2T5) training and generation-evaluation (port of
``situation3d_tpu/train/blip2_trainer.py``) on one device, eager PyTorch:

- ``blip2_train_step``: forward + loss + backward + NaN guard + AdamW over
  the trainable parameters only. T5 is frozen but its embeddings
  (``train/optim.py:blip2_trainable_mask``): a frozen parameter has
  ``requires_grad=False``, so autograd computes no weight gradient for it
  and its ``.grad`` stays ``None``;
- ``Blip2Trainer.fit``: validation (greedy generation scored by exact match)
  every ``train.iters_per_inner_epoch`` steps, else every epoch, a
  checkpoint each time, the best by ``val_em`` kept and reloaded at the end;
  ``train.max_iters`` bounds the run;
- checkpoints: the reference's trainable-only save (``runner_base.py:530-554``)
  plus the optimizer and the step, one file a step; the frozen T5 comes from
  wherever the model was built (its seed or a converted checkpoint);
- ``evaluate_generation`` writes ``vqa_result_rank{r}.json`` and, on rank
  0 after a barrier, the merged ``vqa_result.json`` (the reference's
  per-rank save).

Data parallelism (``parallel/mesh.py``): under a process group every rank
reads the same global batch and keeps its rows; the loss is the rank's term
of the global batch's token mean (the ranks' answers differ in length), the
trainable gradients are averaged over the ranks, and the NaN guard's flag is
reduced over them. Generation runs each rank's rows and gathers the tokens.
Rank 0 alone logs and writes.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from situation3d_tpu_torch.config import Config
from situation3d_tpu_torch.eval.scorers import exact_match
from situation3d_tpu_torch.models.blip2_t5 import Blip2T5, predict_answers
from situation3d_tpu_torch.parallel import collectives
from situation3d_tpu_torch.parallel.mesh import (Mesh, batch_sharding, make_mesh, replicated,
                                                 shard_batch)
from situation3d_tpu_torch.train.checkpoint import CheckpointManager, save_trainable_npz
from situation3d_tpu_torch.train.logging import MetricLogger
from situation3d_tpu_torch.train.optim import (Optimizer, blip2_trainable_mask,
                                               make_optimizer)
from situation3d_tpu_torch.train.trainer import grads_finite
from situation3d_tpu_torch.utils.trace import span


def make_blip2_optimizer(cfg: Config, model: Blip2T5, steps_per_epoch: int):
    """AdamW with the BLIP-2 freeze recipe (T5 frozen but its embeddings)."""
    return make_optimizer(cfg.train, model, steps_per_epoch,
                          trainable=blip2_trainable_mask(cfg, model))


def restore_trainable(model: Blip2T5, tensors: Dict[str, torch.Tensor]) -> None:
    """Copy a checkpoint's trainable tensors into ``model`` by name."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, value in tensors.items():
            params[name].copy_(value)


@dataclass
class Blip2TrainState:
    model: Blip2T5
    optimizer: Optimizer
    step: int

    def state_dict(self) -> dict:
        """The trainable parameters, the optimizer and the step."""
        return {"step": self.step,
                "trainable": {n: p.detach() for n, p in self.model.named_parameters()
                              if p.requires_grad},
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        restore_trainable(self.model, state["trainable"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def blip2_train_step(cfg: Config, state: Blip2TrainState, batch: Dict[str, Any],
                     mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step; the step's metrics (this rank's) as tensors on
    the device. A non-finite step (``train.nan_guard``) changes no parameter
    and no optimizer state. With a ``mesh`` of several ranks ``batch`` holds
    this rank's rows (``shard_batch``)."""
    model = state.model
    model.train()
    with span("train.step", request=state.step + 1):
        with span("train.loss"):
            loss = model(batch, axis=mesh.data_axis if mesh and mesh.world > 1 else None)["loss"]
        state.optimizer.discard()
        with span("train.backward"):
            loss.backward()
        collectives.pmean_grads(state.optimizer.params)
        metrics = {"loss": loss.detach()}
        if cfg.train.nan_guard != "off":
            with span("train.nan_guard"):
                finite = grads_finite(loss.detach(), state.optimizer.params, cfg.train.nan_guard)
                finite = collectives.pmin(finite.to(torch.float32)).bool()    # one verdict
                metrics["grads_finite"] = finite.to(torch.float32)
                finite = bool(finite)
        else:
            finite = True
        with span("train.optimizer"):
            if finite:
                state.optimizer.step()
            else:
                state.optimizer.discard()
        state.step += 1
    return metrics


class Blip2Trainer:
    """RunnerBase / RunnerIter for the 3d_vqa task. ``model`` decides the
    device, ``cfg.mesh`` and the process group that is up the data-parallel
    layout."""

    def __init__(self, cfg: Config, model: Blip2T5, steps_per_epoch: int,
                 log_fn: Optional[Callable] = None,
                 text_decoder: Optional[Callable] = None):
        self.cfg = cfg
        self.model = model
        self.mesh = make_mesh(cfg.mesh, model.device)
        replicated(model, self.mesh)
        self.steps_per_epoch = max(steps_per_epoch, 1)
        optimizer, self.schedule = make_blip2_optimizer(cfg, model, self.steps_per_epoch)
        self.state = Blip2TrainState(model, optimizer, 0)
        self.trainable = blip2_trainable_mask(cfg, model)
        self.ckpt = CheckpointManager(cfg.train.ckpt_dir, cfg.train.ckpt_keep,
                                      best_metric="val_em")
        self.log_fn = log_fn or (lambda m, s: None)
        self.text_decoder = text_decoder
        self.best_metric = -1.0

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    # -- checkpointing ----------------------------------------------------

    def resume(self) -> bool:
        """Restore the latest checkpoint (trainable parameters, optimizer,
        step). False when there is none."""
        collectives.barrier()           # a checkpoint rank 0 is writing is whole
        saved = self.ckpt.restore(map_location=self.model.device)
        if saved is None:
            return False
        self.state.load_state_dict(saved)
        return True

    def save(self, metrics: Optional[dict] = None) -> None:
        """Rank 0 writes the checkpoint; every rank waits for it."""
        if self.mesh.rank == 0:
            self.ckpt.save(self.state.step, self.state.state_dict(), metrics)
        collectives.barrier()

    def reload_best(self) -> Optional[int]:
        """Reload the retained checkpoint with the best ``val_em``."""
        collectives.barrier()
        step = self.ckpt.best_step("val_em")
        if step is None:
            return None
        self.state.load_state_dict(self.ckpt.restore(step, map_location=self.model.device))
        return step

    def save_trainable(self, path: str) -> int:
        """Trainable-only ``.npz`` (the reference's best-model save), written
        by rank 0."""
        n = save_trainable_npz(path, self.model, self.trainable) if self.mesh.rank == 0 else 0
        collectives.barrier()
        return n

    # -- training ---------------------------------------------------------

    def fit(self, train_iter: Iterable, val_iter_fn=None, golds=None,
            max_steps: Optional[int] = None) -> Blip2TrainState:
        """Train with periodic validation and best tracking. The cadence is
        ``iters_per_inner_epoch`` when set, else one epoch of steps;
        ``max_iters`` (or ``max_steps``) bounds the run."""
        cfg = self.cfg.train
        cadence = cfg.iters_per_inner_epoch or self.steps_per_epoch
        limit = min(x for x in (max_steps, cfg.max_iters or None,
                                cfg.epochs * self.steps_per_epoch) if x is not None)
        step = self.state.step
        last_val = -1
        meter = MetricLogger()
        fetch: List[float] = []
        t0 = time.perf_counter()
        batches = iter(train_iter)
        while True:
            t_fetch = time.perf_counter()
            with span("train.fetch"):
                batch = next(batches, None)
            if batch is None or step >= limit:
                break
            fetch.append(time.perf_counter() - t_fetch)
            metrics = blip2_train_step(self.cfg, self.state, shard_batch(batch, self.mesh),
                                       self.mesh)
            step = self.state.step
            if step % cfg.log_every_steps == 0:
                self._sync()
                meter.update(loss=float(collectives.pmean(metrics["loss"])))
                if self.mesh.rank == 0:
                    self.log_fn({"loss": meter.meters["loss"].value,
                                 "loss_smoothed": meter.meters["loss"].median,
                                 "lr": float(self.schedule(self.state.optimizer.updates)),
                                 "time/step": (time.perf_counter() - t0) / cfg.log_every_steps,
                                 "time/fetch": float(np.mean(fetch[-cfg.log_every_steps:]))},
                                step)
                t0 = time.perf_counter()
            if (step % cadence == 0 or step >= limit) and last_val != step:
                self._validate(step, val_iter_fn, golds)
                last_val = step
                t0 = time.perf_counter()
        if self.state.step > 0 and self.ckpt.latest_step() != step:
            self.save()
        if val_iter_fn is not None:
            self.reload_best()
        return self.state

    def _validate(self, step, val_iter_fn, golds) -> None:
        if val_iter_fn is None:
            self.save()
            return
        em, preds = self.evaluate(val_iter_fn(), golds)
        if self.mesh.rank == 0:
            self.log_fn({"val/em": em, "val/n": float(len(preds))}, step)
        self.save({"val_em": em})
        if em > self.best_metric:
            self.best_metric = em
            self.save_trainable(os.path.join(self.cfg.train.ckpt_dir,
                                             "checkpoint_best_trainable.npz"))

    # -- evaluation -------------------------------------------------------

    def predict(self, eval_iter: Iterable) -> Dict[int, str]:
        """Greedy ``predict_answers`` over eval batches -> {qid: answer},
        every rank's rows on every rank."""
        if self.text_decoder is None:
            raise ValueError("Blip2Trainer.predict needs a text_decoder")
        self.model.eval()
        out: Dict[int, str] = {}
        for batch in eval_iter:
            qids = np.asarray(batch["question_id"])
            valid = np.asarray(batch.get("sample_valid", np.ones(len(qids), bool)))
            tokens = _predict_global(self.model, batch, self.cfg.eval.max_gen_len, self.mesh)
            for i in range(len(qids)):
                if valid[i]:
                    out[int(qids[i])] = self.text_decoder(tokens[i])
        return out

    def evaluate(self, eval_iter: Iterable, golds: Optional[Dict] = None):
        """(exact-match score, predictions). ``golds``: {qid: [answers]}."""
        preds = self.predict(eval_iter)
        if not golds:
            return 0.0, preds
        keyed = {str(k): v for k, v in preds.items()}
        gold = {str(k): v for k, v in golds.items() if str(k) in keyed}
        return (exact_match(keyed, gold) if gold else 0.0), preds


def train_blip2(cfg: Config, model: Blip2T5, train_iter: Iterable,
                max_steps: Optional[int] = None, log_fn: Optional[Callable] = None,
                steps_per_epoch: int = 1000) -> Blip2T5:
    """The fit loop alone; returns the trained model."""
    trainer = Blip2Trainer(cfg, model, steps_per_epoch, log_fn=log_fn)
    trainer.fit(train_iter, max_steps=max_steps)
    return model


def _predict_global(model: Blip2T5, batch: Dict[str, Any], max_len: int,
                    mesh: Mesh) -> np.ndarray:
    """Greedy tokens of the global ``batch``: each rank decodes its rows and
    the tokens are gathered."""
    tokens = predict_answers(model, shard_batch(batch, mesh), max_len)
    if mesh.world > 1:
        tokens = collectives.all_gather(tokens, tiled=True)
    return tokens.cpu().numpy()


def evaluate_generation(cfg: Config, model: Blip2T5, eval_iter: Iterable, text_decoder,
                        output_dir: Optional[str] = None, max_len: Optional[int] = None,
                        mesh: Optional[Mesh] = None) -> Dict[int, str]:
    """``predict_answers`` over the eval set -> {question_id: answer}, every
    rank's answers. With a ``mesh`` of several ranks each rank decodes its
    rows of every batch. With ``output_dir``, each rank writes its
    ``vqa_result_rank{r}.json``; after a barrier rank 0 merges them into
    ``vqa_result.json``."""
    mesh = mesh or make_mesh(cfg.mesh, model.device)
    model.eval()
    results: List[Dict[str, Any]] = []
    for batch in eval_iter:
        qids = np.asarray(batch["question_id"])
        valid = np.asarray(batch.get("sample_valid", np.ones(len(qids), bool)))
        rows = range(len(qids))[batch_sharding(mesh, len(qids))]
        tokens = predict_answers(model, shard_batch(batch, mesh),
                                 max_len or cfg.eval.max_gen_len).cpu().numpy()
        for t, i in zip(tokens, rows):
            if valid[i]:
                results.append({"question_id": int(qids[i]), "answer": text_decoder(t)})
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, f"vqa_result_rank{mesh.rank}.json"), "w") as fh:
            json.dump(results, fh)
        collectives.barrier()           # every rank's file is written
        if mesh.rank == 0:
            merged = []
            for fn in sorted(os.listdir(output_dir)):
                if fn.startswith("vqa_result_rank"):
                    with open(os.path.join(output_dir, fn)) as fh:
                        merged.extend(json.load(fh))
            with open(os.path.join(output_dir, "vqa_result.json"), "w") as fh:
                json.dump(merged, fh)
        collectives.barrier()
    everyone = [r for part in collectives.process_gather_host(results) for r in part]
    return {r["question_id"]: r["answer"] for r in everyone}
