"""SIG3D trainer (port of ``situation3d_tpu/train/trainer.py``) on one
device, eager PyTorch:

- ``train_step`` = forward in training form + loss + backward + NaN guard +
  optimizer update + answer metrics + overflow counters;
- ``eval_step`` computes answer metrics and the loss on the device and hands
  back what the host-side situation metrics need;
- ``Trainer.fit`` / ``evaluate``: log cadence, validation every
  ``val_every_steps``, best tracked by ``answer_acc_at1`` (checkpoint +
  ``best_val_pred_answers.csv``), a final checkpoint.

There is no mesh here: data parallelism over several cards is a later slice.
"""
from __future__ import annotations

import csv
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from situation3d_tpu_torch.config import Config
from situation3d_tpu_torch.models.sig3d import SIG3D
from situation3d_tpu_torch.train.checkpoint import CheckpointManager
from situation3d_tpu_torch.train.logging import StepProfiler
from situation3d_tpu_torch.train.losses import get_loss
from situation3d_tpu_torch.train.metrics import answer_metrics, situation_metrics
from situation3d_tpu_torch.train.optim import (Optimizer, make_optimizer,
                                               sig3d_trainable_mask)


def make_sig3d_optimizer(cfg: Config, model: SIG3D, steps_per_epoch: int):
    """Optimizer with the SIG3D freeze recipe: ``train.frozen_prefixes``
    (the scene encoder by default) plus the ``model.lang_freeze`` mask."""
    return make_optimizer(cfg.train, model, steps_per_epoch,
                          trainable=sig3d_trainable_mask(cfg, model))


@dataclass
class TrainState:
    """Everything a step changes: the model's parameters, the optimizer, the
    step count, and the two generators (token sampling, dropout masks)."""
    model: SIG3D
    optimizer: Optimizer
    step: int
    sample_generator: torch.Generator
    dropout_generator: torch.Generator

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "sample_rng": self.sample_generator.get_state(),
                "dropout_rng": self.dropout_generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.sample_generator.set_state(state["sample_rng"].cpu())
        self.dropout_generator.set_state(state["dropout_rng"].cpu())


def create_train_state(cfg: Config, model: SIG3D, steps_per_epoch: int,
                       seed: int = 0) -> TrainState:
    optimizer, _ = make_sig3d_optimizer(cfg, model, steps_per_epoch)
    dev = model.device
    return TrainState(
        model=model, optimizer=optimizer, step=0,
        sample_generator=torch.Generator(device=dev).manual_seed(seed + 1),
        dropout_generator=torch.Generator(device=dev).manual_seed(seed + 2))


def grads_finite(loss: torch.Tensor, params, mode: str = "loss") -> torch.Tensor:
    """The NaN guard's flag (a 0-d bool tensor): ``mode="loss"`` looks at the
    loss only, ``"full"`` also at every trainable gradient."""
    finite = torch.isfinite(loss).all()
    if mode == "full":
        for p in params:
            if p.grad is not None:
                finite = finite & torch.isfinite(p.grad).all()
    return finite


def train_step(cfg: Config, state: TrainState, batch: Dict[str, Any]
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``batch``; returns the step's metrics as
    tensors on the model's device. A non-finite step (see
    ``train.nan_guard``) changes no parameter and no optimizer state."""
    model = state.model
    model.train()
    b = model._to_device(batch)
    out = model(b, generator=state.sample_generator, train=True,
                dropout_generator=state.dropout_generator)
    loss, terms = get_loss(out, b, cfg.loss, cfg.model.situation_loss_tag)
    state.optimizer.discard()
    loss.backward()
    metrics = {k: v.detach() for k, v in terms.items()}
    if cfg.train.nan_guard != "off":
        finite = grads_finite(loss.detach(), state.optimizer.params, cfg.train.nan_guard)
        metrics["grads_finite"] = finite.to(torch.float32)
        if bool(finite):
            state.optimizer.step()
        else:
            state.optimizer.discard()
    else:
        state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        metrics.update(answer_metrics(out["answer_scores"].detach(),
                                      b["answer_cat_scores"], b.get("question_type")))
    metrics.update({k: v for k, v in out.items() if k.startswith("overflow/")})
    return metrics


def eval_step(cfg: Config, state: TrainState, batch: Dict[str, Any],
              generator: Optional[torch.Generator] = None):
    """Evaluation forward: ``(metrics, kept outputs)``."""
    model = state.model
    model.eval()
    with torch.inference_mode():
        b = model._to_device(batch)
        out = model(b, generator=generator, train=False)
        metrics = answer_metrics(out["answer_scores"], b["answer_cat_scores"],
                                 b.get("question_type"), b.get("sample_valid"))
        _, terms = get_loss(out, b, cfg.loss, cfg.model.situation_loss_tag)
        metrics["loss"] = terms["loss"]
    keep = {k: out[k] for k in ("aux_scores", "scene_positions", "answer_scores")
            if k in out}
    return metrics, keep


class Trainer:
    """Step loop with validation, logging and checkpointing. ``model``
    decides the device (``SIG3D`` defaults to the card and raises without
    one)."""

    def __init__(self, cfg: Config, model: SIG3D, steps_per_epoch: int,
                 state: Optional[TrainState] = None,
                 log_fn: Optional[Callable[[Dict[str, float], int], None]] = None):
        self.cfg = cfg
        self.model = model
        self.steps_per_epoch = steps_per_epoch
        self.state = state or create_train_state(cfg, model, steps_per_epoch,
                                                 cfg.train.seed)
        self.schedule = self.state.optimizer.scheduler.lr_lambdas[0]
        # keep-N never prunes the best validation checkpoint
        self.ckpt = CheckpointManager(cfg.train.ckpt_dir, cfg.train.ckpt_keep,
                                      best_metric="answer_acc_at1")
        self.best_acc = -1.0
        self.log_fn = log_fn or (lambda m, s: None)
        self._timings: Dict[str, list] = {"fetch": [], "step": []}
        self.profiler = StepProfiler(cfg.log.log_dir, tuple(cfg.log.profile_steps))
        self.last_predictions: list = []

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return train_step(self.cfg, self.state, batch)

    def eval_step(self, batch: Dict[str, Any], generator=None):
        return eval_step(self.cfg, self.state, batch, generator)

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def resume(self) -> bool:
        """Restore the latest checkpoint of ``train.ckpt_dir`` (model,
        optimizer, step, generators). False when there is none."""
        saved = self.ckpt.restore(map_location=self.model.device)
        if saved is None:
            return False
        self.state.load_state_dict(saved)
        return True

    def fit(self, train_iter: Iterable, val_iter_fn=None,
            max_steps: Optional[int] = None) -> TrainState:
        cfg = self.cfg.train
        step = self.state.step
        t_fetch = time.perf_counter()
        for batch in train_iter:
            self._timings["fetch"].append(time.perf_counter() - t_fetch)
            t0 = time.perf_counter()
            metrics = self.train_step(batch)
            step = self.state.step
            self.profiler.maybe_toggle(step)
            if step % cfg.log_every_steps == 0:
                self._sync()
                self._timings["step"].append(time.perf_counter() - t0)
                host = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
                host["time/fetch"] = float(np.mean(self._timings["fetch"][-50:]))
                host["time/step"] = float(np.mean(self._timings["step"][-10:]))
                host["lr"] = float(self.schedule(self.state.optimizer.updates))
                self.log_fn(host, step)
            if val_iter_fn is not None and step % cfg.val_every_steps == 0:
                val_metrics = self.evaluate(val_iter_fn(), collect_preds=True)
                self.log_fn({f"val/{k}": v for k, v in val_metrics.items()}, step)
                acc = val_metrics.get("answer_acc_at1", 0.0)
                if acc > self.best_acc:
                    self.best_acc = acc
                    self.ckpt.save(step, self.state.state_dict(),
                                   {"answer_acc_at1": float(acc)})
                    if self.last_predictions:
                        path = os.path.join(cfg.ckpt_dir, "best_val_pred_answers.csv")
                        with open(path, "w", newline="") as fh:
                            w = csv.writer(fh)
                            w.writerow(["question_id", "pred_answer_id"])
                            w.writerows(self.last_predictions)
            if max_steps is not None and step >= max_steps:
                break
            t_fetch = time.perf_counter()
        self.ckpt.save(step, self.state.state_dict())
        return self.state

    def evaluate(self, val_iter: Iterable, collect_preds: bool = False
                 ) -> Dict[str, float]:
        tag = self.cfg.model.situation_loss_tag
        agg: Dict[str, list] = {}
        sit_agg: Dict[str, list] = {}
        gen = torch.Generator(device=self.model.device).manual_seed(
            self.cfg.train.seed + 7)
        n = 0
        breakdown: Dict[str, np.ndarray] = {}
        self.last_predictions = []
        for batch in val_iter:
            batch = dict(batch)
            qids = batch.pop("question_id", None)
            metrics, keep = self.eval_step(batch, gen)
            bs = len(batch["answer_cat_scores"])
            valid = (np.asarray(torch.as_tensor(batch["sample_valid"]).cpu(), bool)
                     if "sample_valid" in batch else None)
            if collect_preds and qids is not None:
                pred = keep["answer_scores"].argmax(dim=-1).cpu().numpy()
                ok = valid if valid is not None else np.ones(len(pred), bool)
                self.last_predictions.extend(
                    (int(q), int(p)) for q, p, v in zip(np.asarray(qids), pred, ok) if v)
            for k, v in metrics.items():
                if v.dim() == 0:
                    agg.setdefault(k, []).append((float(v), bs))
                elif k.startswith("answer_acc_breakdown_"):
                    breakdown[k] = breakdown.get(k, 0) + v.cpu().numpy()  # (correct, count)
            if "aux_scores" in keep:
                sit = situation_metrics(
                    {k: v.float().cpu().numpy() for k, v in keep.items()},
                    {"auxiliary_task": np.asarray(
                        torch.as_tensor(batch["auxiliary_task"]).cpu())},
                    tag, valid)
                for k, v in sit.items():
                    sit_agg.setdefault(k, []).append((float(v), bs))
            n += bs
        out = {}
        for k, pairs in {**agg, **sit_agg}.items():
            tot = sum(w for _, w in pairs)
            out[k] = sum(v * w for v, w in pairs) / max(tot, 1)
        for k, pair in breakdown.items():
            out[k] = float(pair[0]) / max(float(pair[1]), 1.0)
        out["num_samples"] = n
        return out
