"""Optimizer and learning-rate schedules (port of
``situation3d_tpu/train/optim.py``): AdamW with the weight-decay / no-decay
split, clip-by-value before the update, the four schedules, the trainable
masks (frozen prefixes, the language-encoder freeze recipe) and gradient
accumulation.

Freezing is the PyTorch idiom: a frozen parameter gets
``requires_grad=False`` and is not handed to the optimizer, so it carries no
Adam moments and autograd computes no weight gradient for it. Masks are
dictionaries ``parameter name -> bool`` over ``model.named_parameters()``;
the names equal the reference's tree paths joined by dots.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

from situation3d_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]
Mask = Dict[str, bool]


# ---------------------------------------------------------------------------
# Schedules: step count (0 for the first update) -> learning rate
# ---------------------------------------------------------------------------

def step_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Schedule:
    """Decay by ``lr_decay_rate`` from the first step of each epoch in
    ``lr_decay_steps`` on."""
    boundaries = sorted(int(e) * steps_per_epoch for e in cfg.lr_decay_steps)

    def schedule(step: int) -> float:
        return cfg.lr * cfg.lr_decay_rate ** sum(step >= b for b in boundaries)
    return schedule


def multistep_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Schedule:
    return step_schedule(cfg, steps_per_epoch)


def _linear(init: float, end: float, steps: int) -> Schedule:
    def schedule(step: int) -> float:
        if steps <= 0:
            return end
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(step: int) -> float:
        start = 0
        for fn, b in zip(schedules, list(boundaries) + [None]):
            if b is None or step < b:
                return fn(step - start)
            start = b
        raise AssertionError("unreachable")
    return schedule


def warmup_cosine_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Schedule:
    """Linear warm-up from 0 to ``lr`` over ``warmup_steps``, then cosine to
    ``min_lr`` over the rest of all epochs."""
    total = max(cfg.epochs * steps_per_epoch, cfg.warmup_steps + 1)
    decay_steps = total - cfg.warmup_steps
    alpha = cfg.min_lr / cfg.lr if cfg.lr else 0.0

    def cosine(step: int) -> float:
        c = min(step, decay_steps)
        return cfg.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps))
                         + alpha)
    return _join([_linear(0.0, cfg.lr, cfg.warmup_steps), cosine], [cfg.warmup_steps])


def warmup_step_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Schedule:
    return _join([_linear(0.0, cfg.lr, cfg.warmup_steps),
                  step_schedule(cfg, steps_per_epoch)], [cfg.warmup_steps])


LR_SCHEDULES = {"step": step_schedule, "multistep": multistep_schedule,
                "warmup_cosine": warmup_cosine_schedule,
                "warmup_step": warmup_step_schedule}


def bn_momentum_schedule(cfg: TrainConfig, epoch: int) -> float:
    """BN momentum decay: ``init * decay^(epoch // step)`` floored at 0.01,
    returned as the running-average weight ``1 - momentum``. No batch norm of
    this slice reads it (the scene encoder's stay in evaluation form)."""
    m = max(cfg.bn_momentum_init
            * cfg.bn_momentum_decay ** (epoch // max(cfg.bn_momentum_step, 1)), 0.01)
    return 1.0 - m


# ---------------------------------------------------------------------------
# Trainable-parameter masks
# ---------------------------------------------------------------------------

def _names(params) -> list:
    if isinstance(params, torch.nn.Module):
        return [n for n, _ in params.named_parameters()]
    return list(params)


def mask_from_predicate(params, trainable_fn: Callable[[Tuple[str, ...]], bool]) -> Mask:
    """``name -> trainable_fn(name split at the dots)``."""
    return {n: bool(trainable_fn(tuple(n.split(".")))) for n in _names(params)}


def combine_masks(*masks: Mask) -> Optional[Mask]:
    """Logical AND (trainable iff trainable under all)."""
    if not masks:
        return None
    return {n: all(m[n] for m in masks) for n in masks[0]}


def prefix_trainable(params, prefixes: Iterable[str]) -> Mask:
    """True where no component of the parameter's path starts with a frozen
    prefix."""
    prefixes = tuple(prefixes)
    return mask_from_predicate(params, lambda names: not any(
        any(k.startswith(pref) for k in names) for pref in prefixes))


def lang_freeze_trainable(params, mode: str, num_layers: int,
                          module: str = "lang_net") -> Mask:
    """Language-encoder freeze recipe: "none" (all of it trains) | "all"
    (none of it) | "last_layer" (only the last encoder layer). Everything
    outside ``module`` stays trainable."""
    if mode not in ("none", "all", "last_layer"):
        raise ValueError(f"invalid lang_freeze mode {mode!r}")
    last = f"layer{num_layers - 1}"

    def fn(names):
        if module not in names or mode == "none":
            return True
        return mode == "last_layer" and last in names
    return mask_from_predicate(params, fn)


def sig3d_trainable_mask(cfg, params) -> Mask:
    """SIG3D's mask from the full Config: the ``model.lang_freeze`` recipe
    (the prefix filter is applied by :func:`make_optimizer` itself)."""
    return lang_freeze_trainable(params, cfg.model.lang_freeze, cfg.lang.num_layers)


def decay_mask(named_params) -> Mask:
    """True where weight decay applies: matrices, embeddings and conv
    kernels; not biases, norm scales or any other vector."""
    return {n: p.dim() >= 2 and n.rsplit(".", 1)[-1] not in ("bias", "scale")
            for n, p in named_params}


def trainable_count(model: torch.nn.Module, trainable: Mask) -> Tuple[int, int]:
    """(n_trainable, n_total) parameter counts for logging."""
    sizes = {n: p.numel() for n, p in model.named_parameters()}
    return sum(s for n, s in sizes.items() if trainable[n]), sum(sizes.values())


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

class Optimizer:
    """Clip by value -> AdamW (decoupled decay on the decay group) at the
    scheduled rate, over the trainable parameters only, with the mean of
    ``grad_accum_steps`` gradients per update. ``step()`` consumes the
    ``.grad`` of every trainable parameter."""

    def __init__(self, cfg: TrainConfig, model: torch.nn.Module,
                 schedule: Schedule, trainable: Mask):
        named = list(model.named_parameters())
        decays = decay_mask(named)
        groups = {True: [], False: []}
        for n, p in named:
            p.requires_grad_(trainable[n])
            if trainable[n]:
                groups[decays[n]].append(p)
        self.params = groups[True] + groups[False]
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "weight_decay": cfg.weight_decay if dec else 0.0}
             for dec, ps in groups.items() if ps],
            lr=1.0, betas=(0.9, 0.999), eps=1e-8)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.adamw, schedule)
        self.clip = cfg.grad_clip_value
        self.accum = max(int(cfg.grad_accum_steps), 1)
        self._mini = 0
        self._sums = None

    @property
    def updates(self) -> int:
        """Number of AdamW updates applied so far."""
        return self.scheduler.last_epoch

    def discard(self) -> None:
        """Drop the gradients of a step that must not count."""
        for p in self.params:
            p.grad = None

    def step(self) -> bool:
        """Returns True when an update was applied (every
        ``grad_accum_steps``-th call)."""
        # a trainable parameter the loss does not reach gets a zero gradient
        # (not None): decoupled weight decay still applies to it
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.accum > 1:
            grads = [p.grad for p in self.params]
            if self._sums is None:
                self._sums = [torch.zeros_like(p) for p in self.params]
                self._mini = 0
            for acc, g in zip(self._sums, grads):      # running mean of the gradients
                acc.add_((g - acc) / (self._mini + 1))
            self._mini += 1
            self.discard()
            if self._mini < self.accum:
                return False
            for p, s in zip(self.params, self._sums):
                p.grad = s
            self._mini, self._sums = 0, None
        torch.nn.utils.clip_grad_value_(self.params, self.clip)
        self.adamw.step()
        self.scheduler.step()
        self.discard()
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "mini": self._mini, "sums": self._sums}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["scheduler"])
        self._mini, self._sums = state["mini"], state["sums"]


def make_optimizer(cfg: TrainConfig, model: torch.nn.Module,
                   steps_per_epoch: int = 1000, trainable: Optional[Mask] = None
                   ) -> Tuple[Optimizer, Schedule]:
    """AdamW + clip + schedule over the trainable parameters of ``model``.
    ``trainable`` (one of the masks above) is ANDed with the
    ``cfg.frozen_prefixes`` mask; frozen parameters get
    ``requires_grad=False`` and no optimizer state."""
    if cfg.lr_schedule not in LR_SCHEDULES:
        raise KeyError(f"unknown lr_schedule {cfg.lr_schedule!r}; "
                       f"one of {sorted(LR_SCHEDULES)}")
    schedule = LR_SCHEDULES[cfg.lr_schedule](cfg, steps_per_epoch)
    masks = [prefix_trainable(model, tuple(cfg.frozen_prefixes))]
    if trainable is not None:
        masks.append(trainable)
    return Optimizer(cfg, model, schedule, combine_masks(*masks)), schedule
