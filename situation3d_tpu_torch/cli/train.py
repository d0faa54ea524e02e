"""Training entry point (port of ``situation3d_tpu/cli/train.py``, the
SIG3D / SQA3D task on synthetic data).

Usage:
  python3 -m situation3d_tpu_torch.cli.train --task sqa3d --synthetic \\
      --max-steps 5 --options train.batch_size=8 train.log_every_steps=1

Runs on the card; ``--device cpu`` asks for the CPU (tiny configurations).
The real SQA3D data pipeline (``data/sqa3d.py``) and the other tasks belong
to later slices of the port and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from situation3d_tpu_torch.config import load_config, save_config, to_dict
from situation3d_tpu_torch.data.synthetic import synthetic_batches
from situation3d_tpu_torch.models.sig3d import SIG3D, init_random_weights
from situation3d_tpu_torch.train.logging import MetricWriter
from situation3d_tpu_torch.train.trainer import Trainer

TASKS = ["sqa3d", "3d_vqa", "stage1", "dialogue", "vqa_reading_comprehension",
         "multimodal_classification"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="situation3d_tpu_torch trainer")
    p.add_argument("--task", choices=TASKS, default="sqa3d")
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--options", nargs="*", default=[],
                   help="dot-key overrides, e.g. train.lr=1e-4")
    p.add_argument("--synthetic", action="store_true",
                   help="use synthetic data (hermetic smoke runs)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in train.ckpt_dir "
                        "(model + optimizer + step + generators)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--output", default="outputs/run")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.task != "sqa3d":
        raise NotImplementedError(
            f"--task {args.task} is not ported yet: the 3D-LLM tasks come with "
            "the BLIP-2 + T5 slice, multimodal_classification with the data slice")
    if not args.synthetic:
        raise NotImplementedError(
            "training on SQA3D files needs data/sqa3d.py, which comes with the "
            "data / CLI slice of the port; pass --synthetic")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    logger = logging.getLogger("situation3d_tpu_torch")
    cfg = load_config(args.config, args.options)
    torch.manual_seed(cfg.train.seed)
    os.makedirs(args.output, exist_ok=True)
    save_config(cfg, os.path.join(args.output, "config.json"))

    bs = cfg.train.batch_size
    steps = args.max_steps if args.max_steps is not None else 20
    model = SIG3D(cfg, cfg.data.num_answers,
                  dtype=torch.bfloat16 if cfg.train.bf16 else torch.float32,
                  device=args.device)
    init_random_weights(model, cfg.train.seed)
    with open(os.path.join(args.output, "info.json"), "w") as fh:
        json.dump({"task": args.task, "synthetic": True, "batch_size": bs,
                   "num_answers": cfg.data.num_answers,
                   "device": str(model.device)}, fh, indent=2)

    writer = MetricWriter(cfg.log.log_dir, cfg.log.use_wandb,
                          cfg.log.use_tensorboard, cfg.log.project,
                          config=to_dict(cfg))

    def log_fn(m, s):
        writer.write(m, s)
        logger.info("step %d | %s", s, " ".join(
            f"{k}={v:.4g}" for k, v in m.items() if isinstance(v, float)))

    trainer = Trainer(cfg, model, steps_per_epoch=max(steps, 1), log_fn=log_fn)
    if args.resume:
        if trainer.resume():
            logger.info("resumed from step %d", trainer.state.step)
        else:
            logger.info("no checkpoint found in %s; starting fresh", cfg.train.ckpt_dir)

    def val_batches():
        for i, b in enumerate(synthetic_batches(cfg, bs, 1, cfg.train.seed + 1000,
                                                model.device)):
            yield {**b, "question_id": np.arange(i * bs, (i + 1) * bs)}

    trainer.fit(synthetic_batches(cfg, bs, steps, cfg.train.seed, model.device),
                val_iter_fn=val_batches, max_steps=args.max_steps)
    metrics = trainer.evaluate(val_batches())
    logger.info("final val: %s", metrics)
    writer.close()


if __name__ == "__main__":
    main()
