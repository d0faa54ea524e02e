"""Training entry point (port of ``situation3d_tpu/cli/train.py``, the
``sqa3d`` and ``multimodal_classification`` tasks: SIG3D on SQA3D files).

Usage:
  python3 -m situation3d_tpu_torch.cli.train --task sqa3d \\
      --options data.sqa_train=.../SQA_train.json data.sqa_val=.../SQA_val.json \\
      data.answer_counter=.../answer_counter.json data.scene_dir=... \\
      data.scans_dir=... train.batch_size=8 --max-steps 100
  python3 -m situation3d_tpu_torch.cli.train --task sqa3d --synthetic \\
      --max-steps 5 --options data.num_answers=12 train.batch_size=8

Reads ``SQA_{split}.json`` + OpenScene ``.pth`` scenes through
``data/sqa3d.py``; without a file at ``data.sqa_train``, or with
``--synthetic``, it trains on ``make_synthetic_dataset`` (2 scenes x 16
records, 12 answers), as the reference does. Writes ``config.json``,
``answer_vocab.json`` and ``info.json`` under ``--output``, checkpoints under
``train.ckpt_dir`` (``--resume`` continues from the latest), metrics under
``log.log_dir``. Runs on the card; ``--device cpu`` asks for the CPU. The
3D-LLM tasks come with the BLIP-2 slice of the port and raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json
import os

from situation3d_tpu_torch.config import load_config, save_config, to_dict
from situation3d_tpu_torch.data.sqa3d import batch_iterator
from situation3d_tpu_torch.device import resolve_device
from situation3d_tpu_torch.train.logging import MetricWriter
from situation3d_tpu_torch.train.tasks import setup_task
from situation3d_tpu_torch.utils.misc import set_seed, setup_logger

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


def main(argv=None) -> dict:
    """Train, then evaluate on the val split; returns the final metrics."""
    args = parse_args(argv)
    cfg = load_config(args.config, args.options)
    task = setup_task(args.task, cfg, synthetic=args.synthetic, device=args.device)
    device = resolve_device(args.device)
    logger = setup_logger()
    set_seed(cfg.train.seed)
    os.makedirs(args.output, exist_ok=True)
    save_config(cfg, os.path.join(args.output, "config.json"))

    datasets = task.build_datasets()
    train_ds, val_ds = datasets["train"], datasets["val"]
    if len(train_ds.vocab) != cfg.data.num_answers:
        raise ValueError(f"the answer vocabulary has {len(train_ds.vocab)} answers "
                         f"but data.num_answers={cfg.data.num_answers}")
    # answer_vocab.json / info.json parity (train.py:315-333)
    with open(os.path.join(args.output, "answer_vocab.json"), "w") as fh:
        json.dump(train_ds.vocab.itos_list, fh)
    with open(os.path.join(args.output, "info.json"), "w") as fh:
        json.dump({"task": args.task, "num_train": len(train_ds),
                   "num_val": len(val_ds), "num_answers": cfg.data.num_answers,
                   "device": str(device)}, fh, indent=2)

    writer = MetricWriter(cfg.log.log_dir, cfg.log.use_wandb,
                          cfg.log.use_tensorboard, cfg.log.project,
                          config=to_dict(cfg))

    def log_fn(m, s):
        writer.write(m, s)
        logger.info("step %d | %s", s, " ".join(
            f"{k}={v:.4g}" for k, v in m.items() if isinstance(v, float)))

    bs = cfg.train.batch_size
    model = task.build_model()
    trainer = task.build_trainer(model, max(len(train_ds) // bs, 1), log_fn)
    if args.resume:
        if trainer.resume():
            logger.info("resumed from step %d", trainer.state.step)
        else:
            logger.info("no checkpoint found in %s; starting fresh", cfg.train.ckpt_dir)

    def val_batches(clean):
        return (clean(b) for b in batch_iterator(val_ds, bs, shuffle=False,
                                                 drop_last=False))

    def val_clean(b):
        # keep question_id for the best-prediction CSV
        return {k: v for k, v in b.items() if k not in ("answer_cat", "answer_cats")}

    trainer.fit((task.clean_batch(b) for b in batch_iterator(
                    train_ds, bs, seed=cfg.train.seed, epochs=cfg.train.epochs)),
                val_iter_fn=lambda: val_batches(val_clean), max_steps=args.max_steps)
    metrics = trainer.evaluate(val_batches(task.clean_batch))
    logger.info("final val: %s", metrics)
    writer.close()
    return metrics


if __name__ == "__main__":
    main()
