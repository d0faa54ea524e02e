"""Training entry point (port of ``situation3d_tpu/cli/train.py``): SIG3D on
SQA3D files (``sqa3d``, ``multimodal_classification``), the 3D-LLM
(``3d_vqa``, ``dialogue``, ``vqa_reading_comprehension``) and its stage-1
Q-Former pretraining (``stage1``).

Usage:
  python3 -m situation3d_tpu_torch.cli.train --task sqa3d \\
      --options data.sqa_train=.../SQA_train.json data.sqa_val=.../SQA_val.json \\
      data.answer_counter=.../answer_counter.json data.scene_dir=... \\
      data.scans_dir=... train.batch_size=8 --max-steps 100
  python3 -m situation3d_tpu_torch.cli.train --task sqa3d --synthetic \\
      --max-steps 5 --options data.num_answers=12 train.batch_size=8
  python3 -m situation3d_tpu_torch.cli.train --task 3d_vqa \\
      --dataset-config 3dvqa.yaml --max-steps 20 --options train.batch_size=4
  python3 -m situation3d_tpu_torch.cli.train --task stage1 \\
      --dataset-config 3dvqa.yaml --max-steps 20 --options train.batch_size=8

SIG3D reads ``SQA_{split}.json`` + OpenScene ``.pth`` scenes through
``data/sqa3d.py``; without a file at ``data.sqa_train``, or with
``--synthetic``, it trains on ``make_synthetic_dataset`` (2 scenes x 16
records, 12 answers), as the reference does, and writes ``answer_vocab.json``
and ``info.json`` under ``--output``. The 3D-LLM reads the records and scene
features a LAVIS-style dataset yaml names (``--dataset-config``, through
``data/builders.py``), else the synthetic 3D-VQA datasets; after training it
evaluates the best checkpoint (``results/vqa_result.json``; ``dialogue``:
the mean loss; ``vqa_reading_comprehension``: beam search and exact match).
Both write ``config.json`` under ``--output``, checkpoints under
``train.ckpt_dir`` (``--resume`` continues from the latest), metrics under
``log.log_dir``. ``stage1`` pretrains ``Blip2Qformer`` (ITC + ITM with hard
negatives + LM) on the same datasets' (scene features, question text)
pairs (``data/threedvqa.py:stage1_batches``), one fresh negative draw a
step, and writes every parameter to ``{output}/stage1_qformer.npz`` keyed by
the reference's tree paths. Runs on the card; ``--device cpu`` asks for the
CPU.

Data parallelism: under ``torchrun`` (which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``) the entry point brings up a process group (NCCL on the card,
gloo with ``--device cpu``) and each rank takes ``cuda:{LOCAL_RANK}``:
  torchrun --nproc-per-node 8 -m situation3d_tpu_torch.cli.train --task 3d_vqa \
      --dataset-config 3dvqa.yaml --options train.batch_size=32
``train.batch_size`` stays the global batch (the number of ranks must
divide it); every rank reads the same global batches and trains on its rows,
and the update equals the one-process update on that global batch. Rank 0
writes the files.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from situation3d_tpu_torch.config import load_config, save_config, to_dict
from situation3d_tpu_torch.data.builders import build_datasets_from_yaml
from situation3d_tpu_torch.data.sqa3d import batch_iterator
from situation3d_tpu_torch.data.threedvqa import (eval_batches, gold_answers,
                                                  stage1_batches, train_batches)
from situation3d_tpu_torch.models.blip2_qformer import Blip2Qformer
from situation3d_tpu_torch.parallel import collectives
from situation3d_tpu_torch.parallel.mesh import (batch_sharding, make_mesh, replicated,
                                                 shard_batch, sharded)
from situation3d_tpu_torch.train.blip2_trainer import Blip2Trainer
from situation3d_tpu_torch.train.checkpoint import save_trainable_npz
from situation3d_tpu_torch.train.logging import MetricWriter
from situation3d_tpu_torch.train.optim import make_optimizer
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
    p.add_argument("--dataset-config", default=None,
                   help="LAVIS-style dataset yaml (datasets: <name>: build_info: "
                        "...) resolved through the builder registry "
                        "(data/builders.py); the 3D-LLM tasks")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in train.ckpt_dir")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--output", default="outputs/run")
    return p.parse_args(argv)


def train_sig3d(args, cfg, task, mesh, logger, log_fn) -> dict:
    """Train SIG3D, then evaluate on the val split; the final metrics."""
    datasets = task.build_datasets()
    train_ds, val_ds = datasets["train"], datasets["val"]
    if len(train_ds.vocab) != cfg.data.num_answers:
        raise ValueError(f"the answer vocabulary has {len(train_ds.vocab)} answers "
                         f"but data.num_answers={cfg.data.num_answers}")
    if mesh.rank == 0:
        # answer_vocab.json / info.json parity (train.py:315-333)
        with open(os.path.join(args.output, "answer_vocab.json"), "w") as fh:
            json.dump(train_ds.vocab.itos_list, fh)
        with open(os.path.join(args.output, "info.json"), "w") as fh:
            json.dump({"task": args.task, "num_train": len(train_ds),
                       "num_val": len(val_ds), "num_answers": cfg.data.num_answers,
                       "device": str(mesh.device)}, fh, indent=2)

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
    return metrics


def _3dvqa_datasets(args, cfg, task) -> dict:
    if args.dataset_config:
        return build_datasets_from_yaml(cfg, args.dataset_config)
    return task.build_datasets()


def train_3dllm(args, cfg, task, mesh, logger, log_fn) -> dict:
    """Train Blip2T5 with validation, then evaluate the best checkpoint.
    Returns ``{"step", "num_train_pairs", "num_val", "final"}``."""
    datasets = _3dvqa_datasets(args, cfg, task)
    ds, val_ds = datasets["train"], datasets["val"]
    bs = cfg.train.batch_size
    model = task.build_model()
    golds, _ = gold_answers(val_ds)
    trainer = Blip2Trainer(cfg, model, steps_per_epoch=max(len(ds.train_pairs()) // bs, 1),
                           log_fn=log_fn, text_decoder=val_ds.text.decode)
    if args.resume and trainer.resume():
        logger.info("resumed from step %d", trainer.state.step)
    trainer.fit(train_batches(ds, bs, seed=cfg.train.seed, epochs=cfg.train.epochs),
                val_iter_fn=lambda: eval_batches(val_ds, bs), golds=golds,
                max_steps=args.max_steps)
    if args.task == "dialogue":
        # loss-based validation (lavis/tasks/dialogue.py:45-64) on label-bearing
        # batches of the val split
        final = task.after_evaluation([task.valid_step(model, b)
                                       for b in train_batches(val_ds, bs, seed=0, epochs=1)])
    elif args.task == "vqa_reading_comprehension":
        results = []
        for b in eval_batches(val_ds, bs):
            results += task.valid_step(model, b, decode_fn=val_ds.text.decode)
        final = task.after_evaluation(results, golds)
    else:
        em, preds = trainer.evaluate(eval_batches(val_ds, bs), golds)
        logger.info("final val EM=%.4f over %d answers (best ckpt)", em, len(preds))
        if mesh.rank == 0:
            results_dir = os.path.join(args.output, "results")
            os.makedirs(results_dir, exist_ok=True)
            with open(os.path.join(results_dir, "vqa_result.json"), "w") as fh:
                json.dump([{"question_id": q, "answer": a} for q, a in preds.items()], fh)
        final = {"EM": em}
    logger.info("final val: %s", final)
    return {"step": trainer.state.step, "num_train_pairs": len(ds.train_pairs()),
            "num_val": len(val_ds), "final": final}


def train_stage1(args, cfg, task, mesh, logger, log_fn) -> dict:
    """Stage-1 pretraining of ``Blip2Qformer`` (ITC + ITM + LM), the
    reference's iteration cadence, then every parameter to
    ``{output}/stage1_qformer.npz``. Returns ``{"step", "num_records",
    "losses" (the last step's, over the global batch), "npz", "tensors"}``.
    On several ranks each trains on its rows; negatives come from the
    global batch, drawn from one generator seeded alike on every rank."""
    ds = _3dvqa_datasets(args, cfg, task)["train"]
    bs, qcfg = cfg.train.batch_size, cfg.blip2.qformer
    model = replicated(Blip2Qformer(qcfg, dtype=torch.float32, device=mesh.device,
                                    seed=cfg.train.seed), mesh)
    optimizer, _ = make_optimizer(cfg.train, model)
    negatives = sharded(torch.Generator(device=mesh.device).manual_seed(cfg.train.seed + 2),
                        mesh)
    axis = mesh.data_axis if mesh.world > 1 else None
    model.train()
    step, out = 0, {}

    def losses():       # the global batch's
        return {k: float(collectives.pmean(v.detach())) for k, v in out.items()}

    for batch in stage1_batches(ds, bs, qcfg, seed=cfg.train.seed, epochs=cfg.train.epochs):
        # one fresh negative draw a step
        out = model(shard_batch(batch, mesh), negatives_axis=axis, generator=negatives)
        optimizer.discard()
        out["loss"].backward()
        collectives.pmean_grads(model.parameters())
        optimizer.step()
        step += 1
        if step % cfg.train.log_every_steps == 0:
            logged = losses()
            if mesh.rank == 0:
                log_fn(logged, step)
        if args.max_steps and step >= args.max_steps:
            break
    path = os.path.join(args.output, "stage1_qformer.npz")
    n = sum(1 for _ in model.parameters())          # what rank 0 writes
    if mesh.rank == 0:
        n = save_trainable_npz(path, model, {name: True for name, _ in model.named_parameters()})
    collectives.barrier()
    logger.info("stage1 done: %d steps, %d tensors saved", step, n)
    return {"step": step, "num_records": len(ds.records), "losses": losses(), "npz": path,
            "tensors": n}


def main(argv=None) -> dict:
    """Train, then evaluate; returns what the task's branch returns."""
    args = parse_args(argv)
    cfg = load_config(args.config, args.options)
    with collectives.launched(args.device):
        mesh = make_mesh(cfg.mesh, args.device)
        batch_sharding(mesh, cfg.train.batch_size)     # the ranks split the global batch
        # stage 1 reads the 3D-VQA datasets, as the reference's entry point does
        task = setup_task("3d_vqa" if args.task == "stage1" else args.task, cfg,
                          synthetic=args.synthetic, device=mesh.device)
        logger = setup_logger()
        set_seed(cfg.train.seed)
        os.makedirs(args.output, exist_ok=True)
        writer = None
        if mesh.rank == 0:
            save_config(cfg, os.path.join(args.output, "config.json"))
            writer = MetricWriter(cfg.log.log_dir, cfg.log.use_wandb,
                                  cfg.log.use_tensorboard, cfg.log.project,
                                  config=to_dict(cfg))

        def log_fn(m, s):
            writer.write(m, s)
            logger.info("step %d | %s", s, " ".join(
                f"{k}={v:.4g}" for k, v in m.items() if isinstance(v, float)))

        try:
            if args.task in ("sqa3d", "multimodal_classification"):
                return train_sig3d(args, cfg, task, mesh, logger, log_fn)
            if args.task == "stage1":
                return train_stage1(args, cfg, task, mesh, logger, log_fn)
            return train_3dllm(args, cfg, task, mesh, logger, log_fn)
        finally:
            if writer is not None:
                writer.close()


if __name__ == "__main__":
    main()
