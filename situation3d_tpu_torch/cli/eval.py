"""Evaluation entry point (port of the SIG3D part of
``situation3d_tpu/cli/eval.py``, which replaces ``situation3d/eval/eval.py``):
SQA3D QA accuracy and situation metrics, optionally through the scene cache,
3D semantic-segmentation mIoU through the whole UNet, and visualization
export.

Usage:
  python3 -m situation3d_tpu_torch.cli.eval --task sqa3d --checkpoint latest \\
      --options <the training run's options> [--scene-cache] \\
      [--segmentation [--text-features feats.npy]] [--visualize]

``--checkpoint`` restores the latest step of ``train.ckpt_dir``, as the
reference does: the flag's value is not read. Writes ``metrics.json`` (and
with ``--visualize`` PLY / OBJ / PNG files) under ``--output``. Runs on the
card; ``--device cpu`` asks for the CPU. ``--task 3d_vqa`` comes with the
BLIP-2 slice of the port and raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from situation3d_tpu_torch.config import load_config
from situation3d_tpu_torch.data.sqa3d import SQA3DDataset, batch_iterator
from situation3d_tpu_torch.data.synthetic import make_synthetic_dataset
from situation3d_tpu_torch.device import resolve_device
from situation3d_tpu_torch.eval.segmentation import (confusion_matrix,
                                                     miou_from_confusion)
from situation3d_tpu_torch.eval.serving import SceneCache
from situation3d_tpu_torch.eval.visualization import (export_scene_visualization,
                                                      render_topdown)
from situation3d_tpu_torch.models.sig3d import SIG3D, init_random_weights
from situation3d_tpu_torch.train.logging import MetricWriter
from situation3d_tpu_torch.train.metrics import answer_metrics
from situation3d_tpu_torch.train.tasks import setup_task
from situation3d_tpu_torch.utils.misc import set_seed, setup_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="situation3d_tpu_torch evaluator")
    p.add_argument("--task", choices=["sqa3d", "3d_vqa"], default="sqa3d")
    p.add_argument("--config", default=None)
    p.add_argument("--options", nargs="*", default=[])
    p.add_argument("--checkpoint", default=None,
                   help="restore the latest checkpoint of train.ckpt_dir "
                        "(the value itself is not read, as in the reference)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--split", default="val")
    p.add_argument("--output", default="outputs/eval")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--scene-cache", action="store_true",
                   help="evaluate with per-scene encoding reuse "
                        "(eval/serving.py): the scene tower runs once per "
                        "scene instead of once per question")
    p.add_argument("--visualize", action="store_true",
                   help="export PLY/OBJ/PNG scene visualizations")
    p.add_argument("--segmentation", action="store_true",
                   help="also run 3D semantic-segmentation mIoU through the "
                        "whole UNet (eval.py:234-332)")
    p.add_argument("--text-features", default=None,
                   help=".npy [num_classes, 768] CLIP text features for the "
                        "segmentation head (random unit vectors if absent)")
    return p.parse_args(argv)


def run_segmentation_eval(cfg, trained_model, seg_ds, batch_size, text_features,
                          num_answers, seed=0, device="cuda"):
    """Segmentation mIoU through the whole UNet: a SIG3D with
    ``sparse.final_result`` (fresh weights give the decoder's tail), the
    trained weights laid over it, then ``openscene_out @ text_features.T``
    against the per-voxel labels (eval.py:293-297, 324-332)."""
    cfg = dataclasses.replace(
        cfg, sparse=dataclasses.replace(cfg.sparse, final_result=True))
    model = SIG3D(cfg, num_answers,
                  dtype=torch.bfloat16 if cfg.train.bf16 else torch.float32,
                  device=device)
    init_random_weights(model, seed)
    if trained_model is not None:   # the reference's strict=False load (eval.py:220-231)
        model.load_state_dict(trained_model.state_dict(), strict=False)
    tf = torch.as_tensor(np.asarray(text_features), dtype=torch.float32,
                         device=model.device)
    num_classes = tf.shape[0]
    conf = np.zeros((num_classes, num_classes), np.int64)
    gen = torch.Generator(device=model.device).manual_seed(seed + 2)
    drop = ("question_id", "answer_cat", "answer_cats", "voxel_labels", "sample_valid")
    with torch.inference_mode():
        for b in batch_iterator(seg_ds, batch_size, shuffle=False, drop_last=False):
            out = model({k: v for k, v in b.items() if k not in drop}, generator=gen)
            pred = (out["openscene_out"].float() @ tf.T).argmax(-1).cpu().numpy()
            sel = np.asarray(b["voxel_mask"]) & np.asarray(b["sample_valid"])[:, None]
            conf += confusion_matrix(pred[sel], np.asarray(b["voxel_labels"])[sel],
                                     num_classes)
    miou, ious = miou_from_confusion(conf)
    acc = float(np.diag(conf).sum() / max(conf.sum(), 1))
    out = {"seg_mIoU": miou, "seg_accuracy": acc}
    out.update({f"seg_iou/{i}": float(v) for i, v in enumerate(ious)})
    return out


def run_cached_eval(cfg, ds, trainer, logger):
    """Scene-grouped QA eval through ``eval/serving.SceneCache``: one scene
    tower pass per scene, every question answered against the cached
    tokens. Returns the answer metrics of ``train/metrics.answer_metrics``
    (breakdown entries as (correct, count) sums)."""
    model = trainer.model
    model.eval()
    cache = SceneCache(model, device=model.device)
    groups: dict = {}
    for i, rec in enumerate(ds.records):
        groups.setdefault(rec["scene_id"], []).append(i)

    Bq = cfg.eval.batch_size
    q_keys = ("s_ids", "s_mask", "q_ids", "q_mask", "auxiliary_task")
    sums: dict = {}
    total = 0
    gen = torch.Generator(device=model.device).manual_seed(cfg.train.seed)
    for sid, idxs in groups.items():
        samples = [ds[i] for i in idxs]
        scene_batch = {k: np.asarray(v)[None] for k, v in samples[0].items()
                       if k not in ("question_id", "answer_cats")}
        cache.encode(sid, scene_batch, generator=gen)
        for s0 in range(0, len(samples), Bq):
            chunk = samples[s0: s0 + Bq]
            nvalid = len(chunk)
            chunk = chunk + [chunk[-1]] * (Bq - nvalid)
            qb = {k: np.stack([s[k] for s in chunk]) for k in q_keys}
            out = cache.answer(sid, qb)
            dev = out["answer_scores"].device
            m = answer_metrics(
                out["answer_scores"],
                torch.as_tensor(np.stack([s["answer_cat_scores"] for s in chunk]), device=dev),
                torch.as_tensor(np.stack([s["question_type"] for s in chunk]), device=dev),
                valid=torch.as_tensor(np.arange(Bq) < nvalid, device=dev))
            for mk, mv in m.items():
                v = mv.double().cpu().numpy()
                # acc_* are per-batch means (weight by nvalid); breakdown
                # entries are (correct, count) sums: add them directly
                sums[mk] = sums.get(mk, 0.0) + (v * nvalid if v.ndim == 0 else v)
            total += nvalid
    logger.info("scene-cache eval: %d questions over %d scenes", total, len(groups))
    return {mk: (v / max(total, 1)).tolist() if np.ndim(v) == 0 else v.tolist()
            for mk, v in sums.items()}


def visualize(cfg, task, ds, trainer, output, logger) -> None:
    """The first batch's scenes with their GT and predicted situations
    (eval.py:302-314): PLY points, OBJ arrows and a top-down PNG each, and
    the PNG logged through ``MetricWriter.write_image``."""
    batch = task.clean_batch(next(batch_iterator(ds, cfg.eval.batch_size,
                                                 shuffle=False)))
    gen = torch.Generator(device=trainer.model.device).manual_seed(0)
    _, keep = trainer.eval_step(batch, gen)
    aux = keep["aux_scores"].float().cpu().numpy()
    writer = MetricWriter(output, cfg.log.use_wandb, cfg.log.use_tensorboard,
                          cfg.log.project)
    for i in range(min(4, len(aux))):
        m = np.asarray(batch["voxel_mask"][i]).astype(bool)
        pts = np.asarray(batch["voxel_coords"][i], np.float32)[m] * cfg.data.voxel_size
        gt = np.asarray(batch["auxiliary_task"][i])
        pred = aux[i] if aux.ndim == 2 else None
        export_scene_visualization(output, f"scene{i}", pts, gt_pose=gt, pred_pose=pred)
        writer.write_image(f"eval/scene{i}", render_topdown(pts, gt_pose=gt, pred_pose=pred),
                           step=trainer.state.step)
    writer.close()
    logger.info("visualizations written to %s", output)


def main(argv=None) -> dict:
    """Returns ``{"step": restored step, "metrics": ..., "num_questions": ...,
    "eval_seconds": ...}`` (the QA evaluation alone, host clock)."""
    args = parse_args(argv)
    cfg = load_config(args.config, args.options)
    task = setup_task(args.task, cfg, synthetic=args.synthetic, device=args.device)
    device = resolve_device(args.device)
    logger = setup_logger()
    set_seed(cfg.train.seed)
    os.makedirs(args.output, exist_ok=True)
    datasets = task.build_datasets()
    ds = datasets.get(args.split, datasets["val"])

    trainer = task.build_trainer(task.build_model(), steps_per_epoch=1)
    if args.checkpoint:
        if trainer.resume():
            logger.info("restored checkpoint step %d", trainer.state.step)
        else:
            logger.warning("no checkpoint in %s: evaluating random weights",
                           cfg.train.ckpt_dir)
    t0 = time.perf_counter()
    if args.scene_cache:
        metrics = run_cached_eval(cfg, ds, trainer, logger)
        # breakdown (correct, count) sums -> accuracies, as Trainer.evaluate gives
        metrics = {k: v[0] / max(v[1], 1.0) if isinstance(v, list) else v
                   for k, v in metrics.items()}
    else:
        metrics = trainer.evaluate(
            task.clean_batch(b) for b in batch_iterator(
                ds, cfg.eval.batch_size, shuffle=False, drop_last=False))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    eval_seconds = time.perf_counter() - t0
    logger.info("eval[%s]: %d questions in %.3f s: %s", args.split, len(ds),
                eval_seconds, metrics)
    if args.visualize:
        visualize(cfg, task, ds, trainer, args.output, logger)
    if args.segmentation:
        if args.synthetic:
            seg_ds = make_synthetic_dataset(cfg, 1, 4, split="val", seed=1,
                                            include_labels=True)
        else:
            seg_ds = SQA3DDataset(cfg, args.split, ds.vocab, ds.answer_counter,
                                  include_labels=True)
        if args.text_features:
            tf = np.load(args.text_features)
        else:
            logger.warning("no --text-features: using random unit vectors")
            r = np.random.RandomState(0).randn(20, cfg.sparse.out_channels)
            tf = r / np.linalg.norm(r, axis=1, keepdims=True)
        seg = run_segmentation_eval(cfg, trainer.model, seg_ds, cfg.eval.batch_size,
                                    tf, num_answers=len(ds.vocab), device=device)
        logger.info("segmentation: mIoU=%.4f acc=%.4f", seg["seg_mIoU"],
                    seg["seg_accuracy"])
        metrics.update(seg)
    with open(os.path.join(args.output, "metrics.json"), "w") as fh:
        json.dump({k: float(v) for k, v in metrics.items()}, fh, indent=2)
    return {"step": trainer.state.step, "metrics": metrics,
            "num_questions": len(ds), "eval_seconds": eval_seconds}


if __name__ == "__main__":
    main()
