"""Task registry: datasets + model + trainer per task (port of the SIG3D part
of ``situation3d_tpu/train/tasks.py``, the LAVIS task layer's replacement).

Registered here: ``sqa3d`` and ``multimodal_classification``. The 3D-LLM
tasks (``3d_vqa``, ``stage1``, ``captioning``, ``retrieval``, ``dialogue``,
``vqa_reading_comprehension``) come with the BLIP-2 + T5 slice of the port;
``setup_task`` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from situation3d_tpu_torch.config import Config
from situation3d_tpu_torch.data.sqa3d import SQA3DDataset
from situation3d_tpu_torch.data.synthetic import make_synthetic_dataset
from situation3d_tpu_torch.data.vocab import build_answer_vocab, load_answer_counter
from situation3d_tpu_torch.models.sig3d import SIG3D, init_random_weights
from situation3d_tpu_torch.train.trainer import Trainer
from situation3d_tpu_torch.utils.registry import registry

BLIP2_TASKS = ("3d_vqa", "stage1", "captioning", "retrieval", "dialogue",
               "vqa_reading_comprehension")
_logger = logging.getLogger("situation3d_tpu_torch")


@registry.register_task("sqa3d")
class SQA3DTask:
    """Situated QA with the SIG3D model (the reference's main stack). The
    model lives on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: Config, synthetic: bool = False, device="cuda"):
        self.cfg = cfg
        self.synthetic = synthetic
        self.device = device

    def build_datasets(self) -> Dict[str, Any]:
        """SQA3D files when ``data.sqa_train`` exists (and ``--synthetic`` is
        not given), else the synthetic datasets (2 scenes x 16 records for
        train, 1 x 8 for val), as the reference falls back."""
        cfg = self.cfg
        if self.synthetic or not os.path.exists(cfg.data.sqa_train):
            _logger.info("datasets: synthetic (%s)", "--synthetic" if self.synthetic
                         else f"no file at data.sqa_train={cfg.data.sqa_train}")
            train = make_synthetic_dataset(cfg, n_scenes=2, per_scene=16)
            val = make_synthetic_dataset(cfg, n_scenes=1, per_scene=8,
                                         split="val", seed=1)
            return {"train": train, "val": val}
        counter = load_answer_counter(cfg.data.answer_counter)
        vocab = build_answer_vocab(counter, cfg.data.answer_min_freq,
                                   cfg.data.num_answers)
        _logger.info("datasets: SQA3D files %s, %s (%d answers)",
                     cfg.data.sqa_train, cfg.data.sqa_val, len(vocab))
        return {split: SQA3DDataset(cfg, split, vocab, counter)
                for split in ("train", "val")}

    def build_model(self, num_answers: Optional[int] = None) -> SIG3D:
        """SIG3D with seeded random weights (``train.seed``)."""
        cfg = self.cfg
        model = SIG3D(cfg, num_answers or cfg.data.num_answers,
                      dtype=torch.bfloat16 if cfg.train.bf16 else torch.float32,
                      device=self.device)
        init_random_weights(model, cfg.train.seed)
        return model

    def build_trainer(self, model: SIG3D, steps_per_epoch: int,
                      log_fn=None) -> Trainer:
        return Trainer(self.cfg, model, steps_per_epoch, log_fn=log_fn)

    def clean_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        drop = {"question_id", "answer_cats", "voxel_labels"}
        if self.cfg.loss.answer_loss != "ce":
            drop.add("answer_cat")  # integer target only needed for CE
        return {k: v for k, v in batch.items() if k not in drop}


@registry.register_task("multimodal_classification")
class MultimodalClassificationTask(SQA3DTask):
    """Closed-vocabulary classification task
    (``lavis/tasks/multimodal_classification.py:20-79``): ``valid_step``
    records {id, prediction, target} from the model's class logits (SIG3D's
    answer head), ``after_evaluation`` deduplicates by instance id and
    reports accuracy as ``agg_metrics``."""

    inst_id_key = "question_id"

    def valid_step(self, model: SIG3D, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None) -> list:
        clean = {k: v for k, v in batch.items()
                 if k not in ("question_id", "answer_cat", "answer_cats",
                              "voxel_labels")}
        model.eval()
        with torch.inference_mode():
            preds = model(clean, generator=generator)["answer_scores"].argmax(-1)
        preds = preds.cpu().numpy()
        targets = np.asarray(batch["answer_cat"]).reshape(-1)
        ids = np.asarray(batch[self.inst_id_key]).reshape(-1)
        return [{self.inst_id_key: i.item() if hasattr(i, "item") else i,
                 "prediction": int(p), "target": int(t)}
                for i, p, t in zip(ids, preds, targets)]

    @staticmethod
    def after_evaluation(results) -> Dict[str, float]:
        seen: Dict[int, Dict] = {}
        for r in results:   # remove_duplicate=inst_id_key (save_result)
            seen.setdefault(r["question_id"], r)
        if not seen:
            return {"agg_metrics": 0.0, "acc": 0.0}
        acc = float(np.mean([r["prediction"] == r["target"]
                             for r in seen.values()]))
        return {"agg_metrics": acc, "acc": acc}


def setup_task(name: str, cfg: Config, **kwargs):
    if name in BLIP2_TASKS:
        raise NotImplementedError(
            f"--task {name} is not ported yet: the 3D-LLM tasks come with the "
            "BLIP-2 + T5 slice of the port")
    return registry.get_task(name)(cfg, **kwargs)
