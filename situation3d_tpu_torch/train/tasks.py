"""Task registry: datasets + model + trainer per task (port of
``situation3d_tpu/train/tasks.py``, the LAVIS task layer's replacement).

Registered here: ``sqa3d`` and ``multimodal_classification`` (SIG3D), the
3D-LLM's ``3d_vqa``, ``captioning``, ``dialogue`` and
``vqa_reading_comprehension`` (Blip2T5), and ``retrieval`` (scene-text
retrieval with the stage-1 ``Blip2Qformer``). Stage-1 pretraining
(``cli.train --task stage1``) reads its datasets through ``3d_vqa``, as the
reference's entry point does.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from situation3d_tpu_torch.config import Config
from situation3d_tpu_torch.data.sqa3d import SQA3DDataset
from situation3d_tpu_torch.data.synthetic import make_synthetic_dataset
from situation3d_tpu_torch.data.threedvqa import ThreeDVQADataset, synthetic_threedvqa
from situation3d_tpu_torch.data.vocab import build_answer_vocab, load_answer_counter
from situation3d_tpu_torch.eval.retrieval import compute_sim_matrix, retrieval_metrics
from situation3d_tpu_torch.eval.scorers import exact_match, score_all
from situation3d_tpu_torch.models.blip2_qformer import Blip2Qformer
from situation3d_tpu_torch.models.blip2_t5 import Blip2T5, generate
from situation3d_tpu_torch.models.sig3d import SIG3D, init_random_weights
from situation3d_tpu_torch.parallel import collectives
from situation3d_tpu_torch.train.trainer import Trainer
from situation3d_tpu_torch.utils.registry import registry

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


@registry.register_task("3d_vqa")
class ThreeDVQATask:
    """Generative 3D QA with Blip2T5 (the reference's 3D-LLM stack). The
    model lives on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, cfg: Config, synthetic: bool = False, device="cuda"):
        self.cfg = cfg
        self.synthetic = synthetic
        self.device = device

    def build_datasets(self, records_path: Optional[str] = None,
                       feature_dir: Optional[str] = None) -> Dict[str, Any]:
        """Records + scene features when ``records_path`` is given (and
        ``--synthetic`` is not), else the synthetic datasets (2 scenes x 8
        records for train, 1 x 4 for val)."""
        if self.synthetic or records_path is None:
            return {"train": synthetic_threedvqa(self.cfg.blip2, 2, 8),
                    "val": synthetic_threedvqa(self.cfg.blip2, 1, 4, seed=1)}
        with open(records_path) as fh:
            records = json.load(fh)
        ds = ThreeDVQADataset(self.cfg.blip2, records, feature_dir=feature_dir)
        return {"train": ds, "val": ds}

    def build_model(self) -> Blip2T5:
        """Blip2T5 built on the task's device with seeded random weights
        (``train.seed``)."""
        cfg = self.cfg
        return Blip2T5(cfg.blip2, dtype=torch.bfloat16 if cfg.train.bf16 else torch.float32,
                       device=self.device, seed=cfg.train.seed)


@registry.register_task("captioning")
class CaptionTask(ThreeDVQATask):
    """Scene captioning with Blip2T5 (``lavis/tasks/captioning.py:17-80``):
    generation without a question prompt, scored by BLEU / ROUGE-L / CIDEr
    (``eval/scorers.score_all``). Caption records use the 3d_vqa schema with
    the caption as the single answer and an empty question; the prompt
    template collapses to ``"{}"``."""

    def __init__(self, cfg: Config, synthetic: bool = False, device="cuda"):
        cfg = dataclasses.replace(cfg, blip2=dataclasses.replace(cfg.blip2, prompt="{}"))
        super().__init__(cfg, synthetic=synthetic, device=device)

    @staticmethod
    def report_metrics(preds: Dict[str, str], golds) -> Dict[str, float]:
        return score_all(preds, golds)


@registry.register_task("retrieval")
class RetrievalTask:
    """Scene-text retrieval with the stage-1 ``Blip2Qformer``: ITC ranking +
    ITM rerank of the top ``k_test`` (``eval/retrieval.py``), recall@k. The
    model lives on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, cfg: Config, synthetic: bool = False, k_test: int = 16,
                 device="cuda"):
        self.cfg = cfg
        self.synthetic = synthetic
        self.k_test = k_test
        self.device = device

    def build_model(self) -> Blip2Qformer:
        """``Blip2Qformer`` on the task's device with seeded random weights
        (``train.seed``)."""
        cfg = self.cfg
        return Blip2Qformer(cfg.blip2.qformer,
                            dtype=torch.bfloat16 if cfg.train.bf16 else torch.float32,
                            device=self.device, seed=cfg.train.seed)

    def evaluation(self, model: Blip2Qformer, image_embeds, image_mask, text_ids,
                   text_mask, img2txt, txt2img) -> Dict[str, float]:
        """Recall@k. Under a process group each rank reranks its rows
        (``compute_sim_matrix``'s ``(rank, world)`` split), the score
        matrices are summed over the ranks (the reference's merge: a row
        outside a rank's range adds a constant, which leaves its ranking
        as it is) and rank 0 computes the metrics; the other ranks return
        ``{}``."""
        rank, world = collectives.rank(), collectives.world()
        i2t, t2i = compute_sim_matrix(model, image_embeds, image_mask, text_ids, text_mask,
                                      k_test=self.k_test, rank=rank, world=world)
        if world > 1:
            i2t, t2i = (collectives.psum(torch.from_numpy(s)).numpy() for s in (i2t, t2i))
        return retrieval_metrics(i2t, t2i, img2txt, txt2img) if rank == 0 else {}


@registry.register_task("dialogue")
class DialogueTask(ThreeDVQATask):
    """Dialogue finetuning (``lavis/tasks/dialogue.py:21-64``): validation is
    loss-based, ``valid_step`` returns the LM loss of a batch and
    ``after_evaluation`` reports the mean as ``agg_metrics``. Dialogue turns
    use the 3d_vqa schema: the history is the question, the reply the
    answer."""

    def valid_step(self, model: Blip2T5, batch: Dict[str, Any]) -> float:
        model.eval()
        with torch.inference_mode():
            return float(model(batch)["loss"])

    @staticmethod
    def after_evaluation(losses) -> Dict[str, float]:
        m = float(np.mean(losses)) if len(losses) else 0.0
        return {"agg_metrics": m, "loss": m}


@registry.register_task("vqa_reading_comprehension")
class VQARCTask(ThreeDVQATask):
    """Reading-comprehension VQA (``lavis/tasks/vqa_reading_comprehension.py``):
    generation with the decoding knobs (num_beams / max_len / min_len /
    top_p / repetition_penalty / nucleus sampling), decoded straight from
    the scene-conditioned encoder, scored by exact match."""

    def __init__(self, cfg: Config, synthetic: bool = False, device="cuda",
                 num_beams: int = 3, max_len: int = 10, min_len: int = 1,
                 top_p: float = 0.9, repetition_penalty: float = 1.0,
                 use_nucleus_sampling: bool = False):
        super().__init__(cfg, synthetic=synthetic, device=device)
        self.num_beams = num_beams
        self.max_len = max_len
        self.min_len = min_len
        self.top_p = top_p
        self.repetition_penalty = repetition_penalty
        self.use_nucleus_sampling = use_nucleus_sampling

    def valid_step(self, model: Blip2T5, batch: Dict[str, Any], decode_fn=None,
                   generator: Optional[torch.Generator] = None) -> list:
        model.eval()
        tokens = generate(model, batch, use_nucleus_sampling=self.use_nucleus_sampling,
                          num_beams=self.num_beams, max_length=self.max_len,
                          min_length=self.min_len, top_p=self.top_p,
                          repetition_penalty=self.repetition_penalty,
                          generator=generator).cpu().numpy()
        decode = decode_fn or (lambda t: " ".join(map(str, t)))
        qids = np.asarray(batch["question_id"]).reshape(-1)
        return [{"question_id": str(q), "answer": decode(list(t))}
                for q, t in zip(qids, tokens)]

    @staticmethod
    def after_evaluation(results, golds: Dict[str, list]) -> Dict[str, float]:
        preds = {str(r["question_id"]): r["answer"] for r in results}
        em = exact_match(preds, {str(k): v for k, v in golds.items()})
        return {"agg_metrics": em, "EM": em}


def setup_task(name: str, cfg: Config, **kwargs):
    return registry.get_task(name)(cfg, **kwargs)
