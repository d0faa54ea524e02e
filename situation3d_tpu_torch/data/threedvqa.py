"""3D-VQA data pipeline of the 3D-LLM, host side (port of
``situation3d_tpu/data/threedvqa.py``, numpy).

- a sample: precomputed scene features ``{scene_id}.pt`` [N, 1408] and voxel
  coords ``{scene_id}.npy`` [N, 3], a random subset when a scene has more
  than ``scene_token_capacity`` points, zero padding otherwise;
- questions lower-cased and stripped of punctuation (``clean_question``);
- training pairs: every (question, answer) of the records, flattened and
  batched at a fixed batch size;
- records filtered to scenes whose feature files exist.

``T5TextEncoder`` is the JAX package's hash fallback with T5's pad = 0 and
eos = 1. It has no HF branch: the port's machines have no ``transformers``.
Where no HF T5 tokenizer is cached, both packages take the same branch and
give the same ids. ``stage1_batches`` makes stage-1 pretraining's (scene
features, caption) batches. Draws from ``rng`` follow the reference's order,
so the batches equal its batches bit for bit.
"""
from __future__ import annotations

import os
import re
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from situation3d_tpu_torch.config import Blip2Config
from situation3d_tpu_torch.data.tokenizer import HashTokenizer


_PUNCT_RE = re.compile(r"([.!\"()*#:;~])")


def question_id_int(rec: dict, idx: int) -> int:
    """Deterministic int32 id for a record (Python's ``hash`` is salted per
    process, which would break cross-process prediction/gold matching)."""
    if "question_id_int" in rec:
        return int(rec["question_id_int"])
    return zlib.crc32(str(rec.get("question_id", idx)).encode()) % (1 << 31)


def clean_question(q: str) -> str:
    """BlipQuestionProcessor.pre_question analogue."""
    q = _PUNCT_RE.sub("", q.lower()).replace("-", " ").replace("/", " ")
    return " ".join(q.split())


class T5TextEncoder:
    """T5 tokenization by the hash fallback, with T5's specials."""

    def __init__(self, name: str = "google/flan-t5-xl", vocab_size: int = 32128):
        self.vocab_size = vocab_size
        self._hash = HashTokenizer(vocab_size)

    def encode(self, text: str, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        ids, mask = self._hash.encode(text, max_len)
        # T5 conventions: pad=0, eos=1 — remap the hash tokenizer's specials
        out = np.zeros_like(ids)
        n = int(mask.sum())
        out[: n - 2] = ids[1 : n - 1]  # drop bos, shift
        out[n - 2] = 1  # eos
        m = np.zeros_like(mask)
        m[: n - 1] = 1
        return out, m

    def decode(self, ids) -> str:
        ids = np.asarray(ids).tolist()
        return " ".join(f"tok{i}" for i in ids if i > 1)


class ThreeDVQADataset:
    """(scene features, question, answers) records -> fixed-shape samples."""

    def __init__(self, cfg: Blip2Config, records: List[dict],
                 feature_dir: Optional[str] = None,
                 features: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None,
                 text_encoder: Optional[T5TextEncoder] = None,
                 seed: int = 0):
        self.cfg = cfg
        self.feature_dir = feature_dir
        self.features = features if features is not None else {}
        self.text = text_encoder or T5TextEncoder(
            vocab_size=cfg.t5.vocab_size)
        self.rng = np.random.RandomState(seed)
        if feature_dir:
            records = [r for r in records if self._has_features(r["scene_id"])]
        self.records = records

    def _has_features(self, scene_id: str) -> bool:
        if scene_id in self.features:
            return True
        return os.path.exists(os.path.join(self.feature_dir, f"{scene_id}.pt"))

    def _load_features(self, scene_id: str) -> Tuple[np.ndarray, np.ndarray]:
        if scene_id not in self.features:
            feat = torch.load(os.path.join(self.feature_dir, f"{scene_id}.pt"),
                              map_location="cpu", weights_only=False)
            pc = np.load(os.path.join(self.feature_dir, f"{scene_id}.npy"))
            self.features[scene_id] = (np.asarray(feat, np.float32),
                                       np.asarray(pc))
        return self.features[scene_id]

    def __len__(self) -> int:
        return len(self.records)

    def sample(self, idx: int, answer: Optional[str] = None) -> Dict[str, Any]:
        cfg = self.cfg
        rec = self.records[idx]
        feat, pc = self._load_features(rec["scene_id"])
        cap = cfg.qformer.scene_token_capacity
        n = len(feat)
        if n > cap:
            sel = self.rng.choice(n, cap, replace=False)
            feat, pc = feat[sel], pc[sel]
            n = cap
        out_feat = np.zeros((cap, cfg.pc_feat_dim), np.float32)
        out_pc = np.zeros((cap, 3), np.int32)
        mask = np.zeros(cap, np.int32)
        out_feat[:n] = feat[:n]
        out_pc[:n] = pc[:n]
        mask[:n] = 1

        question = clean_question(rec["question"])
        prompt = cfg.prompt.format(question) if "{}" in cfg.prompt else question
        input_ids, input_mask = self.text.encode(prompt, cfg.max_txt_len)

        item = {
            "pc_feat": out_feat, "pc": out_pc, "pc_mask": mask,
            "input_ids": input_ids, "input_mask": input_mask,
            "question_id": np.int32(question_id_int(rec, idx)),
        }
        if answer is not None:
            labels, lmask = self.text.encode(answer, cfg.t5.max_answer_len)
            item["labels"] = labels.astype(np.int32)
            item["label_mask"] = lmask
        return item

    def train_pairs(self) -> List[Tuple[int, str]]:
        """Flattened (record, answer) pairs — the fixed-shape counterpart of
        the reference's n_answers replication."""
        pairs = []
        for i, rec in enumerate(self.records):
            for a in rec.get("answers", [""]):
                pairs.append((i, a))
        return pairs


def gold_answers(ds: ThreeDVQADataset) -> Tuple[Dict[int, List[str]],
                                                Dict[int, str]]:
    """({qid: gold answers}, {qid: question}) without loading features."""
    golds, questions = {}, {}
    for i, rec in enumerate(ds.records):
        qid = question_id_int(rec, i)
        golds[qid] = rec.get("answers", [])
        questions[qid] = rec.get("question", "")
    return golds, questions


def train_batches(ds: ThreeDVQADataset, batch_size: int, seed: int = 0,
                  epochs: Optional[int] = 1) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.RandomState(seed)
    pairs = ds.train_pairs()
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(pairs))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            samples = [ds.sample(*pairs[j]) for j in order[start:start + batch_size]]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        epoch += 1


def eval_batches(ds: ThreeDVQADataset, batch_size: int
                 ) -> Iterator[Dict[str, np.ndarray]]:
    for start in range(0, len(ds), batch_size):
        idxs = list(range(start, min(start + batch_size, len(ds))))
        valid = np.ones(batch_size, bool)
        if len(idxs) < batch_size:
            valid[len(idxs):] = False
            idxs = idxs + [idxs[-1]] * (batch_size - len(idxs))
        samples = [ds.sample(i) for i in idxs]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        batch["sample_valid"] = valid
        yield batch


def stage1_batches(ds: ThreeDVQADataset, batch_size: int, qcfg,
                   seed: int = 0, epochs: Optional[int] = 1,
                   text_len: int = 32) -> Iterator[Dict[str, np.ndarray]]:
    """Stage-1 pretraining batches of (scene features, caption) pairs for
    ``Blip2Qformer``: the records in a ``RandomState(seed)`` order each
    epoch, the captions the cleaned question texts hash-tokenized into the
    Q-Former's vocabulary less its two top ids (BOS is the last)."""
    tok = HashTokenizer(qcfg.vocab_size - 2)
    rng = np.random.RandomState(seed)
    n = len(ds.records)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            feats, masks, tids, tmask = [], [], [], []
            for i in order[start:start + batch_size]:
                s = ds.sample(int(i))
                feats.append(s["pc_feat"])
                masks.append(s["pc_mask"])
                ids, m = tok.encode(clean_question(ds.records[int(i)]["question"]), text_len)
                tids.append(ids)
                tmask.append(m)
            yield {"image_embeds": np.stack(feats), "image_mask": np.stack(masks),
                   "text_ids": np.stack(tids).astype(np.int32),
                   "text_mask": np.stack(tmask).astype(np.int32)}
        epoch += 1


def synthetic_threedvqa(cfg: Blip2Config, n_scenes: int = 2, per_scene: int = 3,
                        n_points: int = 200, seed: int = 0) -> ThreeDVQADataset:
    """Hermetic synthetic dataset with the real schema."""
    rng = np.random.RandomState(seed)
    feats, records = {}, []
    for s in range(n_scenes):
        sid = f"scene{s:04d}_00"
        feats[sid] = (rng.randn(n_points, cfg.pc_feat_dim).astype(np.float32),
                      rng.randint(0, 128, (n_points, 3)).astype(np.int32))
        for k in range(per_scene):
            records.append({
                "scene_id": sid,
                "question": f"What is object number {k} near the window?",
                "question_id": f"{sid}-q{k}",
                "answers": ["chair", "table"][: 1 + k % 2],
            })
    return ThreeDVQADataset(cfg, records, features=feats, seed=seed)
