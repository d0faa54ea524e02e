"""SQA3D/ScanQA offline scoring flow (the port's own copy of
``situation3d_tpu/eval/sqa3d_scoring.py``).

Re-implements the result-JSON scoring flow of
``3DLLM_BLIP2-base/calculate_scores/calculate_score_sqa3d.py``:
``<pad>``/``</s>``/comma stripping (``:358-359``), question-type buckets
All/What/How/Can/Is/Which/Other (``:307-320``), EM + caption metrics per
bucket.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from situation3d_tpu_torch.eval.scorers import score_all

BUCKETS = ("All", "What", "How", "Can", "Is", "Which", "Other")


def clean_answer(ans: str) -> str:
    """Strip generation artifacts (calculate_score_sqa3d.py:358-359)."""
    return (ans.replace("<pad>", "").replace("</s>", "").replace(",", "")
            .strip().lower())


def bucket_of(question: str) -> str:
    first = question.split()[0].lower() if question.split() else ""
    table = {"what": "What", "how": "How", "can": "Can", "is": "Is",
             "which": "Which"}
    return table.get(first, "Other")


def clean_answer_scanqa(ans: str) -> str:
    """ScanQA variant (calculate_score_scanqa.py:364-365): strip comma /
    ``<pad>`` / ``</s>``, then keep only the first line. No lowercasing —
    the ScanQA script compares the raw cleaned strings."""
    ans = (ans.replace(",", "").replace("<pad>", "").replace("</s>", "")
           .strip())
    return ans.strip().split("\n")[0]


_LEMMA_SUFFIXES = ("ies", "es", "s")


def _lemma(token: str) -> str:
    """Light noun lemmatizer standing in for WordNetLemmatizer
    (calculate_score_scanqa.py:25-26; nltk WordNet data is unavailable
    offline — documented deviation, identical on regular plurals)."""
    if token.endswith("ies") and len(token) > 4:
        return token[:-3] + "y"
    for suf in ("sses", "shes", "ches", "xes", "zes"):
        if token.endswith(suf):
            return token[:-2]
    if token.endswith("s") and not token.endswith("ss") and len(token) > 3:
        return token[:-1]
    return token


def unigram_f_value(ref: str, pred: str, lemmatize: bool = True) -> float:
    """Lemma-unigram F1 (tokens_unigram_f_value,
    calculate_score_scanqa.py:231-236): precision = fraction of pred tokens
    found in ref, recall = fraction of ref tokens found in pred.
    ``lemmatize=False`` compares raw tokens (the 3dllm variant comments the
    lemmatizer out, calculate_score_3dllm.py:25-26)."""
    lem = _lemma if lemmatize else (lambda t: t)
    ref_l = [lem(t) for t in ref.split()]
    pred_l = [lem(t) for t in pred.split()]
    if not ref_l or not pred_l:
        return 0.0
    precision = sum(1 for t in pred_l if t in ref_l) / len(pred_l)
    recall = sum(1 for t in ref_l if t in pred_l) / len(ref_l)
    if precision + recall == 0.0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def scanqa_bucket_of(question: str) -> str:
    """qclass1 (calculate_score_scanqa.py:307-326): substring probes in
    order; Shape/Type/Kind all fold into 'Object nature'."""
    if "Where" in question:
        return "Place"
    if "How many" in question:
        return "Number"
    if "What color" in question or "What is the color" in question:
        return "Color"
    if ("What shape" in question or "What type" in question
            or "What kind" in question):
        return "Object nature"
    if "What is" in question:
        return "Object"
    return "Other"


SCANQA_BUCKETS = ("All", "Place", "Number", "Color", "Object nature",
                  "Object", "Other")


def merge_rank_results(result_dir: str, split: str, epoch: int
                       ) -> Dict[str, str]:
    """Merge per-rank prediction shards
    ``{split}_{epoch}_vqa_result_rank{r}.json`` in numeric rank order
    (calculate_score_scanqa.py:341-350) into {question_id: answer}."""
    import json
    import os
    import re

    prefix = f"{split}_{epoch}_vqa_result_rank"
    files = [f for f in os.listdir(result_dir)
             if f.startswith(prefix) and f.endswith(".json")]
    files.sort(key=lambda f: (int(re.sub(r"\D", "", f[len(prefix):]) or 0), f))
    preds: Dict[str, str] = {}
    for f in files:
        with open(os.path.join(result_dir, f)) as fh:
            for rec in json.load(fh):
                preds[str(rec["question_id"])] = rec["answer"]
    return preds


def score_results_scanqa(
    preds: Dict[str, str],
    golds: Dict[str, List[str]],
    questions: Optional[Dict[str, str]] = None,
    buckets: Tuple[str, ...] = ("All",),
    bucket_fn=None,
    lemmatize: bool = True,
) -> Dict[str, Dict[str, float]]:
    """ScanQA scoring (calculate_score_scanqa.py:243-305,378-385): per
    bucket, ``Top1 (EM)`` (×100) + ``Top1 (F-value)`` lemma-unigram F1 +
    the pycoco caption metrics. The reference main() scores the 'All'
    bucket only (QT=['All'], :306); pass ``buckets=SCANQA_BUCKETS`` for
    the per-type breakdown. The sibling score scripts differ only in the
    bucket function and data paths: pass ``bucket_fn`` to override (see
    :func:`score_results_3dmvvqa`, :func:`score_results_3dllm`)."""
    bucket_fn = bucket_fn or scanqa_bucket_of
    preds = {k: clean_answer_scanqa(v) for k, v in preds.items()}
    golds = {k: [clean_answer_scanqa(g) for g in v]
             for k, v in golds.items()}
    out: Dict[str, Dict[str, float]] = {}
    for bucket in buckets:
        if bucket == "All":
            keys = list(preds)
        else:
            keys = [k for k in preds
                    if bucket_fn((questions or {}).get(k, ""))
                    == bucket]
        if not keys:
            continue
        p = {k: preds[k] for k in keys}
        g = {k: golds.get(k, []) for k in keys}
        metrics = score_all(p, g)
        # reference reports percentages and its own EM key names
        metrics = {k: v for k, v in metrics.items()}
        metrics["Top1 (EM)"] = 100.0 * metrics.pop("EM", 0.0)
        metrics["Top1 (F-value)"] = 100.0 * float(np.mean(
            [max([unigram_f_value(r, p[k], lemmatize) for r in g[k]]
                 or [0.0]) for k in keys]))
        out[bucket] = metrics
        out[bucket]["count"] = len(keys)
    return out


THREEDMVVQA_BUCKETS = ("All", "0", "1", "2", "3")


def score_results_3dmvvqa(
    preds: Dict[str, str],
    golds: Dict[str, List[str]],
    qtypes: Optional[Dict[str, object]] = None,
    buckets: Tuple[str, ...] = THREEDMVVQA_BUCKETS,
) -> Dict[str, Dict[str, float]]:
    """3DMV-VQA scoring (calculate_score_3dmvvqa.py:306-308,354-370): same
    metric pipeline as ScanQA, but bucketed by the record's integer
    ``type`` field (QT=['All','0','1','2','3']) instead of question-text
    probes. ``qtypes``: {question_id: type} (int or str)."""
    qstr = {k: str(v) for k, v in (qtypes or {}).items()}
    return score_results_scanqa(preds, golds, questions=qstr,
                                buckets=buckets, bucket_fn=lambda t: t)


def score_results_3dllm(
    preds: Dict[str, str],
    golds: Dict[str, List[str]],
) -> Dict[str, Dict[str, float]]:
    """3DLLM pretraining-eval scoring (calculate_score_3dllm.py): the
    ScanQA pipeline with the lemmatizer disabled (the reference comments
    out nltk, :8-9,25-26) and the 'All' bucket only."""
    return score_results_scanqa(preds, golds, buckets=("All",),
                                lemmatize=False)


def score_results(
    preds: Dict[str, str],
    golds: Dict[str, List[str]],
    questions: Dict[str, str],
) -> Dict[str, Dict[str, float]]:
    """Per-bucket metric dict: {bucket: {EM, BLEU-1..4, METEOR, ROUGE-L, CIDEr}}."""
    preds = {k: clean_answer(v) for k, v in preds.items()}
    golds = {k: [clean_answer(g) for g in v] for k, v in golds.items()}
    out: Dict[str, Dict[str, float]] = {}
    for bucket in BUCKETS:
        if bucket == "All":
            keys = list(preds)
        else:
            keys = [k for k in preds
                    if bucket_of(questions.get(k, "")) == bucket]
        if not keys:
            continue
        p = {k: preds[k] for k in keys}
        g = {k: golds.get(k, []) for k in keys}
        out[bucket] = score_all(p, g)
        out[bucket]["count"] = len(keys)
    return out
