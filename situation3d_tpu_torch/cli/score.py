"""Standalone score CLI (port of ``situation3d_tpu/cli/score.py``): the
``calculate_scores/calculate_score_*.py`` executables of the reference as
one entry point. Pure Python; it needs no device.

Usage::

  python3 -m situation3d_tpu_torch.cli.score --variant sqa3d \\
      --results outputs/run/results/vqa_result.json \\
      --golds SQA_test.json [--questions questions.json]

  # rank-sharded result dirs ({split}_{epoch}_vqa_result_rank{r}.json,
  # the reference's distributed-eval output, calculate_score_*.py:341-350):
  python3 -m situation3d_tpu_torch.cli.score --variant scanqa \\
      --results outputs/run/result --split test --epoch 3 --golds ...

Variants: ``sqa3d`` (question-type buckets, calculate_score_sqa3d.py),
``scanqa`` (Top1 EM + lemma-unigram F-value, calculate_score_scanqa.py),
``3dllm`` (no lemmatizer, calculate_score_3dllm.py), ``3dmvvqa``
(type-field buckets, calculate_score_3dmvvqa.py).

``--golds`` accepts either ``{question_id: [answers]}`` or the reference
annotation list format (records with ``question_id`` and ``answers`` /
``answer`` fields; questions are picked up for bucketing when present).
Prints the metric dict as JSON on stdout and optionally ``--output``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="situation3d_tpu_torch scorer")
    p.add_argument("--variant",
                   choices=["sqa3d", "scanqa", "3dllm", "3dmvvqa"],
                   default="sqa3d")
    p.add_argument("--results", required=True,
                   help="vqa_result.json, or a directory of per-rank shards")
    p.add_argument("--split", default="test",
                   help="shard prefix split (dir mode)")
    p.add_argument("--epoch", type=int, default=0,
                   help="shard prefix epoch (dir mode)")
    p.add_argument("--golds", required=True,
                   help="gold answers json (mapping or annotation list)")
    p.add_argument("--questions", default=None,
                   help="optional {question_id: question} json for buckets")
    p.add_argument("--all-buckets", action="store_true",
                   help="report the per-type breakdown, not just 'All'")
    p.add_argument("--output", default=None)
    return p.parse_args(argv)


def load_preds(path: str, split: str, epoch: int) -> Dict[str, str]:
    from situation3d_tpu_torch.eval.sqa3d_scoring import merge_rank_results
    if os.path.isdir(path):
        return merge_rank_results(path, split, epoch)
    with open(path) as fh:
        return {str(r["question_id"]): r["answer"] for r in json.load(fh)}


def load_golds(path: str) -> Tuple[Dict[str, List[str]], Dict[str, str],
                                   Dict[str, object]]:
    """Returns (golds, questions, qtypes) from either format."""
    with open(path) as fh:
        data = json.load(fh)
    golds: Dict[str, List[str]] = {}
    questions: Dict[str, str] = {}
    qtypes: Dict[str, object] = {}
    if isinstance(data, dict):
        for k, v in data.items():
            golds[str(k)] = list(v) if isinstance(v, list) else [str(v)]
        return golds, questions, qtypes
    for i, rec in enumerate(data):
        qid = str(rec.get("question_id", i))
        ans = rec.get("answers")
        if ans is None:
            ans = [rec["answer"]] if "answer" in rec else []
        golds[qid] = [a if isinstance(a, str) else a.get("answer", "")
                      for a in ans]
        if "question" in rec:
            questions[qid] = rec["question"]
        if "type" in rec:
            qtypes[qid] = rec["type"]
    return golds, questions, qtypes


def main(argv=None) -> Dict[str, Dict[str, float]]:
    from situation3d_tpu_torch.eval.sqa3d_scoring import (
        SCANQA_BUCKETS, THREEDMVVQA_BUCKETS, score_results,
        score_results_3dllm, score_results_3dmvvqa, score_results_scanqa)
    args = parse_args(argv)
    preds = load_preds(args.results, args.split, args.epoch)
    golds, questions, qtypes = load_golds(args.golds)
    if args.questions:
        with open(args.questions) as fh:
            questions = {str(k): v for k, v in json.load(fh).items()}
    if args.variant == "sqa3d":
        out = score_results(preds, golds, questions)
    elif args.variant == "scanqa":
        out = score_results_scanqa(
            preds, golds, questions,
            buckets=SCANQA_BUCKETS if args.all_buckets else ("All",))
    elif args.variant == "3dllm":
        out = score_results_3dllm(preds, golds)
    else:
        out = score_results_3dmvvqa(
            preds, golds, qtypes,
            buckets=THREEDMVVQA_BUCKETS if args.all_buckets else ("All",))
    text = json.dumps(out, indent=2, sort_keys=True)
    print(text)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text)
    return out


if __name__ == "__main__":
    main()
