"""Single-scene inference entry point (port of
``situation3d_tpu/cli/infer.py``, the 3D-LLM's ``inference.py``).

``--task 3d_vqa``: a scene's precomputed features (``--pc-feat`` .pt [N,
1408], ``--pc`` .npy [N, 3]) and a free-form question give a greedy answer
of up to ``blip2.t5.max_answer_len`` tokens; weights from the port's
checkpoint directory, a trainable-only ``.npz`` or a reference torch
checkpoint (``cli/eval.py:restore_blip2_params``). ``--visualize`` renders
a t-SNE embedding of the scene features (it needs ``sklearn``).

``--task sqa3d``: a scene ``.pth``, a situation and a question give
SIG3D's classified answer from the port's checkpoint directory
(``--checkpoint``) and the training run's ``--answer-vocab``.

Prints ``Q: ...`` and ``A: ...``. Runs on the card; ``--device cpu`` asks for
the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from situation3d_tpu_torch.cli.eval import restore_blip2_params
from situation3d_tpu_torch.config import load_config
from situation3d_tpu_torch.data.sqa3d import SQA3DDataset, load_scene
from situation3d_tpu_torch.data.threedvqa import ThreeDVQADataset, clean_question
from situation3d_tpu_torch.data.vocab import AnswerVocab
from situation3d_tpu_torch.device import resolve_device
from situation3d_tpu_torch.eval.visualization import render_topdown, write_png
from situation3d_tpu_torch.models.blip2_t5 import Blip2T5, predict_answers
from situation3d_tpu_torch.models.sig3d import SIG3D
from situation3d_tpu_torch.train.trainer import Trainer
from situation3d_tpu_torch.utils.misc import setup_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="situation3d_tpu_torch inference")
    p.add_argument("--task", choices=["sqa3d", "3d_vqa"], default="3d_vqa")
    p.add_argument("--config", default=None)
    p.add_argument("--options", nargs="*", default=[])
    p.add_argument("--pc-feat", help="scene features .pt (N,1408)")
    p.add_argument("--pc", help="voxel coords .npy (N,3)")
    p.add_argument("--scene", help="scene id for sqa3d mode")
    p.add_argument("--scene-dir", default=None,
                   help="OpenScene .pth scene dir for sqa3d mode")
    p.add_argument("--situation", default="I am standing in the room.")
    p.add_argument("--question", required=False, default="What is in front of me?")
    p.add_argument("--checkpoint", default=None,
                   help="the port's checkpoint directory")
    p.add_argument("--trainable-checkpoint", default=None,
                   help="trainable-only .npz (the 3D-LLM trainer's best model)")
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference-format torch .pth checkpoint")
    p.add_argument("--visualize", action="store_true",
                   help="t-SNE scene-feature embedding render (needs sklearn)")
    p.add_argument("--visualize-out", default="outputs/tsne_pc.png")
    p.add_argument("--visualize-points", type=int, default=2000,
                   help="points subsampled into the t-SNE (the reference uses "
                        "10000; exact t-SNE is quadratic in them)")
    p.add_argument("--answer-vocab", default=None,
                   help="answer_vocab.json from the sqa3d train run")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def tsne_scene_render(feat: np.ndarray, pc: np.ndarray, out_path: str,
                      n_points: int, logger) -> None:
    """t-SNE embedding of the scene features (the reference's
    ``inference.py:80-104``): subsample points, embed the features in 3-d,
    normalize to [0, 1] RGB and render the colored points top-down as a
    PNG."""
    try:
        from sklearn.manifold import TSNE
    except ImportError as e:
        raise RuntimeError("--visualize needs scikit-learn (sklearn), which is not "
                           "installed here") from e
    feat = np.asarray(feat, np.float32).reshape(-1, feat.shape[-1])
    pc = np.asarray(pc, np.float32).reshape(-1, 3)
    rng = np.random.RandomState(0)
    idx = rng.choice(feat.shape[0], min(n_points, feat.shape[0]), replace=False)
    emb = TSNE(n_components=3, random_state=0, learning_rate=200.0,
               init="random").fit_transform(feat[idx])
    emb = (emb - emb.min()) / (emb.max() - emb.min() + 1e-6)
    img = render_topdown(pc[idx], (emb * 255).astype(np.uint8), splat=2)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_png(out_path, img)
    logger.info("t-SNE scene render written to %s", out_path)


def infer_3dllm(args, cfg, device, logger) -> str:
    feat = np.asarray(torch.load(args.pc_feat, map_location="cpu", weights_only=False),
                      np.float32)
    pc = np.load(args.pc)
    ds = ThreeDVQADataset(cfg.blip2, [{"scene_id": "scene", "question": args.question,
                                       "question_id": "scene-q0", "answers": []}],
                          features={"scene": (feat, pc)})
    # float32 compute, as the reference's inference; the seed of training, so a
    # trainable-only checkpoint lands on the same frozen T5
    model = Blip2T5(cfg.blip2, device=device, seed=cfg.train.seed)
    restore_blip2_params(cfg, model, args, logger)
    batch = {k: np.asarray(v)[None] for k, v in ds.sample(0).items() if k != "question_id"}
    tokens = predict_answers(model, batch, max_len=cfg.blip2.t5.max_answer_len)
    answer = ds.text.decode(tokens[0].cpu().numpy())
    print("Q:", clean_question(args.question))
    print("A:", answer)
    if args.visualize:
        tsne_scene_render(feat, pc, args.visualize_out, args.visualize_points, logger)
    return answer


def infer_sqa3d(args, cfg, device, logger) -> str:
    if not args.checkpoint or not args.answer_vocab:
        raise ValueError("sqa3d inference needs --checkpoint and --answer-vocab")
    with open(args.answer_vocab) as fh:
        vocab = AnswerVocab(json.load(fh))
    scene = load_scene(args.scene_dir or cfg.data.scene_dir, None, args.scene)
    # identity pose: the situation comes from the text alone
    rec = {"scene_id": args.scene, "situation": args.situation,
           "question": args.question, "question_id": 0,
           "position": [0, 0, 0, 0, 0, 0, 1], "answers": []}
    ds = SQA3DDataset(cfg, "val", vocab, records=[rec], scenes={args.scene: scene})
    batch = {k: np.asarray(v)[None] for k, v in ds[0].items()
             if k not in ("question_id", "answer_cat", "answer_cats")}
    model = SIG3D(cfg, num_answers=len(vocab),
                  dtype=torch.bfloat16 if cfg.train.bf16 else torch.float32, device=device)
    cfg_ckpt = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ckpt_dir=args.checkpoint))
    trainer = Trainer(cfg_ckpt, model, steps_per_epoch=1)
    if not trainer.resume():
        raise FileNotFoundError(f"no checkpoint in {args.checkpoint}")
    logger.info("restored checkpoint step %d", trainer.state.step)
    _, keep = trainer.eval_step(batch, torch.Generator(device=device).manual_seed(0))
    answer = vocab.itos(int(keep["answer_scores"].argmax(-1)[0]))
    print("Q:", args.question)
    print("A:", answer)
    return answer


def main(argv=None) -> str:
    """Prints the question and the answer; returns the answer."""
    args = parse_args(argv)
    logger = setup_logger()
    cfg = load_config(args.config, args.options)
    device = resolve_device(args.device)
    if args.task == "3d_vqa":
        return infer_3dllm(args, cfg, device, logger)
    return infer_sqa3d(args, cfg, device, logger)


if __name__ == "__main__":
    main()
