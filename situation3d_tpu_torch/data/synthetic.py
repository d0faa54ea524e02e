"""The pinned synthetic scene batch used to exercise and time the SIG3D
forward and training step: random points in an 8 x 6 x 3 m box voxelized at
the configured voxel size, random colors, fixed-length random token ids, one
random answer per sample. Made with numpy from the caller's ``RandomState``
(the forward's fields are the same draws, in the same order, as the reference
benchmark's batch; the training targets are drawn after them) and moved to
``device``."""
from __future__ import annotations

import numpy as np
import torch

from situation3d_tpu_torch.device import resolve_device


def make_scene_batch(cfg, B: int, rng: np.random.RandomState, device="cuda"):
    """Returns ``(batch dict of tensors on device, coords ndarray, mask ndarray)``."""
    dev = resolve_device(device)
    cap = cfg.sparse.capacities[0]
    L = cfg.data.max_text_len
    coords = np.zeros((B, cap, 3), np.int32)
    mask = np.zeros((B, cap), bool)
    feats = np.zeros((B, cap, 3), np.float32)
    for b in range(B):
        pts = (rng.rand(50000, 3) * np.array([8.0, 6.0, 3.0])) / cfg.data.voxel_size
        c = np.unique(np.floor(pts).astype(np.int32), axis=0)[:cap]
        coords[b, : len(c)], mask[b, : len(c)] = c, True
        feats[b, : len(c)] = rng.rand(len(c), 3) * 255
    sm = np.zeros((B, L), np.int32); sm[:, :60] = 1
    qm = np.zeros((B, L), np.int32); qm[:, :20] = 1
    A = cfg.data.num_answers
    top = min(30000, cfg.lang.vocab_size)       # 30000 at the default vocabulary
    cats = np.eye(A, dtype=np.float32)[rng.randint(0, A, B)]
    batch = {
        "s_ids": rng.randint(4, top, (B, L)).astype(np.int32),
        "s_mask": sm,
        "q_ids": rng.randint(4, top, (B, L)).astype(np.int32),
        "q_mask": qm,
        "voxel_coords": coords,
        "voxel_feats": feats,
        "voxel_mask": mask,
        "auxiliary_task": np.concatenate(
            [rng.rand(B, 3) * 4, np.tile([0, 0, 0, 1.0], (B, 1))], 1
        ).astype(np.float32),
        "answer_cat_scores": cats,
        # training / evaluation targets
        "answer_cat": cats.argmax(1).astype(np.int32),
        "question_type": rng.randint(0, 9, B).astype(np.int32),
        "sample_valid": np.ones(B, bool),
    }
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}, coords, mask


def synthetic_batches(cfg, B: int, steps: int, seed: int = 0, device="cuda"):
    """``steps`` training batches: two different scene batches made from
    ``seed`` and cycled (making a full-width batch on the host takes longer
    than a step on the card)."""
    pool = [make_scene_batch(cfg, B, np.random.RandomState(seed + i), device)[0]
            for i in range(max(1, min(2, steps)))]
    for i in range(steps):
        yield pool[i % len(pool)]
