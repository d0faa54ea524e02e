"""The general generator of the benchmark's inputs, read from a traffic
mix's parameters and the run's seed.

Rooms are a frozen copy of the geometry of ``make_detection_arrays``
(``situation3d_tpu_torch/data/synthetic.py``), as ``chip_smoke.py`` writes
its SQA3D rooms: a floor (35% of the points), four walls (30%) and 4-10
boxes standing on the floor (the rest, on their top and side faces), drawn
here with a generator on the card for all rooms at once. Points are voxelized
as the data pipeline does (``floor(p / voxel) - min``, one voxel a cell, its
colour from the cell's first point), and a room with more voxels than the
level-0 capacity keeps a random subset of that many, in random order.

Situation and question texts are token ids of MPNet's conventions (``<s>``
0, pad 1, ``</s>`` 2, words from 4 up), their word counts drawn from each
mix's ranges; the 3D-LLM's prompts are T5 ids (pad 0, ``</s>`` 1) of the
template's words around the question's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmarks.reference.weights import sub_seed


def make_rooms(n: int, points: int, room: Sequence[float], boxes: Sequence[int],
               gen: torch.Generator) -> torch.Tensor:
    """float32 [n, points, 3] point clouds, metres, one corner at the origin."""
    dev = gen.device
    rx, ry, rz = (float(v) for v in room)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    n_floor, n_wall = int(0.35 * points), int(0.30 * points)
    n_obj = points - n_floor - n_wall
    kmax = int(boxes[1])
    k = torch.randint(int(boxes[0]), kmax + 1, (n, 1), generator=gen, device=dev)
    size = torch.stack([(0.10 + 0.15 * u(n, kmax)) * min(rx, ry),
                        (0.10 + 0.15 * u(n, kmax)) * min(rx, ry),
                        (0.15 + 0.35 * u(n, kmax)) * rz], -1)
    centre = torch.stack([size[..., 0] / 2 + u(n, kmax) * (rx - size[..., 0]),
                          size[..., 1] / 2 + u(n, kmax) * (ry - size[..., 1]),
                          size[..., 2] / 2], -1)
    floor = torch.stack([u(n, n_floor) * rx, u(n, n_floor) * ry,
                         torch.zeros(n, n_floor, device=dev)], -1)
    along = u(n, n_wall)
    wall = torch.randint(0, 4, (n, n_wall), generator=gen, device=dev)
    wx = torch.where(wall < 2, along * rx, (wall == 3).float() * rx)
    wy = torch.where(wall < 2, (wall == 1).float() * ry, along * ry)
    walls = torch.stack([wx, wy, u(n, n_wall) * rz], -1)
    owner = (u(n, n_obj) * k).long().clamp(max=kmax - 1)
    face = torch.randint(0, 5, (n, n_obj), generator=gen, device=dev)
    off = u(n, n_obj, 3) - 0.5
    axis = torch.clamp(face // 2, max=2)
    side = torch.where(face % 2 == 0, 0.5, -0.5)
    side = torch.where(face == 4, 0.5, side)
    off.scatter_(2, axis[..., None], side[..., None])
    idx = owner[..., None].expand(-1, -1, 3)
    on_box = torch.gather(centre, 1, idx) + off * torch.gather(size, 1, idx)
    return torch.cat([floor, walls, on_box], 1)


def voxelize_rooms(pts: torch.Tensor, voxel: float, capacity: int, gen: torch.Generator):
    """(coords int32 [n, capacity, 3], feats float32 [n, capacity, 3] colours
    in [-1, 1), mask bool [n, capacity], voxels a room before the cut)."""
    n, P, _ = pts.shape
    dev = pts.device
    colours = torch.rand((n, P, 3), generator=gen, device=dev) * 2 - 1
    c = torch.floor(pts / voxel).long()
    c = c - c.min(1, keepdim=True).values
    key = ((torch.arange(n, device=dev)[:, None] * 4096 + c[..., 0]) * 4096 + c[..., 1]) * 4096 + c[..., 2]
    uk, inv = torch.unique(key.reshape(-1), return_inverse=True)
    first = torch.full((len(uk),), n * P, device=dev, dtype=torch.long).scatter_reduce(
        0, inv, torch.arange(n * P, device=dev), "amin")
    room = uk // 4096 ** 3
    counts = torch.bincount(room, minlength=n)
    # a random subset of each room's voxels, in random order
    order = torch.argsort(room.double() + torch.rand(len(uk), generator=gen, device=dev,
                                                     dtype=torch.float64))
    rank = torch.arange(len(uk), device=dev) - (torch.cumsum(counts, 0) - counts)[room[order]]
    keep = rank < capacity
    sel, slot = order[keep], rank[keep]
    coords = torch.zeros(n, capacity, 3, dtype=torch.int32, device=dev)
    feats = torch.zeros(n, capacity, 3, device=dev)
    mask = torch.zeros(n, capacity, dtype=torch.bool, device=dev)
    m = 4095
    xyz = torch.stack([(uk[sel] // 4096 ** 2) % 4096, (uk[sel] // 4096) % 4096, uk[sel] & m], -1)
    coords[room[sel], slot] = xyz.to(torch.int32)
    feats[room[sel], slot] = colours.reshape(-1, 3)[first[sel]]
    mask[room[sel], slot] = True
    return coords, feats, mask, counts


def text_ids(rng: np.random.Generator, n: int, words: Sequence[int], max_len: int,
             vocab: int) -> Dict[str, np.ndarray]:
    """MPNet ids: ``<s>`` + ``words[0]..words[1]`` word ids + ``</s>``, padded."""
    ids = np.ones((n, max_len), np.int32)
    mask = np.zeros((n, max_len), np.int32)
    lengths = rng.integers(int(words[0]), int(words[1]) + 1, n)
    for i, w in enumerate(np.minimum(lengths, max_len - 2)):
        ids[i, 0], ids[i, w + 1] = 0, 2
        ids[i, 1:w + 1] = rng.integers(4, vocab, w)
        mask[i, :w + 2] = 1
    return {"ids": ids, "mask": mask}


def questions(seed: int, stream: int, n: int, mix: dict, s: dict) -> Dict[str, np.ndarray]:
    """``n`` SQA3D-like samples' text, answers and situations in the host
    format of ``data/sqa3d.py:batch_iterator`` (the voxel fields apart)."""
    rng = np.random.default_rng(sub_seed(seed, stream))
    L, A, V = s["data.max_text_len"], s["data.num_answers"], s["lang.vocab_size"]
    sit = text_ids(rng, n, mix["situation_words"], L, V)
    que = text_ids(rng, n, mix["question_words"], L, V)
    answer = rng.integers(0, A, n)
    cats = np.zeros((n, A), np.float32)
    cats[np.arange(n), answer] = 1.0
    room = mix["room"]
    yaw = rng.random(n) * 2 * np.pi
    aux = np.stack([rng.uniform(0.1, 0.9, n) * room[0], rng.uniform(0.1, 0.9, n) * room[1],
                    np.zeros(n), np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)],
                   1).astype(np.float32)
    return {"s_ids": sit["ids"], "s_mask": sit["mask"], "q_ids": que["ids"], "q_mask": que["mask"],
            "auxiliary_task": aux, "answer_cats": cats, "answer_cat_scores": cats.copy(),
            "answer_cat": answer.astype(np.int32),
            "question_type": rng.integers(0, 9, n).astype(np.int32),
            "question_id": np.arange(n, dtype=np.int32)}


def rows(d: Dict[str, np.ndarray], idx) -> Dict[str, np.ndarray]:
    return {k: np.ascontiguousarray(v[idx]) for k, v in d.items()}


def real_lengths(batch: Dict[str, np.ndarray]) -> List[tuple]:
    """(situation, question) real token counts of each row."""
    return list(zip(batch["s_mask"].sum(1).tolist(), batch["q_mask"].sum(1).tolist()))
