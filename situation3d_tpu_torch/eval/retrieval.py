"""Scene-text retrieval scoring: ITC ranking + ITM rerank of the top k (port
of ``situation3d_tpu/eval/retrieval.py``).

``compute_sim_matrix`` encodes every caption and every scene in fixed-size
batches, ranks by the max-over-queries ITC cosine similarity, then rescores
each row's top ``k_test`` candidates with the pairwise ITM head, ``chunk``
rows of ``k_test`` pairs an ITM forward. The scenes and captions move to the
model's device once and are gathered there; the similarities come back to
the host and the ranking is numpy's (``np.argsort``), as in the reference,
so ties break the same way. Rows outside this process's ``(rank, world)``
range are ``FILL`` (one process: ``world=1``, every row).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

FILL = -100.0


def _row_range(n: int, rank: int, world: int) -> Tuple[int, int]:
    """The reference's contiguous row split."""
    step = n // world + 1
    start = rank * step
    return start, min(n, start + step)


@torch.no_grad()
def compute_sim_matrix(model, image_embeds, image_mask, text_ids, text_mask,
                       k_test: int = 16, encode_batch: int = 16, rerank_chunk: int = 4,
                       rank: int = 0, world: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """``model``: a ``Blip2Qformer``. Returns ``(score_i2t [Ni, Nt],
    score_t2i [Nt, Ni])`` as numpy float32. With ``world > 1`` the caller
    sums the processes' results."""
    dev = model.device
    image_embeds, image_mask, text_ids, text_mask = (
        torch.as_tensor(x).to(dev) for x in (image_embeds, image_mask, text_ids, text_mask))
    Ni, Nt = image_embeds.shape[0], text_ids.shape[0]
    k_test = min(k_test, Nt)

    def take(ii, ti):
        ii, ti = torch.from_numpy(ii).to(dev), torch.from_numpy(ti).to(dev)
        return image_embeds[ii], image_mask[ii], text_ids[ti], text_mask[ti]

    # --- features, fixed-size batches (rows past the end wrap around) -------
    img_feats, txt_feats = [], []
    for s in range(0, max(Ni, Nt), encode_batch):
        f_img, f_txt = model.itc_projections(*take(np.arange(s, s + encode_batch) % Ni,
                                                   np.arange(s, s + encode_batch) % Nt))
        if s < Ni:
            img_feats.append(f_img[: Ni - s].cpu().numpy())
        if s < Nt:
            txt_feats.append(f_txt[: Nt - s].cpu().numpy())
    img_feats = np.concatenate(img_feats)[:Ni]          # [Ni, Q, D]
    txt_feats = np.concatenate(txt_feats)[:Nt]          # [Nt, D]

    # ITC similarities: the max over query tokens
    sims = np.einsum("iqd,td->iqt", img_feats, txt_feats).max(axis=1)

    def _rerank(sim_rows, row_ids, i2t: bool):
        """Rerank ``len(row_ids)`` rows' top-k columns with ITM."""
        out = np.full((len(row_ids), sim_rows.shape[1]), FILL, np.float32)
        for s in range(0, len(row_ids), rerank_chunk):
            rows = row_ids[s: s + rerank_chunk]
            pad = rerank_chunk - len(rows)
            rows_p = np.concatenate([rows, np.repeat(rows[-1:], pad)])
            sim_p = sim_rows[np.concatenate([np.arange(s, s + len(rows)),
                                             np.repeat([s + len(rows) - 1], pad)])]
            topk = np.argsort(-sim_p, axis=1)[:, :k_test]       # [R, k]
            if i2t:
                im, tx = np.repeat(rows_p, k_test), topk.reshape(-1)
            else:
                im, tx = topk.reshape(-1), np.repeat(rows_p, k_test)
            score = model.compute_itm(*take(im, tx)).float().cpu().numpy().reshape(-1, k_test)
            for r in range(len(rows)):
                out[s + r, topk[r]] = score[r] + sim_p[r, topk[r]]
        return out

    i0, i1 = _row_range(Ni, rank, world)
    t0, t1 = _row_range(Nt, rank, world)
    score_i2t = np.full((Ni, Nt), FILL, np.float32)
    score_t2i = np.full((Nt, Ni), FILL, np.float32)
    if i1 > i0:
        score_i2t[i0:i1] = _rerank(sims[i0:i1], np.arange(i0, i1), i2t=True)
    if t1 > t0:
        score_t2i[t0:t1] = _rerank(sims.T[t0:t1], np.arange(t0, t1), i2t=False)
    return score_i2t, score_t2i


def retrieval_metrics(scores_i2t: np.ndarray, scores_t2i: np.ndarray,
                      img2txt, txt2img) -> dict:
    """Recall@1/5/10 in both directions from the score matrices.
    ``img2txt`` maps each image row to its matching text ids, ``txt2img``
    each text row to its image id."""
    ranks = np.zeros(scores_i2t.shape[0])
    for i, score in enumerate(scores_i2t):
        inds = np.argsort(score)[::-1]
        ranks[i] = min(np.where(inds == t)[0][0] for t in np.atleast_1d(img2txt[i]))
    tr1, tr5, tr10 = [100.0 * (ranks < k).mean() for k in (1, 5, 10)]

    ranks = np.zeros(scores_t2i.shape[0])
    for i, score in enumerate(scores_t2i):
        inds = np.argsort(score)[::-1]
        ranks[i] = np.where(inds == txt2img[i])[0][0]
    ir1, ir5, ir10 = [100.0 * (ranks < k).mean() for k in (1, 5, 10)]

    tr_mean = (tr1 + tr5 + tr10) / 3
    ir_mean = (ir1 + ir5 + ir10) / 3
    return {"txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10, "txt_r_mean": tr_mean,
            "img_r1": ir1, "img_r5": ir5, "img_r10": ir10, "img_r_mean": ir_mean,
            "r_mean": (tr_mean + ir_mean) / 2, "agg_metrics": tr_mean}
