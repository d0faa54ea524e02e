"""Model FLOPs of SIG3D's work, from the configuration's settings ``s`` and a
cell's own inputs: the real (unpadded) text lengths and the kernel-map hits
of its scenes. A forward product costs 2 x MACs; a trained part three times
its forward (``dx`` and ``dW`` besides); the frozen parts below the last
trained layer (MPNet's first layers, the scene encoder) only their forward;
the per-token situation heads, which no loss reads, only their forward."""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from benchmarks.flops.conv import conv_least_s, conv_ops

STRIDES = (1, 2, 4, 8, 16)


def encoder_convs(s: dict) -> List[Tuple[str, int, int, int, int, int]]:
    """The map-driven convs of the encoder to stride 16, in order:
    (map key, K, C_in, C_out, V_in, V_out); map keys as
    ``reference/sig3d.py:map_hits`` names them."""
    caps, planes, layers = s["sparse.capacities"], s["sparse.planes"], s["sparse.layers"]
    d = s["sparse.init_dim"]
    out = [("k5@0", 125, s["sparse.in_channels"], d, caps[0], caps[0])]
    ch = d
    for i in range(1, 5):
        out.append((f"down@{i}", 8, ch, ch, caps[i - 1], caps[i]))
        p = planes[i - 1]
        for j in range(layers[i - 1]):
            out.append((f"k3@{i}", 27, ch if j == 0 else p, p, caps[i], caps[i]))
            out.append((f"k3@{i}", 27, p, p, caps[i], caps[i]))
        ch = p
    return out


def encoder_flops(s: dict, hits: Dict[str, int], valid: Dict[int, int]) -> float:
    """Forward FLOPs of the encoder on a batch whose maps have ``hits``
    entries that find a voxel and ``valid[i]`` voxels at level i (the 1x1
    shortcut products)."""
    total = sum(conv_ops(hits[k], ci, co) for k, _, ci, co, _, _ in encoder_convs(s))
    planes, ch = s["sparse.planes"], s["sparse.init_dim"]
    for i in range(1, 5):
        if ch != planes[i - 1]:
            total += 2.0 * valid[i] * ch * planes[i - 1]
        ch = planes[i - 1]
    return total


def conv_least_seconds(s: dict, B: int, hits: Dict[str, int]) -> float:
    """The 21 fused convs' least time on a batch of ``B`` scenes."""
    return sum(conv_least_s(hits[k], B, vi, vo, K, ci, co)
               for k, K, ci, co, vi, vo in encoder_convs(s))


def _mpnet_layer(n: int, H: int, I: int) -> float:
    return 2.0 * n * (4 * H * H + 2 * H * I) + 4.0 * n * n * H


def _sa(n: int, H: int) -> float:
    return 24.0 * n * H * H + 4.0 * n * n * H


def _sga(n: int, m: int, H: int) -> float:
    return 24.0 * n * H * H + 4.0 * n * n * H + 8.0 * n * H * H + 4.0 * m * H * H + 4.0 * n * m * H


def _attflat(n: int, H: int, fm: int, g: int, fo: int) -> float:
    return 2.0 * n * (H * fm + fm * g) + 2.0 * n * H * g + 2.0 * H * g * fo


def question_flops(s: dict, ls: int, lq: int, train: bool) -> float:
    """Language, fusion and heads for one question with ``ls`` situation and
    ``lq`` question tokens, on ``num_scene_tokens`` scene tokens."""
    H, I, nl = s["lang.hidden_size"], s["lang.intermediate_size"], s["lang.num_layers"]
    Hm, N, C = s["model.hidden_size"], s["model.num_scene_tokens"], s["model.scene_feat_dim"]
    fm, g, fo = s["model.mcan_flat_mlp_size"], s["model.mcan_flat_glimpses"], s["model.mcan_flat_out_size"]
    A, L = s["data.num_answers"], s["model.mcan_num_layers"]
    frozen = sum((nl - 1) * _mpnet_layer(n, H, I) for n in (ls, lq))
    trained = sum(_mpnet_layer(n, H, I) for n in (ls, lq))
    trained += 2.0 * (ls + lq) * H * Hm + 2.0 * N * (2 * 128 + 128 * C) + 2.0 * N * C * Hm
    trained += L * (_sa(ls, Hm) + _sa(lq, Hm) + _sga(N, ls, Hm) + _sga(N, lq, Hm))
    trained += _attflat(ls, Hm, fm, g, fo) + _attflat(lq, Hm, fm, g, fo) + _attflat(N, Hm, fm, g, fo)
    trained += 2.0 * (2 * fo * Hm + Hm * 7) + 2.0 * (3 * fo * Hm + Hm * A)
    unread = 2.0 * N * (Hm * 256 + 256) + 2.0 * N * (Hm * 256 + 256 * 6)
    return frozen + unread + (3.0 if train else 1.0) * trained


def batch_flops(s: dict, lengths: Iterable[Tuple[int, int]], train: bool,
                hits: Dict[str, int] = None, valid: Dict[int, int] = None) -> float:
    """A batch: its questions, and its scenes' encoder when ``hits`` is given."""
    total = sum(question_flops(s, ls, lq, train) for ls, lq in lengths)
    if hits is not None:
        total += encoder_flops(s, hits, valid)
    return total
