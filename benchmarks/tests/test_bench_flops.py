"""The FLOP and byte counts agree with counts made by hand on tiny shapes."""
import pytest

from benchmarks.flops import blip2, conv, sig3d
from benchmarks.flops.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def test_conv_bound():
    # B=2, V_in=10, V_out=4, K=8, C 3 -> 5, 7 hits
    assert conv.conv_ops(7, 3, 5) == 2 * 7 * 3 * 5
    assert conv.conv_bytes(2, 10, 4, 8, 3, 5) == 2 * 10 * 3 * 2 + 2 * 4 * 8 * 4 + 8 * 3 * 5 * 2 + 2 * 4 * 5 * 4
    assert conv.conv_least_s(7, 2, 10, 4, 8, 3, 5) == pytest.approx(
        max(210 / BF16_FLOPS, 776 / HBM_BYTES_PER_S))


S = {"sparse.capacities": [16, 8, 4, 2, 1], "sparse.planes": [2, 4, 4, 4, 4, 4, 4, 4],
     "sparse.layers": [1, 1, 1, 1], "sparse.init_dim": 2, "sparse.in_channels": 3,
     "lang.hidden_size": 4, "lang.intermediate_size": 8, "lang.num_layers": 2,
     "model.hidden_size": 2, "model.num_scene_tokens": 3, "model.scene_feat_dim": 4,
     "model.mcan_flat_mlp_size": 2, "model.mcan_flat_glimpses": 1, "model.mcan_flat_out_size": 2,
     "data.num_answers": 5, "model.mcan_num_layers": 1}


def test_encoder_convs_and_flops():
    convs = sig3d.encoder_convs(S)
    assert [c[0] for c in convs] == ["k5@0", "down@1", "k3@1", "k3@1", "down@2", "k3@2", "k3@2",
                                     "down@3", "k3@3", "k3@3", "down@4", "k3@4", "k3@4"]
    hits = {"k5@0": 10, "down@1": 4, "k3@1": 6, "down@2": 3, "k3@2": 5, "down@3": 2,
            "k3@3": 2, "down@4": 1, "k3@4": 1}
    valid = {0: 9, 1: 5, 2: 3, 3: 2, 4: 1}
    hand = (2 * 10 * 3 * 2                                   # conv0, 3 -> 2
            + 2 * 4 * 2 * 2 + 2 * 6 * 2 * 2 * 2             # level 1: down, block 2 -> 2
            + 2 * 3 * 2 * 2 + 2 * 5 * 2 * 4 + 2 * 5 * 4 * 4  # level 2: down, block 2 -> 4
            + 2 * valid[2] * 2 * 4                           # its 1x1 shortcut, 2 -> 4
            + 2 * 2 * 4 * 4 + 2 * 2 * 4 * 4 * 2              # level 3
            + 2 * 1 * 4 * 4 + 2 * 1 * 4 * 4 * 2)             # level 4
    assert sig3d.encoder_flops(S, hits, valid) == hand


def test_question_flops_by_hand():
    H, I, Hm, N, C = 4, 8, 2, 3, 4
    ls, lq = 2, 1

    def mp(n):
        return 2 * n * (4 * H * H + 2 * H * I) + 4 * n * n * H

    def sa(n):
        return 24 * n * Hm * Hm + 4 * n * n * Hm

    def sga(n, m):
        return sa(n) + 8 * n * Hm * Hm + 4 * m * Hm * Hm + 4 * n * m * Hm

    def flat(n):
        return 2 * n * (Hm * 2 + 2 * 1) + 2 * n * Hm + 2 * Hm * 2

    trained = (mp(ls) + mp(lq) + 2 * (ls + lq) * H * Hm + 2 * N * (2 * 128 + 128 * C)
               + 2 * N * C * Hm + sa(ls) + sa(lq) + sga(N, ls) + sga(N, lq)
               + flat(ls) + flat(lq) + flat(N) + 2 * (4 * Hm + Hm * 7) + 2 * (6 * Hm + Hm * 5))
    frozen = mp(ls) + mp(lq)
    unread = 2 * N * (Hm * 256 + 256) + 2 * N * (Hm * 256 + 256 * 6)
    assert sig3d.question_flops(S, ls, lq, False) == frozen + unread + trained
    assert sig3d.question_flops(S, ls, lq, True) == frozen + unread + 3 * trained


B2 = {"qformer.hidden_size": 4, "qformer.intermediate_size": 8, "qformer.num_query_tokens": 2,
      "qformer.encoder_width": 6, "qformer.cross_attention_freq": 2, "qformer.num_layers": 2,
      "t5.d_model": 4, "t5.num_heads": 2, "t5.d_kv": 2, "t5.d_ff": 8, "t5.num_layers": 1,
      "t5.num_decoder_layers": 1, "t5.vocab_size": 10}


def test_blip2_flops_by_hand():
    q = (8 * 2 * 16 + 4 * 4 * 4) * 2 + 4 * 2 * 4 * 8 * 2      # self-attention and FFN, 2 layers
    q += 4 * 2 * 16 + 4 * 5 * 6 * 4 + 4 * 2 * 5 * 4         # layer 0's cross-attention, 5 tokens
    q += 2 * 2 * 4 * 4                                       # t5_proj
    assert blip2.qformer_flops(B2, 5) == q
    n = 2 + 3
    assert blip2.t5_encoder_flops(B2, n) == 8 * n * 4 * 4 + 4 * n * n * 4 + 6 * n * 4 * 8
    dec = 4 * n * 4 * 4
    for t in (1, 2):
        dec += 8 * 16 + 4 * t * 4 + 4 * 16 + 4 * n * 4 + 6 * 4 * 8 + 2 * 4 * 10
    assert blip2.decode_flops(B2, n, 2) == dec
