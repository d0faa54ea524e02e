"""LFM2-MoE and Blip2LFM2 in the port (``models/lfm2.py``,
``models/blip2_lfm2.py``, ``ops/cuda/moe_experts.py``) against the
benchmark's plain reference (``benchmarks/reference/lfm2.py``) on seeded
weights, at a tiny width with every kind of layer (conv and attention
mixers, dense and expert feed-forwards), float32 on the CPU.

Tolerances: logits within 1e-5 of the largest (both sides float32; the
orders of the sums differ); a padded row and the row alone within 1e-5 of
the largest; the plain expert layer within 1e-6 of a per-token loop in
float64; greedy tokens equal to the reference's best at every position;
the route counters taken from the segment plan equal to the plain
version's own count. The benchmark's LFM2 cell at a tiny size is correct,
and not correct with each routing fault of ``benchmarks/routing_faults.py``
planted.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import routing_faults  # noqa: E402
from benchmarks.drivers import blip2_lfm2_answer as drv  # noqa: E402
from benchmarks.reference import lfm2 as ref  # noqa: E402
from benchmarks.reference.blip2 import served_positions  # noqa: E402
from situation3d_tpu_torch.models.blip2_lfm2 import lfm2_predict_answers  # noqa: E402
from situation3d_tpu_torch.ops.cuda import moe_experts as moe  # noqa: E402
from situation3d_tpu_torch.ops.cuda.gather_rows import segment_plan  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-5
SEED = 2 ** 33 + 17
S = {
    "qformer.num_query_tokens": 4, "qformer.hidden_size": 16, "qformer.num_layers": 2,
    "qformer.num_heads": 2, "qformer.intermediate_size": 32, "qformer.cross_attention_freq": 2,
    "qformer.encoder_width": 24, "qformer.layer_norm_eps": 1e-12,
    "qformer.scene_token_capacity": 20, "pc_feat_dim": 24, "pos_scale": 0.01,
    "prompt": "Question: {} Answer:", "max_txt_len": 12,
    "lfm2.vocab_size": 96, "lfm2.hidden_size": 32, "lfm2.intermediate_size": 48,
    "lfm2.moe_intermediate_size": 16, "lfm2.num_hidden_layers": 5,
    "lfm2.num_attention_heads": 4, "lfm2.num_key_value_heads": 2,
    "lfm2.layer_types": ["conv", "full_attention", "conv", "conv", "full_attention"],
    "lfm2.num_dense_layers": 1, "lfm2.num_experts": 6, "lfm2.num_experts_per_tok": 2,
    "lfm2.norm_topk_prob": True, "lfm2.routed_scaling_factor": 1.0,
    "lfm2.use_expert_bias": True, "lfm2.norm_eps": 1e-5, "lfm2.conv_L_cache": 3,
    "lfm2.conv_bias": False, "lfm2.rope_parameters": {"rope_theta": 1e6, "rope_type": "default"},
    "lfm2.max_position_embeddings": 128, "lfm2.model_type": "lfm2_moe",
    "lfm2.tie_embedding": True, "lfm2.bos_token_id": 1, "lfm2.eos_token_id": 7,
    "lfm2.pad_token_id": 0,
}
CONFIG = {"settings": S, "compute_dtype": "float32", "param_dtype": "float32",
          "init_normal": {"lfm2.layers.*.feed_forward.expert_bias": 0.05}}


@pytest.fixture(scope="module")
def model():
    return drv.build_model(CONFIG, SEED, "cpu")


@pytest.fixture(scope="module")
def reference():
    return ref.LFM2Reference(S, drv.reference_weights(CONFIG, SEED, "cpu"))


def _batch(lengths, seed=5):
    g = torch.Generator().manual_seed(seed)
    B, N = len(lengths), S["qformer.scene_token_capacity"]
    ids = np.zeros((B, S["max_txt_len"]), np.int32)
    mask = np.zeros_like(ids)
    for b, n in enumerate(lengths):
        ids[b, :n] = torch.randint(4, S["lfm2.vocab_size"], (n,), generator=g).numpy()
        ids[b, 0] = S["lfm2.bos_token_id"]
        mask[b, :n] = 1
    return {"pc_feat": torch.randn(B, N, S["pc_feat_dim"], generator=g),
            "pc": torch.randint(0, 256, (B, N, 3), generator=g, dtype=torch.int32),
            "pc_mask": torch.ones(B, N, dtype=torch.int32), "input_ids": ids,
            "input_mask": mask}


def _row(batch, b):
    return {k: v[b:b + 1] for k, v in batch.items()}


def _prompt(batch, b):
    return torch.as_tensor(batch["input_ids"][b][batch["input_mask"][b].astype(bool)])


def _close(got, want, what=""):
    err, scale = (got - want).abs().max(), want.abs().max()
    assert err <= RTOL * scale, (what, float(err), float(scale))


def _teacher_forced(model, batch, tokens):
    """The program's logits [B, T, V] that predict ``tokens`` [B, T]: the
    prefill's, then a decode step's for each token but the last."""
    lm = model.lfm2
    with torch.no_grad():
        embeds, mask = model.prefix(batch)
        cache = lm.init_cache(embeds.shape[0], model.prefix_slots, tokens.shape[1], "cpu")
        out = [lm.prefill(embeds, mask, cache)]
        for i in range(tokens.shape[1] - 1):
            out.append(lm.decode_step(tokens[:, i:i + 1], cache, i))
    return torch.stack(out, 1)


def test_logits_match_the_reference(model, reference):
    """Every position's logits of one unpadded row, against the reference's
    full forward of the same sequence."""
    batch = _batch([9])
    with torch.no_grad():
        embeds, mask = model.prefix(batch)
        got = model.lfm2._logits(model.lfm2.hidden_states(embeds, mask))[0]
        prompt = _prompt(batch, 0)
        want = reference.logits({k: torch.as_tensor(v) for k, v in batch.items()},
                                [prompt[:1]], [prompt[1:]])[0]
    nq = S["qformer.num_query_tokens"]
    _close(got[nq:-1], want, "positions")
    assert got.shape[0] == nq + 9


def test_prefill_and_decode_match_the_full_forward(model, reference):
    """A left-padded batch of ragged prompts, prefilled and then decoded
    through the hybrid cache, against the reference's full forward of each
    row alone."""
    batch = _batch([3, 9, 6])
    tokens = torch.randint(4, S["lfm2.vocab_size"], (3, 5), generator=torch.Generator().manual_seed(3))
    got = _teacher_forced(model, batch, tokens)
    with torch.no_grad():
        want = reference.logits({k: torch.as_tensor(v) for k, v in batch.items()},
                                [_prompt(batch, b) for b in range(3)], list(tokens))
    for b in range(3):
        _close(got[b], want[b], f"row {b}")


def test_a_padded_row_equals_the_row_alone(model):
    batch = _batch([3, 9, 6])
    tokens = torch.randint(4, S["lfm2.vocab_size"], (3, 4), generator=torch.Generator().manual_seed(4))
    together = _teacher_forced(model, batch, tokens)
    for b in range(3):
        alone = _teacher_forced(model, _row(batch, b), tokens[b:b + 1])
        _close(together[b], alone[0], f"row {b}")


def test_plain_expert_layer_against_a_per_token_loop():
    """Experts that no token chose, a dropped choice (-1) and a token whose
    choices all drop; the counters count routed rows and experts read."""
    g = torch.Generator().manual_seed(9)
    N, K, E, M, D = 7, 2, 6, 16, 32
    x = torch.randn(N, D, generator=g)
    idx = torch.tensor([[0, 2], [2, 0], [5, 2], [0, -1], [-1, -1], [2, 5], [5, 0]],
                       dtype=torch.int32)
    w = torch.rand(N, K, generator=g)
    w1, w3 = torch.randn(E, M, D, generator=g), torch.randn(E, M, D, generator=g)
    w2 = torch.randn(E, D, M, generator=g)
    counters = torch.zeros(2, dtype=torch.int64)
    got = moe.moe_experts(x, idx, w, w1, w3, w2, counters)
    want = torch.zeros(N, D, dtype=torch.float64)
    for n in range(N):
        for k in range(K):
            e = int(idx[n, k])
            if e < 0:
                continue
            xe = x[n].double()
            h = torch.nn.functional.silu(w1[e].double() @ xe) * (w3[e].double() @ xe)
            want[n] += w[n, k].double() * (w2[e].double() @ h)
    err, scale = (got.double() - want).abs().max(), want.abs().max()
    assert err <= 1e-6 * scale, (float(err), float(scale))
    assert got[4].abs().max() == 0
    assert counters.tolist() == [11, 3]


def test_greedy_tokens_are_the_references(model, reference):
    """``lfm2_predict_answers``' tokens are the reference's best at every
    position it served (the reference fed the served tokens before it)."""
    batch = _batch([5, 11, 8, 2], seed=8)
    tokens = lfm2_predict_answers(model, batch, max_len=6)
    assert tokens.shape == (4, 6)
    served = served_positions(tokens, S["lfm2.eos_token_id"])
    rows = [tokens[b][served[b]] for b in range(4)]
    with torch.no_grad():
        want = reference.logits({k: torch.as_tensor(v) for k, v in batch.items()},
                                [_prompt(batch, b) for b in range(4)], rows)
    for b in range(4):
        assert torch.equal(want[b].argmax(-1), rows[b]), b
        assert (tokens[b][~served[b]] == S["lfm2.pad_token_id"]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_counts_from_the_plan_equal_the_plain_counts(seed):
    """The counters the card adds from the segment plan's offsets equal the
    plain version's own count: rows routed (dropped choices left out) and
    experts with at least one row (some experts chosen by none)."""
    g = torch.Generator().manual_seed(seed)
    N, K, E = 40, 4, 64
    idx = torch.topk(torch.rand(N, E, generator=g) + torch.linspace(0, 0.8, E), K, -1)
    idx = idx.indices.int()
    idx[torch.rand(N, K, generator=g) < 0.1] = -1
    plain = torch.zeros(2, dtype=torch.int64)
    w = torch.rand(N, K, generator=g)
    x, w1, w3 = torch.randn(N, 8), torch.randn(E, 4, 8), torch.randn(E, 4, 8)
    moe.moe_experts_plain(x, idx, w, w1, w3, torch.randn(E, 8, 4), plain)
    _, offsets = segment_plan(idx.reshape(1, N * K), E)
    counted = torch.zeros(2, dtype=torch.int64)
    moe.count_routes(offsets, counted)
    assert counted.tolist() == plain.tolist()
    assert 0 < plain[1] < E


@pytest.mark.parametrize("fault", [None, *routing_faults.FAULTS])
def test_the_cell_check_catches_each_routing_fault(fault):
    """The LFM2 cell at a tiny size: correct unbroken, not correct with each
    routing fault planted."""
    from benchmarks.harness.main import run_cell
    from benchmarks.tests.test_bench_lfm2 import CELL, tiny_lfm2_files
    with routing_faults.planted(fault):
        result = run_cell(CELL, 2 ** 34 + 22, 0.3, False, "cpu", files=tiny_lfm2_files())
    assert result["correct"] is (fault is None), result["checks"]
