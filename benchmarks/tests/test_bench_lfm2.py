"""The LFM2 cell's program on the card and its reference's spec: the expert
kernel against its plain version at the cell's decode and prefill shapes,
the captured greedy decode against the same steps run eagerly, and the
full-size spec against the program's state, and each routing fault planted
at the cell's size failing its check (``-m chip`` for the card's:
``python3 -m pytest benchmarks/tests -q -m chip``)."""
import math

import pytest
import torch

from benchmarks import routing_faults
from benchmarks.drivers import blip2_lfm2_answer as drv
from benchmarks.harness.cell import cell_files
from benchmarks.reference import lfm2 as ref

CELL = "blip2_lfm2_24b_a2b.answer"


def test_full_size_spec_matches_the_program():
    s = ref.settings(cell_files(CELL)["config"])
    from situation3d_tpu_torch.models.blip2_lfm2 import Blip2LFM2
    model = Blip2LFM2(drv.qformer_config(s), drv.lfm2_config(s), s["pc_feat_dim"],
                      s["pos_scale"], s["max_txt_len"], torch.bfloat16, torch.bfloat16,
                      device="meta")
    spec = ref.param_spec(s)
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == spec
    lm = sum(math.prod(v) for n, v in spec.items() if n.startswith("lfm2."))
    assert lm == 23_843_661_440
    dtypes = {n: t.dtype for n, t in model.named_parameters()}
    assert dtypes["lfm2.layers.5.feed_forward.experts.w1"] == torch.bfloat16
    assert dtypes["lfm2.layers.5.feed_forward.gate.weight"] == torch.float32


def test_the_config_holds_the_published_keys_once():
    c = cell_files(CELL)["config"]
    assert len(ref.PUBLISHED) == 20 and c["reduced"] == []
    assert all(k in c and f"lfm2.{k}" not in c["settings"] for k in ref.PUBLISHED)
    s = ref.settings(c)
    assert all(s[f"lfm2.{k}"] == c[k] for k in ref.PUBLISHED)
    assert len(c["layer_types"]) == c["num_hidden_layers"] == 40


@pytest.mark.chip
@pytest.mark.parametrize("tokens", [8, 616])
def test_expert_kernel_against_its_plain_version(tokens, card):
    from situation3d_tpu_torch.models.lfm2 import LFM2Config
    from situation3d_tpu_torch.ops.cuda import moe_experts as moe
    cfg = LFM2Config()
    g = torch.Generator(device=card).manual_seed(tokens)
    E, M, D, K = cfg.num_experts, cfg.moe_intermediate_size, cfg.hidden_size, 4
    x = torch.randn(tokens, D, generator=g, device=card).bfloat16()
    w1 = (torch.randn(E, M, D, generator=g, device=card) / D ** 0.5).bfloat16()
    w3 = (torch.randn(E, M, D, generator=g, device=card) / D ** 0.5).bfloat16()
    w2 = (torch.randn(E, D, M, generator=g, device=card) / M ** 0.5).bfloat16()
    # skewed choices: some experts take many rows, some none; a few dropped
    pick = torch.rand(tokens, E, generator=g, device=card) + torch.linspace(0, 0.6, E, device=card)
    idx = torch.topk(pick, K, -1).indices.int()
    idx[::7, 1] = -1
    w = torch.rand(tokens, K, generator=g, device=card)
    c_kernel = torch.zeros(2, dtype=torch.int64, device=card)
    c_plain = torch.zeros(2, dtype=torch.int64, device=card)
    got = moe.moe_experts(x, idx, w, w1, w3, w2, c_kernel)
    want = moe.moe_experts_plain(x, idx, w, w1, w3, w2, c_plain)
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-3, err
    assert c_kernel.tolist() == c_plain.tolist()


@pytest.mark.chip
def test_captured_decode_equals_eager(card):
    """The published widths at 4 layers (dense, conv, attention and expert
    feed-forwards), the cell's B=8 and 10 tokens, four batches: the replayed
    steps' tokens and logits equal the same steps run eagerly; 9 captures at
    the first batch and none after, 9 replays a batch."""
    from situation3d_tpu_torch.models import blip2_lfm2 as bl
    files = cell_files(CELL)
    s = ref.settings(files["config"])
    s["lfm2.layer_types"] = ["conv", "conv", "full_attention", "conv"]
    s["lfm2.num_hidden_layers"] = 4
    config = dict(files["config"], settings=s)
    model = drv.build_model(config, 7, card)
    lm, B, N, T = model.lfm2, 8, s["qformer.scene_token_capacity"], 10
    eos, pad = s["lfm2.eos_token_id"], s["lfm2.pad_token_id"]
    ids, mask = drv.prompts(7, 4 * B, files["traffic"], s["prompt"], s["max_txt_len"],
                            config["tokenizer_vocab"], s["lfm2.bos_token_id"])
    g = torch.Generator(device=card).manual_seed(3)
    captures = bl.decode_graph_captures
    for k in range(4):
        batch = {"pc_feat": torch.randn(B, N, s["pc_feat_dim"], generator=g, device=card),
                 "pc": torch.randint(0, 256, (B, N, 3), generator=g, device=card),
                 "pc_mask": torch.ones(B, N, dtype=torch.int32, device=card),
                 "input_ids": ids[k * B:(k + 1) * B], "input_mask": mask[k * B:(k + 1) * B]}
        replays = bl.decode_graph_replays
        captured = bl.lfm2_predict_answers(model, batch, max_len=T)
        assert bl.decode_graph_replays - replays == T - 1
        graphs = next(iter(model.decode_graphs.keys.values()))
        graph_logits = [x.clone() for x in graphs.logits]
        with torch.no_grad():
            b = bl.GreedyBuffers(lm, B, model.prefix_slots, T, card)
            b.reset(pad, pad)
            embeds, m = model.prefix(batch)
            b.emit(0, lm.prefill(embeds, m, b.cache), eos, pad, True)
            for i in range(1, T):
                assert torch.equal(bl.greedy_step(lm, b, i, eos, pad, True), graph_logits[i - 1])
        assert torch.equal(captured, b.out), k
    assert bl.decode_graph_captures - captures == T - 1


def tiny_lfm2_files() -> dict:
    """The cell's files at the CPU tests' tiny widths, float32."""
    import copy
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[2])
    if root not in sys.path:
        sys.path.insert(0, root)
    from tests.test_torch_lfm2 import S
    f = copy.deepcopy(cell_files(CELL))
    f["config"]["settings"] = dict(S)
    f["config"].update(compute_dtype="float32", param_dtype="float32", tokenizer_vocab=96)
    f["traffic"].update(batch_size=3, pool_batches=2, words=[2, 6], max_len=4, check_batches=2)
    return f


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_and_is_correct(trace):
    from benchmarks.harness.main import run_cell
    result = run_cell(CELL, 2 ** 34 + 21, 0.3, trace, "cpu", files=tiny_lfm2_files())
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"logit_gap", "route_flips"}
    if not trace:
        assert set(result["metrics"]) == {"questions_per_s", "question_p95_ms", "setup_s"}


def test_flops_and_the_expert_bound_by_hand():
    from benchmarks.flops import lfm2 as flops
    from benchmarks.flops import moe
    from benchmarks.flops.peaks import BF16_FLOPS, HBM_BYTES_PER_S
    s = ref.settings(cell_files(CELL)["config"])
    D, I, M, V = 2048, 11776, 1536, 65536
    conv = 2 * D * 3 * D + 2 * D * D + 2 * 3 * D
    attn = 2 * D * (32 + 16) * 64 + 2 * 32 * 64 * D
    dense, sparse = 6 * D * I, 2 * D * 64 + 4 * 6 * D * M
    per_token = 30 * conv + 10 * attn + 2 * dense + 38 * sparse
    # one token fed, one generated: no attention keys but its own, one head row
    assert flops.lm_flops(s, 1, 1) == per_token + 10 * 4 * 1 * 32 * 64 + 2 * D * V
    # LFM2-24B-A2B: about 2 B parameters active a token
    assert 1.9e9 < per_token / 2 < 2.4e9
    least = moe.moe_least_s(30, 32, D, M, 4)
    assert least == max((30 * 3 * D * M * 2 + 8 * D * 6) / HBM_BYTES_PER_S,
                        32 * 6 * D * M / BF16_FLOPS)


@pytest.mark.chip
@pytest.mark.parametrize("seed", [2 ** 35 + 21, 2 ** 35 + 22, 2 ** 35 + 23])
def test_control_fails_at_size(seed, card):
    from benchmarks.tests.test_bench_control import control_fails
    assert control_fails(cell_files(CELL), seed, card)


@pytest.mark.chip
@pytest.mark.parametrize("fault", routing_faults.FAULTS)
def test_routing_faults_fail_at_size(fault, card):
    """Each routing fault planted in the cell at its own size: the run is
    not correct."""
    from benchmarks.harness.main import run_cell
    with routing_faults.planted(fault):
        result = run_cell(CELL, 2 ** 35 + 41, 2.0, False, card)
    assert not result["correct"], result["checks"]
