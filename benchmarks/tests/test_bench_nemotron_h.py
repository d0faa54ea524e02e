"""The Nemotron cell's program on the card and its reference's spec: the
relu^2 expert kernel and the SSM kernels against their plain versions at the
cell's shapes, the captured greedy decode against the same steps run
eagerly, the full-size spec against the program's state, each Mamba fault
planted at the cell's size failing its check, and a tiny CPU run of the
cell through ``run_cell`` (``-m chip`` for the card's:
``python3 -m pytest benchmarks/tests -q -m chip``)."""
import copy
import math

import pytest
import torch

from benchmarks import mamba_faults
from benchmarks.drivers import blip2_nemotron_h_answer as drv
from benchmarks.harness.cell import cell_files
from benchmarks.reference import nemotron_h as ref

CELL = "blip2_nemotron3_nano_30b_a3b.answer"


def tiny_nemotron_files() -> dict:
    """The cell's files at the CPU tests' tiny widths, float32."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[2])
    if root not in sys.path:
        sys.path.insert(0, root)
    from tests.test_torch_nemotron_h import CONFIG, S
    f = copy.deepcopy(cell_files(CELL))
    f["config"]["settings"] = dict(S)
    f["config"].update(compute_dtype="float32", param_dtype="float32", tokenizer_vocab=96,
                       **{k: CONFIG[k] for k in ("time_step_min", "time_step_max")})
    f["traffic"].update(batch_size=3, pool_batches=2, words=[2, 6], max_len=4, check_batches=2)
    return f


def test_full_size_spec_matches_the_program():
    s = ref.settings(cell_files(CELL)["config"])
    from situation3d_tpu_torch.models.blip2_nemotron_h import Blip2NemotronH
    model = Blip2NemotronH(drv.qformer_config(s), drv.lm_config(s), s["pc_feat_dim"],
                           s["pos_scale"], s["max_txt_len"], torch.bfloat16, torch.bfloat16,
                           device="meta")
    spec = ref.param_spec(s)
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == spec
    lm = sum(math.prod(v) for n, v in spec.items() if n.startswith("nemotron_h."))
    from situation3d_tpu_torch.models.nemotron_h import parameter_count
    assert lm == parameter_count(drv.lm_config(s)) == 31_577_940_288
    dtypes = {n: t.dtype for n, t in model.named_parameters()}
    assert dtypes["nemotron_h.layers.1.mixer.experts.up"] == torch.bfloat16
    assert dtypes["nemotron_h.layers.1.mixer.gate.weight"] == torch.float32
    assert dtypes["nemotron_h.layers.0.mixer.A_log"] == torch.float32


def test_the_config_holds_the_published_keys_once():
    c = cell_files(CELL)["config"]
    assert len(ref.PUBLISHED) == 46 and c["reduced"] == []
    assert all(k in c and ref.PREFIX + k not in c["settings"] for k in ref.PUBLISHED)
    assert len(c["hybrid_override_pattern"]) == c["num_hidden_layers"] == 52
    assert [c["hybrid_override_pattern"].count(k) for k in "ME*"] == [23, 23, 6]


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_and_is_correct(trace):
    from benchmarks.harness.main import run_cell
    result = run_cell(CELL, 2 ** 34 + 31, 0.3, trace, "cpu", files=tiny_nemotron_files())
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"logit_gap", "route_flips"}
    if not trace:
        assert set(result["metrics"]) == {"questions_per_s", "question_p95_ms", "setup_s"}


def test_flops_and_the_least_times_by_hand():
    from benchmarks.flops import nemotron_h as flops
    from benchmarks.flops.peaks import BF16_FLOPS, HBM_BYTES_PER_S
    s = ref.settings(cell_files(CELL)["config"])
    D, V = 2688, 131072
    mamba = 2 * D * (4096 + 6144 + 64) + 2 * 4 * 6144 + 4 * 64 * 64 * 128 + 2 * 4096 * D
    attn = 2 * D * (32 + 4) * 128 + 2 * 32 * 128 * D
    moe = 2 * D * 128 + 6 * 4 * D * 1856 + 4 * D * 3712
    per_token = 23 * mamba + 6 * attn + 23 * moe
    assert flops.lm_flops(s, 1, 1) == per_token + 6 * 4 * 1 * 32 * 128 + 2 * D * V
    # Nemotron-3-Nano-30B-A3B: about 3.2 B parameters active a token, the head's
    # and the embedding's rows among them
    assert 3.1e9 < per_token / 2 + D * V < 3.35e9
    least = flops.moe_least_s(40, 48, D, 1856, 6)
    assert least == max((40 * 2 * D * 1856 * 2 + 8 * D * 6) / HBM_BYTES_PER_S,
                        48 * 4 * D * 1856 / BF16_FLOPS)
    state = 64 * 64 * 128 * 4
    per_pos = (6144 + 64 + 4096) * 4
    assert flops.ssm_least_s(s, 600, 8, 8) == max(
        (608 * per_pos + 8 * state + 8 * 2 * state) / HBM_BYTES_PER_S,
        608 * 4 * 64 * 64 * 128 / BF16_FLOPS)


@pytest.mark.chip
@pytest.mark.parametrize("tokens", [8, 616])
def test_relu2_expert_kernel_against_its_plain_version(tokens, card):
    from situation3d_tpu_torch.ops.cuda import moe_experts as moe
    g = torch.Generator(device=card).manual_seed(tokens)
    E, M, D, K = 128, 1856, 2688, 6
    x = torch.randn(tokens, D, generator=g, device=card).bfloat16()
    up = (torch.randn(E, M, D, generator=g, device=card) / D ** 0.5).bfloat16()
    down = (torch.randn(E, D, M, generator=g, device=card) / M ** 0.5).bfloat16()
    pick = torch.rand(tokens, E, generator=g, device=card) + torch.linspace(0, 0.6, E, device=card)
    idx = torch.topk(pick, K, -1).indices.int()
    idx[::7, 1] = -1
    w = torch.rand(tokens, K, generator=g, device=card)
    c_kernel = torch.zeros(2, dtype=torch.int64, device=card)
    c_plain = torch.zeros(2, dtype=torch.int64, device=card)
    got = moe.moe_experts(x, idx, w, up, None, down, c_kernel)
    want = moe.moe_experts_plain(x, idx, w, up, None, down, c_plain)
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-3, err
    assert c_kernel.tolist() == c_plain.tolist()


@pytest.mark.chip
@pytest.mark.parametrize("L", [1, 77, 130])
def test_ssm_kernels_against_their_plain_versions(L, card):
    from situation3d_tpu_torch.ops.cuda import ssm_scan
    g = torch.Generator(device=card).manual_seed(L)
    B, H, G = 8, 64, 8
    xbc = torch.randn(B, L, H * 64 + 2 * G * 128, generator=g, device=card)
    dt = torch.nn.functional.softplus(torch.randn(B, L, H, generator=g, device=card) - 3)
    dt[:, :L // 3] = 0
    A = -torch.rand(H, generator=g, device=card) * 15 - 1
    D = torch.ones(H, device=card)
    keep = torch.ones(B, L, dtype=torch.bool, device=card)
    s_k, s_p = (torch.empty(B, H, 64, 128, device=card) for _ in range(2))
    y_k = ssm_scan.ssm_scan(xbc, dt, A, D, G, 128, s_k, keep)
    y_p = ssm_scan.ssm_scan_plain(xbc, dt, A, D, G, 128, s_p, 128)
    assert float((y_k - y_p).abs().max() / y_p.abs().max()) < 1e-4
    assert float((s_k - s_p).abs().max() / s_p.abs().max()) < 1e-4
    # one position's inputs (the last), stepped on from the scanned state
    x1, d1 = xbc[:, -1].contiguous(), dt[:, -1].contiguous()
    u_k, u_p = ssm_scan.ssm_update(x1, d1, A, D, G, 128, s_k), \
        ssm_scan.ssm_update_plain(x1, d1, A, D, G, 128, s_p)
    assert float((u_k - u_p).abs().max() / u_p.abs().max()) < 1e-4


@pytest.mark.chip
def test_captured_decode_equals_eager(card):
    """The published widths at 4 layers (Mamba, expert, attention, expert),
    the cell's B=8 and 10 tokens, two batches: the replayed steps' tokens
    and logits equal the same steps run eagerly."""
    from situation3d_tpu_torch.models import blip2_lfm2 as bl
    files = cell_files(CELL)
    config = copy.deepcopy(files["config"])
    config["hybrid_override_pattern"], config["num_hidden_layers"] = "ME*E", 4
    s = ref.settings(config)
    model = drv.build_model(config, 7, card)
    lm, B, N, T = model.lm, 8, s["qformer.scene_token_capacity"], 10
    eos, pad = s[ref.PREFIX + "eos_token_id"], s[ref.PREFIX + "pad_token_id"]
    ids, mask = drv.prompts(7, 2 * B, files["traffic"], s["prompt"], s["max_txt_len"],
                            config["tokenizer_vocab"], s[ref.PREFIX + "bos_token_id"])
    g = torch.Generator(device=card).manual_seed(3)
    for k in range(2):
        batch = {"pc_feat": torch.randn(B, N, s["pc_feat_dim"], generator=g, device=card),
                 "pc": torch.randint(0, 256, (B, N, 3), generator=g, device=card),
                 "pc_mask": torch.ones(B, N, dtype=torch.int32, device=card),
                 "input_ids": ids[k * B:(k + 1) * B], "input_mask": mask[k * B:(k + 1) * B]}
        captured = bl.predict_answers(model, batch, max_len=T)
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


@pytest.mark.chip
@pytest.mark.parametrize("fault", mamba_faults.FAULTS)
def test_mamba_faults_fail_at_size(fault, card):
    from benchmarks.harness.main import run_cell
    with mamba_faults.planted(fault):
        result = run_cell(CELL, 2 ** 35 + 43, 2.0, False, card)
    assert not result["correct"], result["checks"]
