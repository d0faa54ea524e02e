"""Nemotron-H and Blip2NemotronH in the port (``models/nemotron_h.py``,
``models/blip2_nemotron_h.py``, ``ops/cuda/ssm_scan.py``, the relu^2 form of
``ops/cuda/moe_experts.py``) against the benchmark's plain reference
(``benchmarks/reference/nemotron_h.py``) on seeded weights, at a tiny width
with every kind of layer (Mamba-2, expert and NoPE attention), float32 on
the CPU; and LFM2's layers bit-equal to their arithmetic before they shared
code with Nemotron-H.

Tolerances: logits within 1e-5 of the largest (both sides float32; the
orders of the sums differ, and the program's chunked scan sums the
recurrence in another order than the reference's position-by-position
one); the chunked scan within 1e-5 of the largest output of a float64
sequential recurrence (float32 against float64: the chunk's exponentials and
einsums round differently); a padded row and the row alone within 1e-5 of
the largest; the relu^2 expert layer within 1e-6 of a per-token float64 loop
(float32 products of the same values); greedy tokens equal to the
reference's best at every position; LFM2 bit-equal (the same operations in
the same order).
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks.drivers import blip2_nemotron_h_answer as drv  # noqa: E402
from benchmarks.reference import nemotron_h as ref  # noqa: E402
from benchmarks.reference.blip2 import served_positions  # noqa: E402
from situation3d_tpu_torch.models.blip2_lfm2 import predict_answers  # noqa: E402
from situation3d_tpu_torch.models.nemotron_h import NemotronHConfig, parameter_count  # noqa: E402
from situation3d_tpu_torch.ops.cuda import moe_experts as moe  # noqa: E402
from situation3d_tpu_torch.ops.cuda import ssm_scan  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-5
SEED = 2 ** 33 + 29
_LM = {
    "attention_bias": False, "chunk_size": 4, "conv_kernel": 4, "expand": 2, "head_dim": 8,
    "hidden_size": 32, "hybrid_override_pattern": "ME*MEM", "intermediate_size": 16,
    "layer_norm_epsilon": 1e-5, "mamba_head_dim": 4, "mamba_hidden_act": "silu",
    "mamba_num_heads": 4, "mamba_proj_bias": False, "max_position_embeddings": 128,
    "mlp_bias": False, "mlp_hidden_act": "relu2", "model_type": "nemotron_h",
    "moe_intermediate_size": 16, "moe_shared_expert_intermediate_size": 24, "n_group": 1,
    "n_groups": 2, "n_routed_experts": 6, "n_shared_experts": 1, "norm_eps": 1e-5,
    "norm_topk_prob": True, "num_attention_heads": 4, "num_experts_per_tok": 2,
    "num_hidden_layers": 6, "num_key_value_heads": 2, "num_logits_to_keep": 1,
    "partial_rotary_factor": 1, "rescale_prenorm_residual": True, "residual_in_fp32": False,
    "rope_theta": 10000, "routed_scaling_factor": 2.5, "sliding_window": None,
    "ssm_state_size": 8, "tie_word_embeddings": False, "time_step_floor": 1e-4,
    "time_step_max": 0.5, "time_step_min": 0.01, "topk_group": 1, "use_bias": False,
    "use_conv_bias": True, "use_mamba_kernels": True, "vocab_size": 96,
    "bos_token_id": 1, "eos_token_id": 2, "pad_token_id": 0,
}
S = {
    "qformer.num_query_tokens": 4, "qformer.hidden_size": 16, "qformer.num_layers": 2,
    "qformer.num_heads": 2, "qformer.intermediate_size": 32, "qformer.cross_attention_freq": 2,
    "qformer.encoder_width": 24, "qformer.layer_norm_eps": 1e-12,
    "qformer.scene_token_capacity": 20, "pc_feat_dim": 24, "pos_scale": 0.01,
    "prompt": "Question: {} Answer:", "max_txt_len": 12,
    **{ref.PREFIX + k: v for k, v in _LM.items()},
}
# step sizes drawn 5-10x the published range: a state of 8 sums too few terms
# for the recurrence to move the logits at the published range, and the
# Mamba faults must show
CONFIG = {"settings": S, "compute_dtype": "float32", "param_dtype": "float32",
          "time_step_min": 0.01, "time_step_max": 0.5, "time_step_floor": 1e-4,
          "init_normal": {"nemotron_h.layers.*.mixer.e_score_correction_bias": 0.05,
                          "nemotron_h.layers.*.mixer.conv1d.bias": 0.1},
          "init_shared": {"nemotron_h.layers.*.mixer.experts.*": 0.1}}


@pytest.fixture(scope="module")
def model():
    return drv.build_model(CONFIG, SEED, "cpu")


@pytest.fixture(scope="module")
def reference():
    return ref.NemotronHReference(S, drv.reference_weights(CONFIG, SEED, "cpu"))


def _batch(lengths, seed=5):
    g = torch.Generator().manual_seed(seed)
    B, N = len(lengths), S["qformer.scene_token_capacity"]
    ids = np.zeros((B, S["max_txt_len"]), np.int32)
    mask = np.zeros_like(ids)
    for b, n in enumerate(lengths):
        ids[b, :n] = torch.randint(4, _LM["vocab_size"], (n,), generator=g).numpy()
        ids[b, 0] = _LM["bos_token_id"]
        mask[b, :n] = 1
    return {"pc_feat": torch.randn(B, N, S["pc_feat_dim"], generator=g),
            "pc": torch.randint(0, 256, (B, N, 3), generator=g, dtype=torch.int32),
            "pc_mask": torch.ones(B, N, dtype=torch.int32), "input_ids": ids,
            "input_mask": mask}


def _prompt(batch, b):
    return torch.as_tensor(batch["input_ids"][b][batch["input_mask"][b].astype(bool)])


def _close(got, want, what="", rtol=RTOL):
    err, scale = (got - want).abs().max(), want.abs().max()
    assert err <= rtol * scale, (what, float(err), float(scale))


def _teacher_forced(model, batch, tokens):
    """The program's logits [B, T, V] that predict ``tokens`` [B, T]: the
    prefill's, then a decode step's for each token but the last."""
    lm = model.lm
    with torch.no_grad():
        embeds, mask = model.prefix(batch)
        cache = lm.init_cache(embeds.shape[0], model.prefix_slots, tokens.shape[1], "cpu")
        out = [lm.prefill(embeds, mask, cache)]
        for i in range(tokens.shape[1] - 1):
            out.append(lm.decode_step(tokens[:, i:i + 1], cache, i))
    return torch.stack(out, 1)


def test_published_config_and_parameter_count():
    """The published keys build the port's config, every one read or named
    as unread; the model reckons to 31.58 B parameters, the published 31.6 B."""
    import json
    c = json.loads((ROOT / "benchmarks/configs/blip2_nemotron3_nano_30b_a3b.json").read_text())
    assert c["reduced"] == [] and all(k in c for k in ref.PUBLISHED)
    cfg = drv.lm_config(ref.settings(c))
    assert cfg == NemotronHConfig()
    n = parameter_count(cfg)
    assert abs(n - 31.58e9) < 0.01e9, n
    with pytest.raises(ValueError):
        NemotronHConfig.from_published({**{k: c[k] for k in ref.PUBLISHED},
                                        "mlp_hidden_act": "silu"})


@pytest.mark.parametrize("L,chunk", [(13, 4), (1, 4), (8, 4), (5, 128)])
def test_chunked_scan_against_the_sequential_recurrence(L, chunk):
    """The plain scan's chunked form against the recurrence run one position
    at a time in float64, at lengths that are not a multiple of the chunk,
    one of it, and length 1; a pad position (dt = 0) leaves the state as it
    was; the final state is the recurrence's."""
    g = torch.Generator().manual_seed(L * 100 + chunk)
    B, H, P, G, N = 2, 4, 3, 2, 5
    xbc = torch.randn(B, L, H * P + 2 * G * N, generator=g)
    dt = F.softplus(torch.randn(B, L, H, generator=g) - 1)
    dt[0, 0] = 0.0                                           # a pad position
    A, D = -torch.rand(H, generator=g) * 4 - 0.5, torch.randn(H, generator=g)
    state = torch.zeros(B, H, P, N)
    y = ssm_scan.ssm_scan_plain(xbc, dt, A, D, G, N, state, chunk)
    x, Bm, Cm = (t.double() for t in ssm_scan._split(xbc, H, G, N))
    S_ = torch.zeros(B, H, P, N, dtype=torch.float64)
    want = []
    for t in range(L):
        S_ = (torch.exp(dt[:, t].double() * A.double())[..., None, None] * S_
              + (dt[:, t].double()[..., None] * x[:, t])[..., None] * Bm[:, t, :, None, :])
        want.append(torch.einsum("bhpn,bhn->bhp", S_, Cm[:, t]) + D.double()[:, None] * x[:, t])
    _close(y.double(), torch.stack(want, 1).reshape(B, L, -1), f"y L={L}")
    _close(state.double(), S_, f"state L={L}")


def test_one_decode_update_continues_the_scan():
    """A scan over L positions then one update equals the scan over L + 1."""
    g = torch.Generator().manual_seed(4)
    B, L, H, P, G, N = 2, 6, 4, 3, 2, 5
    xbc = torch.randn(B, L + 1, H * P + 2 * G * N, generator=g)
    dt = F.softplus(torch.randn(B, L + 1, H, generator=g))
    A, D = -torch.rand(H, generator=g) * 4, torch.randn(H, generator=g)
    whole, part = torch.zeros(B, H, P, N), torch.zeros(B, H, P, N)
    y = ssm_scan.ssm_scan_plain(xbc, dt, A, D, G, N, whole, 4)
    ssm_scan.ssm_scan_plain(xbc[:, :L], dt[:, :L], A, D, G, N, part, 4)
    last = ssm_scan.ssm_update_plain(xbc[:, L], dt[:, L], A, D, G, N, part)
    _close(last, y[:, L], "y")
    _close(part, whole, "state")


def test_prefill_and_decode_match_the_full_forward(model, reference):
    """A left-padded batch of ragged prompts, prefilled and then decoded
    through the conv, SSM and KV states, against the reference's full
    forward of each row alone (its recurrence position by position)."""
    batch = _batch([3, 9, 6])
    tokens = torch.randint(4, 96, (3, 5), generator=torch.Generator().manual_seed(3))
    got = _teacher_forced(model, batch, tokens)
    with torch.no_grad():
        want = reference.logits({k: torch.as_tensor(v) for k, v in batch.items()},
                                [_prompt(batch, b) for b in range(3)], list(tokens))
    for b in range(3):
        _close(got[b], want[b], f"row {b}")


def test_a_padded_row_equals_the_row_alone(model):
    """No state leaks from the pad positions through the conv or the scan:
    each row of a left-padded batch equals the row served alone."""
    batch = _batch([2, 10, 6])
    tokens = torch.randint(4, 96, (3, 4), generator=torch.Generator().manual_seed(4))
    together = _teacher_forced(model, batch, tokens)
    for b in range(3):
        alone = _teacher_forced(model, {k: v[b:b + 1] for k, v in batch.items()},
                                tokens[b:b + 1])
        _close(together[b], alone[0], f"row {b}")


def test_relu2_expert_layer_with_its_shared_expert(model, reference):
    """The plain relu^2 expert path against a per-token float64 loop (a
    dropped choice, an expert chosen by none); and one expert layer of the
    model, shared expert included, against the reference's layer."""
    g = torch.Generator().manual_seed(9)
    N, K, E, M, D = 7, 2, 6, 16, 32
    x = torch.randn(N, D, generator=g)
    idx = torch.tensor([[0, 2], [2, 0], [5, 2], [0, -1], [-1, -1], [2, 5], [5, 0]],
                       dtype=torch.int32)
    w = torch.rand(N, K, generator=g)
    up, down = torch.randn(E, M, D, generator=g), torch.randn(E, D, M, generator=g)
    counters = torch.zeros(2, dtype=torch.int64)
    got = moe.moe_experts(x, idx, w, up, None, down, counters)
    want = torch.zeros(N, D, dtype=torch.float64)
    for n in range(N):
        for k in range(K):
            e = int(idx[n, k])
            if e >= 0:
                h = torch.relu(up[e].double() @ x[n].double()).square()
                want[n] += w[n, k].double() * (down[e].double() @ h)
    _close(got.double(), want, "plain", 1e-6)
    assert counters.tolist() == [11, 3]
    layer = model.lm.layers[1]
    assert layer.kind == "E"
    from situation3d_tpu_torch.models.lfm2 import _Ctx
    xs = torch.randn(2, 5, 32, generator=g)
    with torch.no_grad():
        ctx = _Ctx(None, None, torch.ones(2, 5, dtype=torch.bool), None, None, [], [])
        prog = layer.mixer(xs, ctx, 0)
        reference._held = {}
        want = reference.experts("nemotron_h.layers.1.mixer", xs.reshape(10, 32))
    _close(prog.reshape(10, 32), want, "layer")


def test_greedy_tokens_are_the_references(model, reference):
    """``predict_answers``' tokens are the reference's best at every position
    it served; the decode's counters count its scans and updates."""
    counters = ssm_scan.device_counters("cpu")
    counters.zero_()
    batch = _batch([5, 11, 8, 2], seed=8)
    tokens = predict_answers(model, batch, max_len=6)
    assert tokens.shape == (4, 6)
    served = served_positions(tokens, _LM["eos_token_id"])
    rows = [tokens[b][served[b]] for b in range(4)]
    with torch.no_grad():
        want = reference.logits({k: torch.as_tensor(v) for k, v in batch.items()},
                                [_prompt(batch, b) for b in range(4)], rows)
    for b in range(4):
        assert torch.equal(want[b].argmax(-1), rows[b]), b
    n_ssm = _LM["hybrid_override_pattern"].count("M")
    real = S["qformer.num_query_tokens"] * 4 + 5 + 11 + 8 + 2
    steps = int(served.sum(1).max()) - 1
    assert counters.tolist() == [n_ssm * real, n_ssm * 4 * steps]


@pytest.mark.parametrize("fault", [None, "no_softplus", "state_dropped"])
def test_the_cell_check_catches_each_mamba_fault(fault):
    """The Nemotron cell at a tiny size: correct unbroken, not correct with
    each Mamba fault of ``benchmarks/mamba_faults.py`` planted."""
    from benchmarks import mamba_faults
    from benchmarks.harness.main import run_cell
    from benchmarks.tests.test_bench_nemotron_h import CELL, tiny_nemotron_files
    with mamba_faults.planted(fault):
        result = run_cell(CELL, 2 ** 34 + 23, 0.3, False, "cpu", files=tiny_nemotron_files())
    assert result["correct"] is (fault is None), result["checks"]


# -- LFM2 after the shared code: bit-equal to its arithmetic before ------------

def _lfm2_before(model, embeds, mask, cache):
    """LFM2's prefill with its conv, attention and router written out as they
    were before Nemotron-H shared them (``causal_conv``, ``attend``,
    ``sigmoid_topk_route``)."""
    from situation3d_tpu_torch.models import lfm2
    lm, cfg = model.lfm2, model.lfm2.cfg
    keep = mask.bool()
    positions = (torch.cumsum(keep.long(), 1) - 1).clamp(min=0)
    cos, sin = lfm2.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    P, L = cache.prefix_slots, mask.shape[1]
    cache.zero_()
    cache.mask[:, P - L:P] = keep
    x = embeds.float()
    for i, layer in enumerate(lm.layers):
        h = layer.operator_norm(x).to(layer.dtype)
        if layer.kind == "conv":
            m = layer.conv
            b, c, xt = m.in_proj(h).float().chunk(3, -1)
            bx = b * xt * keep[..., None]
            w = m.conv.weight.float()[:, 0]
            taps = w.shape[1]
            pad = F.pad(bx.transpose(1, 2), (taps - 1, 0))
            y = pad[..., 0:L] * w[:, 0:1]
            for j in range(1, taps):
                y = y + pad[..., j:j + L] * w[:, j:j + 1]
            cache.conv[lm._conv_slot[i]].copy_(pad[..., -taps:])
            h = m.out_proj(c * y.transpose(1, 2))
        else:
            m = layer.self_attn
            B = h.shape[0]
            H, KV, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
            G = H // KV
            q = lfm2.apply_rope(m.q_layernorm(m.q_proj(h).view(B, L, H, d)), cos, sin)
            k = lfm2.apply_rope(m.k_layernorm(m.k_proj(h).view(B, L, KV, d)), cos, sin)
            v = m.v_proj(h).view(B, L, KV, d)
            k, v = k.to(m.dtype).transpose(1, 2), v.to(m.dtype).transpose(1, 2)
            slot = lm._attn_slot[i]
            cache.kv[slot, 0, :, :, P - L:P] = k
            cache.kv[slot, 1, :, :, P - L:P] = v
            causal = torch.ones(L, L, dtype=torch.bool).tril()
            kp = causal[None] & keep[:, None, :]
            qg = q.view(B, L, KV, G, d).permute(0, 2, 3, 1, 4).reshape(B, KV, G * L, d)
            sc = torch.matmul(qg, k.float().transpose(-1, -2)) * (d ** -0.5)
            sc = sc.view(B, KV, G, L, -1)
            sc = torch.where(kp[:, None, None], sc, sc.new_full((), lfm2.NEG_INF))
            att = F.softmax(sc, -1).view(B, KV, G * L, -1)
            out = torch.matmul(att, v.float()).view(B, KV, G, L, d)
            h = m.out_proj(out.permute(0, 3, 1, 2, 4).reshape(B, L, H * d))
        x = x + h.float()
        hn = layer.ffn_norm(x).to(layer.dtype)
        ff = layer.feed_forward
        if isinstance(ff, lfm2.MoEFF):
            rows = hn.reshape(-1, hn.shape[-1])
            s = torch.sigmoid(F.linear(rows.float(), ff.gate.weight.float()))
            idx = torch.topk(s + ff.expert_bias.float(), cfg.num_experts_per_tok, -1).indices
            wts = s.gather(-1, idx)
            wts = wts / (wts.sum(-1, keepdim=True) + 1e-6) * cfg.routed_scaling_factor
            idx = torch.where(keep.reshape(-1, 1), idx.to(torch.int32), -1)
            ex = ff.experts
            out = moe.moe_experts(rows, idx, wts, ex.w1, ex.w3, ex.w2).view(hn.shape)
        else:
            out = ff(hn, keep)
        x = x + out.float()
    return lm._logits(x[:, -1])


def test_lfm2_is_bit_equal_to_its_arithmetic_before_the_shared_code():
    """LFM2's tiny model (every kind of layer, a left-padded batch): the
    prefill's logits and its conv and KV states bit-equal to the layers
    written out as they were before the conv, attention and router became
    shared functions."""
    from tests.test_torch_lfm2 import CONFIG as LFM2_CONFIG, SEED as LFM2_SEED, _batch as lb
    from benchmarks.drivers import blip2_lfm2_answer as ldrv
    m = ldrv.build_model(LFM2_CONFIG, LFM2_SEED, "cpu")
    batch = lb([3, 9, 6])
    with torch.no_grad():
        embeds, mask = m.prefix(batch)
        now = m.lfm2.init_cache(3, m.prefix_slots, 4, "cpu")
        before = m.lfm2.init_cache(3, m.prefix_slots, 4, "cpu")
        got = m.lfm2.prefill(embeds, mask, now)
        want = _lfm2_before(m, embeds, mask, before)
    assert torch.equal(got, want)
    assert torch.equal(now.conv, before.conv) and torch.equal(now.kv, before.kv)
    assert now.ssm is None and not math.isnan(float(got.sum()))
