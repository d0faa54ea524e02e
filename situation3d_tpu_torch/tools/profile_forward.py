"""Where the full-width SIG3D forward, or training step, or the full-width
VoteNet detection path, or the full-width 3D-LLM, spends its time on the card.

Run from the repository root on a machine with one CUDA device:

    python3 -m situation3d_tpu_torch.tools.profile_forward [--batch 8] [--out DIR]
    python3 -m situation3d_tpu_torch.tools.profile_forward --train frozen|unfrozen
    python3 -m situation3d_tpu_torch.tools.profile_forward --model votenet [--points 40000]
    python3 -m situation3d_tpu_torch.tools.profile_forward --model blip2
    python3 -m situation3d_tpu_torch.tools.profile_forward --model stage1

With ``--model blip2`` it times the 3D-LLM (Blip2T5 at the default widths,
bf16 compute) at ``bench.py``'s shapes: greedy decoding of 10 tokens at
``--batch`` (5,120 scene tokens, a 64-token prompt), and one frozen-T5
training step at B=4, that one also split into forward + loss, backward and
optimizer; it profiles one greedy decode and one training step.

With ``--model stage1`` it profiles BLIP-2 stage 1 and the OPT zoo at the
default widths, bf16 compute: one stage-1 ``Blip2Qformer`` optimizer step at
``--batch`` (24 ITM rows, captions of 32), one retrieval evaluation over 32
scenes x 32 captions (``k_test`` 16), and a ``Blip2OPT`` (OPT-2.7B) greedy
decode of 10 tokens at ``--batch`` after prompts of up to 32 tokens.

With ``--train`` it times and profiles one training step of that
configuration (scene encoder frozen, the default, or trained too). With
``--model votenet`` it times the evaluation-form forward of the detector
(float32) and its stages — the five sampling launches, the radius queries,
the gathers, the pointwise MLPs with their pooling, the 3-NN search, the
loss — and the training form's forward + loss and backward, and profiles one
forward and one forward + backward.

Prints one JSON object: the card's name and power limit, the host-clock
time of the whole call (between two ``torch.cuda.synchronize()``; median of
a few runs), and from ``torch.profiler``'s profile of one call its
device-busy time, launches, top device kernels by time and peak memory. The
SIG3D forward, the SIG3D training step and the greedy decode split into
stages by the port's spans (``utils/trace.py``) in that same profile: each
``stages`` entry is a span's host ms (its wall time), device ms (the kernels,
copies and sets launched inside it, child spans included, the backward's
from autograd's thread too) and calls, of a call run as it is served, with
no synchronize inside. VoteNet, stage 1 and the 3D-LLM's training step have
no spans: their stages each end in a synchronize. The forward's JSON also
holds a digest of its ``answer_scores``. With ``--out`` it also writes the
Chrome trace. Weights are random (seeded); the batch is the pinned synthetic
scene batch.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from situation3d_tpu_torch.config import Config, apply_overrides
from situation3d_tpu_torch.data.synthetic import make_scene_batch
from situation3d_tpu_torch.models.sig3d import (SIG3D, init_random_weights,
                                                make_sample_draws)
from situation3d_tpu_torch.train.trainer import create_train_state, train_step


def _timed(fn, runs):
    ts, out = [], None
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), out


def _device_rows(prof):
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer."):
            continue      # a span around kernels that are listed themselves
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((dev_us / 1e3, e.count, e.key[:90]))
    rows.sort(reverse=True)
    return rows


def _device_us(e, mirrors) -> float:
    """The kernels, copies and sets ``e`` and its children launched (us),
    less the device-side mirrors of the spans."""
    return (sum(k.duration for k in e.kernels if k.name not in mirrors)
            + sum(_device_us(c, mirrors) for c in e.cpu_children))


def _span_stages(prof) -> dict:
    """Host ms, device ms and calls of each of the port's spans in one
    profile; an operation autograd's thread ran goes to the spans open on
    the spans' thread where it began."""
    from torch.autograd import DeviceType
    events = prof.events()
    spans = [e for e in events if e.device_type == DeviceType.CPU and e.is_user_annotation
             and not e.name.startswith(("ProfilerStep", "Optimizer."))]
    names, threads = {e.name for e in spans}, {e.thread for e in spans}
    stages = defaultdict(lambda: {"host_ms": 0.0, "device_ms": 0.0, "calls": 0})
    for e in spans:
        st = stages[e.name]
        st["host_ms"] += e.time_range.elapsed_us() / 1e3
        st["device_ms"] += _device_us(e, names) / 1e3
        st["calls"] += 1
    for e in events:
        if (e.device_type == DeviceType.CPU and e.cpu_parent is None
                and e.thread not in threads and not e.is_user_annotation):
            us = _device_us(e, names)
            for s in spans:
                if us and s.time_range.start <= e.time_range.start < s.time_range.end:
                    stages[s.name]["device_ms"] += us / 1e3
    return {k: {"host_ms": round(v["host_ms"], 3), "device_ms": round(v["device_ms"], 3),
                "calls": v["calls"]} for k, v in stages.items()}


def _profiled(fn, runs, top: int = 12, trace_path: str = "") -> dict:
    """Host-clocked ms of ``fn`` (median of ``runs``), and from the profile of
    one call its device-busy ms, device launches, top kernels, peak memory
    above what was allocated before the call and the spans' stages; the
    profile as a Chrome trace at ``trace_path`` if given."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    host_ms, out = _timed(fn, runs)
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    rows = _device_rows(prof)
    if trace_path:
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        prof.export_chrome_trace(trace_path)
    busy = sum(r[0] for r in rows)
    return {"host_ms": round(host_ms, 3),
            "device_busy_ms": round(busy, 4),
            "device_idle_share": round(max(0.0, 1 - busy / host_ms), 4),
            "launches": sum(r[1] for r in rows),
            "peak_memory_gb": round(peak / 2 ** 30, 3),
            "stages": _span_stages(prof),
            "top_device_kernels": [{"ms": round(ms, 4), "calls": n, "name": k}
                                   for ms, n, k in rows[:top]]}


def _write(args, name: str, result: dict) -> None:
    print(json.dumps(result))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, name), "w") as fh:
            json.dump(result, fh, indent=1)


def _trace_path(args, name: str) -> str:
    return os.path.join(args.out, name) if args.out else ""


def profile_train(args, cfg, card) -> dict:
    """One training step, timed over ``--runs`` steps after 3 warm-up steps,
    and the profile of one whole ``train_step``."""
    if args.train == "unfrozen":
        cfg = apply_overrides(cfg, ["train.frozen_prefixes="])
    batch, _, _ = make_scene_batch(cfg, args.batch, np.random.RandomState(0), "cuda")
    model = SIG3D(cfg, 706, dtype=torch.bfloat16, device="cuda")
    init_random_weights(model, 0)
    state = create_train_state(cfg, model, 1000, seed=0)
    for _ in range(2):
        train_step(cfg, state, batch)
    step = _profiled(lambda: train_step(cfg, state, batch), args.runs, 25,
                     _trace_path(args, f"train_{args.train}_trace.json"))
    result = {
        "card": card, "mode": f"train_{args.train}", "batch": args.batch, "dtype": "bfloat16",
        "trainable_parameters": sum(p.numel() for p in state.optimizer.params),
        "samples_per_s": round(args.batch / step["host_ms"] * 1e3, 3), "step": step}
    _write(args, f"profile_train_{args.train}.json", result)
    return result


def profile_votenet(args, card) -> dict:
    """Stage times of the detection path. Each stage function of
    ``models/pointnet2_modules.py`` is wrapped so that it starts and ends in
    a ``synchronize``; a forward run that way gives the stages' shares (their
    sum exceeds the unwrapped forward, which overlaps host and device)."""
    from torch.profiler import ProfilerActivity, profile
    from situation3d_tpu_torch.data.scannet_preprocess import ScannetDatasetConfig
    from situation3d_tpu_torch.data.synthetic import make_detection_batch
    from situation3d_tpu_torch.models import pointnet2_modules as pm
    from situation3d_tpu_torch.models.votenet import VoteNet
    from situation3d_tpu_torch.train.detection_losses import get_detection_loss
    dcfg = ScannetDatasetConfig()
    batch = make_detection_batch(args.batch, args.points, np.random.RandomState(20), "cuda")
    model = VoteNet(dcfg.num_class, dcfg.num_heading_bin, dcfg.num_size_cluster,
                    dcfg.mean_size_arr, device="cuda")
    init_random_weights(model, 21, std=None)
    xyz = batch["point_clouds"]

    spent, calls = {}, {}

    def staged(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            calls[name] = calls.get(name, 0) + 1
            return out
        return run

    plain = {n: getattr(pm, n) for n in ("furthest_point_sample", "ball_query",
                                         "gather_points", "group_points", "three_nn",
                                         "three_interpolate")}
    mlp_forward = pm.SharedMLP.forward
    stage_of = {"furthest_point_sample": "fps", "ball_query": "ball_query",
                "gather_points": "gathers", "group_points": "gathers",
                "three_nn": "three_nn", "three_interpolate": "interpolate"}
    with torch.inference_mode():
        for _ in range(2):
            model(xyz)
        stages = {}
        stages["forward_total"], _ = _timed(lambda: model(xyz), args.runs)
        for n, fn in plain.items():
            setattr(pm, n, staged(stage_of[n], fn))
        pm.SharedMLP.forward = staged("shared_mlps", mlp_forward)
        try:
            runs = []
            for _ in range(args.runs):
                spent.clear()
                calls.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(xyz)
                torch.cuda.synchronize()
                runs.append(dict(spent, forward_with_stage_syncs=(
                    time.perf_counter() - t0) * 1e3))
        finally:
            for n, fn in plain.items():
                setattr(pm, n, fn)
            pm.SharedMLP.forward = mlp_forward
        for k in runs[0]:
            stages[k] = statistics.median(r[k] for r in runs)
        stages["pooling_heads_and_rest"] = stages["forward_with_stage_syncs"] - sum(
            v for k, v in stages.items() if k in set(stage_of.values()) | {"shared_mlps"})
        stage_calls = dict(calls)
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(xyz)
            torch.cuda.synchronize()
        peak_forward = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = _device_rows(prof)
    busy_ms = sum(r[0] for r in rows)

    times = {"train_forward_and_loss": [], "train_backward": []}
    for i in range(args.runs + 1):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(xyz, train=True)
        loss, _ = get_detection_loss({**out, **batch}, dcfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i:                                  # the first run warms up
            times["train_forward_and_loss"].append((t1 - t0) * 1e3)
            times["train_backward"].append((t2 - t1) * 1e3)
    for k, v in times.items():
        stages[k] = statistics.median(v)
    torch.cuda.reset_peak_memory_stats()
    model.zero_grad(set_to_none=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
        out = model(xyz, train=True)
        get_detection_loss({**out, **batch}, dcfg)[0].backward()
        torch.cuda.synchronize()
    trows = _device_rows(tprof)
    tbusy = sum(r[0] for r in trows)
    step_ms = stages["train_forward_and_loss"] + stages["train_backward"]
    result = {
        "card": card, "mode": "votenet", "batch": args.batch, "points": args.points,
        "dtype": "float32", "stages_ms": {k: round(v, 3) for k, v in stages.items()},
        "stage_calls": stage_calls,
        "scenes_per_s": round(args.batch / stages["forward_total"] * 1e3, 3),
        "device_busy_ms": round(busy_ms, 3),
        "device_idle_share": (round(max(0.0, 1 - busy_ms / stages["forward_total"]), 4)
                              if busy_ms else "not measured"),
        "peak_memory_gb_forward": round(peak_forward, 2),
        "train_device_busy_ms": round(tbusy, 3),
        "train_device_idle_share": (round(max(0.0, 1 - tbusy / step_ms), 4)
                                    if tbusy else "not measured"),
        "peak_memory_gb_forward_backward": round(
            torch.cuda.max_memory_allocated() / 2 ** 30, 2),
        "top_device_kernels": [{"ms": round(ms, 3), "calls": n, "name": k}
                               for ms, n, k in rows[:20]],
        "train_top_device_kernels": [{"ms": round(ms, 3), "calls": n, "name": k}
                                     for ms, n, k in trows[:20]],
    }
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "votenet_forward_trace.json"))
        with open(os.path.join(args.out, "profile_votenet.json"), "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return result


def blip2_bench_batch(bcfg, B: int, rng, prompt: int = 64, answer: int = 8,
                      labels: bool = True) -> dict:
    """``bench.py``'s 3D-LLM batch as numpy arrays: every scene token valid,
    random prompts (and answers) of fixed length."""
    N, top = bcfg.qformer.scene_token_capacity, min(32000, bcfg.t5.vocab_size)
    b = {"pc_feat": rng.randn(B, N, bcfg.pc_feat_dim).astype(np.float32),
         "pc": rng.randint(0, 256, (B, N, 3)).astype(np.int32),
         "pc_mask": np.ones((B, N), np.int32),
         "input_ids": rng.randint(2, top, (B, prompt)).astype(np.int32),
         "input_mask": np.ones((B, prompt), np.int32)}
    if labels:
        b["labels"] = rng.randint(2, top, (B, answer)).astype(np.int32)
        b["label_mask"] = np.ones((B, answer), np.int32)
    return b


def profile_blip2(args, card) -> dict:
    from situation3d_tpu_torch.device import tree_to_device
    from situation3d_tpu_torch.models.blip2_t5 import Blip2T5, predict_answers
    from situation3d_tpu_torch.train.blip2_trainer import (Blip2TrainState,
                                                          blip2_train_step,
                                                          make_blip2_optimizer)
    cfg = Config()
    bcfg, gen = cfg.blip2, 10
    model = Blip2T5(bcfg, dtype=torch.bfloat16, device="cuda", seed=0)
    rng = np.random.RandomState(0)
    dbatch = tree_to_device(blip2_bench_batch(bcfg, args.batch, rng, labels=False), "cuda")
    tbatch = tree_to_device(blip2_bench_batch(bcfg, 4, rng), "cuda")
    with torch.inference_mode():
        decode = _profiled(lambda: predict_answers(model, dbatch, gen), args.runs)
        tokens = predict_answers(model, dbatch, gen).cpu().numpy()
    opt, _ = make_blip2_optimizer(cfg, model, 100)
    state = Blip2TrainState(model, opt, 0)
    for _ in range(2):
        blip2_train_step(cfg, state, tbatch)
    parts = {"forward_and_loss": [], "backward": [], "optimizer": []}
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model(tbatch)["loss"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, a, b in (("forward_and_loss", t0, t1), ("backward", t1, t2),
                        ("optimizer", t2, t3)):
            parts[k].append((b - a) * 1e3)
    train = _profiled(lambda: blip2_train_step(cfg, state, tbatch), args.runs)
    train["stages_ms"] = {k: round(statistics.median(v), 3) for k, v in parts.items()}
    steps = max(int(np.argmax(r == 1)) + 1 if (r == 1).any() else gen for r in tokens)
    result = {
        "card": card, "mode": "blip2", "batch": args.batch, "train_batch": 4,
        "scene_tokens": bcfg.qformer.scene_token_capacity, "prompt": 64, "gen": gen,
        "greedy_steps_run": steps,
        "tokens_per_s": round(args.batch * steps / decode["host_ms"] * 1e3, 2),
        "train_samples_per_s": round(4 / train["host_ms"] * 1e3, 3),
        "greedy_decode": decode, "train_step": train}
    _write(args, "profile_blip2.json", result)
    return result


def profile_stage1(args, card) -> dict:
    from situation3d_tpu_torch.device import tree_to_device
    from situation3d_tpu_torch.models.blip2_opt import Blip2OPT, opt_predict_answers
    from situation3d_tpu_torch.models.blip2_qformer import Blip2Qformer
    from situation3d_tpu_torch.models.opt import OPTConfig
    from situation3d_tpu_torch.train.optim import make_optimizer
    from situation3d_tpu_torch.train.tasks import RetrievalTask
    cfg = Config()
    qcfg, B, L, N = cfg.blip2.qformer, args.batch, 32, cfg.blip2.qformer.scene_token_capacity
    rng = np.random.RandomState(0)

    def pairs(n):
        tm = (np.arange(L)[None] < rng.randint(4, L + 1, (n, 1))).astype(np.int32)
        return tree_to_device({
            "image_embeds": rng.randn(n, N, qcfg.encoder_width).astype(np.float32),
            "image_mask": np.ones((n, N), np.int32),
            "text_ids": (rng.randint(4, qcfg.vocab_size - 2, (n, L)) * tm).astype(np.int32),
            "text_mask": tm}, "cuda")

    model = Blip2Qformer(qcfg, dtype=torch.bfloat16, device="cuda", seed=0)
    opt, _ = make_optimizer(cfg.train, model)
    batch, negatives = pairs(B), torch.Generator(device="cuda").manual_seed(1)
    model.train()

    def step():
        out = model(batch, generator=negatives)
        opt.discard()
        out["loss"].backward()
        opt.step()
        return out["loss"].detach()
    train = _profiled(step, args.runs)
    task = RetrievalTask(cfg, device="cuda")
    data = pairs(32)
    retrieval = _profiled(lambda: task.evaluation(
        model, data["image_embeds"], data["image_mask"], data["text_ids"],
        data["text_mask"], [[i] for i in range(32)], list(range(32))), 2)
    del model, opt, batch, data
    torch.cuda.empty_cache()
    ocfg = OPTConfig()
    bo = Blip2OPT(qcfg, ocfg, cfg.blip2.pc_feat_dim, dtype=torch.bfloat16, device="cuda",
                  seed=0)
    lens = np.concatenate([[L], rng.randint(4, L + 1, B - 1)])
    mask = (np.arange(L)[None] >= L - lens[:, None]).astype(np.int32)
    dbatch = tree_to_device({
        "pc_feat": rng.randn(B, N, cfg.blip2.pc_feat_dim).astype(np.float32),
        "pc": rng.randint(0, 256, (B, N, 3)).astype(np.int32),
        "pc_mask": np.ones((B, N), np.int32),
        "input_ids": np.where(mask > 0, rng.randint(3, 50000, (B, L)), 1).astype(np.int32),
        "input_mask": mask}, "cuda")
    with torch.inference_mode():
        decode = _profiled(lambda: opt_predict_answers(bo, dbatch, 10, eos_id=-1), args.runs)
    result = {"card": card, "mode": "stage1", "batch": B, "text_len": L, "scene_tokens": N,
              "stage1_train_step": train,
              "stage1_samples_per_s": round(B / train["host_ms"] * 1e3, 3),
              "retrieval_32x32_k16": retrieval, "blip2_opt_greedy_decode_10": decode,
              "opt_tokens_per_s": round(B * 10 / decode["host_ms"] * 1e3, 2)}
    _write(args, "profile_stage1.json", result)
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default="")
    ap.add_argument("--train", choices=["frozen", "unfrozen"], default=None,
                    help="profile a training step instead of the forward")
    ap.add_argument("--model", choices=["sig3d", "votenet", "blip2", "stage1"],
                    default="sig3d")
    ap.add_argument("--points", type=int, default=40000,
                    help="points a scene (--model votenet)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    if args.model == "votenet":
        profile_votenet(args, card)
        return 0
    if args.model == "blip2":
        profile_blip2(args, card)
        return 0
    if args.model == "stage1":
        profile_stage1(args, card)
        return 0
    cfg = apply_overrides(Config(), ["data.num_answers=706"])
    if args.train:
        profile_train(args, cfg, card)
        return 0
    batch, _, _ = make_scene_batch(cfg, args.batch, np.random.RandomState(0), "cuda")
    model = SIG3D(cfg, 706, dtype=torch.bfloat16, device="cuda")
    init_random_weights(model, 0)
    draws = make_sample_draws(args.batch, cfg.sparse.capacities[-1],
                              cfg.model.num_scene_tokens, torch.Generator().manual_seed(1),
                              "cuda")
    with torch.inference_mode():
        model(batch, sample_draws=draws)
        forward = _profiled(lambda: model(batch, sample_draws=draws), args.runs, 25,
                            _trace_path(args, "forward_trace.json"))
        scores = model(batch, sample_draws=draws)["answer_scores"]
    result = {
        "card": card, "batch": args.batch, "dtype": "bfloat16", "forward": forward,
        # seeded weights, batch and draws: equal digests on two trees mean
        # bit-equal answers
        "answer_scores_sha256": hashlib.sha256(
            scores.float().cpu().numpy().tobytes()).hexdigest()[:16],
    }
    _write(args, "profile_forward.json", result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
