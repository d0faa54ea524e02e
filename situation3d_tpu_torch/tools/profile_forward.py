"""Where the full-width SIG3D forward, or training step, spends its time on
the card.

Run from the repository root on a machine with one CUDA device:

    python3 -m situation3d_tpu_torch.tools.profile_forward [--batch 8] [--out DIR]
    python3 -m situation3d_tpu_torch.tools.profile_forward --train frozen|unfrozen

With ``--train`` it times one training step of that configuration (scene
encoder frozen, the default, or trained too) split into forward, backward
and optimizer, and profiles one whole step.

Prints one JSON object: the card's name and power limit, host-clock stage
times (each stage ends in ``torch.cuda.synchronize()``; median of a few
runs), the device-busy share of one forward and the top device kernels by
time from ``torch.profiler``. With ``--out`` it also writes the Chrome trace.
Weights are random (seeded); the batch is the pinned synthetic scene batch.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from situation3d_tpu_torch.config import Config, apply_overrides
from situation3d_tpu_torch.data.synthetic import make_scene_batch
from situation3d_tpu_torch.models.sig3d import (SIG3D, init_random_weights,
                                                make_sample_draws,
                                                situated_token_pool)
from situation3d_tpu_torch.sparse.minkunet import build_unet_plan
from situation3d_tpu_torch.sparse.tensor import SparseVoxels
from situation3d_tpu_torch.train.losses import get_loss
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


def profile_train(args, cfg, card) -> dict:
    """Stage times of one training step (each stage ends in a synchronize;
    median over ``--runs`` steps after 3 warm-up steps) and the profile of one
    whole ``train_step``."""
    from torch.profiler import ProfilerActivity, profile
    if args.train == "unfrozen":
        cfg = apply_overrides(cfg, ["train.frozen_prefixes="])
    batch, _, _ = make_scene_batch(cfg, args.batch, np.random.RandomState(0), "cuda")
    model = SIG3D(cfg, 706, dtype=torch.bfloat16, device="cuda")
    init_random_weights(model, 0)
    state = create_train_state(cfg, model, 1000, seed=0)
    for _ in range(3):
        train_step(cfg, state, batch)
    times = {"forward": [], "backward": [], "optimizer": [], "step_total": []}
    model.train()
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(batch, generator=state.sample_generator, train=True,
                    dropout_generator=state.dropout_generator)
        loss, _ = get_loss(out, batch, cfg.loss, cfg.model.situation_loss_tag)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state.optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in (("forward", t1 - t0), ("backward", t2 - t1), ("optimizer", t3 - t2)):
            times[k].append(v * 1e3)
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(cfg, state, batch)
        torch.cuda.synchronize()
        times["step_total"].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(cfg, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    stages = {k: statistics.median(v) for k, v in times.items()}
    n_train = sum(p.numel() for p in state.optimizer.params)
    result = {
        "card": card, "mode": f"train_{args.train}", "batch": args.batch,
        "dtype": "bfloat16", "trainable_parameters": n_train,
        "stages_ms": {k: round(v, 3) for k, v in stages.items()},
        "samples_per_s": round(args.batch / stages["step_total"] * 1e3, 3),
        "profiled_step_wall_ms": round(wall_ms, 3),
        "device_busy_ms": round(busy_ms, 3),
        "device_idle_share": (round(max(0.0, 1 - busy_ms / stages["step_total"]), 4)
                              if busy_ms else "not measured"),
        "peak_memory_gb": round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
        "top_device_kernels": [{"ms": round(ms, 3), "calls": n, "name": k}
                               for ms, n, k in rows[:25]],
    }
    if args.out:
        import os
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, f"train_{args.train}_trace.json"))
        with open(os.path.join(args.out, f"profile_train_{args.train}.json"), "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default="")
    ap.add_argument("--train", choices=["frozen", "unfrozen"], default=None,
                    help="profile a training step instead of the forward")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    cfg = apply_overrides(Config(), ["data.num_answers=706"])
    if args.train:
        profile_train(args, cfg, card)
        return 0
    sp = cfg.sparse
    batch, _, _ = make_scene_batch(cfg, args.batch, np.random.RandomState(0), "cuda")
    model = SIG3D(cfg, 706, dtype=torch.bfloat16, device="cuda")
    init_random_weights(model, 0)
    draws = make_sample_draws(args.batch, sp.capacities[-1], cfg.model.num_scene_tokens,
                              torch.Generator().manual_seed(1), "cuda")
    stages = {}
    with torch.inference_mode():
        for _ in range(2):
            model(batch, sample_draws=draws)
        stages["forward_total"], _ = _timed(lambda: model(batch, sample_draws=draws), args.runs)
        stages["plan_build"], plan = _timed(lambda: build_unet_plan(
            batch["voxel_coords"], batch["voxel_mask"], sp.capacities, sp.grid_extent,
            device="cuda"), args.runs)
        x = SparseVoxels(batch["voxel_coords"], batch["voxel_feats"].to(torch.bfloat16),
                         batch["voxel_mask"], 1)
        stages["sparse_encoder"], enc = _timed(lambda: model.scene_encoder(x, plan), args.runs)
        bott = enc["feat_bottleneck"]
        stages["token_pool"], toks = _timed(lambda: situated_token_pool(
            bott.coords, bott.feats, bott.mask, bott.stride, cfg.model.num_scene_tokens,
            cfg.data.voxel_size, *draws), args.runs)
        stages["language"], _ = _timed(lambda: model.lang_net(
            batch["s_ids"], batch["s_mask"], batch["q_ids"], batch["q_mask"]), args.runs)
        fast = {k: v for k, v in batch.items() if not k.startswith("voxel_")}
        fast["scene_tokens"], fast["scene_token_positions"] = toks
        stages["language_fusion_heads"], _ = _timed(lambda: model(fast), args.runs)

        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(batch, sample_draws=draws)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    result = {
        "card": card, "batch": args.batch, "dtype": "bfloat16",
        "stages_ms": {k: round(v, 3) for k, v in stages.items()},
        "profiled_forward_wall_ms": round(wall_ms, 3),
        "device_busy_ms": round(busy_ms, 3),
        # busy time is from the profiled forward; the profiler slows the host,
        # so the idle share is taken against the unprofiled forward's time
        "device_idle_share": (round(max(0.0, 1 - busy_ms / stages["forward_total"]), 4)
                              if busy_ms else "not measured"),
        "top_device_kernels": [{"ms": round(ms, 3), "calls": n, "name": k}
                               for ms, n, k in rows[:25]],
    }
    if args.out:
        import os
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "forward_trace.json"))
        with open(os.path.join(args.out, "profile_forward.json"), "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
