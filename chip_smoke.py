#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``situation3d_tpu_torch``) on one
NVIDIA GPU: builds the CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version at the shapes the SIG3D forward gives
it, then drives the port's main path — the full-width SIG3D scene-QA forward
and the scene-cache serving form — and checks what comes out.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Needs one CUDA device, ``nvcc`` and no network. Exits non-zero when any phase
fails or when no CUDA device is there (there is no CPU fallback). Prints one
JSON line per phase, the card's name and power limit, one JSON object
``{"kernels": [...]}`` and, as the last line,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``--only device,kernels`` runs a subset of the phases (a first check of a
changed kernel); the contract lines are printed only by a full run.

Bounds. ``bound_ms`` of a kernel is the larger of (bytes it must move: each
input read once, each output written once) / 3.35 TB/s and (operations on
this run's inputs) / peak rate: 989 TFLOP/s for the bf16 conv product. For a
map kernel the table bytes are what the in-extent probes of THIS run touch
(4 B per probe of the grid, 8 B per probe of the bit tables), capped at the
table's size; for the conv the operations are 2*C_in*C_out per map entry
that hits a voxel in THIS run's maps.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from situation3d_tpu_torch.config import Config, apply_overrides
from situation3d_tpu_torch.data.synthetic import make_scene_batch
from situation3d_tpu_torch.eval.serving import SceneCache
from situation3d_tpu_torch.models.sig3d import (SIG3D, init_random_weights,
                                                make_sample_draws)
from situation3d_tpu_torch.ops.cuda import _build, fused_conv, map_bits, map_lookup
from situation3d_tpu_torch.sparse.kernel_map import build_level_grid
from situation3d_tpu_torch.sparse.minkunet import STRIDES, build_unet_plan

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
CONV_ATOL = 2e-4      # f32 accumulation in another order; outputs are O(1)
SERVE_RTOL = 2e-2     # bf16 activations + atomics order in the token pooling
SMALL_ATOL = 1e-3     # f32 small model, card (kernels) vs CPU (plain versions)
SEED = 0
BATCH = 8
DEV = "cuda"   # every phase runs here; there is no CPU mode
KERNEL_MODULES = {"fused_sparse_conv": fused_conv, "k3_map_lookup": map_lookup,
                  "k3_map_lookup_bits": map_bits}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def reset_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


_flush = None


def time_cuda(fn, iters: int = 5, warmup: int = 2) -> float:
    """Mean milliseconds per call (CUDA events), with the L2 cache evicted
    before every timed call: on the main path a conv's map and a map kernel's
    tables were written long before they are read."""
    global _flush
    if _flush is None:
        _flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        _flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def full_width_cfg() -> Config:
    """Default widths (12-layer MPNet at 768, 706 answers, text length 100,
    capacities 49152..3072, extent 512x512x256) with the slice's sparse
    switches."""
    return apply_overrides(Config(), [
        "data.num_answers=706", "sparse.conv0_zwin=false",
        "sparse.fused_conv=true", "sparse.pallas_map=true",
        "sparse.pallas_map_bits=true", "sparse.dense_lookup=true",
        "sparse.dense_downsample=true", "sparse.final_result=false"])


def small_cfg() -> Config:
    return apply_overrides(Config(), [
        "lang.num_layers=2", "lang.hidden_size=64", "lang.num_heads=4",
        "lang.intermediate_size=128", "model.hidden_size=64",
        "model.mcan_num_heads=4", "model.mcan_num_layers=1",
        "model.mcan_flat_mlp_size=32", "model.mcan_flat_out_size=48",
        "model.num_scene_tokens=32", "model.scene_feat_dim=48",
        "sparse.planes=8,16,24,48,24,24,16,16", "sparse.init_dim=8",
        "sparse.bottleneck_channels=48",
        "sparse.capacities=4096,2048,1024,512,256", "data.voxel_size=0.08",
        "sparse.grid_extent=(128,128,64)", "data.num_answers=12",
        "data.max_text_len=24"])


# ---------------------------------------------------------------------------

def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    _build.load_library()       # raises if a kernel does not build
    info = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
            "kernel_build_seconds": round(_build.build_seconds, 2)}
    emit("device", **info)
    return info


def _conv_classes(cfg):
    """(name, input level, map key, map level, C_in, C_out, launches per
    forward) for every class of conv on the encoder path."""
    sp = cfg.sparse
    out = [("conv0_k5", 0, "map_k5", 0, sp.in_channels, sp.init_dim, 1)]
    ch = sp.init_dim
    for i in range(1, 5):
        out.append((f"down{i}_k2", i - 1, "map_down", i, ch, ch, 1))
        p, n = sp.planes[i - 1], 2 * sp.layers[i - 1]
        if ch != p:
            out.append((f"level{i}_k3_{ch}to{p}", i, "map_k3", i, ch, p, 1))
            out.append((f"level{i}_k3_{p}to{p}", i, "map_k3", i, p, p, n - 1))
        else:
            out.append((f"level{i}_k3_{p}to{p}", i, "map_k3", i, p, p, n))
        ch = p
    return out


def phase_kernels(cfg, batch) -> dict:
    """Each kernel against its plain version on the card, at the main path's
    shapes, plus timings and bounds. Returns per-kernel records (without the
    main path's launch counts)."""
    dev = torch.device(DEV)
    extent = tuple(cfg.sparse.grid_extent)
    plan = build_unet_plan(batch["voxel_coords"], batch["voxel_mask"],
                           cfg.sparse.capacities, extent, device=dev)
    L = plan["levels"]
    B = batch["voxel_mask"].shape[0]
    records = {}

    # ---- the two map kernels --------------------------------------------
    for name in ("k3_map_lookup", "k3_map_lookup_bits"):
        records[name] = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "max_abs_err": 0, "shapes": []}
    for i in range(1, 5):
        s = STRIDES[i]
        cells = tuple(e // s for e in extent)
        n_cells = cells[0] * cells[1] * cells[2]
        V = L[i]["coords"].shape[1]
        out_cells = torch.div(L[i]["coords"], s, rounding_mode="floor")
        mask = L[i]["mask"]
        if map_lookup.map_lookup_fits(n_cells, cells[2]):
            name = "k3_map_lookup"
            grid, _ = build_level_grid(L[i]["coords"], mask, s, extent)
            args = (grid, out_cells, mask, cells, V)
            kern, plain = map_lookup.k3_map_lookup, map_lookup.k3_map_lookup_plain
            table_bytes, probe_bytes = grid.numel() * 4, 4
        elif map_bits.map_bits_fits(n_cells, cells[2]):
            name = "k3_map_lookup_bits"
            bits, pfx = map_bits.build_level_bits(L[i]["coords"], mask, s, extent)
            args = (bits, pfx, out_cells, mask, cells, V)
            kern, plain = (map_bits.k3_map_lookup_bits,
                           map_bits.k3_map_lookup_bits_plain)
            table_bytes, probe_bytes = 2 * bits.numel() * 4, 8
        else:
            fail(f"level {i} routes to neither map kernel")
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or not torch.equal(got, want):
            fail(f"{name} level {i}: kernel != plain version")
        if not torch.equal(got, L[i]["map_k3"]):
            fail(f"{name} level {i}: kernel != the plan's map")
        # in-extent probes of valid voxels = what this run's data reads
        probes = int(mask.sum()) * 27      # upper bound; extent edges are rare
        bytes_moved = (out_cells.numel() * 4 + mask.numel() + got.numel() * 4
                       + min(probes * probe_bytes, table_bytes))
        rec = records[name]
        ms, pms = time_cuda(lambda: kern(*args)), time_cuda(lambda: plain(*args))
        bound = bytes_moved / HBM_BYTES_PER_S * 1e3
        rec["ms"] += ms
        rec["plain_ms"] += pms
        rec["bound_ms"] += bound
        rec["shapes"].append({"level": i, "cells": list(cells), "B": B, "V": V,
                              "ms": round(ms, 4), "plain_ms": round(pms, 4),
                              "bound_ms": round(bound, 5), "exact": True})
        del args, got, want
    for name in ("k3_map_lookup", "k3_map_lookup_bits"):
        records[name]["bound_by"] = "bytes"

    # ---- the fused conv, every class of the encoder ---------------------
    g = torch.Generator(device=DEV).manual_seed(SEED)
    rec = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_ops_ms": 0.0,
           "bound_bytes_ms": 0.0, "max_abs_err": 0.0, "max_abs_err_f32": 0.0,
           "shapes": []}
    for name, lvl_in, key, lvl_map, c_in, c_out, count in _conv_classes(cfg):
        nbr = L[lvl_map][key]
        v_in, v_out, K = L[lvl_in]["coords"].shape[1], nbr.shape[1], nbr.shape[2]
        feats32 = (torch.randn(B, v_in, c_in, generator=g, device=dev)
                   * L[lvl_in]["mask"][..., None])
        w = torch.randn(K, c_in, c_out, generator=g, device=dev) / (K * c_in) ** 0.5
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            f = feats32.to(dt)
            got = fused_conv.fused_sparse_conv(f, nbr, w)
            want = fused_conv.fused_sparse_conv_plain(f, nbr, w)
            torch.cuda.synchronize()
            if got.dtype != torch.float32 or got.shape != (B, v_out, c_out):
                fail(f"fused_sparse_conv {name}: wrong output {got.dtype} {tuple(got.shape)}")
            errs[dt] = float((got - want).abs().max())
            if not errs[dt] <= CONV_ATOL:
                fail(f"fused_sparse_conv {name} {dt}: max abs err {errs[dt]} > {CONV_ATOL}")
        f = feats32.to(torch.bfloat16)
        ms = time_cuda(lambda: fused_conv.fused_sparse_conv(f, nbr, w))
        pms = time_cuda(lambda: fused_conv.fused_sparse_conv_plain(f, nbr, w), iters=3, warmup=1)
        hits = int(((nbr >= 0) & (nbr < v_in)).sum())
        ops_ms = 2.0 * hits * c_in * c_out / BF16_FLOPS * 1e3
        bytes_ms = (f.numel() * 2 + nbr.numel() * 4 + w.numel() * 2
                    + B * v_out * c_out * 4) / HBM_BYTES_PER_S * 1e3
        rec["ms"] += ms * count
        rec["plain_ms"] += pms * count
        rec["bound_ops_ms"] += ops_ms * count
        rec["bound_bytes_ms"] += bytes_ms * count
        rec["bound_ms"] += max(ops_ms, bytes_ms) * count
        rec["max_abs_err"] = max(rec["max_abs_err"], errs[torch.bfloat16])
        rec["max_abs_err_f32"] = max(rec["max_abs_err_f32"], errs[torch.float32])
        rec["shapes"].append({
            "name": name, "per_forward": count, "B": B, "V_in": v_in, "V_out": v_out,
            "K": K, "C_in": c_in, "C_out": c_out, "map_hits": hits,
            "hit_share": round(hits / nbr.numel(), 4), "ms": round(ms, 4),
            "plain_ms": round(pms, 4), "bound_ms": round(max(ops_ms, bytes_ms), 5),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "err_f32": errs[torch.float32], "err_bf16": errs[torch.bfloat16]})
        del feats32, f, w
    rec["bound_by"] = ("operations" if rec["bound_ops_ms"] > rec["bound_bytes_ms"]
                       else "bytes")
    records["fused_sparse_conv"] = rec
    emit("kernels", conv_atol=CONV_ATOL, timing="CUDA events, L2 evicted before each call",
         kernels={k: {kk: (round(vv, 5) if isinstance(vv, float) else vv)
                      for kk, vv in v.items()} for k, v in records.items()})
    return records


def phase_forward(cfg, batch):
    dev = torch.device(DEV)
    B = batch["voxel_mask"].shape[0]
    model = SIG3D(cfg, num_answers=cfg.data.num_answers, dtype=torch.bfloat16,
                  device=dev)
    init_random_weights(model, SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.inference_mode():
        reset_counts()                       # just before the main path ...
        out = model(batch, generator=gen)
        torch.cuda.synchronize()
        counts = read_counts()               # ... and just after
        scores = out["answer_scores"]
        if tuple(scores.shape) != (B, cfg.data.num_answers) or scores.dtype != torch.float32:
            fail(f"answer_scores has shape {tuple(scores.shape)} {scores.dtype}")
        for k in ("answer_scores", "aux_scores", "auxiliary_task_loc_gt",
                  "scene_positions", "att_feat_pre"):
            if not bool(torch.isfinite(out[k].float()).all()):
                fail(f"forward output {k} is not finite")
        expected = {"fused_sparse_conv": 1 + 4 + 2 * sum(cfg.sparse.layers[:4]),
                    "k3_map_lookup": 3, "k3_map_lookup_bits": 1}
        if counts != expected:
            fail(f"kernel launches on one forward {counts} != expected {expected}")
        for _ in range(2):
            model(batch, generator=gen)
        torch.cuda.synchronize()
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            model(batch, generator=gen)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
    emit("forward", batch_size=B, dtype="bfloat16",
         answer_scores_shape=list(scores.shape), finite=True,
         overflow={k: int(v) for k, v in out.items() if k.startswith("overflow/")},
         launches_per_forward=counts, seconds_per_forward=round(dt, 5),
         samples_per_s=round(B / dt, 3),
         peak_memory_gb=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    return model, counts


def phase_serving(cfg, model, batch):
    """Two scenes encoded once each, six questions per scene; each scene's
    first answer is held against the full forward on the same question and
    the same sampling draws."""
    n_scenes, n_q = 2, 6
    L = cfg.data.max_text_len
    rng = np.random.RandomState(SEED + 2)
    gen = torch.Generator().manual_seed(SEED + 3)
    cache = SceneCache(model, device=DEV)
    worst = 0.0
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answers = []
    for s in range(n_scenes):
        scene = {k: v[s:s + 1] for k, v in batch.items() if k.startswith("voxel_")}
        draws = make_sample_draws(1, cfg.sparse.capacities[-1],
                                  cfg.model.num_scene_tokens, gen, DEV)
        sid = f"scene{s}"
        cache.encode(sid, scene, sample_draws=draws)
        q = {"s_ids": batch["s_ids"][s:s + 1].expand(n_q, L),
             "s_mask": batch["s_mask"][s:s + 1].expand(n_q, L),
             "q_ids": torch.as_tensor(rng.randint(4, 30000, (n_q, L)).astype(np.int32)),
             "q_mask": batch["q_mask"][s:s + 1].expand(n_q, L),
             "auxiliary_task": batch["auxiliary_task"][s:s + 1].expand(n_q, 7)}
        answers.append((sid, scene, draws, q, cache.answer(sid, q)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    with torch.inference_mode():
        for sid, scene, draws, q, ans in answers:
            if tuple(ans["answer_scores"].shape) != (n_q, cfg.data.num_answers) \
                    or not bool(torch.isfinite(ans["answer_scores"]).all()):
                fail("serving answers have the wrong shape or are not finite")
            one = {k: v[:1] for k, v in q.items()}
            full = model({**scene, **one}, sample_draws=draws)["answer_scores"][0]
            first = cache.answer(sid, one)["answer_scores"][0]
            scale = max(1.0, float(full.abs().max()))
            worst = max(worst, float((first - full).abs().max()) / scale)
            worst = max(worst, float((ans["answer_scores"][0] - full).abs().max()) / scale)
    if not worst <= SERVE_RTOL:
        fail(f"serving answers differ from the full forward: {worst} > {SERVE_RTOL}")
    emit("serving", scenes=n_scenes, questions_per_scene=n_q,
         max_rel_diff_vs_full_forward=worst, tolerance=SERVE_RTOL,
         launches=counts, seconds=round(dt, 4),
         questions_per_s=round(n_scenes * n_q / dt, 3))


def phase_reference():
    """A small float32 model: the card's forward (CUDA kernels) against the
    same weights, inputs and draws on the CPU (plain versions)."""
    cfg = small_cfg()
    rng = np.random.RandomState(SEED + 4)
    batch_cpu, _, _ = make_scene_batch(cfg, 2, rng, device="cpu")
    cpu = SIG3D(cfg, cfg.data.num_answers, torch.float32, device="cpu")
    init_random_weights(cpu, SEED + 5)
    gpu = SIG3D(cfg, cfg.data.num_answers, torch.float32, device=DEV)
    gpu.load_state_dict(cpu.state_dict())
    draws = make_sample_draws(2, cfg.sparse.capacities[-1],
                              cfg.model.num_scene_tokens,
                              torch.Generator().manual_seed(SEED + 6))
    with torch.inference_mode():
        reset_counts()
        want = cpu(batch_cpu, sample_draws=draws)
        if any(read_counts().values()):
            fail("a CPU forward launched a CUDA kernel")
        got = gpu(batch_cpu, sample_draws=draws)
        torch.cuda.synchronize()
    errs = {}
    for k in ("answer_scores", "aux_scores", "auxiliary_task_loc_gt", "scene_positions"):
        errs[k] = float((got[k].cpu().float() - want[k].float()).abs().max())
        if not errs[k] <= SMALL_ATOL:
            fail(f"small-model {k}: card vs CPU max abs err {errs[k]} > {SMALL_ATOL}")
    emit("reference", what="small f32 SIG3D, CUDA kernels vs plain versions on the CPU",
         atol=SMALL_ATOL, max_abs_err=errs, launches=read_counts())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", help="comma-separated subset of: "
                    "device,kernels,forward,serving,reference")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on a CUDA device and has no CPU fallback",
              file=sys.stderr)
        return 1
    phases = [p for p in args.only.split(",") if p] or \
        ["device", "kernels", "forward", "serving", "reference"]
    full_run = not args.only
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products stay f32

    info = phase_device()
    cfg = full_width_cfg()
    batch, _, _ = make_scene_batch(cfg, BATCH, np.random.RandomState(SEED), DEV)
    records, counts, model = {}, {}, None
    if "kernels" in phases:
        records = phase_kernels(cfg, batch)
    if "forward" in phases or "serving" in phases:
        model, counts = phase_forward(cfg, batch)
    if "serving" in phases:
        phase_serving(cfg, model, batch)
    del model
    if "reference" in phases:
        phase_reference()
    if not full_run:
        return 0

    sources = {"fused_sparse_conv": ("situation3d_tpu_torch/csrc/fused_conv.cu",
                                     "situation3d_tpu/ops/pallas/fused_conv.py:192"),
               "k3_map_lookup": ("situation3d_tpu_torch/csrc/map_lookup.cu",
                                 "situation3d_tpu/ops/pallas/map_lookup.py:80"),
               "k3_map_lookup_bits": ("situation3d_tpu_torch/csrc/map_bits.cu",
                                      "situation3d_tpu/ops/pallas/map_bits.py:161")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = records[name]
        if counts.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "per": "sum over this kernel's launches in one B=%d forward" % BATCH})
    print(info["card"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
