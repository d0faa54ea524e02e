#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``situation3d_tpu_torch``) on one
NVIDIA GPU: builds the CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version at the shapes the main paths give it,
then drives the port's main paths — the full-width SIG3D scene-QA forward, a
few optimizer steps of the trainer in both training configurations (scene
encoder frozen, and trained too), the scene-cache serving form, and the
full-width VoteNet detection path (forward, boxes and mAP, detection loss and
its gradients) — and checks what comes out.

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
that hits a voxel in THIS run's maps. The row gather and the scatter-add
do no arithmetic to speak of: the gather reads each distinct table row that
THIS run's indices select once (not the whole table), the scatter-add its
whole source; indices read once, output written once. Farthest point
sampling reads the coordinates once and writes the indices once and does
about 10 float32 operations a point a step (67 TFLOP/s peak); both bounds lie
far below its time, because its npoint-1 steps depend on each other: it is
bound by the latency of a step.

Launch counts. ``launches`` of the conv and the two map kernels are read
around one forward, those of ``gather_rows`` and ``scatter_add_rows`` around
one training step with the scene encoder unfrozen (the path that runs the
conv backward), those of ``fps`` around one VoteNet forward; the counters are
set to 0 just before and read just after.
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
from situation3d_tpu_torch.data.scannet_preprocess import ScannetDatasetConfig
from situation3d_tpu_torch.data.synthetic import (make_detection_batch,
                                                  make_scene_batch)
from situation3d_tpu_torch.eval.detection import (APCalculator,
                                                  parse_groundtruths,
                                                  parse_predictions)
from situation3d_tpu_torch.eval.serving import SceneCache
from situation3d_tpu_torch.models.sig3d import (SIG3D, init_random_weights,
                                                make_sample_draws)
from situation3d_tpu_torch.models.votenet import VoteNet
from situation3d_tpu_torch.ops import pointnet2
from situation3d_tpu_torch.ops.cuda import (_build, fps, fused_conv,
                                            gather_rows, map_bits, map_lookup)
from situation3d_tpu_torch.ops.voxelize import voxelize_torch
from situation3d_tpu_torch.sparse import conv as sparse_conv
from situation3d_tpu_torch.sparse.kernel_map import build_level_grid
from situation3d_tpu_torch.sparse.minkunet import STRIDES, build_unet_plan
from situation3d_tpu_torch.train.detection_losses import get_detection_loss
from situation3d_tpu_torch.train.losses import get_loss
from situation3d_tpu_torch.train.trainer import create_train_state, train_step

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12     # float32 outside the tensor cores
CONV_ATOL = 2e-4      # f32 accumulation in another order; outputs are O(1)
SERVE_RTOL = 1e-2     # bf16 rounding (2^-8) when the same question is answered in a batch of 6
SERVE_SAME_RTOL = 0.0  # same question, same batch size: pooling is deterministic, bit-equal
SMALL_ATOL = 1e-3     # f32 small model, card (kernels) vs CPU (plain versions)
SEED = 0
BATCH = 8
DEV = "cuda"   # every phase runs here; there is no CPU mode
SUM_ATOL = 1e-5       # scatter-add: the same f32 sums in another order
GRAD_RTOL = 1e-4      # conv dx/dW vs plain autograd, relative to the largest value
GRAD_RTOL_BF16 = 2e-2  # with bf16 inputs: dx, and the plain version's dW, round to bf16
# kernel name -> (module, name of its launch counter)
KERNEL_COUNTERS = {"fused_sparse_conv": (fused_conv, "launches"),
                   "k3_map_lookup": (map_lookup, "launches"),
                   "k3_map_lookup_bits": (map_bits, "launches"),
                   "gather_rows": (gather_rows, "gather_launches"),
                   "scatter_add_rows": (gather_rows, "scatter_launches"),
                   "fps": (fps, "launches")}
DET_POINTS = 40000    # points a scene on the detection path
DET_NPOINTS = (2048, 1024, 512, 256)
DET_PROPOSALS = 128


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def reset_counts() -> None:
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNEL_COUNTERS.items()}


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


def _tmap_of(L, lvl_in, key, lvl_map):
    """(transpose map, flip_kernel) the encoder hands the conv class: its own
    map for the same-coords k5/k3 convs, the finer level's ``map_up`` for a
    k2 down conv."""
    if key == "map_down":
        return L[lvl_in]["map_up"], False
    return L[lvl_map][key], True


def _rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()) / max(1.0, float(want.abs().max()))


def check_gather_scatter(cfg, L, B, records) -> None:
    """``gather_rows`` and ``scatter_add_rows`` against their plain versions
    at every shape one unfrozen training step gives them, with times, the
    bytes bound and the one PyTorch call that computes the same function."""
    dev = torch.device(DEV)
    g = torch.Generator(device=DEV).manual_seed(SEED + 10)
    grec = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "max_abs_err": 0.0, "bound_by": "bytes", "library": "index_select",
            "shapes": []}

    def one_gather(name, table, idx, count):
        got = gather_rows.gather_rows(table, idx)
        want = gather_rows.gather_rows_plain(table, idx)
        torch.cuda.synchronize()
        if got.dtype != table.dtype or not torch.equal(got, want):
            fail(f"gather_rows {name}: kernel != plain version")
        Bt, V, C = table.shape
        flat_table = table.reshape(Bt * V, C)
        flat_idx = (idx.to(torch.int64)
                    + torch.arange(Bt, device=dev)[:, None] * V).reshape(-1)
        ms = time_cuda(lambda: gather_rows.gather_rows(table, idx))
        pms = time_cuda(lambda: gather_rows.gather_rows_plain(table, idx))
        lms = time_cuda(lambda: flat_table.index_select(0, flat_idx))
        # a gather reads only the rows it selects: count this run's distinct ones
        seen = torch.zeros(Bt * V, dtype=torch.bool, device=dev)
        seen[flat_idx] = True
        rows_read = int(seen.sum())
        del seen
        bound = (rows_read * C * table.element_size() + idx.numel() * 4
                 + got.numel() * got.element_size()) / HBM_BYTES_PER_S * 1e3
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                     ("bound_ms", bound)):
            grec[k] += v * count
        grec["shapes"].append({
            "name": name, "per_step": count, "table": list(table.shape),
            "R": idx.shape[1], "rows_read": rows_read,
            "dtype": str(table.dtype).split(".")[-1],
            "ms": round(ms, 4), "plain_ms": round(pms, 4),
            "library_ms": round(lms, 4), "bound_ms": round(bound, 5), "exact": True})

    # the dy-gathers of the conv backward: one launch per chunk of offsets
    for name, lvl_in, key, lvl_map, c_in, c_out, count in _conv_classes(cfg):
        t_map, _ = _tmap_of(L, lvl_in, key, lvl_map)
        v_in, K = t_map.shape[1], t_map.shape[2]
        v_out = L[lvl_map]["coords"].shape[1]
        dy = torch.randn(B, v_out + 1, c_out, generator=g, device=dev).bfloat16()
        safe = torch.where((t_map >= 0) & (t_map < v_out), t_map, v_out)
        for j0, j1 in sparse_conv._offset_chunks(K, B * v_in * c_out * 2):
            idx = safe[:, :, j0:j1].reshape(B, v_in * (j1 - j0)).contiguous()
            one_gather(f"{name}_dW[{j0}:{j1}]", dy, idx, count)
            del idx
        del dy, safe

    # token pooling: the bottleneck's (x, y) columns and a token sample
    bott = L[-1]
    V4, C, N = bott["coords"].shape[1], cfg.model.scene_feat_dim, cfg.model.num_scene_tokens
    xy3 = torch.div(bott["coords"], STRIDES[-1], rounding_mode="floor").clone()
    xy3[..., 2] = 0
    _, _, inv, nu = voxelize_torch(xy3, bott["mask"], capacity=V4)
    inv = torch.where(bott["mask"], inv, -1)      # as situated_token_pool does
    token_idx = (torch.rand(B, N, generator=g, device=dev)
                 * nu.clamp(min=1)[:, None]).to(torch.int32)
    mean = torch.randn(B, V4, C, generator=g, device=dev)
    one_gather("token_gather", mean, token_idx, 1)
    one_gather("segment_sum_backward", mean, inv.clamp(min=0), 1)

    srec = {"ms": 0.0, "kernel_only_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "library_ms": 0.0, "max_abs_err": 0.0, "bound_by": "bytes",
            "library": "index_add_ (float atomics, not deterministic)",
            "bit_equal_across_runs": True, "shapes": []}

    def one_scatter(name, src, idx, V, count):
        got = gather_rows.scatter_add_rows(src, idx, V)
        again = gather_rows.scatter_add_rows(src, idx, V)
        want = gather_rows.scatter_add_rows_plain(src, idx, V)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"scatter_add_rows {name}: two runs are not bit-equal")
        err = float((got - want).abs().max())
        if got.dtype != torch.float32 or not err <= SUM_ATOL:
            fail(f"scatter_add_rows {name}: max abs err {err} > {SUM_ATOL}")
        Bs, R, Cs = src.shape
        # the library call: dropped entries (index -1) go to a spare row
        flat_idx = (torch.where((idx >= 0) & (idx < V), idx, V).to(torch.int64)
                    + torch.arange(Bs, device=dev)[:, None] * (V + 1)).reshape(-1)
        flat_src = src.float().reshape(Bs * R, Cs)
        acc = torch.empty(Bs * (V + 1), Cs, device=dev)
        plan = gather_rows.sort_segments(idx, V)
        longest = int((plan[1][:, 1:] - plan[1][:, :-1]).max())
        ms = time_cuda(lambda: gather_rows.scatter_add_rows(src, idx, V))
        kms = time_cuda(lambda: gather_rows.scatter_add_rows(src, idx, V, plan))
        pms = time_cuda(lambda: gather_rows.scatter_add_rows_plain(src, idx, V))
        lms = time_cuda(lambda: acc.zero_().index_add_(0, flat_idx, flat_src))
        bound = (src.numel() * src.element_size() + idx.numel() * 4
                 + got.numel() * 4) / HBM_BYTES_PER_S * 1e3
        for k, v in (("ms", ms), ("kernel_only_ms", kms), ("plain_ms", pms),
                     ("library_ms", lms), ("bound_ms", bound)):
            srec[k] += v * count
        srec["max_abs_err"] = max(srec["max_abs_err"], err)
        srec["shapes"].append({
            "name": name, "per_step": count, "src": list(src.shape), "V": V,
            "longest_segment": longest,
            "ms": round(ms, 4), "kernel_only_ms": round(kms, 4),
            "plain_ms": round(pms, 4), "library_ms": round(lms, 4),
            "bound_ms": round(bound, 5), "err": err})

    feats = torch.randn(B, V4, C, generator=g, device=dev) * bott["mask"][..., None]
    one_scatter("segment_sums", feats, inv, V4, 1)
    one_scatter("segment_counts", bott["mask"].float()[..., None], inv, V4, 1)
    one_scatter("token_gather_backward",
                torch.randn(B, N, C, generator=g, device=dev), token_idx, V4, 1)
    # the bf16 instance of the kernel (the gradient of a gather from a bf16
    # table); no step of the default model runs it, so it adds to no total
    one_scatter("segment_sums_bf16", feats.bfloat16(), inv, V4, 0)
    records["gather_rows"], records["scatter_add_rows"] = grec, srec


def check_conv_backward(cfg, L, B, records) -> None:
    """The conv ``Function``'s ``dx`` / ``dW`` on the card against plain
    autograd through ``fused_sparse_conv_plain``, every conv class; times the
    backward in bf16 and, alone, the ``dx`` launch of the forward kernel."""
    dev = torch.device(DEV)
    g = torch.Generator(device=DEV).manual_seed(SEED + 11)
    rec = {"ms": 0.0, "plain_ms": 0.0, "dx_ms": 0.0, "max_rel_err_f32": 0.0,
           "max_rel_err_bf16": 0.0, "shapes": []}
    classes = [c + (True,) for c in _conv_classes(cfg)]
    # the scatter form (no transpose map): the UNet never takes it, so it is
    # held to the plain version here on the deepest class and adds to no total
    last = classes[-1]
    classes.append((last[0] + "_no_map",) + last[1:6] + (0, False))
    for name, lvl_in, key, lvl_map, c_in, c_out, count, with_map in classes:
        nbr = L[lvl_map][key]
        t_map, flip = _tmap_of(L, lvl_in, key, lvl_map)
        v_in, v_out, K = L[lvl_in]["coords"].shape[1], nbr.shape[1], nbr.shape[2]
        want_dx = name != "conv0_k5"          # conv0's input needs no gradient

        def conv(f, w):
            if with_map:
                return sparse_conv._SparseConvTmap.apply(f, nbr, t_map, w, flip)
            return sparse_conv.sparse_conv_apply(f, nbr, w)
        f32 = (torch.randn(B, v_in, c_in, generator=g, device=dev)
               * L[lvl_in]["mask"][..., None])
        w = (torch.randn(K, c_in, c_out, generator=g, device=dev)
             / (K * c_in) ** 0.5).requires_grad_()
        cot32 = (torch.randn(B, v_out, c_out, generator=g, device=dev)
                 * L[lvl_map]["mask"][..., None])
        errs = {}
        for dt, tol in ((torch.float32, GRAD_RTOL), (torch.bfloat16, GRAD_RTOL_BF16)):
            f = f32.to(dt).requires_grad_(want_dx)
            cot = cot32.to(dt)
            wrt = (f, w) if want_dx else (w,)
            out = conv(f, w)
            got = torch.autograd.grad(out, wrt, cot)
            ref = fused_conv.fused_sparse_conv_plain(f, nbr, w)
            want = torch.autograd.grad(ref, wrt, cot.float())
            torch.cuda.synchronize()
            errs[dt] = max(_rel_err(a, b) for a, b in zip(got, want))
            if got[-1].dtype != torch.float32:
                fail(f"conv backward {name} {dt}: dW comes back as {got[-1].dtype}")
            if not errs[dt] <= tol:
                fail(f"conv backward {name} {dt}: rel err {errs[dt]} > {tol}")
            del out, ref, got, want
        f = f32.bfloat16().requires_grad_(want_dx)
        cot = cot32.bfloat16()
        wrt = (f, w) if want_dx else (w,)
        out = conv(f, w)
        ms = time_cuda(lambda: torch.autograd.grad(out, wrt, cot, retain_graph=True))
        ref = fused_conv.fused_sparse_conv_plain(f, nbr, w)
        cot_f = cot.float()
        pms = time_cuda(lambda: torch.autograd.grad(ref, wrt, cot_f, retain_graph=True),
                        iters=3, warmup=1)
        dx_ms = 0.0
        if want_dx and with_map:
            wt = (w.detach().flip(0) if flip else w.detach()).transpose(1, 2)
            dx_ms = time_cuda(lambda: fused_conv.fused_sparse_conv(cot, t_map, wt))
        rec["ms"] += ms * count
        rec["plain_ms"] += pms * count
        rec["dx_ms"] += dx_ms * count
        rec["max_rel_err_f32"] = max(rec["max_rel_err_f32"], errs[torch.float32])
        rec["max_rel_err_bf16"] = max(rec["max_rel_err_bf16"], errs[torch.bfloat16])
        rec["shapes"].append({
            "name": name, "per_step": count, "dx": want_dx, "backward_ms": round(ms, 4),
            "plain_backward_ms": round(pms, 4), "dx_ms": round(dx_ms, 4),
            "err_f32": errs[torch.float32], "err_bf16": errs[torch.bfloat16]})
        del f32, w, cot32, f, cot, out, ref
    records["conv_backward"] = rec


_detection = None


def detection_setup():
    """(dataset config, the full-width ``VoteNet`` with seeded random
    weights, the synthetic detection batch: 8 scenes of 40,000 points), made
    once and shared by the ``kernels`` and ``detection`` phases."""
    global _detection
    if _detection is None:
        dcfg = ScannetDatasetConfig()
        batch = make_detection_batch(BATCH, DET_POINTS, np.random.RandomState(SEED + 20), DEV)
        model = VoteNet(dcfg.num_class, dcfg.num_heading_bin, dcfg.num_size_cluster,
                        dcfg.mean_size_arr, num_proposal=DET_PROPOSALS,
                        backbone_npoints=DET_NPOINTS, device=DEV)
        init_random_weights(model, SEED + 21, std=None)
        _detection = (dcfg, model, batch)
    return _detection


def check_fps(records) -> None:
    """``fps`` against ``fps_plain`` on the card, every index equal: at the
    five shapes of one full-width VoteNet forward, on that forward's own
    point sets (the cloud, its three successive samples, the votes), and on
    the edge cases; times per shape, bound, plain ms."""
    dcfg, model, batch = detection_setup()
    g = torch.Generator(device=DEV).manual_seed(SEED + 12)
    xyz = batch["point_clouds"]
    with torch.inference_mode():
        votes = model(xyz)["vote_xyz"]
    sets, cur = [], xyz
    for i, m in enumerate(DET_NPOINTS):
        sets.append((f"sa{i + 1}", cur, m))
        cur = pointnet2.gather_points(cur, fps.fps(cur, m))
    sets.append(("vote_aggregation", votes, DET_PROPOSALS))
    rec = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_bytes_ms": 0.0,
           "bound_ops_ms": 0.0, "max_abs_err": 0, "shapes": [], "edge_cases": []}
    for name, pts, m in sets:
        got, want = fps.fps(pts, m), fps.fps_plain(pts, m)
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or not torch.equal(got, want):
            bad = int((got != want).any(0).nonzero()[0])
            fail(f"fps {name} {list(pts.shape)} -> {m}: kernel != plain version "
                 f"from sample {bad} on")
        Bp, Np, _ = pts.shape
        ms = time_cuda(lambda: fps.fps(pts, m))
        pms = time_cuda(lambda: fps.fps_plain(pts, m), iters=1, warmup=0)
        bytes_ms = (pts.numel() * 4 + got.numel() * 4) / HBM_BYTES_PER_S * 1e3
        ops_ms = 10.0 * (m - 1) * Np * Bp / F32_FLOPS * 1e3
        rec["ms"] += ms
        rec["plain_ms"] += pms
        rec["bound_bytes_ms"] += bytes_ms
        rec["bound_ops_ms"] += ops_ms
        rec["bound_ms"] += max(bytes_ms, ops_ms)
        rec["shapes"].append({
            "name": name, "xyz": list(pts.shape), "npoint": m, "ms": round(ms, 4),
            "us_per_step": round(ms * 1e3 / (m - 1), 3), "plain_ms": round(pms, 3),
            "bound_ms": round(max(bytes_ms, ops_ms), 5),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes", "exact": True})
    rec["bound_by"] = "operations" if rec["bound_ops_ms"] > rec["bound_bytes_ms"] else "bytes"
    rec["note"] = ("npoint-1 dependent steps: bound by the latency of a step, far above "
                   "both roofline bounds")

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=DEV)

    lattice = torch.stack(torch.meshgrid(*[torch.arange(22.0, device=DEV)] * 3,
                                         indexing="ij"), -1).reshape(1, -1, 3) + 1.0
    origin = rand(3, 3000, 3) * 4 + 0.5
    origin[0, 100:900] = 0.0
    origin[1, 0] = 0.0
    empty = rand(2, 9000, 3) + 0.5
    empty[1] = 0.0
    few = torch.zeros(2, 9001, 3, device=DEV)
    few[:, [7, 500, 8999]] = rand(2, 3, 3) + 1.0
    edge = [
        ("valid_mask_long_row", xyz, 64, rand(BATCH, DET_POINTS) > 0.5),
        ("valid_mask_short_row", sets[1][1], 64, rand(BATCH, DET_NPOINTS[0]) > 0.5),
        ("rows_at_the_origin", origin, 96, None),
        ("n_not_a_multiple_of_32", rand(2, 1000, 3) * 3 + 0.5, 200, None),
        ("n_not_a_multiple_of_32_long_row", rand(2, 9001, 3) * 3 + 0.5, 100, None),
        ("integer_lattice_ties", lattice[:, :4096].contiguous(), 300, None),
        ("integer_lattice_ties_long_row", lattice, 300, None),
        ("nothing_selectable", empty, 32, None),
        ("npoint_above_selectable", few, 16, None),
        ("npoint_above_n", rand(2, 20, 3) + 0.5, 48, None),
        ("one_sample", rand(3, 100, 3) + 0.5, 1, None),
        ("non_contiguous", (rand(2, 3, 700) + 0.5).transpose(1, 2), 50, None),
    ]
    for name, pts, m, valid in edge:
        got, want = fps.fps(pts, m, valid), fps.fps_plain(pts, m, valid)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"fps edge case {name}: kernel != plain version")
        rec["edge_cases"].append(name)
    if not bool((fps.fps(empty, 32)[1] == 0).all()):
        fail("fps: a row with nothing selectable must repeat index 0")
    for bad_call in (lambda: fps.fps(xyz.double(), 4), lambda: fps.fps(xyz[0], 4),
                     lambda: fps.fps(xyz[:, :0], 4), lambda: fps.fps(xyz, 0)):
        try:
            bad_call()
        except (TypeError, ValueError):
            continue
        fail("fps: the wrapper took an argument it must refuse")
    records["fps"] = rec


def check_detection_gathers(records) -> None:
    """``gather_rows`` / ``scatter_add_rows`` at the shapes the VoteNet path
    adds (12-byte coordinate rows, float32 feature rows, ``M * nsample``
    indices with many repeats): gather exact, scatter-add within ``SUM_ATOL``
    of the largest sum, two runs bit-equal. Times stand beside the SIG3D
    path's totals, not in them."""
    _, _, batch = detection_setup()
    g = torch.Generator(device=DEV).manual_seed(SEED + 13)
    xyz = batch["point_clouds"]
    inds = fps.fps(xyz, DET_NPOINTS[0])
    xyz1 = pointnet2.gather_points(xyz, inds)
    idx1 = pointnet2.ball_query(0.2, 64, xyz, xyz1)
    xyz2 = pointnet2.gather_points(xyz1, fps.fps(xyz1, DET_NPOINTS[1]))
    idx2 = pointnet2.ball_query(0.4, 32, xyz1, xyz2)
    f1 = torch.randn(BATCH, DET_NPOINTS[0], 128, generator=g, device=DEV)
    _, nn_idx = pointnet2.three_nn(xyz1, xyz2)
    f2 = torch.randn(BATCH, DET_NPOINTS[1], 256, generator=g, device=DEV)
    shapes = []
    for name, table, idx in (("sa1_centres", xyz, inds),
                             ("sa1_group_xyz", xyz, idx1.flatten(1)),
                             ("sa2_group_features", f1, idx2.flatten(1)),
                             ("fp_interpolate", f2, nn_idx.flatten(1))):
        idx = idx.contiguous()
        got = gather_rows.gather_rows(table, idx)
        want = gather_rows.gather_rows_plain(table, idx)
        if not torch.equal(got, want):
            fail(f"gather_rows {name}: kernel != plain version")
        V = table.shape[1]
        src = torch.randn(got.shape, generator=g, device=DEV)
        back = gather_rows.scatter_add_rows(src, idx, V)
        again = gather_rows.scatter_add_rows(src, idx, V)
        ref = gather_rows.scatter_add_rows_plain(src, idx, V)
        torch.cuda.synchronize()
        if not torch.equal(back, again):
            fail(f"scatter_add_rows {name}: two runs are not bit-equal")
        err, scale = float((back - ref).abs().max()), max(1.0, float(ref.abs().max()))
        if not err <= SUM_ATOL * scale:
            fail(f"scatter_add_rows {name}: max abs err {err} > {SUM_ATOL} x {scale}")
        plan = gather_rows.sort_segments(idx, V)
        shapes.append({
            "name": name, "table": list(table.shape), "R": idx.shape[1],
            "gather_ms": round(time_cuda(lambda: gather_rows.gather_rows(table, idx)), 4),
            "gather_plain_ms": round(time_cuda(
                lambda: gather_rows.gather_rows_plain(table, idx)), 4),
            "scatter_add_ms": round(time_cuda(
                lambda: gather_rows.scatter_add_rows(src, idx, V)), 4),
            "scatter_add_plain_ms": round(time_cuda(
                lambda: gather_rows.scatter_add_rows_plain(src, idx, V)), 4),
            "longest_segment": int((plan[1][:, 1:] - plan[1][:, :-1]).max()),
            "scatter_add_err": err, "largest_sum": scale})
    records["detection_gathers"] = {"shapes": shapes}


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
    check_gather_scatter(cfg, L, B, records)
    check_conv_backward(cfg, L, B, records)
    del plan, L
    check_fps(records)
    check_detection_gathers(records)
    emit("kernels", conv_atol=CONV_ATOL, sum_atol=SUM_ATOL, grad_rtol=GRAD_RTOL,
         grad_rtol_bf16=GRAD_RTOL_BF16, timing="CUDA events, L2 evicted before each call",
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
                    "k3_map_lookup": 3, "k3_map_lookup_bits": 1,
                    "gather_rows": 1, "scatter_add_rows": 2,   # token pooling
                    "fps": 0}
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


def _expected_train_counts(cfg, unfrozen: bool) -> dict:
    """Kernel launches of one training step. Forward: 21 convs, 3 + 1 map
    kernels, 1 token gather, 2 segment sums (features, counts). An unfrozen
    encoder adds, backward: 20 convs as ``dx`` (conv0's input needs none), one
    dy-gather per chunk of offsets per conv for ``dW``, the gather that is the
    segment sum's backward and the scatter-add that is the token gather's."""
    n_conv = 1 + 4 + 2 * sum(cfg.sparse.layers[:4])
    exp = {"fused_sparse_conv": n_conv, "k3_map_lookup": 3, "k3_map_lookup_bits": 1,
           "gather_rows": 1, "scatter_add_rows": 2, "fps": 0}
    if unfrozen:
        B = BATCH
        chunks = 0
        for name, lvl_in, key, _, _, c_out, count in _conv_classes(cfg):
            K = {"map_k5": 125, "map_down": 8, "map_k3": 27}[key]
            v_in = cfg.sparse.capacities[lvl_in]
            chunks += count * len(sparse_conv._offset_chunks(K, B * v_in * c_out * 2))
        exp["fused_sparse_conv"] += n_conv - 1
        exp["gather_rows"] += chunks + 1
        exp["scatter_add_rows"] += 1
    return exp


def _backward_once(cfg, state, batch) -> dict:
    """Forward in training form + backward from the state as it stands,
    without an update and with the generators put back: the gradients of
    every conv kernel of the scene encoder."""
    gens = (state.sample_generator, state.dropout_generator)
    saved = [g.get_state() for g in gens]
    state.model.train()
    out = state.model(batch, generator=gens[0], train=True, dropout_generator=gens[1])
    loss, _ = get_loss(out, batch, cfg.loss, cfg.model.situation_loss_tag)
    state.optimizer.discard()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
             if n.startswith("scene_encoder") and n.endswith("kernel")}
    state.optimizer.discard()
    for g, st in zip(gens, saved):
        g.set_state(st)
    torch.cuda.synchronize()
    return grads


def phase_train(cfg, batch) -> dict:
    """Both training configurations at full width, B=8, bf16: 3 warm-up + 5
    timed optimizer steps each through ``train_step``. Returns the launch
    counts of the first unfrozen step."""
    warmup, timed = 3, 5
    report, unfrozen_counts = {}, {}
    for mode, extra in (("frozen", []), ("unfrozen", ["train.frozen_prefixes="])):
        tcfg = apply_overrides(cfg, extra)
        model = SIG3D(tcfg, num_answers=tcfg.data.num_answers, dtype=torch.bfloat16,
                      device=DEV)
        init_random_weights(model, SEED)
        state = create_train_state(tcfg, model, steps_per_epoch=1000, seed=SEED)
        trainable = {n for n, p in model.named_parameters() if p.requires_grad}
        enc = {n for n, _ in model.named_parameters() if n.startswith("scene_encoder")}
        if (mode == "frozen") != (not (enc & trainable)):
            fail(f"train {mode}: scene encoder trainable = {bool(enc & trainable)}")
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        deterministic = None
        if mode == "unfrozen":
            g1, g2 = _backward_once(tcfg, state, batch), _backward_once(tcfg, state, batch)
            if not g1 or any(not bool(torch.isfinite(g).all()) for g in g1.values()):
                fail("train unfrozen: conv gradients missing or not finite")
            if all(float(g.abs().max()) == 0.0 for g in g1.values()):
                fail("train unfrozen: every conv gradient is zero")
            diff = [n for n in g1 if not torch.equal(g1[n], g2[n])]
            if diff:
                fail(f"train unfrozen: conv gradients differ between two runs from "
                     f"one state: {diff[:4]}")
            deterministic = len(g1)
            del g1, g2
        losses = []
        reset_counts()                        # just before the main path ...
        m = train_step(tcfg, state, batch)
        torch.cuda.synchronize()
        counts = read_counts()                # ... and just after
        expected = _expected_train_counts(tcfg, mode == "unfrozen")
        if counts != expected:
            fail(f"train {mode}: kernel launches on one step {counts} != expected {expected}")
        losses.append(float(m["loss"]))
        for _ in range(warmup - 1):
            losses.append(float(train_step(tcfg, state, batch)["loss"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ms = [train_step(tcfg, state, batch) for _ in range(timed)]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / timed
        losses += [float(m["loss"]) for m in ms]
        if not all(np.isfinite(losses)) or any(float(m["grads_finite"]) != 1.0 for m in ms):
            fail(f"train {mode}: a loss is not finite: {losses}")
        moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
        if moved - trainable:
            fail(f"train {mode}: frozen parameters changed: {sorted(moved - trainable)[:4]}")
        still = [n for n in trainable - moved if before[n].dim() >= 2]
        if still:
            fail(f"train {mode}: trainable matrices did not move: {still[:4]}")
        if state.step != warmup + timed or state.optimizer.updates != warmup + timed:
            fail(f"train {mode}: {state.step} steps, {state.optimizer.updates} updates")
        report[mode] = {
            "steps": warmup + timed, "loss_first": losses[0], "loss_last": losses[-1],
            "trainable_tensors": len(trainable), "frozen_tensors": len(before) - len(trainable),
            "moved_tensors": len(moved), "frozen_bit_unchanged": True,
            "launches_per_step": counts, "seconds_per_step": round(dt, 5),
            "samples_per_s": round(BATCH / dt, 3),
            "peak_memory_gb": round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)}
        if deterministic is not None:
            report[mode]["conv_gradients_bit_equal_across_two_runs"] = deterministic
            unfrozen_counts = counts
        del model, state, before
        torch.cuda.empty_cache()
    emit("train", batch_size=BATCH, dtype="bfloat16", warmup_steps=warmup,
         timed_steps=timed, **report)
    return unfrozen_counts


def phase_serving(cfg, model, batch):
    """Two scenes encoded once each, six questions per scene; each scene's
    first answer is held against the full forward on the same question and
    the same sampling draws."""
    n_scenes, n_q = 2, 6
    L = cfg.data.max_text_len
    rng = np.random.RandomState(SEED + 2)
    gen = torch.Generator().manual_seed(SEED + 3)
    cache = SceneCache(model, device=DEV)
    worst = worst_same = 0.0
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
        with torch.inference_mode():       # two encodes of one scene: bit-equal
            t1, p1, _ = model.encode_scene(scene, draws)
            t2, p2, _ = model.encode_scene(scene, draws)
        if not (torch.equal(t1, t2) and torch.equal(p1, p2)):
            fail("two encodes of one scene differ: token pooling is not deterministic")
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
            worst_same = max(worst_same, float((first - full).abs().max()) / scale)
            worst = max(worst, float((ans["answer_scores"][0] - full).abs().max()) / scale)
    if not worst_same <= SERVE_SAME_RTOL:
        fail(f"serving (one question) differs from the full forward on the same "
             f"question: {worst_same} > {SERVE_SAME_RTOL}")
    if not worst <= SERVE_RTOL:
        fail(f"serving answers differ from the full forward: {worst} > {SERVE_RTOL}")
    emit("serving", scenes=n_scenes, questions_per_scene=n_q,
         two_encodes_bit_equal=True,
         max_rel_diff_same_batch_size=worst_same, tolerance_same_batch_size=SERVE_SAME_RTOL,
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
    # gradients of the same small model, encoder unfrozen, evaluation form
    # (dropout off, so both devices see the same function)
    tcfg = apply_overrides(cfg, ["train.frozen_prefixes=", "model.lang_freeze=none"])
    grads = {}
    for name, m in (("cpu", cpu), ("gpu", gpu)):
        create_train_state(tcfg, m, 10, seed=SEED)     # sets requires_grad
        b = m._to_device(batch_cpu)
        loss, _ = get_loss(m(b, sample_draws=draws), b, tcfg.loss,
                           tcfg.model.situation_loss_tag)
        loss.backward()
        grads[name] = {n: p.grad.detach().cpu() for n, p in m.named_parameters()
                       if p.grad is not None}
    torch.cuda.synchronize()
    if set(grads["cpu"]) != set(grads["gpu"]) or not grads["cpu"]:
        fail("small-model gradients: card and CPU reach different parameters")
    gerr, gname = max((float((grads["gpu"][n] - g).abs().max()), n)
                      for n, g in grads["cpu"].items())
    gmax = max(float(g.abs().max()) for g in grads["cpu"].values())
    if not gerr <= SMALL_ATOL * max(1.0, gmax):
        fail(f"small-model gradient {gname}: card vs CPU max abs err {gerr} > "
             f"{SMALL_ATOL} x max(1, {gmax})")
    emit("reference", what="small f32 SIG3D, CUDA kernels vs plain versions on the CPU",
         atol=SMALL_ATOL, max_abs_err=errs, gradients_compared=len(grads["cpu"]),
         gradient_max_abs_err=gerr, gradient_max_abs=gmax, launches=read_counts())


def _expected_detection_counts(backward: bool) -> dict:
    """Kernel launches of one VoteNet forward (and, with ``backward``, of the
    backward pass of the detection loss), worked out from the modules.
    Sampling: sa1..sa4 and the vote aggregation, one ``fps`` each. Gathers:
    a set-abstraction module gathers its centres, groups the coordinates and,
    where it is given features, groups those (sa1 has none: 2; sa2..sa4 and
    the vote aggregation: 3 each); each feature-propagation module gathers
    once for its interpolation (fp1, fp2). Backward: one scatter-add per
    gather whose table needs a gradient: the grouped features of sa2..sa4,
    the two interpolations, and all three gathers of the vote aggregation
    (the votes are computed by the network; the cloud is not)."""
    exp = {name: 0 for name in KERNEL_COUNTERS}
    exp["fps"] = 5
    exp["gather_rows"] = 2 + 3 * 3 + 2 + 3
    if backward:
        exp["scatter_add_rows"] = 3 + 2 + 3
    return exp


def _detection_backward(dcfg, model, batch):
    """Training-form forward + detection loss + backward from the state as
    it stands. Returns (loss, loss terms, gradients by parameter name)."""
    model.zero_grad(set_to_none=True)
    out = model(batch["point_clouds"], train=True)
    loss, parts = get_detection_loss({**out, **batch}, dcfg)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), parts, {n: p.grad.clone() for n, p in model.named_parameters()}


def phase_detection() -> dict:
    """The full-width VoteNet path, B=8, 40,000 points a scene, float32:
    evaluation-form forward -> boxes -> mAP, then the training form: detection
    loss and its gradients. Returns the launch counts of one forward."""
    dcfg, model, batch = detection_setup()
    xyz = batch["point_clouds"]
    B, N = xyz.shape[:2]
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_counts()                       # just before the main path ...
        out = model(xyz)
        torch.cuda.synchronize()
        counts = read_counts()               # ... and just after
        expected = _expected_detection_counts(backward=False)
        if counts != expected:
            fail(f"detection: kernel launches on one forward {counts} != expected {expected}")
        shapes = {"seed_xyz": (B, DET_NPOINTS[1], 3), "seed_inds": (B, DET_NPOINTS[1]),
                  "vote_xyz": (B, DET_NPOINTS[1], 3), "center": (B, DET_PROPOSALS, 3),
                  "objectness_scores": (B, DET_PROPOSALS, 2),
                  "size_residuals": (B, DET_PROPOSALS, dcfg.num_size_cluster, 3),
                  "sem_cls_scores": (B, DET_PROPOSALS, dcfg.num_class)}
        for k, shape in shapes.items():
            if tuple(out[k].shape) != shape:
                fail(f"detection: {k} has shape {tuple(out[k].shape)}, not {shape}")
        for k, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                fail(f"detection: output {k} is not finite")
        inds = out["seed_inds"]
        if inds.dtype != torch.int32 or int(inds.min()) < 0 or int(inds.max()) >= N:
            fail("detection: seed_inds outside the cloud")
        if not torch.equal(pointnet2.gather_points(xyz, inds), out["seed_xyz"]):
            fail("detection: seed_inds do not select seed_xyz")
        model(xyz)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            model(xyz)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        peak_eval = torch.cuda.max_memory_allocated() / 2 ** 30

    # boxes and mAP on the host, by the port's own evaluation code
    t0 = time.perf_counter()
    preds = parse_predictions({k: v.cpu().numpy() for k, v in out.items()}, dcfg)
    gts = parse_groundtruths({k: v.cpu().numpy() for k, v in batch.items()}, dcfg)
    calc = APCalculator(0.25, dcfg.class2type)
    calc.step(preds, gts)
    metrics = calc.compute_metrics()
    parse_s = time.perf_counter() - t0
    if len(preds) != B or not 0.0 <= metrics["mAP"] <= 1.0 or sum(map(len, gts)) == 0:
        fail(f"detection: AP flow gave {metrics}")

    # training form: batch statistics, loss, gradients
    stats_before = {n: b.clone() for n, b in model.named_buffers()
                    if n.endswith((".mean", ".var"))}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss, parts, g1 = _detection_backward(dcfg, model, batch)
    train_counts = read_counts()
    expected = _expected_detection_counts(backward=True)
    if train_counts != expected:
        fail(f"detection: kernel launches on forward + backward {train_counts} != "
             f"expected {expected}")
    peak_train = torch.cuda.max_memory_allocated() / 2 ** 30
    _, _, g2 = _detection_backward(dcfg, model, batch)
    terms = {k: float(v.detach()) for k, v in parts.items()}
    if not np.isfinite(float(loss)) or not all(np.isfinite(list(terms.values()))):
        fail(f"detection: loss is not finite: {float(loss)} {terms}")
    bad = [n for n, g in g1.items() if not bool(torch.isfinite(g).all())]
    zero = [n for n, g in g1.items() if float(g.abs().max()) == 0.0]
    if bad or zero:
        fail(f"detection: gradients not finite {bad[:4]} or all zero {zero[:4]}")
    diff = [n for n in g1 if not torch.equal(g1[n], g2[n])]
    if diff:
        fail(f"detection: gradients differ between two backward passes from one "
             f"state: {diff[:4]}")
    still = [n for n, b in model.named_buffers()
             if n in stats_before and torch.equal(b, stats_before[n])]
    if still or not stats_before:
        fail(f"detection: running batch-norm statistics did not move: {still[:4]}")
    t0 = time.perf_counter()
    for _ in range(2):
        _detection_backward(dcfg, model, batch)
    step_s = (time.perf_counter() - t0) / 2
    model.zero_grad(set_to_none=True)
    emit("detection", batch_size=B, points_per_scene=N, dtype="float32",
         backbone_npoints=list(DET_NPOINTS), proposals=DET_PROPOSALS, finite=True,
         launches_per_forward=counts, seconds_per_forward=round(dt, 5),
         scenes_per_s=round(B / dt, 3), peak_memory_gb_forward=round(peak_eval, 2),
         boxes_kept=sum(map(len, preds)), ground_truth_boxes=sum(map(len, gts)),
         mAP=metrics["mAP"], parse_and_ap_seconds=round(parse_s, 3),
         loss=float(loss), loss_terms=terms, parameters_with_gradient=len(g1),
         gradients_bit_equal_across_two_runs=True,
         running_statistics_moved=len(stats_before),
         launches_forward_backward=train_counts,
         seconds_forward_backward=round(step_s, 5),
         peak_memory_gb_forward_backward=round(peak_train, 2))
    return {"forward": counts, "forward_backward": train_counts}


def phase_reference_detection() -> None:
    """A small VoteNet (npoints 64/32/16/8, 256 points): the card's forward
    and gradients (CUDA kernels) against the same weights and inputs on the
    CPU (plain versions). Index outputs equal; floats within ``SMALL_ATOL``."""
    dcfg = ScannetDatasetConfig()
    rng = np.random.RandomState(SEED + 7)
    batch = make_detection_batch(2, 256, rng, "cpu", room=(1.6, 1.2, 0.8), max_boxes=4,
                                 num_boxes=(2, 3))
    kw = dict(num_class=dcfg.num_class, num_heading_bin=dcfg.num_heading_bin,
              num_size_cluster=dcfg.num_size_cluster, mean_size_arr=dcfg.mean_size_arr,
              num_proposal=8, backbone_npoints=(64, 32, 16, 8))
    cpu = VoteNet(**kw, device="cpu")
    init_random_weights(cpu, SEED + 8, std=None)
    gpu = VoteNet(**kw, device=DEV)
    gpu.load_state_dict(cpu.state_dict())
    outs, grads = {}, {}
    reset_counts()
    for name, m in (("cpu", cpu), ("gpu", gpu)):
        b = {k: v.to(m.device) for k, v in batch.items()}
        out = m(b["point_clouds"])
        loss, _ = get_detection_loss({**out, **b}, dcfg)
        loss.backward()
        outs[name] = {k: v.detach().cpu() for k, v in out.items()}
        grads[name] = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
        if name == "cpu" and any(read_counts().values()):
            fail("a CPU forward launched a CUDA kernel")
    torch.cuda.synchronize()
    errs = {}
    for k, want in outs["cpu"].items():
        got = outs["gpu"][k]
        if not want.is_floating_point():
            if not torch.equal(got, want):
                fail(f"small VoteNet {k}: card and CPU indices differ")
            continue
        errs[k] = float((got - want).abs().max())
        if not errs[k] <= SMALL_ATOL:
            fail(f"small VoteNet {k}: card vs CPU max abs err {errs[k]} > {SMALL_ATOL}")
    gerr, gname = max((float((grads["gpu"][n] - g).abs().max()), n)
                      for n, g in grads["cpu"].items())
    gmax = max(float(g.abs().max()) for g in grads["cpu"].values())
    if not gerr <= SMALL_ATOL * max(1.0, gmax):
        fail(f"small VoteNet gradient {gname}: card vs CPU max abs err {gerr} > "
             f"{SMALL_ATOL} x max(1, {gmax})")
    emit("reference_detection",
         what="small f32 VoteNet, CUDA kernels vs plain versions on the CPU",
         atol=SMALL_ATOL, seed_inds_equal=True, max_abs_err=errs,
         gradients_compared=len(grads["cpu"]), gradient_max_abs_err=gerr,
         gradient_max_abs=gmax, launches=read_counts())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", help="comma-separated subset of: "
                    "device,kernels,forward,train,serving,detection,reference")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on a CUDA device and has no CPU fallback",
              file=sys.stderr)
        return 1
    phases = [p for p in args.only.split(",") if p] or \
        ["device", "kernels", "forward", "train", "serving", "detection", "reference"]
    full_run = not args.only
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products stay f32

    info = phase_device()
    cfg = full_width_cfg()
    batch, _, _ = make_scene_batch(cfg, BATCH, np.random.RandomState(SEED), DEV)
    records, counts, train_counts, det_counts, model = {}, {}, {}, {}, None
    if "kernels" in phases:
        records = phase_kernels(cfg, batch)
    if "train" in phases:
        train_counts = phase_train(cfg, batch)
    if "forward" in phases or "serving" in phases:
        model, counts = phase_forward(cfg, batch)
    if "serving" in phases:
        phase_serving(cfg, model, batch)
    del model
    if "detection" in phases:
        det_counts = phase_detection()
    if "reference" in phases:
        phase_reference()
        phase_reference_detection()
    if not full_run:
        return 0

    # name: (source, TPU kernel it replaces, path its launches are counted on)
    forward = "one B=%d SIG3D forward" % BATCH
    step = "one B=%d SIG3D training step, scene encoder unfrozen" % BATCH
    det_forward = "one B=%d VoteNet forward, %d points a scene" % (BATCH, DET_POINTS)
    sources = {
        "fused_sparse_conv": ("situation3d_tpu_torch/csrc/fused_conv.cu",
                              "situation3d_tpu/ops/pallas/fused_conv.py:192", counts, forward),
        "k3_map_lookup": ("situation3d_tpu_torch/csrc/map_lookup.cu",
                          "situation3d_tpu/ops/pallas/map_lookup.py:80", counts, forward),
        "k3_map_lookup_bits": ("situation3d_tpu_torch/csrc/map_bits.cu",
                               "situation3d_tpu/ops/pallas/map_bits.py:161", counts, forward),
        "gather_rows": ("situation3d_tpu_torch/csrc/gather_rows.cu",
                        "situation3d_tpu/ops/pallas/gather.py:39", train_counts, step),
        "scatter_add_rows": ("situation3d_tpu_torch/csrc/gather_rows.cu",
                             "situation3d_tpu/ops/pallas/gather.py:82", train_counts, step),
        "fps": ("situation3d_tpu_torch/csrc/fps.cu",
                "situation3d_tpu/ops/pallas/fps.py:61", det_counts["forward"], det_forward)}
    kernels = []
    for name, (src, replaces, path_counts, path) in sources.items():
        r = records[name]
        if path_counts.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the main path")
        k = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
             "launches": path_counts[name], "max_abs_err": r["max_abs_err"],
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
             "library_note": r.get("library",
                                   "no single PyTorch call computes this function"),
             "path": path, "per": "sum over this kernel's launches on that path"}
        if name in ("gather_rows", "scatter_add_rows"):
            k["launches_votenet_forward"] = det_counts["forward"][name]
            k["launches_votenet_forward_backward"] = det_counts["forward_backward"][name]
        if name == "fused_sparse_conv":
            k["launches_train_step_unfrozen"] = train_counts[name]
            k["backward_dx_ms"] = records["conv_backward"]["dx_ms"]
            k["backward_dx_launches"] = train_counts[name] - counts[name]
        kernels.append(k)
    print(info["card"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
