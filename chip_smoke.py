#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``situation3d_tpu_torch``) on one
NVIDIA GPU: builds the CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version at the shapes the main paths give it,
then drives the port's main paths — the full-width SIG3D scene-QA forward, a
few optimizer steps of the trainer in both training configurations (scene
encoder frozen, and trained too: the UNet's decoder then moves by weight
decay alone), the scene-cache serving form (with the question side replayed
from its captured CUDA graph held bit-equal to the eager forward), the whole MinkUNet with its
decoder and 768-d head (``sparse.final_result``), the full-width VoteNet
detection path (forward, boxes and mAP, detection loss and its gradients),
SIG3D trained and evaluated from SQA3D-layout files written on the spot
through ``cli.train`` / ``cli.eval`` (plain, scene cache, segmentation,
visualization) / ``cli.infer``, with host-built UNet plans held against the
device's, the 3D-LLM (BLIP-2 Q-Former + FlanT5-XL, full width: three
frozen-T5 training steps, greedy and beam decoding, then ``cli.train`` /
``cli.eval`` / ``cli.infer`` / ``cli.score`` on 3D-VQA files and a small
float32 model held against the CPU), and BLIP-2 stage 1 with the model zoo
(the text-capable Q-Former trained directly and through ``cli.train --task
stage1`` on 3D-VQA files, scene-text retrieval through the ``retrieval``
task, ``Blip2OPT`` at OPT-2.7B decoding and its training loss, MED at
bert-base, EVA-CLIP-g and CLIP-L forwards, small float32 models held against
the CPU), and data parallelism (``ddp``: two ranks sharing the card under
gloo, SIG3D and stage-1 steps held bit-equal across the ranks and against one
process; ``cli.train --task stage1`` under ``torch.distributed.run`` with
NCCL against plain ``cli.train``), and the last slice (``sortplan``: the
sort-based plan equal to the dense one in extent, and a full-width SIG3D
forward on scan-sized rooms past the grid extent; ``openscene``: OpenScene
files through ``FusedFeatureLoader``, the full-width MinkUNet loaded from a
reference-format checkpoint, one training-form step against the plain route,
segmentation scoring; ``lstm``: ``cli.train`` / ``cli.eval`` with the GloVe +
LSTM encoder; ``multiview``: ENet on 5 frames and the back-projection with
its deterministic backward) — and checks what comes out.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Needs one CUDA device, ``nvcc`` and no network. Exits non-zero when any phase
fails or when no CUDA device is there (there is no CPU fallback). Prints one
JSON line per phase, the card's name and power limit, one JSON object
``{"kernels": [...]}`` and, as the last line,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``--only device,kernels`` runs a subset of the phases (a first check of a
changed kernel; ``--only blip2`` the 3D-LLM alone, ``--only blip2_stage1``
stage 1, retrieval and the model zoo, ``--only device,ddp`` data
parallelism, ``--only device,sortplan,openscene,lstm,multiview`` the last
slice); the contract lines are
printed only by a full run. The
``kernels`` phase holds ``fused_sparse_conv`` to its plain version at every
conv class of the encoder (the SIG3D forward's total), of the decoder and of
a surface-like scene (the floor and walls of a room voxelized into the
level-0 capacity), each reported with its kernel instance, hit share, time
(CUDA events around the call, and the kernel's device time from the
profiler) and bound.

Bounds. ``bound_ms`` of a kernel is the larger of (bytes it must move: each
input read once, each output written once) / 3.35 TB/s and (operations on
this run's inputs) / peak rate: 989 TFLOP/s for the bf16 conv product. For a
map kernel the table bytes are the distinct table entries that the in-extent
probes of THIS run's valid voxels touch, each read once: 4 B a grid cell, 8 B
a bit-table word with its prefix (a word holds 32 cells of a z-run); the k5
route's output is its k5 and its k3 map. For the conv the operations are
2*C_in*C_out per map entry that hits a voxel in THIS run's maps. The row gather and the scatter-add
do no arithmetic to speak of: the gather reads each distinct table row that
THIS run's indices select once (not the whole table), the scatter-add its
whole source; indices read once, output written once. The segment plan reads
the indices once and writes the permutation and the offsets once. Farthest point
sampling reads the coordinates once and writes the indices once and does
about 10 float32 operations a point a step (67 TFLOP/s peak); both bounds lie
far below its time, because its npoint-1 steps depend on each other: it is
bound by the latency of a step.

Launch counts. ``launches`` of the conv and the map kernels (k3 grid, k3
bits, k5 grid) are read around one forward (41 conv launches around one whole-UNet forward in the
``minkunet`` phase), those of ``gather_rows``, ``scatter_add_rows`` and
``segment_plan`` around
one training step with the scene encoder unfrozen (the path that runs the
conv backward), those of ``fps`` around one VoteNet forward; the counters are
set to 0 just before and read just after. Each record also carries the
launches of the last slice's paths, counted the same way: one SIG3D forward
on the sort plan (``sortplan``), the training-form whole-UNet forward and its
backward (``openscene``), one multiview back-projection with its backward
(``multiview``). ``moe_experts`` (the expert layer: plan, two grouped
launches, ordered sums) is held to its plain version at LFM2-24B-A2B's
widths at a decode step's 8 tokens and a prefill's 616; its launches are
read around one ``lfm2_predict_answers`` batch of a 4-layer cut of that
model, replayed and eager.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from situation3d_tpu_torch.cli import eval as cli_eval
from situation3d_tpu_torch.cli import infer as cli_infer
from situation3d_tpu_torch.cli import score as cli_score
from situation3d_tpu_torch.cli import train as cli_train
from situation3d_tpu_torch.config import Config, QFormerConfig, apply_overrides
from situation3d_tpu_torch.ckpt_compat.minkunet import (convert_minkunet,
                                                       random_reference_state_dict)
from situation3d_tpu_torch.data.openscene_loader import FusedFeatureLoader
from situation3d_tpu_torch.data.prefetch import make_train_pipeline
from situation3d_tpu_torch.data.scannet_preprocess import ScannetDatasetConfig
from situation3d_tpu_torch.data.sqa3d import SQA3DDataset, batch_iterator, load_scene
from situation3d_tpu_torch.data.threedvqa import question_id_int
from situation3d_tpu_torch.data.synthetic import (make_detection_arrays,
                                                  make_detection_batch,
                                                  make_scene_batch, write_sqa3d_files)
from situation3d_tpu_torch.data.vocab import build_answer_vocab, load_answer_counter
from situation3d_tpu_torch.device import tree_to_device
from situation3d_tpu_torch.eval.detection import (APCalculator,
                                                  parse_groundtruths,
                                                  parse_predictions)
from situation3d_tpu_torch.eval.segmentation import evaluate as seg_evaluate
from situation3d_tpu_torch.eval.segmentation import (precompute_text_features,
                                                     segment_points)
from situation3d_tpu_torch.eval.serving import SceneCache
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.eval.retrieval import compute_sim_matrix
from situation3d_tpu_torch.models.blip2_opt import Blip2OPT, opt_predict_answers
from situation3d_tpu_torch.models.blip2_qformer import Blip2Qformer
from situation3d_tpu_torch.models.blip2_lfm2 import Blip2LFM2, lfm2_predict_answers
from situation3d_tpu_torch.models.blip2_t5 import Blip2T5, generate, predict_answers
from situation3d_tpu_torch.models.enet import ENetForMultiview
from situation3d_tpu_torch.models.med import MedBertLMHeadModel, MedBertModel, MedConfig
from situation3d_tpu_torch.models.opt import OPTConfig
from situation3d_tpu_torch.models.sig3d import (SIG3D, init_random_weights,
                                                make_sample_draws)
from situation3d_tpu_torch.models.vit import init_vision_encoder
from situation3d_tpu_torch.models.votenet import VoteNet
from situation3d_tpu_torch.models import blip2_lfm2 as lfm2_mod
from situation3d_tpu_torch.models import sig3d as sig3d_mod
from situation3d_tpu_torch.models import layers as layers_mod
from situation3d_tpu_torch.models import t5 as t5_mod
from situation3d_tpu_torch.models.lfm2 import LFM2Config
from situation3d_tpu_torch.ops import native, pointnet2
from situation3d_tpu_torch.ops.cuda import ssm_scan
from situation3d_tpu_torch.ops.cuda import (_build, fps, fused_conv, gather_rows,
                                            map_bits, map_lookup, moe_experts)
from situation3d_tpu_torch.ops.projection import (CameraIntrinsics, multiview_backproject,
                                                  project_points)
from situation3d_tpu_torch.ops.voxelize import voxelize_np, voxelize_torch
from situation3d_tpu_torch.sparse import conv as sparse_conv
from situation3d_tpu_torch.sparse.host_plan import build_host_plan, compare_with_device_plan
from situation3d_tpu_torch.sparse.kernel_map import build_level_grid, kernel_offsets
from situation3d_tpu_torch.sparse.minkunet import (DECODER, STRIDES, MinkUNet,
                                                   build_unet_plan)
from situation3d_tpu_torch.sparse.tensor import SparseVoxels
from situation3d_tpu_torch.tools.profile_forward import blip2_bench_batch
from situation3d_tpu_torch.train.blip2_trainer import (Blip2TrainState, blip2_train_step,
                                                      make_blip2_optimizer)
from situation3d_tpu_torch.train.checkpoint import load_npz_tree
from situation3d_tpu_torch.train.detection_losses import get_detection_loss
from situation3d_tpu_torch.train.losses import get_loss
from situation3d_tpu_torch.train.optim import bn_momentum_schedule, make_optimizer
from situation3d_tpu_torch.train.tasks import RetrievalTask
from situation3d_tpu_torch.train.trainer import Trainer, create_train_state, train_step

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12     # float32 outside the tensor cores
CONV_ATOL = 2e-4      # f32 accumulation in another order; outputs are O(1)
SERVE_RTOL = 1e-2     # bf16 rounding (2^-8) when the same question is answered in a batch of 6
SERVE_SAME_RTOL = 0.0  # same question, same batch size: pooling is deterministic, bit-equal
QUESTION_BATCH = 32   # the answer cells' batch: the replayed question side's check and timing
QUESTION_CALLS = 3    # batches of one key, each replayed and held against the eager forward
SMALL_ATOL = 1e-3     # f32 small model, card (kernels) vs CPU (plain versions)
SEED = 0
BATCH = 8
DEV = "cuda"   # every phase runs here; there is no CPU mode
SUM_ATOL = 1e-5       # scatter-add: the same f32 sums in another order
GRAD_RTOL = 1e-4      # conv dx/dW vs plain autograd, relative to the largest value
GRAD_RTOL_BF16 = 2e-2  # with bf16 inputs: dx, and the plain version's dW, round to bf16
MOE_RTOL = 1e-3       # expert layer, of the largest output: h rounds to bf16 after sums in another order
# kernel name -> (module, name of its launch counter)
KERNEL_COUNTERS = {"fused_sparse_conv": (fused_conv, "launches"),
                   "k3_map_lookup": (map_lookup, "launches"),
                   "k3_map_lookup_bits": (map_bits, "launches"),
                   "k5_map_lookup": (map_lookup, "k5_launches"),
                   "gather_rows": (gather_rows, "gather_launches"),
                   "scatter_add_rows": (gather_rows, "scatter_launches"),
                   "segment_plan": (gather_rows, "plan_launches"),
                   "fps": (fps, "launches"),
                   "moe_experts": (moe_experts, "launches")}
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


def _flush_buffer() -> torch.Tensor:
    """256 MiB written before each timed call to evict the L2 cache; made
    outside inference mode, so a first timing inside it leaves a buffer the
    timings outside it may write too."""
    global _flush
    if _flush is None:
        with torch.inference_mode(False):
            _flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEV)
    return _flush


def time_cuda(fn, iters: int = 5, warmup: int = 2) -> float:
    """Mean milliseconds per call (CUDA events), with the L2 cache evicted
    before every timed call: on the main path a conv's map and a map kernel's
    tables were written long before they are read."""
    flush = _flush_buffer()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in zip(starts, ends)]))


# default widths (12-layer MPNet at 768, 706 answers, text length 100,
# capacities 49152..3072, extent 512x512x256) with the slice's sparse switches
FULL_WIDTH = ["data.num_answers=706", "sparse.conv0_zwin=false",
              "sparse.fused_conv=true", "sparse.pallas_map=true",
              "sparse.pallas_map_bits=true", "sparse.dense_lookup=true",
              "sparse.dense_downsample=true", "sparse.final_result=false"]


def full_width_cfg() -> Config:
    return apply_overrides(Config(), FULL_WIDTH)


SMALL_WIDTH = [
    "lang.num_layers=2", "lang.hidden_size=64", "lang.num_heads=4",
    "lang.intermediate_size=128", "model.hidden_size=64",
    "model.mcan_num_heads=4", "model.mcan_num_layers=1",
    "model.mcan_flat_mlp_size=32", "model.mcan_flat_out_size=48",
    "model.num_scene_tokens=32", "model.scene_feat_dim=48",
    "sparse.planes=8,16,24,48,24,24,16,16", "sparse.init_dim=8",
    "sparse.bottleneck_channels=48",
    "sparse.capacities=4096,2048,1024,512,256", "data.voxel_size=0.08",
    "sparse.grid_extent=(128,128,64)", "data.num_answers=12",
    "data.max_text_len=24"]


def small_cfg() -> Config:
    return apply_overrides(Config(), SMALL_WIDTH)


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

    srec = {"ms": 0.0, "sum_only_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "library_ms": 0.0, "max_abs_err": 0.0, "bound_by": "bytes",
            "library": "index_add_ (float atomics, not deterministic)",
            "bit_equal_across_runs": True, "shapes": []}
    prec = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None,
            "max_abs_err": 0, "bound_by": "bytes", "shapes": [],
            "plain": "sort_segments: torch.sort(stable) + torch.searchsorted"}

    def one_scatter(name, src, idx, V, count, plan_count):
        m = measure_scatter(name, src, idx, V)
        # ms: the whole call (its sum and, where it makes one, its plan), as
        # index_add_ does the whole job; sum_only_ms: the sum kernel alone
        for k, v in (("sum_only_ms", m["kernel_only_ms"]), ("plain_ms", m["plain_ms"]),
                     ("library_ms", m["library_ms"]), ("bound_ms", m["bound_ms"])):
            srec[k] += v * count
        srec["ms"] += m["kernel_only_ms"] * count + m["plan_ms"] * plan_count
        srec["max_abs_err"] = max(srec["max_abs_err"], m["err"])
        for k, v in (("ms", m["plan_ms"]), ("plain_ms", m["plan_plain_ms"]),
                     ("bound_ms", m["plan_bound_ms"])):
            prec[k] += v * plan_count
        srec["shapes"].append({"per_step": count, "plans_per_step": plan_count, **m})

    feats = torch.randn(B, V4, C, generator=g, device=dev) * bott["mask"][..., None]
    one_scatter("segment_sums", feats, inv, V4, 1, 1)
    one_scatter("segment_counts", bott["mask"].float()[..., None], inv, V4, 1, 0)
    one_scatter("token_gather_backward",
                torch.randn(B, N, C, generator=g, device=dev), token_idx, V4, 1, 1)
    # the bf16 instance of the kernel (the gradient of a gather from a bf16
    # table); no step of the default model runs it, so it adds to no total
    one_scatter("segment_sums_bf16", feats.bfloat16(), inv, V4, 0, 0)
    prec["edge_cases"] = check_plan_edges()
    records["gather_rows"], records["scatter_add_rows"] = grec, srec
    records["segment_plan"] = prec


def measure_scatter(name, src, idx, V, relative: bool = False) -> dict:
    """``segment_plan`` equal to ``sort_segments`` and ``scatter_add_rows``
    within ``SUM_ATOL`` (times the largest sum if ``relative``) of its plain
    version, two runs bit-equal; times of the plan, the sum alone, the whole call (plan + sum),
    the plain versions and ``index_add_``, and both bounds."""
    dev = src.device
    plan = gather_rows.segment_plan(idx, V)
    want_plan = gather_rows.sort_segments(idx, V)
    got = gather_rows.scatter_add_rows(src, idx, V)
    again = gather_rows.scatter_add_rows(src, idx, V)
    want = gather_rows.scatter_add_rows_plain(src, idx, V)
    torch.cuda.synchronize()
    if not (torch.equal(plan[0], want_plan[0]) and torch.equal(plan[1], want_plan[1])):
        fail(f"segment_plan {name}: kernel != sort_segments")
    if not torch.equal(got, again):
        fail(f"scatter_add_rows {name}: two runs are not bit-equal")
    err, scale = float((got - want).abs().max()), max(1.0, float(want.abs().max()))
    if got.dtype != torch.float32 or not err <= SUM_ATOL * (scale if relative else 1.0):
        fail(f"scatter_add_rows {name}: max abs err {err} > {SUM_ATOL}"
             + (f" x {scale}" if relative else ""))
    Bs, R, Cs = src.shape
    # the library call: dropped entries (index -1) go to a spare row
    flat_idx = (torch.where((idx >= 0) & (idx < V), idx, V).to(torch.int64)
                + torch.arange(Bs, device=dev)[:, None] * (V + 1)).reshape(-1)
    flat_src = src.float().reshape(Bs * R, Cs)
    acc = torch.empty(Bs * (V + 1), Cs, device=dev)
    ms = time_cuda(lambda: gather_rows.scatter_add_rows(src, idx, V))
    kms = time_cuda(lambda: gather_rows.scatter_add_rows(src, idx, V, plan))
    plan_ms = time_cuda(lambda: gather_rows.segment_plan(idx, V))
    plan_pms = time_cuda(lambda: gather_rows.sort_segments(idx, V))
    pms = time_cuda(lambda: gather_rows.scatter_add_rows_plain(src, idx, V))
    lms = time_cuda(lambda: acc.zero_().index_add_(0, flat_idx, flat_src))
    bound = (src.numel() * src.element_size() + idx.numel() * 4
             + got.numel() * 4) / HBM_BYTES_PER_S * 1e3
    plan_bound = (idx.numel() * 8 + plan[1].numel() * 4) / HBM_BYTES_PER_S * 1e3
    return {"name": name, "src": list(src.shape), "dtype": str(src.dtype).split(".")[-1],
            "V": V, "longest_segment": int((plan[1][:, 1:] - plan[1][:, :-1]).max()),
            "dropped": int(idx.numel() - plan[1][:, -1].sum()),
            "ms": round(ms, 4), "kernel_only_ms": round(kms, 4), "plan_ms": round(plan_ms, 4),
            "plain_ms": round(pms, 4), "plan_plain_ms": round(plan_pms, 4),
            "library_ms": round(lms, 4), "bound_ms": round(bound, 5),
            "plan_bound_ms": round(plan_bound, 5), "err": err, "largest_sum": scale,
            "plan_exact": True}


def check_plan_edges() -> list:
    """``segment_plan`` equal to ``sort_segments`` (and the sum to its plain
    version) where the plan's design is stretched: one destination holding
    12,000 entries, every index dropped, a single entry, and destinations too
    many for a block's shared memory (the counters, and with R = 1,000,000
    the lists of long segments too, in the global scratch)."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 14)
    long_row = torch.randint(0, 50, (2, 20000), generator=g, device=DEV, dtype=torch.int32)
    long_row[:, ::5] = 7
    long_row[1, :12000] = 3                          # 12,000 entries for row 3
    cases = [("one_destination_12000_entries", long_row, 50),
             ("every_index_dropped",
              torch.randint(-9, 0, (3, 7000), generator=g, device=DEV, dtype=torch.int32), 40),
             ("r_equals_1", torch.tensor([[5], [-1], [0]], dtype=torch.int32, device=DEV), 6)]
    wide = torch.randint(0, 300000, (2, 20000), generator=g, device=DEV, dtype=torch.int32)
    wide[0, 3::2] = 123457                           # ~10,000 entries for one row
    wide[1, ::7] = -1
    huge = torch.randint(-1000, 500000, (2, 1000000), generator=g, device=DEV,
                         dtype=torch.int32)
    huge[:, ::50] = torch.tensor([[7], [499999]], dtype=torch.int32, device=DEV)
    huge[:, 1::97] = 250000                          # long segments in two blocks
    cases += [("v_300000_global_counters", wide, 300000),
              ("v_500000_r_1000000_global_lists", huge, 500000)]
    done = []
    for name, idx, V in cases:
        perm, off = gather_rows.segment_plan(idx, V)
        want = gather_rows.sort_segments(idx, V)
        src = torch.randn(*idx.shape, 4, generator=g, device=DEV)
        got = gather_rows.scatter_add_rows(src, idx, V, (perm, off))
        ref = gather_rows.scatter_add_rows_plain(src, idx, V)
        torch.cuda.synchronize()
        if not (torch.equal(perm, want[0]) and torch.equal(off, want[1])):
            fail(f"segment_plan edge case {name}: kernel != sort_segments")
        scale = max(1.0, float(ref.abs().max()))
        if not float((got - ref).abs().max()) <= SUM_ATOL * scale:
            fail(f"scatter_add_rows edge case {name}: sum != plain version")
        done.append({"name": name, "R": idx.shape[1], "V": V,
                     "longest_segment": int((off[:, 1:] - off[:, :-1]).max()),
                     "dropped": int(idx.numel() - off[:, -1].sum())})
    return done


def check_conv_backward(cfg, L, B, records) -> None:
    """The conv ``Function``'s ``dx`` / ``dW`` on the card against plain
    autograd through ``fused_sparse_conv_plain``, every conv class; times the
    backward in bf16 and, alone, the ``dx`` launch of the forward kernel."""
    dev = torch.device(DEV)
    g = torch.Generator(device=DEV).manual_seed(SEED + 11)
    rec = {"ms": 0.0, "plain_ms": 0.0, "dx_ms": 0.0, "dx_bound_ms": 0.0, "max_rel_err_f32": 0.0,
           "max_rel_err_bf16": 0.0, "shapes": []}
    for name, lvl_in, key, lvl_map, c_in, c_out, count in _conv_classes(cfg):
        nbr = L[lvl_map][key]
        t_map, flip = _tmap_of(L, lvl_in, key, lvl_map)
        v_in, v_out, K = L[lvl_in]["coords"].shape[1], nbr.shape[1], nbr.shape[2]
        want_dx = name != "conv0_k5"          # conv0's input needs no gradient

        def conv(f, w):
            return sparse_conv._SparseConvTmap.apply(f, nbr, t_map, w, flip)
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
        dx_ms = dx_bound = 0.0
        if want_dx:
            wt = (w.detach().flip(0) if flip else w.detach()).transpose(1, 2)
            dx_ms = time_cuda(lambda: fused_conv.fused_sparse_conv(cot, t_map, wt))
            # the forward's bound, on the transpose map: dy, map, W read, dx written
            hits = int(((t_map >= 0) & (t_map < v_out)).sum())
            dx_bound = max(2.0 * hits * c_in * c_out / BF16_FLOPS,
                           (cot.numel() * 2 + t_map.numel() * 4 + wt.numel() * 2
                            + B * v_in * c_in * 4) / HBM_BYTES_PER_S) * 1e3
        rec["ms"] += ms * count
        rec["plain_ms"] += pms * count
        rec["dx_ms"] += dx_ms * count
        rec["dx_bound_ms"] += dx_bound * count
        rec["max_rel_err_f32"] = max(rec["max_rel_err_f32"], errs[torch.float32])
        rec["max_rel_err_bf16"] = max(rec["max_rel_err_bf16"], errs[torch.bfloat16])
        rec["shapes"].append({
            "name": name, "per_step": count, "dx": want_dx, "backward_ms": round(ms, 4),
            "plain_backward_ms": round(pms, 4), "dx_ms": round(dx_ms, 4),
            "dx_bound_ms": round(dx_bound, 5),
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
        layout = fps.fps_layout(Np)
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
            "blocks_per_row": layout.blocks_per_row, "threads": layout.threads,
            "points_per_thread": layout.points_per_thread,
            "sms_used": Bp * layout.blocks_per_row,
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
    # rows past the 65,536 points the registers hold: the rest in the scratch
    lattice42 = torch.stack(torch.meshgrid(*[torch.arange(42.0, device=DEV)] * 3,
                                           indexing="ij"), -1).reshape(1, -1, 3) + 1.0
    long_rows = rand(2, 100000, 3) * 4 + 0.5
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
        ("integer_lattice_ties_above_65536_points", lattice42, 300, None),
        ("valid_mask_above_65536_points", long_rows, 128, rand(2, 100000) > 0.3),
    ]
    for name, pts, m, valid in edge:
        got, want = fps.fps(pts, m, valid), fps.fps_plain(pts, m, valid)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"fps edge case {name}: kernel != plain version")
        rec["edge_cases"].append(name)
    rec["rows_above_registers"] = {
        "xyz": list(long_rows.shape), "npoint": 128,
        "us_per_step": round(time_cuda(lambda: fps.fps(long_rows, 128)) * 1e3 / 127, 3)}
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
        flat_table = table.reshape(-1, table.shape[2])
        flat_idx = (idx.to(torch.int64)
                    + torch.arange(BATCH, device=DEV)[:, None] * V).reshape(-1)
        src = torch.randn(got.shape, generator=g, device=DEV)
        shapes.append({
            "name": name, "table": list(table.shape), "R": idx.shape[1],
            "gather_ms": round(time_cuda(lambda: gather_rows.gather_rows(table, idx)), 4),
            "gather_plain_ms": round(time_cuda(
                lambda: gather_rows.gather_rows_plain(table, idx)), 4),
            "gather_library_ms": round(time_cuda(
                lambda: flat_table.index_select(0, flat_idx)), 4),
            "scatter_add": measure_scatter(name, src, idx, V, relative=True)})
    records["detection_gathers"] = {"shapes": shapes}


def _decoder_classes(cfg):
    """(name, input level, map key, map level, C_in, C_out, launches per full
    UNet forward) for every conv class of the decoder (``final_result``):
    the transposed convs gather the coarser level through the finer level's
    ``map_up``; a layer's first conv takes the upsampled features and the
    skip concatenated."""
    sp = cfg.sparse
    skip = {4: sp.planes[2], 3: sp.planes[1], 2: sp.planes[0], 1: sp.init_dim}
    out, ch = [], sp.planes[3]
    for j, lvl in zip(range(4, 8), (4, 3, 2, 1)):
        p, n = sp.planes[j], 2 * sp.layers[j]
        out.append((f"convtr{j}_level{lvl}to{lvl - 1}_k2_{ch}to{p}", lvl, "map_up", lvl - 1,
                    ch, p, 1))
        out.append((f"block{j + 1}_level{lvl - 1}_k3_{p + skip[lvl]}to{p}", lvl - 1, "map_k3",
                    lvl - 1, p + skip[lvl], p, 1))
        out.append((f"block{j + 1}_level{lvl - 1}_k3_{p}to{p}", lvl - 1, "map_k3", lvl - 1,
                    p, p, n - 1))
        ch = p
    return out


def device_ms(fn, name_part: str = "conv") -> float:
    """Mean device time (ms) of the kernels whose name holds ``name_part``
    in one call of ``fn``, from ``torch.profiler`` (L2 evicted before each
    of 3 calls): the kernel alone, without the host's share of a call. A
    profile that caught no such kernel is taken again (up to three times)."""
    flush = _flush_buffer()
    fn()
    torch.cuda.synchronize()
    iters = 3
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                 for e in prof.key_averages() if name_part in e.key)
        if us > 0:
            return us / iters / 1e3
    fail(f"the profiler saw no kernel named *{name_part}*")


def measure_conv(name, nbr, in_mask, c_in, c_out, g) -> dict:
    """``fused_sparse_conv`` on the card against its plain version in bf16
    and f32 (``CONV_ATOL``), its times (CUDA events around the call; the
    kernel's device time from the profiler) and its bound on this map."""
    dev = nbr.device
    B, v_out, K = nbr.shape
    v_in = in_mask.shape[1]
    feats32 = torch.randn(B, v_in, c_in, generator=g, device=dev) * in_mask[..., None]
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
    dms = device_ms(lambda: fused_conv.fused_sparse_conv(f, nbr, w))
    pms = time_cuda(lambda: fused_conv.fused_sparse_conv_plain(f, nbr, w), iters=3, warmup=1)
    hits = int(((nbr >= 0) & (nbr < v_in)).sum())
    ops_ms = 2.0 * hits * c_in * c_out / BF16_FLOPS * 1e3
    bytes_ms = (f.numel() * 2 + nbr.numel() * 4 + w.numel() * 2
                + B * v_out * c_out * 4) / HBM_BYTES_PER_S * 1e3
    return {"name": name, "B": B, "V_in": v_in, "V_out": v_out, "K": K, "C_in": c_in,
            "C_out": c_out, "instance": fused_conv.conv_instance(torch.bfloat16, K, c_in, c_out),
            "map_hits": hits, "hit_share": round(hits / nbr.numel(), 4), "ms": ms,
            "device_ms": dms, "plain_ms": pms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "err_f32": errs[torch.float32], "err_bf16": errs[torch.bfloat16]}


SURFACE_VOXEL = 0.055   # metres: the room's floor and walls fill ~44,000 of 49,152 slots


def surface_scene_voxels(cfg):
    """The floor and walls of ``make_detection_arrays``' 8 x 6 x 3 m room
    (its box faces left out), 400,000 points a scene, voxelized at 5.5 cm
    into the level-0 capacity, so every surface cell is a voxel. Returns
    (coords, mask, voxels a scene)."""
    arr = make_detection_arrays(BATCH, 400000, np.random.RandomState(SEED + 30))
    pts = torch.as_tensor(arr["point_clouds"], device=DEV)
    keep = torch.as_tensor(arr["vote_label_mask"] == 0, device=DEV)   # floor and walls
    coords = torch.floor(pts / SURFACE_VOXEL).to(torch.int32).clamp(min=0)
    vc, vm, _, n_unique = voxelize_torch(coords, keep, capacity=cfg.sparse.capacities[0])
    return vc, vm, n_unique


def surface_scene_convs(cfg, g) -> dict:
    """conv0 and the level-1 k3 class on the surface-like scene
    (``surface_scene_voxels``: every surface cell is a voxel, as in a scan).
    Reported beside the main path's totals, not in them."""
    caps = cfg.sparse.capacities
    vc, vm, n_unique = surface_scene_voxels(cfg)
    plan = build_unet_plan(vc, vm, caps, tuple(cfg.sparse.grid_extent), device=DEV)
    L = plan["levels"]
    sp = cfg.sparse
    out = {"voxel_m": SURFACE_VOXEL, "voxels_per_scene": [int(n) for n in n_unique],
           "capacity": caps[0], "shapes": []}
    if int(n_unique.max()) > caps[0]:
        fail(f"surface scene overflows the level-0 capacity: {n_unique.tolist()}")
    for name, lvl, key, c_in, c_out in (("conv0_k5", 0, "map_k5", sp.in_channels, sp.init_dim),
                                        (f"level1_k3_{sp.planes[0]}to{sp.planes[0]}", 1,
                                         "map_k3", sp.planes[0], sp.planes[0])):
        out["shapes"].append(measure_conv(name, L[lvl][key], L[lvl]["mask"], c_in, c_out, g))
    return out


# map kernel -> (kernel, plain version, name filter of its device kernel,
# kernel size); the k5 route also writes the level's k3 map
MAP_KERNELS = {
    "k5_map_lookup": (map_lookup.k5_map_lookup, map_lookup.k5_map_lookup_plain,
                      "grid_map_kernel<5", 5),
    "k3_map_lookup": (map_lookup.k3_map_lookup, map_lookup.k3_map_lookup_plain,
                      "grid_map_kernel<3", 3),
    "k3_map_lookup_bits": (map_bits.k3_map_lookup_bits, map_bits.k3_map_lookup_bits_plain,
                           "bits_map_kernel", 3)}


def _same_maps(got, want) -> bool:
    got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
    return all(g.dtype == torch.int32 and torch.equal(g, w) for g, w in zip(got, want))


def touched_table_bytes(cells, mask, extent_cells, kernel_size, cells_per_entry,
                        entry_bytes) -> int:
    """Bytes of a level's table that the in-extent probes of the valid
    voxels touch: ``entry_bytes`` for each distinct (sample, entry), an entry
    holding ``cells_per_entry`` consecutive cells of the flat order (1 for
    the int32 grid; 32 for a bit-table word, read with its prefix)."""
    X, Y, Z = extent_cells
    offs = torch.as_tensor(kernel_offsets(kernel_size), dtype=torch.int64, device=cells.device)
    hi = torch.tensor(extent_cells, device=cells.device)
    n = 0
    for b in range(mask.shape[0]):
        q = cells[b][mask[b]].to(torch.int64)[:, None, :] + offs
        q = q[((q >= 0) & (q < hi)).all(-1)]
        n += torch.unique(((q[:, 0] * Y + q[:, 1]) * Z + q[:, 2]) // cells_per_entry).numel()
    return n * entry_bytes


def measure_map(records, name, args, cells_per_entry, entry_bytes, **shape):
    """One map kernel against its plain version (exact), its times (CUDA
    events around the call; the kernel's device time from the profiler)
    and its bound: cells, mask and the map(s) once, and the table entries
    that the probes of this run's valid voxels touch once
    (``touched_table_bytes``). Adds to ``records[name]``; returns the
    kernel's maps."""
    kern, plain, kname, ks = MAP_KERNELS[name]
    cells, mask, extent_cells = args[-4], args[-3], args[-2]
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    if not _same_maps(got, want):
        fail(f"{name} {shape}: kernel != plain version")
    outs = got if isinstance(got, tuple) else (got,)
    table = touched_table_bytes(cells, mask, extent_cells, ks, cells_per_entry, entry_bytes)
    bytes_moved = (cells.numel() * 4 + mask.numel() + sum(o.numel() * 4 for o in outs)
                   + table)
    ms, pms = time_cuda(lambda: kern(*args)), time_cuda(lambda: plain(*args), iters=3)
    dms = device_ms(lambda: kern(*args), kname)
    bound = bytes_moved / HBM_BYTES_PER_S * 1e3
    rec = records[name]
    for k, v in (("ms", ms), ("device_ms", dms), ("plain_ms", pms), ("bound_ms", bound)):
        rec[k] += v
    B, V = mask.shape
    rec["shapes"].append({**shape, "cells": list(extent_cells), "B": B, "V": V,
                          "table_bytes_touched": table,
                          "ms": round(ms, 4), "device_ms": round(dms, 5),
                          "plain_ms": round(pms, 4), "bound_ms": round(bound, 5),
                          "exact": True})
    return got


def check_k5_edges(cfg, batch, rec) -> None:
    """The k5 route (and its k3 map) against its plain version, exact, at
    full width on an edge batch — voxels at negative cells and beyond the
    512 x 512 x 256 extent, voxels on the extent's faces and corners,
    masked rows, a sample with no valid voxel — and on the surface-like
    scene's level 0."""
    extent = tuple(cfg.sparse.grid_extent)
    X, Y, Z = extent
    coords = batch["voxel_coords"].clone()
    mask = batch["voxel_mask"].clone()
    outside = [[-1, 0, 0], [-2, -2, -2], [0, -1, 100], [5, 5, -1], [X, 0, 0], [0, Y, 0],
               [0, 0, Z], [X + 1, 300, 100], [X + 88, Y + 88, Z + 44], [-5, Y + 8, -3],
               [X, Y - 1, Z - 1], [-1, Y, Z]]
    faces = [[0, 0, 0], [X - 1, Y - 1, Z - 1], [0, Y - 1, 0], [X - 1, 0, Z - 1],
             [1, 1, 1], [X - 2, Y - 2, Z - 2], [0, 200, Z - 1], [X - 1, 100, 0]]
    coords[0, :len(outside)] = torch.tensor(outside, dtype=torch.int32, device=DEV)
    coords[3, :len(faces)] = torch.tensor(faces, dtype=torch.int32, device=DEV)
    mask[0, :len(outside)] = True
    mask[3, :len(faces)] = True
    mask[1, 100:2100] = False
    mask[2] = False
    cases = {"edge batch": (coords, mask)}
    vc, vm, _ = surface_scene_voxels(cfg)
    cases["surface scene"] = (vc, vm)
    kern, plain, _, _ = MAP_KERNELS["k5_map_lookup"]
    for case, (c, m) in cases.items():
        grid, misses = build_level_grid(c, m, 1, extent)
        args = (grid, c, m, extent, m.shape[1])
        if not _same_maps(kern(*args), plain(*args)):
            fail(f"k5_map_lookup {case}: kernel != plain version")
        rec.setdefault("edge_cases_exact", []).append(
            {"case": case, "extent_misses": [int(x) for x in misses]})
        del grid
    in_ext = ((coords >= 0) & (coords < torch.tensor(extent, device=DEV))).all(-1)
    want = [int(x) for x in (mask & ~in_ext).sum(1)]
    if rec["edge_cases_exact"][0]["extent_misses"] != want or want[0] < len(outside):
        fail(f"k5_map_lookup edge batch: extent_misses "
             f"{rec['edge_cases_exact'][0]['extent_misses']} != {want}")


def check_plan_against_cpu(cfg, batch, plan) -> None:
    """The whole plan built on the card (kernels) equal, every tensor, to
    the plan built on the CPU from the same voxels (plain versions)."""
    sp = cfg.sparse
    cpu = build_unet_plan(batch["voxel_coords"].cpu(), batch["voxel_mask"].cpu(),
                          sp.capacities, tuple(sp.grid_extent), device="cpu")
    for i, (gl, cl) in enumerate(zip(plan["levels"], cpu["levels"])):
        if set(gl) != set(cl):
            fail(f"plan level {i}: keys {sorted(gl)} != {sorted(cl)} on the CPU")
        for key in cl:
            if not torch.equal(gl[key].cpu(), cl[key]):
                fail(f"plan level {i} {key}: card != CPU (plain versions)")
    for key in cpu["overflow"]:
        if not torch.equal(plan["overflow"][key].cpu(), cpu["overflow"][key]):
            fail(f"plan overflow {key}: card != CPU")


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

    # ---- the map kernels: k3 at levels 1-4, k5 (+ its k3) at level 0 ------
    records.update({name: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                           "bound_by": "bytes", "max_abs_err": 0, "shapes": []}
                    for name in MAP_KERNELS})
    grid, _ = build_level_grid(L[0]["coords"], L[0]["mask"], 1, extent)
    args = (grid, L[0]["coords"], L[0]["mask"], extent, L[0]["coords"].shape[1])
    got = measure_map(records, "k5_map_lookup", args, 1, 4, level=0)
    if not (torch.equal(got[0], L[0]["map_k5"]) and torch.equal(got[1], L[0]["map_k3"])):
        fail("k5_map_lookup level 0: kernel != the plan's maps")
    del grid, args, got
    for i in range(1, 5):
        s = STRIDES[i]
        cells = tuple(e // s for e in extent)
        n_cells = cells[0] * cells[1] * cells[2]
        out_cells = torch.div(L[i]["coords"], s, rounding_mode="floor")
        mask = L[i]["mask"]
        if map_lookup.map_lookup_fits(n_cells, cells[2]):
            name = "k3_map_lookup"
            grid, _ = build_level_grid(L[i]["coords"], mask, s, extent)
            args = (grid, out_cells, mask, cells, mask.shape[1])
            cells_per_entry, entry_bytes = 1, 4
        elif map_bits.map_bits_fits(n_cells, cells[2]):
            name = "k3_map_lookup_bits"
            bits, pfx = map_bits.build_level_bits(L[i]["coords"], mask, s, extent)
            args = (bits, pfx, out_cells, mask, cells, mask.shape[1])
            cells_per_entry, entry_bytes = 32, 8
        else:
            fail(f"level {i} routes to neither map kernel")
        got = measure_map(records, name, args, cells_per_entry, entry_bytes, level=i)
        if not torch.equal(got, L[i]["map_k3"]):
            fail(f"{name} level {i}: kernel != the plan's map")
        del args, got
    check_k5_edges(cfg, batch, records["k5_map_lookup"])
    check_plan_against_cpu(cfg, batch, plan)

    # ---- the fused conv: every class of the encoder (the main path's
    # total), of the decoder and of a surface-like scene (beside it) -------
    g = torch.Generator(device=DEV).manual_seed(SEED)
    rec = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_ops_ms": 0.0,
           "bound_bytes_ms": 0.0, "device_ms": 0.0, "max_abs_err": 0.0,
           "max_abs_err_f32": 0.0, "shapes": []}
    for name, lvl_in, key, lvl_map, c_in, c_out, count in _conv_classes(cfg):
        r = measure_conv(name, L[lvl_map][key], L[lvl_in]["mask"], c_in, c_out, g)
        for k in ("ms", "plain_ms", "bound_ops_ms", "bound_bytes_ms", "bound_ms", "device_ms"):
            rec[k] += r[k] * count
        rec["max_abs_err"] = max(rec["max_abs_err"], r["err_bf16"])
        rec["max_abs_err_f32"] = max(rec["max_abs_err_f32"], r["err_f32"])
        rec["shapes"].append({"per_forward": count, **r})
    rec["bound_by"] = ("operations" if rec["bound_ops_ms"] > rec["bound_bytes_ms"]
                       else "bytes")
    dec = {"ms": 0.0, "bound_ms": 0.0, "device_ms": 0.0, "shapes": []}
    for name, lvl_in, key, lvl_map, c_in, c_out, count in _decoder_classes(cfg):
        r = measure_conv(name, L[lvl_map][key], L[lvl_in]["mask"], c_in, c_out, g)
        for k in ("ms", "bound_ms", "device_ms"):
            dec[k] += r[k] * count
        dec["shapes"].append({"per_forward": count, **r})
        rec["max_abs_err"] = max(rec["max_abs_err"], r["err_bf16"])
        rec["max_abs_err_f32"] = max(rec["max_abs_err_f32"], r["err_f32"])
    rec["decoder"] = dec
    rec["surface_scene"] = surface_scene_convs(cfg, g)
    records["fused_sparse_conv"] = rec
    check_gather_scatter(cfg, L, B, records)
    check_conv_backward(cfg, L, B, records)
    del plan, L
    check_fps(records)
    check_detection_gathers(records)
    records["moe_experts"] = check_moe_experts()
    emit("kernels", conv_atol=CONV_ATOL, sum_atol=SUM_ATOL, grad_rtol=GRAD_RTOL,
         grad_rtol_bf16=GRAD_RTOL_BF16, timing="CUDA events, L2 evicted before each call",
         kernels={k: {kk: (round(vv, 5) if isinstance(vv, float) else vv)
                      for kk, vv in v.items()} for k, v in records.items()})
    return records


LFM2_WIDTHS = dict(E=64, M=1536, D=2048, K=4)     # LFM2-24B-A2B's expert layer


def _grouped_mm(x, idx, w13t, w2t, E: int, M: int, K: int):
    """The library's two grouped products on rows grouped by expert (the
    routing weights and the sums of each token's rows left out)."""
    order = torch.argsort(idx.reshape(-1), stable=True)
    ends = torch.cumsum(torch.bincount(idx.reshape(-1), minlength=E), 0).to(torch.int32)
    gu = torch._grouped_mm(x[order // K], w13t, offs=ends)
    h = (torch.nn.functional.silu(gu[:, :M].float()) * gu[:, M:].float()).bfloat16()
    return torch._grouped_mm(h, w2t, offs=ends)


def measure_moe(tokens: int) -> dict:
    """``moe_experts`` at LFM2-24B-A2B's widths against its plain version
    (within ``MOE_RTOL`` of the largest output; the counters from the plan
    equal the plain version's count), on choices drawn uniformly, a few
    dropped (``benchmarks/tests/test_bench_lfm2.py`` holds skewed ones to
    the plain version too); times of the whole call (plan,
    both grouped launches, ordered sums), the plain version and the
    library's grouped products, and the bound: each chosen expert's weights
    read once, each token's row read and its float32 sum written once, or
    6 D M operations a routed row at the bf16 peak."""
    E, M, D, K = (LFM2_WIDTHS[k] for k in "EMDK")
    g = torch.Generator(device=DEV).manual_seed(tokens)
    x = torch.randn(tokens, D, generator=g, device=DEV).bfloat16()
    w1 = (torch.randn(E, M, D, generator=g, device=DEV) / D ** 0.5).bfloat16()
    w3 = (torch.randn(E, M, D, generator=g, device=DEV) / D ** 0.5).bfloat16()
    w2 = (torch.randn(E, D, M, generator=g, device=DEV) / M ** 0.5).bfloat16()
    idx = torch.topk(torch.rand(tokens, E, generator=g, device=DEV), K, -1).indices.int()
    idx[::7, 1] = -1
    w = torch.rand(tokens, K, generator=g, device=DEV)
    c_kernel = torch.zeros(2, dtype=torch.int64, device=DEV)
    c_plain = torch.zeros(2, dtype=torch.int64, device=DEV)
    got = moe_experts.moe_experts(x, idx, w, w1, w3, w2, c_kernel)
    want = moe_experts.moe_experts_plain(x, idx, w, w1, w3, w2, c_plain)
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= MOE_RTOL:
        fail(f"moe_experts {tokens} tokens: max err {err} > {MOE_RTOL} of the largest")
    if c_kernel.tolist() != c_plain.tolist():
        fail(f"moe_experts {tokens} tokens: counters {c_kernel.tolist()} != plain "
             f"{c_plain.tolist()}")
    rows, read = c_plain.tolist()
    bytes_ms = (read * 3 * D * M * 2 + tokens * D * (2 + 4)) / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * 6 * D * M / BF16_FLOPS * 1e3
    rec = {"tokens": tokens, "rows_routed": rows, "experts_read": read, "max_rel_err": err,
           "ms": time_cuda(lambda: moe_experts.moe_experts(x, idx, w, w1, w3, w2), iters=10),
           "plain_ms": time_cuda(lambda: moe_experts.moe_experts_plain(x, idx, w, w1, w3, w2),
                                 iters=2, warmup=1),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None}
    if hasattr(torch, "_grouped_mm"):
        w13t = torch.cat([w1, w3], 1).transpose(1, 2)       # [E, D, 2M], column-major
        w2t = w2.transpose(1, 2)                              # [E, M, D]
        kept = (idx >= 0).all(1)                              # the library takes no dropped choice
        xk, ik = x[kept], idx[kept].long()
        try:
            rec["library_ms"] = time_cuda(lambda: _grouped_mm(xk, ik, w13t, w2t, E, M, K),
                                          iters=10)
        except (RuntimeError, TypeError) as e:
            rec["library_error"] = str(e)[:200]
    return rec


def lfm2_launches() -> dict:
    """``lfm2_predict_answers`` at LFM2-24B-A2B's widths cut to 4 layers
    (conv, conv, attention, conv: 2 dense, 2 with experts), B=8, 10 tokens:
    the replayed steps' tokens equal the eager ones; ``moe_experts``
    launches around one batch after its capture (the prefill's: the steps'
    are inside graphs) and around the same batch run eagerly (the prefill's
    and each step's), the counters zeroed just before and read just after."""
    cfg = LFM2Config(layer_types=("conv", "conv", "full_attention", "conv"),
                     num_hidden_layers=4)
    model = Blip2LFM2(QFormerConfig(), cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                      device=DEV, seed=SEED)
    n_moe, T = cfg.num_hidden_layers - cfg.num_dense_layers, 10
    g = torch.Generator(device=DEV).manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    lens = rng.randint(13, 44, BATCH)
    ids = np.zeros((BATCH, 64), np.int64)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.randint(8, cfg.vocab_size, n)
    N = QFormerConfig().scene_token_capacity
    batch = {"pc_feat": torch.randn(BATCH, N, 1408, generator=g, device=DEV),
             "pc": torch.randint(0, 256, (BATCH, N, 3), generator=g, device=DEV),
             "pc_mask": torch.ones(BATCH, N, dtype=torch.int32, device=DEV),
             "input_ids": ids, "input_mask": (np.arange(64)[None] < lens[:, None]).astype(np.int64)}
    lfm2_predict_answers(model, batch, max_len=T)                 # captures
    c0, r0 = lfm2_mod.decode_graph_captures, lfm2_mod.decode_graph_replays
    reset_counts()
    replayed = lfm2_predict_answers(model, batch, max_len=T)
    torch.cuda.synchronize()
    captured_launches = read_counts()["moe_experts"]
    captures = lfm2_mod.decode_graph_captures - c0
    replays = lfm2_mod.decode_graph_replays - r0
    reset_counts()
    eager = lfm2_predict_answers(model, batch, max_len=T, graphs=False)
    torch.cuda.synchronize()
    eager_launches = read_counts()["moe_experts"]
    if not torch.equal(replayed, eager):
        fail("lfm2_predict_answers: replayed tokens != eager tokens")
    if captures != 0 or captured_launches != n_moe or eager_launches != n_moe * (1 + replays):
        fail(f"lfm2_predict_answers: {captures} captures after set-up, moe_experts launches "
             f"{captured_launches} a replayed batch (want {n_moe}), {eager_launches} eager "
             f"(want {n_moe} x {1 + replays})")
    del model
    torch.cuda.empty_cache()
    return {"moe_layers": n_moe, "steps_replayed": replays,
            "launches_replayed_batch": captured_launches, "launches_eager_batch": eager_launches}


def check_moe_experts() -> dict:
    """The expert layer at a decode step's 8 tokens and a prefill's 616
    (B=8, ~77 positions a row), and its launches on ``lfm2_predict_answers``."""
    shapes = [measure_moe(8), measure_moe(616)]
    rec = {k: sum(sh[k] for sh in shapes) for k in ("ms", "plain_ms", "bound_ms")}
    lib = [sh["library_ms"] for sh in shapes]
    rec.update(library_ms=None if None in lib else sum(lib),
               bound_by=shapes[-1]["bound_by"], max_abs_err=max(sh["max_rel_err"] for sh in shapes),
               library="torch._grouped_mm: the two grouped products alone, on rows grouped by "
                       "expert, without the routing weights, the sums or the dropped choices",
               shapes=shapes, lfm2=lfm2_launches())
    return rec


NEMOTRON_WIDTHS = dict(E=128, M=1856, D=2688, K=6)  # Nemotron-3-Nano-30B-A3B's expert layer
SSM_RTOL = 1e-4       # the scan and update, of the largest: float32 sums in another order
# sha256 of LFM2's expert layer (8 and 616 tokens) and of a 4-layer captured
# LFM2 decode's logits at the inputs of ``lfm2_digests``, as the kernels gave
# them before Nemotron-H's relu^2 form was added (H100 80GB HBM3)
LFM2_DIGESTS = {"moe_8": "0c784e78ca932d54", "moe_616": "b381127b7e65d455",
                "decode_tokens": "d0580fddd14d61fa", "decode_logits": "3991f06a90348ce8"}


def _sha(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()).hexdigest()[:16]


def lfm2_digests() -> dict:
    """LFM2's expert layer at LFM2-24B-A2B's widths (8 and 616 tokens) and a
    4-layer captured greedy decode's step logits, hashed: equal hashes are
    bit-equal outputs."""
    E, M, D, K = (LFM2_WIDTHS[k] for k in "EMDK")
    out = {}
    for tokens in (8, 616):
        g = torch.Generator(device=DEV).manual_seed(1000 + tokens)
        x = torch.randn(tokens, D, generator=g, device=DEV).bfloat16()
        w1 = (torch.randn(E, M, D, generator=g, device=DEV) / D ** 0.5).bfloat16()
        w3 = (torch.randn(E, M, D, generator=g, device=DEV) / D ** 0.5).bfloat16()
        w2 = (torch.randn(E, D, M, generator=g, device=DEV) / M ** 0.5).bfloat16()
        idx = torch.topk(torch.rand(tokens, E, generator=g, device=DEV), K, -1).indices.int()
        idx[::7, 1] = -1
        w = torch.rand(tokens, K, generator=g, device=DEV)
        out[f"moe_{tokens}"] = _sha(moe_experts.moe_experts(x, idx, w, w1, w3, w2))
    cfg = LFM2Config(layer_types=("conv", "conv", "full_attention", "conv"),
                     num_hidden_layers=4)
    model = Blip2LFM2(QFormerConfig(), cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                      device=DEV, seed=SEED)
    g = torch.Generator(device=DEV).manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    lens = rng.randint(13, 44, BATCH)
    ids = np.zeros((BATCH, 64), np.int64)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.randint(8, cfg.vocab_size, n)
    N = QFormerConfig().scene_token_capacity
    batch = {"pc_feat": torch.randn(BATCH, N, 1408, generator=g, device=DEV),
             "pc": torch.randint(0, 256, (BATCH, N, 3), generator=g, device=DEV),
             "pc_mask": torch.ones(BATCH, N, dtype=torch.int32, device=DEV),
             "input_ids": ids, "input_mask": (np.arange(64)[None] < lens[:, None]).astype(np.int64)}
    tokens = lfm2_predict_answers(model, batch, max_len=10)
    captured = next(iter(model.decode_graphs.keys.values()))
    out["decode_tokens"] = _sha(tokens)
    out["decode_logits"] = _sha(torch.stack([x.clone() for x in captured.logits]))
    del model, captured
    torch.cuda.empty_cache()
    return out


def measure_relu2_moe(tokens: int) -> dict:
    """``moe_experts``' relu^2 form at Nemotron-3-Nano's widths against its
    plain version, choices drawn uniformly, a few dropped; the call's time,
    the plain version's, and the bound (each chosen expert's two matrices
    read once, or 4 D M operations a routed row at the bf16 peak)."""
    E, M, D, K = (NEMOTRON_WIDTHS[k] for k in "EMDK")
    g = torch.Generator(device=DEV).manual_seed(tokens)
    x = torch.randn(tokens, D, generator=g, device=DEV).bfloat16()
    up = (torch.randn(E, M, D, generator=g, device=DEV) / D ** 0.5).bfloat16()
    down = (torch.randn(E, D, M, generator=g, device=DEV) / M ** 0.5).bfloat16()
    idx = torch.topk(torch.rand(tokens, E, generator=g, device=DEV), K, -1).indices.int()
    idx[::7, 1] = -1
    w = torch.rand(tokens, K, generator=g, device=DEV)
    c_kernel = torch.zeros(2, dtype=torch.int64, device=DEV)
    c_plain = torch.zeros(2, dtype=torch.int64, device=DEV)
    got = moe_experts.moe_experts(x, idx, w, up, None, down, c_kernel)
    want = moe_experts.moe_experts_plain(x, idx, w, up, None, down, c_plain)
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= MOE_RTOL:
        fail(f"moe_experts relu2 {tokens} tokens: max err {err} > {MOE_RTOL} of the largest")
    if c_kernel.tolist() != c_plain.tolist():
        fail(f"moe_experts relu2 {tokens} tokens: counters {c_kernel.tolist()} != plain "
             f"{c_plain.tolist()}")
    rows, read = c_plain.tolist()
    bytes_ms = (read * 2 * D * M * 2 + tokens * D * (2 + 4)) / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * 4 * D * M / BF16_FLOPS * 1e3
    return {"tokens": tokens, "rows_routed": rows, "experts_read": read, "max_rel_err": err,
            "ms": time_cuda(lambda: moe_experts.moe_experts(x, idx, w, up, None, down), iters=10),
            "plain_ms": time_cuda(lambda: moe_experts.moe_experts_plain(x, idx, w, up, None, down),
                                  iters=2, warmup=1),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def measure_ssm(L: int) -> dict:
    """The prefill scan (B=8 rows of ``L`` positions, a third of them pad)
    and the decode update (B=8) at Nemotron-3-Nano's widths against their
    plain versions; CUDA-event times and the bounds (``flops/nemotron_h.py``'s
    bytes: x, B, C, dt read and y written a position, the state written a
    prefill row, read and written a decode row)."""
    B, H, G, P, N = BATCH, 64, 8, 64, 128
    conv = H * P + 2 * G * N
    g = torch.Generator(device=DEV).manual_seed(L)
    xbc = torch.randn(B, L, conv, generator=g, device=DEV)
    dt = torch.nn.functional.softplus(torch.randn(B, L, H, generator=g, device=DEV) - 3)
    dt[:, :L // 3] = 0
    A = -torch.rand(H, generator=g, device=DEV) * 15 - 1
    D = torch.ones(H, device=DEV)
    keep = dt[..., 0] > 0
    s_k = torch.empty(B, H, P, N, device=DEV)
    s_p = torch.empty_like(s_k)
    y_k = ssm_scan.ssm_scan(xbc, dt, A, D, G, N, s_k, keep)
    y_p = ssm_scan.ssm_scan_plain(xbc, dt, A, D, G, N, s_p)
    u_k = ssm_scan.ssm_update(xbc[:, -1].contiguous(), dt[:, -1].contiguous(), A, D, G, N, s_k)
    u_p = ssm_scan.ssm_update_plain(xbc[:, -1], dt[:, -1], A, D, G, N, s_p)
    torch.cuda.synchronize()
    errs = {k: float((a - b).abs().max() / b.abs().max())
            for k, (a, b) in {"scan_y": (y_k, y_p), "update_y": (u_k, u_p),
                              "state": (s_k, s_p)}.items()}
    for k, e in errs.items():
        if not e <= SSM_RTOL:
            fail(f"ssm L={L} {k}: max err {e} > {SSM_RTOL} of the largest")
    pos, state = (conv + H + H * P) * 4, H * P * N * 4
    x1, d1 = xbc[:, -1].contiguous(), dt[:, -1].contiguous()
    return {"L": L, "max_rel_err": errs,
            "scan_ms": time_cuda(lambda: ssm_scan.ssm_scan(xbc, dt, A, D, G, N, s_k, keep),
                                 iters=10),
            "scan_plain_ms": time_cuda(lambda: ssm_scan.ssm_scan_plain(xbc, dt, A, D, G, N, s_p),
                                       iters=3, warmup=1),
            "scan_bound_ms": (B * L * pos + B * state) / HBM_BYTES_PER_S * 1e3,
            "update_ms": time_cuda(lambda: ssm_scan.ssm_update(x1, d1, A, D, G, N, s_k),
                                   iters=20),
            "update_plain_ms": time_cuda(lambda: ssm_scan.ssm_update_plain(x1, d1, A, D, G, N,
                                                                           s_p), iters=5),
            "update_bound_ms": B * (pos + 2 * state) / HBM_BYTES_PER_S * 1e3}


def nemotron_captured_decode() -> dict:
    """``predict_answers`` at Nemotron-3-Nano's widths cut to 4 layers
    (Mamba, experts, attention, experts), B=8, 10 tokens: the replayed
    steps' tokens and logits equal the eager ones, and the launches of the
    SSM and expert kernels around a replayed batch (the prefill's) and an
    eager one."""
    from situation3d_tpu_torch.models.blip2_nemotron_h import Blip2NemotronH
    from situation3d_tpu_torch.models.blip2_lfm2 import predict_answers
    from situation3d_tpu_torch.models.nemotron_h import NemotronHConfig
    cfg = NemotronHConfig(hybrid_override_pattern="ME*E", num_hidden_layers=4)
    model = Blip2NemotronH(QFormerConfig(), cfg, dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16, device=DEV, seed=SEED)
    g = torch.Generator(device=DEV).manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    lens = rng.randint(13, 44, BATCH)
    ids = np.zeros((BATCH, 64), np.int64)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.randint(8, cfg.vocab_size, n)
    N = QFormerConfig().scene_token_capacity
    batch = {"pc_feat": torch.randn(BATCH, N, 1408, generator=g, device=DEV),
             "pc": torch.randint(0, 256, (BATCH, N, 3), generator=g, device=DEV),
             "pc_mask": torch.ones(BATCH, N, dtype=torch.int32, device=DEV),
             "input_ids": ids, "input_mask": (np.arange(64)[None] < lens[:, None]).astype(np.int64)}
    T = 10
    predict_answers(model, batch, max_len=T)                       # captures
    l0, m0 = ssm_scan.launches, moe_experts.launches
    replayed = predict_answers(model, batch, max_len=T)
    captured = next(iter(model.decode_graphs.keys.values()))
    logits = torch.stack([x.clone() for x in captured.logits])
    torch.cuda.synchronize()
    l1, m1 = ssm_scan.launches - l0, moe_experts.launches - m0
    eager = predict_answers(model, batch, max_len=T, graphs=False)
    torch.cuda.synchronize()
    l2, m2 = ssm_scan.launches - l0 - l1, moe_experts.launches - m0 - m1
    if not torch.equal(replayed, eager):
        fail("nemotron predict_answers: replayed tokens != eager tokens")
    lm = model.lm
    with torch.no_grad():
        b = lfm2_mod.GreedyBuffers(lm, BATCH, model.prefix_slots, T, DEV)
        b.reset(cfg.pad_token_id, cfg.pad_token_id)
        embeds, m = model.prefix(batch)
        b.emit(0, lm.prefill(embeds, m, b.cache), cfg.eos_token_id, cfg.pad_token_id, True)
        for i in range(1, T):
            step = lfm2_mod.greedy_step(lm, b, i, cfg.eos_token_id, cfg.pad_token_id, True)
            if not torch.equal(step, logits[i - 1]):
                fail(f"nemotron decode step {i}: replayed logits != eager")
    if (l1, m1) != (1, 2) or (l2, m2) != (T, 2 * T):
        fail(f"nemotron launches: replayed batch ssm {l1} moe {m1} (want 1, 2), eager ssm {l2} "
             f"moe {m2} (want {T}, {2 * T})")
    del model
    torch.cuda.empty_cache()
    return {"launches_replayed_batch": {"ssm": l1, "moe_experts": m1},
            "launches_eager_batch": {"ssm": l2, "moe_experts": m2}}


def phase_nemotron() -> dict:
    """Nemotron-H's kernels against their plain versions (the scan and the
    update, the relu^2 expert layer at a decode step's 8 tokens and a
    prefill's 616), its captured decode against eager, and LFM2's expert
    layer and captured decode bit-equal to before (``LFM2_DIGESTS``)."""
    rec = {"ssm": [measure_ssm(1), measure_ssm(77), measure_ssm(432)],
           "moe_relu2": [measure_relu2_moe(8), measure_relu2_moe(616)],
           "decode": nemotron_captured_decode(), "lfm2_digests": lfm2_digests()}
    for k, want in LFM2_DIGESTS.items():
        if rec["lfm2_digests"].get(k) != want:
            fail(f"LFM2 {k}: digest {rec['lfm2_digests'].get(k)} != before {want}")
    emit("nemotron", **rec)
    return rec


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
                    "k3_map_lookup": 3, "k3_map_lookup_bits": 1, "k5_map_lookup": 1,
                    "gather_rows": 1, "scatter_add_rows": 2,   # token pooling
                    "segment_plan": 1, "fps": 0, "moe_experts": 0}   # one plan, two sums
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


def phase_minkunet(cfg, batch) -> dict:
    """The full MinkUNet forward (``sparse.final_result=true``: encoder,
    decoder and the 768-d head) at B=8 and the default capacities, bf16,
    seeded random weights: plan + 41 conv launches, ``openscene_out``
    ``[8, 49152, 768]`` finite, ms a forward, peak memory; then a small f32
    instance on the card (kernels) against the CPU (plain versions)."""
    ucfg = apply_overrides(cfg, ["sparse.final_result=true"])
    sp = ucfg.sparse
    net = MinkUNet(sp, torch.bfloat16).to(DEV).eval()
    init_random_weights(net, SEED + 40)
    B = batch["voxel_mask"].shape[0]

    def forward():
        x = SparseVoxels(batch["voxel_coords"], batch["voxel_feats"], batch["voxel_mask"], 1)
        plan = build_unet_plan(x.coords, x.mask, sp.capacities, tuple(sp.grid_extent),
                               device=DEV)
        return net(x, plan)

    with torch.inference_mode():
        forward()
        torch.cuda.synchronize()
        reset_counts()                       # just before the path ...
        out = forward()
        torch.cuda.synchronize()
        counts = read_counts()               # ... and just after
        expected = {name: 0 for name in KERNEL_COUNTERS}
        # encoder: conv0, 4 down convs, 2 convs a block; decoder: 4
        # transposed convs, 2 convs a block (41 at the defaults)
        n_conv = 1 + 4 + 2 * sum(sp.layers[:4]) + 4 + 2 * sum(sp.layers[4:8])
        expected.update({"fused_sparse_conv": n_conv, "k3_map_lookup": 3,
                         "k3_map_lookup_bits": 1, "k5_map_lookup": 1})
        if counts != expected:
            fail(f"minkunet: kernel launches on one forward {counts} != expected {expected}")
        o = out["openscene_out"].feats
        if tuple(o.shape) != (B, sp.capacities[0], sp.out_channels) or \
                not bool(torch.isfinite(o.float()).all()):
            fail(f"minkunet: openscene_out {tuple(o.shape)} is wrong or not finite")
        for k in ("feat_bottleneck", "feat_layer5", "feat_layer6"):
            if not bool(torch.isfinite(out[k].feats.float()).all()):
                fail(f"minkunet: {k} is not finite")
        del out, o
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del net

    # small f32 instance: card against CPU, same weights and voxels
    scfg = apply_overrides(small_cfg(), ["sparse.final_result=true", "sparse.out_channels=64"])
    ss = scfg.sparse
    sbatch, _, _ = make_scene_batch(scfg, 2, np.random.RandomState(SEED + 41), device="cpu")
    cpu = MinkUNet(ss).eval()
    init_random_weights(cpu, SEED + 42)
    gpu = MinkUNet(ss).to(DEV).eval()
    gpu.load_state_dict(cpu.state_dict())
    errs = {}
    with torch.inference_mode():
        res = {}
        for name, m, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, DEV)):
            x = SparseVoxels(*(sbatch[k].to(dev) for k in
                               ("voxel_coords", "voxel_feats", "voxel_mask")), 1)
            plan = build_unet_plan(x.coords, x.mask, ss.capacities, tuple(ss.grid_extent),
                                   device=dev)
            res[name] = {k: v.feats.float().cpu() for k, v in m(x, plan).items()}
    for k, want in res["cpu"].items():
        errs[k] = float((res["gpu"][k] - want).abs().max())
        if not errs[k] <= SMALL_ATOL:
            fail(f"minkunet small f32 {k}: card vs CPU max abs err {errs[k]} > {SMALL_ATOL}")
    emit("minkunet", batch_size=B, dtype="bfloat16", final_result=True,
         openscene_out_shape=[B, sp.capacities[0], sp.out_channels], finite=True,
         launches_per_forward=counts, seconds_per_forward=round(dt, 5),
         samples_per_s=round(B / dt, 3), peak_memory_gb=round(peak, 2),
         small_f32_card_vs_cpu_max_abs_err=errs, small_atol=SMALL_ATOL)
    return counts


def _expected_train_counts(cfg, unfrozen: bool) -> dict:
    """Kernel launches of one training step. Forward: 21 convs, 3 + 1 + 1
    map kernels (k3 grid, k3 bits, k5), 1 token gather, 2 segment sums
    (features, counts) over 1 segment plan. An unfrozen encoder adds,
    backward: 20 convs as ``dx`` (conv0's input needs none), one dy-gather
    per chunk of offsets per conv for ``dW``, the gather that is the segment
    sum's backward and the scatter-add (with its own plan) that is the token
    gather's."""
    n_conv = 1 + 4 + 2 * sum(cfg.sparse.layers[:4])
    exp = {"fused_sparse_conv": n_conv, "k3_map_lookup": 3, "k3_map_lookup_bits": 1,
           "k5_map_lookup": 1, "gather_rows": 1, "scatter_add_rows": 2, "segment_plan": 1, "fps": 0,
           "moe_experts": 0}
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
        exp["segment_plan"] += 1          # the token gather's scatter-add plans anew
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
    # the decoder's kernels are off the loss's path: no gradient
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
             if n.startswith("scene_encoder") and n.endswith("kernel") and p.grad is not None}
    state.optimizer.discard()
    for g, st in zip(gens, saved):
        g.set_state(st)
    torch.cuda.synchronize()
    return grads


def check_decoder_update(tcfg, model, state, before, trainable, mode) -> dict:
    """The UNet's decoder is in SIG3D's parameters but not on its loss's
    path. Unfrozen, its tensors are trainable: each kernel must have been
    scaled by decoupled weight decay alone, by ``1 - lr_i * wd`` at each
    update (rtol 1e-6), and its batch-norm scales and biases must be
    bit-unchanged (zero gradient, no decay). Frozen, all of it stays put."""
    names = [n for n, _ in model.named_parameters()
             if n.startswith("scene_encoder.") and n.split(".")[1] in
             {m for stage in DECODER[:2] for m in stage[:3]}]
    if not names:
        fail("train: the scene encoder has no decoder parameters")
    params = dict(model.named_parameters())
    wd = tcfg.train.weight_decay
    lam = state.optimizer.scheduler.lr_lambdas[0]
    steps = [1.0 - lam(i) * wd for i in range(state.optimizer.updates)]
    kernels = [n for n in names if params[n].dim() >= 2]
    norms = [n for n in names if params[n].dim() < 2]
    if mode == "frozen":
        if any(n in trainable for n in names) or \
                any(not torch.equal(params[n], before[n]) for n in names):
            fail("train frozen: a decoder parameter is trainable or moved")
        return {"tensors": len(names), "bit_unchanged": True}
    if any(n not in trainable for n in names):
        fail("train unfrozen: a decoder parameter is not trainable")
    worst = 0.0
    for n in kernels:
        want = before[n].clone()
        for f in steps:            # the decay AdamW applies, step by step in f32
            want.mul_(f)
        err = float(((params[n].detach() - want).abs() / want.abs().clamp(min=1e-30)).max())
        worst = max(worst, err)
        if torch.equal(params[n], before[n]) or not err <= 1e-6:
            fail(f"train unfrozen: decoder kernel {n} moved by more than weight decay "
                 f"(rel err {err})")
    changed = [n for n in norms if not torch.equal(params[n], before[n])]
    if changed:
        fail(f"train unfrozen: decoder batch-norm parameters changed: {changed[:4]}")
    return {"tensors": len(names), "kernels_scaled_by_decay_alone": len(kernels),
            "decay_factor": float(np.prod(steps)), "kernel_max_rel_err": worst,
            "norm_parameters_bit_unchanged": len(norms)}


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
        decoder = check_decoder_update(tcfg, model, state, before, trainable, mode)
        report[mode] = {
            "steps": warmup + timed, "loss_first": losses[0], "loss_last": losses[-1],
            "trainable_tensors": len(trainable), "frozen_tensors": len(before) - len(trainable),
            "moved_tensors": len(moved), "frozen_bit_unchanged": True,
            "trainable_parameters": sum(p.numel() for n, p in model.named_parameters()
                                        if n in trainable),
            "decoder": decoder,
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
    serving_question_graphs(cfg, model, batch, cache, answers[0][0])


def _eager_forward(model, batch, **kw):
    """``model(batch)`` with its question side eager: grad on, with nothing
    requiring it, so that autograd records nothing."""
    flags = [p.requires_grad for p in model.parameters()]
    model.requires_grad_(False)
    try:
        with torch.enable_grad():
            return model(batch, **kw)
    finally:
        for p, f in zip(model.parameters(), flags):
            p.requires_grad_(f)


def _question_batch(cfg, batch, s: int, rng) -> dict:
    """``QUESTION_BATCH`` fresh questions, of 5-40 words, about scene ``s``
    of ``batch``, in its situation."""
    B, L = QUESTION_BATCH, cfg.data.max_text_len
    q_mask = (np.arange(L)[None] < rng.randint(5, 41, (B, 1))).astype(np.int32)
    return {"s_ids": batch["s_ids"][s:s + 1].expand(B, L),
            "s_mask": batch["s_mask"][s:s + 1].expand(B, L),
            "q_ids": torch.as_tensor(rng.randint(4, 30000, (B, L)).astype(np.int32)),
            "q_mask": torch.as_tensor(q_mask),
            "auxiliary_task": batch["auxiliary_task"][s:s + 1].expand(B, 7)}


def serving_question_graphs(cfg, model, batch, cache, sid) -> dict:
    """The question side replayed from its captured graph against the eager
    forward on the card, at the answer cells' B=32: ``QUESTION_CALLS``
    batches through ``SceneCache.answer`` (tokens of one cached scene) and
    as many full forwards (the batch's scenes, repeated), under inference
    mode as the cells run them; every output bit-equal, one capture and a
    replay a batch each, the first batch's outputs unchanged by the later
    replays. Then one B=32 question side timed each way (CUDA events)."""
    rng = np.random.RandomState(SEED + 4)
    B, n = QUESTION_BATCH, batch["voxel_mask"].shape[0]
    toks, pos = cache._cache[sid]
    reps = -(-B // n)
    voxels = {k: v.repeat(reps, *([1] * (v.dim() - 1)))[:B] for k, v in batch.items()
              if k.startswith("voxel_")}
    rec = {"batch_size": B, "calls": QUESTION_CALLS}
    for form in ("scene_cache", "full_forward"):
        model.question_graphs.keys.clear()
        c0, r0 = sig3d_mod.question_graph_captures, sig3d_mod.question_graph_replays
        served = []
        for k in range(QUESTION_CALLS):
            q = _question_batch(cfg, batch, k % n, rng)
            if form == "scene_cache":
                with torch.inference_mode():
                    got = cache.answer(sid, q)
                eager_in = {**q, "scene_tokens": toks.expand(B, *toks.shape[1:]),
                            "scene_token_positions": pos.expand(B, *pos.shape[1:])}
                kw = {}
            else:
                kw = {"sample_draws": make_sample_draws(B, cfg.sparse.capacities[-1],
                                                        cfg.model.num_scene_tokens,
                                                        torch.Generator().manual_seed(SEED + k),
                                                        DEV)}
                eager_in = {**q, **voxels}
                with torch.inference_mode():
                    got = model(eager_in, **kw)
            served.append((got, {kk: v.clone() for kk, v in got.items()}, eager_in, kw))
        captures = sig3d_mod.question_graph_captures - c0
        replays = sig3d_mod.question_graph_replays - r0
        unequal = []
        for k, (got, kept, eager_in, kw) in enumerate(served):
            want = _eager_forward(model, eager_in, **kw)
            if set(got) != set(want):
                unequal.append((k, sorted(set(got) ^ set(want))))
            unequal += [(k, key) for key in want if key in got and not (
                torch.equal(got[key], want[key]) and torch.equal(got[key], kept[key]))]
        rec[form] = {"captures": captures, "replays": replays, "bit_equal": not unequal}
        if unequal or captures != 1 or replays != QUESTION_CALLS:
            fail(f"serving question graphs, {form}: {rec[form]}; outputs that differ from the "
                 f"eager forward (batch, key): {unequal[:8]}")
        if form == "scene_cache":
            (cap,) = model.question_graphs.keys.values()
            with torch.inference_mode():
                rec["eager_question_us"] = round(1e3 * time_cuda(
                    lambda: model._question(cap.inputs, B), iters=10), 1)
                rec["replayed_question_us"] = round(1e3 * time_cuda(cap.replay, iters=10), 1)
    emit("serving_question_graphs", **rec)
    model.question_graphs.keys.clear()
    return rec


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
    (the votes are computed by the network; the cloud is not), each with
    its own segment plan."""
    exp = {name: 0 for name in KERNEL_COUNTERS}
    exp["fps"] = 5
    exp["gather_rows"] = 2 + 3 * 3 + 2 + 3
    if backward:
        exp["scatter_add_rows"] = exp["segment_plan"] = 3 + 2 + 3
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


# ---------------------------------------------------------------------------
# SIG3D trained and evaluated from SQA3D-layout files through the entry points

SQA_POINTS = 120000   # points a scene: the size of a ScanNet vh_clean_2 mesh
SQA_STEPS = 4
SQA_THIN = 10000      # voxels a sample kept for the full-plan comparison (no level overflows)
FEAT_RTOL = 2e-2      # bf16 feat_bottleneck, host plan vs device plan, relative to its largest value
_SITUATIONS = [
    "I am standing by the window with the bed on my left and the door behind me, "
    "looking at the desk where my laptop is.",
    "I am sitting on the sofa facing the television; the kitchen counter is to my right.",
    "I just walked in through the door and the table with four chairs is in front of me.",
]
_QUESTIONS = ["What is on the table in front of me?", "Is the door behind me open?",
              "How many chairs are there to my left?", "Which way should I turn to reach "
              "the sink?", "Can I see the window without turning around?",
              "What color is the cabinet on my right?"]


def write_sqa3d_room_files(root: str) -> list:
    """Three rooms (8 x 6 x 3 m: floor, walls and 4-10 boxes, as
    ``make_detection_arrays`` builds them) of ``SQA_POINTS`` points, colors
    in [-1, 1], labels in 0..19 with ~5% unannotated (-100), a z-rotation +
    translation as axis alignment; 16 records on each of the two train
    scenes, 16 on the val scene, yaw-only situation poses; 706 answers.
    Returns the ``data.*`` overrides."""
    rng = np.random.RandomState(SEED + 60)
    rooms = make_detection_arrays(3, SQA_POINTS, rng)["point_clouds"]
    answers = [f"answer{k}" for k in range(706)]
    scenes, records = {}, {"train": [], "val": []}
    for i, split in enumerate(("train", "train", "val")):
        sid = f"scene{i:04d}_00"
        labels = rng.randint(0, 20, SQA_POINTS).astype(np.int64)
        labels[rng.rand(SQA_POINTS) < 0.05] = -100
        aa = np.eye(4)
        a = 0.3 + 0.7 * i
        aa[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        aa[:3, 3] = [1.5, -2.0, 0.05]
        scenes[sid] = {"split": split, "labels": labels, "axis_align": aa,
                       "locs": (rooms[i] - np.array([4.0, 3.0, 1.5], np.float32)),
                       "feats": rng.uniform(-1, 1, (SQA_POINTS, 3)).astype(np.float32)}
        for k in range(16):
            yaw = rng.rand() * 2 * np.pi
            records[split].append({
                "scene_id": sid, "question_id": 1000 * i + k,
                "situation": _SITUATIONS[k % len(_SITUATIONS)],
                "question": _QUESTIONS[k % len(_QUESTIONS)],
                "answers": [answers[rng.randint(0, 40)]],
                "position": [*(rng.rand(3) - 0.5) * [5.0, 3.5, 0.0],
                             0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)]})
    counter = {a: 1000 - k for k, a in enumerate(answers)}
    return write_sqa3d_files(root, scenes, records, counter)


class ForwardLaunches:
    """While active, records the kernel launches (and, for a
    ``final_result`` model, the host-clocked ms) of every ``SIG3D.forward``;
    the counters are read, never reset, so an enclosing count still holds."""

    def __enter__(self):
        self.calls, self._orig = [], SIG3D.forward
        orig = self._orig

        def forward(model, batch, *args, **kwargs):
            whole = model.cfg.sparse.final_result
            before = read_counts()
            if whole:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = orig(model, batch, *args, **kwargs)
            rec = {k: v - before[k] for k, v in read_counts().items()}
            rec.update(train=bool(kwargs.get("train", False)), final_result=whole,
                       host_plan="plan" in batch)
            if whole:
                torch.cuda.synchronize()
                rec["ms"] = (time.perf_counter() - t0) * 1e3
            self.calls.append(rec)
            return out

        SIG3D.forward = forward
        return self

    def __exit__(self, *exc):
        SIG3D.forward = self._orig


def _check_forward_launches(calls, where, total=None, dx_per_step=0):
    """Every forward: 21 convs (41 with the whole UNet) and, with a device
    plan, 3 + 1 + 1 map kernels; none with a host plan. ``total``: the
    counts around all of them, the training forwards' backward adding
    ``dx_per_step`` conv launches each (20 with the encoder trained)."""
    if not calls:
        fail(f"sqa3d {where}: no SIG3D forward ran")
    if total is not None:
        want = sum(c["fused_sparse_conv"] + dx_per_step * c["train"] for c in calls)
        if total["fused_sparse_conv"] != want:
            fail(f"sqa3d {where}: {total['fused_sparse_conv']} conv launches, expected {want}")
    for c in calls:
        maps = 0 if c["host_plan"] else 1
        want = {"fused_sparse_conv": 41 if c["final_result"] else 21,
                "k3_map_lookup": 3 * maps, "k3_map_lookup_bits": maps, "k5_map_lookup": maps}
        got = {k: c[k] for k in want}
        if got != want:
            fail(f"sqa3d {where}: kernel launches of one forward {got} != {want}")


def _expect_launches(counts, forwards, what):
    """``forwards`` forwards on host plans: 21 convs each and no map kernel."""
    want = {"fused_sparse_conv": 21 * forwards, "k3_map_lookup": 0,
            "k3_map_lookup_bits": 0, "k5_map_lookup": 0}
    if {k: counts[k] for k in want} != want:
        fail(f"sqa3d: {what} launched {counts}, expected {want}")


def _by_coordinate(sv: SparseVoxels, b: int):
    m = sv.mask[b].cpu().numpy()
    c = sv.coords[b].cpu().numpy()[m].astype(np.int64)
    order = np.argsort((c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2], kind="stable")
    return c[order], sv.feats[b].float().cpu().numpy()[m][order]


def _read_json(path):
    with open(path) as fh:
        return json.load(fh)


def _per_step(means):
    """Per-step values from the trainer's running means (``time/fetch`` and,
    up to 10 steps, ``time/step`` are means over every step so far)."""
    return [round(means[0], 4)] + [round((k + 1) * means[k] - k * means[k - 1], 4)
                                   for k in range(1, len(means))]


def _clean(batch):
    return {k: v for k, v in batch.items()
            if k not in ("question_id", "answer_cats", "voxel_labels")}


def phase_sqa3d(work: str) -> None:
    """``cli.train`` (4 steps) and ``cli.eval`` (plain, ``--scene-cache``,
    ``--segmentation --visualize``) on SQA3D-layout files at full width,
    B=8, bf16; then host plans against device plans on the same batch, a
    forward on a host plan and 2 training steps through the prefetch
    pipeline with host plans."""
    import gc
    import os
    t_phase = time.perf_counter()
    files = write_sqa3d_room_files(os.path.join(work, "data"))
    opts = [*FULL_WIDTH, *files, f"train.batch_size={BATCH}", f"eval.batch_size={BATCH}",
            "train.log_every_steps=1", "train.val_every_steps=1000",
            f"train.ckpt_dir={work}/ckpt", f"log.log_dir={work}/logs"]
    cfg = apply_overrides(Config(), opts)
    cap = cfg.data.voxel_capacity
    kept = {}
    for sid in ("scene0000_00", "scene0001_00", "scene0002_00"):
        scene = load_scene(cfg.data.scene_dir, cfg.data.scans_dir, sid)
        n = len(voxelize_np(scene.points - scene.points.min(0), cfg.data.voxel_size)[0])
        kept[sid] = {"points": len(scene.points), "voxels": n, "kept": min(n, cap)}
    emit("sqa3d_files", capacity=cap, scenes=kept)

    # ---- train through the entry point ---------------------------------
    reset_counts()
    with ForwardLaunches() as fw:
        t0 = time.perf_counter()
        final = cli_train.main(["--task", "sqa3d", "--max-steps", str(SQA_STEPS),
                                "--device", DEV, "--output", f"{work}/run", "--options", *opts])
        train_s = time.perf_counter() - t0
    train_counts = read_counts()
    info = _read_json(f"{work}/run/info.json")
    if info["num_train"] != 32 or info["num_val"] != 16:
        fail(f"sqa3d: info.json {info}: the files were not read")
    with open(f"{work}/logs/metrics.jsonl") as fh:
        rows = [json.loads(x) for x in fh]
    steps = [r for r in rows if "loss" in r]
    if [r["step"] for r in steps] != list(range(1, SQA_STEPS + 1)) or \
            not all(np.isfinite(r["loss"]) for r in steps):
        fail(f"sqa3d: training losses {[(r['step'], r.get('loss')) for r in steps]}")
    if not os.path.exists(f"{work}/ckpt/step_{SQA_STEPS}.pt"):
        fail("sqa3d: no checkpoint written")
    n_train = sum(c["train"] for c in fw.calls)
    if n_train != SQA_STEPS:
        fail(f"sqa3d: {n_train} training forwards, expected {SQA_STEPS}")
    _check_forward_launches(fw.calls, "train", train_counts,
                            0 if "scene_encoder" in cfg.train.frozen_prefixes else 20)
    emit("sqa3d_train", steps=SQA_STEPS, batch_size=BATCH, info=info,
         losses=[r["loss"] for r in steps],
         fetch_s=_per_step([r["time/fetch"] for r in steps]),
         step_s=_per_step([r["time/step"] for r in steps]),
         final_val_acc=final["answer_acc_at1"],
         launches=train_counts, forwards=len(fw.calls), seconds=round(train_s, 3))
    gc.collect()
    torch.cuda.empty_cache()

    # ---- evaluate the checkpoint ----------------------------------------
    evals = {}
    for name, flags in (("plain", []), ("scene_cache", ["--scene-cache"]),
                        ("segmentation", ["--segmentation", "--visualize"])):
        out = f"{work}/eval_{name}"
        torch.cuda.reset_peak_memory_stats()
        with ForwardLaunches() as fw:
            res = cli_eval.main(["--task", "sqa3d", "--checkpoint", "latest", "--device", DEV,
                                 "--output", out, "--options", *opts, *flags])
        if res["step"] != SQA_STEPS:
            fail(f"sqa3d eval {name}: restored step {res['step']} != {SQA_STEPS}")
        metrics = _read_json(f"{out}/metrics.json")
        if not all(np.isfinite(v) for v in metrics.values()) or \
                not 0.0 <= metrics["answer_acc_at1"] <= 1.0:
            fail(f"sqa3d eval {name}: metrics {metrics}")
        if name != "scene_cache":
            _check_forward_launches(fw.calls, f"eval {name}")
        rec = {"step": res["step"], "answer_acc_at1": metrics["answer_acc_at1"],
               "questions": res["num_questions"], "eval_seconds": round(res["eval_seconds"], 4),
               "questions_per_s": round(res["num_questions"] / res["eval_seconds"], 3)}
        if name == "segmentation":
            seg = [c for c in fw.calls if c["final_result"]]
            if not seg or not 0.0 <= metrics["seg_mIoU"] <= 1.0:
                fail(f"sqa3d segmentation: {len(seg)} forwards, mIoU {metrics.get('seg_mIoU')}")
            for i in range(min(4, BATCH)):
                for f in (f"scene{i}_points.ply", f"scene{i}_situation.obj",
                          f"scene{i}_render.png", f"images/eval_scene{i}_{SQA_STEPS}.png"):
                    if not os.path.getsize(f"{out}/{f}") > 0:
                        fail(f"sqa3d --visualize: {f} missing")
            rec.update(seg_mIoU=metrics["seg_mIoU"], seg_accuracy=metrics["seg_accuracy"],
                       segmentation_forwards=len(seg),
                       segmentation_launches=[c["fused_sparse_conv"] for c in seg],
                       segmentation_forward_ms=[round(c["ms"], 3) for c in seg],
                       peak_memory_gb=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
        evals[name] = rec
        gc.collect()
        torch.cuda.empty_cache()
    # ---- one question through cli.infer from the same checkpoint --------
    answer = cli_infer.main(["--task", "sqa3d", "--scene", "scene0002_00",
                             "--question", _QUESTIONS[0], "--checkpoint", f"{work}/ckpt",
                             "--answer-vocab", f"{work}/run/answer_vocab.json",
                             "--device", DEV, "--options", *opts])
    if answer not in _read_json(f"{work}/run/answer_vocab.json"):
        fail(f"sqa3d cli.infer: answer {answer!r} is not in the run's vocabulary")
    evals["infer"] = {"scene": "scene0002_00", "answer": answer}
    gc.collect()
    torch.cuda.empty_cache()
    emit("sqa3d_eval", **evals)

    # ---- host plans against device plans --------------------------------
    if not native.ensure_built():
        fail("sqa3d: the host library (native/voxelhash.cpp) did not build")
    counter = load_answer_counter(cfg.data.answer_counter)
    vocab = build_answer_vocab(counter, cfg.data.answer_min_freq, cfg.data.num_answers)
    train_ds = SQA3DDataset(cfg, "train", vocab, counter)
    batch = _clean(next(batch_iterator(train_ds, BATCH, shuffle=False)))
    caps, extent = cfg.sparse.capacities, tuple(cfg.sparse.grid_extent)
    coords_d = torch.as_tensor(batch["voxel_coords"], device=DEV)
    mask_d = torch.as_tensor(batch["voxel_mask"], device=DEV)
    host_ms, dev_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        hplan = build_host_plan(batch["voxel_coords"], batch["voxel_mask"], caps)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dplan = build_unet_plan(coords_d, mask_d, caps, extent, device=DEV)
        torch.cuda.synchronize()
        dev_ms.append((time.perf_counter() - t0) * 1e3)
    compared, problems = compare_with_device_plan(hplan, dplan)
    if problems:
        fail(f"sqa3d host plan vs device plan: {problems[:5]}")
    # a thinned copy of the batch (its first SQA_THIN voxels a sample): no
    # level overflows, so every level is compared and the bottlenecks match
    thin_mask = batch["voxel_mask"] & (np.arange(cap) < SQA_THIN)[None]
    thin_host = build_host_plan(batch["voxel_coords"], thin_mask, caps)
    thin_dev = build_unet_plan(coords_d, torch.as_tensor(thin_mask, device=DEV), caps,
                               extent, device=DEV)
    thin_compared, problems = compare_with_device_plan(thin_host, thin_dev)
    if problems or thin_compared != list(range(len(caps))):
        fail(f"sqa3d thinned batch: levels {thin_compared} compared, {problems[:5]}")

    model = SIG3D(cfg, cfg.data.num_answers, dtype=torch.bfloat16, device=DEV)
    init_random_weights(model, SEED + 61)
    draws = make_sample_draws(BATCH, caps[-1], cfg.model.num_scene_tokens,
                              torch.Generator().manual_seed(SEED + 62), DEV)
    with torch.inference_mode():
        reset_counts()
        out_h = model({**batch, "plan": hplan}, sample_draws=draws)
        torch.cuda.synchronize()
        counts_h = read_counts()
        _expect_launches(counts_h, 1, "a forward on a host plan")
        if not bool(torch.isfinite(out_h["answer_scores"]).all()):
            fail("sqa3d: answers on a host plan are not finite")
        x = SparseVoxels(coords_d.to(torch.int32),
                         torch.as_tensor(batch["voxel_feats"], device=DEV).to(torch.bfloat16),
                         torch.as_tensor(thin_mask, device=DEV), 1)
        bott_h = model.scene_encoder(x, tree_to_device(thin_host, DEV),
                                     bottleneck_only=True)["feat_bottleneck"]
        bott_d = model.scene_encoder(x, thin_dev, bottleneck_only=True)["feat_bottleneck"]
    worst, bit_equal, scale = 0.0, True, 0.0
    for b in range(BATCH):
        (ch, fh), (cd, fd) = _by_coordinate(bott_h, b), _by_coordinate(bott_d, b)
        if not np.array_equal(ch, cd):
            fail(f"sqa3d: bottleneck coordinates differ in sample {b}")
        scale = max(scale, float(np.abs(fd).max()))
        worst = max(worst, float(np.abs(fh - fd).max()))
        bit_equal &= bool(np.array_equal(fh, fd))
    if not worst <= FEAT_RTOL * max(scale, 1e-6):
        fail(f"sqa3d: feat_bottleneck host plan vs device plan max abs err {worst} > "
             f"{FEAT_RTOL} x {scale}")

    # ---- 2 training steps through the prefetch pipeline with host plans --
    tcfg = apply_overrides(cfg, [f"train.ckpt_dir={work}/ckpt_pipeline"])
    trainer = Trainer(tcfg, model, steps_per_epoch=4)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit((_clean(b) for b in make_train_pipeline(train_ds, BATCH, caps, seed=SEED,
                                                        epochs=1)), max_steps=2)
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    counts_p = read_counts()
    if trainer.state.step != 2:
        fail(f"sqa3d pipeline: {trainer.state.step} steps, expected 2")
    _expect_launches(counts_p, 2, "2 frozen training steps on host plans")
    emit("sqa3d_host_plan", native_built=True,
         levels_compared=compared, thinned_levels_compared=thin_compared,
         thinned_voxels_per_sample=int(thin_mask.sum(1).max()),
         overflow_host=hplan["overflow"]["voxels_dropped"].tolist(),
         overflow_device=dplan["overflow"]["voxels_dropped"].tolist(),
         host_plan_ms=[round(t, 3) for t in host_ms],
         device_plan_ms_host_clocked=[round(t, 3) for t in dev_ms],
         forward_on_host_plan_launches=counts_h,
         feat_bottleneck_max_abs_err=worst, feat_bottleneck_max_abs=scale,
         feat_bottleneck_rtol=FEAT_RTOL, feat_bottleneck_bit_equal=bit_equal,
         pipeline_steps=2, pipeline_launches=counts_p, pipeline_seconds=round(pipe_s, 3),
         phase_seconds=round(time.perf_counter() - t_phase, 2))


# ---------------------------------------------------------------------------
# The last slice: the sort-based plan past the grid extent, the training-form
# MinkUNet on OpenScene files, the GloVe + LSTM encoder, the multiview path
# ---------------------------------------------------------------------------

# bf16 answer scores, kernel vs plain conv route: each of the 21 conv
# outputs rounds to bf16 (2^-8), and a rounding that falls the other way moves
# what follows
SORT_RTOL = 2e-2
# metres: 800 x 700 x 150 voxels at 0.02 m, past the 512 x 512 x 256 extent
SCAN_ROOM = (16.0, 14.0, 3.0)
SCAN_POINTS = 200000  # points a room (floor, walls, boxes) before voxelization
OS_SCENES, OS_POINTS, OS_BATCH, OS_FEAT_DIM = 4, 120000, 4, 768
OS_RTOL = 1e-4        # float32 training-form UNet, kernel vs plain, relative to the largest
# ScanRefer's frames: 328 x 256 (W x H), features 41 x 32
MV_VIEWS, MV_IMAGE, MV_POINTS = 5, (256, 328), 40000
MV_ATOL = 1e-6        # back-projected features: the gather is exact
LSTM_STEPS = 3


def _bottleneck_kernel_vs_plain(model, batch, plan) -> tuple:
    """The scene encoder's ``feat_bottleneck`` on ``plan`` through the conv
    kernel and through its plain version: (max abs difference over the valid
    voxels, the plain route's largest value)."""
    x = SparseVoxels(batch["voxel_coords"].to(DEV, torch.int32),
                     batch["voxel_feats"].to(DEV, model.dtype),
                     batch["voxel_mask"].to(DEV, torch.bool), 1)
    kern = model.scene_encoder(x, plan, bottleneck_only=True)["feat_bottleneck"]
    kernel_conv = sparse_conv.fused_sparse_conv
    sparse_conv.fused_sparse_conv = fused_conv.fused_sparse_conv_plain
    try:
        plain = model.scene_encoder(x, plan, bottleneck_only=True)["feat_bottleneck"]
    finally:
        sparse_conv.fused_sparse_conv = kernel_conv
    if not torch.equal(kern.mask, plain.mask) or not bool(kern.mask.any()):
        fail("sortplan: the two conv routes' bottlenecks differ in their voxels, or hold none")
    m = kern.mask
    k, p = kern.feats.float()[m], plain.feats.float()[m]
    return float((k - p).abs().max()), float(p.abs().max())


def _plan_device_ms(coords, mask, sp, **flags) -> float:
    return time_cuda(lambda: build_unet_plan(coords, mask, sp.capacities,
                                             tuple(sp.grid_extent), device=DEV, **flags), 3, 1)


def _plans_equal(got, want) -> list:
    """Names of the plan tensors that differ."""
    bad = [f"level{i}/{k}" for i, (g, w) in enumerate(zip(got["levels"], want["levels"]))
           for k in sorted(set(g) | set(w)) if k not in g or k not in w
           or not torch.equal(g[k], w[k])]
    return bad + [f"overflow/{k}" for k in want["overflow"]
                  if not torch.equal(got["overflow"][k], want["overflow"][k])]


def scan_room_batch(cfg, B: int, rng) -> dict:
    """The ``forward`` phase's batch with its voxels replaced by B rooms of
    ``SCAN_ROOM`` (floor, walls and boxes as ``make_detection_arrays`` builds
    them) voxelized at ``data.voxel_size``; each sample keeps a random subset
    of ``capacities[0]`` voxels, as the data pipeline does."""
    batch, _, _ = make_scene_batch(cfg, B, rng, DEV)
    rooms = make_detection_arrays(B, SCAN_POINTS, rng, room=SCAN_ROOM)["point_clouds"]
    cap = cfg.sparse.capacities[0]
    coords = np.zeros((B, cap, 3), np.int32)
    mask = np.zeros((B, cap), bool)
    for b in range(B):
        vc = voxelize_np(rooms[b], cfg.data.voxel_size)[0]
        keep = np.sort(rng.permutation(len(vc))[:cap])
        coords[b, :len(keep)], mask[b, :len(keep)] = vc[keep], True
    batch["voxel_coords"] = torch.as_tensor(coords, device=DEV)
    batch["voxel_mask"] = torch.as_tensor(mask, device=DEV)
    batch["voxel_feats"] = torch.as_tensor(rng.rand(B, cap, 3).astype(np.float32) * 255
                                           * mask[..., None], device=DEV)
    return batch


def phase_sortplan(cfg, batch) -> dict:
    """(a) The ``forward`` phase's in-extent batch: the sort plan
    (``dense_lookup=false``) equals the default plan tensor for tensor (the
    reference's pin ``test_dense_lookup_matches_sort_path``); each plan's
    device time.
    (b) B scan-sized rooms past ``grid_extent``: the dense plan's
    ``extent_misses`` beside the sort plan's (0); the full-width bf16 SIG3D
    forward on the sort plan (finite answers; its kernel launches), against
    the same forward with the plain conv route on the card: the scene
    encoder's ``feat_bottleneck`` within ``FEAT_RTOL`` of the plain route's
    (beside the same reading on the in-extent batch, the control) and the
    answers within ``SORT_RTOL``."""
    sp = cfg.sparse
    t_phase = time.perf_counter()
    coords, mask = batch["voxel_coords"], batch["voxel_mask"]
    with torch.inference_mode():
        dense = build_unet_plan(coords, mask, sp.capacities, tuple(sp.grid_extent), device=DEV)
        plans_ms = {"dense": _plan_device_ms(coords, mask, sp)}
        plan = build_unet_plan(coords, mask, sp.capacities, tuple(sp.grid_extent),
                               device=DEV, dense_lookup=False)
        bad = _plans_equal(plan, dense)
        if bad:
            fail(f"sortplan in extent: the sort plan differs from the dense plan at {bad[:6]}")
        plans_ms["sort"] = _plan_device_ms(coords, mask, sp, dense_lookup=False)
        if int(dense["overflow"]["extent_misses"].sum()) != 0:
            fail("sortplan: the forward phase's batch is not inside the extent")
    del dense, plan
    emit("sortplan_in_extent", batch_size=BATCH, plans_equal=True,
         plan_device_ms={k: round(v, 4) for k, v in plans_ms.items()})

    room = scan_room_batch(cfg, BATCH, np.random.RandomState(SEED + 50))
    scfg = apply_overrides(cfg, ["sparse.dense_lookup=false"])
    rc, rm = room["voxel_coords"], room["voxel_mask"]
    with torch.inference_mode():
        dense = build_unet_plan(rc, rm, sp.capacities, tuple(sp.grid_extent), device=DEV)
        sort = build_unet_plan(rc, rm, sp.capacities, tuple(sp.grid_extent), device=DEV,
                               dense_lookup=False)
        room_ms = {"dense": _plan_device_ms(rc, rm, sp),
                   "sort": _plan_device_ms(rc, rm, sp, dense_lookup=False)}
    misses = {k: p["overflow"]["extent_misses"].tolist() for k, p in
              (("dense", dense), ("sort", sort))}
    dropped = {k: p["overflow"]["voxels_dropped"].tolist() for k, p in
               (("dense", dense), ("sort", sort))}
    if not (min(misses["dense"]) > 0 and max(misses["sort"]) == 0):
        fail(f"sortplan room: extent_misses {misses}: the room is not past the extent, "
             "or the sort plan missed voxels")
    extent_span = (rc.max(dim=1).values.max(dim=0).values + 1).tolist()
    del dense

    model = SIG3D(scfg, num_answers=cfg.data.num_answers, dtype=torch.bfloat16, device=DEV)
    init_random_weights(model, SEED)
    B = rc.shape[0]
    draws = make_sample_draws(B, sp.capacities[-1], cfg.model.num_scene_tokens,
                              torch.Generator().manual_seed(SEED + 51), DEV)
    with torch.inference_mode():
        model(room, sample_draws=draws)
        torch.cuda.synchronize()
        reset_counts()                       # just before the path ...
        out = model(room, sample_draws=draws)
        torch.cuda.synchronize()
        counts = read_counts()               # ... and just after
        scores = out["answer_scores"]
        if not bool(torch.isfinite(scores).all()):
            fail("sortplan room: answer_scores are not finite")
        expected = {name: 0 for name in KERNEL_COUNTERS}
        expected.update({"fused_sparse_conv": 1 + 4 + 2 * sum(sp.layers[:4]),
                         "gather_rows": 1, "scatter_add_rows": 2, "segment_plan": 1})
        if counts != expected:
            fail(f"sortplan room: kernel launches of one forward {counts} != {expected}")
        t0 = time.perf_counter()
        for _ in range(3):
            model(room, sample_draws=draws)
        torch.cuda.synchronize()
        fwd_s = (time.perf_counter() - t0) / 3
        kernel_conv = sparse_conv.fused_sparse_conv
        sparse_conv.fused_sparse_conv = fused_conv.fused_sparse_conv_plain
        try:
            plain = model(room, sample_draws=draws)["answer_scores"]
        finally:
            sparse_conv.fused_sparse_conv = kernel_conv
        # the encoder's output itself, kernel vs plain conv route: on the
        # rooms' sort plan, and on the in-extent batch's plan as the control
        feat_err, feat_scale = _bottleneck_kernel_vs_plain(model, room, sort)
        in_plan = build_unet_plan(coords, mask, sp.capacities, tuple(sp.grid_extent),
                                  device=DEV, dense_lookup=False)
        ctrl_err, ctrl_scale = _bottleneck_kernel_vs_plain(model, batch, in_plan)
    del sort, in_plan
    for what, e, sc in (("rooms", feat_err, feat_scale), ("in-extent control", ctrl_err,
                                                          ctrl_scale)):
        if not e <= FEAT_RTOL * max(sc, 1e-6):
            fail(f"sortplan {what}: feat_bottleneck kernel vs plain conv route max abs err "
                 f"{e} > {FEAT_RTOL} x {sc}")
    err = float((scores - plain).abs().max())
    scale = float(plain.abs().max())
    if not err <= SORT_RTOL * scale:
        fail(f"sortplan room: answers kernel vs plain conv route max abs err {err} > "
             f"{SORT_RTOL} x {scale}")
    emit("sortplan_room", batch_size=B, room_m=list(SCAN_ROOM), voxel_span=extent_span,
         extent=list(sp.grid_extent), extent_misses=misses, voxels_dropped=dropped,
         plan_device_ms={k: round(v, 4) for k, v in room_ms.items()},
         launches_per_forward=counts, seconds_per_forward=round(fwd_s, 5),
         feat_bottleneck_kernel_vs_plain_max_abs_err=feat_err,
         feat_bottleneck_max_abs=feat_scale, in_extent_feat_bottleneck_max_abs_err=ctrl_err,
         in_extent_feat_bottleneck_max_abs=ctrl_scale, feat_rtol=FEAT_RTOL,
         answers_kernel_vs_plain_max_abs_err=err, answers_max_abs=scale, rtol=SORT_RTOL,
         phase_seconds=round(time.perf_counter() - t_phase, 2))
    del model
    torch.cuda.empty_cache()
    return counts


def write_openscene_files(root: str) -> tuple:
    """``OS_SCENES`` ScanNet-style rooms of ``OS_POINTS`` points
    (``make_detection_arrays``; colours in [-1, 1], labels 0..19 with ~5%
    -100) as ``{root}/3d/{train,val}/{scene}_vh_clean_2.pth`` and their fused
    2D features ``{root}/feat/{scene}_{k}.pt`` (``feat`` float16 [n, 768]
    over the ``mask_full`` points; two occurrences for the first scene).
    The last scene is the val split. Returns (3d dir, feature dir)."""
    import os
    rng = np.random.RandomState(SEED + 70)
    rooms = make_detection_arrays(OS_SCENES, OS_POINTS, rng)["point_clouds"]
    for split in ("train", "val"):
        os.makedirs(os.path.join(root, "3d", split), exist_ok=True)
    os.makedirs(os.path.join(root, "feat"), exist_ok=True)
    for i in range(OS_SCENES):
        sid = f"scene{i:04d}_00"
        split = "val" if i == OS_SCENES - 1 else "train"
        labels = rng.randint(0, 20, OS_POINTS).astype(np.int64)
        labels[rng.rand(OS_POINTS) < 0.05] = -100
        torch.save((rooms[i] - rooms[i].mean(0), rng.uniform(-1, 1, (OS_POINTS, 3))
                    .astype(np.float32), labels),
                   os.path.join(root, "3d", split, f"{sid}_vh_clean_2.pth"))
        for k in range(2 if i == 0 else 1):
            seen = rng.rand(OS_POINTS) < 0.6
            torch.save({"feat": torch.from_numpy(rng.randn(int(seen.sum()), OS_FEAT_DIM)
                                                 .astype(np.float16)),
                        "mask_full": torch.from_numpy(seen)},
                       os.path.join(root, "feat", f"{sid}_{k}.pt"))
    return os.path.join(root, "3d"), os.path.join(root, "feat")


def _stack_items(items, keys) -> dict:
    return {k: torch.as_tensor(np.stack([it[k] for it in items]), device=DEV) for k in keys}


def _rel_max(got: dict, want: dict) -> tuple:
    """(worst max-abs error over the entries relative to each entry's
    largest value, its entry)."""
    worst, where = 0.0, None
    for k, w in want.items():
        e = float((got[k].float() - w.float()).abs().max()) / max(float(w.float().abs().max()),
                                                                  1e-30)
        if e >= worst:
            worst, where = e, k
    return worst, where


def phase_openscene(work: str) -> dict:
    """OpenScene files through ``FusedFeatureLoader`` (augmentation on, the
    default capacity), the full-width MinkUNet18A (``final_result``, 768-wide
    ``final``) loaded from a seeded reference-format state dict through
    ``ckpt_compat/minkunet.py:convert_minkunet``, one training-form forward
    at B=4 with the schedule's first momentum and the backward of
    ``sum(openscene_out * R)``, in float32 as the reference trains it, on
    the points' colours (``input_color``): kernel route against the plain
    route on the card (outputs and running statistics of a forward each;
    gradients of a backward each on the kernel route's forward). With
    all-ones input features the gradient of conv0, whose output is
    batch-normalized, is a sum that cancels exactly at the centre offset:
    its rounding, not the kernels, would decide the comparison. Then the val
    scene's ``eval_all`` item scored with ``eval/segmentation.py``."""
    t_phase = time.perf_counter()
    cfg = apply_overrides(full_width_cfg(), ["sparse.final_result=true"])
    sp = cfg.sparse
    d3, dfeat = write_openscene_files(f"{work}/openscene")
    t0 = time.perf_counter()
    loader = FusedFeatureLoader(d3, dfeat, voxel_size=cfg.data.voxel_size, split="train",
                                aug_enabled=True, input_color=True,
                                capacity=sp.capacities[0], seed=SEED)
    items = [loader[i] for i in range(OS_BATCH)]
    load_s = time.perf_counter() - t0
    if len(loader) != OS_SCENES - 1 or loader.list_occur[0] != 2:
        fail(f"openscene: the loader found {len(loader)} scenes, occurrences {loader.list_occur}")
    b = _stack_items(items, ("coords", "feats", "mask", "feat_3d", "feat_mask", "labels"))
    if tuple(b["feat_3d"].shape) != (OS_BATCH, sp.capacities[0], OS_FEAT_DIM) or \
            not bool(b["feat_mask"].any()) or int(b["labels"].max()) != 255:
        fail("openscene: the loader's items have the wrong shape, no visible voxel "
             "or no ignored label")

    sd = random_reference_state_dict(sp, np.random.RandomState(SEED + 71))
    params, stats = convert_minkunet(sd, sp.layers, final_result=True)
    net = MinkUNet(sp).to(DEV)
    unused = load_jax_variables(net, params, stats)
    if unused:
        fail(f"openscene: converted leaves the UNet did not use: {unused[:5]}")
    start = {k: v.clone() for k, v in net.state_dict().items()}
    momentum = bn_momentum_schedule(cfg.train, 0)
    x = SparseVoxels(b["coords"], b["feats"], b["mask"], 1)
    R = torch.randn(OS_BATCH, sp.capacities[0], sp.out_channels,
                    generator=torch.Generator(device=DEV).manual_seed(SEED + 72), device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                           # just before the path ...
    t0 = time.perf_counter()
    with torch.no_grad():
        plan = build_unet_plan(x.coords, x.mask, sp.capacities, tuple(sp.grid_extent),
                               device=DEV)
    net.zero_grad(set_to_none=True)
    out = net(x, plan, train=True, momentum=momentum)["openscene_out"].feats
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_counts = read_counts()
    t0 = time.perf_counter()
    loss = (out.float() * R).sum()
    loss.backward(retain_graph=True)
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0
    all_counts = read_counts()               # ... and just after
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bwd_counts = {k: all_counts[k] - fwd_counts[k] for k in all_counts}
    n_conv = 1 + 4 + 2 * sum(sp.layers[:4]) + 4 + 2 * sum(sp.layers[4:8])
    want_fwd = {name: 0 for name in KERNEL_COUNTERS}
    want_fwd.update({"fused_sparse_conv": n_conv, "k3_map_lookup": 3,
                     "k3_map_lookup_bits": 1, "k5_map_lookup": 1})
    if fwd_counts != want_fwd:
        fail(f"openscene: kernel launches of the plan and the training-form forward "
             f"{fwd_counts} != {want_fwd}")
    if bwd_counts["fused_sparse_conv"] != n_conv - 1 or bwd_counts["gather_rows"] < n_conv:
        fail(f"openscene: backward launches {bwd_counts}: expected {n_conv - 1} conv dx "
             f"launches (conv0's input takes none) and a dW gather a conv at least")
    stats_k = {n: v.detach().clone() for n, v in net.named_buffers()}
    grads_k = {n: p.grad.detach().clone() for n, p in net.named_parameters()
               if p.grad is not None}
    moved = [n for n, v in stats_k.items() if torch.equal(v, start[n])]
    if moved:
        fail(f"openscene: running statistics that did not move: {moved[:5]}")
    originals = (sparse_conv.fused_sparse_conv, sparse_conv.gather_rows)
    sparse_conv.fused_sparse_conv = fused_conv.fused_sparse_conv_plain
    sparse_conv.gather_rows = gather_rows.gather_rows_plain
    try:
        # the backward through the plain versions on the same forward: a
        # separate plain forward would round some pre-activations near 0 to
        # the other side of the ReLUs and move the gradients by whole terms
        net.zero_grad(set_to_none=True)
        loss.backward()
        grads_p = {n: p.grad.detach().clone() for n, p in net.named_parameters()
                   if p.grad is not None}
        # the forward through the plain versions, from the same start
        net.load_state_dict(start)
        with torch.no_grad():
            out_p = net(x, plan, train=True, momentum=momentum)["openscene_out"].feats
        stats_p = {n: v.detach().clone() for n, v in net.named_buffers()}
    finally:
        sparse_conv.fused_sparse_conv, sparse_conv.gather_rows = originals
    if set(grads_k) != set(grads_p):
        fail("openscene: the two routes gave gradients to different parameters")
    errs = {"openscene_out": _rel_max({"o": out.detach()}, {"o": out_p})[0],
            "running_stats": _rel_max(stats_k, stats_p),
            "grads": _rel_max(grads_k, grads_p),
            "grad_conv0p1s1": _rel_max(grads_k, {"conv0p1s1.kernel":
                                                 grads_p["conv0p1s1.kernel"]})[0],
            "grad_bn0": _rel_max(grads_k, {k: grads_p[k] for k in ("bn0.scale",
                                                                   "bn0.bias")})[0]}
    emit("openscene_kernel_vs_plain", rtol=OS_RTOL, grad_rtol=GRAD_RTOL, **errs)
    for k, tol in (("openscene_out", OS_RTOL), ("grad_conv0p1s1", GRAD_RTOL),
                   ("grad_bn0", GRAD_RTOL)):
        if not errs[k] <= tol:
            fail(f"openscene: {k} kernel vs plain route relative err {errs[k]} > {tol}")
    for k, tol in (("running_stats", OS_RTOL), ("grads", GRAD_RTOL)):
        if not errs[k][0] <= tol:
            fail(f"openscene: {k} kernel vs plain route relative err {errs[k]} > {tol}")
    del out, out_p, loss, R, grads_k, grads_p

    torch.cuda.empty_cache()

    # the val scene, every point scored through its voxel
    val = FusedFeatureLoader(d3, dfeat, voxel_size=cfg.data.voxel_size, split="val",
                             input_color=True, capacity=sp.capacities[0], eval_all=True,
                             seed=SEED)
    item = val[0]
    eb = _stack_items([item], ("coords", "feats", "mask"))
    net.load_state_dict(start)
    with torch.no_grad():
        xe = SparseVoxels(eb["coords"], eb["feats"], eb["mask"], 1)
        pe = build_unet_plan(xe.coords, xe.mask, sp.capacities, tuple(sp.grid_extent),
                             device=DEV)
        vox = net(xe, pe)["openscene_out"].feats[0].float().cpu().numpy()
    text = precompute_text_features(
        lambda prompts: np.stack([np.random.RandomState(sum(map(ord, p))).randn(OS_FEAT_DIM)
                                  for p in prompts]))
    inv, pm = item["inds_reconstruct"], item["point_mask"]
    scored = pm & (inv < sp.capacities[0])
    pred = segment_points(vox[inv[scored]], text)
    seg = seg_evaluate(pred, item["point_labels"][scored])
    if not (0.0 <= seg["mIoU"] <= 1.0 and np.isfinite(vox).all()):
        fail(f"openscene eval: mIoU {seg['mIoU']}, finite {np.isfinite(vox).all()}")
    emit("openscene", scenes=OS_SCENES, points=OS_POINTS, batch_size=OS_BATCH,
         capacity=sp.capacities[0], overflow=[int(it["overflow"]) for it in items],
         visible_voxels=int(b["feat_mask"].sum()), load_seconds=round(load_s, 3),
         momentum=momentum, dtype="float32",
         launches_forward=fwd_counts, launches_backward=bwd_counts,
         forward_seconds=round(fwd_s, 4), backward_seconds=round(bwd_s, 4),
         peak_memory_gb=round(peak, 2), kernel_vs_plain=errs, rtol=OS_RTOL,
         eval_points_scored=int(scored.sum()), eval_mIoU_random_weights=seg["mIoU"],
         phase_seconds=round(time.perf_counter() - t_phase, 2))
    return {"forward": fwd_counts, "backward": bwd_counts}


def phase_lstm(work: str) -> None:
    """``cli.train --task sqa3d`` with ``model.lang_model=lstm`` (GloVe width
    300, LSTM 768) for 3 steps at full width, B=8, bf16, on SQA3D-layout
    files, then ``cli.eval`` on its checkpoint."""
    import os
    t_phase = time.perf_counter()
    files = write_sqa3d_room_files(os.path.join(work, "data"))
    opts = [*FULL_WIDTH, *files, "model.lang_model=lstm", f"train.batch_size={BATCH}",
            f"eval.batch_size={BATCH}", "train.log_every_steps=1",
            "train.val_every_steps=1000", f"train.ckpt_dir={work}/ckpt",
            f"log.log_dir={work}/logs"]
    cfg = apply_overrides(Config(), opts)
    reset_counts()
    with ForwardLaunches() as fw:
        t0 = time.perf_counter()
        cli_train.main(["--task", "sqa3d", "--max-steps", str(LSTM_STEPS), "--device", DEV,
                        "--output", f"{work}/run", "--options", *opts])
        train_s = time.perf_counter() - t0
    counts = read_counts()
    with open(f"{work}/logs/metrics.jsonl") as fh:
        steps = [r for r in map(json.loads, fh) if "loss" in r]
    if [r["step"] for r in steps] != list(range(1, LSTM_STEPS + 1)) or \
            not all(np.isfinite(r["loss"]) for r in steps):
        fail(f"lstm: training losses {[(r['step'], r.get('loss')) for r in steps]}")
    _check_forward_launches(fw.calls, "lstm train", counts,
                            0 if "scene_encoder" in cfg.train.frozen_prefixes else 20)
    with ForwardLaunches() as fw:
        res = cli_eval.main(["--task", "sqa3d", "--checkpoint", "latest", "--device", DEV,
                             "--output", f"{work}/eval", "--options", *opts])
    metrics = _read_json(f"{work}/eval/metrics.json")
    if res["step"] != LSTM_STEPS or not 0.0 <= metrics["answer_acc_at1"] <= 1.0:
        fail(f"lstm eval: step {res['step']}, metrics {metrics}")
    _check_forward_launches(fw.calls, "lstm eval")
    emit("lstm", steps=LSTM_STEPS, batch_size=BATCH, hidden=cfg.lang.hidden_size,
         glove_dim=cfg.lang.glove_dim, losses=[r["loss"] for r in steps],
         fetch_s=_per_step([r["time/fetch"] for r in steps]),
         step_s=_per_step([r["time/step"] for r in steps]), train_seconds=round(train_s, 3),
         launches=counts, eval_answer_acc_at1=metrics["answer_acc_at1"],
         eval_questions=res["num_questions"], eval_seconds=round(res["eval_seconds"], 4),
         phase_seconds=round(time.perf_counter() - t_phase, 2))
    _release()


def multiview_cameras(points: torch.Tensor, hw, n_views: int):
    """``n_views`` cameras at the room's centre, 1.5 m up, turned by equal
    yaw steps (x right, y down, z forward), intrinsics for an ``hw`` feature
    map with a 90-degree horizontal field of view, and each view's depth map
    rendered from the points (the nearest point a pixel; 0 where none)."""
    H, W = hw
    intr = CameraIntrinsics(fx=W / 2.0, fy=W / 2.0, cx=(W - 1) / 2.0, cy=(H - 1) / 2.0)
    centre = points.mean(0).double().cpu().numpy()
    centre[2] = 1.5
    w2c, depths = [], []
    for i in range(n_views):
        yaw = 2 * np.pi * i / n_views
        f = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        r = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        R = np.stack([r, np.array([0.0, 0.0, -1.0]), f])
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = R, -R @ centre
        m = torch.as_tensor(m, dtype=torch.float32, device=points.device)
        pix, valid = project_points(points, m, intr, hw)
        z = (torch.cat([points, torch.ones_like(points[:, :1])], -1) @ m.T)[:, 2]
        flat = (pix[:, 0] * W + pix[:, 1]).long()
        depth = torch.full((H * W,), float("inf"), device=points.device)
        depth.scatter_reduce_(0, flat[valid], z[valid], "amin")
        depths.append(torch.where(torch.isinf(depth), 0.0, depth).view(H, W))
        w2c.append(m)
    return intr, torch.stack(w2c), torch.stack(depths)


def phase_multiview() -> dict:
    """``ENetForMultiview`` in evaluation form on 5 views of 256 x 328
    (ScanRefer's frames), features 32 x 41 x 128; ``multiview_backproject``
    (depth test, ``mean``) of them onto a 40,000-point room and its backward,
    the gather on ``gather_rows`` and the backward on ``scatter_add_rows``:
    against the plain versions on the card, and two backward passes
    bit-equal."""
    t_phase = time.perf_counter()
    torch.manual_seed(SEED + 80)
    enet = ENetForMultiview(device=DEV, seed=SEED)
    g = torch.Generator(device=DEV).manual_seed(SEED + 81)
    images = torch.rand(MV_VIEWS, *MV_IMAGE, 3, generator=g, device=DEV)
    with torch.no_grad():
        feats, logits = enet(images)
        enet_ms = time_cuda(lambda: enet(images), 5, 2)
    want = (MV_VIEWS, MV_IMAGE[0] // 8, MV_IMAGE[1] // 8, 128)
    if tuple(feats.shape) != want or tuple(logits.shape) != want[:3] + (41,) or \
            not bool(torch.isfinite(feats).all()):
        fail(f"multiview: ENet features {tuple(feats.shape)} (want {want}) or not finite")
    room = make_detection_arrays(1, MV_POINTS, np.random.RandomState(SEED + 82))
    points = torch.as_tensor(room["point_clouds"][0], device=DEV)
    intr, w2c, depths = multiview_cameras(points, want[1:3], MV_VIEWS)
    R = torch.randn(MV_POINTS, 128, generator=g, device=DEV)

    def run():
        f2d = feats.detach().clone().requires_grad_(True)
        out = multiview_backproject(points, f2d, w2c, intr, depths, "mean")
        (out * R).sum().backward()
        return out.detach(), f2d.grad

    run()
    torch.cuda.synchronize()
    reset_counts()                           # just before the path ...
    out, grad = run()
    torch.cuda.synchronize()
    counts = read_counts()                   # ... and just after
    _, grad2 = run()
    want_counts = {name: 0 for name in KERNEL_COUNTERS}
    want_counts.update({"gather_rows": 1, "scatter_add_rows": 1, "segment_plan": 1})
    if counts != want_counts:
        fail(f"multiview: kernel launches {counts} != {want_counts}")
    if not torch.equal(grad, grad2):
        fail("multiview: the gradients of two backward passes differ (not deterministic)")
    seen = int((out.abs().sum(1) > 0).sum())
    if seen == 0:
        fail("multiview: no point is seen by any view")
    originals = (gather_rows.gather_rows, gather_rows.scatter_add_rows)
    gather_rows.gather_rows = gather_rows.gather_rows_plain
    gather_rows.scatter_add_rows = gather_rows.scatter_add_rows_plain
    try:
        p_out, p_grad = run()
    finally:
        gather_rows.gather_rows, gather_rows.scatter_add_rows = originals
    f_err = float((out - p_out).abs().max())
    g_err = float((grad - p_grad).abs().max())
    if not (f_err <= MV_ATOL and g_err <= SUM_ATOL * max(float(p_grad.abs().max()), 1.0)):
        fail(f"multiview: kernel vs plain features {f_err} (<= {MV_ATOL}), gradients {g_err}")
    t_proj = time_cuda(lambda: multiview_backproject(points, feats, w2c, intr, depths, "mean"),
                       5, 2)
    t_step = time_cuda(run, 3, 1)
    emit("multiview", views=MV_VIEWS, image=list(MV_IMAGE), features=list(want),
         points=MV_POINTS, points_seen=seen, enet_eval_ms=round(enet_ms, 4),
         backproject_ms=round(t_proj, 4), backproject_and_backward_ms=round(t_step, 4),
         launches=counts, features_kernel_vs_plain_max_abs_err=f_err,
         grad_kernel_vs_plain_max_abs_err=g_err, grads_bit_equal=True,
         phase_seconds=round(time.perf_counter() - t_phase, 2))
    return counts


# ---------------------------------------------------------------------------
# The 3D-LLM (BLIP-2 Q-Former + FlanT5-XL) at full width
# ---------------------------------------------------------------------------

B2_DECODE_BATCH = 8    # bench.py blip2_decode: B=8, 5,120 scene tokens, prompt 64, 10 tokens
B2_TRAIN_BATCH = 4     # bench.py blip2_train: B=4, prompt 64, answers 8
B2_PROMPT, B2_ANSWER, B2_GEN, B2_BEAMS = 64, 8, 10, 5
B2_STEPS = 3
B2_CELL_PROMPT, B2_CHECK_BATCHES = 400, 4   # the blip2_flant5xl.answer cell's prompt positions
B2_POINTS = 6000       # points a scene in the files: above the 5,120 capacity
B2_WIDTH: list = []    # default widths (flan-t5-xl, 12-layer Q-Former); a rehearsal shrinks them
B2_SMALL = ["blip2.t5.vocab_size=128", "blip2.t5.d_model=64", "blip2.t5.d_kv=16",
            "blip2.t5.d_ff=128", "blip2.t5.num_layers=2", "blip2.t5.num_decoder_layers=2",
            "blip2.t5.num_heads=4", "blip2.t5.max_answer_len=8",
            "blip2.qformer.num_query_tokens=4", "blip2.qformer.hidden_size=64",
            "blip2.qformer.num_layers=2", "blip2.qformer.num_heads=4",
            "blip2.qformer.intermediate_size=128", "blip2.qformer.encoder_width=48",
            "blip2.qformer.scene_token_capacity=64", "blip2.pc_feat_dim=48",
            "blip2.max_txt_len=16"]


def _steps_run(tokens: torch.Tensor, eos: int, max_len: int) -> int:
    """Decode steps the greedy loop ran: until every row had emitted EOS."""
    t = tokens.cpu().numpy()
    first = [int(np.argmax(r == eos)) + 1 if (r == eos).any() else max_len for r in t]
    return max(first)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _per_step_projection(t5, enc, emask, tok, cache):
    """A decode step as the port ran it before the cross-attention's keys and
    values were kept: each layer projects them from ``enc`` at every step."""
    x = t5.shared(tok).to(t5.dtype)
    bias = None
    for i in range(t5.cfg.num_decoder_layers):
        blk = getattr(t5.decoder, f"block{i}")
        a, bias = blk.self_attn(blk.self_attn_norm(x), position_bias=bias,
                                cache=cache.layers[i], cache_index=cache.index)
        x = x + a
        c, _ = blk.cross_attn(blk.cross_attn_norm(x), kv=enc, mask=emask)
        x = blk.ff(x + c)
    cache.index += x.shape[1]
    return t5._logits(t5.decoder.final_norm(x))


def _eager_decode(t5, enc, emask, start, eos, pad):
    """The greedy steps run eagerly on fresh buffers: (buffers, each step's
    float32 logits), stopping as the loop does."""
    b = t5_mod.GreedyBuffers(t5, enc, emask, B2_GEN)
    b.load(enc, emask, start, pad)
    logits = []
    for i in range(B2_GEN):
        logits.append(t5_mod.greedy_step(t5, b, i, eos, pad, i + 1 < B2_GEN).float())
        if i + 1 < B2_GEN and bool(b.finished):
            break
    return b, logits


def blip2_captured_decode(model, bcfg) -> dict:
    """The captured greedy decode against the eager steps on fresh buffers,
    at the ``blip2_flant5xl.answer`` cell's size (B=8, 32 + 400 encoder
    positions, 10 tokens) over ``B2_CHECK_BATCHES`` batches: the tokens
    equal, the widest logit gap of the steps run, ``GEN`` captures at the
    first batch and one replay a step run; a decode's ``weight_copies``
    (none once made) and ``cross_kv_projections`` (one a batch, two at the
    capture); each step's logits against the step that projects the
    encoder's keys and values anew (:func:`_per_step_projection`), and every
    weight copy against the per-call cast, bit for bit. Then one decoder
    weight updated in place: the replayed decode follows it without a
    capture. One eager and one replayed step timed with CUDA events."""
    t5, t5c = model.t5, bcfg.t5
    start, eos, pad = t5c.decoder_start_token_id, t5c.eos_token_id, t5c.pad_token_id
    rows, gap, scale, parent_gap, parent_eager_gap = [], 0.0, 0.0, 0.0, 0.0
    with torch.no_grad():
        for k in range(B2_CHECK_BATCHES):
            batch = tree_to_device(blip2_bench_batch(
                bcfg, B2_DECODE_BATCH, np.random.RandomState(SEED + 80 + k), B2_CELL_PROMPT,
                labels=False), DEV)
            emb, emask = model.prepare(batch)
            c0, r0 = t5_mod.decode_graph_captures, t5_mod.decode_graph_replays
            w0, x0 = layers_mod.weight_copies, t5_mod.cross_kv_projections
            tokens = t5_mod.greedy_decode(t5, emb, emask, B2_GEN, start, eos, pad)
            captures = t5_mod.decode_graph_captures - c0
            replays = t5_mod.decode_graph_replays - r0
            copies = layers_mod.weight_copies - w0
            projections = t5_mod.cross_kv_projections - x0
            enc = t5.encode(emb, emask)
            cap = t5.decode_graphs.get(t5, enc, emask, B2_GEN, start, eos, pad)
            b, eager = _eager_decode(t5, enc, emask, start, eos, pad)
            steps = len(eager)
            cache = t5.init_cache(B2_DECODE_BATCH)
            for i in range(steps):
                tok = b.out[:, i - 1:i] if i else torch.full_like(b.tok, start)
                parent = _per_step_projection(t5, enc, emask, tok, cache).float()
                gap = max(gap, float((cap.logits[i].float() - eager[i]).abs().max()))
                parent_gap = max(parent_gap, float((cap.logits[i].float() - parent).abs().max()))
                parent_eager_gap = max(parent_eager_gap, float((eager[i] - parent).abs().max()))
                scale = max(scale, float(eager[i].abs().max()))
            same = torch.equal(tokens, b.out)
            rows.append({"captures": captures, "replays": replays, "steps": steps,
                         "tokens_equal": same, "weight_copies": copies,
                         "cross_kv_projections": projections})
            # the first batch captures: the capture's own load projects once more,
            # and the weights trained above get their copies
            if (not same or replays != steps or captures != (B2_GEN if k == 0 else 0)
                    or projections != (2 if k == 0 else 1) or (k > 0 and copies != 0)):
                fail(f"blip2 captured decode, batch {k}: {rows[-1]}; captured "
                     f"{tokens.tolist()}, eager {b.out.tolist()}")
        if parent_gap or parent_eager_gap:
            fail(f"blip2 decode: logits {parent_gap} (replayed) and {parent_eager_gap} (eager) "
                 "from those of the step projecting the keys and values anew")
        copied = [d for d in t5.modules() if isinstance(d, layers_mod.Dense)
                  and d.compute_copy.weight is not None]
        unequal = [d for d in copied if not torch.equal(d.compute_copy.weight,
                                                        d.weight.to(d.dtype))]
        if not copied or unequal:
            fail(f"blip2 weight copies: {len(copied)} made, {len(unequal)} unequal to the cast")
        # one decoder weight updated in place between two decodes: the
        # replayed steps read its refreshed copy, with no capture
        before = cap.logits[0].float().clone()
        w = getattr(t5.decoder, f"block{t5c.num_decoder_layers - 1}").ff.wo.weight
        w.mul_(4.0)
        c0, w0 = t5_mod.decode_graph_captures, layers_mod.weight_copies
        tokens = t5_mod.greedy_decode(t5, emb, emask, B2_GEN, start, eos, pad)
        after_captures = t5_mod.decode_graph_captures - c0
        after_copies = layers_mod.weight_copies - w0
        b, eager = _eager_decode(t5, enc, emask, start, eos, pad)
        update_gap = float((cap.logits[0].float() - eager[0]).abs().max())
        moved = float((cap.logits[0].float() - before).abs().max())
        update = {"tokens_equal": torch.equal(tokens, b.out), "captures": after_captures,
                  "weight_copies": after_copies, "logit_gap": update_gap,
                  "logits_moved": moved}
        if not update["tokens_equal"] or after_captures or after_copies != 1 or moved == 0:
            fail(f"blip2 decode after an in-place weight update: {update}")
        w.div_(4.0)
        # one step each way, the buffers of the last batch
        eager_ms = time_cuda(lambda: t5_mod.greedy_step(t5, b, 0, eos, pad, True), iters=10)
        replay_ms = time_cuda(lambda: cap.graphs[0].replay(), iters=10)
    rec = {"batch_size": B2_DECODE_BATCH, "encoder_positions": int(emask.shape[1]),
           "max_len": B2_GEN, "batches": rows, "widest_logit_gap": gap,
           "per_step_projection_logit_gap": {"replayed": parent_gap,
                                             "eager": parent_eager_gap},
           "weight_copies_checked": len(copied), "after_in_place_update": update,
           "largest_logit": round(scale, 3), "eager_step_ms": round(eager_ms, 3),
           "replayed_step_ms": round(replay_ms, 3)}
    emit("blip2_captured_decode", **rec)
    del cap, b, eager, enc, emb, cache
    t5.decode_graphs.keys.clear()
    return rec


def blip2_train_and_decode(cfg) -> dict:
    """Three frozen-T5 training steps at B=4 and greedy decoding of 10
    tokens at B=8 (beam search with 5 beams beside it) on the full-width
    Blip2T5, bf16 compute, float32 parameters."""
    import gc
    bcfg, t5c = cfg.blip2, cfg.blip2.t5
    torch.cuda.reset_peak_memory_stats()
    model, build_s = _timed(lambda: Blip2T5(bcfg, dtype=torch.bfloat16, device=DEV, seed=SEED))
    n_params = sum(p.numel() for p in model.parameters())
    opt, _ = make_blip2_optimizer(cfg, model, steps_per_epoch=100)
    state = Blip2TrainState(model, opt, 0)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    n_train = sum(p.numel() for n, p in model.named_parameters() if n in trainable)
    n_frozen = sum(1 for n, _ in model.named_parameters() if n not in trainable)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = tree_to_device(blip2_bench_batch(bcfg, B2_TRAIN_BATCH,
                                             np.random.RandomState(SEED + 70), B2_PROMPT,
                                             B2_ANSWER), DEV)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(B2_STEPS):
        m, s = _timed(lambda: blip2_train_step(cfg, state, batch))
        losses.append(float(m["loss"]))
        step_s.append(s)
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(losses)):
        fail(f"blip2 train: losses {losses}")
    still, frozen_bad = [], []
    for n, p in model.named_parameters():
        if n in trainable:
            if torch.equal(p, before[n]):
                still.append(n)
        elif p.grad is not None or not torch.equal(p, before[n]):
            frozen_bad.append(n)
    if still or frozen_bad:
        fail(f"blip2 train: trainable tensors that did not move {still}; frozen tensors "
             f"with a .grad or changed {frozen_bad}")
    del before, opt, state
    gc.collect()
    torch.cuda.empty_cache()
    emit("blip2_train", batch_size=B2_TRAIN_BATCH, prompt=B2_PROMPT, answer=B2_ANSWER,
         params=n_params, trainable_params=n_train, trainable_tensors=len(trainable),
         frozen_tensors_checked=n_frozen,
         build_s=round(build_s, 3), losses=losses, step_s=[round(s, 4) for s in step_s],
         samples_per_s=round(B2_TRAIN_BATCH * (B2_STEPS - 1) / sum(step_s[1:]), 3),
         peak_memory_gb=round(train_peak, 2))

    model.eval()
    blip2_captured_decode(model, bcfg)
    dbatch = tree_to_device(blip2_bench_batch(bcfg, B2_DECODE_BATCH,
                                              np.random.RandomState(SEED + 71), B2_PROMPT,
                                              labels=False), DEV)
    with torch.inference_mode():
        # layers: the scene encoder, the T5 encoder, one decode step (CUDA events)
        b = model._to_device(dbatch)
        scene_ms = time_cuda(lambda: model.encode_scene(b["pc_feat"], b["pc"], b["pc_mask"]))
        emb, emask = model.prepare(dbatch)
        enc_ms = time_cuda(lambda: model.t5.encode(emb, emask))
        enc = model.t5.encode(emb, emask)
        tok = torch.zeros(B2_DECODE_BATCH, 1, dtype=torch.long, device=DEV)
        cache = model.t5.init_cache(B2_DECODE_BATCH)

        def one_step():
            cache.index = 0
            return model.t5.decode_step(enc, emask, tok, cache)
        step_ms = time_cuda(one_step)
        torch.cuda.reset_peak_memory_stats()
        predict_answers(model, dbatch, B2_GEN)                          # warm-up
        tokens, greedy_s = _timed(lambda: predict_answers(model, dbatch, B2_GEN))
        steps = _steps_run(tokens, t5c.eos_token_id, B2_GEN)
        beams, beam_s = _timed(lambda: generate(model, dbatch, num_beams=B2_BEAMS,
                                                max_length=B2_GEN))
        decode_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rec = {"batch_size": B2_DECODE_BATCH, "scene_tokens": bcfg.qformer.scene_token_capacity,
               "prompt": B2_PROMPT, "max_len": B2_GEN, "greedy_steps_run": steps,
               "greedy_s": round(greedy_s, 4),
               "tokens_per_s": round(B2_DECODE_BATCH * steps / greedy_s, 2),
               "answers_per_s": round(B2_DECODE_BATCH / greedy_s, 3),
               "beam_search_s": round(beam_s, 4), "beams": B2_BEAMS,
               "scene_encoder_ms": round(scene_ms, 3), "t5_encoder_ms": round(enc_ms, 3),
               "decode_step_ms": round(step_ms, 3), "peak_memory_gb": round(decode_peak, 2)}
        if tokens.shape != (B2_DECODE_BATCH, B2_GEN) or beams.shape != (B2_DECODE_BATCH, B2_GEN):
            fail(f"blip2 decode: shapes {tuple(tokens.shape)}, {tuple(beams.shape)}")
        if steps < B2_GEN:
            # all-zero weights never emit EOS (every logit 0, argmax the pad
            # token): the full 10 steps, as bench.py times them
            for p in model.t5.parameters():
                p.zero_()
            predict_answers(model, dbatch, B2_GEN)
            tokens, full_s = _timed(lambda: predict_answers(model, dbatch, B2_GEN))
            rec.update(full_steps=_steps_run(tokens, t5c.eos_token_id, B2_GEN),
                       full_greedy_s=round(full_s, 4),
                       full_tokens_per_s=round(B2_DECODE_BATCH * B2_GEN / full_s, 2),
                       full_answers_per_s=round(B2_DECODE_BATCH / full_s, 3))
    emit("blip2_decode", **rec)
    del model, enc, emb, cache
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def write_3dvqa_files(root: str, feat_dim: int) -> tuple:
    """3 scenes of ``B2_POINTS`` points (``feat_dim`` float32 ``.pt`` features,
    int32 ``.npy`` voxel coords), 4 questions a scene with 1-2 answers, and
    the dataset config naming them (JSON, which YAML reads too). Returns
    (dataset config path, records path, scene 0's files)."""
    import os
    rng = np.random.RandomState(SEED + 72)
    feats = os.path.join(root, "features")
    os.makedirs(feats, exist_ok=True)
    records = []
    for s in range(3):
        sid = f"scene{s:04d}_00"
        torch.save(torch.from_numpy(rng.randn(B2_POINTS, feat_dim).astype(np.float32)),
                   os.path.join(feats, f"{sid}.pt"))
        np.save(os.path.join(feats, f"{sid}.npy"),
                rng.randint(0, 256, (B2_POINTS, 3)).astype(np.int32))
        for k in range(4):
            records.append({"scene_id": sid, "question_id": f"{sid}-q{k}",
                            "question": _QUESTIONS[(s + k) % len(_QUESTIONS)],
                            "answers": ["chair", "the chair", "table"][: 1 + (s + k) % 2]})
    rec_path = os.path.join(root, "records.json")
    with open(rec_path, "w") as fh:
        json.dump(records, fh)
    ds_cfg = os.path.join(root, "3dvqa.yaml")
    with open(ds_cfg, "w") as fh:
        json.dump({"datasets": {"3d_vqa": {"data_type": "features", "build_info": {
            "annotations": {"train": {"storage": [rec_path]}, "val": {"storage": [rec_path]}},
            "features": {"storage": feats}}}}}, fh, indent=2)
    return ds_cfg, rec_path, (os.path.join(feats, "scene0000_00.pt"),
                              os.path.join(feats, "scene0000_00.npy"))


def blip2_entry_points(work: str) -> dict:
    """``cli.train --task 3d_vqa`` (3 steps), ``cli.eval`` from its
    checkpoint, ``cli.infer --task 3d_vqa`` on one scene and ``cli.score``
    on the eval's answers, from files, at full width."""
    import gc
    import importlib.util
    import os
    ds_cfg, rec_path, (pt, npy) = write_3dvqa_files(
        os.path.join(work, "data"), apply_overrides(Config(), B2_WIDTH).blip2.pc_feat_dim)
    reader = "yaml" if importlib.util.find_spec("yaml") else "json (no yaml installed)"
    opts = [*B2_WIDTH, f"train.batch_size={B2_TRAIN_BATCH}", "eval.batch_size=8",
            "train.log_every_steps=1", f"train.ckpt_dir={work}/ckpt",
            f"log.log_dir={work}/logs"]
    out = {"dataset_config_reader": reader}
    torch.cuda.reset_peak_memory_stats()
    res, train_s = _timed(lambda: cli_train.main(
        ["--task", "3d_vqa", "--dataset-config", ds_cfg, "--max-steps", str(B2_STEPS),
         "--device", DEV, "--output", f"{work}/run", "--options", *opts]))
    with open(f"{work}/logs/metrics.jsonl") as fh:
        rows = [json.loads(x) for x in fh]
    steps = [r for r in rows if "loss" in r]
    if res["step"] != B2_STEPS or res["num_val"] != 12 or \
            [r["step"] for r in steps] != list(range(1, B2_STEPS + 1)) or \
            not all(np.isfinite(r["loss"]) for r in steps):
        fail(f"blip2 cli.train: {res}, losses {[(r['step'], r.get('loss')) for r in steps]}")
    if not os.path.exists(f"{work}/ckpt/step_{B2_STEPS}.pt") or \
            len(_read_json(f"{work}/run/results/vqa_result.json")) != 12:
        fail("blip2 cli.train: no checkpoint or no results")
    out["train"] = {"steps": B2_STEPS, "train_pairs": res["num_train_pairs"],
                    "losses": [r["loss"] for r in steps],
                    "fetch_s": [round(r["time/fetch"], 4) for r in steps],
                    "step_s": [round(r["time/step"], 4) for r in steps],
                    "final": res["final"], "seconds": round(train_s, 2),
                    "peak_memory_gb": round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)}
    gc.collect()
    torch.cuda.empty_cache()

    ev, eval_s = _timed(lambda: cli_eval.main(
        ["--task", "3d_vqa", "--checkpoint", f"{work}/ckpt", "--dataset-config", ds_cfg,
         "--device", DEV, "--output", f"{work}/eval", "--options", *opts]))
    scores = _read_json(f"{work}/eval/scores.json")
    if ev["step"] != B2_STEPS or scores["All"]["count"] != 12 or scores != ev["scores"]:
        fail(f"blip2 cli.eval: step {ev['step']}, scores {scores}")
    out["eval"] = {"step": ev["step"], "questions": ev["num_questions"],
                   "EM": scores["All"]["EM"], "eval_seconds": round(ev["eval_seconds"], 3),
                   "questions_per_s": round(ev["num_questions"] / ev["eval_seconds"], 3),
                   "seconds": round(eval_s, 2)}
    gc.collect()
    torch.cuda.empty_cache()

    answer, infer_s = _timed(lambda: cli_infer.main(
        ["--task", "3d_vqa", "--pc-feat", pt, "--pc", npy, "--question",
         "What is on the table?", "--checkpoint", f"{work}/ckpt", "--device", DEV,
         "--options", *opts]))
    if not isinstance(answer, str):
        fail(f"blip2 cli.infer: answer {answer!r}")
    out["infer"] = {"answer_words": len(answer.split()), "seconds": round(infer_s, 2)}
    gc.collect()
    torch.cuda.empty_cache()

    records = _read_json(rec_path)
    ann = [{"question_id": question_id_int(r, i), "question": r["question"],
            "answers": r["answers"]} for i, r in enumerate(records)]
    with open(f"{work}/golds.json", "w") as fh:
        json.dump(ann, fh)
    scored = cli_score.main(["--variant", "sqa3d", "--results", f"{work}/eval/vqa_result.json",
                             "--golds", f"{work}/golds.json"])
    if scored != scores:
        fail("blip2 cli.score: scores differ from cli.eval's scores.json")
    out["score"] = {"All": scored["All"]}
    emit("blip2_entry_points", **out)
    return out


def blip2_reference() -> None:
    """A small float32 Blip2T5: the card against the CPU, same weights and
    inputs; logits within SMALL_ATOL, greedy tokens equal."""
    cfg = apply_overrides(Config(), [*B2_SMALL, "train.bf16=false"])
    rng = np.random.RandomState(SEED + 73)
    bc = cfg.blip2
    N, L, La = bc.qformer.scene_token_capacity, bc.max_txt_len, bc.t5.max_answer_len
    batch = {"pc_feat": rng.randn(3, N, bc.pc_feat_dim).astype(np.float32),
             "pc": rng.randint(0, 256, (3, N, 3)).astype(np.int32),
             "pc_mask": (np.arange(N)[None] < [[64], [40], [9]]).astype(np.int32),
             "input_ids": rng.randint(2, 128, (3, L)).astype(np.int32),
             "input_mask": (np.arange(L)[None] < [[16], [7], [3]]).astype(np.int32),
             "labels": rng.randint(2, 128, (3, La)).astype(np.int32),
             "label_mask": (np.arange(La)[None] < [[8], [4], [1]]).astype(np.int32)}
    cpu = Blip2T5(bc, device="cpu", seed=SEED + 74)
    init_random_weights(cpu, SEED + 75, std=None)     # N(0, 1 / fan_in): O(1) logits
    gpu = Blip2T5(bc, device=DEV)
    gpu.load_state_dict(cpu.state_dict())
    with torch.inference_mode():
        want, got = cpu(batch)["logits"], gpu(batch)["logits"].cpu()
        t_want = predict_answers(cpu, batch, La)
        t_got = predict_answers(gpu, batch, La).cpu()
    err = float((got - want).abs().max())
    if not err <= SMALL_ATOL or not torch.equal(t_got, t_want):
        fail(f"small Blip2T5: card vs CPU logits max abs err {err} (tolerance {SMALL_ATOL}), "
             f"greedy tokens equal: {torch.equal(t_got, t_want)}")
    emit("blip2_reference", what="small f32 Blip2T5, card vs CPU", atol=SMALL_ATOL,
         logits_max_abs_err=err, logits_max_abs=float(want.abs().max()),
         greedy_tokens_equal=True, tokens=t_want.tolist())


def phase_blip2(work: str) -> None:
    t0 = time.perf_counter()
    cfg = apply_overrides(Config(), [*B2_WIDTH, "train.bf16=true"])
    blip2_train_and_decode(cfg)
    blip2_entry_points(work)
    blip2_reference()
    emit("blip2", seconds=round(time.perf_counter() - t0, 2))


# ---------------------------------------------------------------------------
# BLIP-2 stage 1 (the text-capable Q-Former), scene-text retrieval and the
# model zoo (OPT-2.7B Blip2OPT, MED, EVA-CLIP-g, CLIP-L) at full width
# ---------------------------------------------------------------------------

S1_BATCH, S1_TEXT, S1_STEPS = 8, 32, 3   # 8 pairs a step (24 ITM rows), captions of 32
S1_WIDTH: list = []    # the default QFormerConfig; a rehearsal shrinks it
RET_N, RET_K = 32, 16  # retrieval: 32 scenes x 32 captions, k_test 16
OPT_DECODE_BATCH, OPT_PROMPT, OPT_GEN, OPT_TRAIN_BATCH = 8, 32, 10, 4
OPT_NEWLINE = 50118    # "\n" in OPT's GPT-2 BPE: where the reference ends an answer
OPT_CFG = OPTConfig()  # opt-2.7b; a rehearsal shrinks it
MED_CFG = MedConfig()  # bert-base, cross-attention into a 768-d ViT-B
ZOO_BATCH, VIT_IMG = 8, 224
S1_SMALL = ["blip2.qformer.num_query_tokens=4", "blip2.qformer.hidden_size=64",
            "blip2.qformer.num_layers=2", "blip2.qformer.num_heads=4",
            "blip2.qformer.intermediate_size=128", "blip2.qformer.encoder_width=48",
            "blip2.qformer.vocab_size=96", "blip2.qformer.max_position=40",
            "blip2.qformer.scene_token_capacity=64", "train.bf16=false"]


def build_vit(name: str):
    """A vision encoder and its ``ln_vision`` at the reference's width, bf16
    compute, on the card."""
    return init_vision_encoder(name, img_size=VIT_IMG, dtype=torch.bfloat16, device=DEV,
                               seed=SEED)


def _release() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _peak_gb() -> float:
    return round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)


def _stage1_batch(qcfg, B: int, rng) -> dict:
    """Every scene token valid; captions of ragged lengths (pad 0), ids
    below the two reserved top ids."""
    N, L = qcfg.scene_token_capacity, S1_TEXT
    tm = (np.arange(L)[None] < rng.randint(4, L + 1, (B, 1))).astype(np.int32)
    return {"image_embeds": torch.from_numpy(
                rng.randn(B, N, qcfg.encoder_width).astype(np.float32)).to(DEV),
            "image_mask": torch.ones(B, N, dtype=torch.int32, device=DEV),
            "text_ids": torch.from_numpy((rng.randint(4, qcfg.vocab_size - 2, (B, L)) * tm
                                          ).astype(np.int32)).to(DEV),
            "text_mask": torch.from_numpy(tm).to(DEV)}


def stage1_train(cfg) -> dict:
    """``S1_STEPS`` optimizer steps of the full-width ``Blip2Qformer`` at
    B=``S1_BATCH`` (ITC over 8 pairs, ITM over 24 rows, LM), bf16 compute,
    float32 parameters, one fresh negative draw a step: losses finite and
    every parameter moved."""
    qcfg = cfg.blip2.qformer
    torch.cuda.reset_peak_memory_stats()
    model, build_s = _timed(lambda: Blip2Qformer(qcfg, dtype=torch.bfloat16, device=DEV,
                                                 seed=SEED))
    opt, _ = make_optimizer(cfg.train, model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = _stage1_batch(qcfg, S1_BATCH, np.random.RandomState(SEED + 80))
    negatives = torch.Generator(device=DEV).manual_seed(SEED + 81)
    model.train()

    def step():
        out = model(batch, generator=negatives)
        opt.discard()
        out["loss"].backward()
        opt.step()
        return {k: float(v.detach()) for k, v in out.items()}

    losses, step_s = [], []
    for _ in range(S1_STEPS):
        m, s = _timed(step)
        losses.append(m)
        step_s.append(s)
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        fail(f"blip2_stage1 train: losses {losses}")
    still = [n for n, p in model.named_parameters() if torch.equal(p, before[n])]
    if still:
        fail(f"blip2_stage1 train: parameters that did not move {still}")
    rec = {"batch_size": S1_BATCH, "itm_rows": 3 * S1_BATCH, "text_len": S1_TEXT,
           "scene_tokens": qcfg.scene_token_capacity,
           "params": sum(p.numel() for p in model.parameters()),
           "tensors_moved": len(before), "build_s": round(build_s, 3), "losses": losses,
           "step_s": [round(s, 4) for s in step_s],
           "samples_per_s": round(S1_BATCH * (S1_STEPS - 1) / sum(step_s[1:]), 3),
           "peak_memory_gb": _peak_gb()}
    emit("blip2_stage1_train", **rec)
    del model, opt, before, batch
    _release()
    return rec


def stage1_entry_point(work: str, cfg) -> dict:
    """``cli.train --task stage1 --max-steps 3`` on 3D-VQA files (3 scenes
    of ``B2_POINTS`` points, 12 questions; B=8, so an epoch is one step):
    the losses logged finite, and the ``.npz`` read back over a fresh model
    through the reference's tree paths, every leaf used and trained."""
    import os
    ds_cfg, _, _ = write_3dvqa_files(os.path.join(work, "data"),
                                     cfg.blip2.qformer.encoder_width)
    opts = [*S1_WIDTH, f"train.batch_size={S1_BATCH}", f"train.epochs={S1_STEPS}",
            "train.log_every_steps=1", f"log.log_dir={work}/logs",
            f"train.ckpt_dir={work}/ckpt"]
    res, secs = _timed(lambda: cli_train.main(
        ["--task", "stage1", "--dataset-config", ds_cfg, "--max-steps", str(S1_STEPS),
         "--device", DEV, "--output", f"{work}/run", "--options", *opts]))
    with open(f"{work}/logs/metrics.jsonl") as fh:
        rows = [json.loads(x) for x in fh]
    keys = ("loss", "loss_itc", "loss_itm", "loss_lm")
    if res["step"] != S1_STEPS or [r["step"] for r in rows] != list(range(1, S1_STEPS + 1)) \
            or not all(np.isfinite(r[k]) for r in rows for k in keys):
        fail(f"blip2_stage1 cli.train: {res}, rows {rows}")
    tree = load_npz_tree(res["npz"])
    fresh = Blip2Qformer(cfg.blip2.qformer, device=DEV,
                         seed=apply_overrides(Config(), opts).train.seed)
    seeded = {n: p.detach().clone() for n, p in fresh.named_parameters()}
    unused = load_jax_variables(fresh, tree, {})
    untrained = [n for n, p in fresh.named_parameters() if torch.equal(p, seeded[n])]
    if unused or untrained or res["tensors"] != len(seeded):
        fail(f"blip2_stage1 .npz: unused leaves {unused}, tensors equal to the seed's "
             f"{untrained}, {res['tensors']} tensors for {len(seeded)} parameters")
    rec = {"steps": res["step"], "records": res["num_records"], "seconds": round(secs, 2),
           "losses": [{k: r[k] for k in keys} for r in rows], "npz_tensors": res["tensors"]}
    emit("blip2_stage1_cli_train", **rec)
    del fresh, seeded, tree
    _release()
    return rec


def stage1_retrieval(cfg) -> dict:
    """``RetrievalTask.evaluation`` over ``RET_N`` scenes x ``RET_N``
    captions with ``k_test`` 16 (1,024 ITM pair passes), bf16; then a small
    f32 model on the card against the CPU: scores within SMALL_ATOL, every
    rank equal."""
    qcfg = cfg.blip2.qformer
    task = RetrievalTask(cfg, k_test=RET_K, device=DEV)
    model = task.build_model()
    b = _stage1_batch(qcfg, RET_N, np.random.RandomState(SEED + 82))
    args = (b["image_embeds"], b["image_mask"], b["text_ids"], b["text_mask"])
    img2txt, txt2img = [[i] for i in range(RET_N)], list(range(RET_N))
    torch.cuda.reset_peak_memory_stats()
    metrics, secs = _timed(lambda: task.evaluation(model, *args, img2txt, txt2img))
    rec = {"scenes": RET_N, "captions": RET_N, "k_test": RET_K,
           "itm_pair_passes": 2 * RET_N * RET_K, "scene_tokens": qcfg.scene_token_capacity,
           "seconds": round(secs, 3), "recall": {k: round(v, 3) for k, v in metrics.items()},
           "peak_memory_gb": _peak_gb()}
    del model, b, args
    _release()

    small = apply_overrides(Config(), S1_SMALL).blip2.qformer
    rng = np.random.RandomState(SEED + 83)
    n, N = 9, small.scene_token_capacity
    im = (np.arange(N)[None] < rng.randint(8, N + 1, (n, 1))).astype(np.int32)
    tm = (np.arange(12)[None] < rng.randint(2, 13, (n, 1))).astype(np.int32)
    data = ((rng.randn(n, N, small.encoder_width) * im[..., None]).astype(np.float32), im,
            (rng.randint(4, small.vocab_size - 2, (n, 12)) * tm).astype(np.int32), tm)
    cpu = Blip2Qformer(small, device="cpu", seed=SEED + 84)
    init_random_weights(cpu, SEED + 85, std=None)      # N(0, 1 / fan_in): O(1) scores
    gpu = Blip2Qformer(small, device=DEV)
    gpu.load_state_dict(cpu.state_dict())
    want = compute_sim_matrix(cpu, *data, k_test=4, encode_batch=4, rerank_chunk=3)
    got = compute_sim_matrix(gpu, *data, k_test=4, encode_batch=4, rerank_chunk=3)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    ranks_equal = all(np.array_equal(np.argsort(-g, axis=1), np.argsort(-w, axis=1))
                      for g, w in zip(got, want))
    if not err <= SMALL_ATOL or not ranks_equal:
        fail(f"small Blip2Qformer retrieval: card vs CPU scores max abs err {err} "
             f"(tolerance {SMALL_ATOL}), ranks equal: {ranks_equal}")
    rec.update(small_f32_scores_max_abs_err=err, small_f32_ranks_equal=True)
    emit("blip2_stage1_retrieval", **rec)
    return rec


def _opt_batch(qcfg, ocfg, B: int, rng, prompt: int, answer: int = 0) -> dict:
    """Scenes of full length; prompts left-padded to ``prompt`` tokens with
    ragged real lengths (the first row full), then ``answer`` more tokens
    each, marked by ``target_mask``."""
    N, L = qcfg.scene_token_capacity, prompt + answer
    lens = np.concatenate([[prompt], rng.randint(4, prompt + 1, B - 1)]) + answer
    mask = (np.arange(L)[None] >= L - lens[:, None]).astype(np.int32)
    ids = np.where(mask > 0, rng.randint(3, min(ocfg.vocab_size, 50000), (B, L)),
                   ocfg.pad_token_id).astype(np.int32)
    return {"pc_feat": rng.randn(B, N, qcfg.encoder_width).astype(np.float32),
            "pc": rng.randint(0, 256, (B, N, 3)).astype(np.int32),
            "pc_mask": np.ones((B, N), np.int32), "input_ids": ids, "input_mask": mask,
            "target_mask": (mask * (np.arange(L)[None] >= prompt)).astype(np.int32)}


def zoo_blip2_opt(cfg) -> dict:
    """``Blip2OPT`` at OPT-2.7B, bf16 compute, float32 parameters: greedy
    decode of ``OPT_GEN`` tokens at B=8 after ragged left-padded prompts of
    up to 32 tokens (every step run: no end token; then once stopping at the
    newline as the reference does), the training forward and loss at B=4;
    then a small f32 model on the card against the CPU, tokens equal."""
    qcfg = cfg.blip2.qformer
    torch.cuda.reset_peak_memory_stats()
    model, build_s = _timed(lambda: Blip2OPT(qcfg, OPT_CFG, cfg.blip2.pc_feat_dim,
                                             dtype=torch.bfloat16, device=DEV, seed=SEED))
    rec = {"params": sum(p.numel() for p in model.parameters()),
           "opt_params": sum(p.numel() for p in model.opt.parameters()),
           "build_s": round(build_s, 3), "batch_size": OPT_DECODE_BATCH,
           "prompt_max": OPT_PROMPT, "max_len": OPT_GEN,
           "scene_tokens": 2 * qcfg.scene_token_capacity}
    rng = np.random.RandomState(SEED + 86)
    dbatch = tree_to_device(_opt_batch(qcfg, OPT_CFG, OPT_DECODE_BATCH, rng, OPT_PROMPT), DEV)
    tbatch = tree_to_device(_opt_batch(qcfg, OPT_CFG, OPT_TRAIN_BATCH, rng, OPT_PROMPT,
                                       answer=8), DEV)
    with torch.inference_mode():
        opt_predict_answers(model, dbatch, OPT_GEN, eos_id=-1)            # warm-up
        torch.cuda.reset_peak_memory_stats()
        tokens, greedy_s = _timed(lambda: opt_predict_answers(model, dbatch, OPT_GEN,
                                                              eos_id=-1))
        rec["decode_peak_memory_gb"] = _peak_gb()
        newline, newline_s = _timed(lambda: opt_predict_answers(model, dbatch, OPT_GEN,
                                                                eos_id=OPT_NEWLINE))
        model(tbatch)                                                    # warm-up
        out, train_s = _timed(lambda: model(tbatch))
    loss = float(out["loss"])
    if tokens.shape != (OPT_DECODE_BATCH, OPT_GEN) or newline.shape != tokens.shape \
            or not np.isfinite(loss) or not bool(torch.isfinite(out["logits"].float()).all()):
        fail(f"blip2_opt: tokens {tuple(tokens.shape)}, loss {loss}")
    rec.update(prompt_lengths=dbatch["input_mask"].sum(1).tolist(),
               greedy_s=round(greedy_s, 4),
               tokens_per_s=round(OPT_DECODE_BATCH * OPT_GEN / greedy_s, 2),
               newline_eos_s=round(newline_s, 4),
               newline_eos_tokens=int((newline != OPT_CFG.pad_token_id).sum()),
               train_forward_batch=OPT_TRAIN_BATCH, train_forward_ms=round(1e3 * train_s, 2),
               train_loss=loss)
    del model, dbatch, tbatch, out, tokens, newline
    _release()

    small_q, small_o = apply_overrides(Config(), S1_SMALL).blip2.qformer, OPTConfig.tiny()
    cpu = Blip2OPT(small_q, small_o, 48, device="cpu", seed=SEED + 87)
    init_random_weights(cpu, SEED + 88, std=None)
    gpu = Blip2OPT(small_q, small_o, 48, device=DEV)
    gpu.load_state_dict(cpu.state_dict())
    sb = _opt_batch(small_q, small_o, 3, np.random.RandomState(SEED + 89), 7, answer=3)
    with torch.inference_mode():
        want, got = cpu(sb)["logits"], gpu(sb)["logits"].cpu()
        t_want = opt_predict_answers(cpu, sb, 6, eos_id=-1)
        t_got = opt_predict_answers(gpu, sb, 6, eos_id=-1).cpu()
    err = float((got - want).abs().max())
    if not err <= SMALL_ATOL or not torch.equal(t_got, t_want):
        fail(f"small Blip2OPT: card vs CPU logits max abs err {err} (tolerance {SMALL_ATOL}), "
             f"greedy tokens equal: {torch.equal(t_got, t_want)}")
    rec.update(small_f32_logits_max_abs_err=err, small_f32_tokens_equal=True)
    emit("blip2_opt", **rec)
    return rec


def zoo_med_vit() -> dict:
    """MED at bert-base (text mode, multimodal mode, the LM head and its
    loss; B=8, 32 tokens, cross-attention into 197 ViT-B tokens), EVA-CLIP-g
    and CLIP-L (a forward each at B=8 of 224 x 224 images, ``ln_vision``
    after), bf16 compute."""
    rng = np.random.RandomState(SEED + 90)
    B, L = ZOO_BATCH, 32
    ids = torch.from_numpy(rng.randint(0, MED_CFG.vocab_size, (B, L))).to(DEV)
    am = torch.from_numpy((np.arange(L)[None] < rng.randint(8, L + 1, (B, 1))
                           ).astype(np.int32)).to(DEV)
    kw = dict(token_type_ids=torch.zeros_like(ids),
              encoder_hidden_states=torch.from_numpy(
                  rng.randn(B, 197, MED_CFG.encoder_width).astype(np.float32)).to(DEV),
              encoder_attention_mask=torch.ones(B, 197, dtype=torch.int32, device=DEV))
    labels = torch.where(am > 0, ids, -100)
    torch.cuda.reset_peak_memory_stats()
    med = MedBertModel(MED_CFG, dtype=torch.bfloat16, device=DEV, seed=SEED)
    lm = MedBertLMHeadModel(MED_CFG, dtype=torch.bfloat16, device=DEV, seed=SEED + 1)
    rec = {"med_params": sum(p.numel() for p in med.parameters()),
           "med_lm_params": sum(p.numel() for p in lm.parameters())}
    with torch.inference_mode():
        finite = True
        for mode in ("text", "multimodal"):
            seq, pooled = med(ids, am, mode=mode, **kw)
            finite &= bool(torch.isfinite(seq.float()).all() and torch.isfinite(pooled.float()).all())
            rec[f"med_{mode}_ms"] = round(time_cuda(lambda: med(ids, am, mode=mode, **kw),
                                                    iters=3, warmup=1), 3)
        loss = float(MedBertLMHeadModel.lm_loss(lm(ids, am, **kw), labels))
        rec["med_lm_loss_ms"] = round(time_cuda(lambda: MedBertLMHeadModel.lm_loss(
            lm(ids, am, **kw), labels), iters=3, warmup=1), 3)
    if not finite or not np.isfinite(loss):
        fail(f"MED: outputs finite {finite}, LM loss {loss}")
    rec.update(med_lm_loss=loss, med_peak_memory_gb=_peak_gb())
    del med, lm, seq, pooled, kw
    _release()
    images = torch.rand(B, VIT_IMG, VIT_IMG, 3, device=DEV)
    for name in ("eva_clip_g", "clip_L"):
        torch.cuda.reset_peak_memory_stats()
        vit, ln_vision = build_vit(name)
        vcfg = vit.cfg
        with torch.inference_mode():
            out = ln_vision(vit(images))
            ms = time_cuda(lambda: ln_vision(vit(images)), iters=3, warmup=1)
        if tuple(out.shape) != (B, 1 + vcfg.num_patches, vcfg.embed_dim) or \
                not bool(torch.isfinite(out.float()).all()):
            fail(f"{name}: output {tuple(out.shape)}, or not finite")
        rec[name] = {"depth": vcfg.depth, "width": vcfg.embed_dim,
                     "params": sum(p.numel() for p in vit.parameters()),
                     "tokens": 1 + vcfg.num_patches, "ms": round(ms, 3),
                     "peak_memory_gb": _peak_gb()}
        del vit, ln_vision, out
        _release()
    emit("model_zoo", batch_size=B, **rec)
    return rec


def phase_blip2_stage1(work: str) -> None:
    t0 = time.perf_counter()
    cfg = apply_overrides(Config(), [*S1_WIDTH, "train.bf16=true"])
    stage1_train(cfg)
    stage1_entry_point(work, cfg)
    stage1_retrieval(cfg)
    zoo_blip2_opt(cfg)
    zoo_med_vit()
    emit("blip2_stage1", seconds=round(time.perf_counter() - t0, 2))


# ---------------------------------------------------------------------------
# ddp: data parallelism across processes (parallel/mesh.py, parallel/collectives.py)

DDP_WORLD, DDP_STEPS = 2, 3
DDP_TIMEOUT = 600      # seconds for the two ranks, start-up included
DDP_G_MIN = 1e-2       # Adam's first update is lr*g/(|g|+eps): updates are held where |g| >= this
# What world 2 is held to against one process on the same card:
# - loss: the global loss, relative;
# - grad_l2: the first step's averaged gradient, L2 error a tensor over its norm (or 1% of
#   the largest tensor's norm), the worst tensor: where a wrong reduction shows;
# - update: the three-step update where every gradient was >= DDP_G_MIN, largest error over
#   the tensor's largest update. Adam normalizes each element's step, so an element's
#   rounding shows relative to its update;
# - update_in_lr: the largest error anywhere, in learning rates. An element whose gradient
#   is rounding noise can move either way; three AdamW steps move an element by at most
#   1.0036 lr each, so two runs part by at most ~6.02 lr.
DDP_TOL = {
    # float32 products (tf32 off): the row split changes only the order of the sums
    "small_sig3d": {"loss": 1e-5, "grad_l2": 1e-5, "update": 1e-3, "update_in_lr": 2.0},
    # bf16 products round to 2^-8 and splitting the batch changes the GEMM shapes, so the
    # gradients take other roundings (~1e-2); Adam then takes the elements whose gradient
    # is that noise a full step either way: only Adam's own bound holds elementwise
    "sig3d": {"loss": 1e-4, "grad_l2": 3e-2, "update": None, "update_in_lr": 6.1},
    # float32, as the reference's stage 1
    "stage1": {"loss": 1e-5, "grad_l2": 1e-4, "update": 1e-3, "update_in_lr": 2.0},
}


def _ddp_specs() -> dict:
    """What each case runs (picklable: the ranks rebuild it)."""
    return {"small_sig3d": {"kind": "sig3d", "options": [*SMALL_WIDTH, "train.frozen_prefixes="],
                            "dtype": "float32", "batch": BATCH},
            "sig3d": {"kind": "sig3d", "options": [*FULL_WIDTH, "train.frozen_prefixes="],
                      "dtype": "bfloat16", "batch": BATCH},
            "stage1": {"kind": "stage1", "options": list(S1_WIDTH), "dtype": "float32",
                       "batch": S1_BATCH, "text": S1_TEXT}}


def _ddp_case(spec, mesh, dev):
    """(model, optimizer, one step on the global batch -> the global loss)."""
    from situation3d_tpu_torch.parallel import collectives
    from situation3d_tpu_torch.parallel.mesh import shard_batch, sharded
    cfg = apply_overrides(Config(), spec["options"])
    B = spec["batch"]
    rows = (lambda b: b) if mesh is None else (lambda b: shard_batch(b, mesh))
    if spec["kind"] == "sig3d":
        model = SIG3D(cfg, cfg.data.num_answers, dtype=getattr(torch, spec["dtype"]), device=dev)
        init_random_weights(model, SEED)
        state = create_train_state(cfg, model, steps_per_epoch=1000, seed=SEED)
        batch = {k: v.numpy() for k, v in make_scene_batch(
            cfg, B, np.random.RandomState(SEED), device="cpu")[0].items()}
        return model, state.optimizer, lambda: collectives.pmean(
            train_step(cfg, state, rows(batch), mesh)["loss"].float())
    qcfg = cfg.blip2.qformer
    model = Blip2Qformer(qcfg, dtype=torch.float32, device=dev, seed=SEED)
    opt, _ = make_optimizer(cfg.train, model)
    rng = np.random.RandomState(SEED + 80)
    L = spec["text"]
    tm = (np.arange(L)[None] < rng.randint(4, L + 1, (B, 1))).astype(np.int32)
    batch = {"image_embeds": rng.randn(B, qcfg.scene_token_capacity,
                                       qcfg.encoder_width).astype(np.float32),
             "image_mask": np.ones((B, qcfg.scene_token_capacity), np.int32),
             "text_ids": (rng.randint(4, qcfg.vocab_size - 2, (B, L)) * tm).astype(np.int32),
             "text_mask": tm}
    negatives = sharded(torch.Generator(device=dev).manual_seed(SEED + 2), mesh)
    axis = mesh.data_axis if mesh is not None else None
    model.train()

    def step():
        out = model(rows(batch), negatives_axis=axis, generator=negatives)
        opt.discard()
        out["loss"].backward()
        collectives.pmean_grads(model.parameters())
        opt.step()
        return collectives.pmean(out["loss"].detach())
    return model, opt, step


def _ranks_bit_equal(params) -> bool:
    """Every rank holds bit for bit the same float32 ``params``: on every
    rank each element's bit pattern equals its minimum over the ranks."""
    from situation3d_tpu_torch.parallel import collectives
    bits = torch.cat([p.detach().reshape(-1) for p in params]).view(torch.int32)
    same = torch.equal(collectives.pmin(bits), bits)
    return bool(collectives.pmin(torch.tensor(float(same))) == 1.0)


def _ddp_run(name, spec, mesh, work, device) -> dict:
    """``DDP_STEPS`` steps of one case. One process (``mesh`` None): saves the
    first step's gradients, the masks of the elements whose every gradient
    is at least ``DDP_G_MIN``, the three-step updates and the losses as the
    reference. A rank: checks the ranks bit-equal after every step, times
    the gradient all-reduce, and rank 0 holds its gradients, updates and
    losses against the reference."""
    import os
    from situation3d_tpu_torch.parallel import collectives
    dev = torch.device(device) if mesh is None else mesh.device
    cuda = dev.type == "cuda"
    model, opt, step = _ddp_case(spec, mesh, dev)
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    start = {n: p.detach().clone() for n, p in trainable}
    masks, first, losses = {}, {}, []
    apply = opt.step

    def recording():                   # the gradients the update is handed
        for n, p in trainable:
            if p.grad is not None:
                if not losses:
                    first[n] = p.grad.detach().clone()
                big = p.grad.abs() >= DDP_G_MIN
                masks[n] = big if n not in masks else masks[n] & big
        return apply()
    opt.step = recording
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    secs, equal = [], []
    for _ in range(DDP_STEPS):
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss = float(step())
        if cuda:
            torch.cuda.synchronize(dev)
        secs.append(round(time.perf_counter() - t0, 4))
        losses.append(loss)
        if mesh is not None:
            equal.append(_ranks_bit_equal([p for _, p in trainable]))
    rec = {"losses": losses, "step_s": secs, "trainable_tensors": len(trainable),
           "peak_gb": round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 2) if cuda else None}
    path = os.path.join(work, f"ddp_{name}.pt")
    if mesh is None:
        torch.save({"losses": losses, "masks": {n: m.cpu() for n, m in masks.items()},
                    "grads": {n: g.cpu() for n, g in first.items()},
                    "updates": {n: (p.detach() - start[n]).cpu() for n, p in trainable}}, path)
        return rec
    rec["ranks_bit_equal_after_each_step"] = equal
    params = [p for _, p in trainable]
    for p in params:                   # a step's gradient all-reduce, timed alone
        p.grad = torch.zeros_like(p)
    ms = []
    for _ in range(2):
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        collectives.pmean_grads(params)
        if cuda:
            torch.cuda.synchronize(dev)
        ms.append(round(1e3 * (time.perf_counter() - t0), 2))
    rec["allreduce_ms"] = ms
    rec["allreduce_mb"] = round(sum(p.numel() * 4 for p in params) / 2 ** 20, 1)
    if mesh.rank == 0:
        rec.update(_ddp_against_one_process(torch.load(path, weights_only=False), trainable,
                                            start, first, losses,
                                            apply_overrides(Config(), spec["options"]).train.lr,
                                            dev))
    return rec


def _ddp_against_one_process(ref, trainable, start, first, losses, lr, dev) -> dict:
    """Rank 0's run against one process's: the losses (relative), the first
    step's averaged gradient (L2 error a tensor over its norm or 1% of the
    largest tensor's, the worst), the
    three-step update where every gradient was at least ``DDP_G_MIN``
    (largest error over the tensor's largest update, the worst tensor) and
    everywhere (largest error, in units of the learning rate)."""
    out = {"loss_rel_err": [abs(a - b) / max(abs(b), 1e-30)
                            for a, b in zip(losses, ref["losses"])]}
    if set(first) != set(ref["grads"]):
        fail(f"ddp: other tensors got a gradient: {sorted(set(first) ^ set(ref['grads']))[:4]}")
    # a tensor whose gradient nearly cancels (a bias before a norm) is held to the
    # rounding of the larger ones: the floor is 1% of the largest tensor's norm
    norms = {n: float(g.norm()) for n, g in ref["grads"].items()}
    floor = 1e-2 * max(norms.values(), default=0.0)
    grad = max(((float((first[n] - g.to(dev)).norm()) / max(norms[n], floor, 1e-30), n)
                for n, g in ref["grads"].items()), default=(0.0, ""))
    upd, anywhere, held = (0.0, ""), 0.0, 0
    for n, p in trainable:
        want = ref["updates"][n].to(dev)
        err = (p.detach() - start[n] - want).abs()
        anywhere = max(anywhere, float(err.max()) / lr)
        if n in ref["masks"]:          # no gradient at all: weight decay alone, whole
            m = ref["masks"][n].to(dev)
            if not bool(m.any()):
                continue
            err = err[m]
        held += 1
        upd = max(upd, (float(err.max()) / max(float(want.abs().max()), 1e-30), n))
    shares = [(int(m.sum()), m.numel()) for m in ref["masks"].values()]
    return {**out, "grad_rel_l2": grad[0], "grad_worst_tensor": grad[1],
            "update_rel_err": upd[0], "update_worst_tensor": upd[1],
            "update_max_abs_err_in_lr": anywhere, "tensors_held": held,
            "masked_share": round(sum(a for a, _ in shares) / max(sum(b for _, b in shares), 1), 4)}


def _ddp_rank(rank, port, work, specs, device) -> None:
    """One rank of the world-2 run: every case, a report to ``work``. Both
    ranks take ``device`` (index 0 of a card)."""
    import os
    from situation3d_tpu_torch.config import MeshConfig
    from situation3d_tpu_torch.parallel import collectives
    from situation3d_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    collectives.initialize_multihost(f"127.0.0.1:{port}", DDP_WORLD, rank, backend="gloo",
                                     device=dev)
    try:
        mesh = make_mesh(MeshConfig(), dev)
        report = {}
        for name, spec in specs.items():
            report[name] = _ddp_run(name, spec, mesh, work, device)
            _release()
        with open(os.path.join(work, f"ddp_rank{rank}.json"), "w") as fh:
            json.dump(report, fh)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _ddp_world2(work, specs) -> list:
    """Two ranks on the one card under gloo, spawned; a rank that raises
    fails the phase, one that hangs fails it at ``DDP_TIMEOUT``."""
    import torch.multiprocessing as tmp
    ctx = tmp.start_processes(_ddp_rank, args=(_free_port(), work, specs, DEV), nprocs=DDP_WORLD,
                              join=False, start_method="spawn")
    deadline = time.perf_counter() + DDP_TIMEOUT
    while not ctx.join(timeout=5):
        if time.perf_counter() > deadline:
            for proc in ctx.processes:
                proc.kill()
            fail(f"ddp: the ranks did not finish within {DDP_TIMEOUT} s")
    reports = []
    for r in range(DDP_WORLD):
        with open(f"{work}/ddp_rank{r}.json") as fh:
            reports.append(json.load(fh))
    return reports


def _ddp_nccl_world1(work) -> dict:
    """``cli.train --task stage1`` on 3D-VQA files, plain and under
    ``torch.distributed.run --nproc-per-node 1`` (NCCL), each in a fresh
    process: the ``.npz`` files bit-equal, or, where the card does not
    repeat a run bit for bit, the NCCL run within two plain runs' spread."""
    import os
    ds_cfg, _, _ = write_3dvqa_files(os.path.join(work, "data"),
                                     apply_overrides(Config(), S1_WIDTH).blip2.qformer
                                     .encoder_width)

    def argv(name):
        return ["--task", "stage1", "--dataset-config", ds_cfg, "--max-steps", str(S1_STEPS),
                "--device", DEV, "--output", f"{work}/{name}/run", "--options", *S1_WIDTH,
                f"train.batch_size={S1_BATCH}", f"train.epochs={S1_STEPS}",
                "train.log_every_steps=1", f"log.log_dir={work}/{name}/logs",
                f"train.ckpt_dir={work}/{name}/ckpt"]

    def npz(name):
        with np.load(f"{work}/{name}/run/stage1_qformer.npz") as z:
            return {k: z[k] for k in z.files}

    def max_diff(a, b):
        return max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in b)

    here = os.path.dirname(os.path.abspath(__file__))          # where the package is
    env = {**os.environ, "OMP_NUM_THREADS": "1"}   # torch.distributed.run's default

    def run(name, launcher):
        t0 = time.perf_counter()
        done = subprocess.run([sys.executable, "-m", *launcher, "situation3d_tpu_torch.cli.train",
                               *argv(name)], capture_output=True, text=True, timeout=600,
                              cwd=here, env=env)
        if done.returncode != 0:
            fail(f"ddp: cli.train stage1 ({' '.join(launcher)}) failed:\n"
                 f"{done.stdout[-2000:]}\n{done.stderr[-3000:]}")
        return round(time.perf_counter() - t0, 2)

    torchrun = ["torch.distributed.run", "--nnodes", "1", "--nproc-per-node", "1",
                "--master-addr", "127.0.0.1", "--master-port", str(_free_port()), "-m"]
    plain_s, nccl_s = run("plain", []), run("nccl", torchrun)
    plain, nccl = npz("plain"), npz("nccl")
    if plain.keys() != nccl.keys():
        fail(f"ddp: the NCCL run's .npz holds other tensors: {sorted(set(plain) ^ set(nccl))}")
    rec = {"tensors": len(plain), "plain_s_with_start_up": plain_s,
           "torchrun_s_with_start_up": nccl_s,
           "nccl_vs_plain_max_abs": max_diff(nccl, plain)}
    rec["bit_equal"] = rec["nccl_vs_plain_max_abs"] == 0.0
    if not rec["bit_equal"]:
        run("plain2", [])
        rec["plain_vs_plain_max_abs"] = max_diff(npz("plain2"), plain)
        if rec["nccl_vs_plain_max_abs"] > rec["plain_vs_plain_max_abs"]:
            fail(f"ddp: the NCCL world-1 run differs from plain cli.train by more than two "
                 f"plain runs differ: {rec}")
    return rec


def phase_ddp(work: str, card: str) -> None:
    """World 2 on the one card (gloo; two ranks share it, so no number here
    is scaling): an f32 small SIG3D, the full-width bf16 SIG3D with its
    scene encoder trained, and the full-width f32 stage-1 Q-Former, each 3
    steps on a global batch of 8, the ranks bit-equal after every step and
    within ``DDP_TOL`` of one process on the same card; then world 1 under
    NCCL through ``torch.distributed.run`` against plain ``cli.train``."""
    t0 = time.perf_counter()
    specs = _ddp_specs()
    world1 = {}
    for name, spec in specs.items():
        world1[name] = _ddp_run(name, spec, None, work, DEV)
        _release()
    ranks = _ddp_world2(work, specs)
    for name in specs:
        emit("ddp_case", name=name, card=card, world1=world1[name], world2_rank0=ranks[0][name],
             world2_rank1_peak_gb=ranks[1][name]["peak_gb"], tolerance=DDP_TOL[name])
    for name in specs:
        r0, r1, tol = ranks[0][name], ranks[1][name], DDP_TOL[name]
        if not (all(r0["ranks_bit_equal_after_each_step"])
                and all(r1["ranks_bit_equal_after_each_step"])):
            fail(f"ddp {name}: the ranks' parameters differ after a step")
        if not all(np.isfinite(r0["losses"])) or r0["losses"] != r1["losses"]:
            fail(f"ddp {name}: losses {r0['losses']} / {r1['losses']}")
        if max(r0["loss_rel_err"]) > tol["loss"] or r0["grad_rel_l2"] > tol["grad_l2"] \
                or (tol["update"] is not None and r0["update_rel_err"] > tol["update"]) \
                or r0["tensors_held"] < 1 \
                or r0["update_max_abs_err_in_lr"] > tol["update_in_lr"]:
            fail(f"ddp {name}: world 2 differs from one process beyond {tol}")
    nccl = _ddp_nccl_world1(work)
    emit("ddp", card=card, note="world 2: two ranks share ONE card under gloo, so its "
         "times are not scaling; the all-reduce stages through the host",
         step_s={n: {"world1": world1[n]["step_s"], "world2_rank0": ranks[0][n]["step_s"]}
                 for n in specs},
         allreduce_ms={n: ranks[0][n]["allreduce_ms"] for n in specs},
         peak_gb={n: {"world1": world1[n]["peak_gb"],
                      "world2": [ranks[r][n]["peak_gb"] for r in range(DDP_WORLD)]}
                  for n in specs},
         nccl_world1=nccl, seconds=round(time.perf_counter() - t0, 2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", help="comma-separated subset of: "
                    "device,kernels,forward,train,serving,minkunet,detection,sqa3d,"
                    "sortplan,openscene,lstm,multiview,blip2,blip2_stage1,ddp,reference,nemotron")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on a CUDA device and has no CPU fallback",
              file=sys.stderr)
        return 1
    phases = [p for p in args.only.split(",") if p] or \
        ["device", "kernels", "forward", "train", "serving", "minkunet", "detection",
         "sqa3d", "sortplan", "openscene", "lstm", "multiview", "blip2", "blip2_stage1",
         "ddp", "reference", "nemotron"]
    full_run = not args.only
    t_run = time.perf_counter()
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
    unet_counts = {}
    if "minkunet" in phases:
        unet_counts = phase_minkunet(cfg, batch)
    if "detection" in phases:
        det_counts = phase_detection()
    if "sqa3d" in phases:
        with tempfile.TemporaryDirectory() as work:
            phase_sqa3d(work)
    sort_counts, os_counts, mv_counts = {}, {}, {}
    if "sortplan" in phases:
        sort_counts = phase_sortplan(cfg, batch)
    if "openscene" in phases:
        with tempfile.TemporaryDirectory() as work:
            os_counts = phase_openscene(work)
    if "lstm" in phases:
        with tempfile.TemporaryDirectory() as work:
            phase_lstm(work)
    if "multiview" in phases:
        mv_counts = phase_multiview()
    if "blip2" in phases:
        with tempfile.TemporaryDirectory() as work:
            phase_blip2(work)
    if "blip2_stage1" in phases:
        with tempfile.TemporaryDirectory() as work:
            phase_blip2_stage1(work)
    if "ddp" in phases:
        with tempfile.TemporaryDirectory() as work:
            phase_ddp(work, info["card"])
    if "reference" in phases:
        phase_reference()
        phase_reference_detection()
    if "nemotron" in phases:
        phase_nemotron()
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
        "k5_map_lookup": ("situation3d_tpu_torch/csrc/map_lookup.cu",
                          "situation3d_tpu/sparse/kernel_map.py:144 lookup_kernel_map_dense "
                          "(XLA, level 0)", counts, forward),
        "gather_rows": ("situation3d_tpu_torch/csrc/gather_rows.cu",
                        "situation3d_tpu/ops/pallas/gather.py:39", train_counts, step),
        "scatter_add_rows": ("situation3d_tpu_torch/csrc/gather_rows.cu",
                             "situation3d_tpu/ops/pallas/gather.py:82", train_counts, step),
        "segment_plan": ("situation3d_tpu_torch/csrc/segment_plan.cu",
                         "situation3d_tpu/ops/pallas/gather.py:82", train_counts, step),
        "fps": ("situation3d_tpu_torch/csrc/fps.cu",
                "situation3d_tpu/ops/pallas/fps.py:61", det_counts["forward"], det_forward),
        "moe_experts": ("situation3d_tpu_torch/csrc/moe_experts.cu",
                        "none: the JAX package has no experts",
                        {"moe_experts": records["moe_experts"]["lfm2"]["launches_replayed_batch"]},
                        "one B=8 lfm2_predict_answers batch replayed, LFM2-24B-A2B's widths at "
                        "4 layers (2 with experts): the prefill's; the steps' are in graphs")}
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
        k["launches_sort_plan_forward"] = sort_counts[name]
        k["launches_training_unet_forward"] = os_counts["forward"][name]
        k["launches_training_unet_backward"] = os_counts["backward"][name]
        k["launches_multiview_forward_backward"] = mv_counts[name]
        if name in ("gather_rows", "scatter_add_rows", "segment_plan"):
            k["launches_votenet_forward"] = det_counts["forward"][name]
            k["launches_votenet_forward_backward"] = det_counts["forward_backward"][name]
        if name in MAP_KERNELS:
            k["device_ms"] = r["device_ms"]
        if name == "moe_experts":
            k["shapes"] = r["shapes"]
            k["launches_eager_batch"] = r["lfm2"]["launches_eager_batch"]
        if name == "scatter_add_rows":
            k["sum_only_ms"] = r["sum_only_ms"]     # ms is the whole call: sums + plans
        if name == "fused_sparse_conv":
            k["launches_train_step_unfrozen"] = train_counts[name]
            k["launches_full_unet_forward"] = unet_counts[name]
            k["device_ms"] = r["device_ms"]
            k["shapes"] = [{kk: sh[kk] for kk in ("name", "per_forward", "instance", "hit_share",
                                                 "ms", "device_ms", "bound_ms", "bound_by")}
                           for sh in r["shapes"]]
            k["backward_dx_ms"] = records["conv_backward"]["dx_ms"]
            k["backward_dx_bound_ms"] = records["conv_backward"]["dx_bound_ms"]
            k["backward_dx_launches"] = train_counts[name] - counts[name]
        kernels.append(k)
    emit("run", seconds=round(time.perf_counter() - t_run, 1))
    print(info["card"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
