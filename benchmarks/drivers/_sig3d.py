"""SIG3D on the port, as the SIG3D cells drive it: the port's ``Config``
from the configuration file, the model on the card with the benchmark's
weights, the pool of rooms and questions a mix asks for, and the
reference's readings of the same inputs."""
from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from benchmarks.flops import sig3d as flops
from benchmarks.harness.cell import set_dotted
from benchmarks.harness.scenes import make_rooms, questions, voxelize_rooms
from benchmarks.reference import sig3d as ref
from benchmarks.reference.precision import Exact, exact_float32
from benchmarks.reference.weights import make_weights, sub_seed

# streams of the run's seed
ROOMS, TEXT, DRAWS, SAMPLE_GEN, DROPOUT_GEN, PICK, PLAN = 2, 3, 4, 5, 6, 7, 9


def port_config(settings: dict):
    from situation3d_tpu_torch.config import Config
    cfg = Config()
    for k, v in settings.items():
        set_dotted(cfg, k, v)
    return cfg


def build_model(config: dict, seed: int, device):
    """SIG3D built on ``meta``, placed on ``device`` and filled with the
    benchmark's weights (every parameter and buffer by name)."""
    from situation3d_tpu_torch.models import sig3d as port
    settings = config["settings"]
    cfg = port_config(settings)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["compute_dtype"]]
    with torch.device("meta"):
        model = port.SIG3D(cfg, settings["data.num_answers"], dtype=dtype, device="meta")
    model.to_empty(device=device)
    load_weights(model, make_weights(ref.param_spec(settings), seed, device))
    model.eval()
    return cfg, model


def load_weights(model: torch.nn.Module, w: Dict[str, torch.Tensor]) -> None:
    """Every tensor of ``model``'s state takes ``w``'s tensor of its name."""
    every = dict(model.named_parameters())
    every.update(dict(model.named_buffers()))
    names = {n: every[n] for n in model.state_dict()}
    if set(names) != set(w):
        raise KeyError(f"model and weights differ: {sorted(set(names) ^ set(w))[:8]}")
    for n, t in names.items():
        if t.shape != w[n].shape:
            raise ValueError(f"{n}: model {tuple(t.shape)}, weights {tuple(w[n].shape)}")
        t.data = w[n]


class Scenes:
    """A pool of ``mix["rooms"]`` distinct rooms (host numpy, the data
    pipeline's layout) and the token draws of each."""

    def __init__(self, mix: dict, s: dict, seed: int, device):
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, ROOMS))
        pts = make_rooms(mix["rooms"], mix["points"], mix["room"], mix["boxes"], gen)
        c, f, m, _ = voxelize_rooms(pts, s["data.voxel_size"], s["sparse.capacities"][0], gen)
        del pts
        self.coords, self.feats, self.mask = c.cpu().numpy(), f.cpu().numpy(), m.cpu().numpy()
        g = torch.Generator(device=device).manual_seed(sub_seed(seed, DRAWS))
        n, V4, N = mix["rooms"], s["sparse.capacities"][-1], s["model.num_scene_tokens"]
        self.uniform = torch.rand((n, V4), generator=g, device=device)
        self.dup = torch.randint(0, 2 ** 31 - 1, (n, N), generator=g, device=device,
                                 dtype=torch.int32)

    def voxels_of(self, idx) -> Dict[str, np.ndarray]:
        return {"voxel_coords": self.coords[idx], "voxel_feats": self.feats[idx],
                "voxel_mask": self.mask[idx]}

    def draws_of(self, idx):
        idx = torch.as_tensor(np.asarray(idx), device=self.uniform.device)
        return self.uniform[idx], self.dup[idx]


def make_batches(mix: dict, s: dict, seed: int, scenes: Scenes, n_batches: int, B: int):
    """``n_batches`` host batches of ``B`` rows: batch k's rooms are rooms
    ``kB..kB+B-1`` of the pool (mod its size), its texts its own."""
    text = questions(seed, TEXT, n_batches * B, mix, s)
    out = []
    for k in range(n_batches):
        rooms = (np.arange(B) + k * B) % mix["rooms"]
        batch = {key: v[k * B:(k + 1) * B] for key, v in text.items()}
        batch.update(scenes.voxels_of(rooms))
        batch["sample_valid"] = np.ones(B, bool)
        out.append((rooms, batch))
    return out


def free() -> None:
    """Return the memory of the program's state, dropped by the caller,
    before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if k != "question_id"}


def reference(s: dict, seed: int, device, precision: Exact = None):
    """The reference model over freshly made weights (float32)."""
    exact_float32()
    w = make_weights(ref.param_spec(s), seed, device)
    return ref.Sig3dReference(s, w, precision), w


class EncoderTap:
    """What the timed path's scene encoder took and gave, kept through a
    forward hook on ``model.scene_encoder`` under the key the driver sets
    before each call (None: keep nothing): ``feat_bottleneck`` of each
    key's last call, and the plan of call ``plan_call`` (of the last call,
    where there were fewer) with its key. It holds references and adds no
    work; the one plan it keeps alive adds its size (about 1.3 GB at B=32)
    to the peak."""

    def __init__(self, model, plan_call: int):
        self.key, self.plan_call, self.calls = None, plan_call, 0
        self.bottleneck: Dict = {}
        self.plan = self.plan_key = None
        model.scene_encoder.register_forward_hook(self._keep)

    def _keep(self, module, args, out) -> None:
        if self.key is None:
            return
        self.bottleneck[self.key] = out["feat_bottleneck"]
        if self.calls <= self.plan_call:
            self.plan, self.plan_key = args[1], self.key
        self.calls += 1


# the reference's maps and the program's, by level: (reference key, program key,
# level whose rows the map indexes, relative to the level that owns it)
MAPS = (("k5", "map_k5", 0), ("k3", "map_k3", 0), ("down", "map_down", -1))


def plan_mismatch(levels: List[dict], plan: dict) -> float:
    """Entries in which the program's plan departs from the reference's
    levels: each level's mask, the coordinates of the voxels both keep, and
    every k5, k3 and down map entry (a missing neighbour is -1 in the
    reference, the indexed level's row count in the program). An exact
    comparison: its limit is 0."""
    if plan is None or len(plan["levels"]) != len(levels):
        return float("inf")
    bad = 0
    for i, (mine, theirs) in enumerate(zip(levels, plan["levels"])):
        m, tm = mine["mask"], theirs["mask"].bool()
        if m.shape != tm.shape:
            return float("inf")
        bad += int((m != tm).sum())
        both = m & tm
        bad += int((mine["coords"][both] != theirs["coords"][both].long()).any(-1).sum())
        for rk, pk, rel in MAPS:
            if rk not in mine:
                continue
            if pk not in theirs or theirs[pk].shape != mine[rk].shape:
                return float("inf")
            v_in = levels[i + rel]["mask"].shape[1]
            want = torch.where(mine[rk] < 0, v_in, mine[rk])
            bad += int((theirs[pk].long() != want).sum())
    return float(bad)


def bottleneck_err(prog, want: torch.Tensor, mask: torch.Tensor) -> float:
    """The widest gap of ``prog``'s ``feat_bottleneck`` (the program's
    ``SparseVoxels``, or the control's tensor) from the reference's over the
    reference's valid voxels, over the reference's largest magnitude there."""
    feats = getattr(prog, "feats", prog)
    if feats.shape != want.shape:
        return float("inf")
    p, r = feats.float().to(want.device)[mask], want[mask]
    return float((p - r).abs().max() / r.abs().max().clamp(min=1e-30))


def answer_readings(prog: List[dict], want: List[dict]) -> Dict[str, float]:
    """The widest gap of the served answer scores and situation outputs from
    the reference's, each over the largest magnitude the reference gives
    across the compared questions."""
    out = {}
    for key, name in (("answer_scores", "answer_err"), ("aux_scores", "situation_err")):
        p = torch.cat([torch.as_tensor(x[key]).float().cpu() for x in prog])
        r = torch.cat([torch.as_tensor(x[key]).float().cpu() for x in want])
        out[name] = float((p - r).abs().max() / r.abs().max().clamp(min=1e-30))
    return out


def batch_hits(s: dict, batch: dict, device) -> tuple:
    """The kernel-map hits and valid voxels a level of one batch's scenes
    (the reference's plan of the same voxels)."""
    levels = ref.build_plan(torch.as_tensor(batch["voxel_coords"], device=device),
                            torch.as_tensor(batch["voxel_mask"], device=device).bool(),
                            s["sparse.capacities"], s["sparse.grid_extent"])
    return ref.map_hits(levels), {i: int(lv["mask"].sum()) for i, lv in enumerate(levels)}


def conv_least(s: dict, B: int, hits: dict) -> float:
    return flops.conv_least_seconds(s, B, hits)
