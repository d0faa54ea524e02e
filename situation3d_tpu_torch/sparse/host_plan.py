"""UNet plans built on the host (port of ``situation3d_tpu/sparse/host_plan.py``):
the plan ``sparse/minkunet.py:build_unet_plan`` builds on the device, built
instead with numpy and the C++ library (``ops/native.py``) inside the data
pipeline, MinkowskiEngine's CoordinateManager role. A batch that carries
such a plan under ``"plan"`` makes ``SIG3D`` skip its plan build: no map
kernel runs on the device.

Equal, bit for bit, to the JAX package's ``build_host_plan``. Against the
device plan: each level holds the same coordinate SET (here in
first-occurrence order, there in key-sorted order) and the maps agree once
that permutation is aligned; on capacity overflow the two keep different
subsets (here a first-occurrence prefix, there a key-sorted one).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Sequence

import numpy as np

from situation3d_tpu_torch.ops import native
from situation3d_tpu_torch.sparse.kernel_map import kernel_offsets
from situation3d_tpu_torch.sparse.minkunet import STRIDES


def build_host_plan_sample(
    coords: np.ndarray,
    num_valid: int,
    capacities: Sequence[int],
) -> Dict[str, Any]:
    """Plan for ONE sample. coords [V0, 3] padded; first num_valid rows real.

    Returns the same nested structure as build_unet_plan but with numpy
    arrays and no batch axis (stack across samples to feed the model).
    """
    k2 = kernel_offsets(2)
    k3 = kernel_offsets(3)
    k5 = kernel_offsets(5)
    native.ensure_built()

    levels = []
    dropped = 0
    cur = np.ascontiguousarray(coords[:num_valid], np.int32)
    for i, stride in enumerate(STRIDES):
        cap = capacities[i]
        if i > 0:
            cur = native.downsample(levels[i - 1]["_real"], STRIDES[i])
            dropped += max(0, len(cur) - cap)
            cur = cur[:cap]
        padded = np.zeros((cap, 3), np.int32)
        n = min(len(cur), cap)
        padded[:n] = cur[:n]
        mask = np.zeros(cap, bool)
        mask[:n] = True
        levels.append({"coords": padded, "mask": mask, "_real": cur[:n]})

    def pad_map(m: np.ndarray, n_in_real: int, cap_in: int, cap_out: int,
                k: int) -> np.ndarray:
        # remap miss sentinel from n_in_real to cap_in; pad rows to cap_out
        out = np.full((cap_out, k), cap_in, np.int32)
        m = np.where(m == n_in_real, cap_in, m)
        out[: len(m)] = m
        return out

    for i, lvl in enumerate(levels):
        s = STRIDES[i]
        cap = capacities[i]
        real = lvl["_real"]
        lvl["map_k3"] = pad_map(
            native.kernel_map(real, s, real, k3, s), len(real), cap, cap, 27)
        if i == 0:
            lvl["map_k5"] = pad_map(
                native.kernel_map(real, s, real, k5, s), len(real), cap, cap, 125)
        if i > 0:
            fine = levels[i - 1]
            sf = STRIDES[i - 1]
            capf = capacities[i - 1]
            lvl["map_down"] = pad_map(
                native.kernel_map(fine["_real"], sf, real, k2, sf),
                len(fine["_real"]), capf, cap, 8)
            fine["map_up"] = pad_map(
                native.kernel_map(real, s, fine["_real"], -k2, sf),
                len(real), cap, capf, 8)
    for lvl in levels:
        del lvl["_real"]
    return {"levels": levels,
            "overflow": {"voxels_dropped": np.int32(dropped),
                         "extent_misses": np.int32(0)}}


def stack_plans(plans) -> Dict[str, Any]:
    """Stack per-sample plans into the batched plan pytree."""
    out = {"levels": []}
    for i in range(len(plans[0]["levels"])):
        lvl = {}
        for key in plans[0]["levels"][i]:
            lvl[key] = np.stack([p["levels"][i][key] for p in plans])
        out["levels"].append(lvl)
    if "overflow" in plans[0]:
        out["overflow"] = {
            k: np.stack([p["overflow"][k] for p in plans])
            for k in plans[0]["overflow"]}
    return out


def build_host_plan(coords: np.ndarray, mask: np.ndarray,
                    capacities: Sequence[int],
                    max_workers: int = 8) -> Dict[str, Any]:
    """Batched host plan for coords [B, V, 3] + mask [B, V].

    Samples build in a thread pool: the ctypes calls into the C++ library
    release the GIL, and the probe loops are OpenMP-parallel besides."""
    with ThreadPoolExecutor(max_workers=min(max_workers, len(coords))) as ex:
        plans = list(ex.map(
            lambda b: build_host_plan_sample(
                coords[b], int(mask[b].sum()), capacities),
            range(len(coords))))
    return stack_plans(plans)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _coord_keys(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.int64)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


# map key -> (level of its input rows relative to its own level)
_MAP_INPUT = {"map_k5": 0, "map_k3": 0, "map_down": -1, "map_up": 1}


def compare_with_device_plan(host: Dict[str, Any], device: Dict[str, Any]):
    """Hold a host plan against the device plan (``build_unet_plan``) of the
    same voxels. A level is compared when neither plan can have dropped a
    voxel there or above it (every level from 1 on holds fewer voxels than
    its capacity in both; a voxel outside the device plan's extent is
    dropped there and shows as a difference). On those levels the coordinate
    sets must be equal and every map equal once the rows are aligned (host
    rows in first-occurrence order, device rows in key order): host entry
    ``m[r, k] = v`` must read ``perm(v)`` at device row ``perm(r)``, a miss
    the same miss. Returns ``(levels compared, list of differences)``."""
    H, D = host["levels"], device["levels"]
    compared = [0]
    for i in range(1, len(H)):
        cap = H[i]["mask"].shape[-1]
        full = (_np(H[i]["mask"]).sum(-1) >= cap) | (_np(D[i]["mask"]).sum(-1) >= cap)
        if full.any():
            break
        compared.append(i)
    problems = []
    for b in range(_np(H[0]["mask"]).shape[0]):
        perm, rows = {}, {}
        for i in compared:
            hm, dm = _np(H[i]["mask"][b]), _np(D[i]["mask"][b])
            hk = _coord_keys(_np(H[i]["coords"][b])[hm])
            dk = _coord_keys(_np(D[i]["coords"][b])[dm])
            if not np.array_equal(np.sort(hk), np.sort(dk)):
                problems.append(f"sample {b} level {i}: coordinate sets differ")
                continue
            cap = hm.shape[0]
            p = np.full(cap + 1, cap, np.int64)       # the miss maps to itself
            dev_row = np.flatnonzero(dm)[np.argsort(dk, kind="stable")]
            p[np.flatnonzero(hm)[np.argsort(hk, kind="stable")]] = dev_row
            perm[i], rows[i] = p, np.flatnonzero(hm)
        for i in perm:
            for key, rel in _MAP_INPUT.items():
                j = i + rel
                if key not in H[i] or j not in perm:
                    continue
                h = _np(H[i][key][b])[rows[i]]
                cap_j = len(perm[j]) - 1
                want = np.where((h >= 0) & (h <= cap_j), perm[j][np.clip(h, 0, cap_j)], -1)
                got = _np(D[i][key][b])[perm[i][rows[i]]]
                if not np.array_equal(want, got):
                    problems.append(f"sample {b} level {i} {key}: maps differ after "
                                    f"aligning rows ({int((want != got).sum())} entries)")
    return compared, problems
