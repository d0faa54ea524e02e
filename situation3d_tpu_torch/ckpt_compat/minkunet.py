"""OpenScene MinkUNet18A checkpoint -> the MinkUNet tree (port of
``situation3d_tpu/ckpt_compat/minkunet.py``).

Maps the state dict of the reference's ``DisNet`` (``scannet_openseg.pth.tar``;
MinkowskiEngine module names) into the ``(params, batch_stats)`` tree of
``sparse/minkunet.py`` that ``ckpt_compat/from_jax.py:load_jax_variables``
lays over a port ``MinkUNet`` (a SIG3D's ``scene_encoder``). The offset
order below is the port's one statement of MinkowskiEngine's.

MinkowskiEngine stores conv kernels as ``[kernel_volume, C_in, C_out]`` —
the same layout as sparse/conv.py — but enumerates hypercube offsets with
the FIRST coordinate fastest, while kernel_map.kernel_offsets enumerates
x slowest (itertools.product). Evidence for x-fastest: ME 0.5's
``kernel_region::coordinate_at`` decodes a kernel index with
``coord[axis] = lower[axis] + (ind % size) * dilation; ind /= size``
iterating axis 0 first, i.e. the first spatial axis is the fastest-varying
digit. ``reorder_kernel`` permutes between the two; ``me_x_fastest=False``
selects the product order if a checkpoint disagrees, and
:func:`kernel_order_coherence` tells a *trained* hypercube kernel from a
scrambled one by its spatial smoothness (adjacent offsets of a trained conv
correlate). The x-fastest order has never been checked against a real
checkpoint.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


def me_offset_permutation(kernel_size: int) -> np.ndarray:
    """perm[i] = ME flat index of our canonical (product-order) offset i.

    ours: index = x*n^2 + y*n + z ; ME: index = x + y*n + z*n^2.
    """
    n = kernel_size
    ours = np.arange(n ** 3)
    x, rem = ours // (n * n), ours % (n * n)
    y, z = rem // n, rem % n
    return x + y * n + z * n * n


def reorder_kernel(k: np.ndarray, kernel_size: int, me_x_fastest: bool = True
                   ) -> np.ndarray:
    """Permute ME offset enumeration -> canonical kernel_offsets order."""
    K = k.shape[0]
    if K == 1 or not me_x_fastest:
        return k
    if kernel_size ** 3 != K:
        raise ValueError(f"a kernel of {K} offsets is not a {kernel_size}-cube")
    return k[me_offset_permutation(kernel_size)]


def kernel_order_coherence(kernel: np.ndarray, kernel_size: int = 3):
    """Spatial-coherence check for a *trained* hypercube kernel.

    Returns (adjacent_sim, baseline_sim): mean cosine similarity between
    kernel slices at spatially adjacent offsets under the hypercube
    decoding, vs the all-pairs baseline. A trained conv kernel is spatially
    smooth, so adjacent_sim >> baseline_sim confirms the [K, Cin, Cout]
    layout really is a hypercube enumeration (a scrambled or non-spatial
    layout scores ~baseline). Note the x-fastest and product orders differ
    only by an x<->z axis transpose, which adjacency statistics CANNOT
    distinguish — that choice rests on ME's coordinate_at decoding (module
    docstring) and is ultimately validated against reference activations.
    """
    n = kernel_size
    flat = kernel.reshape(kernel.shape[0], -1).astype(np.float64)
    norm = np.linalg.norm(flat, axis=1, keepdims=True)
    flat = flat / np.maximum(norm, 1e-12)
    sims = flat @ flat.T
    adj = []
    for x in range(n):
        for y in range(n):
            for z in range(n):
                i = x + y * n + z * n * n
                for dx, dy, dz in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
                    if x + dx < n and y + dy < n and z + dz < n:
                        j = (x + dx) + (y + dy) * n + (z + dz) * n * n
                        adj.append(sims[i, j])
    k = kernel.shape[0]
    off_diag = (sims.sum() - np.trace(sims)) / (k * (k - 1))
    return float(np.mean(adj)), float(off_diag)


def _bn(sd: Dict[str, np.ndarray], name: str):
    params = {"scale": sd[f"{name}.bn.weight"], "bias": sd[f"{name}.bn.bias"]}
    stats = {"mean": sd[f"{name}.bn.running_mean"],
             "var": sd[f"{name}.bn.running_var"]}
    return params, stats


def _conv(sd, name, ksize):
    return {"kernel": reorder_kernel(sd[f"{name}.kernel"], ksize)}


def _basic_block(sd: Dict[str, np.ndarray], prefix: str):
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}
    p["conv1"] = _conv(sd, f"{prefix}.conv1", 3)
    p["norm1"], s["norm1"] = _bn(sd, f"{prefix}.norm1")
    p["conv2"] = _conv(sd, f"{prefix}.conv2", 3)
    p["norm2"], s["norm2"] = _bn(sd, f"{prefix}.norm2")
    if f"{prefix}.downsample.0.kernel" in sd:
        k = sd[f"{prefix}.downsample.0.kernel"]
        p["downsample_conv"] = {"kernel": k.reshape(k.shape[-2], k.shape[-1])
                                if k.ndim == 3 else k}
        p["downsample_norm"], s["downsample_norm"] = _bn(sd, f"{prefix}.downsample.1")
    return p, s


def convert_minkunet(sd: Dict[str, np.ndarray], layers=(2,) * 8,
                     final_result: bool = True):
    """Returns (params, batch_stats) trees for sparse.minkunet.MinkUNet."""
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    params["conv0p1s1"] = _conv(sd, "conv0p1s1", 5)
    params["bn0"], stats["bn0"] = _bn(sd, "bn0")
    for i, (cname, bnname) in enumerate(
            [("conv1p1s2", "bn1"), ("conv2p2s2", "bn2"),
             ("conv3p4s2", "bn3"), ("conv4p8s2", "bn4")], start=1):
        params[cname] = _conv(sd, cname, 2)
        params[bnname], stats[bnname] = _bn(sd, bnname)
    up = [("convtr4p16s2", "bntr4"), ("convtr5p8s2", "bntr5"),
          ("convtr6p4s2", "bntr6"), ("convtr7p2s2", "bntr7")]
    n_up = 4 if final_result else 2
    for cname, bnname in up[:n_up]:
        params[cname] = _conv(sd, cname, 2)
        params[bnname], stats[bnname] = _bn(sd, bnname)

    n_blocks = 8 if final_result else 6
    for bi in range(1, n_blocks + 1):
        bp: Dict[str, Any] = {}
        bs: Dict[str, Any] = {}
        for li in range(layers[bi - 1]):
            bp[f"block{li}"], bs[f"block{li}"] = _basic_block(
                sd, f"block{bi}.{li}")
        params[f"block{bi}"] = bp
        stats[f"block{bi}"] = bs

    if final_result and "final.kernel" in sd:
        fk = sd["final.kernel"]
        fin = {"kernel": fk.reshape(fk.shape[-2], fk.shape[-1])
               if fk.ndim == 3 else fk}
        if "final.bias" in sd:
            fin["bias"] = sd["final.bias"]
        params["final"] = fin
    return params, stats


def random_reference_state_dict(sp, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """A MinkUNet18A state dict in the reference's format (``DisNet``'s
    MinkowskiEngine names: ``conv0p1s1.kernel`` [125, C_in, C_out],
    ``bn0.bn.weight`` / ``bias`` / ``running_mean`` / ``running_var``,
    ``block1.0.conv1.kernel``, ``block1.0.downsample.0.kernel`` [1, C_in,
    C_out], ``final.kernel``, ``final.bias``) at the widths of the sparse
    config ``sp``, drawn from ``rng``: kernels fan-in scaled, norms near the
    identity, so activations stay of order one through the UNet. For smoke
    runs and tests of ``convert_minkunet``; float32."""
    sd = {}

    def conv(name, k, cin, cout):
        sd[f"{name}.kernel"] = rng.randn(k, cin, cout) * np.sqrt(2.0 / (k * cin))

    def bn(name, c):
        sd[f"{name}.bn.weight"] = 1 + 0.1 * rng.randn(c)
        sd[f"{name}.bn.bias"] = 0.1 * rng.randn(c)
        sd[f"{name}.bn.running_mean"] = 0.1 * rng.randn(c)
        sd[f"{name}.bn.running_var"] = 0.5 + rng.rand(c)

    P, D, L = sp.planes, sp.init_dim, sp.layers
    conv("conv0p1s1", 125, sp.in_channels, D)
    bn("bn0", D)
    for i, (ch, s) in enumerate(zip((D, P[0], P[1], P[2]), (1, 2, 4, 8))):
        conv(f"conv{i + 1}p{s}s2", 8, ch, ch)
        bn(f"bn{i + 1}", ch)
    for j, s in enumerate((16, 8, 4, 2)):
        conv(f"convtr{j + 4}p{s}s2", 8, P[3 + j], P[4 + j])
        bn(f"bntr{j + 4}", P[4 + j])
    ins = (D, P[0], P[1], P[2], P[4] + P[2], P[5] + P[1], P[6] + P[0], P[7] + D)
    for i in range(8):
        for n in range(L[i]):
            cin = ins[i] if n == 0 else P[i]
            conv(f"block{i + 1}.{n}.conv1", 27, cin, P[i])
            bn(f"block{i + 1}.{n}.norm1", P[i])
            conv(f"block{i + 1}.{n}.conv2", 27, P[i], P[i])
            bn(f"block{i + 1}.{n}.norm2", P[i])
            if cin != P[i]:
                conv(f"block{i + 1}.{n}.downsample.0", 1, cin, P[i])
                bn(f"block{i + 1}.{n}.downsample.1", P[i])
    conv("final", 1, P[7], sp.out_channels)
    sd["final.bias"] = 0.1 * rng.randn(sp.out_channels)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}
