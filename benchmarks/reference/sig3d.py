"""Plain PyTorch reference of SIG3D: what the program's forward, loss and
optimizer step compute, written from the model's description with no kernel,
no cache and no batching trick.

- Voxel levels: the sorted unique cells of each stride (2, 4, 8, 16) inside
  the grid extent; a level that has more cells than its capacity keeps the
  first ``capacity - 1`` in (x, y, z) order and the last one (the program's
  documented overflow rule).
- Neighbour maps: a binary search of the sorted cell keys, one offset at a
  time (the program looks them up in dense grids with its map kernels).
- Sparse convs: a gather and a product per kernel offset.
- The MinkUNet18A encoder to stride 16, batch norms with running statistics.
- Situated token pooling: the stride-16 voxels' (x, y) columns, the mean
  feature of each, sampled by the same uniform draws and duplicates.
- MPNet (relative position bias shared by the layers), MCAN 2 + 2 SA / SGA,
  AttFlat, the situation and answer heads; the loss; clip by value; AdamW.

Dropout masks and token draws come from generators seeded as the program's
are and drawn in the same order and shapes. Float32 throughout, products in
``precision`` (``reference/precision.py``). Imports nothing of the program.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmarks.reference.precision import Exact

STRIDES = (1, 2, 4, 8, 16)
_BITS = 12                      # coordinates below 4096 cells per axis
_INT32_MAX = 2 ** 31 - 1
NEG_INF = -1e9


def kernel_offsets(k: int) -> torch.Tensor:
    """[K, 3] offsets, x slowest: odd kernels centred, even ones [0, k)."""
    rng = range(-(k // 2), k // 2 + 1) if k % 2 else range(k)
    return torch.tensor(list(itertools.product(rng, rng, rng)), dtype=torch.int64)


# ---------------------------------------------------------------------------
# names and shapes of every tensor the model holds
# ---------------------------------------------------------------------------

def _bn(p: str, c: int, spec: dict) -> None:
    for leaf in ("scale", "bias", "mean", "var"):
        spec[f"{p}.{leaf}"] = (c,)


def _dense(p: str, i: int, o: int, spec: dict, bias: bool = True) -> None:
    spec[f"{p}.weight"] = (o, i)
    if bias:
        spec[f"{p}.bias"] = (o,)


def _res_layer(p: str, cin: int, planes: int, blocks: int, spec: dict) -> None:
    for j in range(blocks):
        b = f"{p}.block{j}"
        c = cin if j == 0 else planes
        spec[f"{b}.conv1.kernel"] = (27, c, planes)
        _bn(f"{b}.norm1", planes, spec)
        spec[f"{b}.conv2.kernel"] = (27, planes, planes)
        _bn(f"{b}.norm2", planes, spec)
        if c != planes:
            spec[f"{b}.downsample_conv.kernel"] = (c, planes)
            _bn(f"{b}.downsample_norm", planes, spec)


def param_spec(s: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and buffer of SIG3D at the settings ``s`` (the
    configuration file's ``settings``), MinkUNet's two decoder stages
    included (they exist, unused on this path)."""
    spec: Dict[str, Tuple[int, ...]] = {}
    H, L = s["lang.hidden_size"], "lang_net.encoder"
    spec[f"{L}.word_embeddings.weight"] = (s["lang.vocab_size"], H)
    spec[f"{L}.position_embeddings.weight"] = (s["lang.max_position"], H)
    spec[f"{L}.emb_norm.weight"], spec[f"{L}.emb_norm.bias"] = (H,), (H,)
    spec[f"{L}.relative_attention_bias.weight"] = (s["lang.relative_attention_num_buckets"],
                                                   s["lang.num_heads"])
    for i in range(s["lang.num_layers"]):
        p = f"{L}.layer{i}"
        for n in "qkvo":
            _dense(f"{p}.attention.{n}", H, H, spec)
        for n in ("attention_norm", "output_norm"):
            spec[f"{p}.{n}.weight"], spec[f"{p}.{n}.bias"] = (H,), (H,)
        _dense(f"{p}.intermediate", H, s["lang.intermediate_size"], spec)
        _dense(f"{p}.output", s["lang.intermediate_size"], H, spec)
    # MinkUNet18A
    E, planes, layers = "scene_encoder", s["sparse.planes"], s["sparse.layers"]
    d = s["sparse.init_dim"]
    spec[f"{E}.conv0p1s1.kernel"] = (125, s["sparse.in_channels"], d)
    _bn(f"{E}.bn0", d, spec)
    ch = d
    for i in range(1, 5):
        spec[f"{E}.conv{i}p{STRIDES[i - 1]}s2.kernel"] = (8, ch, ch)
        _bn(f"{E}.bn{i}", ch, spec)
        _res_layer(f"{E}.block{i}", ch, planes[i - 1], layers[i - 1], spec)
        ch = planes[i - 1]
    skips = {"out_b3p8": planes[2], "out_b2p4": planes[1]}
    for conv, bn, layer, p, skip in (("convtr4p16s2", "bntr4", "block5", 4, "out_b3p8"),
                                     ("convtr5p8s2", "bntr5", "block6", 5, "out_b2p4")):
        spec[f"{E}.{conv}.kernel"] = (8, ch, planes[p])
        _bn(f"{E}.{bn}", planes[p], spec)
        _res_layer(f"{E}.{layer}", planes[p] + skips[skip], planes[p], layers[p], spec)
        ch = planes[p]
    # fusion and heads
    Hm, C = s["model.hidden_size"], s["model.scene_feat_dim"]
    _dense("pos_embed_fc1", 2, 128, spec)
    _dense("pos_embed_fc2", 128, C, spec)
    _dense("lang_feat_linear", H, Hm, spec)
    _dense("scene_feat_linear", C, Hm, spec)

    def mhatt(p):
        for n in ("linear_v", "linear_k", "linear_q", "linear_merge"):
            _dense(f"{p}.{n}", Hm, Hm, spec)

    def norm(p):
        spec[f"{p}.scale"], spec[f"{p}.bias"] = (Hm,), (Hm,)

    def ffn(p):
        _dense(f"{p}.mlp.fc", Hm, 4 * Hm, spec)
        _dense(f"{p}.mlp.linear", 4 * Hm, Hm, spec)

    for i in range(s["model.mcan_num_layers"]):
        for p in (f"enc_s{i}", f"enc_q{i}"):
            mhatt(f"{p}.mhatt"), norm(f"{p}.norm1"), ffn(f"{p}.ffn"), norm(f"{p}.norm2")
        for p in (f"dec_s{i}", f"dec_q{i}"):
            mhatt(f"{p}.mhatt1"), norm(f"{p}.norm1"), mhatt(f"{p}.mhatt2")
            norm(f"{p}.norm2"), ffn(f"{p}.ffn"), norm(f"{p}.norm3")
    _dense("position_head_fc1", Hm, 256, spec)
    _dense("position_head_fc2", 256, 1, spec)
    _dense("rotation_head_fc1", Hm, 256, spec)
    _dense("rotation_head_fc2", 256, 6, spec)
    Fo = s["model.mcan_flat_out_size"]
    for p in ("attflat_s", "attflat_q", "attflat_visual"):
        _dense(f"{p}.mlp.fc", Hm, s["model.mcan_flat_mlp_size"], spec)
        _dense(f"{p}.mlp.linear", s["model.mcan_flat_mlp_size"],
               s["model.mcan_flat_glimpses"], spec)
        _dense(f"{p}.linear_merge", Hm * s["model.mcan_flat_glimpses"], Fo, spec)
    _dense("aux_reg_fc1", 2 * Fo, Hm, spec)
    _dense("aux_reg_fc2", Hm, 7, spec)
    _dense("answer_cls_fc1", 3 * Fo, Hm, spec)
    _dense("answer_cls_fc2", Hm, s["data.num_answers"], spec)
    return spec


def trainable(name: str, s: dict) -> bool:
    """The recipe: the scene encoder frozen, MPNet frozen but its last
    layer, everything else trained."""
    parts = name.split(".")
    if parts[0] == "scene_encoder" or name.rsplit(".", 1)[-1] in ("mean", "var"):
        return False
    if parts[0] == "lang_net":
        return f"layer{s['lang.num_layers'] - 1}" in parts
    return True


# ---------------------------------------------------------------------------
# voxel levels and neighbour maps
# ---------------------------------------------------------------------------

def _inside(c: torch.Tensor, dims) -> torch.Tensor:
    return ((c >= 0) & (c < torch.tensor(dims, device=c.device))).all(-1)


def _keys(b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    c = c.to(torch.int64)
    return (((b.to(torch.int64) << _BITS | c[..., 0]) << _BITS | c[..., 1]) << _BITS) | c[..., 2]


def coarser_level(coords, mask, stride: int, cap: int, extent) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxels of stride ``stride`` (coords in stride-1 units, ascending cell
    order, ``cap`` slots) covering the valid voxels of ``coords``."""
    B, dev = coords.shape[0], coords.device
    dims = [e // stride for e in extent]
    cells = torch.div(coords.to(torch.int64), stride, rounding_mode="floor")
    ok = mask & _inside(cells, dims)
    b = torch.arange(B, device=dev)[:, None].expand_as(mask)
    u = torch.unique(_keys(b[ok], cells[ok]))                    # sorted
    ub = u >> (3 * _BITS)
    counts = torch.bincount(ub, minlength=B)
    rank = torch.arange(len(u), device=dev) - (torch.cumsum(counts, 0) - counts)[ub]
    n = counts[ub]
    keep = (rank < cap - 1) | ((n <= cap) & (rank < cap)) | (rank == n - 1)
    slot = torch.clamp(rank, max=cap - 1)
    m = (1 << _BITS) - 1
    xyz = torch.stack([(u >> (2 * _BITS)) & m, (u >> _BITS) & m, u & m], -1) * stride
    out = torch.zeros(B, cap, 3, dtype=torch.int64, device=dev)
    out[ub[keep], slot[keep]] = xyz[keep]
    out_mask = torch.arange(cap, device=dev)[None] < counts.clamp(max=cap)[:, None]
    return out, out_mask


def neighbour_map(in_coords, in_mask, in_stride: int, out_coords, out_mask,
                  offsets: torch.Tensor, off_stride: int, extent) -> torch.Tensor:
    """int64 [B, V_out, K]: the row of ``in_coords`` at ``out + offset *
    off_stride`` (in cells of ``in_stride``), -1 where there is none."""
    B, v_in = in_mask.shape
    dev = in_coords.device
    dims = [e // in_stride for e in extent]
    cin = torch.div(in_coords.to(torch.int64), in_stride, rounding_mode="floor")
    b = torch.arange(B, device=dev)[:, None]
    keys = torch.where(in_mask & _inside(cin, dims), _keys(b, cin.clamp(min=0)),
                       torch.iinfo(torch.int64).max).reshape(-1)
    sk, order = torch.sort(keys)
    K = offsets.shape[0]
    out = torch.empty(B, out_coords.shape[1], K, dtype=torch.int64, device=dev)
    for k in range(K):
        q = out_coords.to(torch.int64) + offsets[k].to(dev) * off_stride
        qc = torch.div(q, in_stride, rounding_mode="floor")
        ok = ((q % in_stride) == 0).all(-1) & _inside(qc, dims) & out_mask
        qk = _keys(b, qc.clamp(min=0, max=(1 << _BITS) - 1))
        pos = torch.searchsorted(sk, qk.reshape(-1)).clamp(max=len(sk) - 1)
        hit = (sk[pos] == qk.reshape(-1)).view(qk.shape) & ok
        out[:, :, k] = torch.where(hit, (order[pos] % v_in).view(qk.shape), -1)
    return out


def build_plan(coords, mask, capacities, extent) -> List[dict]:
    """Levels of strides 1..16 with their maps: ``k5`` and ``k3`` at level 0,
    ``k3`` and ``down`` (k2 from the finer level) above."""
    coords = coords.to(torch.int64)
    levels = [{"coords": coords, "mask": mask}]
    for i in range(1, len(STRIDES)):
        c, m = coarser_level(levels[-1]["coords"], levels[-1]["mask"], STRIDES[i],
                             capacities[i], extent)
        levels.append({"coords": c, "mask": m})
    k2, k3, k5 = kernel_offsets(2), kernel_offsets(3), kernel_offsets(5)
    for i, lv in enumerate(levels):
        s = STRIDES[i]
        if i == 0:
            lv["k5"] = neighbour_map(lv["coords"], lv["mask"], 1, lv["coords"], lv["mask"],
                                     k5, 1, extent)
        lv["k3"] = neighbour_map(lv["coords"], lv["mask"], s, lv["coords"], lv["mask"],
                                 k3, s, extent)
        if i > 0:
            fine = levels[i - 1]
            lv["down"] = neighbour_map(fine["coords"], fine["mask"], STRIDES[i - 1],
                                       lv["coords"], lv["mask"], k2, STRIDES[i - 1], extent)
    return levels


def map_hits(levels: List[dict]) -> Dict[str, int]:
    """Entries of each map that find a voxel (the conv's work)."""
    out = {}
    for i, lv in enumerate(levels):
        for key in ("k5", "k3", "down"):
            if key in lv:
                out[f"{key}@{i}"] = int((lv[key] >= 0).sum())
    return out


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Sig3dReference:
    """SIG3D over a dict of float32 tensors ``w`` (``param_spec`` names) at
    the settings ``s``. ``forward(batch, sample_gen, dropout_gen, train)``
    follows the program's draw order: token draws from ``sample_gen``,
    dropout masks from ``dropout_gen`` (training only)."""

    def __init__(self, s: dict, w: Dict[str, torch.Tensor], precision: Exact = None):
        self.s, self.w = s, w
        self.p = precision or Exact()
        self.hits: Dict[str, int] = {}

    # -- small pieces --------------------------------------------------------
    def dense(self, name, x):
        return self.p.linear(x, self.w[f"{name}.weight"], self.w.get(f"{name}.bias"))

    def drop(self, x, pdrop, train, gen):
        if not train or pdrop <= 0.0:
            return x
        keep = torch.rand(x.shape, generator=gen, device=gen.device) >= pdrop
        return x * keep.to(x.device) * (1.0 / (1.0 - pdrop))

    def layer_norm(self, name, x, eps):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"], self.w[f"{name}.bias"], eps)

    def mcan_norm(self, name, x, eps=1e-6):
        mean = x.mean(-1, keepdim=True)
        std = ((x - mean).square().sum(-1, keepdim=True) / (x.shape[-1] - 1)).sqrt()
        return self.w[f"{name}.scale"] * (x - mean) / (std + eps) + self.w[f"{name}.bias"]

    # -- sparse encoder ------------------------------------------------------
    def conv(self, feats, nbr, kernel, out_mask):
        B, v_in, c_in = feats.shape
        padded = torch.cat([feats, feats.new_zeros(B, 1, c_in)], 1)
        out = None
        for k in range(nbr.shape[2]):
            idx = torch.where(nbr[:, :, k] < 0, v_in, nbr[:, :, k])
            g = torch.gather(padded, 1, idx[..., None].expand(-1, -1, c_in))
            y = self.p.matmul(g, kernel[k])
            out = y if out is None else out + y
        return out * out_mask[..., None]

    def bn(self, name, x, mask):
        w = self.w
        y = (x - w[f"{name}.mean"]) * torch.rsqrt(w[f"{name}.var"] + 1e-5) \
            * w[f"{name}.scale"] + w[f"{name}.bias"]
        return y * mask[..., None]

    def basic_block(self, p, x, nbr, mask):
        w = self.w
        out = torch.relu(self.bn(f"{p}.norm1", self.conv(x, nbr, w[f"{p}.conv1.kernel"], mask), mask))
        out = self.bn(f"{p}.norm2", self.conv(out, nbr, w[f"{p}.conv2.kernel"], mask), mask)
        res = x
        if f"{p}.downsample_conv.kernel" in w:
            res = self.p.matmul(x, w[f"{p}.downsample_conv.kernel"]) * mask[..., None]
            res = self.bn(f"{p}.downsample_norm", res, mask)
        return torch.relu(out + res)

    def encoder(self, levels, feats):
        """``feat_bottleneck`` [B, V4, C] at stride 16."""
        E, s = "scene_encoder", self.s
        L0 = levels[0]
        h = self.conv(feats * L0["mask"][..., None], L0["k5"], self.w[f"{E}.conv0p1s1.kernel"],
                      L0["mask"])
        h = torch.relu(self.bn(f"{E}.bn0", h, L0["mask"]))
        for i in range(1, 5):
            lv = levels[i]
            h = self.conv(h, lv["down"], self.w[f"{E}.conv{i}p{STRIDES[i - 1]}s2.kernel"],
                          lv["mask"])
            h = torch.relu(self.bn(f"{E}.bn{i}", h, lv["mask"]))
            for j in range(s["sparse.layers"][i - 1]):
                h = self.basic_block(f"{E}.block{i}.block{j}", h, lv["k3"], lv["mask"])
        return h

    # -- token pool ----------------------------------------------------------
    def pool(self, coords, feats, mask, sort_uniform, dup):
        s = self.s
        B, V, C = feats.shape
        N, stride = s["model.num_scene_tokens"], STRIDES[-1]
        out_f, out_p = [], []
        for b in range(B):
            cells = torch.div(coords[b][mask[b]].to(torch.int64), stride, rounding_mode="floor")
            key = cells[:, 0] << _BITS | cells[:, 1]
            uk, inv = torch.unique(key, return_inverse=True)        # ascending (x, y)
            nu = len(uk)
            sums = torch.zeros(nu, C, device=feats.device).index_add(0, inv, feats[b][mask[b]])
            mean = sums / torch.bincount(inv, minlength=nu)[:, None].to(feats.dtype)
            order = torch.argsort(sort_uniform[b, :nu], stable=True)
            slot = torch.arange(N, device=feats.device)
            pick = torch.where(slot < nu, slot % V, dup[b].to(torch.int64) % nu)
            tok = order[pick]
            xy = torch.stack([uk[tok] >> _BITS, uk[tok] & ((1 << _BITS) - 1)], -1)
            out_f.append(mean[tok])
            out_p.append(((xy * stride).float() + stride / 2.0) * s["data.voxel_size"])
        return torch.stack(out_f), torch.stack(out_p)

    # -- language ------------------------------------------------------------
    def mpnet(self, ids, am):
        s, w, L = self.s, self.w, "lang_net.encoder"
        B, T = ids.shape
        H, h = s["lang.hidden_size"], s["lang.num_heads"]
        d, eps = H // h, s["lang.layer_norm_eps"]
        am = am.to(torch.int64)
        pos = torch.cumsum(am, 1) * am + s["lang.pad_token_id"]
        x = w[f"{L}.word_embeddings.weight"][ids.long()] + w[f"{L}.position_embeddings.weight"][pos]
        x = self.layer_norm(f"{L}.emb_norm", x, eps)
        rp = torch.arange(T, device=ids.device)[None] - torch.arange(T, device=ids.device)[:, None]
        bias = w[f"{L}.relative_attention_bias.weight"][
            t5_bucket(rp, True, s["lang.relative_attention_num_buckets"], 128)].permute(2, 0, 1)[None]
        pad = (am == 0)[:, None, None, :]
        for i in range(s["lang.num_layers"]):
            p = f"{L}.layer{i}"

            def heads(t):
                return t.view(B, T, h, d).transpose(1, 2)
            q, k, v = (heads(self.dense(f"{p}.attention.{n}", x)) for n in "qkv")
            sc = self.p.matmul(q, k.transpose(-1, -2)) / math.sqrt(d) + bias
            att = torch.softmax(sc.masked_fill(pad, NEG_INF), -1)
            a = self.dense(f"{p}.attention.o", self.p.matmul(att, v).transpose(1, 2).reshape(B, T, H))
            x = self.layer_norm(f"{p}.attention_norm", x + a, eps)
            y = self.dense(f"{p}.output", F.gelu(self.dense(f"{p}.intermediate", x)))
            x = self.layer_norm(f"{p}.output_norm", x + y, eps)
        return x

    # -- fusion --------------------------------------------------------------
    def mhatt(self, p, v, k, q, pad, train, gen):
        s = self.s
        B, Hm, h = q.shape[0], s["model.hidden_size"], s["model.mcan_num_heads"]
        d = Hm // h

        def heads(t):
            return t.view(B, -1, h, d).transpose(1, 2)
        vh, kh, qh = (heads(self.dense(f"{p}.linear_{n}", t)) for n, t in (("v", v), ("k", k), ("q", q)))
        sc = self.p.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(d)
        if pad is not None:
            sc = sc.masked_fill(pad[:, None, None, :], NEG_INF)
        att = self.drop(torch.softmax(sc, -1), s["model.mcan_dropout"], train, gen)
        return self.dense(f"{p}.linear_merge", self.p.matmul(att, vh).transpose(1, 2).reshape(B, -1, Hm))

    def mlp(self, p, x, train, gen):
        return self.dense(f"{p}.linear", self.drop(F.gelu(self.dense(f"{p}.fc", x)),
                                                   self.s["model.mcan_dropout"], train, gen))

    def sa(self, p, x, pad, train, gen):
        pd = self.s["model.mcan_dropout"]
        x = self.mcan_norm(f"{p}.norm1", x + self.drop(self.mhatt(f"{p}.mhatt", x, x, x, pad, train, gen),
                                                       pd, train, gen))
        return self.mcan_norm(f"{p}.norm2", x + self.drop(self.mlp(f"{p}.ffn.mlp", x, train, gen),
                                                          pd, train, gen))

    def sga(self, p, x, y, y_pad, train, gen):
        pd = self.s["model.mcan_dropout"]
        x = self.mcan_norm(f"{p}.norm1", x + self.drop(self.mhatt(f"{p}.mhatt1", x, x, x, None, train, gen),
                                                       pd, train, gen))
        x = self.mcan_norm(f"{p}.norm2", x + self.drop(self.mhatt(f"{p}.mhatt2", y, y, x, y_pad, train, gen),
                                                       pd, train, gen))
        return self.mcan_norm(f"{p}.norm3", x + self.drop(self.mlp(f"{p}.ffn.mlp", x, train, gen),
                                                          pd, train, gen))

    def attflat(self, p, x, pad, train, gen):
        att = self.mlp(f"{p}.mlp", x, train, gen)
        if pad is not None:
            att = att.masked_fill(pad[..., None], NEG_INF)
        att = torch.softmax(att, 1)
        flat = self.p.matmul(att.transpose(1, 2), x).reshape(x.shape[0], -1)
        return self.dense(f"{p}.linear_merge", flat)

    def head(self, name, x, pdrop, train, gen):
        return self.dense(f"{name}_fc2", self.drop(F.gelu(self.dense(f"{name}_fc1", x)), pdrop, train, gen))

    # -- whole model ---------------------------------------------------------
    def scene_tokens(self, batch, sample_draws=None, sample_gen=None):
        """(plan levels, feat_bottleneck, tokens [B, N, C], positions [B, N, 2])."""
        s = self.s
        coords, mask = batch["voxel_coords"], batch["voxel_mask"].bool()
        levels = build_plan(coords, mask, s["sparse.capacities"], s["sparse.grid_extent"])
        self.hits = map_hits(levels)
        with torch.no_grad():
            bott = self.encoder(levels, batch["voxel_feats"].float())
        top = levels[-1]
        B, V4 = top["mask"].shape
        if sample_draws is None:
            u = torch.rand((B, V4), generator=sample_gen, device=sample_gen.device)
            dup = torch.randint(0, _INT32_MAX, (B, s["model.num_scene_tokens"]),
                                generator=sample_gen, device=sample_gen.device, dtype=torch.int32)
            sample_draws = (u.to(coords.device), dup.to(coords.device))
        tok, pos = self.pool(top["coords"], bott, top["mask"], *sample_draws)
        return levels, bott, tok, pos

    def forward(self, batch, sample_draws=None, sample_gen=None, dropout_gen=None,
                train=False, tokens=None, keep_plan=False) -> Dict[str, torch.Tensor]:
        """``tokens=(tokens, positions)`` skips the scene tower (served
        scenes); ``keep_plan`` returns the plan's levels under ``plan``."""
        s = self.s
        out = {}
        ids = torch.cat([batch["s_ids"], batch["q_ids"]])
        am = torch.cat([batch["s_mask"], batch["q_mask"]])
        lang = self.mpnet(ids, am)
        B = batch["s_ids"].shape[0]
        s_out, q_out = lang[:B], lang[B:]
        s_pad, q_pad = batch["s_mask"] == 0, batch["q_mask"] == 0
        if tokens is None:
            levels, out["feat_bottleneck"], tok, pos = self.scene_tokens(batch, sample_draws,
                                                                         sample_gen)
            if keep_plan:
                out["plan"] = levels
        else:
            tok, pos = tokens
        out["scene_tokens"], out["scene_positions"] = tok, pos
        pe = self.dense("pos_embed_fc2", F.gelu(self.dense("pos_embed_fc1", pos)))
        scene = F.gelu(self.dense("scene_feat_linear", tok + pe))
        sf = F.gelu(self.dense("lang_feat_linear", s_out))
        qf = F.gelu(self.dense("lang_feat_linear", q_out))
        n = s["model.mcan_num_layers"]
        for i in range(n):
            sf = self.sa(f"enc_s{i}", sf, s_pad, train, dropout_gen)
        for i in range(n):
            qf = self.sa(f"enc_q{i}", qf, q_pad, train, dropout_gen)
        for i in range(n):
            scene = self.sga(f"dec_s{i}", scene, sf, s_pad, train, dropout_gen)
        for i in range(n):
            scene = self.sga(f"dec_q{i}", scene, qf, q_pad, train, dropout_gen)
        # the per-token situation heads: no loss reads them, their dropout
        # draws come before the flatten's
        self.head("position_head", scene, 0.1, train, dropout_gen)
        self.head("rotation_head", scene, 0.1, train, dropout_gen)
        s_flat = self.attflat("attflat_s", sf, s_pad, train, dropout_gen)
        q_flat = self.attflat("attflat_q", qf, q_pad, train, dropout_gen)
        v_flat = self.attflat("attflat_visual", scene, None, train, dropout_gen)
        out["aux_scores"] = self.head("aux_reg", torch.cat([s_flat, v_flat], 1), 0.1, train, dropout_gen)
        out["answer_scores"] = self.head("answer_cls", torch.cat([s_flat, q_flat, v_flat], 1),
                                         s["model.answer_pdrop"], train, dropout_gen)
        return out


def t5_bucket(rp: torch.Tensor, bidirectional: bool, num_buckets: int, max_distance: int):
    """T5's log-bucketed relative position (MPNet and T5 share it)."""
    ret = torch.zeros_like(rp)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rp > 0).to(rp.dtype) * num_buckets
        n = rp.abs()
    else:
        n = (-rp).clamp(min=0)
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float() / max_exact + 1e-6)
                         / math.log(max_distance / max_exact) * (num_buckets - max_exact)).to(rp.dtype)
    return ret + torch.where(n < max_exact, n, large.clamp(max=num_buckets - 1))


def loss(out, batch, s: dict) -> torch.Tensor:
    """Answer BCE summed over classes / batch, the L2 situation loss on
    position and quaternion, times the amplifier."""
    a = out["answer_scores"]
    ans = F.binary_cross_entropy_with_logits(a, batch["answer_cat_scores"].float(),
                                             reduction="sum") / a.shape[0]
    gt, aux = batch["auxiliary_task"].float(), out["aux_scores"]
    sit = (s["loss.pos_weight"] * (aux[:, :3] - gt[:, :3]).square().mean()
           + s["loss.rot_weight"] * (aux[:, 3:] - gt[:, 3:]).square().mean())
    return (s["loss.answer_weight"] * ans + s["loss.aux_situation_weight"] * sit) * s["loss.amplifier"]


class AdamW:
    """Clip by value, then AdamW (decoupled decay on matrices), as
    ``torch.optim.AdamW`` writes it."""

    def __init__(self, params: Dict[str, torch.Tensor], s: dict):
        self.params, self.s, self.t = params, s, 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Returns the clipped gradients it used."""
        s = self.s
        lr, wd, clip = s["train.lr"], s["train.weight_decay"], s["train.grad_clip_value"]
        b1, b2, eps = 0.9, 0.999, 1e-8
        self.t += 1
        used = {}
        for n, p in self.params.items():
            g = grads.get(n)
            g = torch.zeros_like(p) if g is None else g.clamp(-clip, clip)
            used[n] = g
            if p.dim() >= 2 and n.rsplit(".", 1)[-1] not in ("bias", "scale"):
                p.mul_(1 - lr * wd)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[n].sqrt() / math.sqrt(1 - b2 ** self.t)).add_(eps)
            p.addcdiv_(self.m[n], denom, value=-lr / (1 - b1 ** self.t))
        return used
