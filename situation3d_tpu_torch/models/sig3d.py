"""SIG3D — situated 3D question answering model (port of
``situation3d_tpu/models/sig3d.py``):
language encoder -> sparse 3D encoder (MinkUNet18A bottleneck) -> situated
token pooling -> MCAN SA/SGA fusion -> situation heads + AttFlat -> answer
classifier. Under ``sparse.final_result`` the whole UNet runs and its 768-d
per-voxel head comes out as ``openscene_out`` (segmentation eval).

Submodule names follow the reference's parameter tree (``lang_net``,
``scene_encoder``, ``enc_s0``, ``dec_q1``, ``answer_cls_fc1``, ...), so
``ckpt_compat/from_jax.py`` carries weights across mechanically.
``forward(..., train=True)`` turns on dropout (MCAN, AttFlat, the heads, the
LSTM encoder's embeddings; the reference's MPNet drops nowhere); the scene
encoder's batch norms use running statistics in training too, as in the
reference, and while none of the encoder's parameters requires a gradient
the scene tower runs under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from situation3d_tpu_torch.config import Config
from situation3d_tpu_torch.device import resolve_device, tree_to_device
from situation3d_tpu_torch.models.lang import LangModule
from situation3d_tpu_torch.models.layers import (Dense, dropout,  # noqa: F401
                                                  init_random_weights)
from situation3d_tpu_torch.models.mcan import SA, SGA, AttFlat
from situation3d_tpu_torch.ops.cuda.gather_rows import (GatherRows,
                                                        ScatterAddRows,
                                                        scatter_add_rows,
                                                        segment_plan)
from situation3d_tpu_torch.ops.voxelize import voxelize_torch
from situation3d_tpu_torch.parallel.mesh import draw
from situation3d_tpu_torch.sparse.minkunet import MinkUNet, build_unet_plan
from situation3d_tpu_torch.sparse.tensor import SparseVoxels

ROT_DIMS = {"__quat__": 4, "__angle__": 2, "__6d__": 6}
_INT32_MAX = 2 ** 31 - 1


def rotation_dim(tag: str) -> int:
    for k, v in ROT_DIMS.items():
        if k in tag:
            return v
    raise ValueError(f"situation_loss_tag {tag!r} has no rotation representation")


def make_sample_draws(batch_size: int, num_voxels: int, num_tokens: int,
                      generator: Optional[torch.Generator] = None,
                      device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The random numbers :func:`situated_token_pool` consumes:
    ``sort_uniform`` float32 [B, V] in [0, 1) and ``dup`` int32 [B, N] in
    [0, 2^31 - 1). Drawn where the generator lives (the CPU without one) and
    moved to ``device``; a ``ShardedGenerator`` gives the rank's rows of the
    global batch's draws."""
    gdev = generator.device if generator is not None else "cpu"
    u = draw(torch.rand, (batch_size, num_voxels), generator=generator, device=gdev)
    dup = draw(torch.randint, (batch_size, num_tokens), 0, _INT32_MAX,
               generator=generator, device=gdev, dtype=torch.int32)
    return u.to(device), dup.to(device)


def situated_token_pool(coords: torch.Tensor, feats: torch.Tensor,
                        mask: torch.Tensor, stride: int, num_tokens: int,
                        voxel_size: float, sort_uniform: torch.Tensor,
                        dup: torch.Tensor):
    """Collapse z, segment-mean features per unique (x, y), sample N tokens.

    Batched. Args: coords int32 [B, V, 3] raw units, feats [B, V, C], mask
    [B, V]; ``sort_uniform`` float32 [B, V] orders the unique columns (a
    random sample without replacement) and ``dup`` int32 [B, N] picks the
    random duplicates that pad a scene with fewer than N columns.
    Returns (tok_feats [B, N, C], positions float32 [B, N, 2] in meters).

    The segment sums and the token gather go through
    ``ops/cuda/gather_rows.py`` (deterministic on the card, and each the
    other's backward, so the gradient reaches ``feats``).
    """
    B, V, C = feats.shape
    xy3 = torch.div(coords, stride, rounding_mode="floor").clone()
    xy3[..., 2] = 0                                  # collapse z before dedup
    uc, um, inv, nu = voxelize_torch(xy3, mask, capacity=V)
    mf = mask.to(torch.float32)
    # padding voxels carry weight 0: drop them (index -1) instead of summing
    # their zeros into slot 0, which would make one long segment
    inv = torch.where(mask, inv, -1)
    segments = segment_plan(inv, V)
    sums = ScatterAddRows.apply(feats.float() * mf[..., None], inv, V, segments)
    counts = scatter_add_rows(mf[..., None], inv, V, segments)
    mean = sums / counts.clamp(min=1.0)

    sort_key = torch.where(um, sort_uniform, 2.0)
    perm = torch.argsort(sort_key, dim=1, stable=True)
    safe_nu = nu.clamp(min=1).to(torch.int64)[:, None]
    slot = torch.arange(num_tokens, device=feats.device)[None]
    pick = torch.where(slot < safe_nu, slot % V, dup.to(torch.int64) % safe_nu)
    token_idx = torch.gather(perm, 1, pick)                     # [B, N]
    tok_feats = GatherRows.apply(mean, token_idx.to(torch.int32))
    tok_xy = torch.gather(uc[..., :2], 1, token_idx[..., None].expand(B, num_tokens, 2))
    positions = ((tok_xy * stride).float() + stride / 2.0) * voxel_size
    return tok_feats.to(feats.dtype), positions


class SIG3D(nn.Module):
    """SIG3D. ``forward`` takes a fixed-shape batch dict:

      s_ids, s_mask, q_ids, q_mask: int [B, L] tokenized situation/question
      voxel_coords int32 [B, V, 3], voxel_feats [B, V, 3], voxel_mask [B, V]
        (or ``scene_tokens`` [B, N, C] + ``scene_token_positions`` [B, N, 2]
        from an earlier :meth:`encode_scene`)
      auxiliary_task float32 [B, 3+rot]: GT situation vector
      plan (optional): a UNet plan built on the host
        (``sparse/host_plan.py``); without one the plan is built on the device

    Values may be numpy arrays or tensors; they are moved to the model's
    device. Parameters are float32; ``dtype`` is the compute dtype.
    ``device`` defaults to ``"cuda"`` and raises when no card is there.
    """

    def __init__(self, cfg: Config, num_answers: int,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.num_answers, self.dtype = cfg, num_answers, dtype
        mc = cfg.model
        H = mc.hidden_size
        rot = rotation_dim(mc.situation_loss_tag)
        self.lang_net = LangModule(cfg.lang, dtype, model=mc.lang_model)
        if not mc.no_3d:
            self.scene_encoder = MinkUNet(cfg.sparse, dtype)
        self.pos_embed_fc1 = Dense(2, 128, dtype)
        self.pos_embed_fc2 = Dense(128, mc.scene_feat_dim, dtype)
        self.lang_feat_linear = Dense(cfg.lang.hidden_size, H, dtype)
        self.scene_feat_linear = Dense(mc.scene_feat_dim, H, dtype)
        pd = mc.mcan_dropout
        for i in range(mc.mcan_num_layers):
            self.add_module(f"enc_s{i}", SA(H, mc.mcan_num_heads, dtype, pd))
            self.add_module(f"enc_q{i}", SA(H, mc.mcan_num_heads, dtype, pd))
            self.add_module(f"dec_s{i}", SGA(H, mc.mcan_num_heads, dtype, pd))
            self.add_module(f"dec_q{i}", SGA(H, mc.mcan_num_heads, dtype, pd))
        if mc.predict_situation:
            self.position_head_fc1 = Dense(H, 256, dtype)
            self.position_head_fc2 = Dense(256, 1, dtype)
            self.rotation_head_fc1 = Dense(H, 256, dtype)
            self.rotation_head_fc2 = Dense(256, 6, dtype)
        flat = dict(flat_mlp_size=mc.mcan_flat_mlp_size,
                    flat_glimpses=mc.mcan_flat_glimpses,
                    flat_out_size=mc.mcan_flat_out_size, dtype=dtype)
        self.attflat_s = AttFlat(H, **flat)
        self.attflat_q = AttFlat(H, **flat)
        self.attflat_visual = AttFlat(H, **flat)
        F_out = mc.mcan_flat_out_size
        if mc.use_situation:
            if "__class__" in mc.situation_loss_tag:
                self.aux_cls_fc1 = Dense(H, H, dtype)
                self.aux_cls_fc2 = Dense(H, 1 + rot, dtype)
            else:
                self.aux_reg_fc1 = Dense(2 * F_out, H, dtype)
                self.aux_reg_fc2 = Dense(H, 3 + rot, dtype)
        n_flat = 2 if mc.no_3d else 3
        self.answer_cls_fc1 = Dense(n_flat * F_out, H, dtype)
        self.answer_cls_fc2 = Dense(H, num_answers, dtype)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.answer_cls_fc2.weight.device

    def train(self, mode: bool = True):
        """The scene encoder stays in evaluation form whatever the mode."""
        super().train(mode)
        if hasattr(self, "scene_encoder"):
            self.scene_encoder.eval()
        return self

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The batch's values as tensors on the model's device; a ``plan``
        keeps its structure."""
        return tree_to_device(batch, self.device)

    # ---- vision branch ---------------------------------------------------
    def _run_scene_encoder(self, b: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict]:
        """MinkUNet on the batch's voxels, on ``b["plan"]`` when the batch
        carries one (``sparse/host_plan.py``), else on a plan built here on
        the device. The whole UNet under ``sparse.final_result``, else its
        encoder alone. Returns (the UNet's outputs, the plan's overflow
        counters)."""
        cfg = self.cfg
        x = SparseVoxels(coords=b["voxel_coords"].to(torch.int32),
                         feats=b["voxel_feats"].to(self.dtype),
                         mask=b["voxel_mask"].to(torch.bool), stride=1)
        plan = b.get("plan")
        if plan is None:
            with torch.no_grad():                     # integer bookkeeping
                plan = build_unet_plan(x.coords, x.mask, cfg.sparse.capacities,
                                       cfg.sparse.grid_extent,
                                       pallas_map=cfg.sparse.pallas_map,
                                       pallas_map_bits=cfg.sparse.pallas_map_bits,
                                       device=self.device,
                                       dense_lookup=cfg.sparse.dense_lookup,
                                       dense_downsample=cfg.sparse.dense_downsample)
        frozen = not any(p.requires_grad for p in self.scene_encoder.parameters())
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            enc = self.scene_encoder(x, plan,
                                     bottleneck_only=not cfg.sparse.final_result)
        return enc, plan.get("overflow", {})

    def _pool_tokens(self, bott: SparseVoxels, sample_draws, generator):
        N = self.cfg.model.num_scene_tokens
        if sample_draws is None:
            sample_draws = make_sample_draws(bott.batch_size, bott.capacity, N,
                                             generator, self.device)
        sort_uniform, dup = (torch.as_tensor(t).to(self.device) for t in sample_draws)
        return situated_token_pool(bott.coords, bott.feats, bott.mask, bott.stride,
                                   N, self.cfg.data.voxel_size, sort_uniform, dup)

    def encode_scene(self, batch: Dict[str, Any], sample_draws=None,
                     generator: Optional[torch.Generator] = None):
        """The scene tower alone: plan (the batch's, or built on the device)
        + MinkUNet + situated pooling. Returns (scene_tokens [B, N, C],
        positions [B, N, 2], overflow dict). ``sample_draws = (sort_uniform
        [B, V4], dup [B, N])`` fixes the token sampling; otherwise it is drawn
        from ``generator``."""
        enc, overflow = self._run_scene_encoder(self._to_device(batch))
        tok_feats, positions = self._pool_tokens(enc["feat_bottleneck"],
                                                 sample_draws, generator)
        return tok_feats, positions, overflow

    def forward(self, batch: Dict[str, Any], sample_draws=None,
                generator: Optional[torch.Generator] = None, train: bool = False,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """``train`` turns dropout on; its masks come from
        ``dropout_generator`` (``generator`` when that is not given), the
        token sampling from ``sample_draws`` or ``generator``."""
        cfg = self.cfg
        dgen = dropout_generator if dropout_generator is not None else generator

        def head(x, name, pdrop=0.1):
            x = F.gelu(getattr(self, f"{name}_fc1")(x))
            return getattr(self, f"{name}_fc2")(dropout(x, pdrop, train, dgen))

        mc = cfg.model
        tag = mc.situation_loss_tag
        out: Dict[str, Any] = {}
        b = self._to_device(batch)

        # ---- language branch --------------------------------------------
        s_out, q_out, s_pad, q_pad = self.lang_net(
            b["s_ids"], b["s_mask"], b["q_ids"], b["q_mask"], train, dgen)

        # ---- vision branch ----------------------------------------------
        have_tokens = False
        if "scene_tokens" in b:
            # multi-question serving: the scene tower ran once per scene
            # (encode_scene); this pass reuses its pooled tokens
            tok_feats = b["scene_tokens"].to(self.dtype)
            positions = b["scene_token_positions"]
            have_tokens = True
        elif not mc.no_3d:
            enc, overflow = self._run_scene_encoder(b)
            for k, v in overflow.items():
                out[f"overflow/{k}"] = v.sum()
            if "openscene_out" in enc:
                # per-voxel CLIP-space features for segmentation eval
                # (eval.py:293-297: openscene_out @ text_features.T)
                out["openscene_out"] = enc["openscene_out"].feats
            tok_feats, positions = self._pool_tokens(enc["feat_bottleneck"],
                                                     sample_draws, generator)
            have_tokens = True

        if have_tokens:
            out["scene_positions"] = positions
            out["att_feat_pre"] = tok_feats
            gt = b["auxiliary_task"].float()
            pe_positions = positions
            if mc.situated_reencode:
                # token positions in the agent's frame: translate to the GT
                # situation position, rotate by the inverse z-heading
                rel = positions - gt[:, None, :2]
                if "__quat__" in tag:
                    qz, qw = gt[:, 5], gt[:, 6]
                    yaw = 2.0 * torch.atan2(qz, qw.abs().clamp(min=1e-8)) \
                        * torch.sign(qw + (qw == 0))
                elif "__angle__" in tag:
                    yaw = torch.atan2(gt[:, 3], gt[:, 4])
                else:  # __6d__: first rotation-matrix row is [cos, -sin, *]
                    yaw = torch.atan2(-gt[:, 4], gt[:, 3])
                c, s = torch.cos(-yaw)[:, None], torch.sin(-yaw)[:, None]
                pe_positions = torch.stack(
                    [rel[..., 0] * c - rel[..., 1] * s,
                     rel[..., 0] * s + rel[..., 1] * c], dim=-1)

            # situational position embedding of the 2D coords
            pe = self.pos_embed_fc2(F.gelu(self.pos_embed_fc1(pe_positions)))
            scene_feat = tok_feats + pe

            # Gaussian location-gt weights (sigma from config)
            dist = torch.linalg.norm(positions - gt[:, None, :2], dim=-1)
            w = torch.exp(-dist ** 2 / (2 * mc.pos_sigma ** 2))
            out["auxiliary_task_loc_gt"] = w / w.sum(dim=1, keepdim=True).clamp(min=1e-12)

        # ---- projections ------------------------------------------------
        s_feat = F.gelu(self.lang_feat_linear(s_out))
        q_feat = F.gelu(self.lang_feat_linear(q_out))
        if have_tokens:
            scene_feat = F.gelu(self.scene_feat_linear(scene_feat))

        # ---- MCAN fusion ------------------------------------------------
        L = mc.mcan_num_layers
        for i in range(L):
            s_feat = getattr(self, f"enc_s{i}")(s_feat, s_pad, train, dgen)
        for i in range(L):
            q_feat = getattr(self, f"enc_q{i}")(q_feat, q_pad, train, dgen)
        if have_tokens:
            for i in range(L):
                scene_feat = getattr(self, f"dec_s{i}")(scene_feat, s_feat, None,
                                                        s_pad, train, dgen)
            for i in range(L):
                scene_feat = getattr(self, f"dec_q{i}")(scene_feat, q_feat, None,
                                                        q_pad, train, dgen)
            out["att_feat_ori"] = scene_feat
            if mc.predict_situation:
                # per-token situation heads (kept for parity with the
                # reference; no loss reads them)
                out["pred_pos_likelihood"] = torch.sigmoid(
                    head(scene_feat, "position_head")).squeeze(-1)
                out["pred_rotation"] = head(scene_feat, "rotation_head")

        # ---- flatten + heads --------------------------------------------
        s_flat, out["satt"] = self.attflat_s(s_feat, s_pad, train, dgen)
        q_flat, out["qatt"] = self.attflat_q(q_feat, q_pad, train, dgen)
        if have_tokens:
            v_flat, out["oatt"] = self.attflat_visual(scene_feat, None, train, dgen)
            fuse = torch.cat([s_flat, q_flat, v_flat], dim=1)
        else:
            fuse = torch.cat([s_flat, q_flat], dim=1)

        if mc.use_situation and have_tokens:
            if "__class__" in tag:
                out["aux_scores"] = head(scene_feat, "aux_cls")
            else:
                out["aux_scores"] = head(torch.cat([s_flat, v_flat], dim=1), "aux_reg")

        out["answer_scores"] = head(fuse, "answer_cls", mc.answer_pdrop).float()
        return out

