"""Vision transformers for BLIP-2: EVA-CLIP-g, CLIP ViT-L and ViT-B (port of
``situation3d_tpu/models/vit.py``).

- ``EvaViT`` (eva_clip_g: patch 14, width 1408, 39 blocks, 16 heads, MLP
  ratio 4.3637): pre-LN blocks, fused qkv with learned q / v biases and the k
  bias pinned to zero, absolute cls + patch position embeddings, an optional
  shared relative position bias (``SharedRelPosBias``), and no final norm:
  it returns every token.
- ``ViTConfig.vit_base()``: the plain timm ViT-B/16 as an ``EvaViT`` with a
  learned k bias (``full_qkv_bias``) and a final norm.
- ``ClipViT`` (clip_L: patch 14, width 1024, 21 blocks): patch conv without
  bias, class embedding, ``ln_pre``, QuickGELU MLPs, no final norm.

Images are channel-last [B, H, W, 3]; the patch convolution keeps the
reference's HWIO kernel and its SAME padding. Drop path (stochastic depth)
acts in training form only, its keep masks drawn from an explicit
``torch.Generator`` before the blocks run. ``remat`` maps to
``torch.utils.checkpoint`` (recompute a block's activations in the
backward) when gradients are being recorded, and is ignored at inference,
where nothing is kept for a backward; the masks drawn beforehand make the
recomputation repeat the forward exactly. Attention is product, float32
softmax, product, in ``dtype``, as in the reference. ``init_vision_encoder``
builds a model and its ``ln_vision`` on a device from a seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from situation3d_tpu_torch.device import resolve_device
from situation3d_tpu_torch.models.layers import Dense, LayerNorm, materialise


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Shape of one vision transformer (both families)."""
    model_name: str = "eva_clip_g"      # "eva_clip_g" | "clip_L" | "vit_base"
    img_size: int = 224
    patch_size: int = 14
    embed_dim: int = 1408
    depth: int = 39
    num_heads: int = 16
    mlp_ratio: float = 4.3637
    qkv_bias: bool = True               # EVA q/v bias, k bias pinned to zero
    full_qkv_bias: bool = False         # plain timm ViT: k bias learned too
    final_norm: bool = False            # plain timm ViT: trailing LayerNorm
    drop_path_rate: float = 0.0
    layer_norm_eps: float = 1e-6
    use_shared_rel_pos_bias: bool = False
    remat: bool = False                 # recompute blocks in the backward

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @staticmethod
    def eva_clip_g(img_size: int = 224, drop_path_rate: float = 0.0,
                   remat: bool = False) -> "ViTConfig":
        return ViTConfig(model_name="eva_clip_g", img_size=img_size, patch_size=14,
                         embed_dim=1408, depth=39, num_heads=16, mlp_ratio=4.3637,
                         qkv_bias=True, drop_path_rate=drop_path_rate, remat=remat)

    @staticmethod
    def vit_base(img_size: int = 224, patch_size: int = 16,
                 remat: bool = False) -> "ViTConfig":
        """Plain timm ViT-B (embed 768, depth 12, 12 heads, MLP 4.0, full qkv
        bias, final norm, every token returned)."""
        return ViTConfig(model_name="vit_base", img_size=img_size, patch_size=patch_size,
                         embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0,
                         qkv_bias=True, full_qkv_bias=True, final_norm=True, remat=remat)

    @staticmethod
    def clip_L(img_size: int = 224, remat: bool = False) -> "ViTConfig":
        """CLIP ViT-L/14 (``layers=22`` -> 21 blocks)."""
        return ViTConfig(model_name="clip_L", img_size=img_size, patch_size=14,
                         embed_dim=1024, depth=21, num_heads=16, mlp_ratio=4.0,
                         qkv_bias=True, layer_norm_eps=1e-5, remat=remat)


def _attention(q, k, v, dtype, bias=None) -> torch.Tensor:
    """[B, h, N, d] each; ``q`` already scaled."""
    scores = torch.matmul(q, k.transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    att = F.softmax(scores.float(), dim=-1).to(dtype)
    return torch.matmul(att, v)


class PatchEmbed(nn.Module):
    """Stride-p p x p convolution over [B, H, W, C_in] images with a HWIO
    kernel and SAME padding -> [B, H/p, W/p, C_out]."""

    def __init__(self, patch: int, c_in: int, c_out: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.kernel = nn.Parameter(torch.empty(patch, patch, c_in, c_out))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        p = self.patch
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        pads = []
        for n in (x.shape[3], x.shape[2]):          # SAME: W then H, low side first
            total = max((math.ceil(n / p) - 1) * p + p - n, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = F.pad(x, pads)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        out = F.conv2d(x, self.kernel.permute(3, 2, 0, 1).to(self.dtype), bias, stride=p)
        return out.permute(0, 2, 3, 1)


class EvaAttention(nn.Module):
    """Fused-qkv attention: learned q / v biases, the k bias zero (learned
    under ``full_qkv_bias``)."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        C = cfg.embed_dim
        self.cfg, self.dtype = cfg, dtype
        self.qkv_kernel = nn.Parameter(torch.empty(C, 3 * C))
        self.q_bias = nn.Parameter(torch.empty(C)) if cfg.qkv_bias else None
        self.v_bias = nn.Parameter(torch.empty(C)) if cfg.qkv_bias else None
        self.k_bias = (nn.Parameter(torch.empty(C))
                       if cfg.qkv_bias and cfg.full_qkv_bias else None)
        self.proj = Dense(C, C, dtype)

    def forward(self, x, rel_pos_bias=None) -> torch.Tensor:
        B, N, C = x.shape
        h = self.cfg.num_heads
        d = C // h
        qkv = torch.matmul(x, self.qkv_kernel.to(self.dtype))
        if self.q_bias is not None:
            k_bias = self.k_bias if self.k_bias is not None else torch.zeros_like(self.q_bias)
            qkv = qkv + torch.cat([self.q_bias, k_bias, self.v_bias]).to(self.dtype)
        q, k, v = qkv.reshape(B, N, 3, h, d).permute(2, 0, 3, 1, 4)
        out = _attention(q * (d ** -0.5), k, v, self.dtype, rel_pos_bias)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


def _drop(x, keep_mask, rate: float) -> torch.Tensor:
    """Stochastic depth of a residual branch: sample ``b`` kept (scaled by
    ``1 / (1 - rate)``) or dropped. ``keep_mask`` [B] bool, or None."""
    if keep_mask is None:
        return x
    return x * keep_mask.to(x.dtype)[:, None, None] / (1.0 - rate)


class EvaBlock(nn.Module):
    """Pre-LN transformer block with an exact-GELU MLP."""

    def __init__(self, cfg: ViTConfig, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C, eps = cfg.embed_dim, cfg.layer_norm_eps
        hidden = int(C * cfg.mlp_ratio)
        self.drop_path = drop_path
        self.norm1 = LayerNorm(C, eps, dtype)
        self.attn = EvaAttention(cfg, dtype)
        self.norm2 = LayerNorm(C, eps, dtype)
        self.mlp_fc1 = Dense(C, hidden, dtype)
        self.mlp_fc2 = Dense(hidden, C, dtype)

    def forward(self, x, rel_pos_bias=None, keep_attn=None, keep_mlp=None) -> torch.Tensor:
        x = x + _drop(self.attn(self.norm1(x), rel_pos_bias), keep_attn, self.drop_path)
        m = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none"))
        return x + _drop(m, keep_mlp, self.drop_path)


class SharedRelPosBias(nn.Module):
    """A relative position bias table over the patch grid and the cls token,
    shared by every block -> [1, heads, N, N]."""

    def __init__(self, window: Tuple[int, int], num_heads: int):
        super().__init__()
        wh, ww = window
        num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
        self.table = nn.Parameter(torch.empty(num_rel, num_heads))
        coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
        rel = coords[:, :, None] - coords[:, None, :]
        P = wh * ww
        full = np.zeros((P + 1, P + 1), np.int64)
        full[1:, 1:] = (rel[0] + wh - 1) * (2 * ww - 1) + (rel[1] + ww - 1)
        full[0, :] = num_rel - 3
        full[:, 0] = num_rel - 2
        full[0, 0] = num_rel - 1
        self.index = full          # host array: a meta-built model keeps it

    def forward(self) -> torch.Tensor:
        idx = torch.from_numpy(self.index).to(self.table.device)
        return self.table[idx].permute(2, 0, 1)[None]


class _VisionTransformer(nn.Module):
    """Blocks run in order, each through ``torch.utils.checkpoint`` under
    ``remat`` while gradients are recorded."""

    def _run_blocks(self, x, blocks: List[nn.Module], extra: List[tuple]) -> torch.Tensor:
        for block, args in zip(blocks, extra):
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, *args, use_reentrant=False)
            else:
                x = block(x, *args)
        return x


class EvaViT(_VisionTransformer):
    """EVA VisionTransformer: cls + patch tokens, absolute position
    embedding, pre-LN blocks; every token out ([B, 1 + patches, width])."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32,
                 device="cuda", seed: int = 0):
        super().__init__()
        C = cfg.embed_dim
        self.cfg, self.dtype = cfg, dtype
        self.drop_rates = [cfg.drop_path_rate * i / max(cfg.depth - 1, 1)
                           for i in range(cfg.depth)]
        with torch.device("meta"):
            self.patch_embed = PatchEmbed(cfg.patch_size, 3, C, True, dtype)
            self.cls_token = nn.Parameter(torch.empty(1, 1, C))
            self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches + 1, C))
            g = cfg.img_size // cfg.patch_size
            self.rel_pos_bias = (SharedRelPosBias((g, g), cfg.num_heads)
                                 if cfg.use_shared_rel_pos_bias else None)
            for i in range(cfg.depth):
                self.add_module(f"block{i}", EvaBlock(cfg, self.drop_rates[i], dtype))
            self.norm = LayerNorm(C, cfg.layer_norm_eps, dtype) if cfg.final_norm else None
        materialise(self, device, seed)

    def forward(self, images, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images [B, H, W, 3] -> [B, 1 + num_patches, embed_dim]. In
        training form (``train``) each block's two residual branches drop
        per sample at the block's drop-path rate, masks from ``generator``."""
        cfg = self.cfg
        x = self.patch_embed(images)
        B = x.shape[0]
        x = x.reshape(B, -1, cfg.embed_dim)
        x = torch.cat([self.cls_token.to(self.dtype).expand(B, -1, -1), x], dim=1)
        x = x + self.pos_embed.to(self.dtype)
        rel = self.rel_pos_bias() if self.rel_pos_bias is not None else None
        extra = []
        for rate in self.drop_rates:
            if train and rate > 0.0:
                where = generator.device if generator is not None else x.device
                keep = [(torch.rand(B, generator=generator, device=where) < 1.0 - rate
                         ).to(x.device) for _ in range(2)]
            else:
                keep = [None, None]
            extra.append((rel, *keep))
        x = self._run_blocks(x, [getattr(self, f"block{i}") for i in range(cfg.depth)], extra)
        return self.norm(x) if self.norm is not None else x


class ClipBlock(nn.Module):
    """CLIP residual attention block: pre-LN, fused in-projection, QuickGELU
    MLP."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        C, eps = cfg.embed_dim, cfg.layer_norm_eps
        self.cfg, self.dtype = cfg, dtype
        self.ln_1 = LayerNorm(C, eps, dtype)
        self.in_proj = Dense(C, 3 * C, dtype)
        self.out_proj = Dense(C, C, dtype)
        self.ln_2 = LayerNorm(C, eps, dtype)
        self.c_fc = Dense(C, int(C * cfg.mlp_ratio), dtype)
        self.c_proj = Dense(int(C * cfg.mlp_ratio), C, dtype)

    def forward(self, x) -> torch.Tensor:
        B, N, C = x.shape
        h = self.cfg.num_heads
        d = C // h
        q, k, v = (t.reshape(B, N, h, d).transpose(1, 2)
                   for t in self.in_proj(self.ln_1(x)).chunk(3, dim=-1))
        out = _attention(q * (d ** -0.5), k, v, self.dtype)
        x = x + self.out_proj(out.transpose(1, 2).reshape(B, N, C))
        m = self.c_fc(self.ln_2(x))
        return x + self.c_proj(m * torch.sigmoid(1.702 * m))


class ClipViT(_VisionTransformer):
    """CLIP VisionTransformer: conv1 (no bias), class embedding, absolute
    position embedding, ``ln_pre``, blocks; every token out."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32,
                 device="cuda", seed: int = 0):
        super().__init__()
        C = cfg.embed_dim
        self.cfg, self.dtype = cfg, dtype
        with torch.device("meta"):
            self.conv1 = PatchEmbed(cfg.patch_size, 3, C, False, dtype)
            self.class_embedding = nn.Parameter(torch.empty(C))
            self.positional_embedding = nn.Parameter(torch.empty(cfg.num_patches + 1, C))
            self.ln_pre = LayerNorm(C, cfg.layer_norm_eps, dtype)
            for i in range(cfg.depth):
                self.add_module(f"block{i}", ClipBlock(cfg, dtype))
        materialise(self, device, seed)

    def forward(self, images, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images [B, H, W, 3] -> [B, 1 + num_patches, embed_dim] (CLIP has
        no drop path; ``train`` and ``generator`` are accepted for a common
        call)."""
        cfg = self.cfg
        x = self.conv1(images)
        B = x.shape[0]
        x = x.reshape(B, -1, cfg.embed_dim)
        x = torch.cat([self.class_embedding.to(self.dtype).expand(B, 1, -1), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding[None].to(self.dtype))
        return self._run_blocks(x, [getattr(self, f"block{i}") for i in range(cfg.depth)],
                                [()] * cfg.depth)


def init_vision_encoder(model_name: str, img_size: int = 224, drop_path_rate: float = 0.0,
                        use_grad_checkpoint: bool = False,
                        dtype: torch.dtype = torch.bfloat16, device="cuda", seed: int = 0):
    """``Blip2Base.init_vision_encoder``: ``(vit, ln_vision)`` on ``device``,
    the ViT's weights from ``seed``, ``ln_vision`` (eps 1e-5) at weight 1 and
    bias 0."""
    if model_name == "eva_clip_g":
        cfg = ViTConfig.eva_clip_g(img_size, drop_path_rate, remat=use_grad_checkpoint)
        vit = EvaViT(cfg, dtype=dtype, device=device, seed=seed)
    elif model_name == "clip_L":
        cfg = ViTConfig.clip_L(img_size, remat=use_grad_checkpoint)
        vit = ClipViT(cfg, dtype=dtype, device=device, seed=seed)
    else:
        raise ValueError(f"vit model must be eva_clip_g or clip_L, got {model_name!r}")
    ln_vision = LayerNorm(cfg.embed_dim, 1e-5, dtype).to(resolve_device(device))
    return vit, ln_vision


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] weights of a linear resize with antialiasing (a
    triangle kernel widened by the scale when downsampling), normalized per
    output sample, zero where the sample lies outside the input: the
    arithmetic of ``jax.image.resize(..., "bilinear")``, in float32."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = (1.0 - x).clamp(min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embed(pos_embed, new_num_patches: int,
                          num_extra_tokens: int = 1) -> torch.Tensor:
    """Resize the patch-grid part of a position embedding [1, extra +
    old^2, C] to ``new_num_patches`` (a square grid), as the reference does
    when loading a checkpoint trained at another image size: the
    ``jax.image.resize`` bilinear resize of its grid, float32."""
    pos_embed = torch.as_tensor(np.asarray(pos_embed), dtype=torch.float32)
    extra, grid = pos_embed[:, :num_extra_tokens], pos_embed[:, num_extra_tokens:]
    old = int(round(grid.shape[1] ** 0.5))
    new = int(round(new_num_patches ** 0.5))
    if old == new:
        return pos_embed
    C = grid.shape[-1]
    w = _resize_weights(old, new)
    grid = torch.einsum("bhwc,hi,wj->bijc", grid.reshape(1, old, old, C), w, w)
    return torch.cat([extra, grid.reshape(1, new * new, C)], dim=1)
