"""Blip2Qformer, the stage-1 representation-learning model (port of
``situation3d_tpu/models/blip2_qformer.py``).

The full text-capable Q-Former: word and position embeddings, separate FFNs
for query and text positions, cross-attention into the scene features for
the query positions only. Over (scene features, caption) pairs it computes
the three stage-1 objectives:

- ITC: query features (``vision_proj``) against the text CLS (``text_proj``),
  max over queries, a learned temperature clamped at 1e-3; negatives from the
  batch (``train/contrastive.py:itc_loss``);
- ITM: joint [query ; text] encoding over the positive pairs and one hard
  negative image a text and one hard negative text an image, drawn from the
  similarity-weighted categorical (``argmax(w + Gumbel)``); a 2-way head
  averaged over the query outputs;
- LM: the caption generated with a causal text mask over a bidirectional
  query prefix, BOS = ``vocab_size - 1``, the LM head tied to the word
  embeddings.

The hard negatives' Gumbel noise is an input, ``gumbel=(for images, for
texts)``; without it the noise is drawn from ``generator`` (on the model's
device without one). Nothing
here drops out (the reference's layers have no dropout either).

``negatives_axis`` names the data axis when this process holds its rows of
a batch split over processes (``parallel/mesh.py``): the step then computes
what the reference's step computes on the global batch. ITC takes its
negatives from every process; the ITM hard negatives are drawn over the
global batch (gathered similarities, scene features, captions), the noise
drawn at the global ``[B, B]`` and cut to this process's rows; the LM loss
is this process's term of the global token mean.

``Blip2Qformer`` is built on its device from a seed as ``Blip2T5`` is; it
owns ``word_embeddings`` and lends it to its ``QFormerTextModel``, so the
module paths equal the reference's tree paths.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from situation3d_tpu_torch.config import QFormerConfig
from situation3d_tpu_torch.device import tree_to_device
from situation3d_tpu_torch.models.layers import Dense, Embed, LayerNorm, materialise
from situation3d_tpu_torch.models.qformer import NEG_INF, BertSelfAttentionOut
from situation3d_tpu_torch.models.t5 import gumbel_noise
from situation3d_tpu_torch.parallel import collectives
from situation3d_tpu_torch.train.contrastive import itc_loss, itm_loss, lm_loss, normalize
from situation3d_tpu_torch.utils.registry import registry

_BATCH_KEYS = ("image_embeds", "image_mask", "text_ids", "text_mask")


class QFormerTextLayer(nn.Module):
    """One layer over a [query ; text] sequence: joint self-attention,
    cross-attention for the query slice only, separate FFNs for query and
    text positions."""

    def __init__(self, cfg: QFormerConfig, has_cross_attention: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H, I, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.attention = BertSelfAttentionOut(cfg, dtype=dtype)
        self.crossattention = (BertSelfAttentionOut(cfg, cfg.encoder_width, dtype)
                               if has_cross_attention else None)
        for prefix in ("_query", ""):
            self.add_module(f"intermediate{prefix}", Dense(H, I, dtype))
            self.add_module(f"output{prefix}", Dense(I, H, dtype))
            self.add_module(f"output{prefix}_norm", LayerNorm(H, eps, dtype))

    def _ffn(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        inter = F.gelu(getattr(self, f"intermediate{prefix}")(x), approximate="none")
        return getattr(self, f"output{prefix}_norm")(x + getattr(self, f"output{prefix}")(inter))

    def forward(self, hidden, num_query: int, enc_states=None, enc_mask=None,
                attn_bias=None) -> torch.Tensor:
        hidden = self.attention(hidden, attn_bias=attn_bias)
        q_part, t_part = hidden[:, :num_query], hidden[:, num_query:]
        if self.crossattention is not None and num_query > 0 and enc_states is not None:
            q_part = self.crossattention(q_part, kv=enc_states, kv_mask=enc_mask)
        parts = []
        if num_query > 0:
            parts.append(self._ffn(q_part, "_query"))
        if t_part.shape[1] > 0:
            parts.append(self._ffn(t_part, ""))
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


class QFormerTextModel(nn.Module):
    """Text-capable Q-Former encoder with the three attention regimes of the
    stage-1 objectives: queries alone, text alone, or both (optionally causal
    on the text). ``word_embed`` is an embedding owned by the caller (the LM
    head ties to it); without one the model owns ``word_embeddings``."""

    def __init__(self, cfg: QFormerConfig, dtype: torch.dtype = torch.float32,
                 word_embed: Optional[Embed] = None):
        super().__init__()
        H = cfg.hidden_size
        self.cfg, self.dtype = cfg, dtype
        self.query_tokens = nn.Parameter(torch.zeros(1, cfg.num_query_tokens, H))
        if word_embed is None:
            self.word_embeddings = Embed(cfg.vocab_size, H, dtype)
        self._lent_embed = (word_embed,)     # a tuple: not registered a second time
        self.position_embeddings = Embed(cfg.max_position, H, dtype)
        self.emb_norm = LayerNorm(H, cfg.layer_norm_eps, dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", QFormerTextLayer(
                cfg, has_cross_attention=(i % cfg.cross_attention_freq == 0), dtype=dtype))

    def word_embed(self) -> Embed:
        return self._lent_embed[0] or self.word_embeddings

    def forward(self, enc_states=None, enc_mask=None, text_ids=None, text_mask=None,
                use_query: bool = True, causal_text: bool = False) -> torch.Tensor:
        cfg = self.cfg
        parts, nq = [], 0
        if use_query:
            B = (enc_states if enc_states is not None else text_ids).shape[0]
            parts.append(self.query_tokens.expand(B, -1, -1).to(self.dtype))
            nq = cfg.num_query_tokens
        if text_ids is not None:
            pos = torch.arange(text_ids.shape[1], device=text_ids.device)[None]
            parts.append(self.word_embed()(text_ids) + self.position_embeddings(pos))
        hidden = self.emb_norm(torch.cat(parts, dim=1) if len(parts) > 1 else parts[0])

        # additive self-attention bias over the [query ; text] sequence
        B, L = hidden.shape[:2]
        key_ok = torch.ones(B, L, dtype=torch.bool, device=hidden.device)
        if text_ids is not None and text_mask is not None:
            key_ok[:, nq:] = text_mask.bool()
        zero = torch.zeros((), device=hidden.device)
        bias = torch.where(key_ok[:, None, None, :], zero, NEG_INF)
        if causal_text and L - nq > 0:
            qpos = torch.arange(L, device=hidden.device)[:, None]
            kpos = torch.arange(L, device=hidden.device)[None, :]
            # queries see each other; text sees every query and text up to itself
            causal = (kpos < nq) | (kpos <= qpos)
            bias = bias + torch.where(causal[None, None], zero, NEG_INF)
        for i in range(cfg.num_layers):
            hidden = getattr(self, f"layer{i}")(hidden, nq, enc_states, enc_mask, bias)
        return hidden


@registry.register_model("blip2")
class Blip2Qformer(nn.Module):
    """Stage-1 model: scene features + captions -> ITC / ITM / LM losses.
    Parameters are float32, compute runs in ``dtype``."""

    def __init__(self, cfg: QFormerConfig, embed_dim: int = 256,
                 dtype: torch.dtype = torch.float32, device="cuda", seed: int = 0):
        super().__init__()
        H = cfg.hidden_size
        self.cfg, self.embed_dim, self.dtype = cfg, embed_dim, dtype
        with torch.device("meta"):
            self.word_embeddings = Embed(cfg.vocab_size, H, dtype)
            self.qformer = QFormerTextModel(cfg, dtype, word_embed=self.word_embeddings)
            self.vision_proj = Dense(H, embed_dim, dtype)
            self.text_proj = Dense(H, embed_dim, dtype)
            self.itm_head = Dense(H, 2, dtype)
            self.temp = nn.Parameter(torch.empty(()))
            # LM head: transform + the decoder tied to the word embeddings
            self.lm_transform = Dense(H, H, dtype)
            self.lm_norm = LayerNorm(H, cfg.layer_norm_eps, dtype)
            self.lm_bias = nn.Parameter(torch.empty(cfg.vocab_size))
        materialise(self, device, seed)
        with torch.no_grad():       # the reference's own values
            self.temp.fill_(0.07)
            self.lm_bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.temp.device

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return tree_to_device({k: v for k, v in batch.items() if k in _BATCH_KEYS},
                              self.device)

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        h = self.lm_norm(F.gelu(self.lm_transform(hidden), approximate="none"))
        return F.linear(h.to(self.dtype), self.word_embeddings.weight.to(self.dtype)) \
            + self.lm_bias

    def encode_image(self, image_embeds, image_mask) -> torch.Tensor:
        return self.qformer(enc_states=image_embeds, enc_mask=image_mask, use_query=True)

    def encode_text(self, text_ids, text_mask) -> torch.Tensor:
        return self.qformer(text_ids=text_ids, text_mask=text_mask, use_query=False)

    # -- retrieval surface --------------------------------------------------
    def forward_image(self, image_embeds, image_mask):
        """Query outputs and the raw encoder states."""
        return self.encode_image(image_embeds, image_mask), image_embeds

    def forward_text(self, text_ids, text_mask) -> torch.Tensor:
        """Text CLS hidden state."""
        return self.encode_text(text_ids, text_mask)[:, 0]

    def compute_itm(self, image_inputs, image_mask, text_ids, text_mask) -> torch.Tensor:
        """ITM match logit a (scene, text) pair: joint [query ; text]
        encoding, the 2-way head's positive logit averaged over the query
        outputs. [B]"""
        mm = self.qformer(enc_states=image_inputs.to(self.dtype), enc_mask=image_mask,
                          text_ids=text_ids, text_mask=text_mask, use_query=True)
        return self.itm_head(mm[:, :self.cfg.num_query_tokens])[:, :, 1].mean(dim=1)

    def itc_projections(self, image_embeds, image_mask, text_ids, text_mask
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalized (image features [B, Q, D], text feature [B, D]), float32."""
        q = self.encode_image(image_embeds.to(self.dtype), image_mask)
        img = normalize(self.vision_proj(q).float())
        t = self.encode_text(text_ids, text_mask)[:, 0]
        return img, normalize(self.text_proj(t).float())

    def forward(self, batch: Dict[str, Any], negatives_axis: Optional[str] = None,
                gumbel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """batch: image_embeds [B, N, encoder_width], image_mask [B, N],
        text_ids / text_mask [B, Lt] caption tokens (pad = 0).

        Returns {"loss", "loss_itc", "loss_itm", "loss_lm"}.
        """
        b = self._to_device(batch)
        image_embeds = b["image_embeds"].to(self.dtype)
        image_mask, text_ids, text_mask = b["image_mask"], b["text_ids"], b["text_mask"]
        B, nq = text_ids.shape[0], self.cfg.num_query_tokens

        # --- ITC -------------------------------------------------------------
        image_feats = self.vision_proj(self.encode_image(image_embeds, image_mask))  # [B, Q, D]
        text_feat = self.text_proj(self.encode_text(text_ids, text_mask)[:, 0])    # [B, D]
        temp = self.temp.clamp(min=1e-3)
        loss_itc = itc_loss(image_feats.float(), text_feat.float(), temp, axis=negatives_axis)

        # --- ITM with in-batch hard negatives --------------------------------
        neg_img, neg_txt = self.draw_negatives(image_feats, text_feat, temp, gumbel, generator,
                                               negatives_axis)
        pool = (image_embeds, image_mask, text_ids, text_mask)
        if negatives_axis is not None:      # negatives index the global batch
            pool = tuple(collectives.all_gather(x, tiled=True) for x in pool)
        all_img, all_imask, all_txt, all_tmask = pool
        itm_images = torch.cat([image_embeds, all_img[neg_img], image_embeds])
        itm_image_mask = torch.cat([image_mask, all_imask[neg_img], image_mask])
        itm_text = torch.cat([text_ids, text_ids, all_txt[neg_txt]])
        itm_tmask = torch.cat([text_mask, text_mask, all_tmask[neg_txt]])
        mm = self.qformer(enc_states=itm_images, enc_mask=itm_image_mask, text_ids=itm_text,
                          text_mask=itm_tmask, use_query=True)
        logits = self.itm_head(mm[:, :nq]).mean(dim=1)                            # [3B, 2]
        itm_labels = torch.cat([torch.ones(B, dtype=torch.long, device=self.device),
                                torch.zeros(2 * B, dtype=torch.long, device=self.device)])
        loss_itm = itm_loss(logits, itm_labels)

        # --- LM ----------------------------------------------------------------
        dec_in = torch.roll(text_ids, 1, dims=1)
        dec_in[:, 0] = self.cfg.vocab_size - 1       # BOS: the last vocabulary id
        lm_hidden = self.qformer(enc_states=image_embeds, enc_mask=image_mask,
                                 text_ids=dec_in, text_mask=torch.ones_like(text_mask),
                                 use_query=True, causal_text=True)
        loss_lm = lm_loss(self.lm_logits(lm_hidden[:, nq:]), text_ids, text_mask,
                          axis=negatives_axis)

        return {"loss": loss_itc + loss_itm + loss_lm, "loss_itc": loss_itc,
                "loss_itm": loss_itm, "loss_lm": loss_lm}

    @torch.no_grad()
    def draw_negatives(self, image_feats, text_feat, temp, gumbel=None, generator=None,
                       axis=None):
        """(hard negative image a text, hard negative text an image): draws of
        the categorical over the similarities (the pair itself excluded),
        ``argmax(w + Gumbel)``. With ``axis``: over the global batch, for
        this process's rows, as indices into the global batch; ``gumbel``
        is the global batch's noise [B, B] either way."""
        img, txt = normalize(image_feats.float()), normalize(text_feat.float())
        rows = slice(None)
        if axis is not None:
            B, r = txt.shape[0], collectives.rank()
            img, txt = (collectives.all_gather(x, tiled=True) for x in (img, txt))
            rows = slice(r * B, (r + 1) * B)
        B = txt.shape[0]
        sim = torch.einsum("bqd,jd->bqj", img, txt).amax(dim=1) / temp      # [B, B]
        eye = torch.eye(B, dtype=torch.bool, device=sim.device)
        w_t2i = torch.where(eye, NEG_INF, sim.T)[rows]     # text b picks a hard image
        w_i2t = torch.where(eye, NEG_INF, sim)[rows]       # image b picks a hard text
        if gumbel is None:
            where = generator.device if generator is not None else sim.device
            gumbel = tuple(gumbel_noise(w_t2i.shape, generator, where) for _ in range(2))
        else:
            gumbel = tuple(g[rows] for g in gumbel)
        g_t2i, g_i2t = (g.to(sim.device) for g in gumbel)
        return (w_t2i + g_t2i).argmax(dim=-1), (w_i2t + g_i2t).argmax(dim=-1)


@registry.register_model("blip2_image_text_matching")
class Blip2ITM(Blip2Qformer):
    """The stage-1 Q-Former as a scorer. ``forward(batch, match_head)``:

    - ``"itm"``: the 2-way ITM logits a (scene, text) pair, the head averaged
      over the query outputs of the joint encoding (not softmaxed). [B, 2]
    - ``"itc"``: the max-over-queries cosine similarity of the normalized
      query features and text CLS projection, without the temperature. [B]

    Both heads' parameters belong to the model whichever head is asked for.
    """

    def forward(self, batch: Dict[str, Any],  # type: ignore[override]
                match_head: str = "itm") -> torch.Tensor:
        if match_head not in ("itm", "itc"):
            raise ValueError(f"match_head must be itm|itc, got {match_head!r}")
        b = self._to_device(batch)
        image_embeds = b["image_embeds"].to(self.dtype)
        if match_head == "itm":
            mm = self.qformer(enc_states=image_embeds, enc_mask=b["image_mask"],
                              text_ids=b["text_ids"], text_mask=b["text_mask"],
                              use_query=True)
            return self.itm_head(mm[:, :self.cfg.num_query_tokens]).mean(dim=1)
        img, txt = self.itc_projections(image_embeds, b["image_mask"], b["text_ids"],
                                        b["text_mask"])
        return torch.einsum("bqd,bd->bq", img, txt).amax(dim=1)
