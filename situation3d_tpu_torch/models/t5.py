"""T5 encoder-decoder sized for FlanT5-XL (port of
``situation3d_tpu/models/t5.py``), and its decoders.

As the reference writes it: RMS layer norm in float32 (``x * rsqrt(var +
eps)``, then the weight, then the cast), no ``1/sqrt(d)`` attention scaling,
attention scores in float32 with a float32 softmax, masks with ``NEG_INF =
-1e9``, the relative position bias in layer 0 of each stack only and passed
down, a gated exact-erf GELU FFN (``"gelu_new"`` takes the tanh form), an
untied ``lm_head``. Attention is a product, a softmax and a product, the
arithmetic the reference runs, so decoded tokens agree with it.

Decoding keeps a self-attention cache of ``max_answer_len`` slots a layer
(:class:`DecodeCache`): a step writes its keys at ``index``, attends over all
slots with the later ones masked, and takes row ``index`` of the bias over
``max_answer_len`` keys. The cache also holds every layer's cross-attention
keys and values over the encoder output, projected once at the first step
(the same product over ``[B, L_enc, d_model]`` that each step ran before),
and the encoder mask's boolean form. ``greedy_decode``,
``beam_search_decode`` and ``sample_decode`` are Python loops over
``decode_step``; each reads one flag from the device a step to stop when
every row is done. ``sample_decode`` takes its Gumbel noise as an input (or
draws it from a generator).

On a CUDA device with grad off, ``greedy_decode`` captures each of its steps
once per shape as a CUDA graph over static buffers (:class:`GreedyBuffers`,
the cross-attention's keys and values among them, projected once a batch
before the replays) and replays it; the flag is still read between steps.
The eager loop runs the same step function on the same buffers, so both
emit the same tokens.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from situation3d_tpu_torch.config import T5Config
from situation3d_tpu_torch.models.layers import Dense, Embed
from situation3d_tpu_torch.models.relpos import (relative_position_bucket,
                                                 relative_position_matrix)
from situation3d_tpu_torch.models.step_graphs import (GraphCache, GreedyTokens, capture_steps,
                                                     eager, greedy_loop, storage)
from situation3d_tpu_torch.parallel import collectives
from situation3d_tpu_torch.parallel.mesh import draw
from situation3d_tpu_torch.utils.trace import spanned

NEG_INF = -1e9

decode_graph_captures = 0   # +1 per greedy step graph captured, nowhere else
decode_graph_replays = 0    # +1 per greedy step graph replayed, nowhere else
cross_kv_projections = 0    # +1 per encoder output whose cross keys and values a decode projects


class DecodeCache:
    """Self-attention keys and values of every decoder layer, ``[B, h,
    max_answer_len, d_kv]`` each, and the next slot to write; ``cross``:
    each layer's cross-attention keys (float32) and values over the encoder
    output, ``[B, L_enc, h * d_kv]`` each, with ``cross_mask``, the encoder
    mask as booleans. ``cross`` is None until the first step projects it
    (:meth:`T5Decoder.project_cross`)."""

    def __init__(self, layers: List[dict], index: int = 0,
                 cross: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
                 cross_mask: Optional[torch.Tensor] = None):
        self.layers, self.index = layers, index
        self.cross, self.cross_mask = cross, cross_mask

    def reorder(self, rows: torch.Tensor) -> None:
        """Keep the batch rows ``rows`` (beam search's reorder)."""
        for layer in self.layers:
            layer["key"] = layer["key"].index_select(0, rows)
            layer["value"] = layer["value"].index_select(0, rows)
        if self.cross is not None:
            self.cross = [(k.index_select(0, rows), v.index_select(0, rows))
                          for k, v in self.cross]
            self.cross_mask = self.cross_mask.index_select(0, rows)


class T5LayerNorm(nn.Module):
    """RMS norm without mean subtraction or bias, in float32."""

    def __init__(self, features: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        var = x.square().mean(-1, keepdim=True)
        return (self.weight * (x * torch.rsqrt(var + self.eps))).to(self.dtype)


def _where_neg(keep: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    # the fill made on the device: a host tensor's copy would sync the stream
    # (and cannot be captured)
    return torch.where(keep, scores, scores.new_full((), NEG_INF))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False,
                 causal: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg, self.causal, self.dtype = cfg, causal, dtype
        self.q = Dense(cfg.d_model, inner, dtype, bias=False)
        self.k = Dense(cfg.d_model, inner, dtype, bias=False)
        self.v = Dense(cfg.d_model, inner, dtype, bias=False)
        self.o = Dense(inner, cfg.d_model, dtype, bias=False)
        self.relative_attention_bias = (
            Embed(cfg.relative_attention_num_buckets, cfg.num_heads)
            if has_relative_bias else None)

    def _split(self, x, B):
        return x.reshape(B, -1, self.cfg.num_heads, self.cfg.d_kv).transpose(1, 2)

    def forward(self, hidden, kv=None, mask=None, position_bias=None,
                cache: Optional[dict] = None, cache_index: Optional[int] = None,
                projected: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """mask: [B, Lk] 1 = attend. ``cache`` (this layer's slots) and
        ``cache_index`` for a decode step of the self-attention;
        ``projected``: the keys and values of ``kv``, ``[B, Lk, h * d_kv]``
        each (the keys may be float32 already), in place of projecting them
        here. Returns (out, position_bias)."""
        cfg = self.cfg
        B, Lq, _ = hidden.shape
        q = self._split(self.q(hidden), B)
        if projected is None:
            kv_src = hidden if kv is None else kv
            k = self._split(self.k(kv_src), B)
            v = self._split(self.v(kv_src), B)
        else:
            k, v = (self._split(t, B) for t in projected)
        decode = cache is not None
        if decode:
            slots = cache["key"].shape[2]
            start = min(max(cache_index, 0), slots - Lq)  # the reference clamps the write
            cache["key"][:, :, start:start + Lq] = k
            cache["value"][:, :, start:start + Lq] = v
            k, v = cache["key"], cache["value"]
        Lk = k.shape[2]
        # no 1/sqrt(d) scaling (T5); products of the compute dtype summed in float32
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))

        if position_bias is None and self.relative_attention_bias is not None:
            rp = relative_position_matrix(Lk if decode else Lq, Lk, device=hidden.device)
            buckets = relative_position_bucket(
                rp, bidirectional=not self.causal,
                num_buckets=cfg.relative_attention_num_buckets,
                max_distance=cfg.relative_attention_max_distance)
            position_bias = self.relative_attention_bias(buckets).permute(2, 0, 1)[None]
            if decode:   # the row(s) of the current position(s), clamped as the reference does
                row = min(max(cache_index, 0), Lk - Lq)
                position_bias = position_bias[:, :, row:row + Lq]
        if position_bias is not None:
            scores = scores + position_bias.float()

        if self.causal and not decode:
            scores = _where_neg(torch.ones(Lq, Lk, dtype=torch.bool, device=scores.device)
                                .tril()[None, None], scores)
        if decode:
            pos = torch.arange(Lk, device=scores.device)
            scores = _where_neg((pos <= cache_index)[None, None, None], scores)
        if mask is not None:
            scores = _where_neg(mask[:, None, None, :].bool(), scores)
        att = F.softmax(scores, dim=-1).to(self.dtype)
        out = torch.matmul(att, v).transpose(1, 2).reshape(B, Lq, -1)
        return self.o(out), position_bias


class T5FF(nn.Module):
    def __init__(self, cfg: T5Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)
        if cfg.is_gated_act:
            self.wi_0 = Dense(cfg.d_model, cfg.d_ff, dtype, bias=False)
            self.wi_1 = Dense(cfg.d_model, cfg.d_ff, dtype, bias=False)
        else:
            self.wi = Dense(cfg.d_model, cfg.d_ff, dtype, bias=False)
        self.wo = Dense(cfg.d_ff, cfg.d_model, dtype, bias=False)

    def forward(self, x):
        cfg = self.cfg
        h = self.layer_norm(x)
        if cfg.is_gated_act:
            g = F.gelu(self.wi_0(h),
                       approximate="tanh" if cfg.dense_act_fn == "gelu_new" else "none")
            h = g * self.wi_1(h)
        else:
            h = F.relu(self.wi(h))
        return x + self.wo(h)


class T5EncoderBlock(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)
        self.self_attn = T5Attention(cfg, has_relative_bias, causal=False, dtype=dtype)
        self.ff = T5FF(cfg, dtype)

    def forward(self, x, mask, position_bias):
        a, position_bias = self.self_attn(self.self_attn_norm(x), mask=mask,
                                          position_bias=position_bias)
        return self.ff(x + a), position_bias


class T5DecoderBlock(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.self_attn_norm = T5LayerNorm(cfg.d_model, eps, dtype)
        self.self_attn = T5Attention(cfg, has_relative_bias, causal=True, dtype=dtype)
        self.cross_attn_norm = T5LayerNorm(cfg.d_model, eps, dtype)
        self.cross_attn = T5Attention(cfg, False, causal=False, dtype=dtype)
        self.ff = T5FF(cfg, dtype)

    def forward(self, x, enc, enc_mask, dec_mask, position_bias, cache=None,
                cache_index=None, cross=None):
        a, position_bias = self.self_attn(self.self_attn_norm(x), mask=dec_mask,
                                          position_bias=position_bias, cache=cache,
                                          cache_index=cache_index)
        x = x + a
        c, _ = self.cross_attn(self.cross_attn_norm(x), kv=enc, mask=enc_mask,
                               projected=cross)
        return self.ff(x + c), position_bias


def _run_block(block, remat: bool, *args):
    """One block, recomputed in the backward under ``remat`` (training only)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        for i in range(cfg.num_layers):
            self.add_module(f"block{i}", T5EncoderBlock(cfg, i == 0, dtype))
        self.final_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)

    def forward(self, inputs_embeds, mask):
        x = inputs_embeds.to(self.dtype)
        position_bias = None
        for i in range(self.cfg.num_layers):
            x, position_bias = _run_block(getattr(self, f"block{i}"), self.cfg.remat,
                                          x, mask, position_bias)
        return self.final_norm(x)


class T5Decoder(nn.Module):
    def __init__(self, cfg: T5Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        for i in range(cfg.num_decoder_layers):
            self.add_module(f"block{i}", T5DecoderBlock(cfg, i == 0, dtype))
        self.final_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)

    def project_cross(self, enc: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Every layer's cross-attention keys and values over ``enc``, which
        a decode's steps all read; a cache keeps the keys in float32, as the
        scores product reads them."""
        global cross_kv_projections
        cross_kv_projections += 1
        attns = [getattr(self, f"block{i}").cross_attn for i in range(self.cfg.num_decoder_layers)]
        return [(a.k(enc), a.v(enc)) for a in attns]

    def forward(self, dec_embeds, enc, enc_mask, dec_mask=None,
                cache: Optional[DecodeCache] = None):
        """With ``cache``, a decode step: at the cache's first step ``enc``
        is projected into its cross-attention keys and values, which every
        step reads in place of ``enc`` and ``enc_mask``."""
        x = dec_embeds.to(self.dtype)
        position_bias = None
        if cache is not None and cache.cross is None:
            cache.cross = [(k.float(), v) for k, v in self.project_cross(enc)]
            cache.cross_mask = enc_mask.bool()
        for i in range(self.cfg.num_decoder_layers):
            block = getattr(self, f"block{i}")
            if cache is None:
                x, position_bias = _run_block(block, self.cfg.remat, x, enc, enc_mask,
                                              dec_mask, position_bias)
            else:
                x, position_bias = block(x, None, cache.cross_mask, dec_mask, position_bias,
                                         cache.layers[i], cache.index, cache.cross[i])
        if cache is not None:
            cache.index += x.shape[1]
        return self.final_norm(x)


class T5ForConditionalGeneration(nn.Module):
    def __init__(self, cfg: T5Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.shared = Embed(cfg.vocab_size, cfg.d_model, dtype)
        self.encoder = T5Encoder(cfg, dtype)
        self.decoder = T5Decoder(cfg, dtype)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, dtype, bias=False)
        self.decode_graphs = DecodeGraphs()

    def embed(self, ids):
        return self.shared(ids)

    @spanned("t5.encoder")
    def encode(self, inputs_embeds, mask):
        return self.encoder(inputs_embeds, mask)

    def _logits(self, x):
        if self.cfg.tie_word_embeddings:
            x = x * (self.cfg.d_model ** -0.5)
            return x @ self.shared.weight.to(x.dtype).T
        return self.lm_head(x)

    def decode_train(self, enc, enc_mask, decoder_input_ids, dec_mask):
        x = self.decoder(self.shared(decoder_input_ids), enc, enc_mask, dec_mask)
        return self._logits(x)

    def init_cache(self, batch: int, device=None) -> DecodeCache:
        cfg = self.cfg
        shape = (batch, cfg.num_heads, cfg.max_answer_len, cfg.d_kv)
        device = device or self.shared.weight.device
        return DecodeCache([{"key": torch.zeros(shape, dtype=self.dtype, device=device),
                             "value": torch.zeros(shape, dtype=self.dtype, device=device)}
                            for _ in range(cfg.num_decoder_layers)])

    def decode_step(self, enc, enc_mask, token_ids, cache: DecodeCache):
        """One decode step through ``cache`` (token_ids [B, 1]); ``enc`` and
        ``enc_mask`` are read at the cache's first step only
        (:meth:`T5Decoder.forward`)."""
        x = self.decoder(self.shared(token_ids), enc, enc_mask, None, cache=cache)
        return self._logits(x)

    def forward(self, inputs_embeds, enc_mask, decoder_input_ids, dec_mask):
        """Teacher-forced training forward -> logits [B, Ld, V]."""
        enc = self.encode(inputs_embeds, enc_mask)
        return self.decode_train(enc, enc_mask, decoder_input_ids, dec_mask)


def shift_right(labels: torch.Tensor, start_id: int, pad_id: int) -> torch.Tensor:
    """Decoder inputs = labels shifted right with the start token."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[:, 0] = start_id
    return torch.where(shifted == -100, torch.full_like(shifted, pad_id), shifted)


def t5_cross_entropy(logits, labels, label_mask, axis: Optional[str] = None
                     ) -> torch.Tensor:
    """Token-mean CE ignoring masked labels (HF -100 convention); with
    ``axis`` this process's term of the global batch's token mean
    (``collectives.token_mean``): the processes' answers differ in length,
    so the mean of their own token means is not the global one."""
    safe = torch.where(labels < 0, torch.zeros_like(labels), labels)
    per = F.cross_entropy(logits.float().flatten(0, -2), safe.flatten().long(),
                          reduction="none").view(labels.shape)
    m = label_mask.float()
    if axis is not None:
        return collectives.token_mean((per * m).sum(), m.sum())
    return (per * m).sum() / m.sum().clamp(min=1.0)


def apply_repetition_penalty(logits, seen, penalty: float):
    """HF RepetitionPenaltyLogitsProcessor: previously generated tokens'
    scores divide by ``penalty`` when positive, multiply when negative."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, pen, logits)


def _topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, ``u`` uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = draw(torch.rand, shape, generator=generator, device=device).clamp(min=tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def sample_decode(model: T5ForConditionalGeneration, inputs_embeds, enc_mask,
                  max_len: int, decoder_start_id: int, eos_id: int, pad_id: int,
                  generator: Optional[torch.Generator] = None, top_p: float = 0.9,
                  temperature: float = 1.0, min_length: int = 1,
                  repetition_penalty: float = 1.0,
                  gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nucleus (top-p) sampling: keep the smallest prefix of the sorted
    distribution whose cumulative probability exceeds ``top_p``, then draw
    ``argmax(logits + Gumbel noise)`` (a categorical draw). ``gumbel`` [max_len,
    B, V] gives the noise of every step; without it the noise comes from
    ``generator``. Returns int64 [B, max_len] (pad after EOS)."""
    B = inputs_embeds.shape[0]
    dev = inputs_embeds.device
    enc = model.encode(inputs_embeds, enc_mask)
    cache = model.init_cache(B, dev)
    vocab = model.cfg.vocab_size
    rows = torch.arange(B, device=dev)
    out = torch.full((B, max_len), pad_id, dtype=torch.long, device=dev)
    tok = torch.full((B, 1), decoder_start_id, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    seen = torch.zeros(B, vocab, dtype=torch.bool, device=dev)
    for i in range(max_len):
        if bool(done.all()):
            break
        lg = model.decode_step(enc, enc_mask, tok, cache)[:, -1].float() / temperature
        if repetition_penalty != 1.0:
            lg = apply_repetition_penalty(lg, seen, repetition_penalty)
        if i + 1 < min_length:
            lg[:, eos_id] = NEG_INF
        # top-p on the sorted distribution; the first token crossing the
        # threshold is kept (HF's shifted remove-mask)
        sorted_lg, order = torch.sort(lg, dim=-1, descending=True, stable=True)
        probs = F.softmax(sorted_lg, dim=-1)
        remove_sorted = (probs.cumsum(-1) - probs) >= top_p
        remove = torch.zeros_like(remove_sorted).scatter(1, order, remove_sorted)
        lg = torch.where(remove, torch.tensor(NEG_INF, device=dev), lg)
        noise = (gumbel[i].to(dev) if gumbel is not None
                 else gumbel_noise(lg.shape, generator, dev))
        nxt = (lg + noise).argmax(-1)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        out[:, i] = nxt
        seen[rows, nxt] = True
        done = done | (nxt == eos_id)
        tok = nxt[:, None]
    return out


@torch.no_grad()
def beam_search_decode(model: T5ForConditionalGeneration, inputs_embeds, enc_mask,
                       max_len: int, decoder_start_id: int, eos_id: int, pad_id: int,
                       num_beams: int = 5, length_penalty: float = 1.0,
                       min_length: int = 1) -> torch.Tensor:
    """Beam search with HF ``generate``'s semantics, as the reference's
    fixed-shape loop runs it: 2M candidates a step, EOS candidates among the
    top M finish with score ``sum_logprobs / len**alpha`` (len = start token
    + generated so far), the top M others continue; on the last step every
    top-M candidate finishes; a batch is done (and stays done) once it holds
    M finished hypotheses that the best running beam can no longer beat.
    Returns int64 [B, max_len] (EOS kept, pad after)."""
    B = inputs_embeds.shape[0]
    M = num_beams
    dev = inputs_embeds.device
    enc = model.encode(inputs_embeds, enc_mask)
    enc_rep = enc.repeat_interleave(M, dim=0)
    mask_rep = enc_mask.repeat_interleave(M, dim=0)
    cache = model.init_cache(B * M, dev)
    NEG = torch.tensor(NEG_INF, device=dev)

    tokens = torch.full((B, M), decoder_start_id, dtype=torch.long, device=dev)
    run_score = torch.tensor([0.0] + [NEG_INF] * (M - 1), device=dev).repeat(B, 1)
    seqs = torch.full((B, M, max_len), pad_id, dtype=torch.long, device=dev)
    fin_seqs = seqs.clone()
    fin_scores = torch.full((B, M), NEG_INF, device=dev)
    n_fin = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    ident = torch.arange(M, device=dev)[None].expand(B, M)
    top_rank = (torch.arange(2 * M, device=dev) < M)[None]
    for step in range(max_len):
        if bool(done.all()):
            break
        logits = model.decode_step(enc_rep, mask_rep, tokens.reshape(B * M, 1), cache)
        logp = F.log_softmax(logits[:, -1].float(), dim=-1)
        vocab = logp.shape[-1]
        if step + 1 < min_length:
            logp[:, eos_id] = NEG_INF
        flat = (run_score[:, :, None] + logp.reshape(B, M, vocab)).reshape(B, M * vocab)
        top2, idx2 = _topk_stable(flat, 2 * M)
        beam2 = torch.div(idx2, vocab, rounding_mode="floor")
        tok2 = idx2 % vocab
        hits = (tok2 == eos_id) | (step == max_len - 1)

        # finish the hit candidates among the top M ranks
        denom = float(step + 1) ** length_penalty
        fin_mask = hits & top_rank & ~done[:, None]
        eos_fin_scores = torch.where(fin_mask, top2 / denom, NEG)
        cand_fin = torch.gather(seqs, 1, beam2[:, :, None].expand(-1, -1, max_len))
        cand_fin[:, :, step] = tok2
        all_scores = torch.cat([fin_scores, eos_fin_scores], dim=1)
        all_seqs = torch.cat([fin_seqs, cand_fin], dim=1)
        fin_scores, keep_i = _topk_stable(all_scores, M)
        fin_seqs = torch.gather(all_seqs, 1, keep_i[:, :, None].expand(-1, -1, max_len))
        n_fin = n_fin + fin_mask.long().sum(1)

        # survivors: the top M candidates that did not finish
        sel_s, sel_i = _topk_stable(torch.where(hits, NEG, top2), M)
        sel_beam = torch.gather(beam2, 1, sel_i)
        sel_tok = torch.gather(tok2, 1, sel_i)
        sel_beam = torch.where(done[:, None], ident, sel_beam)
        sel_tok = torch.where(done[:, None], torch.full_like(sel_tok, pad_id), sel_tok)
        run_score = torch.where(done[:, None], run_score, sel_s)
        seqs = torch.gather(seqs, 1, sel_beam[:, :, None].expand(-1, -1, max_len))
        seqs[:, :, step] = torch.where(done[:, None], seqs[:, :, step], sel_tok)
        cache.reorder((torch.arange(B, device=dev)[:, None] * M + sel_beam).reshape(-1))
        # HF latches the early stop: a batch once done stays done
        best_possible = run_score[:, 0] / float(max(step + 1, 1)) ** length_penalty
        done = done | ((n_fin >= M) & (fin_scores[:, -1] >= best_possible))
        tokens = sel_tok
    best = fin_scores.argmax(1)
    return fin_seqs[torch.arange(B, device=dev), best]


class GreedyBuffers(GreedyTokens):
    """The static state of one greedy decode shape: every layer's cache
    slots (views of one flat buffer), its cross-attention keys and values
    over the encoder output with the mask, and the tokens
    (:class:`GreedyTokens`)."""

    def __init__(self, model: T5ForConditionalGeneration, enc: torch.Tensor,
                 enc_mask: torch.Tensor, max_len: int):
        cfg, (B, L), dev = model.cfg, enc.shape[:2], enc.device
        super().__init__(B, max_len, dev)
        self.decoder = model.decoder
        n, inner = cfg.num_decoder_layers, cfg.num_heads * cfg.d_kv
        self.slots = torch.empty((n, 2, B, cfg.num_heads, cfg.max_answer_len, cfg.d_kv),
                                 dtype=model.dtype, device=dev)
        keys = torch.empty((n, B, L, inner), dtype=torch.float32, device=dev)
        values = torch.empty((n, B, L, inner), dtype=model.dtype, device=dev)
        self.cache = DecodeCache([{"key": kv[0], "value": kv[1]} for kv in self.slots.unbind(0)],
                                 cross=list(zip(keys.unbind(0), values.unbind(0))),
                                 cross_mask=torch.empty((B, L), dtype=torch.bool, device=dev))

    def load(self, enc, enc_mask, start_id: int, pad_id: int) -> None:
        """A new batch: its cross-attention keys and values projected into
        the buffers (the keys cast to float32 by the copy) with its mask, the
        slots zeroed, nothing emitted."""
        for (k, v), (k_buf, v_buf) in zip(self.decoder.project_cross(enc), self.cache.cross):
            k_buf.copy_(k)
            v_buf.copy_(v)
        self.cache.cross_mask.copy_(enc_mask)
        self.slots.zero_()
        self.reset(start_id, pad_id)


def greedy_step(model: T5ForConditionalGeneration, b: GreedyBuffers, i: int,
                eos_id: int, pad_id: int, check: bool) -> torch.Tensor:
    """Greedy step ``i`` on ``b``, in place and without a host read
    (:meth:`GreedyTokens.emit`). Returns the step's logits."""
    b.cache.index = i
    logits = model.decode_step(None, None, b.tok, b.cache)
    b.emit(i, logits[:, -1], eos_id, pad_id, check)
    return logits


class CapturedDecode:
    """One key's buffers and its step graphs, one a step index, in one
    memory pool; ``logits[i]``: step ``i``'s output in that pool."""

    def __init__(self, model: T5ForConditionalGeneration, enc, enc_mask, max_len: int,
                 start_id: int, eos_id: int, pad_id: int):
        global decode_graph_captures
        self.buffers = b = GreedyBuffers(model, enc, enc_mask, max_len)
        b.load(enc, enc_mask, start_id, pad_id)
        self.graphs, self.logits = capture_steps(
            lambda i, check: greedy_step(model, b, i, eos_id, pad_id, check),
            range(max_len), enc.device)
        decode_graph_captures += len(self.graphs)

    def replay(self, i: int) -> None:
        global decode_graph_replays
        self.graphs[i].replay()
        decode_graph_replays += 1


def decode_modules(model: T5ForConditionalGeneration) -> tuple:
    """The modules a decode step reads."""
    return model.decoder, model.shared, model.lm_head


def decode_storage(model: T5ForConditionalGeneration) -> tuple:
    """Where the decode step's parameters and buffers live: the captured
    graphs read them through these addresses."""
    return storage(decode_modules(model))


class DecodeGraphs(GraphCache):
    """A model's captured greedy decodes (``models/step_graphs.py``), keyed
    ``(B, L_enc, max_len, dtype, mask dtype, eos, pad, device, inference
    mode)`` and dropped when :func:`decode_storage` moved."""

    def get(self, model: T5ForConditionalGeneration, enc, enc_mask, max_len: int,
            start_id: int, eos_id: int, pad_id: int) -> Optional[CapturedDecode]:
        """This call's captured decode, captured at its key's first call; None
        where the steps run eagerly: CPU tensors, grad on, a stream capturing."""
        if eager(enc.device):
            return None
        key = (*enc.shape[:2], max_len, enc.dtype, enc_mask.dtype, eos_id, pad_id,
               enc.device, torch.is_inference_mode_enabled())
        return self.lookup(key, decode_modules(model), lambda: CapturedDecode(
            model, enc, enc_mask, max_len, start_id, eos_id, pad_id))


@torch.no_grad()
def greedy_decode(model: T5ForConditionalGeneration, inputs_embeds, enc_mask,
                  max_len: int, decoder_start_id: int, eos_id: int, pad_id: int
                  ) -> torch.Tensor:
    """Greedy generation (beam 1). Returns int64 [B, max_len] (pad after
    EOS); stops once every row has emitted EOS. Each step replays its
    captured graph where :meth:`DecodeGraphs.get` gives one, else runs
    :func:`greedy_step` eagerly."""
    enc = model.encode(inputs_embeds, enc_mask)
    captured = model.decode_graphs.get(model, enc, enc_mask, max_len, decoder_start_id,
                                       eos_id, pad_id)
    b = captured.buffers if captured else GreedyBuffers(model, enc, enc_mask, max_len)
    b.load(enc, enc_mask, decoder_start_id, pad_id)
    return greedy_loop(b, range(max_len),
                       lambda i, check: greedy_step(model, b, i, eos_id, pad_id, check),
                       captured.replay if captured else None, "t5.decode_step")
