"""UniVS video transformer decoder (counterpart of
``univs_tpu/models/decoder.py``), tasks 'detection' (learnable queries,
or category text prompts), 'sot' (visual prompts through ProCA) and
'grounding' (RefVOS expressions as text prompts).

Batch-major tokens ``[B*T, Q, C]``; the spatio-temporal self-attention
runs on ``[B, Q*T, C]`` with a static block bias (q-major tokens); the
masked cross-attention's allow-mask comes from the previous layer's mask
logits computed at the attention resolution from PRE-DOWNSAMPLED mask
features (bilinear resize is linear, so this equals resizing the
full-resolution logits).  ProCA applies no kv mask: blank entries attend
as zero-vector tokens, as in the reference.  Text prompts are projected
to the vision width (``text_norm`` -> ``text2vis_projection``), attend
to every level's tokens of each frame (``lang2vision``), and their
sentence token becomes the prompt query; at inference the grounding
task fuses each prompt query's masks with those of its most similar
learnable query (l4p), on the full-resolution masks and on the next
layer's attention mask alike.  Module names follow the flax tree so the
weight bridge maps them one to one.

Training (``train=True``, JAX ``decoder.py:325-350,428,558``): every
supervised layer's outputs are returned (``aux_outputs``); the mask
embeddings are shuffled over frames by a drawn permutation per head call
(``shuffle_perms``, drawn by the caller at the JAX package's
``make_rng("shuffle")`` addresses); grounding logits are divided by the
width; no l4p fusion; the text prompts' head-averaged lang->vision
attention weights come back as ``l2v_attn_weights``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from univs_tpu_torch.models.transformer_layers import (
    MLP,
    NEG_INF,
    CrossAttentionBlock,
    FFNBlock,
    SelfAttentionBlock,
)
from univs_tpu_torch.ops.position_encoding import SinePositionEncoding3D
from univs_tpu_torch.structures import TextPrompts, VisualPrompts


def build_self_attn_bias(num_learnable: int, num_prompt: int, t: int, mask_type: str, task: str,
                         device=None) -> Optional[torch.Tensor]:
    """Static (Q*T, Q*T) additive bias [1, 1, QT, QT] for the
    spatio-temporal self-attention (token = q*T + t'); semantics per
    decoder_univs.py:824-848."""
    if mask_type in ("none", "all"):
        return None
    Ql, Qp = num_learnable, num_prompt
    n = (Ql + Qp) * t
    disallow = np.ones((n, n), dtype=bool)
    disallow[: Ql * t, : Ql * t] = False
    if mask_type == "sep-blocked" or task == "grounding":
        for k in range(Qp):
            s = Ql * t + k * t
            disallow[s: s + t, s: s + t] = False
    elif mask_type == "sep":
        disallow[Ql * t:, Ql * t:] = False
    elif mask_type == "sep-l2p":
        disallow[Ql * t:, :] = False
    else:
        raise ValueError(mask_type)
    bias = np.where(disallow, NEG_INF, 0.0).astype(np.float32)
    return torch.as_tensor(bias, device=device)[None, None]


def draw_shuffle_perms(key, num_layers: int, t: int):
    """The temporal query shuffle's permutations of one training forward,
    one per head call, at the addresses of flax's
    ``make_rng("shuffle")`` in the decoder (``decoder.py:326``)."""
    return [key.static("decoder", k + 1).permutation(t) for k in range(num_layers + 1)]


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


class UniVSDecoder(nn.Module):
    def __init__(self, hidden_dim=256, num_queries=200, num_layers=9, num_heads=8, ffn_dim=2048,
                 pre_norm=False, mask_dim=256, num_feature_levels=3, text_emb_dim=640,
                 self_attn_mask_type="sep", num_max_frames=128, l4p_fusion=True,
                 temporal_query_shuffle=True, remat_heads=False):
        super().__init__()
        self.remat_heads = remat_heads
        C = hidden_dim
        self.hidden_dim = C
        self.num_queries = num_queries
        self.num_layers = num_layers
        self.num_feature_levels = num_feature_levels
        self.self_attn_mask_type = self_attn_mask_type
        self.l4p_fusion = l4p_fusion
        self.temporal_query_shuffle = temporal_query_shuffle
        self.query_feat = nn.Parameter(torch.zeros(num_queries, C))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, C))
        self.level_embed = nn.Parameter(torch.zeros(num_feature_levels, C))
        self.cls_temp = nn.Parameter(torch.full((1,), math.log(1 / 0.07)))
        self.reid_temp = nn.Parameter(torch.full((1,), math.log(1 / 0.07)))
        self.prompt_detection = nn.Parameter(torch.zeros(C))
        self.prompt_sot = nn.Parameter(torch.zeros(C))
        self.prompt_grounding = nn.Parameter(torch.zeros(C))
        for i in range(num_layers):
            setattr(self, f"cross_{i}", CrossAttentionBlock(C, num_heads, pre_norm))
            setattr(self, f"self_{i}", SelfAttentionBlock(C, num_heads, pre_norm))
            setattr(self, f"ffn_{i}", FFNBlock(C, ffn_dim, pre_norm))
            setattr(self, f"proca_{i}", CrossAttentionBlock(C, num_heads, False))
        self.decoder_norm = nn.LayerNorm(C, eps=1e-5)
        self.mask_embed = MLP(C, C, mask_dim, 3)
        self.vis2text_projection = nn.Linear(C, text_emb_dim)
        self.text_norm = nn.LayerNorm(text_emb_dim, eps=1e-5)
        self.text2vis_projection = nn.Linear(text_emb_dim, C)
        self.lang2vision = CrossAttentionBlock(C, num_heads, False)
        self.pe3d = SinePositionEncoding3D(num_pos_feats=C // 2, mode="arbitrary",
                                           num_max_frames=num_max_frames)

    # ------------------------------------------------------------------

    def _pe(self, t, h, w, frame_indices) -> torch.Tensor:
        """[B, T, H, W, C] ArbitraryT PE per video (z from absolute frames)."""
        return torch.stack([self.pe3d.grid(t, h, w, t_indices=fi) for fi in frame_indices])

    def prompt_feature_grid(self, x_finest: torch.Tensor, frame_indices: torch.Tensor):
        """1/8-level src tokens (+level embed) and their 3D PE as grids:
        x_finest [B*T, H, W, C] -> (feats [B, T, H, W, C], pos [B, T, H, W, C])."""
        b, t = frame_indices.shape
        _, h, w, C = x_finest.shape
        feats = x_finest + self.level_embed[self.num_feature_levels - 1].to(x_finest.dtype)
        pos = self._pe(t, h, w, frame_indices)
        return feats.reshape(b, t, h, w, C), pos.to(x_finest.dtype)

    def _encode_text_prompts(self, text_prompts: TextPrompts, src_all: torch.Tensor, b: int,
                             t: int, need_l2v_weights: bool = False):
        """Text embeddings [B, Qp, L, Dt] -> vision space, lang->vision
        cross-attention over every level's tokens of each frame
        (src_all [B*T, S, C]; decoder_univs.py:659-744).  Returns
        (queries [B, Qp, T, C] = the sentence token = query_pos, kv
        [B, Qp, L, T, C], kv_valid [B, Qp, L, T], the head-averaged
        attention weights [B*T, Qp*L, S] or None)."""
        B, Qp, L, _ = text_prompts.embs.shape
        dtype = self.query_feat.dtype
        proj = self.text2vis_projection(self.text_norm(text_prompts.embs.to(dtype)))
        C = proj.shape[-1]
        x = proj[:, None].expand(B, t, Qp, L, C).reshape(b * t, Qp * L, C)
        l2v_w = None
        if need_l2v_weights:
            x, l2v_w = self.lang2vision(x, src_all, return_weights=True)
        else:
            x = self.lang2vision(x, src_all)
        kv = x.reshape(b, t, Qp, L, C).permute(0, 2, 3, 1, 4)  # [B, Qp, L, T, C]
        queries = kv[:, :, 0]  # the sentence token leads each stack
        if text_prompts.word_valid is not None:
            kv_valid = text_prompts.word_valid[..., None].expand(B, Qp, L, t)
        else:
            kv_valid = text_prompts.valid[:, :, None, None].expand(B, Qp, L, t)
        return queries, kv, kv_valid, l2v_w

    def _proca(self, i, output, query_pos, kv, kv_pe, b, t):
        """Prompt cross-attention over each prompt's [self; L kv] set (no
        kv mask — decoder_univs.py:456-496)."""
        Ql = self.num_queries
        Qp, L, C = kv.shape[1], kv.shape[2], output.shape[-1]
        out_p, pos_p = output[:, Ql:], query_pos[:, Ql:]
        layer = getattr(self, f"proca_{i}")
        if kv.shape[3] == 1 and t > 1:
            # frame-invariant kv: fold the T frames into the query axis; each
            # frame's query sees only its own token as the "self" key
            q = out_p.reshape(b, t, Qp, C).transpose(1, 2).reshape(b * Qp, t, C)
            qp_ = pos_p.reshape(b, t, Qp, C).transpose(1, 2).reshape(b * Qp, t, C)
            kv_sh = kv[:, :, :, 0].reshape(b * Qp, L, C)
            keys = torch.cat([q, kv_sh], dim=1)
            if kv_pe is not None:
                key_pos = torch.cat([qp_, kv_pe[:, :, :, 0].reshape(b * Qp, L, C)], dim=1)
                q_pos = qp_
            else:
                key_pos, q_pos = None, None
            eye = torch.eye(t, dtype=torch.bool, device=output.device)
            diag = torch.where(eye, 0.0, NEG_INF).to(torch.float32)
            bias = torch.cat([diag, torch.zeros((t, L), device=output.device)], dim=1)[None, None]
            new_p = layer(q, keys, query_pos=q_pos, pos=key_pos, bias=bias)
            new_p = new_p.reshape(b, Qp, t, C).transpose(1, 2).reshape(b * t, Qp, C)
            return torch.cat([output[:, :Ql], new_p], dim=1)

        kv_bt = kv.permute(0, 3, 1, 2, 4).reshape(b * t, Qp, L, C)
        keys = torch.cat([out_p[:, :, None], kv_bt], dim=2).reshape(b * t * Qp, 1 + L, C)
        if kv_pe is not None:
            pe_bt = kv_pe.permute(0, 3, 1, 2, 4).reshape(b * t, Qp, L, C)
            key_pos = torch.cat([pos_p[:, :, None], pe_bt], dim=2).reshape(b * t * Qp, 1 + L, C)
            q_pos = pos_p.reshape(b * t * Qp, 1, C)
        else:
            key_pos, q_pos = None, None
        new_p = layer(out_p.reshape(b * t * Qp, 1, C), keys, query_pos=q_pos, pos=key_pos)
        return torch.cat([output[:, :Ql], new_p.reshape(b * t, Qp, C)], dim=1)

    def _prediction_heads(self, output, mask_features, mask_features_small, task, cls_emb,
                          exp_sentence, b, t, need_outputs, train=False, perm=None):
        """Per-layer heads + the next layer's boolean attention allow-mask
        [B*T, 1, Q, h*w] (decoder_univs.py:498-567).  Grounding scores
        each query against the raw sentence embeddings (divided by the
        width in training) and, at inference, applies the l4p fusion
        (decoder_univs.py:536-551) to the full-resolution masks and to
        the allow-mask's logits.  ``perm`` [T] (training) shuffles the
        mask embeddings over frames."""
        Q = output.shape[1]
        Ql = self.num_queries
        dec = self.decoder_norm(output)
        membed = self.mask_embed(dec).reshape(b, t, Q, -1)
        if perm is not None:
            membed = membed[:, perm.to(membed.device)]
        logits = masks = embds_raw = None
        if need_outputs:
            cls_feats = self.vis2text_projection(dec)
            if task != "grounding":
                logits = _normalize(cls_feats) @ _normalize(cls_emb).to(cls_feats.dtype).T
                logits = logits.reshape(b, t, Q, -1).mean(dim=1) * torch.exp(self.cls_temp)
            else:
                cf = cls_feats.reshape(b, t, Q, -1).mean(dim=1)
                logits = cf @ exp_sentence.to(cf.dtype).transpose(1, 2)  # [B, Q, Qe]
                if train:
                    logits = logits / dec.shape[-1]
            H, W, Cm = mask_features.shape[2:]
            masks = membed @ mask_features.reshape(b, t, H * W, Cm).transpose(-1, -2)
            masks = masks.reshape(b, t, Q, H, W).transpose(1, 2)  # [B, Q, T, H, W]
            embds_raw = dec.reshape(b, t, Q, -1).transpose(1, 2)

        l4p_idx = None
        if not train and task == "grounding" and self.l4p_fusion and Q > Ql:
            norm = _normalize(dec)
            sim = (norm @ norm[:, Ql:].transpose(1, 2)).reshape(b, t, Q, -1).mean(dim=1)
            l4p_idx = torch.argmax(sim[:, :Ql], dim=1)  # [B, Qp], first maximum
            if need_outputs:
                learn = torch.take_along_dim(masks, l4p_idx[:, :, None, None, None], dim=1)
                masks = torch.cat([masks[:, :Ql], (masks[:, Ql:] + learn) / 2.0], dim=1)

        h, w, Cm = mask_features_small.shape[2:]
        m_small = membed @ mask_features_small.reshape(b, t, h * w, Cm).transpose(-1, -2)
        m_small = m_small.to(torch.float32)  # [B, T, Q, hw]
        if l4p_idx is not None:  # mirror the fusion on the allow-mask's logits
            learn = torch.take_along_dim(m_small, l4p_idx[:, None, :, None], dim=2)
            m_small = torch.cat([m_small[:, :, :Ql], (m_small[:, :, Ql:] + learn) / 2.0], dim=2)
        allowed = torch.sigmoid(m_small) >= 0.5
        allowed = allowed | ~allowed.any(dim=-1, keepdim=True)
        bias = allowed.reshape(b * t, 1, Q, h * w)
        return logits, masks, embds_raw, bias

    def forward(self, x_levels: Sequence[torch.Tensor], mask_features: torch.Tensor,
                frame_indices: torch.Tensor, task: str = "detection",
                visual_prompts: Optional[VisualPrompts] = None,
                cls_emb: Optional[torch.Tensor] = None,
                text_prompts: Optional[TextPrompts] = None, train: bool = False,
                shuffle_perms=None) -> Dict:
        """x_levels: 3 maps [B*T, H_l, W_l, C] coarse to fine; mask_features
        [B*T, H/4, W/4, Cm]; frame_indices [B, T]; task 'detection' |
        'sot' | 'grounding'; cls_emb [K, Dt] (the class bank, unless
        grounding).  Returns 'pred_logits', 'pred_masks', 'pred_embds',
        'aux_outputs' (training: one dict per earlier supervised layer)
        and in training with text prompts 'l2v_attn_weights'.
        ``shuffle_perms``: training's num_layers + 1 frame permutations
        (``draw_shuffle_perms``), one per head call."""
        assert len(x_levels) == self.num_feature_levels
        C = self.hidden_dim
        dtype = self.query_feat.dtype
        bt = x_levels[0].shape[0]
        b, t = frame_indices.shape
        assert b * t == bt, (b, t, bt)
        hm, wm = mask_features.shape[1:3]
        mask_features = mask_features.reshape(b, t, hm, wm, -1)

        srcs, poss, sizes = [], [], []
        for i, x in enumerate(x_levels):
            _, h, w, cin = x.shape
            assert cin == C, "input_proj is identity (in_channels == hidden_dim)"
            sizes.append((h, w))
            poss.append(self._pe(t, h, w, frame_indices).reshape(bt, h * w, C).to(dtype))
            srcs.append(x.reshape(bt, h * w, C) + self.level_embed[i][None, None])

        Ql = self.num_queries
        output = self.query_feat[None].expand(bt, Ql, C)
        query_pos = self.query_embed[None].expand(bt, Ql, C)

        prompts = None
        aux_l2v = None
        if task in ("detection", "grounding") and text_prompts is not None:
            q, kv, kv_valid, aux_l2v = self._encode_text_prompts(
                text_prompts, torch.cat(srcs, dim=1), b, t, need_l2v_weights=train)
            if task == "grounding" and visual_prompts is not None:
                # prev-clip visual kv AHEAD of the text tokens per expression
                # (decoder_univs.py:736-748); no pe on the text path
                vkv, vkvv = visual_prompts.kv, visual_prompts.kv_valid
                if vkv.shape[3] == 1 and t > 1:
                    vkv = vkv.expand(*vkv.shape[:3], t, vkv.shape[4])
                    vkvv = vkvv.expand(*vkvv.shape[:3], t)
                kv = torch.cat([vkv.to(kv.dtype), kv], dim=2)
                kv_valid = torch.cat([vkvv.to(kv_valid.dtype), kv_valid], dim=2)
            prompts = VisualPrompts(queries=q, query_pos=q, kv=kv, kv_pe=None, kv_valid=kv_valid,
                                    valid=text_prompts.valid)
            task_emb = self.prompt_detection if task == "detection" else self.prompt_grounding
        elif visual_prompts is not None:
            prompts = visual_prompts
            task_emb = self.prompt_sot
        Qp = 0
        kv = kv_pe = None
        if prompts is not None:
            # the memory pool holds float32; the decoder runs in its dtype
            Qp = prompts.num_prompts
            kv = prompts.kv.to(dtype)
            kv_pe = None if prompts.kv_pe is None else prompts.kv_pe.to(dtype)
            pq = (prompts.queries.to(dtype) + task_emb).transpose(1, 2).reshape(bt, Qp, C)
            pqp = prompts.query_pos.to(dtype).transpose(1, 2).reshape(bt, Qp, C)
            output = torch.cat([output, pq], dim=1)
            query_pos = torch.cat([query_pos, pqp], dim=1)
            output = self._proca(0, output, query_pos, kv, kv_pe, b, t)
            query_pos = torch.cat([query_pos[:, :Ql], output[:, Ql:]], dim=1)
        # sentence embedding per expression in CLIP space (pre-projection)
        exp_sentence = None
        if task == "grounding" and text_prompts is not None:
            exp_sentence = text_prompts.embs[:, :, 0]  # [B, Qe, Dt]

        # pre-downsampled mask features per attention level
        Cm = mask_features.shape[-1]
        mf = mask_features.to(torch.float32).reshape(bt, hm, wm, Cm).permute(0, 3, 1, 2)
        mf_small = [
            F.interpolate(mf, size=(h, w), mode="bilinear", align_corners=False)
            .permute(0, 2, 3, 1).reshape(b, t, h, w, Cm).to(mask_features.dtype)
            for (h, w) in sizes
        ]

        shuffle = train and self.temporal_query_shuffle and t > 1
        if shuffle and shuffle_perms is None:
            raise ValueError("training with the temporal query shuffle needs shuffle_perms")
        calls = iter(range(self.num_layers + 1))

        # activation checkpointing of the heads in training (JAX
        # ``remat_heads``: nn.remat of _prediction_heads): the full-resolution
        # mask logits are recomputed in the backward.  The heads draw nothing
        # (the shuffle permutation comes in drawn), so the recompute is exact
        remat = self.remat_heads and train and torch.is_grad_enabled()

        def heads(out_tokens, mfs, need):
            k = next(calls)
            args = (out_tokens, mask_features, mfs, task, cls_emb, exp_sentence, b, t, need, train,
                    shuffle_perms[k] if shuffle else None)
            if remat:
                return checkpoint(self._prediction_heads, *args, use_reentrant=False)
            return self._prediction_heads(*args)

        logits, masks, embds_raw, attn_bias = heads(output, mf_small[0], train)
        all_preds = [(logits, masks, embds_raw)]

        self_bias = build_self_attn_bias(Ql, Qp, t, self.self_attn_mask_type, task,
                                         device=output.device)
        if prompts is not None:
            tok_valid = torch.cat([torch.ones((b, Ql), dtype=torch.bool, device=output.device),
                                   prompts.valid.to(torch.bool)], dim=1)
            tok_valid = tok_valid.repeat_interleave(t, dim=1)
            col_bias = torch.where(tok_valid, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]
            n_tok = tok_valid.shape[1]
            eye = torch.eye(n_tok, dtype=torch.bool, device=output.device)[None, None]
            base = 0.0 if self_bias is None else self_bias
            self_bias = torch.where(eye, 0.0, base + col_bias)

        for i in range(self.num_layers):
            if prompts is not None and i > 0:
                output = self._proca(i, output, query_pos, kv, kv_pe, b, t)
            li = i % self.num_feature_levels
            output = getattr(self, f"cross_{i}")(output, srcs[li], query_pos=query_pos,
                                                 pos=poss[li], bias=attn_bias)
            Qtot = output.shape[1]
            o = output.reshape(b, t, Qtot, C).transpose(1, 2).reshape(b, Qtot * t, C)
            qp_ = query_pos.reshape(b, t, Qtot, C).transpose(1, 2).reshape(b, Qtot * t, C)
            o = getattr(self, f"self_{i}")(o, pos=qp_, bias=self_bias)
            output = o.reshape(b, Qtot, t, C).transpose(1, 2).reshape(bt, Qtot, C)
            output = getattr(self, f"ffn_{i}")(output)
            final = i == self.num_layers - 1
            logits, masks, embds_raw, attn_bias = heads(
                output, mf_small[(i + 1) % self.num_feature_levels], train or final)
            all_preds.append((logits, masks, embds_raw))

        def to_out(p):
            return {"pred_logits": p[0], "pred_masks": p[1], "pred_embds": p[2]}

        out = to_out(all_preds[-1])
        out["aux_outputs"] = [to_out(p) for p in all_preds[:-1]] if train else []
        if aux_l2v is not None:
            out["l2v_attn_weights"] = aux_l2v
        if prompts is not None:
            out["prompt_valid"] = prompts.valid
        return out
