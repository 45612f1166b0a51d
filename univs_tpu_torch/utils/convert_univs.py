"""Full UniVS checkpoint conversion: reference .pth -> the flax-shaped
tree of the UniVS model (the port's copy of
``univs_tpu/utils/convert_univs.py``; ``utils/weights.state_dict_from_flax``
turns the tree into the port's state_dict).

Maps the reference's released checkpoint naming (e.g.
``univs_r50_stage3_f7_wosquare_ema.pth``) onto the UniVSModel param
tree.  Name sources (reference):
- backbone: d2 ResNet "backbone.stem/res{2-5}" (utils/convert.py) or
  Swin "backbone.*";
- pixel decoder: "sem_seg_head.pixel_decoder.{input_proj.N.{0,1},
  transformer.level_embed, transformer.encoder.layers.N.{self_attn.*,
  norm1, linear1, linear2, norm2}, mask_features, adapter_1, layer_1}"
  (msdeformattn.py:214-294);
- predictor: "sem_seg_head.predictor.{query_feat, query_embed,
  level_embed, transformer_{self,cross}_attention_layers.N,
  transformer_ffn_layers.N, transformer_prompt_self_attention_layers.N,
  decoder_norm, mask_embed.layers.N, vis2text_projection, text_norm,
  text2vis_projection, cls_temp, reid_temp, prompt_{detection,sot,
  grounding}, lang2vision_cross_attention_layer}"
  (decoder_univs.py:122-228), with the historical
  'static_query'->'query_feat' rename shim (:32-53).

EMA teacher weights ("teacher." prefixes / *_ema checkpoints that
duplicate the student) are selected with ``prefer_ema``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from univs_tpu_torch.utils.convert import (
    _layernorm,
    _linear,
    convert_resnet,
    split_inproj,
)


def _strip_prefixes(sd: Dict[str, np.ndarray], prefer_ema: bool = True) -> Dict[str, np.ndarray]:
    out = {}
    has_ema = any(k.startswith(("teacher.", "model_teacher.")) for k in sd)
    for k, v in sd.items():
        if k == "static_query" or ".static_query" in k:
            k = k.replace("static_query", "query_feat")
        if has_ema and prefer_ema:
            if k.startswith("teacher."):
                out[k[len("teacher."):]] = v
            elif k.startswith("model_teacher."):
                out[k[len("model_teacher."):]] = v
        elif not k.startswith(("teacher.", "model_teacher.")):
            out[k] = v
    return out or sd


def convert_pixel_decoder(sd: Dict[str, np.ndarray], num_layers: int = 6) -> Dict:
    """'sem_seg_head.pixel_decoder.*' -> MSDeformAttnPixelDecoder params."""
    p = "sem_seg_head.pixel_decoder."
    out: Dict = {}
    # input projections (top-down order, conv1x1 + GN)
    i = 0
    while f"{p}input_proj.{i}.0.weight" in sd:
        w = sd[f"{p}input_proj.{i}.0.weight"]  # [C, Cin, 1, 1]
        out[f"input_proj_{i}"] = {
            "kernel": np.transpose(w, (2, 3, 1, 0)),
            "bias": sd[f"{p}input_proj.{i}.0.bias"],
        }
        out[f"input_proj_gn_{i}"] = {
            "scale": sd[f"{p}input_proj.{i}.1.weight"],
            "bias": sd[f"{p}input_proj.{i}.1.bias"],
        }
        out[f"level_embed_{i}"] = sd[f"{p}transformer.level_embed"][i]
        i += 1

    for li in range(num_layers):
        q = f"{p}transformer.encoder.layers.{li}."
        layer: Dict = {
            "self_attn": {
                "sampling_offsets": _linear(sd, q + "self_attn.sampling_offsets"),
                "attention_weights": _linear(sd, q + "self_attn.attention_weights"),
                "value_proj": _linear(sd, q + "self_attn.value_proj"),
                "output_proj": _linear(sd, q + "self_attn.output_proj"),
            },
            "norm1": _layernorm(sd, q + "norm1"),
            "linear1": _linear(sd, q + "linear1"),
            "linear2": _linear(sd, q + "linear2"),
            "norm2": _layernorm(sd, q + "norm2"),
        }
        out[f"encoder_layer_{li}"] = layer

    # FPN adapter/layer (reference numbers from 1)
    i = 0
    while f"{p}adapter_{i + 1}.weight" in sd:
        out[f"adapter_{i}"] = {"kernel": np.transpose(sd[f"{p}adapter_{i + 1}.weight"], (2, 3, 1, 0))}
        out[f"adapter_gn_{i}"] = {
            "scale": sd[f"{p}adapter_{i + 1}.norm.weight"],
            "bias": sd[f"{p}adapter_{i + 1}.norm.bias"],
        }
        out[f"layer_{i}"] = {"kernel": np.transpose(sd[f"{p}layer_{i + 1}.weight"], (2, 3, 1, 0))}
        out[f"layer_gn_{i}"] = {
            "scale": sd[f"{p}layer_{i + 1}.norm.weight"],
            "bias": sd[f"{p}layer_{i + 1}.norm.bias"],
        }
        i += 1
    out["mask_features"] = {
        "kernel": np.transpose(sd[f"{p}mask_features.weight"], (2, 3, 1, 0)),
        "bias": sd[f"{p}mask_features.bias"],
    }
    return out


def convert_pixel_decoder_vl(sd: Dict[str, np.ndarray], num_layers: int = 6) -> Dict:
    """'sem_seg_head.pixel_decoder.*' -> MSDeformAttnPixelDecoderVL
    params.  Same layout as :func:`convert_pixel_decoder` plus the
    per-layer VLFuse bi-attention stacks
    (reference: univs/modeling/pixel_decoder/msdeformattn_vl.py —
    ``transformer.encoder.vl_layers.{li}.b_attn``)."""
    out = convert_pixel_decoder(sd, num_layers=num_layers)
    p = "sem_seg_head.pixel_decoder."
    for li in range(num_layers):
        q = f"{p}transformer.encoder.vl_layers.{li}.b_attn."
        out[f"vl_fuse_{li}"] = {
            "layer_norm_v": _layernorm(sd, q + "layer_norm_v"),
            "layer_norm_l": _layernorm(sd, q + "layer_norm_l"),
            "gamma_v": sd[q + "gamma_v"],
            "gamma_l": sd[q + "gamma_l"],
            "attn": {
                name: _linear(sd, q + "attn." + name)
                for name in ("v_proj", "l_proj", "values_v_proj",
                             "values_l_proj", "out_v_proj", "out_l_proj")
            },
        }
    return out


def _conv(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """torch Conv2d [out, in/groups, kh, kw] -> flax [kh, kw, in/g, out]."""
    out = {"kernel": np.transpose(sd[prefix + ".weight"], (2, 3, 1, 0))}
    if prefix + ".bias" in sd:
        out["bias"] = sd[prefix + ".bias"]
    return out


def convert_pvt(sd: Dict[str, np.ndarray], depths=(3, 4, 6, 3),
                prefix: str = "backbone.") -> Dict:
    """Reference PVTv2 state dict -> :class:`PVTv2` params
    (mask2former/modeling/backbone/pvt_v2.py — ``patch_embed{i+1}``,
    ``block{i+1}.{j}``, ``norm{i+1}``)."""
    out: Dict = {}
    for s in range(4):
        p = f"{prefix}patch_embed{s + 1}."
        out[f"patch_embed{s}"] = _conv(sd, p + "proj")
        out[f"patch_norm{s}"] = _layernorm(sd, p + "norm")
        for b in range(depths[s]):
            q = f"{prefix}block{s + 1}.{b}."
            attn = {
                "q": _linear(sd, q + "attn.q"),
                "kv": _linear(sd, q + "attn.kv"),
                "proj": _linear(sd, q + "attn.proj"),
            }
            if q + "attn.sr.weight" in sd:
                attn["sr"] = _conv(sd, q + "attn.sr")
                attn["sr_norm"] = _layernorm(sd, q + "attn.norm")
            out[f"stage{s}_block{b}"] = {
                "norm1": _layernorm(sd, q + "norm1"),
                "attn": attn,
                "norm2": _layernorm(sd, q + "norm2"),
                "mlp": {
                    "fc1": _linear(sd, q + "mlp.fc1"),
                    "dwconv": _conv(sd, q + "mlp.dwconv.dwconv"),
                    "fc2": _linear(sd, q + "mlp.fc2"),
                },
            }
        out[f"out_norm{s}"] = _layernorm(sd, f"{prefix}norm{s + 1}")
    return out


def _attn_block(sd, prefix: str, d: int) -> Dict:
    """torch {Self,Cross}AttentionLayer -> {attn:{q,k,v,out}, norm}."""
    key = "self_attn" if f"{prefix}.self_attn.in_proj_weight" in sd else "multihead_attn"
    return {
        "attn": split_inproj(sd, f"{prefix}.{key}", d),
        "norm": _layernorm(sd, f"{prefix}.norm"),
    }


def convert_decoder(sd: Dict[str, np.ndarray], num_layers: int = 9, hidden: int = 256) -> Dict:
    """'sem_seg_head.predictor.*' -> UniVSDecoder params."""
    p = "sem_seg_head.predictor."
    out: Dict = {
        "query_feat": sd[p + "query_feat.weight"],
        "query_embed": sd[p + "query_embed.weight"],
        "level_embed": sd[p + "level_embed.weight"],
        "cls_temp": sd[p + "cls_temp.weight"].reshape(-1),
        "reid_temp": sd[p + "reid_temp.weight"].reshape(-1),
        "prompt_detection": sd[p + "prompt_detection.weight"].reshape(-1),
        "prompt_sot": sd[p + "prompt_sot.weight"].reshape(-1),
        "prompt_grounding": sd[p + "prompt_grounding.weight"].reshape(-1),
        "decoder_norm": _layernorm(sd, p + "decoder_norm"),
        "vis2text_projection": _linear(sd, p + "vis2text_projection"),
        "text_norm": _layernorm(sd, p + "text_norm"),
        "text2vis_projection": _linear(sd, p + "text2vis_projection"),
    }
    for i in range(num_layers):
        out[f"cross_{i}"] = _attn_block(sd, p + f"transformer_cross_attention_layers.{i}", hidden)
        out[f"self_{i}"] = _attn_block(sd, p + f"transformer_self_attention_layers.{i}", hidden)
        out[f"ffn_{i}"] = {
            "linear1": _linear(sd, p + f"transformer_ffn_layers.{i}.linear1"),
            "linear2": _linear(sd, p + f"transformer_ffn_layers.{i}.linear2"),
            "norm": _layernorm(sd, p + f"transformer_ffn_layers.{i}.norm"),
        }
        if f"{p}transformer_prompt_self_attention_layers.{i}.multihead_attn.in_proj_weight" in sd:
            out[f"proca_{i}"] = _attn_block(
                sd, p + f"transformer_prompt_self_attention_layers.{i}", hidden
            )
    if f"{p}lang2vision_cross_attention_layer.multihead_attn.in_proj_weight" in sd:
        out["lang2vision"] = _attn_block(sd, p + "lang2vision_cross_attention_layer", hidden)
    # mask_embed MLP: layers.0/1/2 -> layer0/1/2
    out["mask_embed"] = {
        f"layer{i}": _linear(sd, p + f"mask_embed.layers.{i}") for i in range(3)
    }
    return out


def _max_index(sd: Dict, prefix: str) -> int:
    """1 + highest integer following ``prefix`` in any key (0 if none)."""
    best = -1
    for k in sd:
        if k.startswith(prefix):
            tail = k[len(prefix):].split(".", 1)[0]
            if tail.isdigit():
                best = max(best, int(tail))
    return best + 1


def convert_univs_checkpoint(sd: Dict[str, np.ndarray], resnet_depth: int = 50,
                             num_dec_layers: int = None, num_enc_layers: int = None,
                             prefer_ema: bool = True) -> Dict:
    """Full reference checkpoint -> {'backbone', 'pixel_decoder',
    'decoder'} param tree for UniVSModel.

    Layer counts default to what the checkpoint actually contains; the
    backbone converter is picked from the key shape (Swin
    ``backbone.patch_embed``/``layers.S.blocks.B`` vs d2 ResNet
    ``backbone.stem``/``res{2-5}``)."""
    sd = _strip_prefixes(sd, prefer_ema)
    if num_enc_layers is None:
        num_enc_layers = _max_index(
            sd, "sem_seg_head.pixel_decoder.transformer.encoder.layers.") or 6
    if num_dec_layers is None:
        num_dec_layers = _max_index(
            sd, "sem_seg_head.predictor.transformer_cross_attention_layers.") or 9
    backbone_sd = {k: v for k, v in sd.items() if k.startswith("backbone.")}
    if any(k.startswith("backbone.patch_embed") for k in backbone_sd):
        from univs_tpu_torch.utils.convert import convert_swin

        depths = tuple(
            _max_index(backbone_sd, f"backbone.layers.{s}.blocks.")
            for s in range(_max_index(backbone_sd, "backbone.layers."))
        )
        backbone = convert_swin(backbone_sd, depths=depths)
    else:
        backbone = convert_resnet(backbone_sd, depth=resnet_depth)
    return {
        "backbone": backbone,
        "pixel_decoder": convert_pixel_decoder(sd, num_enc_layers),
        "decoder": convert_decoder(sd, num_dec_layers),
    }
