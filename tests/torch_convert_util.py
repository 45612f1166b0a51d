"""Reference-named checkpoints for the weight-intake tests
(``tests/test_torch_{convert,weight_intake,entry}.py``): the converters of
``utils/convert.py`` and ``utils/convert_univs.py`` read backwards, from the
port's state_dict names to the reference's (d2 / torchvision ResNet, Swin,
PVTv2, the OpenAI CLIP text tower, ``sem_seg_head.pixel_decoder.*`` with
its VLFuse layers, ``sem_seg_head.predictor.*`` with packed attention
projections).  Neither package has an exporter; this one exists to make
inputs for the converters.  The shapes come from the port's modules (built
on the meta device when only shapes are needed), so every channel count is
the backbone's."""

import re
from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch

Rule = Tuple[str, Union[str, Callable]]

_RESNET_D2: List[Rule] = [
    (r"stem_conv\.weight", "stem.conv1.weight"),
    (r"stem_bn\.(\w+)", r"stem.conv1.norm.\1"),
    (r"res(\d)_block(\d+)\.conv(\d)\.weight", r"res\1.\2.conv\3.weight"),
    (r"res(\d)_block(\d+)\.bn(\d)\.(\w+)", r"res\1.\2.conv\3.norm.\4"),
    (r"res(\d)_block(\d+)\.shortcut\.weight", r"res\1.\2.shortcut.weight"),
    (r"res(\d)_block(\d+)\.shortcut_bn\.(\w+)", r"res\1.\2.shortcut.norm.\3"),
]
_RESNET_TORCHVISION: List[Rule] = [
    (r"stem_conv\.weight", "conv1.weight"),
    (r"stem_bn\.(\w+)", r"bn1.\1"),
    (r"res(\d)_block(\d+)\.conv(\d)\.weight",
     lambda m: f"layer{int(m[1]) - 1}.{m[2]}.conv{m[3]}.weight"),
    (r"res(\d)_block(\d+)\.bn(\d)\.(\w+)", lambda m: f"layer{int(m[1]) - 1}.{m[2]}.bn{m[3]}.{m[4]}"),
    (r"res(\d)_block(\d+)\.shortcut\.weight",
     lambda m: f"layer{int(m[1]) - 1}.{m[2]}.downsample.0.weight"),
    (r"res(\d)_block(\d+)\.shortcut_bn\.(\w+)",
     lambda m: f"layer{int(m[1]) - 1}.{m[2]}.downsample.1.{m[3]}"),
]
_SWIN: List[Rule] = [
    (r"patch_embed\.(weight|bias)", r"patch_embed.proj.\1"),
    (r"patch_norm\.(\w+)", r"patch_embed.norm.\1"),
    (r"stage(\d+)_block(\d+)\.(fc1|fc2)\.(\w+)", r"layers.\1.blocks.\2.mlp.\3.\4"),
    (r"stage(\d+)_block(\d+)\.(.*)", r"layers.\1.blocks.\2.\3"),
    (r"merge_norm(\d+)\.(\w+)", r"layers.\1.downsample.norm.\2"),
    (r"merge_reduction(\d+)\.weight", r"layers.\1.downsample.reduction.weight"),
    (r"out_norm(\d+)\.(\w+)", r"norm\1.\2"),
]
_PVT: List[Rule] = [
    (r"patch_embed(\d)\.(weight|bias)", lambda m: f"patch_embed{int(m[1]) + 1}.proj.{m[2]}"),
    (r"patch_norm(\d)\.(\w+)", lambda m: f"patch_embed{int(m[1]) + 1}.norm.{m[2]}"),
    (r"stage(\d)_block(\d+)\.attn\.sr_norm\.(\w+)",
     lambda m: f"block{int(m[1]) + 1}.{m[2]}.attn.norm.{m[3]}"),
    (r"stage(\d)_block(\d+)\.mlp\.dwconv\.(\w+)",
     lambda m: f"block{int(m[1]) + 1}.{m[2]}.mlp.dwconv.dwconv.{m[3]}"),
    (r"stage(\d)_block(\d+)\.(.*)", lambda m: f"block{int(m[1]) + 1}.{m[2]}.{m[3]}"),
    (r"out_norm(\d)\.(\w+)", lambda m: f"norm{int(m[1]) + 1}.{m[2]}"),
]
_CLIP: List[Rule] = [
    (r"token_embedding", "token_embedding.weight"),
    (r"(positional_embedding|text_projection)", r"\1"),
    (r"ln_final\.(\w+)", r"ln_final.\1"),
    (r"block_(\d+)\.(ln_1|ln_2)\.(\w+)", r"transformer.resblocks.\1.\2.\3"),
    (r"block_(\d+)\.(c_fc|c_proj)\.(\w+)", r"transformer.resblocks.\1.mlp.\2.\3"),
    (r"block_(\d+)\.attn\.(.*)", r"transformer.resblocks.\1.attn.\2"),
]
_PIXEL_DECODER: List[Rule] = [
    (r"level_embed", "transformer.level_embed"),
    (r"input_proj_(\d+)\.(\w+)", r"input_proj.\1.0.\2"),
    (r"input_proj_gn_(\d+)\.(\w+)", r"input_proj.\1.1.\2"),
    (r"encoder_layer_(\d+)\.(.*)", r"transformer.encoder.layers.\1.\2"),
    (r"adapter_(\d+)\.weight", lambda m: f"adapter_{int(m[1]) + 1}.weight"),
    (r"adapter_gn_(\d+)\.(\w+)", lambda m: f"adapter_{int(m[1]) + 1}.norm.{m[2]}"),
    (r"layer_(\d+)\.weight", lambda m: f"layer_{int(m[1]) + 1}.weight"),
    (r"layer_gn_(\d+)\.(\w+)", lambda m: f"layer_{int(m[1]) + 1}.norm.{m[2]}"),
    (r"mask_features\.(\w+)", r"mask_features.\1"),
    (r"vl_fuse_(\d+)\.(.*)", r"transformer.encoder.vl_layers.\1.b_attn.\2"),
]
_TEMPS = r"(cls_temp|reid_temp|prompt_detection|prompt_sot|prompt_grounding)"
_DECODER: List[Rule] = [
    (r"(query_embed|level_embed)", r"\1.weight"),
    (_TEMPS, r"\1.weight"),
    (r"(decoder_norm|text_norm|vis2text_projection|text2vis_projection)\.(\w+)", r"\1.\2"),
    (r"cross_(\d+)\.attn\.(.*)", r"transformer_cross_attention_layers.\1.multihead_attn.\2"),
    (r"cross_(\d+)\.norm\.(\w+)", r"transformer_cross_attention_layers.\1.norm.\2"),
    (r"self_(\d+)\.attn\.(.*)", r"transformer_self_attention_layers.\1.self_attn.\2"),
    (r"self_(\d+)\.norm\.(\w+)", r"transformer_self_attention_layers.\1.norm.\2"),
    (r"proca_(\d+)\.attn\.(.*)", r"transformer_prompt_self_attention_layers.\1.multihead_attn.\2"),
    (r"proca_(\d+)\.norm\.(\w+)", r"transformer_prompt_self_attention_layers.\1.norm.\2"),
    (r"lang2vision\.attn\.(.*)", r"lang2vision_cross_attention_layer.multihead_attn.\1"),
    (r"lang2vision\.norm\.(\w+)", r"lang2vision_cross_attention_layer.norm.\1"),
    (r"ffn_(\d+)\.(.*)", r"transformer_ffn_layers.\1.\2"),
    (r"mask_embed\.layer(\d)\.(\w+)", r"mask_embed.layers.\1.\2"),
]


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _pack_attention(sd: Dict[str, np.ndarray], owner: str) -> Dict[str, np.ndarray]:
    """Every ``<owner>.attn.{q,k,v}_proj`` (``owner`` a regex of the
    module names) -> the packed ``in_proj_weight`` / ``in_proj_bias`` of
    torch's ``nn.MultiheadAttention``; ``out_proj`` kept."""
    out = dict(sd)
    for k in sd:
        m = re.fullmatch(rf"({owner})\.attn\.q_proj\.weight", k)
        if not m:
            continue
        p = f"{m[1]}.attn."
        for leaf in ("weight", "bias"):
            out[f"{p}in_proj_{leaf}"] = np.concatenate([sd[f"{p}{n}_proj.{leaf}"] for n in "qkv"])
            for n in "qkv":
                del out[f"{p}{n}_proj.{leaf}"]
    return out


def rename(sd: Dict[str, np.ndarray], rules: List[Rule], prefix: str = "") -> Dict[str, np.ndarray]:
    """Each key through the first rule whose pattern it matches whole."""
    out = {}
    for k, v in sd.items():
        for pat, rep in rules:
            m = re.fullmatch(pat, k)
            if m:
                out[prefix + (rep(m) if callable(rep) else m.expand(rep))] = _np(v)
                break
        else:
            raise KeyError(f"no reference name for {k}")
    return out


def resnet_reference(sd, naming: str = "d2", prefix: str = "") -> Dict[str, np.ndarray]:
    return rename(sd, _RESNET_D2 if naming == "d2" else _RESNET_TORCHVISION, prefix)


def swin_reference(sd, prefix: str = "") -> Dict[str, np.ndarray]:
    return rename(sd, _SWIN, prefix)


def pvt_reference(sd, prefix: str = "backbone.") -> Dict[str, np.ndarray]:
    return rename(sd, _PVT, prefix)


def clip_text_reference(sd) -> Dict[str, np.ndarray]:
    return rename(_pack_attention({k: _np(v) for k, v in sd.items()}, r"block_\d+"), _CLIP)


def pixel_decoder_reference(sd) -> Dict[str, np.ndarray]:
    return rename(sd, _PIXEL_DECODER, "sem_seg_head.pixel_decoder.")


def decoder_reference(sd, static_query: bool = True) -> Dict[str, np.ndarray]:
    """The predictor's names; ``query_feat`` under its historical name
    ``static_query`` when asked; the 1-row embeddings as [1, C]."""
    sd = _pack_attention({k: _np(v) for k, v in sd.items()},
                         r"cross_\d+|self_\d+|proca_\d+|lang2vision")
    p = "sem_seg_head.predictor."
    out = rename({k: v for k, v in sd.items() if k != "query_feat"}, _DECODER, p)
    for k in list(out):
        if re.fullmatch(p + _TEMPS + r"\.weight", k):
            out[k] = out[k].reshape(1, -1)
    out[p + ("static_query" if static_query else "query_feat") + ".weight"] = sd["query_feat"]
    return out


def univs_reference(sd, static_query: bool = True) -> Dict[str, np.ndarray]:
    """A UniVS model's state_dict (``backbone.`` R50 or Swin,
    ``pixel_decoder.``, ``decoder.``) -> the reference checkpoint's names."""
    part = lambda p: {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
    bb = part("backbone.")
    out = (swin_reference(bb, "backbone.") if "patch_embed.weight" in bb
           else resnet_reference(bb, "d2", "backbone."))
    out.update(pixel_decoder_reference(part("pixel_decoder.")))
    out.update(decoder_reference(part("decoder."), static_query))
    assert len(out) == len(sd) - 4 * sum(k.endswith(".attn.q_proj.weight") for k in sd), \
        "every key mapped once"
    return out


def with_teacher(student: Dict[str, np.ndarray], teacher: Dict[str, np.ndarray]) -> Dict:
    """An EMA checkpoint: the student's keys and a ``teacher.``-prefixed copy."""
    out = dict(student)
    out.update({"teacher." + k: v for k, v in teacher.items()})
    return out


def save_reference(path, sd: Dict[str, np.ndarray]) -> None:
    """``torch.save`` under ``{"model": ...}``, as the reference's checkpointer."""
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}},
               str(path))


def meta_shapes(build: Callable[[], torch.nn.Module]) -> Dict[str, Tuple[int, ...]]:
    """The state_dict shapes of ``build()`` made on the meta device."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in build().state_dict().items()}


def random_arrays(shapes: Dict[str, Tuple[int, ...]], seed: int) -> Dict[str, np.ndarray]:
    """Seeded float32 normals of the given shapes."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}
