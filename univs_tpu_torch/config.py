"""Configuration tree for univs_tpu_torch.

The port's own copy of ``univs_tpu/config.py`` (the port imports nothing
of the JAX package): typed, frozen dataclasses whose defaults reproduce
the reference's R50 inference configuration
(reference: configs/univs/Base.yaml:46-57, tools/test/test_r50.sh:5-12).
Field names and defaults are kept identical, so one config value means
the same thing in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class BackboneConfig:
    """Backbone selection + geometry."""

    name: str = "resnet50"  # resnet50 | swin_tiny | swin_base | swin_large
    # ResNet
    resnet_depth: int = 50
    norm: str = "frozen_bn"  # frozen_bn at inference parity; group_norm option
    # Swin
    swin_embed_dim: int = 96
    swin_depths: Tuple[int, ...] = (2, 2, 6, 2)
    swin_num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    swin_window_size: int = 7
    swin_drop_path_rate: float = 0.0  # read by no JAX module: JAX's Swin has no drop path
    swin_use_checkpoint: bool = False  # checkpoint each Swin block in training
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")


@dataclass(frozen=True)
class PixelDecoderConfig:
    """Multi-scale deformable-attention encoder + FPN.

    Reference: mask2former/modeling/pixel_decoder/msdeformattn.py,
    configs/univs/Base.yaml:46-57 (6 encoder layers, 3 scales, 8 heads,
    4 points, hidden 256, FFN 1024).
    """

    hidden_dim: int = 256
    num_layers: int = 6
    num_heads: int = 8
    num_points: int = 4
    ffn_dim: int = 1024
    # features entering the deformable encoder (highest->used for FPN too)
    transformer_in_features: Tuple[str, ...] = ("res3", "res4", "res5")
    mask_dim: int = 256
    common_stride: int = 4  # mask features at 1/4
    norm: str = "group_norm"
    # VL early fusion (msdeformattn_vl.py) — off by default
    vl_fusion: bool = False
    lang_dim: int = 640


@dataclass(frozen=True)
class DecoderConfig:
    """UniVS video transformer decoder.

    Reference: univs/modeling/transformer_decoder/
    video_mask2former_transformer_decoder_univs.py (9 layers, 200
    queries, hidden 256, 8 heads, FFN 2048; ProCA every layer).
    """

    hidden_dim: int = 256
    num_queries: int = 200
    num_layers: int = 9  # DEC_LAYERS(10) - 1
    num_heads: int = 8
    ffn_dim: int = 2048
    pre_norm: bool = False
    mask_dim: int = 256
    num_feature_levels: int = 3
    enforce_input_project: bool = False
    # prompt machinery
    num_prompt_self_attn_layers: int = 10  # ProCA at layer 0 + each of 9 layers
    self_attn_mask_type: str = "sep"  # sep | sep-blocked | sep-l2p | full
    position_embedding_sine3d: str = "ArbitraryT"  # FixedT | ArbitraryT
    num_max_frames: int = 128  # z normalizer for ArbitraryT PE
    # classification head
    clip_cls_emb_dim: int = 640  # RN50x4 text embedding width
    num_classes: int = 3938  # combined category space (frozen CLIP embeds)
    # language head (RefVOS)
    lang_dim: int = 640
    max_text_len: int = 77
    # inference-time fusion of learnable-query masks into prompt masks
    l4p_fusion: bool = True
    temporal_query_shuffle: bool = True  # train-time shuffle in mask head
    # rematerialize the per-layer prediction heads in training: aux-layer
    # full-res mask logits are recomputed in backward instead of stored
    # (10 x [B, Q, T, H/4, W/4] f32 dominates HBM at 1024^2 Swin inputs;
    # pair with backbone.swin_use_checkpoint — reference univs/config.py:63)
    remat_heads: bool = False


@dataclass(frozen=True)
class PromptConfig:
    """Visual/text prompt encoders + memory pool geometry.

    Reference: univs/modeling/prompt_encoder/prompt_encoder.py,
    univs/config.py:120-140.
    """

    num_dense_points_train: int = 32
    num_dense_points_test: int = 128
    num_max_instances: int = 40  # padded prompt-query capacity (train)
    num_max_instances_test: int = 60  # memory-pool entity capacity (inference)
    num_prev_frames_memory: int = 5
    prompt_type_ratios: Tuple[float, float, float] = (0.25, 0.25, 0.50)
    # train: P(point), P(box), P(mask)
    text_prompt_enable: bool = True
    visual_prompt_enable: bool = True


@dataclass(frozen=True)
class InferenceConfig:
    """Clip-streaming inference runtime.

    Reference: tools/test/test_r50.sh:5-12, univs/config.py.
    """

    num_frames: int = 5  # clip length T
    clip_stride: int = 1
    num_frames_window: int = 30  # backbone window
    min_size_test: int = 640
    size_divisibility: int = 32
    # thresholds (reference: inference_video_entity.py)
    apply_cls_thres: float = 0.25
    newly_entity_thres: float = 0.1
    detect_newly_interval_frames: int = 1  # TEST.DETECT_NEWLY_INTERVAL_FRAMES
    consistency_thres: Tuple[float, float] = (0.25, 0.5)
    nms_thres: float = 0.85
    overlap_threshold: float = 0.8  # panoptic area-ratio filter (Base.yaml:62)
    object_mask_threshold: float = 0.05  # panoptic keep thresh (Base.yaml:63)
    detections_per_image: int = 100  # image instance top-k (d2 TEST.DETECTIONS_PER_IMAGE)
    max_num_instances: int = 60
    topk_per_video: int = 25
    semantic_extraction_enable: bool = False
    # VOS back-end re-ID variant: 'prompt' | 'learn' | 'prompt+learn'
    # (reference: VIDEO_UNIFIED_INFERENCE_QUERIES,
    #  inference_video_vos.py:337-496)
    video_unified_inference_queries: str = "prompt"
    # RefVOS: concat prev-clip visual prompt kv ahead of the text kv
    # (reference MODEL.UniVS.TEST.ENABLED_PREV_VISUAL_PROMPTS_FOR_GROUNDING,
    #  decoder_univs.py:628,736-748; default off)
    enabled_prev_visual_prompts_for_grounding: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule / criterion weights.

    Reference: train_net.py:211-292, configs/univs/Base.yaml:85-111.
    """

    lr: float = 1e-4
    backbone_lr_multiplier: float = 0.1
    weight_decay: float = 0.05
    clip_gradients_value: float = 0.01
    max_iter: int = 160_000
    warmup_iters: int = 10
    # LR schedule family (reference: detectron2/deeplab build_lr_scheduler
    # dispatched on SOLVER.LR_SCHEDULER_NAME; UniVS configs use the
    # default WarmupMultiStepLR with STEPS/GAMMA, e.g. Base.yaml:85-88)
    lr_scheduler: str = "multistep"  # multistep | poly | cosine
    lr_steps: Tuple[int, ...] = ()  # decay boundaries (SOLVER.STEPS)
    lr_gamma: float = 0.1  # per-step decay (SOLVER.GAMMA)
    warmup_factor: float = 1.0  # SOLVER.WARMUP_FACTOR (1.0 = no warmup)
    poly_power: float = 0.9  # SOLVER.POLY_LR_POWER (WarmupPolyLR)
    ema_decay: float = 0.999
    amp_dtype: str = "bfloat16"
    # loss weights (configs/univs/Base.yaml:37-44)
    class_weight: float = 5.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    reid_weight: float = 0.5
    class_weight_matcher: float = 3.0
    mask_weight_matcher: float = 5.0
    dice_weight_matcher: float = 5.0
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    # no_object_weight, deep_supervision, amp_dtype, long_video_enable and
    # num_frames_video are read by no module of the JAX package (only its
    # config_io maps them): the JAX criterion always supervises every layer
    # and has no no-object class, the compute dtype is ``UniVSConfig.dtype``,
    # and stage 3 is ``parallel/long_video.long_video_loss``, called with the
    # video's frames whatever these say.  Nothing in the port reads them either.
    no_object_weight: float = 0.1
    deep_supervision: bool = True
    # stage-3 long-video training
    long_video_enable: bool = False
    num_frames_video: int = 7
    # BoxVIS box-supervised training (projection loss) + EMA-teacher
    # pseudo masks (reference: video_criterion.py:242-306 +
    # mask2former/modeling/criterion.py:403 score thresh); read by
    # parallel/train_state.make_train_step
    boxvis_enabled: bool = False
    boxvis_ema_enabled: bool = False
    pseudo_score_thresh: float = 0.2


@dataclass(frozen=True)
class ParallelConfig:
    """Device mesh layout.  DP over ICI is the primary axis
    (reference used DDP/NCCL — train_net.py:90,400-407); optional
    model axis for sharding encoder activations of large backbones.
    """

    dp_axis: str = "data"
    mp_axis: str = "model"
    mesh_shape: Tuple[int, int] = (-1, 1)  # (-1 => all remaining devices)


@dataclass(frozen=True)
class UniVSConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    pixel_decoder: PixelDecoderConfig = field(default_factory=PixelDecoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    prompt: PromptConfig = field(default_factory=PromptConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    # global
    num_frames: int = 2  # training clip length (stage 1/2)
    dtype: str = "float32"  # compute dtype: float32 | bfloat16
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)

    def replace(self, **kwargs) -> "UniVSConfig":
        return dataclasses.replace(self, **kwargs)


def tiny_test_config() -> UniVSConfig:
    """A miniature config for unit tests: small dims, CPU-friendly."""
    return UniVSConfig(
        backbone=BackboneConfig(name="resnet50"),
        pixel_decoder=PixelDecoderConfig(hidden_dim=32, num_layers=2, num_heads=4, num_points=2, ffn_dim=64, mask_dim=32),
        decoder=DecoderConfig(
            hidden_dim=32,
            num_queries=8,
            num_layers=3,
            num_heads=4,
            ffn_dim=64,
            mask_dim=32,
            clip_cls_emb_dim=16,
            num_classes=10,
            lang_dim=16,
        ),
        prompt=PromptConfig(num_dense_points_train=4, num_dense_points_test=8, num_max_instances=4, num_max_instances_test=6),
        num_frames=2,
    )
