"""The port's reference-YAML front-end (``univs_tpu_torch/config_io.py``)
against the JAX package's on the same files: inline yacs YAML files with a
``_BASE_`` chain written under ``tmp_path`` (tuple-literal strings, d2
scheduler names, Swin and ResNet backbones, DEC_LAYERS, AMP, extras and
unknown keys) give the same ``(cfg, extras, unmapped)``, the configs
compared field by field through ``dataclasses.asdict``; ``apply_overrides``
in the ``key=value`` and the d2 pair form, ``set_by_path``'s refusals and
``_coerce`` agree with JAX's."""

import dataclasses
import textwrap

import pytest
import torch

from univs_tpu import config_io as jax_io
from univs_tpu.config import UniVSConfig as JaxUniVSConfig
from univs_tpu_torch import config_io
from univs_tpu_torch.config import UniVSConfig

torch.set_num_threads(1)

BASE = """
MODEL:
  BACKBONE:
    NAME: "build_resnet_backbone"
  RESNETS:
    DEPTH: 50
  PIXEL_MEAN: [123.675, 116.280, 103.530]
  SEM_SEG_HEAD:
    CONVS_DIM: 256
    TRANSFORMER_ENC_LAYERS: 6
    NUM_CLASSES: 40
    DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES: ["res3", "res4", "res5"]
  MASK_FORMER:
    NUM_OBJECT_QUERIES: 200
    DEC_LAYERS: 10
    DEEP_SUPERVISION: True
    TEST:
      OBJECT_MASK_THRESHOLD: 0.8
  UniVS:
    PROMPT_SELF_ATTN_LAYERS: -1
    TEST:
      CLIP_STRIDE: 1
SOLVER:
  BASE_LR: 0.0001
  STEPS: (327778, 355092)
  LR_SCHEDULER_NAME: "WarmupMultiStepLR"
  AMP:
    ENABLED: False
INPUT:
  MIN_SIZE_TEST: 480
DATASETS:
  TRAIN: ("coco_panoptic_train", "ytvis_2021_train")
  TEST: ("ytvis_2021_dev",)
  DATASET_RATIO: [1.0, 0.5]
SEED: 42
"""

STAGE1 = """
_BASE_: base.yaml
MODEL:
  WEIGHTS: "output/stage0/model_final.pth"
  MASK_FORMER:
    NUM_OBJECT_QUERIES: 100
  UniVS:
    PROMPT_SELF_ATTN_LAYERS: 4
    CLIP_CLASS_EMBED_PATH: "datasets/concept_emb/bank.pth"
    TEST:
      VIDEO_UNIFIED_INFERENCE_QUERIES: "prompt+learn"
SOLVER:
  MAX_ITER: 1000
  LR_SCHEDULER_NAME: "WarmupPolyLR"
INPUT:
  SAMPLING_FRAME_NUM: 3
OUTPUT_DIR: "output/stage1"
"""

STAGE2_SWIN = """
_BASE_: stage1.yaml
MODEL:
  BACKBONE:
    NAME: "D2SwinTransformer"
  SWIN:
    EMBED_DIM: 192
    DEPTHS: [2, 2, 18, 2]
    NUM_HEADS: [6, 12, 24, 48]
    WINDOW_SIZE: 12
    USE_CHECKPOINT: True
  BoxVIS:
    BoxVIS_ENABLED: True
    TEST:
      NUM_MAX_INST: 40
SOLVER:
  AMP:
    ENABLED: True
  CLIP_GRADIENTS:
    CLIP_VALUE: 0.01
    ENABLED: True
DATALOADER:
  NUM_WORKERS: 4
"""


@pytest.fixture(scope="module")
def yaml_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("yacs")
    for name, text in (("base.yaml", BASE), ("stage1.yaml", STAGE1), ("stage2.yaml", STAGE2_SWIN)):
        (d / name).write_text(textwrap.dedent(text))
    return d


def assert_same_config(got, want):
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_key_tables_equal_jax():
    assert config_io.REF_KEY_MAP == jax_io.REF_KEY_MAP
    assert config_io._TRANSFORM_KEYS == jax_io._TRANSFORM_KEYS
    assert config_io._EXTRA_KEYS == jax_io._EXTRA_KEYS


@pytest.mark.parametrize("name", ["base.yaml", "stage1.yaml", "stage2.yaml"])
def test_load_yacs_yaml_equals_jax(yaml_dir, name):
    got = config_io.load_yacs_yaml(str(yaml_dir / name))
    assert got == jax_io.load_yacs_yaml(str(yaml_dir / name))
    assert "_BASE_" not in got


@pytest.mark.parametrize("name", ["base.yaml", "stage1.yaml", "stage2.yaml"])
def test_config_from_yacs_equals_jax(yaml_dir, name):
    cfg, extras, unmapped = config_io.config_from_yacs(str(yaml_dir / name))
    jcfg, jextras, junmapped = jax_io.config_from_yacs(str(yaml_dir / name))
    assert_same_config(cfg, jcfg)
    assert extras == jextras and unmapped == junmapped
    # and from the merged tree, over a non-default base config
    tree = config_io.load_yacs_yaml(str(yaml_dir / name))
    got = config_io.config_from_yacs(tree, base=UniVSConfig(num_frames=7))
    want = jax_io.config_from_yacs(tree, base=JaxUniVSConfig(num_frames=7))
    assert_same_config(got[0], want[0])
    assert got[1:] == want[1:]


def test_the_chain_reads_as_the_reference(yaml_dir):
    cfg, extras, unmapped = config_io.config_from_yacs(str(yaml_dir / "stage2.yaml"))
    assert cfg.backbone.name == "swin_large" and cfg.backbone.swin_depths == (2, 2, 18, 2)
    assert cfg.decoder.num_queries == 100 and cfg.decoder.num_layers == 9
    assert cfg.decoder.num_prompt_self_attn_layers == 4
    assert cfg.num_frames == cfg.inference.num_frames == 3
    assert cfg.train.lr_scheduler == "poly" and cfg.train.lr_steps == (327778, 355092)
    assert cfg.dtype == "bfloat16" and cfg.backbone.swin_use_checkpoint
    assert extras["datasets_train"] == ("coco_panoptic_train", "ytvis_2021_train")
    assert extras["weights"] == "output/stage0/model_final.pth"
    assert "DATALOADER.NUM_WORKERS" in unmapped and "SEED" in unmapped


OVERRIDES = [
    ["decoder.num_queries=50", "inference.consistency_thres=(-1.0, 0.5)", "dtype=bfloat16"],
    ["MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "64", "MODEL.MASK_FORMER.DEC_LAYERS", "7",
     "INPUT.SAMPLING_FRAME_NUM", "4", "inference.apply_cls_thres", "0.0"],
    ["MODEL.BoxVIS.TEST.APPLY_CLS_THRES=0.1", "train.boxvis_enabled=true",
     "backbone.swin_depths=[2, 2, 6, 2]", "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS=3"],
    ["inference.consistency_thres", "(-1.0, 0.5)", "MODEL.UniVS.TEST.CLIP_STRIDE", "2",
     "train.clip_gradients_value", "0.5"],
]


@pytest.mark.parametrize("opts", OVERRIDES, ids=["key=value", "pairs", "mixed", "pairs-tuple"])
def test_apply_overrides_equals_jax(opts):
    got = config_io.apply_overrides(UniVSConfig(), list(opts))
    assert_same_config(got, jax_io.apply_overrides(JaxUniVSConfig(), list(opts)))
    assert got != UniVSConfig()


def test_set_by_path_refusals_and_coercion_equal_jax():
    with pytest.raises(KeyError, match="unknown config field"):
        config_io.set_by_path(UniVSConfig(), "decoder.no_such_field", 1)
    with pytest.raises(KeyError, match="unknown config field"):
        jax_io.set_by_path(JaxUniVSConfig(), "decoder.no_such_field", 1)
    for path, value in (("inference.min_size_test", "512"), ("train.lr", "1e-3"),
                        ("backbone.swin_use_checkpoint", "yes"), ("pixel_mean", "[1, 2, 3]"),
                        ("decoder.pre_norm", 0)):
        assert_same_config(config_io.set_by_path(UniVSConfig(), path, value),
                           jax_io.set_by_path(JaxUniVSConfig(), path, value))
    types = config_io._field_types(UniVSConfig().inference)
    assert sorted(types) == sorted(jax_io._field_types(JaxUniVSConfig().inference))
    assert config_io._coerce("(1, 2)", types["consistency_thres"]) == (1.0, 2.0)
