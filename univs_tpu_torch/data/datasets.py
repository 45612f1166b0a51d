"""Dataset catalog: named dataset specs -> loader + evaluator wiring (the port's copy of
``univs_tpu/data/datasets.py``, which the port may not import).

Rebuild of the reference's registration layer
(reference: univs/data/datasets/builtin.py:27-614 — ~60 named datasets
with evaluator_type metadata across SA-1B, LVIS, COCO/ADE20K panoptic,
EntitySeg, VIPSeg, VSPW, YTVIS-19/21/22, OVIS, BURST, DAVIS, YTVOS,
MOSE, GOT10K, VIPOSeg, Ref-YTVOS/Ref-DAVIS, RefCOCO, and raw-video test
sets).  Paths resolve under UNIVS_TPU_DATA_ROOT (default ./datasets),
matching the reference's on-disk layout so existing dataset trees work
unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


def data_root() -> str:
    return os.environ.get("UNIVS_TPU_DATA_ROOT", "datasets")


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    json_path: str  # relative to data root
    image_root: str  # relative to data root
    evaluator_type: Optional[str]  # ytvis | vps | vss | davis | pvos | coco | None
    task: str = "detection"  # detection | sot | grounding
    namespace: Optional[str] = None  # category namespace (category_info.py)
    has_expression: bool = False
    sot: bool = False

    @property
    def thing_ids(self):
        """1-based thing category ids for panoptic datasets."""
        return THING_IDS_BY_NAMESPACE.get(self.namespace, None)


# thing/stuff split for panoptic namespaces (reference:
# univs/data/datasets/vps.py VIPSEG_CATEGORIES isthing==1 — 58 of 124)
THING_IDS_BY_NAMESPACE = {
    "vipseg": frozenset({
        3, 5, 9, 11, 42, 44, 45, 47, 48, 49, 50, 51, 52, 53, 55, 56, 57,
        61, 62, 63, 64, 65, 66, 73, 75, 77, 78, 79, 80, 83, 84, 85, 86,
        87, 88, 89, 90, 91, 92, 93, 96, 97, 98, 100, 101, 102, 103, 107,
        108, 109, 110, 115, 116, 117, 118, 119, 123, 124,
    }),
    # viposeg shares the VIPSeg category space
    "viposeg": frozenset({
        3, 5, 9, 11, 42, 44, 45, 47, 48, 49, 50, 51, 52, 53, 55, 56, 57,
        61, 62, 63, 64, 65, 66, 73, 75, 77, 78, 79, 80, 83, 84, 85, 86,
        87, 88, 89, 90, 91, 92, 93, 96, 97, 98, 100, 101, 102, 103, 107,
        108, 109, 110, 115, 116, 117, 118, 119, 123, 124,
    }),
    # COCO panoptic contiguous layout: things first (80), stuff after
    # (d2 convention, reference register_coco_panoptic_annos_semseg.py)
    "coco_panoptic": frozenset(range(1, 81)),
    # ADE20K-150 panoptic isthing flags (reference:
    # univs/data/datasets/ade20k_panoptic.py — 100 thing classes)
    "ade20k": frozenset({
        8, 9, 11, 13, 15, 16, 19, 20, 21, 23, 24, 25, 28, 31, 32, 33, 34,
        36, 37, 38, 39, 40, 42, 43, 44, 45, 46, 48, 50, 51, 54, 56, 57,
        58, 59, 63, 65, 66, 67, 68, 70, 71, 72, 73, 74, 75, 76, 77, 79,
        81, 82, 83, 84, 86, 87, 88, 89, 90, 91, 93, 94, 96, 98, 99, 103,
        104, 105, 108, 109, 111, 112, 113, 116, 117, 119, 120, 121, 122,
        124, 125, 126, 127, 128, 130, 131, 133, 134, 135, 136, 137, 138,
        139, 140, 143, 144, 145, 147, 148, 149, 150,
    }),
}


_CATALOG: Dict[str, DatasetSpec] = {}


def register(spec: DatasetSpec):
    _CATALOG[spec.name] = spec


def get_spec(name: str) -> DatasetSpec:
    return _CATALOG[name]


def list_datasets() -> List[str]:
    return sorted(_CATALOG)


def load_dataset(name: str) -> List[Dict]:
    from univs_tpu_torch.data.ytvis import load_ytvis_json

    spec = _CATALOG[name]
    return load_ytvis_json(
        os.path.join(data_root(), spec.json_path),
        os.path.join(data_root(), spec.image_root),
        dataset_name=name,
        has_expression=spec.has_expression,
        sot=spec.sot,
    )


def _reg(name, json_path, image_root, ev, task="detection", ns=None, expr=False, sot=False):
    register(DatasetSpec(name, json_path, image_root, ev, task, ns, expr, sot))


# ---- VIS ------------------------------------------------------------------
_reg("ytvis_2019_train", "ytvis_2019/train.json", "ytvis_2019/train/JPEGImages", "ytvis", ns="ytvis19")
_reg("ytvis_2019_val", "ytvis_2019/valid.json", "ytvis_2019/valid/JPEGImages", "ytvis", ns="ytvis19")
_reg("ytvis_2021_train", "ytvis_2021/train.json", "ytvis_2021/train/JPEGImages", "ytvis", ns="ytvis21")
_reg("ytvis_2021_val", "ytvis_2021/valid.json", "ytvis_2021/valid/JPEGImages", "ytvis", ns="ytvis21")
_reg("ytvis_2021_dev", "ytvis_2021/instances_dev.json", "ytvis_2021/train/JPEGImages", "ytvis", ns="ytvis21")
_reg("ytvis_2022_val", "ytvis_2022/instances.json", "ytvis_2022/valid/JPEGImages", "ytvis", ns="ytvis21")
_reg("ovis_train", "ovis/annotations_train.json", "ovis/train", "ytvis", ns="ovis")
_reg("ovis_val", "ovis/annotations_valid.json", "ovis/valid", "ytvis", ns="ovis")
_reg("ovis_dev", "ovis/annotations_dev.json", "ovis/train", "ytvis", ns="ovis")
_reg("mots_burst_train", "burst/annotations/train_uni.json", "burst/frames/train", "ytvis", ns="burst")
_reg("mots_burst_val_det", "burst/annotations/val_uni.json", "burst/frames/val", "ytvis", ns="burst")

# ---- VPS / VSS ------------------------------------------------------------
_reg("vipseg_panoptic_train", "vipseg/panoptic_gt_VIPSeg_train_cocovid.json", "vipseg/imgs", "vps", ns="vipseg")
_reg("vipseg_panoptic_val", "vipseg/panoptic_gt_VIPSeg_val_cocovid.json", "vipseg/imgs", "vps", ns="vipseg")
_reg("vipseg_panoptic_dev", "vipseg/panoptic_gt_VIPSeg_val_sub_cocovid.json", "vipseg/imgs", "vps", ns="vipseg")
_reg("vspw_vss_video_val", "vspw/val_cocovid.json", "vspw/data", "vss", ns="vspw")
_reg("vspw_vss_video_dev", "vspw/dev_cocovid.json", "vspw/data", "vss", ns="vspw")

# ---- VOS (sot) ------------------------------------------------------------
_reg("sot_davis17_train", "davis/2017_train.json", "davis/JPEGImages/480p", "davis", task="sot", sot=True)
_reg("sot_davis17_val", "davis/2017_val.json", "davis/JPEGImages/480p", "davis", task="sot", sot=True)
_reg("sot_davis16_val", "davis/2016_val.json", "davis/JPEGImages/480p", "davis", task="sot", sot=True)
_reg("sot_ytbvos18_train", "ytbvos18/train.json", "ytbvos18/train/JPEGImages", None, task="sot", sot=True)
_reg("sot_ytbvos18_val", "ytbvos18/val.json", "ytbvos18/valid/JPEGImages", None, task="sot", sot=True)
_reg("mots_mose_train", "mose/train.json", "mose/train/JPEGImages", None, task="sot", sot=True)
_reg("mots_mose_val", "mose/val.json", "mose/valid/JPEGImages", None, task="sot", sot=True)
_reg("sot_got10k_train", "got10k/train.json", "got10k/train", None, task="sot", sot=True)

# ---- PVOS -----------------------------------------------------------------
_reg("pvos_viposeg_val", "viposeg/val_cocovid.json", "viposeg/valid/images", "pvos", task="sot", ns="viposeg", sot=True)
_reg("pvos_viposeg_dev", "viposeg/dev_cocovid.json", "viposeg/valid/images", "pvos", task="sot", ns="viposeg", sot=True)

# ---- RefVOS (grounding) ---------------------------------------------------
_reg("rvos-refytb-train", "ref-youtube-vos/train.json", "ref-youtube-vos/train/JPEGImages", None, task="grounding", expr=True)
_reg("rvos-refytb-val", "ref-youtube-vos/valid.json", "ref-youtube-vos/valid/JPEGImages", None, task="grounding", expr=True)
_reg("rvos-refdavis-val-0", "ref-davis/valid_0.json", "ref-davis/valid/JPEGImages", "davis", task="grounding", expr=True)
_reg("refcoco-unc-train", "refcoco/refcoco-unc/instances_train.json", "coco/train2017", None, task="grounding", expr=True)
_reg("refcoco-unc-val", "refcoco/refcoco-unc/instances_val.json", "coco/train2017", None, task="grounding", expr=True)

# ---- image datasets (pseudo-video) ----------------------------------------
_reg("coco_panoptic_train", "coco/annotations/panoptic_train2017_cocovid.json", "coco/train2017", "coco", ns="coco_panoptic")
_reg("coco_panoptic_val", "coco/annotations/panoptic_val2017_cocovid.json", "coco/val2017", "coco", ns="coco_panoptic")
_reg("ade20k_panoptic_train", "ade20k/ade20k_panoptic_train_cocovid.json", "ade20k/images/training", "coco", ns="ade20k")
_reg("lvis_v1_train512p", "lvis/lvis_v1_train512p_cocovid.json", "coco", None, ns="lvis")
_reg("sa_1b_train_250k_1", "sa_1b/sa_1b_250k_1_cocovid.json", "sa_1b/images", None, ns=None)
_reg("entityseg_instance_train", "entityseg/entityseg_insseg_train_cocovid.json", "entityseg/images", None, ns="entityseg_instance")
_reg("entityseg_panoptic_train", "entityseg/entityseg_panseg_train_cocovid.json", "entityseg/images", None, ns="entityseg_panoptic")

# ---- additional splits (reference builtin.py parity) ----------------------
_reg("ytvis_2019_test", "ytvis_2019/test.json", "ytvis_2019/test/JPEGImages", None, ns="ytvis19")
_reg("ytvis_2021_test", "ytvis_2021/test.json", "ytvis_2021/test/JPEGImages", None, ns="ytvis21")
_reg("ytvis_2021_dev_merge", "ytvis_2021/instances_dev_merge.json", "ytvis_2021/train/JPEGImages", "ytvis", ns="ytvis21")
_reg("ovis_test", "ovis/annotations_test.json", "ovis/test", None, ns="ovis")
_reg("ovis_dev_merge", "ovis/annotations_dev_merge.json", "ovis/train", "ytvis", ns="ovis")
_reg("mots_burst_val_vos", "burst/annotations/val_uni_vos.json", "burst/frames/val", None, task="sot", ns="burst", sot=True)
_reg("mots_mose_dev", "mose/dev.json", "mose/train/JPEGImages", "davis", task="sot", sot=True)
_reg("mots_mose_test", "mose/test.json", "mose/test/JPEGImages", None, task="sot", sot=True)
_reg("sot_davis16_train", "davis/2016_train.json", "davis/JPEGImages/480p", "davis", task="sot", sot=True)
_reg("sot_got10k_val", "got10k/val.json", "got10k/val", None, task="sot", sot=True)
_reg("sot_got10k_test", "got10k/test.json", "got10k/test", None, task="sot", sot=True)
_reg("sa_1b_train_250k_2", "sa_1b/sa_1b_250k_2_cocovid.json", "sa_1b/images", None, ns=None)
_reg("lvis_v1_train_video", "lvis/lvis_v1_train_video_cocovid.json", "coco", None, ns="lvis")
_reg("rvos-refdavis-val-1", "ref-davis/valid_1.json", "ref-davis/valid/JPEGImages", "davis", task="grounding", expr=True)
_reg("rvos-refdavis-val-2", "ref-davis/valid_2.json", "ref-davis/valid/JPEGImages", "davis", task="grounding", expr=True)
_reg("rvos-refdavis-val-3", "ref-davis/valid_3.json", "ref-davis/valid/JPEGImages", "davis", task="grounding", expr=True)
_reg("rvos-refytb-test", "ref-youtube-vos/test.json", "ref-youtube-vos/test/JPEGImages", None, task="grounding", expr=True)
_reg("refcoco+-unc-train", "refcoco/refcoco+-unc/instances_train.json", "coco/train2017", None, task="grounding", expr=True)
_reg("refcoco+-unc-val", "refcoco/refcoco+-unc/instances_val.json", "coco/train2017", None, task="grounding", expr=True)
_reg("refcocog-google-val", "refcoco/refcocog-google/instances_val.json", "coco/train2017", None, task="grounding", expr=True)
_reg("refcocog-umd-train", "refcoco/refcocog-umd/instances_train.json", "coco/train2017", None, task="grounding", expr=True)
_reg("refcocog-umd-val", "refcoco/refcocog-umd/instances_val.json", "coco/train2017", None, task="grounding", expr=True)
_reg("coco_2017_train_video", "coco/annotations/instances_train2017_cocovid.json", "coco/train2017", "coco", ns="coco")
_reg("coco_2017_val_video", "coco/annotations/instances_val2017_cocovid.json", "coco/val2017", "coco", ns="coco")
_reg("ade20k_panoptic_val", "ade20k/ade20k_panoptic_val_cocovid.json", "ade20k/images/validation", "coco", ns="ade20k")
_reg("objects365_train", "objects365/objects365_train_cocovid.json", "objects365/train", None, ns="objects365")
_reg("bdd_track_train", "bdd100k/box_track_train_cocovid.json", "bdd100k/images/track/train", None, ns="bdd_track")
_reg("bdd_track_val", "bdd100k/box_track_val_cocovid.json", "bdd100k/images/track/val", None, ns="bdd_track")

# ---- raw video / demo -----------------------------------------------------
_reg("custom_videos", "custom_videos/raw/test.json", "custom_videos/raw", None)
_reg("custom_images", "custom_images/test.json", "custom_images", None)
_reg("custom_videos_text", "custom_videos/raw_text/test.json", "custom_videos/raw_text", None, task="grounding", expr=True)
_reg("internvid-flt-1", "internvid/internvid_flt_1_cocovid.json", "internvid/videos", None)
_reg("pexels_videos", "pexels/test_cocovid.json", "pexels/videos", None)
_reg("msrvtt_videos", "msrvtt/test_cocovid.json", "msrvtt/videos", None)
