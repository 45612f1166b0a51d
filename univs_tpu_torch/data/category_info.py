"""Combined category namespace table (a copy of
``univs_tpu/data/category_info.py``, which the port may not import).

Maps dataset name -> (num_classes, start_offset) into the frozen
3938-row CLIP category-embedding bank shared by all datasets
(reference data table: datasets/concept_emb/
combined_datasets_category_info.py:7-25; the bank itself is extracted
offline with the CLIP text tower — see models/clip_text.py and
tools in the reference's tools/clip_concept_extraction/).
"""

COMBINED_DATASETS_CATEGORY_INFO = {
    "imagenet": (1000, 0),
    "lvis": (1203, 1000),
    "burst": (1203, 1000),
    "ytvis21": (40, 2203),
    "ovis": (25, 2243),
    "bdd_track": (8, 2268),
    "objects365": (365, 2276),
    "coco_panoptic": (133, 2641),
    "coco": (80, 2641),
    "ade20k": (150, 2774),
    "vipseg": (124, 2924),
    "vspw": (124, 2924),
    "viposeg": (124, 2924),
    "ytvis19": (40, 3048),
    "entityseg_instance": (206, 3088),
    "entityseg_panoptic": (644, 3294),
}

TOTAL_CATEGORY_ROWS = 3938


def dataset_namespace(dataset_name: str) -> str:
    """Full registered dataset name -> category namespace key
    (e.g. 'ytvis_2021_train' -> 'ytvis21')."""
    n = dataset_name.lower()
    for key in (
        "ytvis_2021", "ytvis21", "ytvis_2019", "ytvis19", "ovis", "vipseg",
        "vspw", "viposeg", "coco_panoptic", "coco", "ade20k", "lvis", "burst",
        "objects365", "imagenet", "bdd", "entityseg_panoptic", "entityseg",
    ):
        if key in n:
            return {
                "ytvis_2021": "ytvis21",
                "ytvis_2019": "ytvis19",
                "bdd": "bdd_track",
                "entityseg": "entityseg_instance",
            }.get(key, key)
    raise KeyError(f"no category namespace for dataset {dataset_name!r}")
