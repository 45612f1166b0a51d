"""A configuration file's ``model`` tree as a config object: the same
nested dataclasses in the program (``univs_tpu_torch.config``) and in
the reference (``benchmark/reference/config.py``), which share field
names.  A key the dataclass lacks raises, so a file cannot state a size
that neither side reads; on the reference's side a backbone key may also
be one that the backbone's family declares in its ``KEYS``
(``reference/models/backbones/<family>.py``), which the family's
``build`` reads."""

from __future__ import annotations

import dataclasses
from typing import Any


def build(cls, tree: dict) -> Any:
    """``cls`` (a frozen dataclass with defaults) with the fields of
    ``tree`` set; nested dicts build the nested dataclasses, lists become
    tuples."""
    default = cls()
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(tree) - names)
    if unknown:
        raise KeyError(f"{cls.__name__} has no field {unknown}")
    values = {}
    for key, v in tree.items():
        cur = getattr(default, key)
        if dataclasses.is_dataclass(cur):
            values[key] = build(type(cur), v)
        elif isinstance(v, list):
            values[key] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        else:
            values[key] = v
    return dataclasses.replace(default, **values)


def program_config(model: dict):
    from univs_tpu_torch.config import UniVSConfig

    return build(UniVSConfig, model)


def reference_config(model: dict):
    """The reference's config; its backbone built into the family's class
    (``BackboneConfig`` with the family's ``KEYS`` added)."""
    from benchmark.reference.config import BackboneConfig, UniVSConfig
    from benchmark.reference.models.backbones import config_class

    tree = dict(model)
    backbone = tree.pop("backbone", {})
    cls = config_class(backbone.get("name", BackboneConfig.name))
    return build(UniVSConfig, tree).replace(backbone=build(cls, backbone))
