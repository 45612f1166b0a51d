"""Backbone families, found by name as kinds and metric readers are.

A backbone's family is the leading run of letters of its name
(``resnet50`` -> ``resnet``, ``swin_large`` -> ``swin``, ``pvt_v2_b5`` ->
``pvt``), and its module is ``<family>.py`` in this folder.  The module
provides:

- ``build(cfg)``: the plain float32 reference backbone from a backbone
  config, under the program's parameter names, with ``out_channels``;
- ``flops(backbone_tree, H, W) -> (operations, {res2..res5: channels})``:
  its model operations for one frame, from the configuration file's
  ``backbone`` tree (the yardstick of ``harness/flops.py``);
- optionally ``leaf_rule(module, leaf)``: the seeded draw, (kind, scale)
  as ``harness/weights.py`` reads it, of leaves only this family has
  (None for a leaf it has no rule for);
- optionally ``KEYS``: each config key the family reads beyond
  ``config.BackboneConfig``'s fields, with its default.

So a later family is one new file here, beside a configuration file and
a cell's entries; nothing else names it.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import os
import re
from types import ModuleType

DIR = os.path.dirname(os.path.abspath(__file__))


def family_name(name: str) -> str:
    """The leading run of letters of a backbone's name."""
    m = re.match(r"[A-Za-z]+", name)
    return m.group(0) if m else ""


def family(name: str) -> ModuleType:
    """The family module of backbone ``name``; a ``ValueError`` that names
    the file looked for when there is none."""
    fam = family_name(name)
    path = os.path.join(DIR, f"{fam}.py")
    if not fam or not os.path.isfile(path):
        raise ValueError(f"no backbone family for {name!r}: {path} does not exist")
    return importlib.import_module(f"{__name__}.{fam}")


@functools.lru_cache(maxsize=None)
def config_class(name: str) -> type:
    """``BackboneConfig`` with the fields of the family's ``KEYS`` added
    (frozen, with their defaults): the class a configuration of backbone
    ``name`` is built into."""
    from benchmark.reference.config import BackboneConfig

    keys = getattr(family(name), "KEYS", {})
    if not keys:
        return BackboneConfig
    taken = {f.name for f in dataclasses.fields(BackboneConfig)} & set(keys)
    if taken:
        raise ValueError(f"{family_name(name)}.KEYS redeclares {sorted(taken)}")
    fields = [(k, type(v), dataclasses.field(default=v)) for k, v in keys.items()]
    return dataclasses.make_dataclass(f"{family_name(name).capitalize()}BackboneConfig",
                                      fields, bases=(BackboneConfig,), frozen=True)


def build_backbone(cfg):
    """The reference backbone of ``cfg`` (a backbone config), built by its
    family's ``build``."""
    return family(cfg.name).build(cfg)
