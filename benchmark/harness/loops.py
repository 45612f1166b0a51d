"""What the closed loops that drive the program share.

A traffic mix is a data file; its ``kind`` names the loop, the class
``Loop`` of ``<bench>/kinds/<kind>.py`` (found by name, as a metric's
reader is), and its other keys are the loop's parameters (sizes,
counts, how many units the traced part of a traced run covers, how many
units the comparison reads).  A loop builds the program's entry from the benchmark's weights,
makes its inputs from the seed and warms up the shapes it will use
(set-up); the window then runs ``begin``, ``step`` until its time is
spent, and ``end``: every unit started in the window finishes in it.
What the timed path produced is kept for the comparison: ``take`` hands
it over and frees the program, ``judge`` compares it with the plain
reference; with a ``control`` named in the kind's ``controls`` (the
reference computed in fp8, or a fault planted in the reference put in
the program's place) another side takes the program's place.
"""

from __future__ import annotations

import dataclasses
import gc
import math
from typing import Callable, Dict, List

import numpy as np
import torch

from benchmark.harness import inputs
from benchmark.harness.trace import Ranges


def _clone(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


class FirstProca:
    """A wrapper around a decoder's prompt cross-attention (its
    ``_proca``, set on the instance) that keeps, while ``on()`` holds, the
    prompt rows [frames x prompts, C] of the first layer's result: the
    pool's prompts after reading their kv, before any masked attention;
    ``remove`` puts the decoder's own back."""

    def __init__(self, decoder: torch.nn.Module, on: Callable[[], bool] = lambda: True):
        self.decoder, self.rows = decoder, None
        self.own = vars(decoder).get("_proca")
        inner, Ql = decoder._proca, decoder.num_queries

        def proca(i, output, *args):
            out = inner(i, output, *args)
            if i == 0 and on():
                self.rows = out[:, Ql:].detach().reshape(-1, out.shape[-1]).clone()
            return out

        decoder._proca = proca

    def remove(self) -> None:
        if self.own is None:
            del self.decoder._proca
        else:
            self.decoder._proca = self.own


class DecoderTap:
    """A forward hook on the program's decoder that keeps, for the
    (video, call) pairs in ``targets``, a copy of the call's visual
    prompts, its outputs and its first prompt cross-attention's prompt
    rows.  ``video`` is set by the loop; calls are counted within a video
    (one call per clip)."""

    def __init__(self, decoder: torch.nn.Module, targets: Dict[int, List[int]]):
        self.targets = targets
        self.video = -1
        self.call = 0
        self.kept: Dict[tuple, dict] = {}
        self.first = FirstProca(decoder, self._kept_call)
        self.handle = decoder.register_forward_hook(self._hook, with_kwargs=True)

    def next_video(self, video: int) -> None:
        self.video, self.call = video, 0

    def _kept_call(self) -> bool:
        return self.call in self.targets.get(self.video, ())

    def _hook(self, _mod, _args, kwargs, out):
        if self._kept_call():
            vp = kwargs.get("visual_prompts")
            self.kept[(self.video, self.call)] = {
                "visual_prompts": None if vp is None else _clone(vars(vp)),
                **{k: _clone(out[k][0]) for k in ("pred_logits", "pred_masks", "pred_embds")},
                "proca0": self.first.rows,
            }
            self.first.rows = None
        self.call += 1

    def remove(self) -> None:
        self.handle.remove()
        self.first.remove()


class StepTap:
    """A wrapper around the driver's ``entity_clip_step`` (where the driver
    calls it) that keeps, for the (video, clip) pairs in ``targets``, the
    clip's arguments, a copy of the pool before and after the step and the
    step's features; ``restore`` puts the program's function back."""

    def __init__(self, targets: Dict[int, List[int]], video):
        from univs_tpu_torch.inference import driver

        self.targets, self.video, self.clip = targets, video, 0
        self.kept: Dict[tuple, dict] = {}
        self._driver, self._inner = driver, driver.entity_clip_step
        driver.entity_clip_step = self._step

    def next_video(self) -> None:
        self.clip = 0

    def _step(self, modules, encoded, pool, frame_indices, clip_offset, is_first_clip, cls_emb,
              cc, thing_mask=None):
        key = (self.video(), self.clip)
        self.clip += 1
        if key[1] not in self.targets.get(key[0], ()):
            return self._inner(modules, encoded, pool, frame_indices, clip_offset, is_first_clip,
                               cls_emb, cc, thing_mask)
        rec = {"before": _clone(vars(pool)), "encoded": _clone(encoded),
               "args": (list(frame_indices), int(clip_offset), bool(is_first_clip)),
               "cc": dataclasses.asdict(cc)}
        out = self._inner(modules, encoded, pool, frame_indices, clip_offset, is_first_clip,
                          cls_emb, cc, thing_mask)
        rec["after"] = _clone(vars(pool))
        self.kept[key] = rec
        return out

    def restore(self) -> None:
        self._driver.entity_clip_step = self._inner


class Loop:
    """The base of every kind: ``chips`` lists the card counts it runs
    on, ``controls`` the sides that ``judge`` can put in the program's
    place; ``asked`` (set before ``setup``) the controls this run will
    judge, for a kind that reads one at set-up."""

    chips = (1,)
    controls = ("fp8",)
    asked: tuple = ()

    def __init__(self, program_cfg, ref_cfg, state, traffic: dict, seed: int, seconds: float,
                 device, ranges: Ranges):
        self.pcfg, self.rcfg, self.state = program_cfg, ref_cfg, state
        self.traffic, self.seed, self.seconds = traffic, seed, seconds
        self.device, self.ranges = device, ranges

    def _free_cuda(self) -> None:
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, cfg=None, compute: bool = False):
        """The plain reference in float32, or (``compute``) in the
        configuration's compute dtype as the program holds its weights."""
        from benchmark.reference.univs import build_reference, strict_float32

        strict_float32()
        return build_reference(cfg or self.rcfg, self.state, self.device, compute=compute)

    def extra(self) -> Dict[str, float]:
        return {}

    def peak_bytes(self) -> int:
        """The peak device memory of the run (the fullest card's)."""
        return torch.cuda.max_memory_allocated()

    def busy_s(self, tr) -> float:
        """Seconds in which an operation ran on the device in the traced
        part ``tr``, averaged over the cards the run uses."""
        return tr.busy_us() * 1e-6


class Stream(Loop):
    """What the inference loops share: the driver over the benchmark's
    weights, the videos, the class bank and the decoder tap.  The
    comparison reads video 0 and one of videos 1-3 of the window, and in
    each the first clip and ``check_clips`` - 1 more, drawn from the seed."""

    def __init__(self, *args):
        super().__init__(*args)
        from univs_tpu_torch.inference.driver import EntityDriver
        from univs_tpu_torch.models.univs import build_model

        t, dev = self.traffic, self.device
        V, H, W = t["frames"], t["height"], t["width"]
        self.V = V
        with torch.device(dev):
            model = build_model(self.pcfg, self.state, device=dev)
        self.driver = EntityDriver(self.pcfg, model, num_classes=t["classes"],
                                   capacity=t["capacity"], device=dev)
        self.model = model
        self.ranges.hook_modules({"backbone": model.backbone, "pixel_decoder": model.pixel_decoder,
                                  "decoder": model.decoder})
        # enough distinct videos for the window at the fastest rate the mix
        # expects, and one ahead; past that the loop wraps
        n = int(math.ceil(self.seconds * t["max_videos_per_s"])) + 3
        self.videos = inputs.noise_videos(self.seed, 2, n, V, H, W, dev)
        self.warm = inputs.noise_videos(self.seed, 3, 1, V, H, W, dev)[0]
        self.cls_emb = inputs.class_bank(self.seed, t["classes"],
                                         self.pcfg.decoder.clip_cls_emb_dim, dev)
        self.k = 0  # videos started in the window
        self.done = 0  # videos finished in the window
        self.outputs: Dict[int, object] = {}
        self.keep = set()
        self.tap = None

    def video(self, k: int) -> np.ndarray:
        return self.videos[k % len(self.videos)]

    def arm(self) -> None:
        videos = inputs.draw_indices(self.seed, 11, 2, 0, 4, always=(0,))
        self.targets = {v: inputs.draw_indices(self.seed, 12 + v, self.traffic["check_clips"], 0,
                                               self.clips_per_video, always=(0,))
                        for v in videos}
        self.keep = set(self.targets)
        self.tap = DecoderTap(self.model.decoder, self.targets)

    def work(self) -> Dict[str, float]:
        return {"videos": self.done, "frames": self.done * self.V,
                "clips": self.done * self.clips_per_video}

    def extra(self) -> Dict[str, float]:
        return {"clips_per_video": self.clips_per_video}

    def take(self) -> Dict:
        self.kept_videos = {v: self.video(v) for v in self.outputs}
        prog = {"dec": self.tap.kept, "outputs": self.outputs}
        self.tap.remove()
        self.ranges.remove_hooks()
        del self.driver, self.model, self.tap
        self._free_cuda()
        return prog
