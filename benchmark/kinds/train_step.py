"""``train_step``: a trainer's loop over ``make_train_step``.

The detection step on ``batches`` distinct pre-collated batches, cycled,
each moved to the card at its step.  Set-up builds the state and the
step and drives them from the seed through their first
``compare_steps`` steps (one on each batch when the two are equal, so
that every batch the window feeds has been judged); the window goes on
with the same state and step.  The comparison reads each compared step's
loss, the first gradient as Adam got it and the masters' change over the
steps, against the reference following the same steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from benchmark.harness import inputs, loops
from benchmark.reference.quant import fp8_control


class Loop(loops.Loop):
    controls = ("fp8", "half_batch", "witness_bf16")

    def __init__(self, *args):
        super().__init__(*args)
        from univs_tpu_torch.models.univs import build_model
        from univs_tpu_torch.parallel.train_state import create_train_state, make_train_step
        from univs_tpu_torch.utils.draws import make_key

        t, dev = self.traffic, self.device
        self.batches = inputs.train_batches(self.seed, t, self.pcfg.decoder.num_classes,
                                            self.pcfg.decoder.clip_cls_emb_dim, dev)
        with torch.device(dev):
            model = build_model(self.pcfg, self.state, device=dev)
        self.model = model
        self.tstate = create_train_state(self.pcfg, model)
        self.timings = {} if self.ranges.modules else None
        self.train_step = make_train_step(self.pcfg, model, "detection", timings=self.timings)
        self.key = make_key(self.seed % (2 ** 63), device=dev)
        self.ranges.hook_modules({"backbone": model.backbone, "pixel_decoder": model.pixel_decoder,
                                  "decoder": model.decoder})
        self.jv: List[float] = []
        self._restore = None
        if self.ranges.modules:
            self._time_host_jv()
        self.k = 0
        self.done = 0
        self.last = None

    def _time_host_jv(self) -> None:
        """In a traced run: host clock around the criterion's one host copy
        and JV walk a step (``hungarian_batch``), and ranges around it, the
        criterion and each group's optimizer update, each wrapped where the
        program calls it (and restored by ``take``)."""
        from univs_tpu_torch.losses import criterion
        from univs_tpu_torch.parallel import train_state

        spans, ranges = self.jv, self.ranges
        saved = [(criterion, "hungarian_batch"), (train_state, "_adamw_group"),
                 (criterion.UniCriterion, "__call__")]
        inner = [getattr(o, n) for o, n in saved]

        def jv(*a, **k):
            t0 = time.perf_counter()
            try:
                with ranges.span("host_jv"):
                    return inner[0](*a, **k)
            finally:
                spans.append(time.perf_counter() - t0)

        def ranged(name, fn):
            def call(*a, **k):
                with ranges.span(name):
                    return fn(*a, **k)
            return call

        for (o, n), f in zip(saved, (jv, ranged("optimizer", inner[1]),
                                     ranged("criterion", inner[2]))):
            setattr(o, n, f)
        self._restore = lambda: [setattr(o, n, f) for (o, n), f in zip(saved, inner)]

    def _batch(self, k: int):
        from univs_tpu_torch.losses.criterion import TrainTargets
        from univs_tpu_torch.parallel.train_state import TrainBatch

        b = self.batches[k % len(self.batches)]
        targets = TrainTargets(labels=b["labels"], ids=b["ids"], masks=b["masks"],
                               valid=b["valid"], prompt_obj_ids=b["prompt_obj_ids"])
        with self.ranges.span("upload"):
            return TrainBatch(images=b["images"], frame_indices=b["frame_indices"],
                              targets=targets, prompt_category_embs=b["prompt_category_embs"],
                              prompt_category_valid=b["prompt_category_valid"],
                              category_bank=b["category_bank"],
                              category_bank_valid=b["category_bank_valid"]).to(self.device)

    def _run(self, k: int):
        batch = self._batch(k)
        with self.ranges.span("step"):
            _, logged = self.train_step(self.tstate, batch, self.key)
        return logged

    def setup(self) -> None:
        from univs_tpu_torch.parallel.train_state import B1

        n = self.traffic["compare_steps"]
        start = {k: v.detach().to("cpu", copy=True) for k, v in self.tstate.params.items()}
        losses, grad1, grad1_t = [], {}, {}
        for s in range(n):
            losses.append(float(self._run(s)["total_loss"]))
            if s == 0:
                grad1_t = {k: (v / (1 - B1)).to("cpu") for k, v in self.tstate.mu.items()}
                grad1 = {k: float(v.norm()) for k, v in grad1_t.items()}
        delta = {k: float((v.detach().cpu() - start[k]).norm())
                 for k, v in self.tstate.params.items()}
        self.readings = {"losses": losses, "grad1": grad1, "grad1_tensors": grad1_t,
                         "delta": delta}
        self.k = n
        if self.timings is not None:
            self.timings.clear()
        self.jv.clear()

    def arm(self) -> None:
        pass

    def begin(self) -> None:
        pass

    def step(self) -> None:
        self.last = self._run(self.k)["total_loss"]
        self.k += 1
        self.done += 1

    def end(self) -> None:
        if self.last is not None:
            float(self.last)

    def work(self) -> Dict[str, float]:
        c = self.traffic["clips"]
        return {"steps": self.done, "clips": self.done * c,
                "frames": self.done * c * self.traffic["frames"]}

    def extra(self) -> Dict[str, float]:
        out = {f"program.{k}": v for k, v in (self.timings or {}).items()}
        if self._restore is not None:
            out["host_jv_s"] = sum(self.jv)
        return out

    def take(self) -> Dict:
        if self._restore is not None:
            self._restore()
        self.ranges.remove_hooks()
        del self.model, self.tstate, self.train_step
        self._free_cuda()
        return self.readings

    def _reference_steps(self, model, half: bool = False) -> Dict:
        """The reference's steps on the compared batches (``half``: the
        first half of each batch's clips only, the planted fault)."""
        from benchmark.reference.train import train_steps
        from benchmark.reference.utils.draws import make_key

        n = self.traffic["compare_steps"]
        keep = self.traffic["clips"] // 2 if half else None
        batches = [{k: (v[:keep] if keep and v.shape[0] == self.traffic["clips"] else v)
                    .to(self.device) for k, v in self.batches[s].items()} for s in range(n)]
        return train_steps(model, batches, make_key(self.seed % (2 ** 63), device=self.device), n)

    def judge(self, prog: Dict, control=None) -> Dict[str, float]:
        """Each compared step's loss, the first gradient and the change
        over the steps, against the reference following the same steps
        (its Swin blocks, encoder layers and heads recomputed in the
        backward, which is exact).  In the program's place: ``fp8``, the
        reference in fp8; ``half_batch``, the reference fed the first half
        of each batch's clips; ``witness_bf16``, the reference computing in
        the configuration's compute dtype over float32 masters, as the
        program trains (no fault: the second witness of what rounding
        alone reads)."""
        from benchmark.reference.train import train_numbers

        rc = self.rcfg.replace(
            backbone=dataclasses.replace(self.rcfg.backbone, swin_use_checkpoint=True),
            decoder=dataclasses.replace(self.rcfg.decoder, remat_heads=True))
        side = prog
        if control == "fp8":
            side = self._reference_steps(fp8_control(self.reference(rc)))
        elif control == "half_batch":
            side = self._reference_steps(self.reference(rc), half=True)
        elif control == "witness_bf16":
            side = self._reference_steps(self.reference(rc, compute=True))
        self._free_cuda()
        return train_numbers(side, self._reference_steps(self.reference(rc)))
