"""``vis_stream``: one client's steady VIS loop over ``EntityDriver``.

Video k + 1's ``start_vis`` (which uploads video k + 2 after its
compute) is dispatched before video k's ``finish_vis``.  The comparison
reads, at the kept clips of the kept videos, the decoder over all query
rows and over the prompt rows alone, and the prompt rows after the first
prompt cross-attention (the sot path: the pool's prompts reading their
kv, before any masked attention), the first clip's pool read and the
clip step by themselves, and the drain with its RLEs by itself.
"""

from __future__ import annotations

from typing import Dict

from benchmark.harness import compare, faults
from benchmark.harness.loops import StepTap, Stream
from benchmark.reference.quant import fp8_control

NAMES = (("logit", "pred_logits"), ("mask", "pred_masks"), ("embd", "pred_embds"))


class Loop(Stream):
    controls = ("fp8", "prompt_skip")

    def setup(self) -> None:
        from benchmark.reference.univs import iter_clips

        d, inf = self.driver, self.pcfg.inference
        h = d.start_vis(self.warm, self.cls_emb, next_frames=self.warm)
        h2 = d.start_vis(h["next_frames_device"], self.cls_emb, next_frames=self.warm)
        d.finish_vis(h)
        d.finish_vis(h2)
        self.clips_per_video = len(list(iter_clips(self.V, inf.num_frames, inf.clip_stride,
                                                   inf.num_frames_window)))

    def arm(self) -> None:
        super().arm()
        self.steps = StepTap(self.targets, lambda: self.tap.video)
        self.drains: Dict[int, dict] = {}

    def _start(self, frames):
        if self.tap is not None:
            self.tap.next_video(self.k)
            self.steps.next_video()
        with self.ranges.span("start_vis"):
            h = self.driver.start_vis(frames, self.cls_emb, next_frames=self.video(self.k + 1))
        h["video"] = self.k
        self.k += 1
        return h

    def _finish(self, h) -> None:
        v = h["video"]
        if v in self.keep:  # the windows as the drain gets them, and the final valid
            self.drains[v] = {"emitted": [w.clone() for w in h["emitted"]],
                              "starts": list(h["emit_starts"]), "valid": h["pool"].valid.clone(),
                              "V": h["V"]}
        with self.ranges.span("finish_vis"):
            results = self.driver.finish_vis(h)
        if v in self.keep:
            self.outputs[v] = results
        self.done += 1

    def begin(self) -> None:
        self.h = self._start(self.video(self.k))

    def step(self) -> None:
        nxt = self._start(self.h["next_frames_device"])
        self._finish(self.h)
        self.h = nxt

    def end(self) -> None:
        self._finish(self.h)
        self.h = None

    def take(self) -> Dict:
        self.steps.restore()
        prog = super().take()
        prog.update(steps=self.steps.kept, drains=self.drains)
        return prog

    def judge(self, prog: Dict, control=None) -> Dict[str, float]:
        """The decoder at the kept clips (on the program's pool, encoded by
        the reference) as ratios to the compute-dtype reference's error,
        over all rows and over the prompt rows; the first clip's pool
        read; the clip step at the kept clips on the program's pool,
        features and decoder outputs; the drain on the program's windows."""
        t, rc = self.traffic, self.rcfg
        H, W = t["height"], t["width"]
        ref = self.reference()
        args = (self.kept_videos, self.cls_emb, prog["dec"], self.device)
        other = compare.vis_decoder_side(ref, *args)
        side = prog["dec"]
        if control == "fp8":
            side = compare.vis_decoder_side(fp8_control(ref), *args)
        elif control == "prompt_skip":
            side = compare.vis_decoder_side(faults.prompt_skip(ref), *args)
        low = compare.vis_decoder_side(self.reference(compute=True), *args)
        expected = [(v, c) for v in self.kept_videos for c in self.targets[v]]
        numbers = compare.decoder_numbers(side, other, expected, NAMES)
        numbers.update(compare.ratios(side, other, low, expected, NAMES))
        numbers.update(compare.ratios(side, other, low, expected, NAMES,
                                      rows=slice(rc.decoder.num_queries, None), prefix="prompt_"))
        numbers.update(compare.ratios(side, other, low, expected, (("proca", "proca0"),)))
        p = rc.prompt
        numbers["start_diff"] = float(sum(
            compare.empty_pool_read(prog["dec"][(v, 0)], t["capacity"], t["classes"],
                                    rc.decoder.hidden_dim, (H // 4, W // 4),
                                    rc.inference.num_frames, p.num_dense_points_test,
                                    rc.inference.clip_stride, p.num_prev_frames_memory, self.device)
            for v in self.kept_videos if (v, 0) in prog["dec"]))
        numbers["step_diff"] = compare.clip_step_diff(ref, prog["steps"], prog["dec"], expected,
                                                      self.cls_emb)
        numbers["drain_diff"] = compare.drain_diff(prog["drains"], prog["outputs"], (H, W))
        numbers["entities"] = float(sum(len(r) for r in prog["outputs"].values()))
        return numbers
