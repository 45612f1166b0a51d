"""``vss_stream``: one client's VSS loop, ``EntityDriver.run_vss`` over
each video in turn.  The comparison reads, at the kept clips of the kept
videos, the decoder (class and mask logits) and the label law: the
widest gap by which the evidence of the program's label lies below the
reference's best."""

from __future__ import annotations

from typing import Dict

from benchmark.harness import compare, faults
from benchmark.harness.loops import Stream
from benchmark.reference.quant import fp8_control


class Loop(Stream):
    controls = ("fp8", "label_shift")

    def setup(self) -> None:
        self.driver.run_vss(self.warm, self.cls_emb)
        self.clips_per_video = -(-self.V // self.pcfg.inference.num_frames)

    def begin(self) -> None:
        pass

    def step(self) -> None:
        if self.tap is not None:
            self.tap.next_video(self.k)
        with self.ranges.span("run_vss"):
            labels = self.driver.run_vss(self.video(self.k), self.cls_emb)
        if self.k in self.keep:
            self.outputs[self.k] = labels
        self.k += 1
        self.done += 1

    def end(self) -> None:
        pass

    def judge(self, prog: Dict, control=None) -> Dict[str, float]:
        """The decoder at the kept clips, as a ratio to the compute-dtype
        reference's error, and the labels.  ``label_shift``: the program's
        labels of each kept clip's first frame moved on by one class."""
        T = self.rcfg.inference.num_frames
        ref = self.reference()
        clips = {v: self.targets[v] for v in self.kept_videos}
        args = (self.kept_videos, clips, self.cls_emb, self.device)
        other = compare.vss_other_side(ref, *args)
        side = {"dec": prog["dec"], "labels": prog["outputs"]}
        if control == "fp8":
            side = compare.vss_as_program(compare.vss_other_side(fp8_control(ref), *args),
                                          {v: f.shape[:3] for v, f in self.kept_videos.items()}, T)
        elif control == "label_shift":
            labels = {v: lab.copy() for v, lab in prog["outputs"].items()}
            for v, cs in clips.items():
                for c in cs:
                    labels[v][c * T:] = faults.shift_labels(labels[v][c * T:],
                                                            self.traffic["classes"])
            side = {"dec": prog["dec"], "labels": labels}
        low = compare.vss_other_side(self.reference(compute=True), *args)
        numbers = compare.vss_numbers(side, other, T)
        numbers.update(compare.ratios(side["dec"], other, low, list(other),
                                      (("logit", "pred_logits"), ("mask", "pred_masks"))))
        return numbers
