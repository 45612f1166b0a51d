"""``train_ddp``: the detection step under data parallelism, one process a card.

``ranks`` processes (``harness/ranks.py``): rank 0 is the benchmark's
own process, which ``record`` traces and which times the window; ranks
1..n-1 are this module run as a script (``python -m
benchmark.kinds.train_ddp <arguments>``), spawned at set-up.  Every rank
draws the same seeded weights on its own card, and set-up checks that
they agree bit for bit; rank 0 draws the ``batches`` distinct global
batches of ``clips`` clips and hands them to every rank (a broadcast:
the CPU's elementwise laws may round a pixel of the blob frames
otherwise in another process).  Each rank takes its contiguous shard of
each (``ddp.shard_batch``: the draws at the global batch's addresses
are the program's), builds the program from the weights and steps
through ``ddp.make_train_step`` over NCCL (gloo on the CPU).  A closed
loop: each step starts when every rank has finished the last (the
step's first collective waits for all).  Set-up drives the
same state through its first ``compare_steps`` steps, one on each global
batch; the window goes on with it.

The comparison is ``train_step``'s numbers against the reference's one
process over the whole global batch (``reference/parallel/ddp.py``'s
``BatchShard.whole``), in float32 with TF32 off and its blocks
recomputed in the backward, plus ``rank_diff``: the largest difference
between the ranks' float32 masters after the compared steps (0 when
sound: every rank steps on the same all-reduced gradient).  Controls:
``fp8``, the reference in fp8 in the program's place; ``no_allreduce``,
a fault planted in the program (each rank steps on its own shard's
gradient), read from the same steps run again from the seeded state
before the sound ones.

Rank 0 reports its own trace; the device's busy time is the mean of
every rank's over the first traced part (the other ranks start their
profiler once in set-up, so that its start-up falls outside the traced
window), and the peak memory the fullest card's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Dict, List

import torch

from benchmark.harness import configs, inputs, loops, ranks, weights
from benchmark.harness.trace import Trace, record
from benchmark.reference.quant import fp8_control

STEP, COMPARE, FAULT, TRACE, REPORT, TRACE_END, WARM = 1, 2, 3, 4, 5, 6, 7


def _threads(world: int) -> None:
    """The host's cores shared between the ranks."""
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))


def share_batches(batches, channel, device) -> List[Dict[str, torch.Tensor]]:
    """Rank 0's ``batches`` (host tensors) on every rank: their shapes and
    dtypes over the command channel, the tensors over the program's group
    through the card."""
    import torch.distributed as dist

    rank0 = dist.get_rank() == 0
    meta = [[{k: (tuple(v.shape), str(v.dtype)) for k, v in b.items()} for b in batches]
            if rank0 else None]
    dist.broadcast_object_list(meta, 0, group=channel)
    dtypes = {str(d): d for d in (torch.uint8, torch.int32, torch.int64, torch.float32,
                                  torch.bool)}
    out = []
    for i, spec in enumerate(meta[0]):
        b = {}
        for k, (shape, dt) in spec.items():
            t = (batches[i][k].to(device) if rank0
                 else torch.empty(shape, dtype=dtypes[dt], device=device))
            wide = t.to(torch.uint8) if t.dtype == torch.bool else t
            dist.broadcast(wide, 0)
            b[k] = batches[i][k] if rank0 else wide.to(t.dtype).cpu()
        out.append(b)
    return out


class Rank:
    """One rank's side of the program: the global batches, its shard of
    each, the model, the float32 train state and the data-parallel step."""

    def __init__(self, pcfg, state, batches, seed: int, device, rank: int, world: int,
                 timings=None):
        self.pcfg, self.state, self.batches = pcfg, state, batches
        self.seed, self.device, self.rank, self.world = seed, device, rank, world
        self.timings = timings
        self.build()

    def build(self) -> None:
        """The program from the seeded weights: model, state, step."""
        from univs_tpu_torch.models.univs import build_model
        from univs_tpu_torch.parallel import ddp
        from univs_tpu_torch.parallel.train_state import create_train_state
        from univs_tpu_torch.utils.draws import make_key

        self.model = self.tstate = self.train_step = None
        loops.Loop._free_cuda(self)
        with torch.device(self.device):
            self.model = build_model(self.pcfg, self.state, device=self.device)
        self.tstate = create_train_state(self.pcfg, self.model)
        self.train_step = ddp.make_train_step(self.pcfg, self.model, "detection",
                                              timings=self.timings)
        self.key = make_key(self.seed % (2 ** 63), device=self.device)

    def batch(self, k: int):
        """This rank's shard of global batch ``k`` (cycled), on its card."""
        from univs_tpu_torch.losses.criterion import TrainTargets
        from univs_tpu_torch.parallel import ddp
        from univs_tpu_torch.parallel.train_state import TrainBatch

        b = self.batches[k % len(self.batches)]
        targets = TrainTargets(labels=b["labels"], ids=b["ids"], masks=b["masks"],
                               valid=b["valid"], prompt_obj_ids=b["prompt_obj_ids"])
        whole = TrainBatch(images=b["images"], frame_indices=b["frame_indices"], targets=targets,
                           prompt_category_embs=b["prompt_category_embs"],
                           prompt_category_valid=b["prompt_category_valid"],
                           category_bank=b["category_bank"],
                           category_bank_valid=b["category_bank_valid"])
        return ddp.shard_batch(whole, self.rank, self.world).to(self.device)

    def run(self, k: int):
        _, logged = self.train_step(self.tstate, self.batch(k), self.key)
        return logged

    def compare(self, n: int) -> Dict:
        """The first ``n`` steps from the state as it is: each step's
        global loss, this rank's first gradient as Adam got it (tensors
        and norms) and its masters' change, and ``rank_diff``."""
        from univs_tpu_torch.parallel.train_state import B1

        start = {k: v.detach().to("cpu", copy=True) for k, v in self.tstate.params.items()}
        losses, grad1, grad1_t = [], {}, {}
        for s in range(n):
            losses.append(float(self.run(s)["total_loss"]))
            if s == 0:
                grad1_t = {k: (v / (1 - B1)).to("cpu") for k, v in self.tstate.mu.items()}
                grad1 = {k: float(v.norm()) for k, v in grad1_t.items()}
        delta = {k: float((v.detach().cpu() - start[k]).norm())
                 for k, v in self.tstate.params.items()}
        return {"losses": losses, "grad1": grad1, "grad1_tensors": grad1_t, "delta": delta,
                "rank_diff": self.spread(self.tstate.params.values())}

    def fault(self, n: int) -> Dict:
        """``compare`` with the gradients' all-reduce left out (each rank
        steps on its own shard's gradient), from the seeded state; then
        the program is built again from it."""
        from univs_tpu_torch.parallel import train_state

        inner = train_state._group_grads
        train_state._group_grads = lambda st, names, named, group=None, share=None: inner(
            st, names, named, None, share)
        try:
            out = self.compare(n)
        finally:
            train_state._group_grads = inner
        self.build()
        return out

    def spread(self, tensors) -> float:
        """The largest difference between the ranks' copies of
        ``tensors``: max over ranks less min over ranks, elementwise."""
        import torch.distributed as dist

        flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
        hi, lo = flat.clone(), flat
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        return float((hi - lo).max())

    def start_diff(self) -> float:
        """``spread`` of the seeded weights."""
        return self.spread(self.state.values())

    def free(self) -> None:
        self.model = self.tstate = self.train_step = None
        self.batches = self.state = None
        loops.Loop._free_cuda(self)


def _program_side(pcfg_tree: dict, rcfg_tree: dict, seed: int, device, rank: int, world: int,
                  channel) -> Rank:
    """A spawned rank's side: the seeded weights drawn here, rank 0's
    batches."""
    from benchmark.reference.univs import UniVSModel

    pcfg, rcfg = configs.program_config(pcfg_tree), configs.reference_config(rcfg_tree)
    with torch.device("meta"):
        shapes = UniVSModel(rcfg)
    compute = torch.bfloat16 if pcfg.dtype == "bfloat16" else torch.float32
    state = weights.seeded_state(shapes, seed, device, compute)
    return Rank(pcfg, state, share_batches([], channel, device), seed, device, rank, world)


def _tree(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


class Loop(loops.Loop):
    chips = (4,)
    controls = ("fp8", "no_allreduce")
    # seconds without progress after which a rank counts as stalled: longer
    # than any one step of set-up or of the window, well inside a run's 360
    stall_s = 240.0

    def __init__(self, *args):
        super().__init__(*args)
        t, dev = self.traffic, torch.device(self.device)
        self.world = int(t["ranks"])
        if t["clips"] % self.world:
            raise ValueError(f"a global batch of {t['clips']} clips does not shard over "
                             f"{self.world} ranks")
        _threads(self.world)
        self.card = dev.type == "cuda"
        common = {"pcfg": _tree(self.pcfg), "rcfg": _tree(self.rcfg),
                  "seed": self.seed, "world": self.world, "card": self.card,
                  "stall_s": self.stall_s}
        self.ranks = ranks.Ranks(
            lambda r, port: [sys.executable, "-m", "benchmark.kinds.train_ddp",
                             json.dumps(dict(common, rank=r, port=port))],
            self.world, self.stall_s)
        if self.card:  # the kernels built once, here, before any rank launches one
            from univs_tpu_torch.ops import kernels

            kernels.build()
        self.channel = ranks.join(0, self.world, self.ranks.port, self.device, self.stall_s)
        self.ranks.beat()
        self.timings = {} if self.ranges.modules else None
        self.batches = inputs.train_batches(self.seed, t, self.pcfg.decoder.num_classes,
                                            self.pcfg.decoder.clip_cls_emb_dim, self.device)
        self.prog = Rank(self.pcfg, self.state, share_batches(self.batches, self.channel, dev),
                         self.seed, self.device, 0, self.world, self.timings)
        diff = self.prog.start_diff()
        if diff != 0:
            raise RuntimeError(f"the ranks' seeded weights differ by {diff}")
        self.jv: List[float] = []
        self._restore = None
        self.k = self.done = 0
        self.last = None
        self.traced = False
        self.busy: List[float] = []
        self.fault_side = None
        self.ranks.beat()

    # the host-clock and range wrappers of a traced run are train_step's
    def _time_host_jv(self) -> None:
        from benchmark.kinds import train_step

        train_step.Loop._time_host_jv(self)

    def _command(self, cmd: int, arg: int = 0) -> None:
        ranks.broadcast(self.channel, cmd, arg)
        self.ranks.beat()

    def setup(self) -> None:
        n = self.traffic["compare_steps"]
        if "no_allreduce" in self.asked:
            self._command(FAULT, n)
            self.fault_side = self.prog.fault(n)
            self.ranks.beat()
        self._command(COMPARE, n)
        self.readings = self.prog.compare(n)
        self.ranks.beat()
        self.k = n
        model = self.prog.model  # the one the window steps (the fault builds its own)
        self.ranges.hook_modules({"backbone": model.backbone,
                                  "pixel_decoder": model.pixel_decoder, "decoder": model.decoder})
        if self.ranges.modules:
            self._time_host_jv()
        if self.timings is not None:
            self.timings.clear()

    def arm(self) -> None:
        if self.ranges.modules:  # the other ranks' profiler started once in set-up
            self._command(WARM)

    def begin(self) -> None:
        if self.ranges.modules and not self.traced:  # the other ranks trace the first part
            self._command(TRACE)

    def step(self) -> None:
        self._command(STEP, self.k)
        with self.ranges.span("step"):
            self.last = self.prog.run(self.k)["total_loss"]
        self.k += 1
        self.done += 1
        self.ranks.beat()

    def end(self) -> None:
        if self.last is not None:
            float(self.last)
        if self.ranges.modules and not self.traced:
            self.traced = True
            self._command(TRACE_END)
        self.ranks.beat()

    def work(self) -> Dict[str, float]:
        c = self.traffic["clips"]
        return {"steps": self.done, "clips": self.done * c,
                "frames": self.done * c * self.traffic["frames"]}

    def extra(self) -> Dict[str, float]:
        out = {f"program.{k}": v for k, v in (self.timings or {}).items()}
        if self._restore is not None:
            out["host_jv_s"] = sum(self.jv)
        return out

    def peak_bytes(self) -> int:
        """The fullest card's peak, from every rank's report, which also
        brings the other ranks' busy seconds for ``busy_s``."""
        self._command(REPORT)
        rows = ranks.report(self.channel, _own_report(0.0))
        self.busy = [r[1] for r in rows[1:]]
        return int(max(r[0] for r in rows))

    def busy_s(self, tr: Trace) -> float:
        return (tr.busy_us() * 1e-6 + sum(self.busy)) / self.world

    def take(self) -> Dict:
        if self._restore is not None:
            self._restore()
        self.ranges.remove_hooks()
        self.ranks.close(self.channel)
        self.prog.free()
        self._free_cuda()
        return self.readings

    def _reference_steps(self, model) -> Dict:
        from benchmark.reference.train import train_steps
        from benchmark.reference.utils.draws import make_key

        n = self.traffic["compare_steps"]
        batches = [{k: v.to(self.device) for k, v in self.batches[s].items()} for s in range(n)]
        return train_steps(model, batches, make_key(self.seed % (2 ** 63), device=self.device), n)

    def judge(self, prog: Dict, control=None) -> Dict[str, float]:
        """``train_step``'s numbers against the reference over the global
        batch, and ``rank_diff``.  In the program's place: ``fp8``, the
        reference in fp8 (one process: its ``rank_diff`` is 0);
        ``no_allreduce``, the program with the fault, as read at set-up."""
        from benchmark.reference.train import train_numbers

        rc = self.rcfg.replace(
            backbone=dataclasses.replace(self.rcfg.backbone, swin_use_checkpoint=True),
            decoder=dataclasses.replace(self.rcfg.decoder, remat_heads=True))
        side = prog
        if control == "fp8":
            side = dict(self._reference_steps(fp8_control(self.reference(rc))), rank_diff=0.0)
        elif control == "no_allreduce":
            side = self.fault_side
        self._free_cuda()
        out = train_numbers(side, self._reference_steps(self.reference(rc)))
        out["rank_diff"] = side["rank_diff"]
        return out


def _own_report(busy_s: float) -> List[float]:
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    return [float(peak), busy_s]


def main(arg: str) -> int:
    """A spawned rank: build this rank's side, check it against the others,
    then serve rank 0's commands until it says stop."""
    a = json.loads(arg)
    ranks.exit_when_orphaned()
    rank, world = a["rank"], a["world"]
    _threads(world)
    device = torch.device("cuda", rank) if a["card"] else torch.device("cpu")
    channel = ranks.join(rank, world, a["port"], device, a["stall_s"])
    side = _program_side(a["pcfg"], a["rcfg"], a["seed"], device, rank, world, channel)
    side.start_diff()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    busy = [0.0]

    def traced(_):
        tr = record(lambda: ranks.serve(channel, handlers, until=TRACE_END) or {}, sync,
                    host_ops=False)
        busy[0] = tr.busy_us() * 1e-6

    handlers = {STEP: side.run, COMPARE: side.compare, FAULT: side.fault, TRACE: traced,
                WARM: lambda _: record(dict, sync, host_ops=False),
                REPORT: lambda _: ranks.report(channel, _own_report(busy[0]))}
    ranks.serve(channel, handlers)
    ranks.leave()
    return 0


if __name__ == "__main__":
    code = main(sys.argv[1])
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # not through the interpreter's shutdown: the stdin watch still reads
