"""Demo: run UniVS with the port on raw videos / image folders and write
overlays (counterpart of the JAX package's ``tools/demo.py``, with the
same arguments and ``--device``).

    python -m univs_tpu_torch.tools.demo --input video.mp4 --output out.avi \\
        --weights univs_r50.pth --bank bank.npy --dataset-ns ytvis21

    # several videos, rendering overlapped with inference:
    python -m univs_tpu_torch.tools.demo --parallel --input a.mp4 b.mp4 c.mp4 \\
        --output outdir/

Runs on the card unless ``--device cpu`` is given (and raises without a
card).  Equivalent of the reference's demo entry (demo/demo.py +
demo/predictor.py VisualizationDemo/VideoPredictor/AsyncPredictor).

Async design: the reference's ``AsyncPredictor`` forks model-worker
processes so that slow visualization in the main process does not starve
the GPU.  Here the card already runs asynchronously to the host (kernel
launches are queued and return), so the split is inverted as in the JAX
tool: inference stays on the main thread and the host-side rendering and
encoding move onto bounded background threads (numpy/cv2 release the
GIL).  Ordering and shutdown semantics match the reference: results are
completed in submission order and ``shutdown()`` drains the queue,
re-raising worker errors.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np


def read_frames(path: str, max_frames: int = 300):
    import cv2

    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*")))[:max_frames]
        return [cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2RGB) for f in files]
    cap = cv2.VideoCapture(path)
    frames = []
    while len(frames) < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return frames


def render_and_write(frames, results, out_path: str, score_thres: float,
                     render_pool: Optional[ThreadPoolExecutor] = None):
    """Rasterize per-frame instance overlays and encode the video.

    With ``render_pool``, per-frame rasterization fans out across the
    pool (frames are independent); encoding stays ordered.  This is the
    per-video unit of work the async pipeline schedules."""
    from univs_tpu_torch.utils.rle import decode as rle_decode
    from univs_tpu_torch.utils.visualization import overlay_instances, write_video

    kept = [r for r in results if float(np.max(r["score"])) >= score_thres]

    def render_one(fi_frame):
        fi, frame = fi_frame
        masks = [rle_decode(r["segmentations"][fi]) for r in kept]
        return overlay_instances(frame, masks)

    items = list(enumerate(frames))
    if render_pool is not None:
        out_frames = list(render_pool.map(render_one, items))
    else:
        out_frames = [render_one(it) for it in items]
    write_video(out_frames, out_path)
    return len(out_frames), len(kept)


class AsyncRenderPipeline:
    """Overlap host-side visualization with device inference
    (reference ``AsyncPredictor`` analogue, demo/predictor.py:122-210 —
    see the module docstring for why the split is inverted here).

    ``put(frames, results, out_path)`` enqueues one video's render job
    on a single ordered writer thread; inside a job, per-frame
    rasterization fans out over ``num_workers`` threads.  The queue is
    bounded (``maxsize = num_workers * 3``, matching the reference) so
    a slow disk cannot buffer unbounded frames in RAM.  ``shutdown()``
    joins the writer and re-raises the first worker error."""

    _STOP = object()

    def __init__(self, score_thres: float, num_workers: int = 2):
        import queue

        self.score_thres = score_thres
        self._tasks: "queue.Queue" = queue.Queue(maxsize=max(num_workers, 1) * 3)
        self._render_pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
        self._done: List[tuple] = []
        self._error: Optional[BaseException] = None
        self._writer = threading.Thread(target=self._run, daemon=True)
        self._writer.start()

    def _run(self):
        while True:
            task = self._tasks.get()
            if task is self._STOP:
                return
            frames, results, out_path = task
            try:
                n, e = render_and_write(
                    frames, results, out_path, self.score_thres, self._render_pool
                )
                self._done.append((out_path, n, e))
            except BaseException as exc:  # surfaced by shutdown()
                if self._error is None:
                    self._error = exc

    def put(self, frames, results, out_path: str):
        self._tasks.put((frames, results, out_path))

    def shutdown(self) -> List[tuple]:
        """Drain the queue; returns [(out_path, n_frames, n_entities)]
        in submission order.  Re-raises the first render error."""
        self._tasks.put(self._STOP)
        self._writer.join()
        self._render_pool.shutdown(wait=True)
        if self._error is not None:
            raise self._error
        return list(self._done)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, nargs="+",
                   help="one or more videos / frame folders")
    p.add_argument("--output", default="demo_out.avi",
                   help="output video path, or a directory for multiple inputs")
    p.add_argument("--weights", default=None)
    p.add_argument("--bank", default=None)
    p.add_argument("--dataset-ns", default="ytvis21")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--score-thres", type=float, default=0.3)
    p.add_argument("--tiny", action="store_true", help="tiny model smoke mode")
    p.add_argument("--max-frames", type=int, default=300)
    p.add_argument("--parallel", action="store_true",
                   help="render overlays on background threads so video k's "
                        "visualization overlaps video k+1's inference "
                        "(reference demo/demo.py --parallel)")
    p.add_argument("--num-render-workers", type=int, default=2)
    p.add_argument("--text", nargs="+", default=None,
                   help="referring expressions: run text-prompted (RefVOS) "
                        "inference instead of category-guided VIS — one "
                        "tracked mask per expression (the reference's "
                        "CUSTOM_VIDEOS_TEXT flow, univs/config.py:151-153)")
    p.add_argument("--clip-weights", default=None,
                   help="CLIP text-tower weights for real expression features "
                        "(without them a seeded random prompt is used and "
                        "masks are smoke-quality only)")
    p.add_argument("--pipeline", action="store_true",
                   help="two-card pipelined streaming (encode on cuda:0, "
                        "decode + memory pool on cuda:1); needs >=2 cards")
    p.add_argument("--batch", type=int, default=1,
                   help="lockstep-batched VIS serving: decode N videos per "
                        "dispatch (BatchedVISServer); inputs are grouped by "
                        "padded resolution")
    p.add_argument("--mask", default=None,
                   help="first-frame mask PNG (DAVIS convention: 0=bg, value "
                        "i=object i) -> prompt-guided VOS on a single video "
                        "(the reference's visual-prompt inference path)")
    p.add_argument("--device", default=None,
                   help="torch device; the card when absent (raises without one), "
                        "'cpu' to run on the CPU")
    return p.parse_args(argv)


def main(argv=None):
    run(parse_args(argv))


def _out_path_for(output: str, inp: str, multi: bool) -> str:
    if not multi and not os.path.isdir(output):
        return output
    os.makedirs(output, exist_ok=True)
    stem = os.path.splitext(os.path.basename(os.path.normpath(inp)))[0]
    return os.path.join(output, f"{stem}_overlay.avi")


def run(args):
    import torch

    from univs_tpu_torch.data.augment import resize_shortest_edge, transformed_image_size
    from univs_tpu_torch.data.category_info import COMBINED_DATASETS_CATEGORY_INFO, TOTAL_CATEGORY_ROWS
    from univs_tpu_torch.inference.driver import EntityDriver, VOSDriver
    from univs_tpu_torch.structures import TextPrompts
    from univs_tpu_torch.tools.run_net import build, build_cfg, text_encoder_from
    from univs_tpu_torch.utils.checkpoint import load_category_bank
    from univs_tpu_torch.utils.device import resolve_device
    from univs_tpu_torch.utils.rle import encode_mask_batch

    class A:  # minimal args shim for build_cfg
        backbone = args.backbone
        num_frames = 5
        bf16 = not getattr(args, "tiny", False)
        tiny = getattr(args, "tiny", False)

    device = resolve_device(getattr(args, "device", None))
    cfg, _ = build_cfg(A)
    bank = load_category_bank(args.bank, TOTAL_CATEGORY_ROWS, cfg.decoder.clip_cls_emb_dim)
    if getattr(args, "tiny", False):
        # tiny decoder has a small embedding width: seeded random bank
        rngb = np.random.RandomState(0)
        bank = rngb.randn(TOTAL_CATEGORY_ROWS, cfg.decoder.clip_cls_emb_dim).astype(np.float32)
    k, start = COMBINED_DATASETS_CATEGORY_INFO[args.dataset_ns]
    cls_slice = bank[start : start + k]

    pipeline_devices = None
    if getattr(args, "pipeline", False):
        from univs_tpu_torch.engine import _pipeline_pair

        pipeline_devices = _pipeline_pair()
        if pipeline_devices is not None:
            device = resolve_device(pipeline_devices[1])
    model = build(cfg, args.weights, 0, device)
    cls_emb = torch.as_tensor(cls_slice).to(device)

    exprs = getattr(args, "text", None)
    vos_mask_path = getattr(args, "mask", None)
    if exprs and vos_mask_path:
        raise ValueError("--text and --mask are exclusive")
    if vos_mask_path:
        from PIL import Image

        vos_mask = np.array(Image.open(vos_mask_path))
        if vos_mask.ndim == 3:  # RGB mask: any nonzero pixel = one object
            vos_mask = (vos_mask.sum(-1) > 0).astype(np.uint8)
        vos_obj_ids = [int(v) for v in np.unique(vos_mask) if v != 0]
        if not vos_obj_ids:
            raise ValueError(f"no objects in {vos_mask_path}")
        driver = VOSDriver(cfg, model, capacity=len(vos_obj_ids), num_classes=k,
                           query_mode=cfg.inference.video_unified_inference_queries,
                           device=device)
    elif exprs:
        n_expr = len(exprs)
        driver = VOSDriver(cfg, model, capacity=n_expr, num_classes=k,
                           query_mode=cfg.inference.video_unified_inference_queries,
                           device=device)
        if getattr(args, "clip_weights", None):
            from univs_tpu_torch.prompts.prepare_targets import PrepareTargets

            enc = text_encoder_from(args.clip_weights, device)
            tp = PrepareTargets(bank, enc).grounding_inputs(exprs, pad_to=n_expr)
        else:
            logging.getLogger(__name__).warning(
                "--text without --clip-weights: seeded RANDOM expression "
                "features — output masks are smoke-quality only")
            rngt = np.random.RandomState(0)
            tp = TextPrompts(
                embs=torch.as_tensor(rngt.randn(1, n_expr, 4, cls_slice.shape[-1]),
                                     dtype=torch.float32).to(device),
                valid=torch.ones((1, n_expr), dtype=torch.bool, device=device),
            )
    batch = max(1, getattr(args, "batch", 1))
    if not (exprs or vos_mask_path) and batch == 1:
        driver = EntityDriver(cfg, model, num_classes=k,
                              capacity=cfg.inference.max_num_instances, device=device,
                              pipeline_devices=pipeline_devices)

    inputs = args.input if isinstance(args.input, (list, tuple)) else [args.input]
    multi = len(inputs) > 1
    pipeline = None
    if getattr(args, "parallel", False):
        pipeline = AsyncRenderPipeline(
            args.score_thres, num_workers=getattr(args, "num_render_workers", 2)
        )

    def emit(inp, frames, results):
        out_path = _out_path_for(args.output, inp, multi)
        if pipeline is not None:
            pipeline.put(frames, results, out_path)
        else:
            n, e = render_and_write(frames, results, out_path, args.score_thres)
            print(f"wrote {out_path} ({n} frames, {e} entities)")

    def prep(inp):
        frames = read_frames(inp, max_frames=getattr(args, "max_frames", 300))
        if not frames:
            raise ValueError(f"no frames read from {inp}")
        h, w = frames[0].shape[:2]
        t = resize_shortest_edge((h, w), cfg.inference.min_size_test, 1333, 32)
        images = np.stack([t.apply_image(f) for f in frames]).astype(np.float32)
        ih, iw = transformed_image_size(t, (h, w))
        return frames, t, images, (ih, iw), (h, w)

    if batch > 1 and not (exprs or vos_mask_path):
        # lockstep-batched VIS serving: N videos per dispatch, grouped
        # by padded resolution (BatchedVISServer requires one shape);
        # short chunks are padded by repeating the last video and the
        # padding's results are dropped
        from univs_tpu_torch.inference.serving import BatchedVISServer

        server = BatchedVISServer(cfg, model, num_classes=k,
                                  capacity=cfg.inference.max_num_instances,
                                  batch_size=batch, device=device)
        groups = {}
        for inp in inputs:
            item = (inp, *prep(inp))
            groups.setdefault(item[3].shape[1:3], []).append(item)
        for items in groups.values():
            for c0 in range(0, len(items), batch):
                chunk = items[c0 : c0 + batch]
                padded = chunk + [chunk[-1]] * (batch - len(chunk))
                res = server.run_vis(
                    [it[3] for it in padded], cls_emb,
                    image_sizes=[it[4] for it in padded],
                    out_sizes=[it[5] for it in padded],
                )
                for (inp, frames, _, _, _, _), results in zip(chunk, res):
                    emit(inp, frames, results)
        if pipeline is not None:
            for out_path, n, e in pipeline.shutdown():
                print(f"wrote {out_path} ({n} frames, {e} entities)")
        return

    for inp in inputs:
        frames, t, images, (ih, iw), (h, w) = prep(inp)

        if vos_mask_path:
            if vos_mask.shape != (h, w):
                raise ValueError(f"first-frame mask {vos_mask.shape} must match the video "
                                 f"resolution {(h, w)}")
            N = len(vos_obj_ids)
            Hp, Wp = images.shape[1:3]
            gt14 = np.zeros((N, len(frames), Hp // 4, Wp // 4), np.float32)
            for n, oid in enumerate(vos_obj_ids):
                tm = t.apply_mask((vos_mask == oid).astype(np.uint8))
                gt14[n, 0] = tm[::4, ::4][: Hp // 4, : Wp // 4]
            labels = driver.run(
                images, gt14, np.zeros(N, np.int32), np.ones(N, bool),
                cls_emb, image_size=(ih, iw), out_size=(h, w),
            )
            results = [
                {"score": np.float32(1.0), "object_id": oid,
                 "segmentations": encode_mask_batch(
                     (labels == n + 1).astype(np.uint8))}
                for n, oid in enumerate(vos_obj_ids)
            ]
        elif exprs:
            # [n_expr, V, h, w] binary masks -> results-list shape so the
            # same render pipeline (incl. --parallel) applies
            masks = driver.run_grounding(
                images, tp.embs, tp.valid, cls_emb,
                n_expressions=n_expr, image_size=(ih, iw), out_size=(h, w),
            )
            results = [
                {"score": np.float32(1.0), "expression": exprs[e],
                 "segmentations": encode_mask_batch(np.asarray(masks[e], np.uint8))}
                for e in range(n_expr)
            ]
        else:
            results = driver.run_vis(
                images, cls_emb, image_size=(ih, iw), out_size=(h, w)
            )
        emit(inp, frames, results)

    if pipeline is not None:
        for out_path, n, e in pipeline.shutdown():
            print(f"wrote {out_path} ({n} frames, {e} entities)")


if __name__ == "__main__":
    main()
