"""Evaluation engine: datasets -> drivers -> evaluators (counterpart of
``univs_tpu/engine.py``).

``evaluate_dataset`` picks the evaluator of a registered dataset, runs
the port's clip-streaming driver per video and feeds the matching metric
(reference: train_net.py:111-165, :294-350).  Every metric, file and
decision is the JAX package's: the evaluators' category ids are 0-based
where the dataset's are 1-based, VPS's ``thing_ids`` are shifted for STQ
but not for ``run_vps``, PVOS buckets by ``raw_category_id``, and the
random text prompts used without a text encoder are JAX's numpy draw.

The model is built once per evaluation (from ``params``: a built
``UniVSModel``, its state_dict, e.g. from
``utils.weights.state_dict_from_flax``, or None for the seeded init) and
shared by every driver, including the per-video ``VOSDriver`` of
VOS / PVOS / RefVOS, whose capacity follows the video's objects.
``device=None`` runs on the card and raises without one; the CPU is
asked for with ``device="cpu"``.
"""

from __future__ import annotations

import json
import logging
import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from univs_tpu_torch.config import UniVSConfig
from univs_tpu_torch.data.datasets import get_spec, load_dataset
from univs_tpu_torch.data.mapper import EvalVideoMapper
from univs_tpu_torch.data.ytvis import segmentation_to_mask
from univs_tpu_torch.inference.driver import EntityDriver, VOSDriver, vis_results_to_ytvis_json
from univs_tpu_torch.models.univs import UniVSModel, build_model
from univs_tpu_torch.structures import TextPrompts
from univs_tpu_torch.utils.device import resolve_device


def evaluate_dataset(
    cfg: UniVSConfig,
    params,
    dataset_name: str,
    cls_bank: np.ndarray,  # [K, Dt] category embedding slice for the dataset
    max_videos: Optional[int] = None,
    output_dir: Optional[str] = None,
    text_encoder=None,
    pipeline: bool = False,
    device=None,
) -> Dict[str, float]:
    """``pipeline``: two-card pipelined streaming for the entity-driver
    tasks (encode on cuda:0, decode + memory pool on cuda:1 —
    ``EntityDriver(pipeline_devices=...)``); ignored with a warning when
    fewer than two cards are visible."""
    device = resolve_device(device)  # refuse before reading the dataset
    spec = get_spec(dataset_name)
    records = load_dataset(dataset_name)
    if max_videos:
        records = records[:max_videos]
    mapper = EvalVideoMapper(
        short=cfg.inference.min_size_test, size_divisibility=cfg.inference.size_divisibility
    )
    pipeline_devices = _pipeline_pair() if pipeline else None

    if spec.evaluator_type == "ytvis":
        return _eval_ytvis(cfg, params, records, mapper, cls_bank, output_dir,
                           pipeline_devices=pipeline_devices, device=device)
    if spec.task == "grounding":
        return _eval_refvos(cfg, params, records, mapper, cls_bank,
                            text_encoder=text_encoder, output_dir=output_dir, device=device)
    if spec.evaluator_type == "davis":
        return _eval_vos(cfg, params, records, mapper, cls_bank, output_dir=output_dir,
                         device=device)
    if spec.evaluator_type == "pvos":
        return _eval_vos(cfg, params, records, mapper, cls_bank, output_dir=output_dir,
                         pvos=True, device=device)
    if spec.evaluator_type == "vss":
        return _eval_vss(cfg, params, records, mapper, cls_bank, device=device)
    if spec.evaluator_type == "vps":
        return _eval_vps(cfg, params, records, mapper, cls_bank,
                         thing_ids=set(spec.thing_ids or ()), output_dir=output_dir,
                         pipeline_devices=pipeline_devices, device=device)
    if spec.evaluator_type == "coco":
        return _eval_image(cfg, params, records, mapper, cls_bank,
                           thing_ids=set(spec.thing_ids or ()), output_dir=output_dir,
                           device=device)
    if spec.evaluator_type is None:
        # no-GT datasets (custom_videos, raw-video corpora): prediction
        # only — the reference runs its drivers and writes outputs with
        # no metric stage (CUSTOM_VIDEOS_ENABLE, univs/config.py:151)
        return _predict_only(cfg, params, records, mapper, cls_bank,
                             text_encoder=text_encoder, output_dir=output_dir, device=device)
    raise NotImplementedError(f"evaluator {spec.evaluator_type} for {dataset_name}")


def _model(cfg: UniVSConfig, params, device):
    """(the model every driver of one evaluation shares, its device)."""
    dev = resolve_device(device)
    if isinstance(params, UniVSModel):
        return params.to(dev), dev
    return build_model(cfg, params, device=dev), dev


def _cls_emb(cls_bank: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(cls_bank), dtype=torch.float32).to(dev)


def _text_prompts(cls_bank, text_encoder, exprs, cap: int, n: int) -> TextPrompts:
    """The expressions through ``text_encoder``, or without one JAX's
    random prompts: ``RandomState(0).randn(1, cap, 4, Dt)``, the first
    ``n`` valid (a pipeline smoke; no CLIP weights)."""
    if text_encoder is not None:
        from univs_tpu_torch.prompts.prepare_targets import PrepareTargets

        return PrepareTargets(cls_bank, text_encoder).grounding_inputs(exprs, pad_to=cap)
    rng = np.random.RandomState(0)
    embs = rng.randn(1, cap, 4, cls_bank.shape[-1]).astype(np.float32)
    return TextPrompts(embs=torch.as_tensor(embs),
                       valid=torch.as_tensor(np.arange(cap) < n)[None])


def _frame_names(rec, V: int) -> List[str]:
    return rec.get("file_names") or [f"{t:05d}.jpg" for t in range(V)]


def _write_json(output_dir: str, name: str, obj) -> None:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, name), "w") as f:
        json.dump(obj, f)


def _predict_only(cfg, params, records, mapper, cls_bank, text_encoder=None,
                  output_dir=None, device=None):
    """Inference without ground truth: VIS results.json for detection
    records; per-expression mask trees for grounding records
    (reference: custom-video flows in inference_video_entity/vos)."""
    model, dev = _model(cfg, params, device)
    cls_emb = _cls_emb(cls_bank, dev)
    preds: List[Dict] = []
    t0, total_frames, n_videos = time.time(), 0, 0
    det_driver = None
    for rec in records:
        s = mapper(rec)
        n_videos += 1
        total_frames += s["video_len"]
        exprs = rec.get("expressions", [])
        if rec.get("task") == "grounding" and exprs:
            n = len(exprs)
            driver = VOSDriver(cfg, model, capacity=n, num_classes=cls_bank.shape[0],
                               query_mode=cfg.inference.video_unified_inference_queries,
                               device=dev)
            tp = _text_prompts(cls_bank, text_encoder, exprs, n, n)
            masks = driver.run_grounding(
                s["images"], tp.embs, tp.valid, cls_emb, n_expressions=n,
                image_size=s["image_size"], out_size=s["out_size"],
            )
            if output_dir:
                from univs_tpu_torch.evaluation.submission import emit_rvos_submission

                emit_rvos_submission(
                    output_dir, rec.get("video_name", str(rec["video_id"])),
                    rec.get("exp_ids", [str(e) for e in range(n)]),
                    _frame_names(rec, masks.shape[1]), masks,
                )
        else:
            if det_driver is None:
                det_driver = EntityDriver(cfg, model, num_classes=cls_bank.shape[0],
                                          capacity=cfg.inference.max_num_instances, device=dev)
            ent = det_driver.run_vis(
                s["images"], cls_emb, image_size=s["image_size"], out_size=s["out_size"]
            )
            preds += vis_results_to_ytvis_json(
                s["video_id"], s["video_len"], *s["out_size"], ent,
                apply_cls_thresh=cfg.inference.apply_cls_thres,
                topk_per_video=cfg.inference.topk_per_video,
            )
    if output_dir and preds:
        _write_json(output_dir, "results.json", preds)
    dt = time.time() - t0
    return {"num_videos": float(n_videos), "num_predictions": float(len(preds)),
            "fps": total_frames / max(dt, 1e-6)}


def _pipeline_pair():
    """(encode_device, decode_device) for two-card streaming, or None
    (with a warning) when a second card is not visible."""
    n = torch.cuda.device_count()
    if n >= 2:
        return ("cuda:0", "cuda:1")
    logging.getLogger(__name__).warning(
        "pipeline requested but only %d device(s) visible — running single-device", n)
    return None


def _eval_ytvis(cfg, params, records, mapper, cls_bank, output_dir,
                pipeline_devices=None, device=None):
    from univs_tpu_torch.evaluation.ytvis import YTVISEval

    if pipeline_devices is not None:
        device = pipeline_devices[1]
    model, dev = _model(cfg, params, device)
    driver = EntityDriver(cfg, model, num_classes=cls_bank.shape[0],
                          capacity=cfg.inference.max_num_instances, device=dev,
                          pipeline_devices=pipeline_devices)
    cls_emb = _cls_emb(cls_bank, dev)
    preds: List[Dict] = []
    gts: List[Dict] = []
    t0 = time.time()
    total_frames = 0
    for rec in records:
        s = mapper(rec)
        ent = driver.run_vis(s["images"], cls_emb, image_size=s["image_size"], out_size=s["out_size"])
        preds += vis_results_to_ytvis_json(
            s["video_id"], s["video_len"], *s["out_size"], ent,
            apply_cls_thresh=cfg.inference.apply_cls_thres,
            topk_per_video=cfg.inference.topk_per_video,
        )
        total_frames += s["video_len"]
        for ann in rec["annotations"]:
            gts.append({
                "video_id": rec["video_id"],
                "category_id": ann["category_id"] - 1,  # evaluator uses 0-based like preds
                "id": ann["id"],
                "segmentations": ann["segmentations"],
                "iscrowd": ann.get("iscrowd", 0),
            })
    dt = time.time() - t0
    if output_dir:
        _write_json(output_dir, "results.json", preds)
    metrics = YTVISEval(gts, preds).evaluate()
    metrics["fps"] = total_frames / max(dt, 1e-6)
    return metrics


def _gt_label_maps(rec, sem: bool):
    """Per-frame GT maps from annotations: semantic class maps (vss) or
    (segment_id, {id: cat}) panoptic maps (vps)."""
    V = rec["length"]
    H, W = rec["height"], rec["width"]
    lab = np.full((V, H, W), 255 if sem else 0, np.int32)
    cats = {}
    crowd = {}
    for ann in rec["annotations"]:
        for fi in range(V):
            segm = (ann["segmentations"] or [None] * V)[fi]
            m = segmentation_to_mask(segm, H, W)
            if m is None:
                continue
            if sem:
                lab[fi][m > 0] = ann["category_id"] - 1
            else:
                lab[fi][m > 0] = ann["id"]
                cats[ann["id"]] = ann["category_id"] - 1
                crowd[ann["id"]] = bool(ann.get("iscrowd", 0))
    if sem:
        return (lab, cats)
    return (lab, cats, crowd)


def _eval_vss(cfg, params, records, mapper, cls_bank, device=None):
    from univs_tpu_torch.evaluation.vss import (confusion_matrix, miou_from_confusion,
                                                video_consistency)

    model, dev = _model(cfg, params, device)
    driver = EntityDriver(cfg, model, num_classes=cls_bank.shape[0],
                          capacity=cfg.inference.max_num_instances, device=dev)
    cls_emb = _cls_emb(cls_bank, dev)
    K = cls_bank.shape[0]
    cm = np.zeros((K, K), np.int64)
    vcs = []
    t0, total_frames = time.time(), 0
    for rec in records:
        s = mapper(rec)
        pred = driver.run_vss(s["images"], cls_emb, image_size=s["image_size"], out_size=s["out_size"])
        gt, _ = _gt_label_maps(rec, sem=True)
        cm += confusion_matrix(gt, pred, K)
        vc = video_consistency(list(gt), list(pred), window=min(8, rec["length"]))
        if np.isfinite(vc):
            vcs.append(vc)
        total_frames += s["video_len"]
    miou, macc, _ = miou_from_confusion(cm)
    return {"mIoU": miou, "mAcc": macc, "mVC": float(np.mean(vcs)) if vcs else float("nan"),
            "fps": total_frames / max(time.time() - t0, 1e-6)}


def _eval_vps(cfg, params, records, mapper, cls_bank, thing_ids, output_dir=None,
              pipeline_devices=None, device=None):
    from univs_tpu_torch.evaluation.stq import STQAccumulator
    from univs_tpu_torch.evaluation.vpq import vpq_single_video

    if pipeline_devices is not None:
        device = pipeline_devices[1]
    model, dev = _model(cfg, params, device)
    driver = EntityDriver(cfg, model, num_classes=cls_bank.shape[0],
                          capacity=cfg.inference.max_num_instances, device=dev,
                          pipeline_devices=pipeline_devices)
    cls_emb = _cls_emb(cls_bank, dev)
    K = cls_bank.shape[0]
    # spec.thing_ids are 1-based VIPSeg category ids; the class maps fed to
    # stq.update below are 0-based (category_id - 1), so shift here.  The
    # driver's run_vps keeps the 1-based set (it compares against argmax+1).
    stq = STQAccumulator(K, things={t - 1 for t in thing_ids} if thing_ids else set(range(K)))
    vpqs = []
    vps_records = []
    t0, total_frames = time.time(), 0
    for rec in records:
        s = mapper(rec)
        pan, seg_info = driver.run_vps(
            s["images"], cls_emb, thing_class_ids=(thing_ids or set(range(1, K + 1))),
            image_size=s["image_size"], out_size=s["out_size"],
        )
        if output_dir:
            # VIPSeg evaluator input layout (vps_evaluation.py:118-199)
            from univs_tpu_torch.evaluation.submission import emit_vps_submission

            vps_records.append(emit_vps_submission(
                output_dir, rec.get("video_name", str(rec["video_id"])),
                _frame_names(rec, pan.shape[0]), pan, seg_info,
            ))
        gt_lab, gt_cats, gt_crowd = _gt_label_maps(rec, sem=False)
        pr_cats = {si["id"]: si["category_id"] - 1 for si in seg_info}
        spans = tuple(k for k in (1, 2, 4, 6) if k <= rec["length"])
        vpqs.append(vpq_single_video(list(gt_lab), gt_cats, list(pan), pr_cats,
                                     K, spans, gt_crowd=gt_crowd)["vpq"])
        for t in range(rec["length"]):
            gt_cls = np.vectorize(lambda i: gt_cats.get(i, 255))(gt_lab[t]).astype(np.int64)
            pr_cls = np.vectorize(lambda i: pr_cats.get(i, 0))(pan[t]).astype(np.int64)
            stq.update(rec["video_id"], gt_cls, gt_lab[t], pr_cls, pan[t])
        total_frames += s["video_len"]
    if output_dir and vps_records:
        from univs_tpu_torch.evaluation.submission import write_vps_pred_json

        write_vps_pred_json(output_dir, vps_records)
    out = {"VPQ": float(np.mean(vpqs))}
    out.update(stq.result())
    out["fps"] = total_frames / max(time.time() - t0, 1e-6)
    return out


def _eval_image(cfg, params, records, mapper, cls_bank, thing_ids, output_dir=None,
                device=None):
    """COCO/ADE20K image instance / semantic / panoptic evaluation over
    1-frame pseudo-video records (reference:
    inference_image_generic_seg.py:176-449 + the evaluator dispatch in
    train_net.py:111-165 — COCOEvaluator mask AP, COCOPanopticEvaluator
    PQ, SemSegEvaluator mIoU).

    ``thing_ids``: 1-based thing category ids; empty -> pure instance
    dataset (every class a thing, AP only)."""
    from univs_tpu_torch.evaluation.panoptic import PQStat
    from univs_tpu_torch.evaluation.vss import confusion_matrix, miou_from_confusion
    from univs_tpu_torch.evaluation.ytvis import YTVISEval
    from univs_tpu_torch.inference.image import (
        ImageDriver, instance_inference, panoptic_inference, semantic_inference,
    )
    from univs_tpu_torch.utils import rle

    K = cls_bank.shape[0]
    panoptic_mode = bool(thing_ids) and len(thing_ids) < K  # stuff exists
    thing_contig = {t - 1 for t in thing_ids} if thing_ids else set(range(K))
    inf = cfg.inference

    model, dev = _model(cfg, params, device)
    driver = ImageDriver(cfg, model, num_classes=K, device=dev)
    cls_emb = _cls_emb(cls_bank, dev)
    Ql = cfg.decoder.num_queries
    pq = PQStat()
    cm = np.zeros((K, K), np.int64)
    preds: List[Dict] = []
    gts: List[Dict] = []
    t0, total = time.time(), 0
    for rec in records:
        s = mapper(rec)
        mask_cls, mask_pred = driver.run(
            s["images"][:1], cls_emb, s["image_size"], s["out_size"]
        )
        img_id = rec["video_id"]
        inst = instance_inference(
            mask_cls, mask_pred, Ql,
            thing_contiguous_ids=sorted(thing_contig) if panoptic_mode else None,
            topk=inf.detections_per_image,
        )
        for r in inst:
            preds.append({
                "video_id": img_id, "score": r["score"],
                "category_id": r["category_id"],
                "segmentations": [rle.encode(r["mask"])],
                "height": s["out_size"][0], "width": s["out_size"][1],
            })
        for ann in rec.get("annotations", []):
            if panoptic_mode and (ann["category_id"] - 1) not in thing_contig:
                continue  # instance AP is over thing classes only
            gts.append({
                "video_id": img_id,
                "category_id": ann["category_id"] - 1,
                "id": ann["id"],
                "segmentations": ann["segmentations"],
                "iscrowd": ann.get("iscrowd", 0),
            })
        if panoptic_mode:
            pan, infos = panoptic_inference(
                mask_cls, mask_pred, Ql, thing_contig,
                object_mask_threshold=inf.object_mask_threshold,
                overlap_threshold=inf.overlap_threshold,
            )
            gt_lab, gt_cats, _ = _gt_label_maps(rec, sem=False)
            gt_segments = [
                {"id": ann["id"], "category_id": gt_cats[ann["id"]],
                 "iscrowd": ann.get("iscrowd", 0)}
                for ann in rec["annotations"] if ann["id"] in gt_cats
            ]
            pq.update(gt_lab[0], gt_segments, pan, infos)
            sem = semantic_inference(mask_cls, mask_pred, Ql).argmax(0)
            gt_sem = _gt_label_maps(rec, sem=True)[0][0]
            cm += confusion_matrix(gt_sem[None], sem[None], K)
        total += 1
    if output_dir:
        _write_json(output_dir, "image_results.json", preds)
    out = YTVISEval(gts, preds).evaluate()  # T=1 video AP == COCO mask AP
    out = {"AP": out.get("AP", float("nan")), "AP50": out.get("AP50", float("nan"))}
    if panoptic_mode:
        out.update(pq.result(thing_ids={t - 1 for t in thing_ids}))
        miou, macc, _ = miou_from_confusion(cm)
        out.update({"mIoU": miou, "mAcc": macc})
    out["fps"] = total / max(time.time() - t0, 1e-6)
    return out


def _eval_refvos(cfg, params, records, mapper, cls_bank, text_encoder=None,
                 output_dir=None, device=None):
    """RefVOS J&F: one prompt per expression, GT = the referred object
    (reference: save_rvos_results per-expression dirs + DAVIS J&F)."""
    from univs_tpu_torch.evaluation.davis import evaluate_davis_sequence

    model, dev = _model(cfg, params, device)
    cls_emb = _cls_emb(cls_bank, dev)
    res_j, res_f = [], []
    t0, total_frames = time.time(), 0
    for rec in records:
        exprs = rec.get("expressions", [])
        if not exprs:
            continue
        s = mapper(rec)
        n = len(exprs)
        cap = max(n, 1)
        driver = VOSDriver(cfg, model, capacity=cap, num_classes=cls_bank.shape[0],
                           query_mode=cfg.inference.video_unified_inference_queries, device=dev)
        tp = _text_prompts(cls_bank, text_encoder, exprs, cap, n)
        masks = driver.run_grounding(
            s["images"], tp.embs, tp.valid, cls_emb, n_expressions=n,
            image_size=s["image_size"], out_size=s["out_size"],
        )
        if output_dir:
            # Ref-YTVOS codalab layout (inference_video_vos.py:672-714)
            from univs_tpu_torch.evaluation.submission import emit_rvos_submission

            emit_rvos_submission(
                output_dir, rec.get("video_name", str(rec["video_id"])),
                rec.get("exp_ids", [str(e) for e in range(n)]),
                _frame_names(rec, masks.shape[1]), masks,
            )
        # GT: expression e refers to object exp_obj_ids[e]
        anns = {a["id"]: a for a in rec["annotations"]}
        obj_ids = rec.get("exp_obj_ids", list(anns))
        for e in range(n):
            ann = anns.get(obj_ids[e]) if obj_ids[e] in anns else list(anns.values())[min(e, len(anns) - 1)]
            gt = np.zeros((rec["length"], *s["out_size"]), np.uint8)
            for fi, segm in enumerate(ann["segmentations"] or []):
                m = segmentation_to_mask(segm, rec["height"], rec["width"])
                if m is not None:
                    gt[fi] = m
            r = evaluate_davis_sequence(gt[None], masks[e][None])
            res_j.append(r["J"])
            res_f.append(r["F"])
        total_frames += s["video_len"]
    dt = time.time() - t0
    j, f = float(np.mean(res_j)), float(np.mean(res_f))
    return {"J": j, "F": f, "J&F": (j + f) / 2, "fps": total_frames / max(dt, 1e-6)}


def _eval_vos(cfg, params, records, mapper, cls_bank, output_dir=None,
              pvos=False, device=None):
    """DAVIS/YTVOS J&F, or — with ``pvos=True`` — the VIPOSeg G protocol
    (reference eval_pvos.py): per-(object, frame) mIoU+bIoU samples
    pooled into thing/stuff x seen/unseen buckets across ALL videos,
    objects scored only after their reference (first-appearance) frame,
    G = mean of the four bucket scores."""
    from univs_tpu_torch.evaluation import pvos as pvos_eval
    from univs_tpu_torch.evaluation.davis import evaluate_davis_sequence

    model, dev = _model(cfg, params, device)
    cls_emb = _cls_emb(cls_bank, dev)
    res_j, res_f = [], []
    pvos_buckets: Dict[str, list] = {}
    t0 = time.time()
    total_frames = 0
    for rec in records:
        s = mapper(rec)
        V = s["video_len"]
        H, W = s["images"].shape[1:3]
        anns = rec["annotations"]
        N = len(anns)
        if N == 0:
            continue
        t = s["transform"]
        gt14 = np.zeros((N, V, H // 4, W // 4), np.float32)
        gt_full = np.zeros((N, V, *s["out_size"]), np.uint8)
        faf = np.full((N,), -1, np.int32)
        for n, ann in enumerate(anns):
            for fi, segm in enumerate(ann["segmentations"] or []):
                m = segmentation_to_mask(segm, rec["height"], rec["width"])
                if m is None or m.sum() == 0:
                    continue
                gt_full[n, fi] = m
                tm = t.apply_mask(m)
                gt14[n, fi] = tm[::4, ::4][: H // 4, : W // 4]
                if faf[n] < 0:
                    faf[n] = fi
        obj_valid = faf >= 0
        driver = VOSDriver(cfg, model, capacity=N, num_classes=cls_bank.shape[0], device=dev)
        labels = driver.run(
            s["images"], gt14, faf, obj_valid, cls_emb,
            image_size=s["image_size"], out_size=s["out_size"],
        )
        if output_dir:
            # YTVOS18/DAVIS codalab layout (inference_video_vos.py:622-670)
            from univs_tpu_torch.evaluation.submission import emit_vos_submission

            emit_vos_submission(
                output_dir, rec.get("video_name", str(rec["video_id"])),
                _frame_names(rec, V), labels, obj_ids=[a["id"] for a in anns],
            )
        pred_masks = np.stack([(labels == n + 1) for n in range(N)]).astype(np.uint8)
        if pvos:
            # VIPOSeg protocol: object ids 1..N introduced at their
            # first-appearance frames; category_id is 1-based in our
            # dataset records, VIPOSeg class ids are 0-based
            gt_ids = np.zeros(gt_full.shape[1:], np.int32)
            pr_ids = np.zeros(pred_masks.shape[1:], np.int32)
            for n in range(N):
                gt_ids[gt_full[n] > 0] = n + 1
                pr_ids[pred_masks[n] > 0] = n + 1
            ann_frames: Dict[int, np.ndarray] = {}
            for n in range(N):
                if faf[n] < 0:
                    continue
                rf = int(faf[n])
                m = (gt_full[n, rf] > 0).astype(np.int32) * (n + 1)
                ann_frames[rf] = np.where(
                    m > 0, m, ann_frames.get(rf, np.zeros_like(m)))
            # bucket by the dataset's ORIGINAL class ids (1-based json ->
            # 0-based VIPOSeg tables); the loader's contiguous remap is
            # for the classifier head only
            obj_classes = {
                n + 1: int(anns[n].get("raw_category_id",
                                       anns[n].get("category_id", 1))) - 1
                for n in range(N)}
            # fail loudly on ids outside the VIPOSeg tables: a dataset
            # registered with 0-based json category ids would shift
            # every class here and silently drop objects from all
            # buckets (bucket_of -> None)
            known = set(pvos_eval.THING_CLASSES) | set(pvos_eval.STUFF_CLASSES)
            bad = {o: c for o, c in obj_classes.items() if c not in known}
            if bad:
                warnings.warn(
                    "PVOS: object class ids %r not in the VIPOSeg thing/"
                    "stuff tables (expected 1-based json category_id); "
                    "these objects are EXCLUDED from every G bucket — "
                    "check the dataset registration" % (bad,),
                    stacklevel=2,
                )
            unseen_machine = (
                rec.get("video_name", "") in pvos_eval.OTHER_MACHINE_UNSEEN_VIDEOS)
            samples, _ = pvos_eval.pvos_video_samples(
                gt_ids, pr_ids, obj_classes, ann_frames,
                video_unseen_machine=unseen_machine)
            for k, v in samples.items():
                pvos_buckets.setdefault(k, []).extend(v)
        else:
            r = evaluate_davis_sequence(gt_full, pred_masks)
            res_j.append(r["J"])
            res_f.append(r["F"])
        total_frames += V
    dt = time.time() - t0
    if pvos:
        out = pvos_eval.pvos_aggregate(pvos_buckets)
        out["fps"] = total_frames / max(dt, 1e-6)
        return out
    j, f = float(np.mean(res_j)), float(np.mean(res_f))
    return {"J": j, "F": f, "J&F": (j + f) / 2, "fps": total_frames / max(dt, 1e-6)}
