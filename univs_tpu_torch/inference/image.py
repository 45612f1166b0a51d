"""Image generic segmentation (COCO / ADE20K instance, semantic,
panoptic), the port's counterpart of ``univs_tpu/inference/image.py``:
the numpy laws are copied (the port may not import the JAX package),
``ImageDriver`` runs the model on the card.

Pipeline per image (1-frame pseudo-video), as the reference's
``InferenceImageGenericSegmentation``
(inference_image_generic_seg.py:176-450):

1. model forward in detection mode with the dataset's category prompt
   queries (``prompt_as_queries``): ``pred_logits`` [Q, K] for the 200
   learnable and K prompt queries, ``pred_masks`` at 1/4;
2. bilinear upsample of the mask logits to the padded size; per-query
   mask quality ``count(>1)/count(>-1)`` multiplied into the sigmoid
   class scores;
3. ``sem_seg_postprocess``: crop the padding, bilinear resize to the
   output size;
4. task heads (host numpy): :func:`instance_inference`,
   :func:`semantic_inference`, :func:`panoptic_inference`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from univs_tpu_torch.inference.driver import _StreamingDriver, _upsample_logits_device
from univs_tpu_torch.structures import TextPrompts


# ---------------------------------------------------------------------------
# small numpy helpers (torchvision.ops semantics)
# ---------------------------------------------------------------------------


def masks_to_boxes_np(masks: np.ndarray) -> np.ndarray:
    """[Q, H, W] binary -> xyxy boxes; [0,0,0,0] for empty masks
    (reference: univs/utils/comm.py convert_mask_to_box:41-79)."""
    Q, h, w = masks.shape
    boxes = np.zeros((Q, 4), np.float32)
    for q in range(Q):
        ys, xs = np.nonzero(masks[q])
        if len(ys) == 0:
            continue
        boxes[q] = [xs.min(), ys.min(), xs.max(), ys.max()]
    empty = ~masks.any((-2, -1))
    boxes[empty] = 0
    return boxes


def _nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy NMS, torchvision.ops.nms semantics. Returns kept indices
    sorted by descending score."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(scores), bool)
    area = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        lt = np.maximum(boxes[i, :2], boxes[order, :2])
        rb = np.minimum(boxes[i, 2:], boxes[order, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        iou = inter / np.maximum(area[i] + area[order] - inter, 1e-9)
        suppressed[order[iou > iou_threshold]] = True
        suppressed[i] = False  # keep self
    return np.asarray(keep, np.int64)


def batched_nms_np(boxes, scores, labels, iou_threshold) -> np.ndarray:
    """torchvision.ops.batched_nms: per-class NMS via coordinate offset."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    max_coord = boxes.max() + 1
    offsets = labels.astype(np.float32) * max_coord
    shifted = boxes + offsets[:, None]
    return _nms(shifted, scores, iou_threshold)


def mask_quality_scores_np(mask_logits: np.ndarray) -> np.ndarray:
    """count(>1)/count(>-1) stability score
    (reference: univs/utils/comm.py calculate_mask_quality_scores)."""
    pos = (mask_logits > 1).reshape(mask_logits.shape[0], -1).sum(-1)
    tot = (mask_logits > -1).reshape(mask_logits.shape[0], -1).sum(-1)
    return pos / np.maximum(tot, 1)


def postprocess_nms(scores, mask_pred, box_pred=None, biou_threshold=0.85):
    """Class-batched box NMS over query rows
    (reference: inference_image_generic_seg.py:436-450)."""
    if box_pred is None:
        box_pred = masks_to_boxes_np(mask_pred > 0.0)
    s_nms = scores.max(-1)
    labels = scores.argmax(-1)
    keep = batched_nms_np(box_pred.astype(np.float32), s_nms, labels, biou_threshold)
    return scores[keep], mask_pred[keep], box_pred[keep]


# ---------------------------------------------------------------------------
# the three task heads
# ---------------------------------------------------------------------------


def instance_inference(
    mask_cls: np.ndarray,  # [Q, K] sigmoid scores x quality
    mask_pred: np.ndarray,  # [Q, H, W] logits at output size
    num_queries: int,
    thing_contiguous_ids: Optional[Sequence[int]] = None,
    topk: int = 100,
    prompt_as_queries: bool = True,
) -> List[Dict]:
    """Instance results (reference :378-434).  Returns dicts with
    0-based ``category_id`` indexing the (possibly thing-sliced) class
    axis remapped back to the dataset's contiguous ids, ``score``, and
    a binary ``mask``."""
    box_pred = masks_to_boxes_np(mask_pred > 0)
    if prompt_as_queries:
        mask_cls = mask_cls[:num_queries]
        mask_pred = mask_pred[:num_queries]
        box_pred = box_pred[:num_queries]

    K = mask_cls.shape[-1]
    thing_ids = list(thing_contiguous_ids) if thing_contiguous_ids is not None else list(range(K))
    class_map = np.asarray(thing_ids, np.int64)
    if len(thing_ids) != K:
        labels = mask_cls.argmax(-1)
        keep = np.isin(labels, thing_ids)
        mask_cls = mask_cls[:, thing_ids]
        if keep.sum() == 0:
            s = mask_cls.max(-1)
            keep = s >= min(0.1, s.max() if len(s) else 0.1)
        mask_cls = mask_cls[keep]
        mask_pred = mask_pred[keep]
        box_pred = box_pred[keep]

    mask_cls, mask_pred, box_pred = postprocess_nms(mask_cls, mask_pred, box_pred)

    Kc = mask_cls.shape[-1]
    flat = mask_cls.reshape(-1)
    k = min(topk, flat.size)
    if k == 0:
        return []
    top = np.argsort(-flat, kind="stable")[:k]
    out = []
    for t in top:
        q, c = divmod(int(t), Kc)
        out.append({
            "category_id": int(class_map[c]),
            "score": float(flat[t]),
            "mask": (mask_pred[q] > 0).astype(np.uint8),
        })
    return out


def semantic_inference(
    mask_cls: np.ndarray,  # [Q, K]
    mask_pred: np.ndarray,  # [Q, H, W] logits
    num_queries: int,
    disable_semantic_queries: bool = False,
    prompt_as_queries: bool = True,
    topk: int = 200,
) -> np.ndarray:
    """Semantic evidence map [K, H, W] (reference :287-304); argmax is
    the evaluator's job."""
    if prompt_as_queries and disable_semantic_queries:
        mask_cls = mask_cls[num_queries:]
        mask_pred = mask_pred[num_queries:]
    k = min(topk, mask_cls.shape[0])
    keep = np.argsort(-mask_cls.max(-1), kind="stable")[:k]
    mask_cls = mask_cls[keep]
    mask_pred = mask_pred[keep]
    prob = 1.0 / (1.0 + np.exp(-mask_pred))
    w = np.exp(mask_cls / 0.06)
    w = w / w.sum(-1, keepdims=True)  # (mask_cls/0.06).softmax(-1)
    return np.einsum("qc,qhw->chw", w, prob)


def panoptic_inference(
    mask_cls: np.ndarray,  # [Q, K]
    mask_pred: np.ndarray,  # [Q, H, W] logits
    num_queries: int,
    thing_contiguous_ids: Set[int],
    object_mask_threshold: float = 0.05,
    overlap_threshold: float = 0.8,
    prompt_as_queries: bool = True,
) -> Tuple[np.ndarray, List[Dict]]:
    """Panoptic map + segments (reference :306-376).  ``category_id`` in
    segments_info is the 0-based contiguous class id."""
    Q = mask_cls.shape[0]
    if prompt_as_queries:
        rows = [i for i in range(Q)
                if i < num_queries or (i - num_queries) not in thing_contiguous_ids]
        mask_cls = mask_cls[rows]
        mask_pred = mask_pred[rows]

    mask_cls, mask_pred, _ = postprocess_nms(mask_cls, mask_pred, biou_threshold=0.9)

    raw_scores = mask_cls.max(-1)
    prob = 1.0 / (1.0 + np.exp(-mask_pred))
    keep = raw_scores > object_mask_threshold
    w = np.exp(mask_cls / 0.06)
    w = w / w.sum(-1, keepdims=True)
    scores_t = w.max(-1)
    labels_t = w.argmax(-1)
    cur_scores = scores_t[keep]
    cur_classes = labels_t[keep]
    cur_masks = prob[keep]

    h, w_ = mask_pred.shape[-2:]
    panoptic = np.zeros((h, w_), np.int32)
    segments_info: List[Dict] = []
    if cur_masks.shape[0] == 0:
        return panoptic, segments_info

    cur_prob_masks = cur_scores[:, None, None] * cur_masks
    cur_mask_ids = cur_prob_masks.argmax(0)
    stuff_memory: Dict[int, int] = {}
    current_segment_id = 0
    for k in range(cur_masks.shape[0]):  # QUERY order, not score order
        pred_class = int(cur_classes[k])
        isthing = pred_class in thing_contiguous_ids
        sel = cur_mask_ids == k
        mask_area = int(sel.sum())
        original_area = int((cur_masks[k] >= 0.5).sum())
        mask = sel & (cur_masks[k] >= 0.5)
        if mask_area > 0 and original_area > 0 and mask.sum() > 0:
            if mask_area / original_area < overlap_threshold:
                continue
            if not isthing:
                if pred_class in stuff_memory:
                    panoptic[mask] = stuff_memory[pred_class]
                    continue
                stuff_memory[pred_class] = current_segment_id + 1
            current_segment_id += 1
            panoptic[mask] = current_segment_id
            segments_info.append({
                "id": current_segment_id,
                "isthing": bool(isthing),
                "category_id": pred_class,
            })
    return panoptic, segments_info


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


class ImageDriver(_StreamingDriver):
    """One-image-at-a-time generic segmentation driver.

    Args: cfg; params (a built ``UniVSModel``, its state_dict, or None for
    the seeded init of ``seed``); num_classes K of the bank; device (None
    -> the card, raises without one; "cpu" explicitly)."""

    def __init__(self, cfg, params=None, num_classes: int = 1, device=None, seed: int = 0):
        super().__init__(cfg, params, device, seed)
        self.num_queries = cfg.decoder.num_queries
        self.num_classes = num_classes

    @torch.no_grad()
    def _image_fn(self, frame: torch.Tensor, cls_emb: torch.Tensor):
        """frame [1, H, W, 3] -> (sigmoid scores [Q, K], mask logits [Q,
        H/4, W/4]), float32 on the device; the bank rows are the prompt
        queries."""
        mask_features, ms = self.encode_window(frame)
        tp = TextPrompts(embs=cls_emb[None, :, None, :],
                         valid=torch.ones((1, cls_emb.shape[0]), dtype=torch.bool,
                                          device=self.device))
        out = self.model.decoder(ms, mask_features,
                                 torch.zeros((1, 1), dtype=torch.int64, device=self.device),
                                 task="detection", text_prompts=tp, cls_emb=cls_emb)
        return (torch.sigmoid(out["pred_logits"][0].to(torch.float32)),
                out["pred_masks"][0, :, 0].to(torch.float32))

    @torch.no_grad()
    def run(self, frame: np.ndarray, cls_emb, image_size, out_size):
        """frame [1, H, W, 3] padded RGB.  Returns (mask_cls [Q, K] =
        sigmoid x quality, mask_pred [Q, out_h, out_w] logits), the
        reference's upsample -> quality -> crop -> resize order
        (:224-256); the upsamples and counts on the device, the quality
        division on the host as in the JAX package."""
        H, W = frame.shape[1:3]
        frame_d = torch.as_tensor(frame).to(device=self.device, dtype=torch.float32)
        bank = torch.as_tensor(cls_emb).to(device=self.device, dtype=torch.float32)
        logits, masks = self._image_fn(frame_d, bank)
        up_pad = F.interpolate(masks[None], size=(H, W), mode="bilinear", align_corners=False)[0]
        n = up_pad.shape[0]
        pos = (up_pad > 1).reshape(n, -1).sum(-1).cpu().numpy()
        tot = (up_pad > -1).reshape(n, -1).sum(-1).cpu().numpy()
        del up_pad
        quality = pos / np.maximum(tot, 1)
        mask_cls = logits.cpu().numpy() * quality[:, None]
        mask_pred = _upsample_logits_device(masks, image_size, out_size, (H, W)).cpu().numpy()
        return mask_cls, mask_pred
