"""Every evaluator of the port against the JAX package's on seeded inputs,
exactly equal: DAVIS J / F, VSS confusion / mIoU / VC, VPQ, STQ, HOTA,
``PQStat``, PVOS samples / aggregate / decay fit, ``YTVISEval``; and the
submission emitters' trees and zip members byte for byte."""

import math
import os
import zipfile

import numpy as np
import pytest
import torch

import univs_tpu.evaluation as jax_eval_pkg
import univs_tpu_torch.evaluation as torch_eval_pkg
from univs_tpu.evaluation import davis as j_davis, hota as j_hota, panoptic as j_panoptic
from univs_tpu.evaluation import pvos as j_pvos, stq as j_stq, submission as j_submission
from univs_tpu.evaluation import vpq as j_vpq, vss as j_vss, ytvis as j_ytvis
from univs_tpu.utils import rle as jax_rle
from univs_tpu_torch.evaluation import davis as t_davis, hota as t_hota, panoptic as t_panoptic
from univs_tpu_torch.evaluation import pvos as t_pvos, stq as t_stq, submission as t_submission
from univs_tpu_torch.evaluation import vpq as t_vpq, vss as t_vss, ytvis as t_ytvis
from univs_tpu_torch.utils import rle

torch.set_num_threads(1)

JAX = dict(davis=j_davis, hota=j_hota, panoptic=j_panoptic, pvos=j_pvos, stq=j_stq, vpq=j_vpq,
           vss=j_vss, ytvis=j_ytvis)
PORT = dict(davis=t_davis, hota=t_hota, panoptic=t_panoptic, pvos=t_pvos, stq=t_stq, vpq=t_vpq,
            vss=t_vss, ytvis=t_ytvis)

N, T, H, W = 4, 6, 40, 56


def _objects(seed, n=N, t=T, h=H, w=W):
    """[n, t, h, w] binary ellipses drifting over the frames; some objects
    absent from some frames."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    out = np.zeros((n, t, h, w), np.uint8)
    for i in range(n):
        cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
        ry, rx = rng.uniform(0.1, 0.3) * h, rng.uniform(0.1, 0.3) * w
        vy, vx = rng.uniform(-1.5, 1.5, 2)
        start = rng.randint(0, 2)
        for f in range(start, t):
            out[i, f] = ((yy - cy - vy * f) / ry) ** 2 + ((xx - cx - vx * f) / rx) ** 2 <= 1
    return out


def _predicted(gt, seed):
    """A degraded prediction of ``gt``: shifted, one object dropped for a
    frame, speckled."""
    rng = np.random.RandomState(seed)
    pr = np.roll(gt, shift=(rng.randint(-3, 4), rng.randint(-3, 4)), axis=(2, 3)).copy()
    pr[rng.randint(len(gt)), rng.randint(gt.shape[1])] = 0
    pr |= (rng.rand(*gt.shape) > 0.995).astype(np.uint8)
    return pr


def _id_maps(masks):
    ids = np.zeros(masks.shape[1:], np.int32)
    for i in range(len(masks)):
        ids[masks[i] > 0] = i + 1
    return ids


def _davis(m, seed):
    gt = _objects(seed)
    pr = _predicted(gt, seed + 1)
    void = (np.random.RandomState(seed).rand(T, H, W) > 0.9).astype(np.uint8)
    d = m["davis"]
    return (d.evaluate_davis_sequence(gt, pr), d.db_eval_iou(gt[0], pr[0], void),
            d.db_eval_boundary(gt[1], pr[1]), d.db_eval_boundary(gt[2], pr[2], bound_th=2))


def _vss(m, seed):
    rng = np.random.RandomState(seed)
    gt = np.where(rng.rand(T, H, W) > 0.1, _id_maps(_objects(seed)), 255)
    pr = _id_maps(_predicted(_objects(seed), seed + 1))
    cm = m["vss"].confusion_matrix(gt, pr, N + 1)
    return (cm, m["vss"].miou_from_confusion(cm), m["vss"].video_consistency(list(gt), list(pr), 4),
            m["vss"].video_consistency(list(gt), list(pr), 8))


def _vpq(m, seed):
    gt_seg = _id_maps(_objects(seed)) * 3
    pr_seg = _id_maps(_predicted(_objects(seed), seed + 1)) * 5
    gt_cats = {3 * (i + 1): i % 3 for i in range(N)}
    pr_cats = {5 * (i + 1): (i if i != 1 else 2) % 3 for i in range(N)}
    crowd = {3 * N: True}
    return m["vpq"].vpq_single_video(list(gt_seg), gt_cats, list(pr_seg), pr_cats, 4,
                                     spans=(1, 2, 4), gt_crowd=crowd)


def _stq(m, seed):
    acc = m["stq"].STQAccumulator(num_classes=4, things={1, 2})
    for vid, s in (("a", seed), ("b", seed + 7)):
        gt_inst = _id_maps(_objects(s))
        pr_inst = _id_maps(_predicted(_objects(s), s + 1))
        gt_cls = np.where(gt_inst > 0, gt_inst % 3 + 1, 0)
        gt_cls[:, :2] = 255
        pr_cls = np.where(pr_inst > 0, (pr_inst + 1) % 3 + 1, 0)
        for f in range(T):
            acc.update(vid, gt_cls[f], gt_inst[f], pr_cls[f], pr_inst[f])
    return acc.result()


def _hota(m, seed):
    gt = _objects(seed)
    pr = _predicted(gt, seed + 1)
    gt_frames = [{i + 1: gt[i, f] for i in range(N) if gt[i, f].any()} for f in range(T)]
    pr_frames = [{10 + (i + f // 3) % N: pr[i, f] for i in range(N) if pr[i, f].any()}
                 for f in range(T)]
    return m["hota"].hota_single_video(gt_frames, pr_frames)


def _panoptic(m, seed):
    pq = m["panoptic"].PQStat()
    for f in range(T):
        gt = _id_maps(_objects(seed)[:, f:f + 1])[0]
        pr = _id_maps(_predicted(_objects(seed), seed + 1)[:, f:f + 1])[0]
        gt_seg = [{"id": i + 1, "category_id": i % 2, "iscrowd": int(i == 3)} for i in range(N)]
        pr_seg = [{"id": i + 1, "category_id": (i + f) % 2} for i in range(N)]
        pq.update(gt, gt_seg, pr, pr_seg)
    return pq.result(), pq.result(thing_ids={0})


def _pvos(m, seed):
    gt = _objects(seed)
    pr = _predicted(gt, seed + 1)
    faf = [int(np.flatnonzero(gt[i].reshape(T, -1).any(1))[0]) for i in range(N)]
    ann = {}
    for i, rf in enumerate(faf):
        mm = gt[i, rf].astype(np.int32) * (i + 1)
        ann[rf] = np.where(mm > 0, mm, ann.get(rf, np.zeros_like(mm)))
    # thing seen, stuff seen, thing unseen, the "other machine" class
    classes = {1: 60, 2: 28, 3: 123, 4: 97}
    out = []
    for unseen in (False, True):
        samples, decay = m["pvos"].pvos_video_samples(_id_maps(gt), _id_maps(pr), classes, ann,
                                                      video_unseen_machine=unseen)
        out += [dict(samples), dict(decay), m["pvos"].pvos_aggregate(samples),
                m["pvos"].pvos_decay_fit(decay)]
    out.append(m["pvos"].evaluate_pvos_video(gt, pr, [60, 28, 123, 97], ref_frames=faf))
    out.append(m["pvos"].pvos_decay_fit({}))
    return out


def _ytvis(m, seed):
    gts, preds = [], []
    for vid in (1, 2):
        gt = _objects(seed + vid)
        pr = _predicted(gt, seed + vid + 10)
        rng = np.random.RandomState(seed + vid)
        for i in range(N):
            segs = [jax_rle.encode(gt[i, f]) if gt[i, f].any() else None for f in range(T)]
            gts.append({"video_id": vid, "category_id": i % 2, "id": 10 * vid + i,
                        "segmentations": segs, "iscrowd": int(i == 3 and vid == 2)})
            for c in (i % 2, (i + 1) % 2):
                preds.append({"video_id": vid, "category_id": c, "score": float(rng.rand()),
                              "segmentations": [jax_rle.encode(pr[i, f]) for f in range(T)]})
    ev = m["ytvis"].YTVISEval(gts, preds)
    return ev.evaluate(), m["ytvis"].YTVISEval(gts, preds, max_dets=3).evaluate(), \
        m["ytvis"].video_mask_iou(gts[0]["segmentations"], preds[0]["segmentations"]), \
        m["ytvis"].video_mask_iou(gts[0]["segmentations"], preds[0]["segmentations"], True)


EVALUATORS = dict(davis=_davis, vss=_vss, vpq=_vpq, stq=_stq, hota=_hota, panoptic=_panoptic,
                  pvos=_pvos, ytvis=_ytvis)


def _assert_same(got, want, where="result"):
    if isinstance(want, dict):
        assert type(got) is dict and sorted(got) == sorted(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), where
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(EVALUATORS))
def test_evaluator_equals_jax(name, seed):
    want = EVALUATORS[name](JAX, seed)
    got = EVALUATORS[name](PORT, seed)
    _assert_same(got, want)


def test_ytvis_evaluator_on_numpy_rle_equals_native(monkeypatch):
    want = _ytvis(PORT, 3)
    assert rle.backend() == "native"
    monkeypatch.setattr(rle, "_native", lambda: None)
    assert rle.backend() == "numpy"
    _assert_same(_ytvis(PORT, 3), want)


def test_package_exports():
    names = ["db_eval_iou", "db_eval_boundary", "evaluate_davis_sequence", "confusion_matrix",
             "miou_from_confusion", "video_consistency", "vpq_single_video", "STQAccumulator",
             "YTVISEval"]
    for n in names:
        assert getattr(torch_eval_pkg, n).__module__.startswith("univs_tpu_torch.evaluation.")
        assert getattr(jax_eval_pkg, n).__name__ == getattr(torch_eval_pkg, n).__name__
    assert t_pvos.THING_CLASSES == j_pvos.THING_CLASSES
    assert t_pvos.STUFF_CLASSES == j_pvos.STUFF_CLASSES
    assert t_pvos.OTHER_MACHINE_UNSEEN_VIDEOS == j_pvos.OTHER_MACHINE_UNSEEN_VIDEOS


def _tree(root):
    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(dp, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _emit(sub, out_dir):
    gt = _objects(5)
    labels = _id_maps(gt).astype(np.uint8)
    names = [f"frame_{t:03d}.jpg" for t in range(T)]
    sub.emit_vos_submission(out_dir, "vid_a", names, labels, obj_ids=[3, 7, 11, 2])
    sub.emit_vos_submission(out_dir, "vid_b", names, labels)
    sub.emit_rvos_submission(out_dir, "vid_c", ["0", "1", "2"], names, gt[:3])
    pan = _id_maps(_objects(6)) * 4
    info = [{"id": 4 * (i + 1), "isthing": i < 2, "category_id": 3 + i} for i in range(N)]
    per_video = [sub.emit_vps_submission(out_dir, "vps_a", names, pan, info),
                 sub.emit_vps_submission(out_dir, "vps_b", names[:2], pan, info)]
    sub.write_vps_pred_json(out_dir, per_video)
    zpath = sub.zip_submission(out_dir)
    with zipfile.ZipFile(zpath) as zf:
        members = [(i.filename, zf.read(i)) for i in zf.infolist()]
    return per_video, members


def test_submission_trees_equal_jax(tmp_path):
    want_info, want_zip = _emit(j_submission, str(tmp_path / "jax"))
    got_info, got_zip = _emit(t_submission, str(tmp_path / "port"))
    assert got_info == want_info
    assert got_zip == want_zip and len(want_zip) == 2 * T + 3 * T
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for k in want:
        if k != "submission.zip":  # the archive's timestamps differ; members compared above
            assert got[k] == want[k], k


def test_visualization_equals_jax(tmp_path):
    from univs_tpu.utils import visualization as j_vis
    from univs_tpu_torch.utils import visualization as t_vis

    for i in range(26):  # the DAVIS palette, then seeded colours
        np.testing.assert_array_equal(t_vis.color_for(i), j_vis.color_for(i))
    frame = np.random.RandomState(0).randint(0, 256, (H, W, 3)).astype(np.uint8)
    masks = list(_objects(2)[:, 0])
    np.testing.assert_array_equal(t_vis.overlay_instances(frame, masks, alpha=0.4),
                                  j_vis.overlay_instances(frame, masks, alpha=0.4))
    labels = _id_maps(_objects(3)).astype(np.uint8)
    names = [f"x/{t:03d}.jpg" for t in range(T)]
    t_vis.save_vos_video(labels, str(tmp_path / "port"), names)
    j_vis.save_vos_video(labels, str(tmp_path / "jax"), names)
    t_vis.save_vos_video(labels[:2], str(tmp_path / "port" / "unnamed"))
    j_vis.save_vos_video(labels[:2], str(tmp_path / "jax" / "unnamed"))
    want = _tree(tmp_path / "jax")
    assert _tree(tmp_path / "port") == want and len(want) == T + 2
