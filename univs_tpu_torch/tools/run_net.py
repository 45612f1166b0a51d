"""Train / evaluate UniVS with the port — the ``train_net.py`` equivalent
(counterpart of the JAX package's ``tools/run_net.py``, with the same
arguments and ``--device``).

    # evaluate VIS on a dev split (weights: a reference UniVS .pth or a
    # checkpoint written by --train)
    python -m univs_tpu_torch.tools.run_net --eval-only --dataset ytvis_2021_dev \\
        --weights univs_r50.pth --bank datasets/concept_emb/bank.npy

    # train stage 2 (detection prompts) on a dataset mixture
    python -m univs_tpu_torch.tools.run_net --train \\
        --datasets ytvis_2021_train:0.6,coco_panoptic_train:0.4 \\
        --batch-size 8 --max-iter 10000 --output out/

    # the same global batch over two processes, one card each
    torchrun --nproc_per_node 2 -m univs_tpu_torch.tools.run_net --train \\
        --datasets ytvis_2021_train:1.0 --batch-size 8 --output out/

Runs on the card unless ``--device cpu`` is given (and raises without a
card).  Under ``torchrun`` (WORLD_SIZE set) ``--train`` is data parallel
over the processes (``parallel/ddp.py``, the port's counterpart of the JAX
tool's ``make_mesh()`` data axis): ``--batch-size`` is the global batch,
split evenly over the ranks, and the state advances as one process's on
the whole batch.  Each rank takes ``cuda:(LOCAL_RANK % cards)``; the
backend is ``--dist-backend`` (NCCL on the card, gloo on the CPU or for
ranks that share a card).  Evaluation runs in one process.
Reference entry point: train_net.py.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--train", action="store_true")
    p.add_argument("--config-file", type=str, default=None,
                   help="reference-style yacs YAML (with _BASE_ inheritance)")
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=[],
                   help="dotted overrides: our paths (decoder.num_queries=100) "
                        "or yacs keys (MODEL.MASK_FORMER.NUM_OBJECT_QUERIES 100)")
    p.add_argument("--dataset", type=str, help="dataset to evaluate")
    p.add_argument("--datasets", type=str, help="train mixture name:ratio,name:ratio")
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--bank", type=str, default=None, help="category embedding bank (.npy/.pth)")
    p.add_argument("--backbone", type=str, default="resnet50")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-iter", type=int, default=1000)
    p.add_argument("--num-frames", type=int, default=2)
    p.add_argument("--image-size", type=int, default=1024)
    p.add_argument("--max-videos", type=int, default=None)
    p.add_argument("--output", type=str, default="output")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--tiny", action="store_true", help="tiny model for smoke tests")
    p.add_argument("--vos-queries", type=str, default="prompt",
                   choices=["prompt", "learn", "prompt+learn"],
                   help="VOS back-end re-ID variant "
                        "(VIDEO_UNIFIED_INFERENCE_QUERIES)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clip-weights", default=None,
                   help="CLIP text-tower weights (OpenAI naming): grounding (RefVOS) "
                        "eval encodes expressions with the real tower instead of the "
                        "random-prompt smoke path")
    p.add_argument("--pipeline", action="store_true",
                   help="two-card pipelined streaming for entity-driver eval "
                        "(encode on cuda:0, decode + pool on cuda:1)")
    p.add_argument("--resume", action="store_true",
                   help="resume training from the latest state_* checkpoint "
                        "in --output (full state: params + optimizer + EMA + "
                        "step — the reference's DetectionCheckpointer "
                        "resume_or_load, train_net.py:377-393)")
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the card when absent (raises without one; "
                        "cuda:LOCAL_RANK under torchrun), 'cpu' to run on the CPU")
    p.add_argument("--dist-backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="process-group backend under torchrun: NCCL on the card and "
                        "gloo on the CPU when absent; gloo for ranks that share a card")
    return p.parse_args(argv)


def latest_state(output: str) -> Optional[str]:
    """Newest full-state checkpoint ``state_<iter>`` under output."""
    cands = []
    for path in glob.glob(os.path.join(output, "state_*")):
        tail = os.path.basename(path).split("_")[-1]
        if os.path.isfile(path) and tail.isdigit():
            cands.append((int(tail), path))
    return max(cands)[1] if cands else None


def build_cfg(args):
    """Config priority: dataclass defaults < --config-file (yacs YAML)
    < --opts dotted overrides; --tiny short-circuits to the smoke cfg."""
    from univs_tpu_torch.config import (BackboneConfig, InferenceConfig, TrainConfig, UniVSConfig,
                                        tiny_test_config)

    vq = getattr(args, "vos_queries", "prompt")
    if getattr(args, "tiny", False):
        return tiny_test_config().replace(
            inference=InferenceConfig(num_frames=2, clip_stride=1, num_frames_window=4,
                                      min_size_test=64, apply_cls_thres=0.0, topk_per_video=5,
                                      max_num_instances=6,
                                      video_unified_inference_queries=vq),
            # cheap criterion for smoke runs (full 12544-point sampling
            # makes a single-core CPU train step take tens of minutes)
            train=TrainConfig(num_points=64, oversample_ratio=2.0),
        ), {}
    extras = {}
    if getattr(args, "config_file", None):
        from univs_tpu_torch.config_io import config_from_yacs

        cfg, extras, unmapped = config_from_yacs(args.config_file)
        if unmapped:
            print(f"[config] {len(unmapped)} yacs keys without an equivalent in the "
                  f"config (first 10): {unmapped[:10]}")
        cfg = cfg.replace(dtype="bfloat16" if args.bf16 else cfg.dtype)
    else:
        cfg = UniVSConfig(
            backbone=BackboneConfig(name=args.backbone),
            num_frames=args.num_frames,
            dtype="bfloat16" if args.bf16 else "float32",
        )
    cfg = cfg.replace(
        inference=dataclasses.replace(cfg.inference, video_unified_inference_queries=vq)
    )
    if getattr(args, "opts", None):
        from univs_tpu_torch.config_io import apply_overrides

        cfg = apply_overrides(cfg, args.opts)
    return cfg, extras


def initial_params(cfg, seed: int = 0) -> Dict:
    """The float32 state_dict of the port's seeded init of ``cfg``'s model
    (the JAX tool's ``init_params``)."""
    from univs_tpu_torch.models.univs import UniVSModel
    from univs_tpu_torch.utils import weights

    model = UniVSModel(cfg)
    weights.init_params(model, seed)
    return model.state_dict()


def build(cfg, weights: Optional[str], seed: int, device):
    """The model of ``--weights`` (through ``load_params``), else of the
    seeded init, on ``device``."""
    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.utils.checkpoint import load_params

    return build_model(cfg, load_params(weights, cfg) if weights else None, seed=seed,
                       device=device)


def text_encoder_from(path: str, device):
    """The CLIP text tower of an OpenAI-named checkpoint
    (``token_embedding.weight``, ``transformer.resblocks.N``...) through
    ``convert_clip_text``, its geometry read from the weights (heads =
    width / 64, as OpenAI's CLIP)."""
    from univs_tpu_torch.models.clip_text import ClipTextEncoder, TextPromptEncoder
    from univs_tpu_torch.utils.checkpoint import load_params
    from univs_tpu_torch.utils.convert import convert_clip_text
    from univs_tpu_torch.utils.convert_univs import _max_index
    from univs_tpu_torch.utils.weights import state_dict_from_flax

    sd = load_params(path)
    vocab, width = sd["token_embedding.weight"].shape
    layers = _max_index(sd, "transformer.resblocks.")
    encoder = ClipTextEncoder(embed_dim=sd["text_projection"].shape[1],
                              context_length=sd["positional_embedding"].shape[0],
                              vocab_size=vocab, width=width, heads=width // 64,
                              num_layers=layers)
    params = state_dict_from_flax(convert_clip_text(sd, num_layers=layers, width=width))
    return TextPromptEncoder(params, encoder=encoder, device=device)


def _fill_from_extras(args, extras) -> None:
    """Fall back to the YAML's dataset / weights fields when flags are absent."""
    if not args.dataset and extras.get("datasets_test"):
        args.dataset = list(extras["datasets_test"])[0]
    if not args.datasets and extras.get("datasets_train"):
        ratios = extras.get("dataset_ratio") or [1.0] * len(extras["datasets_train"])
        args.datasets = ",".join(
            f"{n}:{r}" for n, r in zip(extras["datasets_train"], ratios)
        )
    if not args.weights and extras.get("weights"):
        args.weights = extras["weights"]
    if not args.bank and extras.get("class_embed_path"):
        if os.path.exists(extras["class_embed_path"]):
            args.bank = extras["class_embed_path"]


def evaluate(args, cfg, bank, device) -> Dict[str, float]:
    """--eval-only: ``engine.evaluate_dataset`` on the model of --weights."""
    from univs_tpu_torch.engine import evaluate_dataset
    from univs_tpu_torch.prompts.prepare_targets import PrepareTargets

    model = build(cfg, args.weights, args.seed, device)
    try:
        cls_slice = PrepareTargets(bank).category_slice(args.dataset)
    except KeyError:
        # class-agnostic VOS/SOT/MOSE datasets have no category
        # namespace; the drivers only need a nonempty cls_emb
        cls_slice = bank[:1]
    text_encoder = text_encoder_from(args.clip_weights, device) if args.clip_weights else None
    return evaluate_dataset(
        cfg, model, args.dataset, cls_slice,
        max_videos=args.max_videos, output_dir=args.output,
        text_encoder=text_encoder, pipeline=args.pipeline, device=device,
    )


def agreed_start(start_it: int, world) -> int:
    """The resumed step, the same on every rank (raises if the ranks read
    different checkpoints)."""
    if not world.distributed:
        return start_it
    import torch
    import torch.distributed as dist

    both = torch.tensor([start_it, -start_it], dtype=torch.int64, device=world.device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=world.group)
    hi, lo = int(both[0]), -int(both[1])
    if hi != lo:
        raise RuntimeError(f"--resume: the ranks resumed at iterations {lo} to {hi}")
    return hi


def train(args, cfg, bank, world) -> None:
    """--train: detection-prompt training on the --datasets mixture,
    ``state_<it>`` every --ckpt-every iterations, ``ckpt_final`` at the end.

    In a world of several processes every rank builds the same loaders
    with the same seeds, so it draws (and decodes) the same global batch,
    keeps its videos (``ddp.shard_batch``) and steps with the same key;
    only rank 0 writes ``metrics.jsonl``, the states and ``ckpt_final``,
    and prints."""
    from univs_tpu_torch.data.datasets import load_dataset
    from univs_tpu_torch.data.loader import CombinedLoader, collate_train_batch, dataset_iterator
    from univs_tpu_torch.data.mapper import TrainMapperConfig, TrainVideoMapper
    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.parallel.train_state import create_train_state, make_train_step
    from univs_tpu_torch.prompts.prepare_targets import PrepareTargets
    from univs_tpu_torch.utils.checkpoint import (load_checkpoint, load_params, save_checkpoint,
                                                  save_params)
    from univs_tpu_torch.utils.draws import make_key
    from univs_tpu_torch.utils.events import EventWriter

    from univs_tpu_torch.parallel import ddp

    if args.batch_size % world.size:
        raise ValueError(f"--batch-size {args.batch_size} does not split over {world.size} "
                         "processes: the global batch is sharded evenly, as the JAX tool's "
                         "data axis")
    device, lead = world.device, world.rank == 0
    # float32 masters: the checkpoint's, or the seeded init's before the
    # working model rounds it to the compute dtype
    params = load_params(args.weights, cfg) if args.weights else initial_params(cfg, args.seed)
    pt = PrepareTargets(bank)
    items = [d.split(":") for d in args.datasets.split(",")]
    loaders, ratios = [], []
    mcfg = TrainMapperConfig(num_frames=cfg.num_frames, image_size=args.image_size,
                             max_instances=cfg.prompt.num_max_instances)
    for i, (name, ratio) in enumerate(items):
        records = load_dataset(name)
        sl = pt.category_slice(name)
        collate = lambda b, sl=sl: collate_train_batch(
            b, sl, np.ones(sl.shape[0], bool), cfg.prompt.num_max_instances
        )
        loaders.append(dataset_iterator(records, TrainVideoMapper(mcfg, seed=i),
                                        args.batch_size, collate, seed=i))
        ratios.append(float(ratio))
    loader = CombinedLoader(loaders, ratios, seed=args.seed)

    model = build_model(cfg, params, device=device)
    state = create_train_state(cfg, model, params)
    del params
    start_it = 0
    if args.resume:
        latest = latest_state(args.output)
        if latest:
            state = load_checkpoint(latest, model)
            start_it = int(state.step)
            if lead:
                print(f"resumed full train state from {latest} (iter {start_it})")
    start_it = agreed_start(start_it, world)
    if world.distributed:
        step = ddp.make_train_step(cfg, model, task="detection", group=world.group)
    else:
        step = make_train_step(cfg, model, task="detection")
    key = make_key(args.seed, device=device)
    events = EventWriter(args.output, print_every=20) if lead else None
    for it in range(start_it, args.max_iter):
        batch = ddp.shard_batch(next(loader), world.rank, world.size).to(device)
        state, logged = step(state, batch, key)
        if lead and it % 20 == 0:  # fetch scalars at the log cadence only
            events.log(it, {k: float(v) for k, v in logged.items()})
        if lead and (it + 1) % args.ckpt_every == 0:
            # full state (params + optimizer + EMA + step) so --resume
            # restarts exactly; eval loads ckpt_final
            save_checkpoint(os.path.join(args.output, f"state_{it + 1}"), state)
    if lead:
        events.close()
        save_params(os.path.join(args.output, "ckpt_final"), state)


def main(argv: Optional[Sequence[str]] = None) -> None:
    from univs_tpu_torch.data.category_info import TOTAL_CATEGORY_ROWS
    from univs_tpu_torch.parallel import ddp
    from univs_tpu_torch.utils.checkpoint import load_category_bank
    from univs_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    cfg, extras = build_cfg(args)
    _fill_from_extras(args, extras)
    if not (args.eval_only or args.train):
        print("specify --eval-only or --train")
        return
    load_bank = lambda: load_category_bank(args.bank, TOTAL_CATEGORY_ROWS,
                                           cfg.decoder.clip_cls_emb_dim)
    if args.eval_only:
        device = resolve_device(args.device)
        print(json.dumps(evaluate(args, cfg, load_bank(), device)))
        return
    world = ddp.init_from_env(args.device, args.dist_backend)
    try:
        train(args, cfg, load_bank(), world)
    finally:
        world.close()


if __name__ == "__main__":
    main()
