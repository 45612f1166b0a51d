"""Shared set-up of the port's tool tests: a synthetic ytvis tree under a
data root (one video of PNG frames, two GT ellipses stored as RLEs), as
``tests/test_torch_entry.py`` builds it, and the rank of a two-process
``run_net --train``.  Imports neither JAX nor the JAX package, so that a
spawned rank starts in seconds."""

import contextlib
import io
import json
import os
import shutil
import socket

import numpy as np
import torch
from PIL import Image

from univs_tpu_torch.data.datasets import get_spec
from univs_tpu_torch.utils import rle

DATASET = "ytvis_2019_val"


def write_ytvis_tree(root, H: int = 48, W: int = 64, V: int = 5, seed: int = 0) -> dict:
    """``DATASET``'s JSON and frames under ``root``; returns the JSON."""
    spec = get_spec(DATASET)
    frames_dir = os.path.join(root, spec.image_root, "v1")
    os.makedirs(frames_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = []
    for t in range(V):
        Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8)).save(
            os.path.join(frames_dir, f"{t:05d}.png"))
        names.append(f"v1/{t:05d}.png")
    yy, xx = np.mgrid[0:H, 0:W]
    ellipses = [((((yy - cy) / 8.0) ** 2 + ((xx - cx) / 12.0) ** 2) <= 1).astype(np.uint8)
                for cy, cx in ((15, 20), (30, 45))]
    anns = [{"id": i + 1, "video_id": 1, "category_id": i + 1, "iscrowd": 0,
             "segmentations": [rle.encode(m)] * V} for i, m in enumerate(ellipses)]
    data = {"videos": [{"id": 1, "file_names": names, "height": H, "width": W, "length": V}],
            "annotations": anns,
            "categories": [{"id": c, "name": str(c)} for c in range(1, 41)]}
    path = os.path.join(root, spec.json_path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f)
    return data


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_net_argv(out, max_iter, *extra):
    """The tiny CLI's ``--train`` on the CPU over ``DATASET``."""
    return ["--train", "--tiny", "--device", "cpu", "--datasets", f"{DATASET}:1.0",
            "--batch-size", "2", "--image-size", "64", "--ckpt-every", "2",
            "--max-iter", str(max_iter), "--output", out, *extra]


def run_net_cli(argv) -> str:
    """The port's ``run_net.main(argv)`` in-process; its stdout."""
    from univs_tpu_torch.tools import run_net

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_net.main(argv)
    return buf.getvalue()


def run_net_worker(rank, ports, root, out, world: int = 2):
    """One of ``world`` torchrun ranks (its environment set here, one free
    port a rendezvous): ``--batch-size 3`` (refused), ``--train`` for 2
    steps (rank 0 keeps its ``ckpt_final`` as ``<out>_ckpt_final_2``), then
    ``--resume`` to 3; the refusal and both stdouts saved to
    ``root/rank<r>.pt``."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      UNIVS_TPU_DATA_ROOT=root)
    res = {}
    os.environ["MASTER_PORT"] = str(ports[0])
    try:
        run_net_cli(run_net_argv(out + "_odd", 2, "--batch-size", "3"))
    except ValueError as e:
        res["refused"] = str(e)
    os.environ["MASTER_PORT"] = str(ports[1])
    res["train"] = run_net_cli(run_net_argv(out, 2))
    if rank == 0:  # the step-2 ckpt_final, which the resume rewrites
        shutil.copy(os.path.join(out, "ckpt_final"), out + "_ckpt_final_2")
    os.environ["MASTER_PORT"] = str(ports[2])
    res["resume"] = run_net_cli(run_net_argv(out, 3, "--resume"))
    torch.save(res, os.path.join(root, f"rank{rank}.pt"))
