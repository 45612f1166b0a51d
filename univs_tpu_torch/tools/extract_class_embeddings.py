"""Extract the frozen CLIP category-embedding bank (counterpart of the JAX
package's ``tools/extract_class_embeddings.py``, with its arguments, its
printed lines and ``--device``).

Equivalent of the reference's offline concept-embedding extraction
(reference: tools/clip_concept_extraction/ +
univs/modeling/language/extract_class_embed.py): for each category name
in the combined namespace list, embed 81 prompt templates through the
CLIP text tower and average the EOT features -> [N, D] bank.

    python -m univs_tpu_torch.tools.extract_class_embeddings \\
        --names datasets/concept_emb/combined_datasets.txt \\
        --clip-weights clip_rn50x4_text.pth --out bank.npy

The tower is read from an OpenAI-named ``.pth`` through
``convert_clip_text``, its geometry from the weights (heads = width / 64,
as ``run_net --clip-weights``); without weights it is the seeded random
RN50x4 tower (a smoke run).  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np


def load_names(path: str) -> List[str]:
    """One bank row per line; synonym rows ("tench, Tinca tinca,") stay
    whole — clean_strings concatenates the synonyms (reference:
    extract_concept_emb.py:60-69)."""
    names = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            names.append(line)
    return names


def text_encoder(clip_weights: Optional[str], device, seed: int = 0):
    """The ``TextPromptEncoder`` of ``clip_weights`` (an OpenAI-named
    text tower), or of the seeded random RN50x4 tower when None."""
    from univs_tpu_torch.models.clip_text import TextPromptEncoder
    from univs_tpu_torch.tools.run_net import text_encoder_from

    if clip_weights:
        return text_encoder_from(clip_weights, device)
    print("WARNING: no CLIP weights — random tower (smoke only)")
    return TextPromptEncoder(None, device=device, seed=seed)


def extract(tpe, names: Sequence[str], batch: int = 8) -> np.ndarray:
    """[len(names), D] float32: ``encode_category_names`` over batches of
    ``batch`` names, the tail padded with "object" so that every call
    has one shape, as the JAX tool pads it for one compiled encode."""
    bank = []
    for i in range(0, len(names), batch):
        chunk = list(names[i:i + batch])
        npad = batch - len(chunk)
        emb = tpe.encode_category_names(chunk + ["object"] * npad).cpu().numpy()
        bank.append(emb[:len(chunk)])
        if i % 512 == 0:
            print(f"{i}/{len(names)}", flush=True)
    return np.concatenate(bank)


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--names", required=True)
    p.add_argument("--clip-weights", default=None, help=".pth CLIP text tower (OpenAI naming)")
    p.add_argument("--out", default="bank.npy")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the card when absent (raises without one), "
                        "'cpu' to run on the CPU")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    from univs_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    names = load_names(args.names)
    print(f"{len(names)} category names")
    bank = extract(text_encoder(args.clip_weights, device), names, args.batch)
    np.save(args.out, bank)
    print(f"wrote {args.out} {bank.shape}")
    return bank


if __name__ == "__main__":
    main()
