"""decoder_replays.vss: the program's ``decoder_graph_replays`` counter (the
decoder's layer stack replayed from a CUDA graph) over the traced windows,
a clip, over the windows' ``clip.decode`` spans; None where the program's
decoder keeps no graphs (no ``GRAPHS`` in ``models/decoder.py``)."""

import importlib

from benchmark.harness import spans


def read(run):
    try:
        decoder = importlib.import_module("univs_tpu_torch.models.decoder")
    except ImportError:
        return None
    if not hasattr(decoder, "GRAPHS"):
        return None
    return spans.count_per(run.attribution, "decoder_graph_replays", None, "clip.decode")
