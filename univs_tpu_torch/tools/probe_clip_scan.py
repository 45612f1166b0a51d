"""A window's clip steps without the per-clip dispatch: host issue against
device busy time, and a CUDA graph of the clip's decode (counterpart of
``tools/probe_clip_scan.py``).

The TPU question: the driver dispatches the clip function and the ring
shift per clip at a fixed cost per dispatch, so a window's emit-less
clips are folded into ONE ``lax.scan`` and the final pool is checked bit
for bit against the per-clip loop.  The card's form, in two parts:

- the eager loop over the video's clip schedule (``_iter_clips``: the
  window's features sliced per clip, ``entity_clip_step``, ``shift_clip``
  unless last), with the host's time per clip beside the device's busy
  time per clip (torch.profiler over the loop's first ``PROFILED_CLIPS``
  clips, whose events cost host time to read): where the device idles,
  the host's issue and its synchronisations hold it back;
- a CUDA graph, the card's way to issue many kernels at once.  The whole
  clip step does not capture: it synchronises with the host (the
  Hungarian's host walk in ``memory_pool.match_candidates_to_memory``,
  the ``.cpu()`` reads of the emission path).  So the graph captures the
  clip's DECODE (``probe_pe_cache.decode_clip``: the finest prompt grid
  and the sot decode over the pool's prompt queries), with its PE grids
  and the self-attention bias computed before the capture (the PE cache
  of ``probe_pe_cache``: both are built from host data, which a capture
  cannot copy); the replay is held bit for bit to the decode as
  shipped, and both are timed with CUDA events (per clip: the shipped
  span is the host's issue, the replay's the device's work).  The decode
  as shipped replays the decoder's own graph of its layer stack from a
  shape's second call on (``models/decoder.py``), so only its first call
  (``want``) is wholly eager; inside this probe's capture it runs eagerly.

The aliasing watch point: the pool is updated in place, so an emitted
window must be a copy taken before ``evict_window`` (``EntityDriver._emit``)
and a graph's outputs must be cloned before the next replay; both are
checked.  On the CPU no graph is captured (``graph`` is None) and the
eager half runs.

    python -m univs_tpu_torch.tools.probe_clip_scan [--device cuda]
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence

import torch

from univs_tpu_torch.tools import _probe_util as pu
from univs_tpu_torch.tools.probe_pe_cache import cached_pe, decode_clip, pe_grids, sot_prompts

PROFILED_CLIPS = 4  # clips of the loop under the profiler: reading its events costs host time


def parse_args(argv: Optional[Sequence[str]] = None):
    return pu.parser(__doc__, iters=10, warmup=2, video=30).parse_args(argv)


@contextlib.contextmanager
def capturable(decoder, frame_indices, sizes):
    """The decoder's host-made inputs (its PE grids, the self-attention
    bias) computed before the block and served from memory inside it."""
    from univs_tpu_torch.models import decoder as dec_mod

    shipped = dec_mod.build_self_attn_bias
    biases = {}

    def bias(*args, **kw):
        key = (args, tuple(sorted((k, str(v)) for k, v in kw.items())))
        if key not in biases:
            biases[key] = shipped(*args, **kw)
        return biases[key]

    with cached_pe(decoder, pe_grids(decoder, sizes, frame_indices), frame_indices), \
            pu.patched(dec_mod, "build_self_attn_bias", bias):
        yield


def emitted_copy_survives(driver, pool) -> bool:
    """``_emit``'s window is a copy: ``evict_window`` leaves it unchanged."""
    from univs_tpu_torch.inference import memory_pool as mp

    work = pu.clone_pool(pool)
    win, _, _ = driver._emit(work, 2, divide=True)
    keep = win.clone()
    work.mask_logits.add_(1.0)
    mp.evict_window(work, 2)
    return bool(torch.equal(win, keep))


@torch.no_grad()
def main(argv: Optional[Sequence[str]] = None, model=None) -> dict:
    from univs_tpu_torch.inference import memory_pool as mp
    from univs_tpu_torch.inference.entity import entity_clip_step

    args = parse_args(argv)
    s = pu.setup(args, model)
    dev, T, V = s.device, s.T, args.video_frames
    driver = pu.entity_driver(s)
    plan = list(driver._iter_clips(V))
    Wn = min(driver.window, V)
    feats_w = pu.encode(s, pu.video(s, Wn, blobs=args.floored))
    n_scan = sum(1 for c in plan if not c["emits"] and not c["is_last"])
    pu.log(f"V={V}: {len(plan)} clips, {n_scan} scannable (emit-less, non-last)")

    def clip_feats(c):
        rel = torch.as_tensor(c["rel"], device=dev)
        return feats_w[0][rel], tuple(m[rel] for m in feats_w[1])

    host_s, last = [], {}

    def run_loop(clips=plan):
        pool = last["pool"] = driver._new_pool(driver.capacity, pu.K, s.h, s.w)
        for c in clips:
            t0 = time.perf_counter()
            entity_clip_step(driver._modules, clip_feats(c), pool, c["clip_idx"], c["offset"],
                             c["i"] == 0, s.cls_emb, driver.cc)
            if not c["is_last"]:
                mp.shift_clip(pool, driver.stride)
            host_s.append(time.perf_counter() - t0)
        return pool

    run_loop()
    host_s.clear()
    loop_ms, _ = pu.wall_ms(run_loop, dev, 1, 0)
    host_ms = sum(host_s) * 1e3 / len(plan)
    pool = last["pool"]
    n_prof = min(PROFILED_CLIPS, len(plan))
    busy = pu.device_busy_ms(lambda: run_loop(plan[:n_prof]), dev)
    busy_ms = None if busy is None else busy / n_prof
    pu.log(f"sequential: {loop_ms:.1f} ms/video-decode ({loop_ms / len(plan):.2f} ms/clip "
           f"incl. shift); host {host_ms:.2f} ms/clip, device busy "
           + (f"{busy_ms:.2f} ms/clip" if busy_ms is not None else "not measured"))

    # the clip decode as shipped against a CUDA graph of the whole of it
    dec = s.model.decoder
    c0 = plan[min(1, len(plan) - 1)]
    feats = clip_feats(c0)
    fi = torch.as_tensor(c0["clip_idx"], device=dev)[None]
    vp = sot_prompts(pool, driver.cc, T)
    sizes = [tuple(m.shape[1:3]) for m in feats[1]]
    want = decode_clip(dec, feats, fi, vp, s.cls_emb)
    t_eager = pu.event_ms(lambda: decode_clip(dec, feats, fi, vp, s.cls_emb), dev, args.iters,
                          args.warmup)
    graph = None
    if dev.type == "cuda":
        with capturable(dec, fi, sizes):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(3):
                    decode_clip(dec, feats, fi, vp, s.cls_emb)
            torch.cuda.current_stream(dev).wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                static = decode_clip(dec, feats, fi, vp, s.cls_emb)
        g.replay()
        got = [t.clone() for t in static]
        bit_equal = all(torch.equal(a, b) for a, b in zip(want, got))
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(want, got))
        t_graph = pu.event_ms(g.replay, dev, args.iters, args.warmup)
        # a replay rewrites the graph's output buffers: on new inputs the
        # buffer moves and only a clone keeps the earlier clip's masks
        feats[0].mul_(2.0)
        g.replay()
        overwritten = not torch.equal(static[3], got[3])
        clone_kept = overwritten and torch.equal(got[3], want[3])
        graph = dict(bit_equal=bit_equal, max_abs_err=err, replay_ms=t_graph,
                     clone_survives_replay=clone_kept)
        pu.log(f"max |eager - graph| over the decode's outputs: {err:.3e}")
        pu.log(f"decode eager {t_eager:.2f} ms/clip, graph replay {t_graph:.2f} ms/clip")
        del g, static
    else:
        pu.log(f"decode eager {t_eager:.2f} ms/clip (no CUDA graph on the CPU)")
    alias_ok = emitted_copy_survives(driver, pool)
    pu.log(f"emitted window survives evict_window: {alias_ok}")
    return dict(clips=len(plan), scannable=n_scan, loop_ms=loop_ms, host_ms_per_clip=host_ms,
                device_busy_ms_per_clip=busy_ms, profiled_clips=n_prof, decode_eager_ms=t_eager,
                graph=graph,
                captured="sot decode (prompt grid + decoder), PE and self-attention bias "
                         "precomputed", emitted_copy_ok=alias_ok, video_frames=V,
                frames=T, height=s.h, width=s.w, card=pu.card(dev))


if __name__ == "__main__":
    main()
