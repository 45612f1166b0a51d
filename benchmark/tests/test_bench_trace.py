"""The trace's reduction and the metric readers, on a synthetic trace."""

import pytest

from benchmark.harness.cell import Run
from benchmark.harness.spec import Cell, Spec
from benchmark.harness.trace import parse_chrome_trace
from benchmark.tests.tiny import ROOT


def _events():
    ev = []

    def kernel(name, ts, dur, corr, launch):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
                   "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                   "args": {"correlation": corr}})

    ev.append({"ph": "X", "cat": "user_annotation", "name": "bench.pixel_decoder", "ts": 0,
               "dur": 100})
    ev.append({"ph": "X", "cat": "user_annotation", "name": "bench.decoder", "ts": 200, "dur": 100})
    ev.append({"ph": "X", "cat": "user_annotation", "name": "bench.finish_vis", "ts": 400,
               "dur": 300})
    ev.append({"ph": "X", "cat": "user_annotation", "name": "other", "ts": 0, "dur": 5})
    kernel("void msda_sample_kernel<__nv_bfloat16>(...)", 10, 40, 1, 5)
    kernel("msda_rows_mma_kernel", 50, 20, 2, 6)
    kernel("ffn_wgmma_kernel", 70, 30, 3, 7)
    kernel("gemm", 210, 50, 4, 250)
    kernel("gemm", 240, 40, 5, 350)  # overlaps; launched outside any range
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 600, "dur": 100})
    return ev


def test_busy_ranges_and_gaps():
    tr = parse_chrome_trace(_events(), window_s=1e-3)
    assert tr.busy_us() == 40 + 20 + 30 + 70 + 100
    assert tr.device_us_in("decoder") == 50
    assert tr.device_us_in("pixel_decoder") == 90
    assert tr.range_count("decoder") == 1 and tr.range_count("other") == 0
    top = tr.top_ops(2)
    assert [n for n, _ in top] == ["Memcpy HtoD", "gemm"]
    assert top[1][1] == pytest.approx(90e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps == {"decoder": pytest.approx(110e-6), "finish_vis": pytest.approx(320e-6)}


def test_readers_on_a_synthetic_trace():
    spec = Spec(ROOT)
    tr = parse_chrome_trace(_events(), window_s=1e-3)
    tr.units = {"frames": 5, "videos": 1}
    model = spec.config("univs-swinl")["model"]
    model = dict(model, pixel_decoder=dict(model["pixel_decoder"], num_layers=1))
    run = Run(Cell("vss-swinl", "univs-swinl", "vss_stream", 1, ""), model,
              spec.traffic("vss_stream"), 1.0, 1.0, {"frames": 30}, {"run_vss": [0.5, 0.7]}, tr, tr)
    assert spec.reader("decoder_ms.vis")(run) == 0.05
    assert spec.reader("pixel_decoder_ms.vss")(run) == 90 / 1e3 / 5
    idle = spec.reader("idle_share.vss")(run)
    assert abs(idle - 100 * (1 - 260e-6 / 1e-3)) < 1e-9
    a = spec.reader("msda_sample_roofline.vss")(run)
    assert abs(a - 100 * 0.246 / 6 / 0.040) < 0.5  # 5 frames: a sixth of the 30-frame bound
    assert spec.reader("mfu.vss")(run) > 0
    run.trace = run.attribution = None
    assert spec.reader("mfu.vss")(run) is None and spec.reader("decoder_ms.vis")(run) is None
    assert spec.reader("vss_fps")(run) == 30.0
