"""The reduction of a trace to busy time, idle gaps and kernel time,
and the readers that divide by it."""

import pytest

from harness import cells, counts, layers as L
from harness import trace as T

MS = 1_000_000   # nanoseconds


def _trace():
    device = [(0 * MS, 4 * MS, "void max_pool_forward_nhwc<float>"),
              (2 * MS, 6 * MS, "sm80_xmma_gemm"),
              (8 * MS, 9 * MS, "void max_pool_backward_nhwc<float>"),
              (9 * MS, 9 * MS + 5_000, "Memcpy HtoD")]
    host = [(0, 20 * MS, "bench.traced_segment"),
            (5 * MS, 8 * MS, "aten::conv2d"),
            (6 * MS + 500_000, 7 * MS, "cudaLaunchKernel")]
    return T.Trace(device, host, (0, 10 * MS))


def test_busy_is_the_union_of_device_intervals():
    tr = _trace()
    assert tr.busy_intervals() == [[0, 6 * MS], [8 * MS, 9 * MS + 5_000]]
    assert tr.busy_s == pytest.approx(0.007005)
    assert tr.window_s == pytest.approx(0.010)


def test_idle_gaps_by_what_the_host_was_doing():
    gaps = dict(_trace().idle_gaps())
    # 6-8 ms: aten::conv2d began before 6 ms and runs on
    assert gaps["aten::conv2d"] == pytest.approx(0.002)
    assert gaps["bench.traced_segment"] == pytest.approx(0.000995)


def test_kernel_time_by_name():
    import re
    seconds, n = _trace().seconds_matching(re.compile("max_pool"))
    assert (seconds, n) == (pytest.approx(0.005), 2)


def test_an_empty_trace_is_refused():
    with pytest.raises(T.TraceError):
        T.Trace([], [], (0, MS))


def test_the_training_readers_on_a_traced_window():
    items = L.walk(
        [{"type": "conv", "->": {"n_kernels": 4, "kx": 3, "ky": 3}},
         {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
         {"type": "softmax", "->": {"output_sample_shape": 3}}], (9, 9, 1))
    pool_bytes = 10 * counts.pool_bytes(items, 8, backward=True)
    view = type("V", (), {"card": "NVIDIA H100 80GB HBM3", "layer": {
        "kind": "train", "trace": _trace(), "pool_bytes": pool_bytes,
        "flops_per_sample": counts.train_flops(items),
        "update_ms": [0.3, 0.2, 0.4],
        "window": {"seconds": 2.0, "steps": 100, "images": 800,
                   "enqueue_s": 0.5}}})
    assert cells.reader("train.host_enqueue_ms_per_step")(view) == 5.0
    assert cells.reader("train.update_ms_per_step")(view) == 0.3
    assert cells.reader("device.idle_pct.train")(view) == \
        pytest.approx(29.95)
    assert cells.reader("pool_roofline.train")(view) == pytest.approx(
        100 * pool_bytes / 3.35e12 / 0.005)
    assert cells.reader("train.mfu_pct")(view) == pytest.approx(
        100 * counts.train_flops(items) * 400 / 67e12)
    view.card = "an unlisted card"
    assert cells.reader("train.mfu_pct")(view) is None
