"""The readers of the program's spans, on a synthetic traced segment and
synthetic span totals: device time a step by part, launches a step and
the device idle of an epoch turn; and None where there is nothing to
read (no spans, no device times, a program without span totals)."""

import pytest

from harness import cells
from harness import trace as T

MS = 1_000_000   # nanoseconds


def _trace():
    """A 100 ms segment of two steps and an epoch turn: the card idles
    from 40 ms (inside the readback) and from 52 ms (inside the next
    epoch's order) to 55 ms; its other gaps (10-12 ms, and 90-100 ms
    after the last step) begin outside the turn."""
    device = [(0, 10 * MS, "sm80_xmma_fprop"),
              (12 * MS, 40 * MS, "sm80_xmma_wgrad"),
              (50 * MS, 52 * MS, "Memcpy HtoD"),
              (55 * MS, 90 * MS, "sm80_xmma_dgrad")]
    host = [(0, 100 * MS, "bench.traced_segment"),
            (0, 30 * MS, "fused.step"),
            (1 * MS, 2 * MS, "cudaLaunchKernel"),
            (3 * MS, 4 * MS, "cuLaunchKernelEx"),
            (5 * MS, 6 * MS, "cudaMemcpyAsync"),
            (20 * MS, 21 * MS, "cudaLaunchKernelExC"),
            (31 * MS, 32 * MS, "cudaLaunchKernel"),   # outside every step
            (35 * MS, 45 * MS, "fused.readback"),
            (48 * MS, 53 * MS, "fused.epoch_perm"),
            (54 * MS, 80 * MS, "fused.step"),
            (60 * MS, 61 * MS, "cudaGraphLaunch"),
            (62 * MS, 63 * MS, "cudaLaunchKernel"),
            (64 * MS, 65 * MS, "cudaLaunchKernel"),
            (70 * MS, 71 * MS, "aten::add")]
    return T.Trace(device, sorted(host), (0, 100 * MS))


def _view(trace):
    return type("V", (), {"card": "NVIDIA H100 80GB HBM3", "layer": {
        "kind": "train", "trace": trace}})


TOTALS = {
    "fused.window": {"count": 1, "host_s": 0.2, "device_s": None},
    "fused.step": {"count": 4, "host_s": 0.1, "device_s": 0.112},
    "fused.forward": {"count": 4, "host_s": 0.02, "device_s": 0.036},
    "fused.backward": {"count": 4, "host_s": 0.03, "device_s": 0.064},
    "fused.update": {"count": 4, "host_s": 0.01, "device_s": 0.01},
}


@pytest.fixture
def totals(monkeypatch):
    """``telemetry.span_totals`` of the program, set by the test."""
    from znicz_tpu_torch.core import telemetry
    box = {}
    monkeypatch.setattr(telemetry, "span_totals", lambda: box)
    return box


def test_device_time_a_step_by_part(totals):
    totals.update(TOTALS)
    view = _view(_trace())
    assert cells.reader("train.forward_ms_per_step")(view) == \
        pytest.approx(9.0)
    assert cells.reader("train.backward_ms_per_step")(view) == \
        pytest.approx(16.0)
    assert cells.reader("train.window_update_ms_per_step")(view) == \
        pytest.approx(2.5)


def test_launches_inside_the_steps_alone():
    # 3 calls in the first step (the copy is no launch), 3 in the
    # second; the call between them counts for neither
    assert cells.reader("train.launches_per_step")(_view(_trace())) == 3.0


def test_a_drained_turn_whose_gap_begins_inside_the_readback():
    # 40-50 ms begins inside fused.readback, 52-55 ms inside
    # fused.epoch_perm; one readback in the segment
    assert cells.reader("train.epoch_turn_idle_ms")(_view(_trace())) == \
        pytest.approx(13.0)


NAMES = ("train.forward_ms_per_step", "train.backward_ms_per_step",
         "train.window_update_ms_per_step", "train.launches_per_step",
         "train.epoch_turn_idle_ms")


def test_nothing_to_read_gives_none(totals):
    bare = T.Trace([(0, 10 * MS, "k")], [(1 * MS, 2 * MS,
                                          "cudaLaunchKernel")],
                   (0, 20 * MS))
    for name in NAMES:
        assert cells.reader(name)(_view(bare)) is None, name
        assert cells.reader(name)(type("V", (), {"card": "x", "layer": {
            "kind": "train"}})) is None, name
    # spans booked without device times (a net off the card)
    totals.update({k: dict(v, device_s=None) for k, v in TOTALS.items()})
    for name in NAMES[:3]:
        assert cells.reader(name)(_view(_trace())) is None, name


def test_a_program_without_span_totals_gives_none(monkeypatch):
    from znicz_tpu_torch.core import telemetry
    monkeypatch.delattr(telemetry, "span_totals", raising=False)
    for name in NAMES[:3]:
        assert cells.reader(name)(_view(_trace())) is None, name
