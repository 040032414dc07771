"""The port's spans (``znicz_tpu_torch.core.telemetry.span``) and the
fused trainer's vocabulary of them, on the CPU.

* Off (telemetry off, no ``torch.profiler`` capture) a span is the
  shared no-op: no ring entry, no totals, and a whole window makes no
  CUDA event and no range of the trace.
* On, spans nest, name their enclosing span as ``parent`` and export
  the JAX package's name, ``ph`` and args.
* Under a capture a span is a host range of the trace (a ``cpu_op``,
  with no copy on the card's timeline), armed whether telemetry is on
  or not; the ring's clock is the trace's.
* A sliced window under a capture: each ``fused.step`` holds
  ``fused.fetch``, ``fused.forward``, ``fused.backward``,
  ``fused.update`` and ``fused.stats`` in that order, and the epoch
  turn ``fused.epoch_perm`` and ``fused.readback``.
* Armed spans leave the parameters bit-equal; ``span_totals()`` counts
  the steps run, with no device time off CUDA; device event pairs are
  read without a wait when the outermost span closes, and the oldest
  is waited for only past ``PENDING_CAPACITY``.
"""

import numpy
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from znicz_tpu.core import telemetry as jax_telemetry
from znicz_tpu_torch.core import prng, telemetry
from znicz_tpu_torch.parallel import fused

LAYERS = [
    {"type": "conv", "->": {"n_kernels": 2, "kx": 3, "ky": 3,
                            "weights_stddev": 0.1},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "softmax", "->": {"output_sample_shape": 3,
                               "weights_stddev": 0.05},
     "<-": {"learning_rate": 0.05}},
]
ROWS, BATCH = 12, 4
STEPS = ("fused.fetch", "fused.forward", "fused.backward", "fused.update",
         "fused.stats")


@pytest.fixture
def tel():
    """Telemetry as the test sets it, with a clean ring and totals;
    restored after the test."""
    on = telemetry.enabled()
    telemetry.reset()
    telemetry.disable()
    yield telemetry
    telemetry.reset()
    telemetry.enable() if on else telemetry.disable()


def _net():
    net = fused.FusedNet(LAYERS, (6, 6, 1), device="cpu",
                         rand=prng.RandomGenerator().seed(3),
                         dtype=numpy.float64)
    r = numpy.random.RandomState(5)
    net.set_dataset(r.uniform(-1, 1, (ROWS, 6, 6, 1)),
                    r.randint(0, 3, ROWS).astype(numpy.int32))
    return net


def _epoch(net):
    """One epoch in one sliced window, as the trainer drives it: the
    epoch's order, the window, the accumulator's readback."""
    net.set_epoch_perm(numpy.random.RandomState(7).permutation(ROWS),
                       pad=BATCH)
    n = ROWS // BATCH
    stats = net.run_window_sliced([k * BATCH for k in range(n)], BATCH,
                                  [BATCH] * n,
                                  fused.stack_hypers(net.hypers, n))
    acc = net.window_acc_host()
    net.reset_window_acc()
    return stats, acc


def _ranges(prof, prefix="fused."):
    """``[(start_ns, end_ns, name)]`` of the capture's host ranges whose
    name starts with ``prefix``, by start; each is a ``cpu_op``."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(prefix):
            assert str(ev.activity_type()) == "cpu_op"
            assert str(ev.device_type()).endswith("CPU")
            s = ev.start_ns()
            out.append((s, s + ev.duration_ns(), ev.name()))
    return sorted(out)


def test_off_a_span_is_the_shared_no_op(tel):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tel.span("a") is tel.span("b", device=True, k=1)
    with tel.span("fused.step", device=True):
        with tel.span("fused.fetch"):
            pass
    assert tel.trace_events() == []
    assert tel.span_totals() == {}


def test_off_a_window_makes_no_event_no_range_no_entry(tel, monkeypatch):
    made = []

    def count(what):
        def make(*args, **kwargs):
            made.append(what)
            raise AssertionError("%s made while off" % what)
        return make
    net = _net()
    monkeypatch.setattr(torch.cuda, "Event", count("a CUDA event"))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        count("a range of the trace"))
    net._on_card = True   # as on the card: the off path must not look
    _epoch(net)
    net.step(numpy.zeros((BATCH, 6, 6, 1)), numpy.zeros(BATCH, numpy.int32))
    assert made == []
    assert tel.trace_events() == [] and tel.span_totals() == {}


def test_spans_nest_and_name_their_parent(tel):
    tel.enable()
    with tel.span("fused.window", form="sliced", steps=1):
        with tel.span("fused.step"):
            with tel.span("fused.fetch"):
                pass
        tel.instant("loader.epoch_end", epoch=1)
    events = tel.trace_events()
    assert [(e["name"], e["ph"], e.get("parent")) for e in events] == [
        ("fused.fetch", "X", "fused.step"),
        ("fused.step", "X", "fused.window"),
        ("loader.epoch_end", "i", None),
        ("fused.window", "X", None)]
    fetch, step, _, window = events
    for inner, outer in ((fetch, step), (step, window)):
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert window["args"] == {"form": "sliced", "steps": 1}
    assert "args" not in step


def test_span_events_as_in_jax(tel):
    on = jax_telemetry.enabled()
    jax_telemetry.reset()
    jax_telemetry.enable()
    try:
        tel.enable()
        for mod in (tel, jax_telemetry):
            with mod.span("loader.fill", size=4):
                with mod.span("fused.window", form="sliced", steps=2):
                    pass
                mod.instant("loader.epoch_end", epoch=3)
        got = [(e["name"], e["ph"], e.get("args"))
               for e in tel.trace_events()]
        want = [(e["name"], e["ph"], e.get("args"))
                for e in jax_telemetry.trace_events()]
    finally:
        jax_telemetry.reset()
        jax_telemetry.enable() if on else jax_telemetry.disable()
    assert got == want == [
        ("fused.window", "X", {"form": "sliced", "steps": 2}),
        ("loader.epoch_end", "i", {"epoch": 3}),
        ("loader.fill", "X", {"size": 4})]


@pytest.mark.parametrize("on", [False, True])
def test_under_a_capture_a_span_is_a_host_range(tel, on):
    if on:
        tel.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tel.span("fused.readback") is not tel.span("fused.x")
        with tel.span("fused.readback"):
            torch.ones(8).add_(1.0)
    (s, e, name), = _ranges(prof)
    assert name == "fused.readback"
    events = tel.trace_events()
    assert tel.span_totals()["fused.readback"]["count"] == 1
    if not on:
        assert events == []
        return
    ev, = events
    assert abs(ev["ts"] * 1e3 - s) < 1e6   # ns: the same clock, within 1 ms
    assert ev["dur"] * 1e3 <= e - s + 1e6


def test_a_sliced_window_under_a_capture(tel):
    net = _net()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _epoch(net)
    spans = _ranges(prof)
    names = [n for _, _, n in spans]
    assert names.count("fused.window") == 1
    assert names.count("fused.epoch_perm") == names.count(
        "fused.readback") == 1
    steps = [(s, e) for s, e, n in spans if n == "fused.step"]
    assert len(steps) == ROWS // BATCH
    for s0, e0 in steps:
        inside = [n for s, e, n in spans
                  if s0 <= s and e <= e0 and (s, e) != (s0, e0)]
        assert tuple(inside) == STEPS
    window, = [(s, e) for s, e, n in spans if n == "fused.window"]
    assert all(window[0] <= s and e <= window[1] for s, e in steps)
    perm, = [(s, e) for s, e, n in spans if n == "fused.epoch_perm"]
    back, = [(s, e) for s, e, n in spans if n == "fused.readback"]
    assert perm[1] <= window[0] and window[1] <= back[0]
    # the window's fold into the epoch accumulator, after its steps
    assert names.count("fused.stats") == len(steps) + 1


def test_armed_spans_leave_the_parameters_bit_equal(tel):
    nets = [_net(), _net()]
    out = [_epoch(nets[0])]
    tel.enable()
    with profile(activities=[ProfilerActivity.CPU]):
        out.append(_epoch(nets[1]))
    assert len(tel.trace_events()) > 0
    assert torch.equal(out[0][0]["loss"], out[1][0]["loss"])
    for key in out[0][1]:
        assert numpy.array_equal(out[0][1][key], out[1][1][key])
    for a, b in zip(nets[0].host_params(), nets[1].host_params()):
        for name in a:
            assert numpy.array_equal(a[name], b[name]), name


def test_span_totals_count_the_steps(tel):
    tel.enable()
    net = _net()
    _epoch(net)
    net.step(numpy.zeros((BATCH, 6, 6, 1)), numpy.zeros(BATCH, numpy.int32))
    totals = tel.span_totals()
    steps = ROWS // BATCH
    assert {name: t["count"] for name, t in totals.items()} == {
        "fused.epoch_perm": 1, "fused.window": 1, "fused.readback": 1,
        "fused.step": steps + 1, "fused.fetch": steps,
        "fused.forward": steps + 1, "fused.backward": steps + 1,
        "fused.update": steps + 1, "fused.stats": steps + 1}
    assert all(t["device_s"] is None and t["host_s"] > 0
               for t in totals.values())
    tel.reset()
    assert tel.span_totals() == {}


class _FakeEvent(object):
    """A CUDA event on a fake card that has passed every event recorded
    up to ``passed`` (in record order), and passes one when waited
    for."""

    recorded = 0
    passed = 0
    waits = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.seq = None

    def record(self):
        _FakeEvent.recorded += 1
        self.seq = _FakeEvent.recorded

    def query(self):
        return self.seq <= _FakeEvent.passed

    def synchronize(self):
        _FakeEvent.waits += 1
        _FakeEvent.passed = max(_FakeEvent.passed, self.seq)

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return 2.0   # ms


def test_device_pairs_resolve_without_a_wait(tel, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    for name in ("recorded", "passed", "waits"):
        monkeypatch.setattr(_FakeEvent, name, 0)
    monkeypatch.setattr(telemetry, "PENDING_CAPACITY", 4)
    tel.enable()
    with tel.span("fused.window"):
        for _ in range(3):
            with tel.span("fused.step", device=True):
                pass
    # the outermost span closed while the card still ran: nothing read
    assert len(telemetry._pending) == 3 and _FakeEvent.waits == 0
    _FakeEvent.passed = _FakeEvent.recorded
    with tel.span("fused.step", device=True):
        pass
    # its own pair is not passed yet; the three before it are read
    assert len(telemetry._pending) == 1 and _FakeEvent.waits == 0
    with tel.span("fused.window"):
        for _ in range(5):
            with tel.span("fused.step", device=True):
                pass
    # past the capacity the oldest pair is waited for, and only it
    assert len(telemetry._pending) == 4 and _FakeEvent.waits == 2
    totals = tel.span_totals()["fused.step"]
    assert len(telemetry._pending) == 0
    assert totals["count"] == 9
    assert totals["device_s"] == pytest.approx(9 * 2e-3)
    assert tel.span_totals()["fused.window"]["device_s"] is None


def test_device_time_by_the_span_of_its_launch_call(tmp_path):
    """``profiler.device_table``'s ``by_span``: each device event under
    the innermost ``fused.*`` span whose time holds the launch call of
    the same correlation id, a backward's launches from autograd's own
    thread included; launches outside every span are left out."""
    import json

    from znicz_tpu_torch.core import profiler

    def x(cat, name, tid, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
                "ts": ts, "dur": dur, "args": args}
    events = [
        x("cpu_op", "fused.step", 5, 0.0, 100.0),
        x("cpu_op", "fused.forward", 5, 10.0, 30.0),
        x("cpu_op", "fused.backward", 5, 40.0, 40.0),
        x("user_annotation", "bench.traced_segment", 5, 0.0, 200.0),
        x("cpu_op", "aten::mm", 5, 12.0, 20.0),
        x("cuda_runtime", "cudaLaunchKernel", 5, 20.0, 2.0, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 5, 30.0, 2.0, correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", 9, 50.0, 2.0, correlation=3),
        x("cuda_runtime", "cudaMemcpyAsync", 5, 85.0, 2.0, correlation=4),
        x("cuda_driver", "cuLaunchKernel", 5, 90.0, 2.0, correlation=5),
        x("cuda_runtime", "cudaLaunchKernel", 5, 150.0, 2.0, correlation=6),
        x("kernel", "sm80_xmma_fprop", 7, 300.0, 40.0, correlation=1),
        # correlation 2's kernel record was lost
        x("kernel", "sm80_xmma_wgrad", 7, 340.0, 60.0, correlation=3),
        x("gpu_memcpy", "Memcpy DtoH", 7, 400.0, 5.0, correlation=4),
        x("kernel", "max_pooling_offsets", 7, 405.0, 8.0, correlation=5),
        x("kernel", "vectorized_elementwise", 7, 420.0, 1.0,
          correlation=6),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    table = profiler.device_table(str(path))
    assert table["events"] == 5
    assert table["by_span"] == {
        "fused.backward": {"count": 1, "ms": 0.06},
        "fused.forward": {"count": 1, "ms": 0.04},
        "fused.step": {"count": 2, "ms": 0.013}}
    assert list(table["by_span"]) == ["fused.backward", "fused.forward",
                                      "fused.step"]
