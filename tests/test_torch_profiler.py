"""The port's performance introspection (``znicz_tpu_torch/core/profiler.py``)
held against ``znicz_tpu/core/profiler.py``, case by case after
``tests/unit/test_profiler.py``:

* the disabled path does no work (no profiler state, no ledger call
  from ``memory.Array``), and the disabled summaries are safe;
* the cost registry: a counted matrix product registers exactly the
  FLOPs and bytes the JAX package's XLA cost analysis gives (2mnk,
  each operand read and the result written once: tolerance 0), dedup
  and the agreement band, a disagreement outside it; ``FusedNet.step``
  on JAX's 784-256-10 MLP: the port's count (matrix products only, no
  elementwise work) within [0.85, 1.0] of JAX's ``fused.step`` entry,
  its analytic ratio inside JAX's 0.4-1.6, and the counted step
  bit-equal to an uncounted one; a K-step window counts K steps;
* the ledger: balance and high water, an unmatched free, leak
  detection, the steady state and a snapshot-reload cycle give the same
  summaries as the JAX package's for the same sequence (exact);
* the breakdown: the parts sum to wall (within 5e-6 s, the summary's
  rounding), each verdict equals JAX's on the same parts, and
  ``note_gd_step``;
* ``export_report`` rendered by ``tools/profile_summary.py --roofline``
  and ``--ledger`` in a subprocess; the device table of a Chrome trace.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
import types

import numpy
import pytest
import torch

from znicz_tpu.core import profiler as jax_profiler
from znicz_tpu.core import telemetry as jax_telemetry
from znicz_tpu_torch.core import profiler, telemetry
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP = [{"type": "all2all_tanh", "->": {"output_sample_shape": 256}},
       {"type": "softmax", "->": {"output_sample_shape": 10}}]


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (profiler, telemetry, jax_profiler, jax_telemetry):
        mod.reset()
    yield
    for prof in (profiler, jax_profiler):
        prof.reset()
        prof.disable()
    telemetry.reset()
    jax_telemetry.reset()


def _boom(*args, **kwargs):
    raise AssertionError("profiler state touched while disabled")


def _cpu_array(value, name):
    a = Array(value, name=name)
    a.device = torch.device("cpu")
    return a


# -- the disabled path --------------------------------------------------------

def test_disabled_path_does_no_work(monkeypatch):
    profiler.disable()
    telemetry.enable()
    monkeypatch.setattr(profiler, "_prof", _boom)
    assert profiler.window_probe() is None
    assert profiler.register_cost("x", 1, 1) is None
    with profiler.count_cost("x") as count:
        assert count is None
    assert profiler.note_data_wait(0.1) is None
    assert profiler.note_gd_step(object(), time.perf_counter()) is None
    assert profiler.epoch_check(3) is None
    assert profiler.ledger_swap("a", 0, 128) is None
    profiler.kernel_cost("k", 1, 1)
    monkeypatch.setattr(profiler, "ledger_swap", _boom)
    a = _cpu_array(numpy.zeros(4, numpy.float32), "a")
    a.dev
    a.set_dev(a.dev)
    a.reset()
    assert profiler._state is None
    snap = telemetry.snapshot()
    assert not any(k.startswith("profiler.")
                   for k in list(snap["gauges"]) + list(snap["counters"]))
    assert profiler.cost_registry() == []
    assert profiler.breakdown_summary() is None


def test_disabled_summaries_are_safe():
    profiler.disable()
    jax_profiler.disable()
    assert profiler.ledger_summary() == jax_profiler.ledger_summary()
    snap, jax_snap = profiler.snapshot(), jax_profiler.snapshot()
    assert set(jax_snap) <= set(snap)
    for key in ("enabled", "cost_registry", "ledger", "breakdown",
                "leak_suspects"):
        assert snap[key] == jax_snap[key]
    assert snap["device_memory"] == {"cpu": None}
    assert snap["device_ops"] is None


# -- pillar 1: the cost registry ----------------------------------------------

M, N, K = 64, 128, 32


def _operands():
    rng = numpy.random.RandomState(7)
    return (rng.rand(M, N).astype(numpy.float32),
            rng.rand(N, K).astype(numpy.float32))


def _jax_matmul_entry(name, analytic):
    import jax
    a, b = _operands()
    jax_profiler.enable()
    return jax_profiler.register_jit_cost(name, jax.jit(lambda x, y: x @ y),
                                          (a, b), analytic_flops=analytic)


def _counted_matmul(name, analytic, calls):
    a, b = (torch.from_numpy(x) for x in _operands())
    profiler.enable()
    with profiler.count_cost(name, analytic_flops=analytic):
        calls.append(1)
        out = a @ b
    return out


def test_cost_registry_register_lookup_crosscheck():
    analytic = 2.0 * M * N * K
    calls = []
    out = _counted_matmul("unit.matmul", analytic, calls)
    e = profiler.cost_entry("unit.matmul")
    want = _jax_matmul_entry("unit.matmul", analytic)
    assert calls == [1]      # the dispatch itself, no extra run
    for key in ("flops", "bytes_accessed", "operational_intensity",
                "flops_ratio_measured_vs_analytic", "agreement",
                "analytic_flops"):
        assert e[key] == want[key], key
    assert e["flops"] == analytic
    # the counted product is the uncounted one, bit for bit
    a, b = (torch.from_numpy(x) for x in _operands())
    assert torch.equal(out, a @ b)
    # lookup and dedup: the same name is not counted again
    assert profiler.cost_entry("unit.matmul") is e
    with profiler.count_cost("unit.matmul") as count:
        assert count is None
    assert profiler.register_cost("unit.matmul", 0, 0) is e
    assert [x["name"] for x in profiler.cost_registry()] == ["unit.matmul"]
    rep = profiler.cost_report()
    assert rep["compared"] == 1 and rep["agree"] is True


def test_cost_disagreement_outside_band():
    analytic = 2.0 * M * N * K * 10
    _counted_matmul("unit.off", analytic, [])
    want = _jax_matmul_entry("unit.off", analytic)
    assert profiler.cost_entry("unit.off")["agreement"] is False
    assert want["agreement"] is False
    assert profiler.cost_report()["agree"] is False


def test_a_raising_dispatch_registers_nothing():
    profiler.enable()
    with pytest.raises(ValueError):
        with profiler.count_cost("unit.raises"):
            raise ValueError("dispatch failed")
    assert profiler.cost_entry("unit.raises") is None
    assert profiler._running == 0


def test_kernel_cost_reaches_only_a_counted_dispatch():
    """A ctypes launch is invisible to the dispatch modes: its wrapper's
    report is added to the dispatch being counted, and to nothing
    else."""
    profiler.enable()
    profiler.kernel_cost("max_pooling_offsets", 100, 1000)   # no count
    with profiler.count_cost("unit.kernel"):
        profiler.kernel_cost("max_pooling_offsets", 100, 1000)
        profiler.kernel_cost("max_pooling_offsets_backward", 10, 200)
    e = profiler.cost_entry("unit.kernel")
    assert e["flops"] == 110 and e["bytes_accessed"] == 1200
    assert e["meta"]["kernel_launches"] == {
        "max_pooling_offsets": 1, "max_pooling_offsets_backward": 1}


class _Reporting(torch.autograd.Function):
    """A stand-in for a kernel wrapper inside an autograd Function:
    forward and backward each report a launch, as the pooling kernels'
    wrappers do (on the card the backward runs in autograd's device
    thread)."""

    @staticmethod
    def forward(ctx, x):
        profiler.kernel_cost("max_pooling_offsets", 7, 70)
        return x * 2

    @staticmethod
    def backward(ctx, grad):
        profiler.kernel_cost("max_pooling_offsets_backward", 5, 50)
        return grad * 2


def test_kernel_cost_of_a_backward_reaches_its_step():
    profiler.enable()
    x = torch.ones(4, requires_grad=True)
    with profiler.count_cost("unit.step"):
        g, = torch.autograd.grad(_Reporting.apply(x).sum(), [x])
    e = profiler.cost_entry("unit.step")
    assert e["meta"]["kernel_launches"] == {
        "max_pooling_offsets": 1, "max_pooling_offsets_backward": 1}
    assert torch.equal(g, torch.full((4,), 2.0))


def test_a_count_inside_a_count_is_not_taken():
    profiler.enable()
    with profiler.count_cost("unit.outer") as outer:
        with profiler.count_cost("unit.inner") as inner:
            profiler.kernel_cost("max_pooling_offsets", 1, 10)
    assert outer is not None and inner is None
    assert profiler.cost_entry("unit.inner") is None
    assert profiler.cost_entry("unit.outer")["bytes_accessed"] == 10


@pytest.mark.parametrize("shape", [(128, 55, 55, 96), (128, 13, 13, 256)])
def test_kernel_work_is_the_bound_s(shape):
    """The wrappers report the work chip_smoke.py's bounds count: the
    forward reads the input and writes values and int32 offsets and
    compares 9 cells a window; the backward reads err and offsets,
    writes the input gradient and adds once more a window."""
    b, h, w, c = shape
    ny, nx = (h - 3 + 1) // 2 + 1, (w - 3 + 1) // 2 + 1
    n_in, n_out = b * h * w * c, b * ny * nx * c
    assert cuda_pooling.work(n_in, n_out, 4, 3, 3) == \
        (n_out * 9, n_in * 4 + n_out * 8)
    assert cuda_pooling_backward.work(n_in, n_out, 4, 3, 3) == \
        (n_out * 10, n_out * 8 + n_in * 4)


def _mlp_batch():
    rng = numpy.random.RandomState(0)
    return (rng.rand(32, 784).astype(numpy.float32),
            (numpy.arange(32) % 10).astype(numpy.int32))


def test_fused_net_step_registers_cost_within_tolerance():
    from znicz_tpu.parallel import fused as jax_fused
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.parallel import fused
    x, labels = _mlp_batch()
    jax_profiler.enable()
    jax_fused.FusedNet(MLP, 784).step(x, labels)
    want = jax_profiler.cost_entry("fused.step")
    profiler.enable()
    counted = fused.FusedNet(MLP, 784, device="cpu",
                             rand=prng.RandomGenerator().seed(3))
    plain = fused.FusedNet(MLP, 784, device="cpu",
                           rand=prng.RandomGenerator().seed(3))
    m_counted = counted.step(x, labels)
    e = profiler.cost_entry("fused.step")
    assert e is not None and e["flops"] > 0 and e["bytes_accessed"] > 0
    # the port counts the products (forward, both backward products of
    # the second layer, the first layer's weight gradient); XLA adds the
    # elementwise work of the activations and the update
    assert 0.85 <= e["flops"] / want["flops"] <= 1.0
    assert 0.4 < e["flops_ratio_measured_vs_analytic"] < 1.6
    assert 0.4 < want["flops_ratio_measured_vs_analytic"] < 1.6
    assert e["analytic_flops"] == want["analytic_flops"]
    assert e["meta"] == want["meta"]
    # the counted step is the uncounted one, bit for bit
    profiler.disable()
    m_plain = plain.step(x, labels)
    for k in ("loss", "output", "max_idx"):
        assert torch.equal(m_counted[k], m_plain[k])
    for pa, pb in zip(counted.params, plain.params):
        for k in pa:
            assert torch.equal(pa[k], pb[k])


def test_window_counts_all_its_steps():
    """The known difference: the port's window is a loop of K steps,
    counted whole, where XLA counts a scan's body once and the JAX
    package scales it by K."""
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.parallel import fused
    x, labels = _mlp_batch()
    profiler.enable()
    net = fused.FusedNet(MLP, 784, device="cpu",
                         rand=prng.RandomGenerator().seed(3))
    net.step(x, labels)
    xs = numpy.stack([x] * 3)
    ls = numpy.stack([labels] * 3)
    net.run_window(xs, ls, [32] * 3, fused.stack_hypers(net.hypers, 3))
    step = profiler.cost_entry("fused.step")
    win = profiler.cost_entry("fused.window.stacked.k3")
    # three steps, and three folds of the evaluator's stats (its
    # confusion-matrix product: 2 x 32 x 10 x 10 a step)
    assert win["flops"] == 3 * step["flops"] + 3 * 2 * 32 * 10 * 10
    assert win["meta"]["steps"] == 3
    assert win["analytic_flops"] == 3 * step["analytic_flops"]
    assert "scan_scaled" not in win


# -- pillar 2: the device-memory ledger ---------------------------------------

def _ledger_sequence(prof, make, zeros):
    """The JAX test's balance / high-water sequence on ``make(value,
    name)`` Arrays, ``zeros(n)`` a device write of n float32 zeros;
    returns the ledger summaries after each step."""
    prof.enable()
    out = []
    a = make(numpy.zeros((100,), numpy.float32), "acts")
    w = make(numpy.zeros((50,), numpy.float32), "weights")
    a.dev
    w.dev
    out.append(prof.ledger_summary())
    a.set_dev(zeros(200))
    out.append(prof.ledger_summary())
    a.reset()
    out.append(prof.ledger_summary())
    w.reset()
    out.append(prof.ledger_summary())
    return out


def test_ledger_balance_attribution_high_water():
    import jax.numpy as jnp
    from znicz_tpu.core.memory import Array as JaxArray
    got = _ledger_sequence(profiler, _cpu_array,
                           lambda n: torch.zeros(n, dtype=torch.float32))
    want = _ledger_sequence(jax_profiler, JaxArray,
                            lambda n: jnp.zeros((n,), jnp.float32))
    assert got == want
    assert got[0]["by_name"] == {"acts": 400, "weights": 200}
    assert got[1]["live_bytes"] == 1000 == got[1]["high_water_bytes"]
    assert got[3]["live_bytes"] == 0 and got[3]["high_water_bytes"] == 1000
    assert got[3]["balanced"]


def test_ledger_across_snapshot_reload_cycle():
    profiler.enable()
    arrays = {name: _cpu_array(numpy.full((64,), i, numpy.float32), name)
              for i, name in enumerate(("w0", "w1"))}
    for arr in arrays.values():
        arr.dev
    led0 = profiler.ledger_summary()
    assert led0["live_bytes"] == 512 and led0["balanced"]
    state = {n: numpy.array(arr.mem) for n, arr in arrays.items()}
    assert profiler.ledger_summary()["live_bytes"] == 512
    for arr in arrays.values():
        arr.reset()
    assert profiler.ledger_summary()["live_bytes"] == 0
    restored = {n: _cpu_array(v, n) for n, v in state.items()}
    for arr in restored.values():
        arr.dev
    led1 = profiler.ledger_summary()
    assert led1["live_bytes"] == 512 and led1["balanced"]
    assert led1["by_name"] == led0["by_name"]
    assert led1["high_water_bytes"] == 512
    assert (restored["w1"].mem == 1.0).all()


def _leak_sequence(prof):
    prof.enable(leak_epochs=2, leak_min_bytes=1024)
    out = []
    for i in range(3):
        prof.ledger_swap("grow%d" % i, 0, 2048)
        out.append(prof.epoch_check(i + 1))
    out.append(prof.epoch_check(4))
    return out


def test_ledger_leak_detection():
    telemetry.enable()
    jax_telemetry.enable()
    got = _leak_sequence(profiler)
    assert got == _leak_sequence(jax_profiler)
    assert got[:2] == [None, None] and got[3] is None
    assert got[2]["grown_bytes"] == 4096 and got[2]["epoch"] == 3
    assert telemetry.counter("profiler.leak_suspects").value == 1
    assert "profiler.leak_suspect" in [
        ev["kind"] for ev in telemetry.journal_events()]


def _unmatched_sequence(prof):
    prof.enable()
    prof.ledger_swap("seen", 0, 256)
    first = prof.ledger_summary()["balanced"]
    prof.ledger_swap("ghost", 4096, 0)
    return first, prof.ledger_summary()


def test_ledger_unmatched_free_breaks_balance():
    got = _unmatched_sequence(profiler)
    assert got == _unmatched_sequence(jax_profiler)
    assert got[0] is True and got[1]["balanced"] is False
    assert got[1]["clamped_frees"] == 1 and got[1]["live_bytes"] == 256


def _steady_sequence(prof):
    prof.enable(leak_epochs=2, leak_min_bytes=1)
    prof.ledger_swap("buf", 0, 4096)
    return [prof.epoch_check(epoch) for epoch in range(1, 6)]


def test_ledger_no_leak_on_steady_state():
    assert _steady_sequence(profiler) == _steady_sequence(jax_profiler) \
        == [None] * 5


def test_sample_device_memory_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiler.sample_device_memory() == {"cpu": None}


# -- pillar 3: the step-time breakdown ---------------------------------------

def test_breakdown_parts_sum_to_wall():
    profiler.enable()
    probe = profiler.window_probe()
    time.sleep(0.02)
    profiler.note_data_wait(0.005)
    probe.collected()
    time.sleep(0.01)
    probe.dispatched({"out": torch.zeros(3)})
    time.sleep(0.005)
    probe.done(steps=4)
    assert probe.done(steps=4) is None      # idempotent
    bd = profiler.breakdown_summary()
    assert bd["steps"] == 4 and bd["windows"] == 1
    total = sum(bd["parts_seconds"].values())
    assert abs(total - bd["wall_seconds"]) <= 5e-6
    assert bd["parts_seconds"]["data_wait"] == pytest.approx(0.005)
    assert bd["verdict"] in profiler.VERDICTS
    assert profiler._state.probes_active == 0


@pytest.mark.parametrize("parts,wall", [
    ({"data_wait": 1.0}, 1.0),
    ({"device": 1.0, "dispatch": 0.1}, 1.1),
    ({"dispatch": 0.6, "readback": 0.5, "device": 0.1}, 1.2),
    ({"data_wait": 0.3, "host_collect": 0.3, "device": 0.3}, 0.9),
    ({"device": 0.5, "dispatch": 0.25, "readback": 0.25}, 1.0),
])
def test_breakdown_verdicts(parts, wall):
    """Each verdict (and the whole summary) equals JAX's on the same
    parts."""
    for prof in (profiler, jax_profiler):
        prof.enable()
        prof._add_parts(parts, wall=wall, steps=1)
    assert profiler.breakdown_summary() == jax_profiler.breakdown_summary()
    assert profiler.PARTS == jax_profiler.PARTS
    assert profiler.VERDICTS == jax_profiler.VERDICTS


def test_standalone_data_wait_is_input_bound():
    for prof in (profiler, jax_profiler):
        prof.enable()
        prof.note_data_wait(1.0)
    assert profiler.breakdown_summary() == jax_profiler.breakdown_summary()
    assert profiler.breakdown_summary()["verdict"] == "input-bound"


def test_note_gd_step_records_dispatch_and_device():
    profiler.enable()
    w = _cpu_array(numpy.zeros((8,), numpy.float32), "w")
    w.dev
    unit = types.SimpleNamespace(weights=w, bias=None)
    t0 = time.perf_counter() - 0.01
    assert profiler.note_gd_step(unit, t0) is True
    bd = profiler.breakdown_summary()
    assert bd["steps"] == 1 and bd["parts_seconds"]["dispatch"] >= 0.01
    total = sum(bd["parts_seconds"].values())
    assert abs(total - bd["wall_seconds"]) <= 5e-6


# -- reports, the device table -----------------------------------------------

def test_export_report_and_summary_modes(tmp_path):
    analytic = 2.0 * M * N * K
    _counted_matmul("unit.matmul", analytic, [])
    profiler.ledger_swap("w", 0, 1024)
    profiler.note_data_wait(0.01)
    path = profiler.export_report(str(tmp_path / "report.json"))
    with open(path) as f:
        doc = json.load(f)
    assert set(jax_profiler.snapshot()) <= set(doc)
    tool = os.path.join(REPO, "tools", "profile_summary.py")
    roof = subprocess.run([sys.executable, tool, "--roofline", path],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    assert "unit.matmul" in roof and "1.000" in roof
    led = subprocess.run([sys.executable, tool, "--ledger", path],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert "balanced=True" in led and "`w`" in led


def test_device_table_of_a_chrome_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "dur": 80.0,
         "name": "void max_pooling_offsets_kernel<float, 4, true>(...)"},
        {"ph": "X", "cat": "kernel", "dur": 70.0,
         "name": "void max_pooling_offsets_kernel<float, 4, true>(...)"},
        {"ph": "X", "cat": "kernel", "dur": 90.0,
         "name": "void max_pooling_backward_kernel<float, 4, 2>(...)"},
        {"ph": "X", "cat": "kernel", "dur": 500.0,
         "name": "sm90_xmma_fprop_implicit_gemm_f32f32_tf32"},
        {"ph": "X", "cat": "gpu_memcpy", "dur": 10.0,
         "name": "Memcpy HtoD (Pinned -> Device)"},
        {"ph": "X", "cat": "cpu_op", "dur": 999.0, "name": "aten::conv2d"},
        {"ph": "i", "cat": "kernel", "name": "not a span"},
    ]
    path = str(tmp_path / "trace.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    table = profiler.device_table(path)
    assert table["events"] == 5 and table["total_ms"] == pytest.approx(0.75)
    assert table["by_name"][0]["category"] == "convolution"
    assert profiler.kernel_events(table, "max_pooling_offsets_kernel") == \
        (2, pytest.approx(0.15))
    assert profiler.kernel_events(table, "max_pooling_backward_kernel") \
        == (1, pytest.approx(0.09))
    assert table["by_category"]["pooling"] == pytest.approx(0.24)
    assert table["by_category"]["copy-transpose"] == pytest.approx(0.01)


def test_one_capture_at_a_time(tmp_path):
    """Kineto cannot nest two profilers: a second capture raises, and
    the guard is free again after the first."""
    with profiler.traced(str(tmp_path / "a"), cuda=False) as result:
        torch.ones(4).add_(1.0)
        with pytest.raises(RuntimeError, match="already running"):
            with profiler.traced(str(tmp_path / "b"), cuda=False):
                pass
    assert os.path.exists(result["trace"])
    assert result["device_ops"]["events"] == 0
    with profiler.traced(str(tmp_path / "c"), cuda=False):
        pass


def test_a_card_capture_with_no_device_event_raises(tmp_path, monkeypatch):
    """A capture on the card whose trace holds no device event raises
    ``EmptyDeviceTrace`` (a ``RuntimeError``), so a caller can tell it
    from other faults and take the trace again; the guard is free after
    it.  Here the card is stood in for by the CPU: its small op and its
    synchronize run on the CPU, and the trace holds no device event."""
    class _Cuda(object):
        @staticmethod
        def synchronize():
            pass

    class _Torch(object):
        cuda = _Cuda()

        @staticmethod
        def ones(n, device=None):
            return torch.ones(n)

    monkeypatch.setattr(profiler, "torch", _Torch())
    with pytest.raises(profiler.EmptyDeviceTrace,
                       match="holds no device event"):
        with profiler.traced(str(tmp_path / "a"), cuda=True):
            torch.ones(4).add_(1.0)
    assert issubclass(profiler.EmptyDeviceTrace, RuntimeError)
    assert os.path.exists(str(tmp_path / "a" / "trace.json"))
    with profiler.traced(str(tmp_path / "b"), cuda=False) as result:
        pass
    assert result["device_ops"]["events"] == 0


def test_family_trace_is_taken_again_when_empty(tmp_path, monkeypatch):
    """``chip_smoke.py``'s family trace takes an epoch's trace again
    when CUPTI recorded no device event, up to FAMILY_TRACE_ATTEMPTS
    traces; with none, its numbers are None and its line says they were
    not measured, while a trace that holds events gives them."""
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "FAMILIES_DIR", str(tmp_path))
    said, runs, empty = [], [], [2]
    monkeypatch.setattr(chip_smoke, "say", said.append)
    table = {"events": 3, "total_ms": 0.6, "by_name": [
        {"name": "k", "count": 2}, {"name": "Memcpy HtoD", "count": 1}]}

    @contextlib.contextmanager
    def traced(directory):
        res = {}
        yield res
        if empty[0]:
            empty[0] -= 1
            raise profiler.EmptyDeviceTrace("no device event in " + directory)
        res["device_ops"] = table

    monkeypatch.setattr(profiler, "traced", traced)
    got = chip_smoke._family_trace(torch, "f", lambda: runs.append(1), 2)
    assert got == {"kernels": 1.0, "copies": 0.5,
                   "device_ms": pytest.approx(0.3)}
    assert len(runs) == 3 and len(said) == 2
    assert "trace 2 of %d" % chip_smoke.FAMILY_TRACE_ATTEMPTS in said[1]
    empty[0], runs[:], said[:] = 99, [], []
    got = chip_smoke._family_trace(torch, "f", lambda: runs.append(1), 2)
    assert got == {"kernels": None, "copies": None, "device_ms": None}
    assert len(runs) == chip_smoke.FAMILY_TRACE_ATTEMPTS
    row = chip_smoke._family_row("f", 1.0, 2, got, 1.0, "card")
    assert row["busy"] is None and "not measured" in said[-1]
