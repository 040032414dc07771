"""The port's metric time-series (``znicz_tpu_torch/core/timeseries.py``)
held against ``znicz_tpu/core/timeseries.py``, case by case after
``tests/unit/test_timeseries.py``: the same counters, gauges and
histograms sampled at the same injected clocks give the same rings,
``rate``, ``windowed_delta``, ``snapshot`` and ``merge_snapshots`` in
both packages, exactly (the arithmetic is the same Python on the same
floats: tolerance 0), and the hand-computed values of the JAX tests.
No test sleeps.
"""

import types

import pytest

from znicz_tpu.core import telemetry as jax_telemetry
from znicz_tpu.core import timeseries as jax_timeseries
from znicz_tpu.core.config import root as jax_root
from znicz_tpu_torch.core import telemetry, timeseries
from znicz_tpu_torch.core.config import root

PKGS = {
    "jax": types.SimpleNamespace(ts=jax_timeseries, tel=jax_telemetry,
                                 root=jax_root),
    "torch": types.SimpleNamespace(ts=timeseries, tel=telemetry,
                                   root=root),
}
KNOBS = ("enabled", "interval_ms", "capacity", "prefixes")


@pytest.fixture
def both():
    """Telemetry and the time-series on in both packages, with clean
    registries; the knobs restored after."""
    saved = {name: ({k: p.root.common.telemetry.timeseries.get(k)
                     for k in KNOBS}, p.root.common.telemetry.get("enabled"))
             for name, p in PKGS.items()}
    for p in PKGS.values():
        p.root.common.telemetry.enabled = True
        p.root.common.telemetry.timeseries.enabled = True
        p.tel.reset()
        p.ts.reset()
    yield PKGS
    for name, p in PKGS.items():
        p.ts.reset()
        p.tel.reset()
        knobs, tel_on = saved[name]
        for k, v in knobs.items():
            setattr(p.root.common.telemetry.timeseries, k, v)
        p.root.common.telemetry.enabled = tel_on


def run_both(both, fn):
    """``fn(pkg)`` on each package; the two results, JAX's first."""
    return fn(both["jax"]), fn(both["torch"])


def test_disabled_sampler_touches_nothing(monkeypatch):
    root.common.telemetry.timeseries.enabled = False

    def boom(*a, **k):
        raise AssertionError("disabled sampler touched telemetry")

    monkeypatch.setattr(telemetry, "snapshot", boom)
    assert timeseries.sample_once() == 0
    assert timeseries.maybe_start() is False
    assert timeseries.series_names() == []
    assert timeseries._thread is None


def test_sample_records_counters_gauges_and_quantiles(both):
    def drive(p):
        p.tel.counter("serving.batches").inc(3)
        p.tel.gauge("serving.queue_depth").set(7)
        for v in (0.01, 0.02, 0.03):
            p.tel.histogram("serving.request_seconds").observe(v)
        touched = p.ts.sample_once(now=100.0)
        return touched, {n: p.ts.points(n) for n in p.ts.series_names()}
    want, got = run_both(both, drive)
    assert got == want
    assert got[1]["serving.batches"] == [(100.0, 3.0)]
    assert got[1]["serving.queue_depth"] == [(100.0, 7.0)]
    assert len(got[1]["serving.request_seconds.p99"]) == 1


def test_prefix_filter_is_curated(both):
    def drive(p):
        p.root.common.telemetry.timeseries.prefixes = "serving"
        p.tel.counter("serving.batches").inc()
        p.tel.counter("workflow.runs").inc()
        p.ts.sample_once(now=50.0)
        return p.ts.points("serving.batches"), p.ts.points("workflow.runs")
    want, got = run_both(both, drive)
    assert got == want and got[0] and got[1] == []


def test_default_prefixes_name_the_port_families():
    """The known difference: the port samples its own counter
    families, where the JAX package names a ``jax`` one."""
    prefixes = timeseries._prefixes()
    assert "jax" not in prefixes
    for fam in ("serving", "loader", "pyprof", "profiler", "faults",
                "health", "launcher"):
        assert fam in prefixes


def test_ring_capacity_bounds_points(both):
    def drive(p):
        p.root.common.telemetry.timeseries.capacity = 4
        c = p.tel.counter("serving.batches")
        for i in range(10):
            c.inc()
            p.ts.sample_once(now=100.0 + i)
        return p.ts.points("serving.batches")
    want, got = run_both(both, drive)
    assert got == want
    assert [t for t, _ in got] == [106.0, 107.0, 108.0, 109.0]


def test_rate_and_delta_hand_computed(both):
    def drive(p):
        c = p.tel.counter("serving.batches")
        c.inc(10)
        p.ts.sample_once(now=100.0)
        c.inc(30)
        p.ts.sample_once(now=104.0)
        return (p.ts.rate("serving.batches"),
                p.ts.windowed_delta("serving.batches"))
    want, got = run_both(both, drive)
    assert got == want == (7.5, 30.0)


def test_rate_honors_the_trailing_window(both):
    def drive(p):
        c = p.tel.counter("serving.batches")
        total = 0
        for t, v in ((100.0, 0), (110.0, 100), (112.0, 120),
                     (114.0, 140)):
            c.inc(v - total)
            total = v
            p.ts.sample_once(now=t)
        return (p.ts.rate("serving.batches"),
                p.ts.rate("serving.batches", window_s=5.0),
                p.ts.rate("serving.batches", window_s=3.0),
                p.ts.windowed_delta("serving.batches", window_s=3.0),
                p.ts.rate("serving.batches", window_s=3.0, now=120.0))
    want, got = run_both(both, drive)
    assert got == want
    assert got[:4] == (10.0, 10.0, 10.0, 20.0)


def test_rate_needs_two_points(both):
    def drive(p):
        p.tel.counter("serving.batches").inc()
        p.ts.sample_once(now=100.0)
        return (p.ts.rate("serving.batches"),
                p.ts.windowed_delta("serving.batches"),
                p.ts.rate("serving.never_sampled"))
    want, got = run_both(both, drive)
    assert got == want == (None, None, None)


def test_snapshot_payload_shape(both):
    def drive(p):
        c = p.tel.counter("serving.batches")
        c.inc(4)
        p.ts.sample_once(now=100.0)
        c.inc(4)
        p.ts.sample_once(now=102.0)
        p.tel.gauge("serving.inflight").set(1)
        p.ts.sample_once(now=103.0)
        snap = p.ts.snapshot()
        return {k: snap[k] for k in ("enabled", "sweeps", "series",
                                     "rates")}
    want, got = run_both(both, drive)
    assert got == want
    assert got["sweeps"] == 3
    assert got["series"]["serving.batches"]["points"][-1] == [103.0, 8.0]
    assert got["rates"]["serving.batches"] == pytest.approx(4 / 3.0)
    assert "serving.inflight" not in got["rates"]


def test_sampler_thread_lifecycle(both):
    """maybe_start is idempotent, its thread is named for the Python
    sampler's registry, and stop() retires it; the rings survive."""
    root.common.telemetry.timeseries.interval_ms = 5.0
    assert timeseries.maybe_start() is True
    assert timeseries.maybe_start() is True
    assert timeseries._thread.name == "znicz:timeseries"
    telemetry.counter("serving.batches").inc()
    timeseries.stop()
    timeseries.sample_once(now=500.0)
    assert timeseries.points("serving.batches")


def test_sweeps_meter_on_telemetry(both):
    def drive(p):
        p.tel.counter("serving.batches").inc()
        p.ts.sample_once(now=1.0)
        p.ts.sample_once(now=2.0)
        snap = p.tel.snapshot()
        return (snap["counters"]["timeseries.sweeps"],
                snap["gauges"]["timeseries.series"])
    want, got = run_both(both, drive)
    assert got == want and got[0] == 2


@pytest.mark.parametrize("sources,use_max,want", [
    ({"a": [(1.0, 10.0), (3.0, 20.0)], "b": [(2.0, 5.0)]}, False,
     [(1.0, 10.0), (2.0, 15.0), (3.0, 25.0)]),
    ({"a": [(1.0, 10.0), (3.0, 2.0)], "b": [(2.0, 5.0)]}, True,
     [(1.0, 10.0), (2.0, 10.0), (3.0, 5.0)]),
    ({"a": [(1.0, 100.0), (4.0, 120.0)], "b": [(3.0, 10.0)]}, False,
     [(1.0, 100.0), (3.0, 110.0), (4.0, 130.0)]),
])
def test_step_merge(sources, use_max, want):
    got = timeseries._step_merge(sources, use_max=use_max)
    assert got == jax_timeseries._step_merge(sources, use_max=use_max)
    assert got == want


def _snap(series, sweeps=1, enabled=True, interval=100.0):
    return {"enabled": enabled, "sweeps": sweeps,
            "interval_ms": interval, "series": series, "rates": {}}


def test_merge_snapshots_counters_and_quantiles():
    payloads = {
        "r1": _snap({"serving.batches": {
            "kind": "counter", "points": [[1.0, 10.0], [3.0, 20.0]]},
            "serving.request_seconds.p99": {
                "kind": "quantile", "points": [[1.0, 0.030]]}}, sweeps=2),
        "r2": _snap({"serving.batches": {
            "kind": "counter", "points": [[2.0, 5.0]]},
            "serving.request_seconds.p99": {
                "kind": "quantile", "points": [[1.0, 0.050]]}}),
        "router": _snap({"router.requests": {
            "kind": "counter", "points": [[1.0, 1.0], [3.0, 9.0]]}},
            enabled=False),
    }
    for window_s in (None, 1.5):
        got = timeseries.merge_snapshots(payloads, window_s=window_s)
        assert got == jax_timeseries.merge_snapshots(payloads,
                                                     window_s=window_s)
    got = timeseries.merge_snapshots(payloads)
    assert got["sources"] == ["r1", "r2", "router"] and got["sweeps"] == 4
    batches = got["series"]["serving.batches"]
    assert batches["points"] == [[1.0, 10.0], [2.0, 15.0], [3.0, 25.0]]
    assert batches["sources"] == {"r1": 20.0, "r2": 5.0}
    assert got["rates"]["serving.batches"] == pytest.approx(7.5)
    assert got["series"]["serving.request_seconds.p99"]["points"] == \
        [[1.0, 0.050]]


def test_checkpoint_sink_and_last_points(both):
    """The blackbox's hooks: the sink sees every sweep's count and
    clock, a raising sink never fails the sampler, and last_points is
    each ring's frontier; the same in both packages."""
    def drive(p):
        calls = []
        p.ts.set_checkpoint_sink(lambda sweeps, now: calls.append(
            (sweeps, now)))
        try:
            c = p.tel.counter("serving.batches")
            c.inc(2)
            p.ts.sample_once(now=10.0)
            c.inc(3)
            p.ts.sample_once(now=11.0)
            p.ts.set_checkpoint_sink(lambda *a: 1 / 0)
            p.ts.sample_once(now=12.0)
        finally:
            p.ts.set_checkpoint_sink(None)
        return calls, p.ts.last_points()
    want, got = run_both(both, drive)
    assert got == want
    assert got[0] == [(1, 10.0), (2, 11.0)]
    assert got[1]["serving.batches"] == {"kind": "counter", "t": 12.0,
                                         "v": 5.0}
