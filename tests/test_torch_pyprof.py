"""The port's Python sampling profiler (``znicz_tpu_torch/core/pyprof.py``)
held against ``znicz_tpu/core/pyprof.py``, case by case after
``tests/unit/test_pyprof.py``: the same injected frames, thread names,
clocks and probe delays give the same ``classify`` phases,
``sample_once`` aggregates, GIL accounting, ``diff_snapshots``,
``merge_profiles``, ``collapsed`` and ``speedscope`` output in both
packages, exactly (tolerance 0: the same Python on the same numbers),
except where the port classifies its own dispatch frames (the known
difference: ``torch`` frames and the kernels' ctypes launches are its
``device_dispatch``, where the JAX package's are ``jax`` ones).  No
test sleeps over a second.
"""

import os
import threading
import time
import types

import pytest

from znicz_tpu.core import pyprof as jax_pyprof
from znicz_tpu.core import telemetry as jax_telemetry
from znicz_tpu.core.config import root as jax_root
from znicz_tpu_torch.core import pyprof, telemetry
from znicz_tpu_torch.core.config import root

PKGS = {
    "jax": types.SimpleNamespace(pp=jax_pyprof, tel=jax_telemetry,
                                 root=jax_root),
    "torch": types.SimpleNamespace(pp=pyprof, tel=telemetry, root=root),
}
KNOBS = ("enabled", "hz", "capacity", "max_depth", "gil_probe",
         "gil_interval_ms", "gil_calib_probes", "capture_seconds_cap")


@pytest.fixture
def both():
    saved = {name: ({k: p.root.common.profiler.pyprof.get(k)
                     for k in KNOBS}, p.root.common.telemetry.get("enabled"))
             for name, p in PKGS.items()}
    for p in PKGS.values():
        p.root.common.telemetry.enabled = True
        p.tel.reset()
        p.pp.reset()
        p.root.common.profiler.pyprof.enabled = True
    yield PKGS
    for name, p in PKGS.items():
        p.pp.reset()
        p.tel.reset()
        knobs, tel_on = saved[name]
        for k, v in knobs.items():
            setattr(p.root.common.profiler.pyprof, k, v)
        p.root.common.telemetry.enabled = tel_on


def run_both(both, fn):
    return fn(both["jax"]), fn(both["torch"])


class _Code(object):
    def __init__(self, filename, name):
        self.co_filename = filename
        self.co_name = name


class _Frame(object):
    def __init__(self, code, back=None):
        self.f_code = code
        self.f_back = back


def chain(*pairs):
    """Root-first ``(filename, funcname)`` pairs -> the leaf frame."""
    f = None
    for filename, funcname in pairs:
        f = _Frame(_Code(filename, funcname), back=f)
    return f


def _without_timing(snap):
    """A snapshot without the wall-clock fields (uptime differs between
    two runs by construction)."""
    out = dict(snap)
    out.pop("overhead", None)
    return out


def test_disabled_profiler_touches_nothing(monkeypatch):
    root.common.profiler.pyprof.enabled = False

    def boom(*a, **k):
        raise AssertionError("disabled profiler touched its state")

    monkeypatch.setattr(pyprof, "_ensure_state", boom)
    assert pyprof.sample_once() == 0
    assert pyprof.gil_probe_once(0.01) is None
    assert pyprof.maybe_start() is False
    assert pyprof.capture(0.1) == {"enabled": False}
    assert pyprof.running() is False
    assert pyprof._state is None
    snap = pyprof.snapshot()
    assert snap == jax_pyprof.snapshot() | {"enabled": False}


@pytest.mark.parametrize("name", [
    "znicz:continuous", "znicz:continuous-3", "znicz:replica-out-r0",
    "MainThread", "Thread-12", "", None, "znicz:"])
def test_thread_name_registry(name):
    assert pyprof.component_of(name) == jax_pyprof.component_of(name)
    assert pyprof.thread_name("x") == jax_pyprof.thread_name("x")


def test_name_current_thread():
    saved = threading.current_thread().name
    try:
        pyprof.name_current_thread("test-main")
        assert threading.current_thread().name == "znicz:test-main"
    finally:
        threading.current_thread().name = saved


@pytest.mark.parametrize("filename,funcname,want", [
    ("/usr/lib/python3/threading.py", "wait", "lock_wait"),
    ("/usr/lib/python3/queue.py", "get", "lock_wait"),
    ("app.py", "acquire", "lock_wait"),
    ("/usr/lib/python3/json/decoder.py", "raw_decode", "json_decode"),
    ("/usr/lib/python3/json/scanner.py", "scan_once", "json_decode"),
    ("/usr/lib/python3/json/__init__.py", "loads", "json_decode"),
    ("/usr/lib/python3/json/encoder.py", "iterencode", "serialize"),
    ("app.py", "dumps", "serialize"),
    ("app.py", "tolist", "serialize"),
    ("/sp/numpy/lib/format.py", "read_array", "npy_decode"),
    ("/sp/numpy/core/multiarray.py", "frombuffer", "npy_decode"),
    ("/usr/lib/python3/socket.py", "recv_into", "socket_io"),
    ("/usr/lib/python3/http/client.py", "begin", "socket_io"),
    ("/usr/lib/python3/socketserver.py", "process_request", "socket_io"),
    ("app.py", "sendall", "socket_io"),
    ("app.py", "block_until_ready", "device_dispatch"),
    ("app.py", "train_epoch", "other"),
    (None, None, "other"),
])
def test_classify_table(filename, funcname, want):
    got = pyprof.classify(filename, funcname)
    assert got == jax_pyprof.classify(filename, funcname) == want
    assert got in pyprof.PHASES


@pytest.mark.parametrize("filename,funcname,jax_want", [
    ("/sp/torch/nn/modules/conv.py", "_conv_forward", "other"),
    ("/sp/torch/cuda/__init__.py", "synchronize", "other"),
    ("/repo/znicz_tpu_torch/ops/cuda_pooling.py", "max_pooling_offsets",
     "other"),
    ("/repo/znicz_tpu_torch/ops/cuda_pooling_backward.py",
     "max_pooling_offsets_backward", "other"),
    ("/sp/jax/_src/api.py", "cache_miss", "device_dispatch"),
    ("/sp/jaxlib/xla_client.py", "execute", "device_dispatch"),
])
def test_classify_the_ports_dispatch_frames(filename, funcname, jax_want):
    """The known difference: the port's dispatch frames (torch's and the
    kernels' ctypes launches) are ``device_dispatch``, JAX's are
    not; and the JAX package's own are the port's ``other``."""
    assert jax_pyprof.classify(filename, funcname) == jax_want
    want = "other" if jax_want == "device_dispatch" else "device_dispatch"
    assert pyprof.classify(filename, funcname) == want


def test_vocabulary_is_jaxs():
    assert pyprof.PHASES == jax_pyprof.PHASES
    assert pyprof.DATAPLANE_PHASES == jax_pyprof.DATAPLANE_PHASES


def test_sample_once_folds_and_attributes(both):
    frames = {
        1: chain(("server.py", "handle"),
                 ("/usr/lib/python3/json/decoder.py", "raw_decode")),
        2: chain(("app.py", "main"), ("model.py", "train_epoch")),
    }
    names = {1: "znicz:http-handler", 2: "Thread-5"}

    def drive(p):
        n = [p.pp.sample_once(frames=frames, names=names)]
        first = _without_timing(p.pp.snapshot())
        n.append(p.pp.sample_once(frames=frames, names=names))
        return n, first, _without_timing(p.pp.snapshot())
    want, got = run_both(both, drive)
    assert got == want
    assert got[1]["stacks"] == {
        "http-handler;server:handle;decoder:raw_decode": 1,
        "unnamed;app:main;model:train_epoch": 1}
    assert got[1]["attributed_pct"] == pytest.approx(50.0)
    assert got[2]["samples"] == 4


def test_sampler_never_profiles_itself(both):
    def drive(p):
        return p.pp.sample_once(frames={1: chain(("pyprof.py", "_run"))},
                                names={1: "znicz:pyprof-sampler"})
    assert run_both(both, drive) == (0, 0)


def test_max_depth_and_capacity(both):
    def drive(p):
        p.root.common.profiler.pyprof.max_depth = 2
        p.root.common.profiler.pyprof.capacity = 2
        p.pp.sample_once(frames={1: chain(("a.py", "fa"), ("b.py", "fb"),
                                          ("c.py", "fc"), ("d.py", "fd"))},
                         names={1: "znicz:x"})
        for i in range(3):
            p.pp.sample_once(frames={1: chain(("m%d.py" % i, "f"))},
                             names={1: "znicz:x"})
        return _without_timing(p.pp.snapshot())
    want, got = run_both(both, drive)
    assert got == want
    assert "x;c:fc;d:fd" in got["stacks"] and got["truncated"] == 2


def test_unknown_phase_is_a_loud_error(both, monkeypatch):
    monkeypatch.setattr(pyprof, "classify",
                        lambda filename, funcname: "warp_drive")
    with pytest.raises(ValueError, match="warp_drive"):
        pyprof.sample_once(frames={1: chain(("novel.py", "f"))},
                           names={1: "znicz:x"})


def test_samples_counter_and_overhead_meter(both):
    def drive(p):
        frames = {1: chain(("a.py", "f"))}
        p.pp.sample_once(frames=frames, names={1: "znicz:x"})
        ticks = [100.0, 100.25]
        p.pp.sample_once(frames=frames, names={1: "znicz:x"},
                         clock=lambda: ticks.pop(0))
        return (p.tel.snapshot()["counters"]["pyprof.samples"],
                p.pp.snapshot()["overhead"]["busy_ms"] >= 250.0)
    want, got = run_both(both, drive)
    assert got == want == (2, True)


def test_gil_probe_calibrates_then_counts_excess(both):
    def drive(p):
        p.root.common.profiler.pyprof.gil_calib_probes = 3
        out = [p.pp.gil_probe_once(d) for d in
               (0.001, 0.003, 0.002, 0.005, 0.001)]
        return (out, p.pp.snapshot()["gil"],
                p.tel.snapshot()["counters"]["pyprof.gil_wait_ms"])
    want, got = run_both(both, drive)
    assert got == want
    assert got[1]["baseline_ms"] == pytest.approx(2.0)
    assert got[1]["wait_ms"] == pytest.approx(3.0)


def test_diff_snapshots_is_the_window(both):
    a = {1: chain(("a.py", "f"))}
    b = {1: chain(("b.py", "dumps"))}

    def drive(p):
        p.pp.sample_once(frames=a, names={1: "znicz:x"})
        before = p.pp.snapshot()
        p.pp.sample_once(frames=a, names={1: "znicz:x"})
        p.pp.sample_once(frames=b, names={1: "znicz:y"})
        after = p.pp.snapshot()
        return before, after
    (jb, ja), (tb, ta) = run_both(both, drive)
    # each package's diff of its own window, and either diff of the
    # other's snapshots
    for before, after in ((jb, ja), (tb, ta), (jb, ta), (tb, ja)):
        got = pyprof.diff_snapshots(before, after)
        want = jax_pyprof.diff_snapshots(before, after)
        assert got == want
    win = _without_timing(pyprof.diff_snapshots(tb, ta))
    assert win["stacks"] == {"x;a:f": 1, "y;b:dumps": 1}
    assert win["phases"] == {"other": 1, "serialize": 1}


def test_capture_clamps_and_injects_sleep(both):
    def drive(p):
        p.root.common.profiler.pyprof.capture_seconds_cap = 5.0
        slept = []
        out = p.pp.capture(99.0, sleep=slept.append)
        return slept, out["seconds"], out["pid"], out["enabled"]
    want, got = run_both(both, drive)
    assert got == want == ([5.0], 5.0, os.getpid(), True)


def test_merge_profiles_sums_with_attribution():
    payloads = {
        "r0": {"enabled": True, "samples": 10,
               "components": {"http-handler": 8, "unnamed": 2},
               "phases": {"socket_io": 6, "other": 4},
               "stacks": {"http-handler;a:f": 8},
               "gil": {"probes": 5, "wait_ms": 1.5},
               "overhead": {"pct": 2.0}},
        "r1": {"enabled": True, "samples": 6,
               "components": {"http-handler": 6},
               "phases": {"socket_io": 6},
               "stacks": {"http-handler;a:f": 6},
               "gil": {"probes": 5, "wait_ms": 0.5},
               "overhead": {"pct": 3.0}},
        "router": {"enabled": False},
    }
    got = pyprof.merge_profiles(payloads)
    assert got == jax_pyprof.merge_profiles(payloads)
    assert got["samples"] == 16 and got["attributed_pct"] == 87.5


@pytest.mark.parametrize("stacks", [
    {"x;a:f;b:g": 3, "x;a:f": 1}, {}, {"c;d:e": 2, "a;b:c": 7}])
def test_renderers(stacks):
    prof = {"stacks": stacks}
    assert pyprof.collapsed(prof) == jax_pyprof.collapsed(prof)
    assert pyprof.speedscope(prof, name="t") == \
        jax_pyprof.speedscope(prof, name="t")


def test_maybe_start_lifecycle(both):
    assert pyprof.maybe_start() is True
    assert pyprof.maybe_start() is True
    assert pyprof.running() is True
    mine = [t.name for t in threading.enumerate()
            if t.name.startswith("znicz:pyprof")]
    assert "znicz:pyprof-sampler" in mine and "znicz:pyprof-gil" in mine
    root.common.profiler.pyprof.enabled = False
    deadline = time.monotonic() + 5.0
    while pyprof.running() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pyprof.running() is False
    assert pyprof.maybe_start() is False


def test_stop_keeps_aggregates_reset_drops_them(both):
    pyprof.sample_once(frames={1: chain(("a.py", "f"))},
                       names={1: "znicz:x"})
    assert pyprof.maybe_start() is True
    pyprof.stop()
    assert pyprof.running() is False
    assert pyprof.snapshot()["samples"] >= 1
    pyprof.reset()
    assert pyprof.snapshot()["samples"] == 0


def test_the_ports_threads_are_named():
    """Every thread the port spawns carries a ``znicz:<component>``
    name: the batchers', the servers' and the samplers'."""
    import numpy
    from znicz_tpu_torch.core.status_server import StatusServer
    from znicz_tpu_torch.serving.batcher import MicroBatcher

    class Engine(object):
        buckets = (1, 2)
        max_batch = 2
        sample_shape = (3,)

        def predict(self, x, request_ids=None):
            return numpy.zeros((len(x), 2), numpy.float32)

    server = StatusServer(None, port=0).start()
    batcher = MicroBatcher(Engine()).start()
    try:
        names = {t.name for t in threading.enumerate()}
        assert "znicz:statusserver" in names
        assert "znicz:micro-batcher" in names
        for name in names:
            if name.startswith("znicz:"):
                assert pyprof.component_of(name) != "unnamed"
    finally:
        batcher.stop()
        server.stop()
