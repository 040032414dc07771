"""The port's multi-model serving on the CPU: the continuous batcher,
the per-bucket circuit breaker, the model registry and their HTTP front
end.

* ``tests/unit/test_continuous_batcher.py`` case for case: immediate
  dispatch when idle, coalescing
  while the slots are busy, round-robin across models, shape lanes that
  never mix, the queue limit, deadlines, a failing dispatch failing only
  its batch, the draining stop, unknown models, the stale lane cap and
  oversize requests; plus the priority lanes, and the request ids
  (slice 15): the admitted ring's bounds and a shed request never
  admitted (``tests/unit/test_priority_lanes.py``), the ids reaching
  the engine that serves the model at dispatch, also after the model
  is replaced (``test_rid_aware_cache_invalidates_on_model_replace``;
  the port caches nothing per engine: every engine's ``predict`` takes
  ``request_ids``).
* The breaker cases of ``tests/functional/test_serving_resilience.py``,
  a monkeypatched dispatch that raises in place of fault injection:
  open after the threshold, 503 with ``Retry-After`` without a
  dispatch, per-bucket isolation, recovery through a half-open probe on
  a fake clock, runtime disable and reconfigure, a ``BaseException``
  releasing its probe slot, a submit racing the drain answering 503.
* Every test runs under the armed lock-order sanitizer (the JAX
  package's conftest arms the three modules above): 0 cycles and 0
  blocking calls under a lock at teardown.
* The registry (``tests/functional/test_serving_dtype.py``'s mixed-dtype
  accounting among them): URL-safe names, hot reload by name, the LRU
  eviction under a budget below the models' sum with a lazy restore
  whose replies are bit-identical, ``peek`` restoring nothing, and the
  HTTP routes ``/predict/<model>``, ``/healthz/<model>``, ``/models``
  (GET, POST, DELETE) and ``/reload``.
"""

import http.client
import json
import threading
import time

import numpy
import pytest

from test_torch_engine import NARROW
from test_torch_locksmith import armed_clean
from test_torch_mnist import _one_torch_thread  # noqa: F401
from znicz_tpu_torch import export
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.samples import alexnet
from znicz_tpu_torch.serving.batcher import (BatcherStoppedError,
                                             QueueFullError,
                                             RequestTimeoutError)
from znicz_tpu_torch.serving.breaker import (CircuitBreaker,
                                             CircuitOpenError)
from znicz_tpu_torch.serving.continuous import (ContinuousBatcher,
                                                normalize_priority)
from znicz_tpu_torch.serving.engine import InferenceEngine
from znicz_tpu_torch.serving.registry import ModelRegistry, UnknownModelError
from znicz_tpu_torch.serving.server import ServingServer


@pytest.fixture(autouse=True)
def _lock_order_sanitizer():
    """Every test here runs under the armed lock-order sanitizer, as
    the JAX package arms ``test_model_registry``,
    ``test_continuous_batcher`` and ``test_serving_resilience``: the
    teardown asserts 0 lock-order cycles and 0 blocking calls under a
    lock."""
    with armed_clean():
        yield


# -- the continuous batcher ------------------------------------------------

class RecordingModel(object):
    """A stand-in engine: ``y = x + 1``, recording each dispatch's rows;
    ``gate`` (when cleared) holds the dispatches."""

    def __init__(self, max_batch=8, fail=False):
        self.max_batch = max_batch
        self.sample_shape = None
        self.batches = []
        self.gate = threading.Event()
        self.gate.set()
        self.fail = fail
        self.lock = threading.Lock()

    def predict(self, x, request_ids=None):
        self.gate.wait(10)
        if self.fail:
            raise RuntimeError("dispatch boom")
        with self.lock:
            self.batches.append(len(x))
        return numpy.asarray(x) + 1.0


class FakeRegistry(object):
    """Just enough of ModelRegistry for the batcher."""

    def __init__(self, engines):
        self.engines = engines
        self.default = sorted(engines)[0]

    def names(self):
        return sorted(self.engines)

    def engine(self, name=None):
        key = name if name is not None else self.default
        if key not in self.engines:
            raise UnknownModelError(key, self.engines)
        return self.engines[key]

    peek = engine


def _rows(n, width=3, base=0.0):
    return numpy.arange(n * width, dtype=numpy.float64).reshape(
        n, width) + base


def _batcher(model, **kw):
    kw = dict(dict(max_inflight=1, queue_limit=64, timeout_ms=0), **kw)
    return ContinuousBatcher(model, **kw).start()


def test_idle_request_dispatches_immediately():
    model = RecordingModel()
    b = _batcher(model, max_inflight=2)
    try:
        t0 = time.monotonic()
        y = b.submit(_rows(1)).result(timeout=5)
        assert time.monotonic() - t0 < 2.0
        assert numpy.array_equal(y, _rows(1) + 1.0)
        assert model.batches == [1]
    finally:
        b.stop()


def test_queued_requests_coalesce_when_slots_busy():
    model = RecordingModel(max_batch=8)
    b = _batcher(model)
    try:
        model.gate.clear()
        first = b.submit(_rows(1, base=100.0))
        time.sleep(0.05)
        rest = [b.submit(_rows(1, base=float(i))) for i in range(4)]
        time.sleep(0.05)
        model.gate.set()
        assert numpy.array_equal(first.result(timeout=5),
                                 _rows(1, base=100.0) + 1.0)
        for i, f in enumerate(rest):
            assert numpy.array_equal(f.result(timeout=5),
                                     _rows(1, base=float(i)) + 1.0)
        assert model.batches == [1, 4]
        # a slot leaves the inflight count just after it resolves its
        # batch's futures
        deadline = time.monotonic() + 5
        while b.inflight and time.monotonic() < deadline:
            time.sleep(0.001)
        assert b.inflight == 0 and b.queued_rows == 0
    finally:
        b.stop()


def test_round_robin_fairness_across_models():
    order = []

    class TaggedModel(RecordingModel):
        def __init__(self, tag):
            super().__init__()
            self.tag = tag

        def predict(self, x, request_ids=None):
            y = super().predict(x)
            order.append(self.tag)
            return y

    flood, lone = TaggedModel("flood"), TaggedModel("lone")
    b = _batcher(FakeRegistry({"flood": flood, "lone": lone}),
                 queue_limit=1024)
    try:
        flood.gate.clear()
        lone.gate.clear()
        floods = [b.submit(_rows(1), model="flood") for _ in range(20)]
        time.sleep(0.05)
        alone = b.submit(_rows(1), model="lone")
        time.sleep(0.05)
        flood.gate.set()
        lone.gate.set()
        alone.result(timeout=5)
        for f in floods:
            f.result(timeout=5)
        assert order.index("lone") <= 2, order
    finally:
        b.stop()


def test_shape_lanes_never_mix():
    seen = []

    def predict(x, request_ids=None):
        seen.append(numpy.asarray(x).shape)
        return numpy.asarray(x)

    predict.max_batch = 8
    b = _batcher(predict)
    try:
        f1 = b.submit(_rows(2, width=3))
        f2 = b.submit(_rows(2, width=5))
        f1.result(timeout=5)
        f2.result(timeout=5)
        assert sorted(s[1] for s in seen) == [3, 5]
    finally:
        b.stop()


def test_queue_limit_rejects():
    model = RecordingModel()
    b = _batcher(model, queue_limit=4)
    try:
        model.gate.clear()
        b.submit(_rows(1))
        time.sleep(0.05)
        b.submit(_rows(4))
        with pytest.raises(QueueFullError):
            b.submit(_rows(1))
        model.gate.set()
    finally:
        b.stop()


def test_priority_lanes_shed_low_first_and_dispatch_high_first():
    model = RecordingModel(max_batch=1)
    b = _batcher(model, queue_limit=4)
    try:
        model.gate.clear()
        held = b.submit(_rows(1))
        time.sleep(0.05)
        low = [b.submit(_rows(1, base=10.0), priority="low")
               for _ in range(2)]
        # low admits under half the queue; normal and high to the full
        with pytest.raises(QueueFullError, match="low priority"):
            b.submit(_rows(1), priority="low")
        high = b.submit(_rows(1, base=20.0), priority="HIGH")
        normal = b.submit(_rows(1, base=30.0))
        with pytest.raises(QueueFullError):
            b.submit(_rows(1), priority="high")
        order = []
        for f, tag in [(held, "held"), (high, "high"), (normal, "normal")] \
                + [(f, "low") for f in low]:
            f.add_done_callback(lambda _, tag=tag: order.append(tag))
        model.gate.set()
        for f in low:
            f.result(timeout=5)
        assert order == ["held", "high", "normal", "low", "low"]
    finally:
        b.stop()
    assert normalize_priority(None) == "normal"
    with pytest.raises(ValueError, match="unknown priority"):
        normalize_priority("hgih")


def test_deadline_expires_in_queue():
    model = RecordingModel()
    b = _batcher(model)
    try:
        model.gate.clear()
        blocker = b.submit(_rows(1))
        time.sleep(0.05)
        doomed = b.submit(_rows(1), timeout_ms=30.0)
        time.sleep(0.2)
        model.gate.set()
        blocker.result(timeout=5)
        with pytest.raises(RequestTimeoutError):
            doomed.result(timeout=5)
        assert sum(model.batches) == 1
    finally:
        b.stop()


def test_failing_dispatch_fails_batch_not_worker():
    model = RecordingModel()
    b = _batcher(model)
    try:
        model.fail = True
        with pytest.raises(RuntimeError, match="dispatch boom"):
            b.submit(_rows(1)).result(timeout=5)
        model.fail = False
        assert numpy.array_equal(b.submit(_rows(2)).result(timeout=5),
                                 _rows(2) + 1.0)
    finally:
        b.stop()


def test_stop_flush_serves_queue_submit_after_raises():
    model = RecordingModel()
    b = _batcher(model)
    model.gate.clear()
    futures = [b.submit(_rows(1, base=float(i))) for i in range(5)]
    stopper = threading.Thread(target=b.stop, kwargs={"flush": True})
    stopper.start()
    time.sleep(0.05)
    model.gate.set()
    stopper.join(timeout=10)
    assert not stopper.is_alive()
    for i, f in enumerate(futures):
        assert numpy.array_equal(f.result(timeout=1),
                                 _rows(1, base=float(i)) + 1.0)
    with pytest.raises(BatcherStoppedError):
        b.submit(_rows(1))


def test_unknown_model_raises_at_submit():
    b = _batcher(FakeRegistry({"only": RecordingModel()}))
    try:
        with pytest.raises(UnknownModelError):
            b.submit(_rows(1), model="ghost")
        assert numpy.array_equal(b.submit(_rows(1)).result(timeout=5),
                                 _rows(1) + 1.0)
    finally:
        b.stop()


def test_stale_lane_cap_never_wedges_a_slot():
    model = RecordingModel(max_batch=8)
    b = _batcher(model)
    try:
        model.gate.clear()
        blocker = b.submit(_rows(1))
        time.sleep(0.05)
        big = b.submit(_rows(6))
        model.max_batch = 4
        small = b.submit(_rows(1))
        model.gate.set()
        blocker.result(timeout=5)
        assert numpy.array_equal(big.result(timeout=5), _rows(6) + 1.0)
        assert numpy.array_equal(small.result(timeout=5), _rows(1) + 1.0)
        assert 6 in model.batches
    finally:
        b.stop()


def test_oversize_request_rejected_loudly():
    b = _batcher(RecordingModel(max_batch=4))
    try:
        with pytest.raises(ValueError, match="max_batch"):
            b.submit(_rows(5))
    finally:
        b.stop()
    with pytest.raises(ValueError, match="max_inflight"):
        ContinuousBatcher(RecordingModel(), max_inflight=0)


# -- the circuit breaker ---------------------------------------------------

def test_breaker_state_machine_on_a_fake_clock():
    now = [0.0]
    b = CircuitBreaker("b", threshold=2, cooldown_s=10.0,
                       clock=lambda: now[0])
    assert b.allow() is False
    b.record_failure()
    b.record_success()
    b.record_failure()
    assert b.state == "closed"
    b.record_failure()
    assert b.state == "open" and b.opens == 1
    with pytest.raises(CircuitOpenError) as e:
        b.allow()
    assert e.value.retry_after == 10.0
    assert b.status()["retry_after"] == 10.0
    now[0] = 11.0
    assert b.allow() is True and b.state == "half_open"
    with pytest.raises(CircuitOpenError):
        b.allow()  # the one probe slot is taken
    b.record_failure()  # the probe failed: open again
    assert b.state == "open" and b.opens == 2
    now[0] = 22.0
    probe = b.allow()
    b.record_neutral(probe)  # frees the slot, no transition
    assert b.state == "half_open" and b.allow() is True
    b.record_success()
    assert b.state == "closed" and b.status()["failures"] == 0
    b.reconfigure(3, 0.5, 2)
    assert (b.threshold, b.cooldown_s, b.half_open_max) == (3, 0.5, 2)


@pytest.fixture(scope="module")
def package():
    return alexnet.init_package(7, size=35, layers=NARROW)


@pytest.fixture
def serving_knobs():
    cfg = root.common.serving
    saved = {k: cfg.get(k) for k in ("breaker_threshold",
                                     "breaker_cooldown_ms",
                                     "breaker_half_open_max",
                                     "registry_memory_budget_bytes")}
    yield cfg
    for k, v in saved.items():
        setattr(cfg, k, v)


def _images(n, seed=3):
    return numpy.random.RandomState(seed).uniform(
        -1, 1, (n, 35, 35, 3)).astype(numpy.float32)


def _call(port, method, path, doc=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=None if doc is None
                     else json.dumps(doc),
                     headers=dict({"Content-Type": "application/json"},
                                  **(headers or {})))
        resp = conn.getresponse()
        return (resp.status, json.loads(resp.read() or b"null"),
                dict(resp.getheaders()))
    finally:
        conn.close()


def _failing(engine, monkeypatch):
    """Make ``engine``'s dispatches raise; returns the dispatch counter
    and the switch that heals them."""
    real = engine._dispatch
    state = {"fail": True, "calls": 0}

    def dispatch(m, params, x):
        state["calls"] += 1
        if state["fail"]:
            raise RuntimeError("device lost")
        return real(m, params, x)
    monkeypatch.setattr(engine, "_dispatch", dispatch)
    return state


def test_breaker_opens_serves_503_and_recovers(package, serving_knobs,
                                               monkeypatch):
    serving_knobs.breaker_threshold = 2
    serving_knobs.breaker_cooldown_ms = 3600 * 1e3
    engine = InferenceEngine(package, max_batch=4, device="cpu")
    server = ServingServer(engine, port=0).start()
    try:
        body = {"inputs": _images(1).tolist()}
        assert _call(server.port, "POST", "/predict", body)[0] == 200
        state = _failing(engine, monkeypatch)
        for _ in range(2):
            status, doc, _ = _call(server.port, "POST", "/predict", body)
            assert status == 500 and "device lost" in doc["error"]
        bucket1 = engine._breakers[1]
        assert bucket1.state == "open"
        calls = state["calls"]
        status, doc, headers = _call(server.port, "POST", "/predict", body)
        assert status == 503 and int(headers["Retry-After"]) >= 1
        assert "is open" in doc["error"] and state["calls"] == calls
        # another bucket still dispatches (and fails on its own)
        status, _, _ = _call(server.port, "POST", "/predict",
                             {"inputs": _images(4).tolist()})
        assert status == 500 and state["calls"] == calls + 1
        state["fail"] = False
        opened_at = bucket1._opened_at
        bucket1._clock = lambda: opened_at + 10 * 3600.0
        assert _call(server.port, "POST", "/predict", body)[0] == 200
        assert bucket1.state == "closed"
        st = engine.stats()["breakers"]["1"]
        assert st["state"] == "closed" and st["opens"] == 1
    finally:
        server.stop()


def test_breaker_runtime_disable_and_reconfigure(package, serving_knobs,
                                                 monkeypatch):
    serving_knobs.breaker_threshold = 2
    serving_knobs.breaker_cooldown_ms = 3600 * 1e3
    engine = InferenceEngine(package, max_batch=4, device="cpu")
    x = _images(1)
    state = _failing(engine, monkeypatch)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="device lost"):
            engine.predict(x)
    with pytest.raises(CircuitOpenError):
        engine.predict(x)
    state["fail"] = False
    serving_knobs.breaker_threshold = 0
    assert engine._bucket_breaker(1) is None
    assert engine.predict(x).shape == (1, 10)
    serving_knobs.breaker_threshold = 5
    serving_knobs.breaker_cooldown_ms = 250.0
    b = engine._bucket_breaker(1)
    assert b is engine._breakers[1]
    assert b.threshold == 5 and b.cooldown_s == 0.25
    assert b.state == "open" and b.opens == 1


def test_client_errors_do_not_count(package, serving_knobs):
    serving_knobs.breaker_threshold = 1
    engine = InferenceEngine(package, max_batch=4, device="cpu")
    with pytest.raises(ValueError, match="per-sample shape"):
        engine.predict(numpy.zeros((1, 34, 35, 3), numpy.float32))
    assert engine._breakers[1].state == "closed"


def test_base_exception_probe_releases_slot(package, serving_knobs,
                                            monkeypatch):
    serving_knobs.breaker_threshold = 1
    serving_knobs.breaker_cooldown_ms = 3600 * 1e3
    engine = InferenceEngine(package, max_batch=4, device="cpu")
    x = _images(1)
    state = _failing(engine, monkeypatch)
    with pytest.raises(RuntimeError):
        engine.predict(x)
    b = engine._breakers[1]
    assert b.state == "open"
    opened_at = b._opened_at
    b._clock = lambda: opened_at + 7200.0
    real = engine._dispatch

    def interrupted(m, params, xx):
        raise KeyboardInterrupt()
    monkeypatch.setattr(engine, "_dispatch", interrupted)
    with pytest.raises(KeyboardInterrupt):
        engine.predict(x)
    assert b.state == "half_open" and b._probes == 0
    monkeypatch.setattr(engine, "_dispatch", real)
    state["fail"] = False
    assert engine.predict(x).shape == (1, 10) and b.state == "closed"


def test_submit_racing_drain_gets_503(package):
    engine = InferenceEngine(package, max_batch=4, device="cpu")
    server = ServingServer(engine, port=0).start()
    try:
        server.batcher.stop()
        status, doc, headers = _call(server.port, "POST", "/predict",
                                     {"inputs": _images(1).tolist()})
        assert status == 503 and doc["error"] == "server draining"
        assert headers["Retry-After"] == "1"
    finally:
        server.stop()


# -- the registry ----------------------------------------------------------

@pytest.fixture(scope="module")
def packages(package, tmp_path_factory):
    """The narrow package on disk, and a twin with other weights."""
    tmp = tmp_path_factory.mktemp("registry")
    other = alexnet.init_package(8, size=35, layers=NARROW)
    return (export.write_package(*package, str(tmp / "a.zip")),
            export.write_package(*other, str(tmp / "b.zip")))


def test_registry_names_reload_remove(packages):
    reg = ModelRegistry(max_batch=4, device="cpu")
    with pytest.raises(ValueError, match="URL-routable"):
        reg.add("no/slash", packages[0])
    assert reg.add("m", packages[0]) == 1
    assert reg.default == "m" and "m" in reg and len(reg) == 1
    x = _images(2)
    y1 = reg.engine("m").predict(x)
    assert reg.reload("m", packages[1]) == 2
    y2 = reg.engine().predict(x)
    assert not numpy.allclose(y1, y2)
    assert reg.add("m", packages[0]) == 3  # an add on a name reloads
    assert numpy.array_equal(reg.engine("m").predict(x), y1)
    assert reg.reload("m") == 4
    with pytest.raises(ValueError, match="cannot change"):
        reg.add("m", packages[0], dtype="bf16")
    assert reg.ready and reg.readiness() == {"m": True}
    reg.remove("m")
    assert reg.default is None and reg.names() == []
    with pytest.raises(UnknownModelError, match="unknown model"):
        reg.remove("m")
    with pytest.raises(UnknownModelError):
        reg.engine()


def test_registry_mixed_dtype_accounting(packages):
    reg = ModelRegistry(max_batch=4, device="cpu")
    reg.add("f32", packages[0])
    reg.add("q8", packages[0], dtype="int8")
    reg.add("bf", packages[0], dtype="bf16")
    stats = reg.stats()["models"]
    assert {k: v["serve_dtype"] for k, v in stats.items()} == {
        "f32": "f32", "q8": "int8", "bf": "bf16"}
    f32, q8, bf = (reg.peek(n).device_bytes for n in ("f32", "q8", "bf"))
    assert 0 < q8 < 0.3 * f32 and bf * 2 == f32
    assert reg.resident_bytes == f32 + q8 + bf


def test_lru_eviction_and_lazy_restore(packages, serving_knobs):
    reg = ModelRegistry(max_batch=4, device="cpu")
    for name, dtype in (("a", "f32"), ("a8", "int8"), ("b", "bf16")):
        reg.add(name, packages[0], dtype=dtype)
    x = _images(3, seed=9)
    before = {n: reg.engine(n).predict(x) for n in ("a", "a8", "b")}
    total = reg.resident_bytes
    a_bytes = reg.peek("a").device_bytes
    # a budget below the sum, read live: the next request evicts the
    # least recently used model ("a")
    serving_knobs.registry_memory_budget_bytes = total - 1
    reg.engine("b")
    assert not reg.peek("a").resident
    assert reg.resident_bytes == total - a_bytes
    assert reg.memory_stats()["evictions"] == 1
    assert reg.readiness()["a"] is False
    assert not reg.peek("a").resident  # peek restores nothing
    # the next request to "a" restores it (evicting the coldest other)
    assert numpy.array_equal(reg.engine("a").predict(x), before["a"])
    assert reg.peek("a").resident and not reg.peek("a8").resident
    assert numpy.array_equal(reg.engine("a8").predict(x), before["a8"])
    assert reg.resident_bytes <= total - 1
    serving_knobs.registry_memory_budget_bytes = 0
    tight = ModelRegistry(max_batch=4, device="cpu",
                          memory_budget_bytes=1)
    tight.add("only", packages[0])  # nothing evictable but itself
    assert tight.peek("only").resident


def test_registry_over_http(packages):
    reg = ModelRegistry(max_batch=4, device="cpu")
    reg.add("a", packages[0])
    reg.add("q", packages[0], dtype="int8")
    server = ServingServer(registry=reg, port=0).start()
    try:
        port = server.port
        x = _images(2, seed=4)
        status, doc, _ = _call(port, "POST", "/predict/q",
                               {"inputs": x.tolist()})
        assert status == 200 and doc["model"] == "q"
        numpy.testing.assert_allclose(doc["outputs"],
                                      reg.peek("q").predict(x), rtol=0,
                                      atol=0)
        status, doc, _ = _call(port, "POST", "/predict",
                               {"inputs": x.tolist(), "model": "a"})
        assert status == 200 and doc["model_version"] == 1
        assert _call(port, "POST", "/predict/ghost",
                     {"inputs": x.tolist()})[0] == 404
        assert _call(port, "POST", "/predict/a", {"inputs": x.tolist()},
                     headers={"X-Priority": "hgih"})[0] == 400
        assert _call(port, "POST", "/predict/a", {"inputs": x.tolist()},
                     headers={"X-Priority": "high"})[0] == 200
        status, doc, _ = _call(port, "GET", "/healthz/q")
        assert status == 200 and doc["serve_dtype"] == "int8"
        assert _call(port, "GET", "/healthz/ghost")[0] == 404
        status, doc, _ = _call(port, "GET", "/healthz")
        assert status == 200 and doc["models"] == {"a": True, "q": True}
        status, doc, _ = _call(port, "POST", "/models/b",
                               {"path": packages[1], "dtype": "bf16"})
        assert status == 200 and doc["models"] == ["a", "b", "q"]
        status, doc, _ = _call(port, "GET", "/models")
        assert doc["models"]["b"]["serve_dtype"] == "bf16"
        status, doc, _ = _call(port, "POST", "/reload",
                               {"path": packages[1], "model": "a"})
        assert status == 200 and doc["model_version"] == 2
        assert _call(port, "POST", "/models/bad",
                     {"path": "/nonexistent.zip"})[0] == 400
        assert "bad" not in reg
        status, doc, _ = _call(port, "DELETE", "/models/b")
        assert status == 200 and doc["models"] == ["a", "q"]
        assert _call(port, "DELETE", "/models/b")[0] == 404
    finally:
        server.stop()
    single = ServingServer(InferenceEngine(packages[0], max_batch=4,
                                           device="cpu"), port=0).start()
    try:
        assert _call(single.port, "POST", "/models/x",
                     {"path": packages[0]})[0] == 400
        assert _call(single.port, "POST", "/predict/x",
                     {"inputs": _images(1).tolist()})[0] == 404
        status, doc, _ = _call(single.port, "GET", "/models")
        assert status == 200 and doc["default"] == "default"
    finally:
        single.stop()
    with pytest.raises(ValueError, match="exactly one"):
        ServingServer(port=0)


# -- request ids: the admitted ring and the engine's ids --------------------

def _unstarted(model, **kw):
    """A batcher that admits but has no slot running (as JAX's tests
    hold one): what it admits stays queued."""
    kw = dict(dict(max_inflight=1, queue_limit=64, timeout_ms=0), **kw)
    b = ContinuousBatcher(model, **kw)
    b._running = True
    return b


def test_admitted_ring_records_and_bounds(monkeypatch):
    monkeypatch.setattr(root.common.serving, "admitted_rid_capacity", 4)
    b = _unstarted(RecordingModel(), queue_limit=1024)
    try:
        for i in range(6):
            b.submit(_rows(1), request_id="rid-%d" % i)
        status = [b.admitted_status("rid-%d" % i)["admitted"]
                  for i in range(6)]
        assert status == [False, False, True, True, True, True]
        st = b.admitted_status("never-seen")
        assert st["admitted"] is False and st["evictions"] == 2
        assert st["oldest_retained_ts"] <= time.time()
        assert b.admitted_status(None)["admitted"] is False
    finally:
        b.stop(flush=False)


def test_shed_request_is_never_marked_admitted():
    b = _unstarted(RecordingModel(max_batch=100), queue_limit=10)
    try:
        b.submit(_rows(9), priority="high", request_id="kept")
        with pytest.raises(QueueFullError):
            b.submit(_rows(5), priority="high", request_id="shed")
        kept = b.admitted_status("kept")
        assert kept["admitted"] is True
        assert b.admitted_status("shed") == dict(kept, admitted=False)
    finally:
        b.stop(flush=False)


def test_a_request_whose_model_went_while_queued_leaves_the_ring():
    """A release's candidate removed while a canary request queued for
    it: the request fails as an unknown model before any forward, and
    its rid is no longer admitted (the router's fallback to the live
    generation may send it to a peer); the served model's rid stays."""
    live = RecordingModel()
    live.gate.clear()                  # the one slot held on "live"
    registry = FakeRegistry({"live": live, "cand": RecordingModel()})
    b = _batcher(registry)
    try:
        kept = b.submit(_rows(1), model="live", request_id="to-live")
        deadline = time.monotonic() + 5
        while b.queued_rows and time.monotonic() < deadline:
            time.sleep(0.001)
        assert b.queued_rows == 0      # the slot holds it
        gone = b.submit(_rows(1), model="cand", request_id="to-cand")
        assert b.admitted_status("to-cand")["admitted"] is True
        del registry.engines["cand"]
        live.gate.set()
        with pytest.raises(UnknownModelError):
            gone.result(timeout=5)
        kept.result(timeout=5)
        assert b.admitted_status("to-cand")["admitted"] is False
        assert b.admitted_status("to-live")["admitted"] is True
        assert live.batches == [1]
    finally:
        b.stop(flush=False)


def test_rid_aware_cache_invalidates_on_model_replace():
    class RidAwareModel(RecordingModel):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.rids = []

        def predict(self, x, request_ids=None):
            with self.lock:
                self.rids.append(request_ids)
            return numpy.asarray(x) + 1.0

    first = RidAwareModel()
    registry = FakeRegistry({"m": first})
    b = _batcher(registry)
    try:
        b.submit(_rows(1), model="m", request_id="r1").result(timeout=5)
        assert first.rids == [["r1"]]
        aware = RidAwareModel()
        registry.engines["m"] = aware
        b.submit(_rows(1), model="m", request_id="r2").result(timeout=5)
        b.submit(_rows(1), model="m").result(timeout=5)
        assert aware.rids == [["r2"], None]
        assert first.rids == [["r1"]]
    finally:
        b.stop()

