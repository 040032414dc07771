"""The SLO plane and the request traces through the port's HTTP front
end, after ``tests/functional/test_slo_observability.py`` (in-process
servers on the CPU, a 8-6-4 package):

* the full loop: healthy traffic keeps the budget full, injected
  dispatch faults answer 500s that burn it, ``slo.burn`` fires once with
  a bad request's rid as its exemplar, the healthy requests' trees are
  complete and their five top-level spans tile the wall (each starting
  where the one before ended, the parts summing to the wall within the
  stamps' rounding), ``device`` nests in ``dispatch``, and the
  time-series rings rate the batches;
* head sampling, the bounded ring, the single-engine server, client
  faults excluded from the budget, and the plane inert when off;
* the server's JSON replies equal the JAX package's server on the same
  package within 1e-5, its ``/slo`` payload has JAX's keys, and
  ``/admitted/<rid>`` and ``X-Serving-Ms`` answer as JAX's do.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest

from test_torch_mnist import _one_torch_thread  # noqa: F401
from znicz_tpu.core import telemetry as jax_telemetry
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.serving import ModelRegistry as JaxRegistry
from znicz_tpu.serving import ServingServer as JaxServer
from znicz_tpu_torch.core import faults, telemetry, timeseries
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.serving import reqtrace, slo
from znicz_tpu_torch.serving.batcher import MicroBatcher
from znicz_tpu_torch.serving.engine import InferenceEngine
from znicz_tpu_torch.serving.registry import ModelRegistry
from znicz_tpu_torch.serving.server import ServingServer

WIDTH = 8
TOL = 1e-5


def _model_source(seed=5, n_in=WIDTH, n_hidden=6, n_out=4):
    r = numpy.random.RandomState(seed)
    manifest = {
        "format": 1,
        "layers": [
            {"type": "all2all_tanh", "name": "fc0",
             "arrays": {"weights": "w0.npy", "bias": "b0.npy"},
             "include_bias": True, "weights_transposed": True},
            {"type": "softmax", "name": "out",
             "arrays": {"weights": "w1.npy", "bias": "b1.npy"},
             "include_bias": True, "weights_transposed": True},
        ],
        "input_sample_shape": [n_in],
    }
    arrays = {
        "w0.npy": r.randn(n_in, n_hidden).astype(numpy.float32),
        "b0.npy": numpy.zeros(n_hidden, numpy.float32),
        "w1.npy": r.randn(n_hidden, n_out).astype(numpy.float32),
        "b1.npy": numpy.zeros(n_out, numpy.float32),
    }
    return manifest, arrays


#: slo_ms is generous: these tests judge the fault and client-fault
#: accounting, and a loaded test host must not turn a 200 bad
PLANE = {"slo_enabled": True, "slo_ms": 5000.0, "slo_target_pct": 90.0,
         "slo_fast_window_s": 30.0, "slo_slow_window_s": 120.0,
         "slo_burn_threshold": 1.5, "trace_sample_n": 1,
         "breaker_threshold": 0}


@pytest.fixture
def armed(monkeypatch):
    """Telemetry and the whole plane on, with test-sized knobs; the
    sampler's gate on at an hour-long interval (the test samples)."""
    cfg = root.common.serving
    monkeypatch.setattr(root.common.telemetry, "enabled", True)
    for k, v in PLANE.items():
        monkeypatch.setattr(cfg, k, v)
    monkeypatch.setattr(root.common.retry, "attempts", 0)
    monkeypatch.setattr(root.common.telemetry.timeseries, "enabled", True)
    monkeypatch.setattr(root.common.telemetry.timeseries, "interval_ms",
                        3600e3)
    telemetry.reset()
    timeseries.reset()
    reqtrace.reset()
    yield
    timeseries.stop()
    timeseries.reset()
    reqtrace.reset()
    telemetry.reset()


def _serve_registry():
    registry = ModelRegistry(models={"m": _model_source()}, max_batch=4,
                             device="cpu")
    server = ServingServer(registry=registry).start()
    return server, "http://127.0.0.1:%d" % server.port


def _rows(rid, rows=1, width=WIDTH):
    seed = sum(map(ord, rid or "")) * 7919 % (2 ** 31)
    return numpy.random.RandomState(seed).uniform(-1, 1, (rows, width))


def _predict(url, rid, rows=1, model="m", width=WIDTH, headers=None):
    body = json.dumps({"inputs": _rows(rid, rows, width).tolist()}).encode()
    hdrs = {"Content-Type": "application/json"}
    if rid is not None:
        hdrs["X-Request-Id"] = rid
    hdrs.update(headers or {})
    req = urllib.request.Request(
        url + ("/predict/" + model if model else "/predict"), body, hdrs)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _closed_tree(url, rid, wait_s=5.0):
    """``rid``'s trace tree once the server has closed it: the server
    finishes a tree just after it sends the reply, so a read right
    after the reply may come first.  The last read after ``wait_s``."""
    deadline = time.monotonic() + wait_s
    while True:
        code, tree = _get(url, "/debug/trace/%s" % rid)
        if tree.get("complete") or time.monotonic() > deadline:
            return code, tree
        time.sleep(0.01)


class _Records(object):
    """Counts a server's SLO records.  The server finishes a request's
    trace and records its SLO after the reply was written, so a client
    can read ``/slo``, ``/statusz``, the journal or the trace before
    the record: it waits for the count first."""

    def __init__(self, server):
        self._cv = threading.Condition()
        self.count = 0
        record = server.slo.record

        def noted(*args, **kwargs):
            try:
                return record(*args, **kwargs)
            finally:
                with self._cv:
                    self.count += 1
                    self._cv.notify_all()
        server.slo.record = noted

    def wait(self, n, timeout=30.0):
        """True once ``n`` requests were recorded (False at the
        deadline)."""
        with self._cv:
            return self._cv.wait_for(lambda: self.count >= n, timeout)


def test_full_slo_loop_over_http(armed):
    server, url = _serve_registry()
    records = _Records(server)
    try:
        n_ok = 20
        for i in range(n_ok):
            code, doc, _ = _predict(url, "ok-%d" % i)
            assert code == 200 and doc["request_id"] == "ok-%d" % i
        assert records.wait(n_ok)
        timeseries.sample_once()
        code, healthy = _get(url, "/slo")
        m0 = healthy["models"]["m"]
        assert m0["good"] == n_ok and m0["bad"] == 0
        assert m0["error_budget_remaining"] == 1.0
        assert healthy["enabled"] is True

        root.common.faults.enabled = True
        faults.install("serving.forward", kind="xla", every=1)
        n_bad = 6
        try:
            for i in range(n_bad):
                assert _predict(url, "bad-%d" % i)[0] == 500
        finally:
            faults.clear()
            faults.reset()
            root.common.faults.enabled = False

        assert records.wait(n_ok + n_bad)
        code, burned = _get(url, "/slo")
        m1 = burned["models"]["m"]
        assert m1["bad"] == n_bad
        assert m1["error_budget_remaining"] < m0["error_budget_remaining"]
        assert m1["burn_rate"]["fast"] > burned["burn_threshold"]
        assert m1["burning"] is True
        code, statusz = _get(url, "/statusz")
        assert statusz["slo"]["models"]["m"]["bad"] == n_bad
        burns = [e for e in telemetry.journal_events()
                 if e.get("kind") == "slo.burn"]
        assert len(burns) == 1, burns
        assert burns[0]["model"] == "m"
        exemplar = burns[0]["exemplar_rid"]
        assert str(exemplar).startswith("bad-")
        assert _get(url, "/debug/trace/%s" % exemplar)[0] == 200

        code, tree = _get(url, "/debug/trace/ok-7")
        assert tree["complete"] is True
        assert set(tree["span_kinds"]) == set(reqtrace.SPAN_KINDS)
        wall, parts = tree["wall_ms"], tree["parts_ms"]
        assert wall > 0
        # the five top-level spans tile the wall, whatever the host's
        # load: each starts where the one before it ended (the 3-decimal
        # rounding of the stamps is the only slack)
        assert abs(parts - wall) <= 0.005, (parts, wall)
        top = [s for s in tree["spans"]
               if s["kind"] in reqtrace.TOP_LEVEL_KINDS]
        assert [s["kind"] for s in top] == list(reqtrace.TOP_LEVEL_KINDS)
        assert abs(top[0]["start_ms"]) <= 0.001, top
        for a, b in zip(top, top[1:]):
            assert abs(a["start_ms"] + a["duration_ms"] - b["start_ms"]) \
                <= 0.002, (a, b)
        spans = {s["kind"]: s for s in tree["spans"]}
        dev, disp = spans["device"], spans["dispatch"]
        assert dev["start_ms"] >= disp["start_ms"] - 1e-3
        assert dev["start_ms"] + dev["duration_ms"] <= \
            disp["start_ms"] + disp["duration_ms"] + 1e-3
        jax_telemetry.validate_trace(
            {"traceEvents": tree["traceEvents"]},
            require_names=("admission", "dispatch", "device", "reply"),
            require_nested=(("device", "dispatch"),))

        v1 = float(telemetry.counter("serving.batches").value)
        for i in range(5):
            assert _predict(url, "ts-%d" % i)[0] == 200
        assert records.wait(n_ok + n_bad + 5)
        timeseries.sample_once()
        assert timeseries.points("serving.batches")[-1][1] == v1 + 5
        assert (timeseries.rate("serving.batches") or 0) > 0
        code, ts_doc = _get(url, "/debug/timeseries")
        assert ts_doc["series"]["serving.batches"]["points"]
        assert ts_doc["rates"]["serving.batches"] > 0
        assert any(name.startswith("slo.error_budget_remaining")
                   for name in ts_doc["series"])
    finally:
        server.stop()


def test_trace_head_sampling_every_nth(armed, monkeypatch):
    monkeypatch.setattr(root.common.serving, "trace_sample_n", 3)
    server, url = _serve_registry()
    try:
        for i in range(9):
            assert _predict(url, "s-%d" % i)[0] == 200
        code, index = _get(url, "/debug/trace")
        assert index["enabled"] is True and len(index["rids"]) == 3
        unsampled = sorted({"s-%d" % i for i in range(9)}
                           - set(index["rids"]))[0]
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(url, "/debug/trace/%s" % unsampled)
        assert err.value.code == 404
        assert "trace_sample_n" in json.loads(err.value.read())["error"]
    finally:
        server.stop()


def test_trace_ring_is_bounded(armed, monkeypatch):
    monkeypatch.setattr(root.common.serving, "trace_capacity", 4)
    server, url = _serve_registry()
    try:
        for i in range(10):
            assert _predict(url, "b-%d" % i)[0] == 200
        code, index = _get(url, "/debug/trace")
        assert len(index["rids"]) == 4 and index["rids"][0] == "b-9"
    finally:
        server.stop()


def test_single_engine_server_traces_too(armed):
    engine = InferenceEngine(_model_source(), max_batch=4, device="cpu")
    batcher = MicroBatcher(engine, max_delay_ms=1.0, queue_limit=64,
                           timeout_ms=0).start()
    server = ServingServer(engine, batcher).start()
    url = "http://127.0.0.1:%d" % server.port
    try:
        assert _predict(url, "single-1", model=None)[0] == 200
        code, tree = _closed_tree(url, "single-1")
        assert tree["complete"] is True
        assert set(tree["span_kinds"]) == set(reqtrace.SPAN_KINDS)
        # the micro-batcher keeps no admitted ring: the oracle says so
        assert _get(url, "/admitted/single-1")[1] == {
            "rid": "single-1", "tracked": False, "admitted": False}
    finally:
        server.stop()
        batcher.stop()


def test_slo_excludes_client_faults_over_http(armed):
    server, url = _serve_registry()
    try:
        assert _predict(url, "good-1")[0] == 200
        assert _predict(url, "nf-1", model="nope")[0] == 404
        req = urllib.request.Request(
            url + "/predict/m", b'{"nope": 1}',
            {"Content-Type": "application/json", "X-Request-Id": "bb"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400
        err.value.read()
        code, status = _get(url, "/slo")
        assert list(status["models"]) == ["m"]
        assert status["models"]["m"]["good"] == 1
        assert status["models"]["m"]["bad"] == 0
    finally:
        server.stop()


def test_disabled_plane_adds_zero_compiles_and_touches_nothing(
        monkeypatch):
    monkeypatch.setattr(root.common.telemetry, "enabled", True)
    telemetry.reset()
    reqtrace.reset()
    timeseries.reset()
    assert slo.enabled() is False
    assert reqtrace.enabled() is False
    assert timeseries.enabled() is False

    def boom(*a, **k):
        raise AssertionError("disabled observability plane was touched")

    monkeypatch.setattr(slo.SloTracker, "record", boom)
    monkeypatch.setattr(reqtrace, "begin", boom)
    monkeypatch.setattr(reqtrace, "add_span", boom)
    monkeypatch.setattr(timeseries, "sample_once", boom)
    server, url = _serve_registry()
    engine = server.registry.peek("m")
    try:
        warm = engine.warmup_dispatches
        for i in range(6):
            code, doc, _ = _predict(url, "off-%d" % i, rows=1 + i % 3)
            assert code == 200 and doc["request_id"] == "off-%d" % i
        # no warmup ran again (the port's counterpart of "no compile")
        assert engine.warmup_dispatches == warm
        code, status = _get(url, "/slo")
        assert status["enabled"] is False and status["models"] == {}
        code, ts_doc = _get(url, "/debug/timeseries")
        assert ts_doc["enabled"] is False
        assert _get(url, "/debug/trace")[1] == {"enabled": False,
                                                "rids": []}
    finally:
        server.stop()


# -- against the JAX package's server ------------------------------------------

@pytest.fixture
def both_armed(armed, monkeypatch):
    jcfg = jax_root.common.serving
    monkeypatch.setattr(jax_root.common.telemetry, "enabled", True)
    for k, v in PLANE.items():
        monkeypatch.setattr(jcfg, k, v)
    jax_telemetry.reset()
    yield
    jax_telemetry.reset()


def test_replies_slo_and_oracle_as_jaxs_server(both_armed):
    server, url = _serve_registry()
    jax_server = JaxServer(registry=JaxRegistry(
        models={"m": _model_source()}, max_batch=4)).start()
    jurl = "http://127.0.0.1:%d" % jax_server.port
    try:
        for i, rows in enumerate((1, 2, 3, 4)):
            rid = "eq-%d" % i
            code, doc, headers = _predict(url, rid, rows=rows)
            jcode, jdoc, jheaders = _predict(jurl, rid, rows=rows)
            assert code == jcode == 200
            assert sorted(doc) == sorted(jdoc)
            numpy.testing.assert_allclose(doc["outputs"], jdoc["outputs"],
                                          rtol=0, atol=TOL)
            assert doc["argmax"] == jdoc["argmax"]
            assert float(headers["X-Serving-Ms"]) > 0
            assert headers["X-Request-Id"] == jheaders["X-Request-Id"]
            assert headers["X-Serving-Generation"] == \
                jheaders["X-Serving-Generation"]
        for surface in ("/slo", "/admitted/eq-1", "/admitted/never"):
            mine, theirs = _get(url, surface)[1], _get(jurl, surface)[1]
            assert sorted(mine) == sorted(theirs), surface
        mine, theirs = _get(url, "/slo")[1], _get(jurl, "/slo")[1]
        assert {k: v for k, v in mine["models"]["m"].items()} == \
            theirs["models"]["m"]
        assert _get(url, "/admitted/eq-1")[1]["admitted"] is True
        assert _get(url, "/admitted/never")[1]["admitted"] is False
        ok = _get(url, "/healthz")[1]
        assert ok["wire_port"] == server.wire_port and ok["wire_port"]
    finally:
        server.stop()
        jax_server.stop()
