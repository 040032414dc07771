"""The port's serving slice on the CPU against znicz_tpu's: a narrow
AlexNet-shaped package through both InferenceEngines (rtol 1e-4 /
atol 1e-6, float32 — different conv/matmul summation orders), the
package zip round trip, params_from_numpy fed from the JAX engine's
host parameters, the micro-batcher and the HTTP server, and the
full-width AlexNet sample's manifest."""

import gc
import http.client
import io
import json
import threading
import time
import weakref

import numpy
import pytest
import torch

from znicz_tpu import export as jax_export
from znicz_tpu.serving.engine import InferenceEngine as JaxEngine
from znicz_tpu_torch import export
from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.params import params_from_numpy
from znicz_tpu_torch.samples import alexnet
from znicz_tpu_torch.serving import accuracy, quant
from znicz_tpu_torch.serving import engine as engine_mod
from znicz_tpu_torch.serving.batcher import (MicroBatcher, QueueFullError,
                                             RequestTimeoutError)
from znicz_tpu_torch.serving.engine import InferenceEngine
from znicz_tpu_torch.serving.server import ServingServer

TOL = dict(rtol=1e-4, atol=1e-6)


def _fwd(**kw):
    kw.update(weights_filling="gaussian", bias_filling="constant")
    return kw


#: AlexNet's layer types in AlexNet's order, at narrow widths on a
#: 35x35x3 input; the second pool overhangs the edge (8 -> 4)
NARROW = [
    {"name": "conv1", "type": "conv_str",
     "->": _fwd(n_kernels=8, kx=5, ky=5, padding=(0, 0, 0, 0),
                sliding=(2, 2), weights_stddev=0.2, bias_stddev=0.1)},
    {"name": "pool1", "type": "max_pooling",
     "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"name": "norm1", "type": "norm", "n": 5, "alpha": 0.0001,
     "beta": 0.75},
    {"name": "grouping1", "type": "zero_filter", "grouping": 2},
    {"name": "conv2", "type": "conv_str",
     "->": _fwd(n_kernels=16, kx=3, ky=3, padding=(1, 1, 1, 1),
                sliding=(1, 1), weights_stddev=0.2, bias_stddev=0.1)},
    {"name": "pool2", "type": "max_pooling",
     "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"name": "fc", "type": "all2all",
     "->": _fwd(output_sample_shape=32, weights_stddev=0.1,
                bias_stddev=0.1)},
    {"name": "relu", "type": "activation_str"},
    {"name": "drop", "type": "dropout", "dropout_ratio": 0.5},
    {"name": "out", "type": "softmax",
     "->": _fwd(output_sample_shape=10, weights_stddev=0.3,
                bias_stddev=0)},
]


@pytest.fixture(scope="module")
def package():
    return alexnet.init_package(7, size=35, layers=NARROW)


@pytest.fixture(scope="module")
def jax_engine(package):
    return JaxEngine(package, max_batch=4)


@pytest.fixture(scope="module")
def engine(package):
    return InferenceEngine(package, max_batch=4, device="cpu")


def _images(n, seed=3):
    return numpy.random.RandomState(seed).uniform(
        -1, 1, (n, 35, 35, 3)).astype(numpy.float32)


def test_narrow_package_has_alexnet_layer_types(package):
    manifest, arrays = package
    assert [e["type"] for e in manifest["layers"]] == [
        "conv_str", "max_pooling", "norm", "conv_str", "max_pooling",
        "all2all", "activation_str", "dropout", "softmax"]
    conv2 = manifest["layers"][3]
    mask = arrays[conv2["arrays"]["zero_filter_mask"]]
    assert conv2["zero_filter_grouping"] == 2
    assert (arrays[conv2["arrays"]["weights"]][mask == 0] == 0).all()


@pytest.mark.parametrize("n", [1, 3, 4])
def test_engine_matches_jax_engine(engine, jax_engine, n):
    """Batches of 1, 3 (padded to the 4-bucket) and 4 rows."""
    x = _images(n)
    got = engine.predict(x)
    want = jax_engine.predict(x)
    assert got.shape == want.shape == (n, 10)
    numpy.testing.assert_allclose(got, want, **TOL)
    # the outputs discriminate: a constant reply would also "match"
    assert numpy.ptp(want) > 0.05


def test_engine_single_sample_and_shape_checks(engine):
    x = _images(2)
    numpy.testing.assert_allclose(engine.predict(x[0]),
                                  engine.predict(x[:1]), **TOL)
    with pytest.raises(ValueError, match="per-sample shape"):
        engine.predict(numpy.zeros((2, 34, 35, 3), numpy.float32))
    with pytest.raises(ValueError, match="exceeds max_batch"):
        engine.predict(numpy.zeros((5, 35, 35, 3), numpy.float32))
    assert engine.bucket_for(3) == 4 and engine.ready
    stats = engine.stats()
    assert stats["warm_buckets"] == [1, 2, 4] and stats["device"] == "cpu"


@pytest.mark.parametrize("dtype", ["f32", "f32-fast", "bf16", "int8",
                                   "fp8"])
def test_engine_serves_each_dtype(package, engine, dtype):
    """The four serving dtypes serve within their accuracy pins of the
    f32 engine; an unknown spelling still raises ValueError."""
    if dtype == "fp8":
        with pytest.raises(ValueError, match="unknown serving dtype"):
            InferenceEngine(package, device="cpu", dtype=dtype)
        return
    served = InferenceEngine(package, max_batch=4, device="cpu",
                             dtype=dtype)
    assert served.serve_dtype == quant.normalize_dtype(dtype)
    assert served.warm_buckets == (1, 2, 4)
    x = _images(4, seed=11)
    got, want = served.predict(x), engine.predict(x)
    assert got.dtype == numpy.float32 and got.shape == want.shape
    if dtype == "f32":
        assert numpy.array_equal(got, want)
    else:
        pin = accuracy.TOLERANCES[served.serve_dtype]["max_delta"]
        assert numpy.abs(got - want).max() <= pin


def test_params_from_jax_host_params(engine, jax_engine):
    """The JAX engine's host parameters, turned into the port's tensors,
    run through the port's forward give the JAX engine's replies."""
    m = jax_engine._model
    params = params_from_numpy(m.layers, m.host_params, "cpu")
    x = _images(4, seed=9)
    with torch.inference_mode():
        got = engine_mod.forward(m.layers, params, torch.from_numpy(x))
    numpy.testing.assert_allclose(got.numpy(), jax_engine.predict(x), **TOL)


def test_params_transposed_fc_weights():
    layers = [{"type": "all2all_tanh", "weights_transposed": True},
              {"type": "softmax"}]
    r = numpy.random.RandomState(1)
    host = [{"weights": r.randn(6, 4), "bias": r.randn(4)},
            {"weights": r.randn(3, 4).astype(numpy.float32),
             "bias": numpy.zeros(3, numpy.float32)}]
    params = params_from_numpy(layers, host, "cpu")
    assert tuple(params[0]["weights"].shape) == (4, 6)
    assert params[0]["weights"].dtype == torch.float32
    x = r.randn(2, 6).astype(numpy.float32)
    y = engine_mod.forward(layers, params, torch.from_numpy(x))
    h = 1.7159 * numpy.tanh(0.6666 * (x @ host[0]["weights"] +
                                      host[0]["bias"]))
    z = h @ host[1]["weights"].T
    e = numpy.exp(z - z.max(axis=1, keepdims=True))
    numpy.testing.assert_allclose(y.numpy(), e / e.sum(axis=1,
                                                       keepdims=True),
                                  **TOL)


def test_package_zip_round_trip(package, engine, tmp_path):
    manifest, arrays = package
    path = export.write_package(manifest, arrays, str(tmp_path / "m.zip"))
    m2, a2 = export.import_package(path)
    assert m2 == json.loads(json.dumps(manifest))
    assert sorted(a2) == sorted(arrays)
    for k in arrays:
        assert a2[k].dtype == arrays[k].dtype and (a2[k] == arrays[k]).all()
    # the JAX package reads what the port writes
    mj, aj = jax_export.import_package(path)
    assert mj == m2 and sorted(aj) == sorted(a2)
    x = _images(3, seed=4)
    from_zip = InferenceEngine(path, max_batch=4, device="cpu")
    numpy.testing.assert_allclose(from_zip.predict(x), engine.predict(x),
                                  rtol=0, atol=0)


def test_import_rejects_unknown_format_and_missing_arrays(package,
                                                          tmp_path):
    manifest, arrays = package
    future = dict(manifest, format=99)
    path = export.write_package(future, arrays, str(tmp_path / "f.zip"))
    with pytest.raises(ValueError, match="unknown package format"):
        export.import_package(path)
    some = {k: v for k, v in arrays.items() if "layer0_bias" not in k}
    path = export.write_package(manifest, some, str(tmp_path / "m.zip"))
    with pytest.raises(ValueError, match="missing array"):
        export.import_package(path)


def test_alexnet_sample_full_width_manifest():
    """Full-width AlexNet, built (not run): shapes, grouping folds and
    the serving manifest."""
    manifest, arrays = alexnet.init_package(0)
    layers = manifest["layers"]
    engine_mod._validate_layers(layers)
    assert manifest["input_sample_shape"] == [227, 227, 3]
    assert manifest["serving"]["buckets"] == [1, 2, 4, 8, 16, 32, 64]
    shapes = {e["name"]: arrays[e["arrays"]["weights"]].shape
              for e in layers if "weights" in e["arrays"]}
    assert shapes == {
        "conv_str1": (96, 363), "conv_str2": (256, 2400),
        "conv_str3": (384, 2304), "conv_str4": (384, 3456),
        "conv_str5": (256, 3456), "fc6": (4096, 9216),
        "fc7": (4096, 4096), "fc_softmax8": (1000, 4096)}
    n_params = sum(v.size for k, v in arrays.items()
                   if "zero_filter" not in k)
    assert n_params == 62378344
    folded = [e for e in layers if "zero_filter_mask" in e["arrays"]]
    assert [e["name"] for e in folded] == ["conv_str2", "conv_str3",
                                           "conv_str5", "fc6"]
    for e in folded:
        w = arrays[e["arrays"]["weights"]]
        k = numpy.arange(w.shape[0])[:, None] % 2
        c = numpy.arange(w.shape[1])[None, :] % 2
        assert (w[k == c] == 0).all() and (w[k != c] != 0).all()
    assert all(v.dtype == numpy.float32 for v in arrays.values())


# -- micro-batcher -------------------------------------------------------

def test_batcher_coalesces_and_scatters():
    calls = []

    def twice(x, request_ids=None):
        calls.append(len(x))
        return x * 2

    b = MicroBatcher(twice, max_batch=8, max_delay_ms=200,
                     timeout_ms=0).start()
    try:
        futures = [b.submit(numpy.full((2, 3), i, numpy.float32))
                   for i in range(3)]
        out = [f.result(timeout=10) for f in futures]
    finally:
        b.stop()
    assert calls == [6]
    for i, y in enumerate(out):
        assert (y == 2 * i).all() and y.shape == (2, 3)


def _blocked_batcher(**kw):
    """A batcher whose dispatch blocks until the returned event is set."""
    release = threading.Event()

    def blocked(x, request_ids=None):
        release.wait(10)
        return x

    return MicroBatcher(blocked, max_batch=4, max_delay_ms=0,
                        **kw).start(), release


def _wait_idle_queue(b):
    deadline = time.monotonic() + 10
    while b.queued_rows and time.monotonic() < deadline:
        time.sleep(0.005)
    assert b.queued_rows == 0


def test_batcher_queue_full_and_deadline():
    b, release = _blocked_batcher(queue_limit=2, timeout_ms=0)
    try:
        first = b.submit(numpy.zeros((1, 3)))
        _wait_idle_queue(b)  # the worker holds it, blocked
        late = b.submit(numpy.zeros((2, 3)), timeout_ms=1)
        with pytest.raises(QueueFullError):
            b.submit(numpy.zeros((1, 3)))
        time.sleep(0.02)  # the queued request's deadline passes
        release.set()
        assert first.result(timeout=10).shape == (1, 3)
        with pytest.raises(RequestTimeoutError):
            late.result(timeout=10)
    finally:
        release.set()
        b.stop()


def test_warmups_run_on_one_long_lived_thread(package, monkeypatch):
    """Every engine warms up on the process's one warm-up thread,
    whatever thread loads it (a handler thread would take a cuBLAS
    handle, and a workspace, of its own on the card); a predict runs on
    its caller's thread."""
    seen = []
    dispatch = InferenceEngine._dispatch

    def recording(self, m, params, x):
        seen.append((threading.current_thread(), len(x)))
        return dispatch(self, m, params, x)

    monkeypatch.setattr(InferenceEngine, "_dispatch", recording)
    engines = []
    loaders = [threading.Thread(target=lambda: engines.append(
        InferenceEngine(package, max_batch=2, device="cpu")))
        for _ in range(2)]
    for t in loaders:
        t.start()
    for t in loaders:
        t.join(60)
    assert len(engines) == 2 and all(e.ready for e in engines)
    warm = {t for t, _ in seen}
    assert len(seen) == 4 and len(warm) == 1  # buckets 1 and 2, twice
    (thread,) = warm
    assert thread.name == "znicz:warmup" and thread.is_alive()
    assert thread not in loaders
    del seen[:]
    engines[0].predict(_images(1))
    assert seen == [(threading.current_thread(), 1)]
    # the warm-up thread keeps no engine it warmed: a removed model's
    # parameters go with its last reference
    gone = [weakref.ref(e) for e in engines]
    del engines[:]
    gc.collect()
    assert [ref() for ref in gone] == [None, None]


def test_on_warm_thread_result_error_and_nesting():
    here = threading.current_thread()
    there = engine_mod.on_warm_thread(threading.current_thread)
    assert there is not here and there.name == "znicz:warmup"
    # a job on the warm-up thread runs a nested one inline
    assert engine_mod.on_warm_thread(lambda: engine_mod.on_warm_thread(
        threading.current_thread)) is there
    with pytest.raises(ZeroDivisionError):
        engine_mod.on_warm_thread(lambda: 1 // 0)
    assert engine_mod.on_warm_thread(lambda: 7) == 7


def test_batcher_threads_take_their_blas_handles_as_they_start(
        monkeypatch):
    """Each dispatch slot takes its cuBLAS handle when it starts, once
    the process uses the card (here a stand-in for one), not at its
    first product; without the card nothing is taken."""
    from znicz_tpu_torch.serving.continuous import ContinuousBatcher
    taken = []
    lock = threading.Lock()

    def handle():
        with lock:
            taken.append(threading.current_thread().name)
        return 1

    monkeypatch.setattr(torch.cuda, "current_blas_handle", handle)

    def ident(x, request_ids=None):
        return x

    engine_mod.claim_blas_handle()
    assert taken == []  # no card in this process
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    batchers = [ContinuousBatcher(ident, max_inflight=3).start(),
                MicroBatcher(ident, max_batch=4).start()]
    try:
        deadline = time.monotonic() + 10
        while len(taken) < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        for b in batchers:
            b.stop()
    assert sorted(taken) == ["znicz:continuous-0", "znicz:continuous-1",
                             "znicz:continuous-2", "znicz:micro-batcher"]


# -- HTTP front end ------------------------------------------------------

def _call(server, method, path, body=None, ctype="application/json"):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=30)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": ctype} if body else {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


@pytest.fixture
def telemetry_on():
    was = root.common.telemetry.get("enabled")
    telemetry.enable()
    yield
    root.common.telemetry.enabled = was


def test_server_predict_json_and_npy(engine, telemetry_on):
    server = ServingServer(engine, port=0).start()
    try:
        x = _images(3, seed=5)
        want = engine.predict(x)
        status, raw, headers = _call(server, "POST", "/predict",
                                     json.dumps({"inputs": x.tolist()}))
        assert status == 200 and headers.get("X-Request-Id")
        doc = json.loads(raw)
        numpy.testing.assert_allclose(doc["outputs"], want, **TOL)
        assert doc["argmax"] == want.argmax(axis=1).tolist()
        buf = io.BytesIO()
        numpy.save(buf, x[:1])
        status, raw, _ = _call(server, "POST", "/predict", buf.getvalue(),
                               "application/octet-stream")
        assert status == 200
        numpy.testing.assert_allclose(numpy.load(io.BytesIO(raw)),
                                      want[:1], **TOL)
        status, raw, _ = _call(server, "POST", "/predict", b"{not json")
        assert status == 400
        status, raw, _ = _call(server, "POST", "/predict", json.dumps(
            {"inputs": numpy.zeros((2, 7)).tolist()}))
        assert status == 400
        status, raw, _ = _call(server, "GET", "/healthz")
        assert status == 200 and json.loads(raw)["ready"] is True
        status, raw, _ = _call(server, "GET", "/metrics")
        assert status == 200
        assert b"znicz_serving_predictions_bucket_4" in raw
        assert b"znicz_serving_batch_rows_count" in raw
        assert _call(server, "GET", "/nope")[0] == 404
    finally:
        server.stop()


def test_server_413_429_and_draining(engine, monkeypatch):
    b, release = _blocked_batcher(queue_limit=1, timeout_ms=0)
    server = ServingServer(engine, batcher=b, port=0).start()
    try:
        body = json.dumps({"inputs": _images(1).tolist()})
        monkeypatch.setattr(root.common.serving, "max_body_bytes", 100)
        assert _call(server, "POST", "/predict", body)[0] == 413
        monkeypatch.setattr(root.common.serving, "max_body_bytes", 16 << 20)
        held = b.submit(_images(1))
        _wait_idle_queue(b)
        queued = b.submit(_images(1))
        status, raw, _ = _call(server, "POST", "/predict", body)
        assert status == 429 and "queue full" in json.loads(raw)["error"]
        release.set()
        held.result(timeout=10)
        queued.result(timeout=10)
        server._draining = True
        assert _call(server, "POST", "/predict", body)[0] == 503
        assert _call(server, "GET", "/healthz")[0] == 503
    finally:
        release.set()
        server.stop()
        b.stop()


def test_serve_cli_subprocess(package, tmp_path):
    """``python -m znicz_tpu_torch serve PKG.zip --port 0`` serves, and
    drains to exit 0 on SIGTERM."""
    import os
    import re
    import signal
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = export.write_package(*package, str(tmp_path / "m.zip"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "znicz_tpu_torch", "serve", path,
         "--port", "0", "--device", "cpu", "--max-batch", "4"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        banner = proc.stdout.readline()
        port = int(re.search(r"http://[\d.]+:(\d+)/", banner).group(1))
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/predict",
                     body=json.dumps({"inputs": _images(2).tolist()}))
        resp = conn.getresponse()
        doc = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and len(doc["argmax"]) == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
