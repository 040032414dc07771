"""``f32-fast`` and ``root.common.serving.latency_bucket_max`` on the
CPU, held to ``tests/functional/test_latency_fastpath.py``: buckets up
to the knob run the fast FC layer (within its 1e-5 pin of ``f32``),
larger ones the f32 layer, bit-equal to ``--dtype f32``; the knob is
read at load, sits in ``compile_key`` and in ``/models`` as the JAX
engine's does, and a changed knob is a new key."""

import numpy
import pytest

from test_torch_mnist import _one_torch_thread  # noqa: F401
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.serving.engine import InferenceEngine as JaxEngine
from znicz_tpu.testing import build_fc_package_zip
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.serving import accuracy, engine as engine_mod
from znicz_tpu_torch.serving.engine import InferenceEngine
from znicz_tpu_torch.serving.registry import ModelRegistry
from znicz_tpu_torch.serving.server import ServingServer

DIMS = [96, 64, 48, 10]
BUCKETS = (1, 2, 4, 8, 16)


@pytest.fixture
def package(tmp_path):
    return build_fc_package_zip(str(tmp_path / "fc.zip"), DIMS, seed=11,
                                scale=0.2)


@pytest.fixture
def threshold(monkeypatch):
    def set_(value):
        for cfg in (root, jax_root):
            monkeypatch.setattr(cfg.common.serving, "latency_bucket_max",
                                value)
    set_(2)
    return set_


def _rows(n, seed=3):
    return numpy.random.RandomState(seed).uniform(
        -1.0, 1.0, (n, DIMS[0])).astype(numpy.float32)


def _engine(package, dtype=None, **kw):
    return InferenceEngine(package, buckets=BUCKETS, device="cpu",
                           dtype=dtype, **kw)


@pytest.mark.parametrize("rows", [3, 4, 5, 8, 16])
def test_buckets_over_the_threshold_are_bit_equal_to_f32(package, threshold,
                                                         rows):
    strict, fast = _engine(package), _engine(package, "f32-fast")
    x = _rows(rows)
    assert fast.bucket_for(rows) > 2
    assert numpy.array_equal(fast.predict(x).view(numpy.uint32),
                             strict.predict(x).view(numpy.uint32))


@pytest.mark.parametrize("rows", [1, 2])
def test_buckets_up_to_the_threshold_hold_the_fast_pin(package, threshold,
                                                       rows):
    strict, fast = _engine(package), _engine(package, "f32-fast")
    x = _rows(rows)
    d = numpy.abs(fast.predict(x) - strict.predict(x)).max()
    assert d <= accuracy.TOLERANCES["f32_fast"]["max_delta"]


def test_the_layer_each_bucket_runs(package, threshold, monkeypatch):
    """Which layer a bucket takes: the fast one up to the knob, the
    strict one over it, never both."""
    calls = []
    for name in ("_apply_fast_layer", "apply_layer"):
        real = getattr(engine_mod, name)

        def spy(entry, params, y, _real=real, _name=name):
            calls.append((_name, y.shape[0]))
            return _real(entry, params, y)
        monkeypatch.setattr(engine_mod, name, spy)
    fast = _engine(package, "f32-fast", warmup=False)
    for rows in (1, 2, 3):
        fast.predict(_rows(rows))
    by_bucket = {}
    for name, bucket in calls:
        by_bucket.setdefault(bucket, set()).add(name)
    assert by_bucket == {1: {"_apply_fast_layer"},
                         2: {"_apply_fast_layer"},
                         4: {"apply_layer"}}


def test_the_strict_layer_keeps_one_resident_copy(package, threshold):
    strict, fast = _engine(package), _engine(package, "f32-fast")
    assert fast.device_bytes == strict.device_bytes
    fc = [p["weights"] for p in fast.params if "weights" in p]
    ref = [p["weights"] for p in strict.params if "weights" in p]
    assert fc[0].shape == (DIMS[1], DIMS[0])     # (out, in), as f32's
    assert all(a.is_contiguous() and (a == b).all()
               for a, b in zip(fc, ref))


def test_compile_key_carries_the_knob_as_jaxs(package, threshold):
    """The key equalities of JAX's fast-path tests, on the port's key:
    default and f32 share it, fast never aliases strict, two fast loads
    under different thresholds differ."""
    def keys(cls, **kw):
        default = cls(package, max_batch=8, **kw)
        strict = cls(package, max_batch=8, dtype="f32", **kw)
        fast = cls(package, max_batch=8, dtype="f32-fast", **kw)
        threshold(0)
        fast0 = cls(package, max_batch=8, dtype="f32-fast", **kw)
        threshold(2)
        return (default.compile_key == strict.compile_key,
                fast.compile_key != strict.compile_key,
                fast.compile_key != fast0.compile_key,
                fast.stats()["latency_bucket_max"],
                fast0.stats()["latency_bucket_max"],
                "latency_bucket_max" in strict.stats())
    assert keys(InferenceEngine, device="cpu") == keys(JaxEngine) == \
        (True, True, True, 2, 0, False)


def test_a_changed_knob_is_a_new_generation_key(package, threshold):
    fast = _engine(package, "f32-fast")
    warm = fast.warmup_dispatches
    fast.load(package)                       # same key: warm set kept
    assert fast.warmup_dispatches == warm
    key = fast.compile_key
    threshold(4)
    fast.load(package)
    assert fast.compile_key != key
    assert fast.warmup_dispatches == warm + len(BUCKETS)
    assert fast.stats()["latency_bucket_max"] == 4
    # bucket 4 now takes the fast layer: within the pin, no longer equal
    x = _rows(3)
    d = numpy.abs(fast.predict(x) - _engine(package).predict(x)).max()
    assert d <= accuracy.TOLERANCES["f32_fast"]["max_delta"]


def test_models_reports_the_knob(package, threshold):
    import http.client
    import json
    registry = ModelRegistry(max_batch=4, device="cpu")
    registry.add("fast", package, dtype="f32-fast")
    registry.add("strict", package)
    srv = ServingServer(registry=registry, port=0).start()
    try:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        conn.request("GET", "/models")
        doc = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        srv.stop()
    assert doc["models"]["fast"]["latency_bucket_max"] == 2
    assert doc["models"]["fast"]["serve_dtype"] == "f32_fast"
    assert "latency_bucket_max" not in doc["models"]["strict"]
