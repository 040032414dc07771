"""The port's tail-latency module (``znicz_tpu_torch/serving/latency.py``)
held against ``znicz_tpu/serving/latency.py``, after
``tests/unit/test_latency_quantiles.py`` and the scenario cases of
``tests/functional/test_latency_fastpath.py``:

* ``exact_percentile`` and ``quantile_summary`` equal JAX's exactly
  (tolerance 0) on the same samples, seeded with numpy, and on the
  hand-computed sets of the JAX cases;
* the scenario series land in the same labelled histograms;
* the runners (steady, cold bucket, evict and restore, breaker probe)
  answer right on a small port engine (784-32-10 on the CPU): each
  reply equals the engine's own quiet reply bit for bit, and the JAX
  engine's reply on the same package within 1e-5.
"""

import numpy
import pytest

from test_torch_mnist import _one_torch_thread, _restored  # noqa: F401
from znicz_tpu.serving import latency as jax_latency
from znicz_tpu.serving.engine import InferenceEngine as JaxEngine
from znicz_tpu.testing import build_fc_package_zip
from znicz_tpu_torch.core import faults, telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.serving import latency
from znicz_tpu_torch.serving.engine import InferenceEngine

N_IN = 784
TOL = 1e-5


@pytest.fixture(autouse=True)
def _telemetry_isolated():
    saved = root.common.telemetry.get("enabled")
    telemetry.reset()
    yield
    telemetry.reset()
    root.common.telemetry.enabled = saved


# -- exact_percentile -------------------------------------------------------

def test_empty_returns_none():
    assert latency.exact_percentile([], 50) is None
    assert latency.exact_percentile((), 99.9) is None


def test_single_sample_is_every_quantile():
    for q in (0, 50, 95, 99, 99.9, 100):
        assert latency.exact_percentile([7.5], q) == 7.5


def test_known_small_sets_exact():
    data = [1.0, 2.0, 3.0, 4.0]
    assert latency.exact_percentile(data, 50) == 2.5
    assert latency.exact_percentile(data, 0) == 1.0
    assert latency.exact_percentile(data, 100) == 4.0
    assert latency.exact_percentile(data, 25) == pytest.approx(1.75)
    data = [float(v) for v in range(1, 102)]
    assert latency.exact_percentile(data, 99) == pytest.approx(100.0)
    data = [float(v) for v in range(1, 11)]
    assert latency.exact_percentile(data, 99.9) == pytest.approx(9.991)


def test_ties_and_unsorted_and_clamped():
    assert latency.exact_percentile([1.0, 2.0, 2.0, 2.0, 9.0], 50) == 2.0
    assert latency.exact_percentile([3.0, 3.0], 99) == 3.0
    assert latency.exact_percentile([4.0, 1.0, 3.0, 2.0], 50) == 2.5
    assert latency.exact_percentile([5.0, 6.0], -3) == 5.0
    assert latency.exact_percentile([5.0, 6.0], 250) == 6.0


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 2), (2, 10), (3, 999),
                                    (4, 1000), (5, 4097)])
def test_percentiles_equal_jaxs_and_numpys(seed, n):
    samples = numpy.random.RandomState(seed).lognormal(-5.0, 1.0, n)
    for q in (-1.0, 0.0, 12.5, 50.0, 95.0, 99.0, 99.9, 100.0, 120.0):
        got = latency.exact_percentile(samples, q)
        assert got == jax_latency.exact_percentile(samples, q)
        assert got == pytest.approx(numpy.percentile(
            samples, min(max(q, 0.0), 100.0)), rel=1e-12)
    assert latency.quantile_summary(samples) == \
        jax_latency.quantile_summary(samples)


# -- quantile_summary -------------------------------------------------------

def test_quantile_summary_keys_and_units():
    s = latency.quantile_summary([0.001, 0.002, 0.003, 0.004])
    assert s["count"] == 4
    assert s["p50_ms"] == pytest.approx(2.5)
    assert s["p999_ms"] == pytest.approx(3.997)
    assert s["min_ms"] == pytest.approx(1.0)
    assert s["max_ms"] == pytest.approx(4.0)
    assert s["mean_ms"] == pytest.approx(2.5)
    assert set(s) >= {"p50_ms", "p95_ms", "p99_ms", "p999_ms"}


def test_quantile_summary_empty_is_nulls_not_zeros():
    s = latency.quantile_summary([])
    assert s == jax_latency.quantile_summary([])
    assert s["count"] == 0
    assert s["p99_ms"] is None and s["mean_ms"] is None


# -- scenario series --------------------------------------------------------

def test_record_scenario_unknown_name_is_loud():
    with pytest.raises(ValueError, match="unknown tail-latency"):
        latency.record_scenario("warp_drive", 0.1)


def test_record_scenario_lands_in_labeled_histogram():
    root.common.telemetry.enabled = True
    latency.record_scenario("evict_restore", 0.25, model="m1")
    h = telemetry.histogram(
        "serving.tail_seconds.model_m1.scenario_evict_restore")
    assert h.count == 1 and h.sum == pytest.approx(0.25)


def test_record_scenario_disabled_is_noop():
    root.common.telemetry.enabled = False
    latency.record_scenario("steady", 0.1)
    root.common.telemetry.enabled = True
    assert telemetry.histogram(
        "serving.tail_seconds.scenario_steady").count == 0


# -- the scenario runners on a port engine ------------------------------------

@pytest.fixture(scope="module")
def package(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("latency") / "m.zip")
    return build_fc_package_zip(path, [N_IN, 32, 10], seed=11, scale=0.1)


def _rows(n, seed=3):
    return numpy.random.RandomState(seed).uniform(
        -1, 1, (n, N_IN)).astype(numpy.float32)


def _engine(package, **kwargs):
    kwargs.setdefault("max_batch", 8)
    return InferenceEngine(package, device="cpu", **kwargs)


def _jax_reply(package, x):
    return numpy.asarray(JaxEngine(package, max_batch=8).predict(x))


def test_steady_runner_answers_and_times(package):
    root.common.telemetry.enabled = True
    eng = _engine(package, name="st")
    x = _rows(1)
    samples, elapsed = latency.run_steady(eng, x, n=20)
    assert len(samples) == 20 and elapsed >= sum(samples) * 0.5
    assert telemetry.histogram(
        "serving.tail_seconds.model_st.scenario_steady").count == 20
    numpy.testing.assert_allclose(eng.predict(x), _jax_reply(package, x),
                                  rtol=0, atol=TOL)


def test_evict_restore_runner_answers_right(package):
    root.common.telemetry.enabled = True
    eng = _engine(package, name="lf")
    x = _rows(1)
    y0 = eng.predict(x)
    samples, replies = latency.run_evict_restore(eng, x, n=2)
    assert len(samples) == 2 and all(s > 0 for s in samples)
    for y in replies:
        assert (y == y0).all()
    numpy.testing.assert_allclose(y0, _jax_reply(package, x), rtol=0,
                                  atol=TOL)
    assert telemetry.histogram(
        "serving.tail_seconds.model_lf.scenario_evict_restore").count == 2
    assert eng.resident and eng.ready


def test_breaker_probe_runner_answers_right(package):
    root.common.telemetry.enabled = True
    eng = _engine(package, name="lf2")
    x = _rows(1)
    y0 = eng.predict(x)
    with _restored(root.common.faults, root.common.retry,
                   root.common.serving):
        samples, replies = latency.run_breaker_probe(eng, x, trials=2)
    faults.reset()
    assert len(samples) == 2
    for y in replies:
        assert (y == y0).all()
    assert telemetry.histogram(
        "serving.tail_seconds.model_lf2.scenario_breaker_probe").count == 2
    assert (eng.predict(x) == y0).all()
    assert eng.stats()["breakers"]["1"]["state"] == "closed"


def test_cold_bucket_runner_hits_every_bucket(package):
    root.common.telemetry.enabled = True
    samples = latency.run_cold_bucket(
        lambda: InferenceEngine(package, buckets=(1, 2), device="cpu",
                                warmup=False), (N_IN,), trials=2)
    assert len(samples) == 4
    assert telemetry.histogram(
        "serving.tail_seconds.scenario_cold_bucket").count == 4
