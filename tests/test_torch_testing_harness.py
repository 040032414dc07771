"""The port's test harness (``znicz_tpu_torch/testing.py``) — the cases of
JAX ``tests/unit/test_testing_harness.py`` but the mesh's, on the CPU.

"Both backends" is the CPU (the plain versions) and the card (the
kernels); here the device pair points at two CPU runs, which drives the
same comparison logic, and without a card the default pair raises.
``build_fc_package_zip`` writes the arrays and manifest of JAX's.
"""

import io
import json
import time
import unittest
import zipfile

import numpy
import pytest
import torch

from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu import testing as jax_testing
from znicz_tpu_torch import testing as zt
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.units.all2all import All2AllTanh
from znicz_tpu_torch.units.pooling import MaxPooling

TWO_CPU_RUNS = (("cpu", "cpu"), ("cpu again", "cpu"))


@pytest.fixture
def two_cpu_runs(monkeypatch):
    monkeypatch.setattr(zt, "DEVICES", TWO_CPU_RUNS)


def _build_fc(wf, device, rand_seed=9):
    unit = All2AllTanh(wf, output_sample_shape=6, weights_stddev=0.05,
                       bias_stddev=0.05,
                       rand=prng.RandomGenerator().seed(rand_seed))
    unit.input = Array(numpy.linspace(-1, 1, 2 * 5).reshape(2, 5)
                       .astype(numpy.float32))
    unit.input.device = torch.device(device)
    unit.initialize(device=device)
    return unit


def test_run_both_backends_agree(two_cpu_runs):
    outs = zt.run_both_backends(_build_fc, atol=1e-5)
    assert outs["output"].shape == (2, 6)


def test_run_both_backends_on_the_pooling_unit_bit_for_bit(two_cpu_runs):
    x = numpy.random.RandomState(5).uniform(
        -1, 1, (2, 9, 9, 4)).astype(numpy.float32)

    def build(wf, device):
        unit = MaxPooling(wf, kx=3, ky=3, sliding=(2, 2))
        unit.input = Array(x.copy())
        unit.input.device = torch.device(device)
        unit.initialize(device=device)
        return unit
    outs = zt.run_both_backends(build, outputs=("output", "input_offset"),
                                atol=0)
    assert outs["output"].shape == (2, 4, 4, 4)
    assert outs["input_offset"].dtype == numpy.int32


def test_run_both_backends_catches_divergence(two_cpu_runs):
    calls = {"n": 0}

    def build(wf, device):
        unit = _build_fc(wf, device)
        calls["n"] += 1
        if calls["n"] == 2:   # poison the second run's weights
            unit.weights.map_write()
            unit.weights.mem[...] += 1.0
        return unit

    with pytest.raises(AssertionError, match="differs between backends"):
        zt.run_both_backends(build, atol=1e-5)


def test_run_both_backends_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zt.run_both_backends(lambda wf, device: built.append(device))
    assert built == []    # nothing was built before the check


def test_assert_rerun_stable_and_leak_detection():
    from znicz_tpu_torch.core.workflow import Workflow
    unit = _build_fc(Workflow(None), "cpu")
    zt.assert_rerun_stable(unit)

    class Leaky(object):
        def __init__(self):
            self.output = Array(numpy.zeros(3, numpy.float32))
            self.n = 0

        def run(self):
            self.n += 1
            self.output.map_write()
            self.output.mem[...] = self.n  # state leaks into outputs

    with pytest.raises(AssertionError, match="leaks state"):
        zt.assert_rerun_stable(Leaky())


def test_timeout_decorator():
    @zt.timeout(0.2)
    def slow():
        time.sleep(5)

    with pytest.raises(AssertionError, match="timeout"):
        slow()

    @zt.timeout(5)
    def fast():
        return 42

    assert fast() == 42


def test_accelerated_test_base_runs(two_cpu_runs):
    seeds = []

    class MyTest(zt.AcceleratedTest):
        def test_fc(self):
            seeds.append((prng.get(1).uniform(), prng.get(2).uniform()))
            self.assertBackendsAgree(_build_fc, atol=1e-5)
            self.assertRerunStable(_build_fc(self.workflow,
                                             self.cpu_device))

    suite = unittest.defaultTestLoader.loadTestsFromTestCase(MyTest)
    result = unittest.TextTestRunner(stream=io.StringIO(),
                                     verbosity=0).run(suite)
    assert result.wasSuccessful() and result.testsRun == 1
    # the prng streams seeded as JAX's AcceleratedTest seeds them
    prng.get(1).seed(1234)
    prng.get(2).seed(5678)
    assert seeds == [(prng.get(1).uniform(), prng.get(2).uniform())]


def test_harness_review_regressions(two_cpu_runs):
    """NaN outputs fail, empty output sets fail, shape mismatches fail,
    and AcceleratedTest's TIMEOUT wraps test methods (JAX's case)."""
    class NoOut(object):
        def run(self):
            pass

    with pytest.raises(AssertionError, match="no outputs"):
        zt.assert_rerun_stable(NoOut())

    state = {"n": 0}

    class Weird(object):
        def __init__(self, mem):
            self.output = Array(mem)

        def run(self):
            pass

    def build_nan(wf, device):
        state["n"] += 1
        mem = numpy.zeros((2, 3), numpy.float32)
        if state["n"] == 2:
            mem[0, 0] = numpy.nan
        return Weird(mem)

    with pytest.raises(AssertionError, match="differs between backends"):
        zt.run_both_backends(build_nan)

    def build_shape(wf, device):
        state["n"] += 1
        return Weird(numpy.zeros((2, 3) if state["n"] % 2 else (2, 1),
                                 numpy.float32))

    state["n"] = 0
    with pytest.raises(AssertionError, match="shape differs"):
        zt.run_both_backends(build_shape)

    with pytest.raises(AssertionError, match="no outputs to compare"):
        zt.run_both_backends(lambda wf, device: NoOut())

    class Hanging(zt.AcceleratedTest):
        TIMEOUT = 0.2

        def test_sleeps(self):
            time.sleep(5)

    suite = unittest.defaultTestLoader.loadTestsFromTestCase(Hanging)
    result = unittest.TextTestRunner(stream=io.StringIO(),
                                     verbosity=0).run(suite)
    assert not result.wasSuccessful()


def _zip_contents(path):
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
        arrays = {n: numpy.load(io.BytesIO(zf.read(n)))
                  for n in zf.namelist() if n.endswith(".npy")}
    return manifest, arrays


@pytest.mark.parametrize("dims,seed,scale,transposed", [
    ([784, 64, 64, 10], 42, 0.05, True),
    ([5, 3], 7, None, True),
    ([12, 8, 4], 3, 0.1, False)])
def test_build_fc_package_zip_equals_jax(tmp_path, dims, seed, scale,
                                         transposed):
    mine = zt.build_fc_package_zip(str(tmp_path / "torch.zip"), dims,
                                   seed=seed, scale=scale,
                                   weights_transposed=transposed)
    theirs = jax_testing.build_fc_package_zip(
        str(tmp_path / "jax.zip"), dims, seed=seed, scale=scale,
        weights_transposed=transposed)
    assert mine == str(tmp_path / "torch.zip")
    m_manifest, m_arrays = _zip_contents(mine)
    j_manifest, j_arrays = _zip_contents(theirs)
    assert m_manifest == j_manifest
    assert sorted(m_arrays) == sorted(j_arrays)
    for name, want in j_arrays.items():
        got = m_arrays[name]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert numpy.array_equal(got.view(numpy.uint8),
                                 want.view(numpy.uint8))


def test_the_package_serves_on_the_port(tmp_path):
    """The harness's package loads in the port's engine on the CPU."""
    from znicz_tpu_torch.serving.engine import InferenceEngine
    path = zt.build_fc_package_zip(str(tmp_path / "fc.zip"), [6, 4, 3],
                                   seed=2, scale=0.1)
    engine = InferenceEngine(path, max_batch=2, device="cpu")
    out = engine.predict(numpy.ones((2, 6), numpy.float32))
    assert out.shape == (2, 3)
    assert numpy.allclose(out.sum(axis=1), 1.0, atol=1e-6)
