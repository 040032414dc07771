"""The port's histogram accumulators and labels printer
(``units/{accumulator,labels_printer}.py``) against the JAX package's,
on the CPU.

* ``FixAccumulator`` (relu and tanh): values under ``min``, at ``min``
  (JAX's control flow sends them to the overflow bar), inside, at
  ``max`` and over it, in float32 and float64, over several fires with
  and without a reset: the bars equal JAX's bar for bar.
* ``RangeAccumulator``: a widening sequence of fires (re-binned by bin
  centres), a reset that hands the bars out, the degenerate single bin
  and a widening from it: ``x`` / ``y`` / ``x_out`` / ``y_out`` equal
  JAX's, in float32 and float64.
* ``LabelsPrinter``: its counter equals JAX's over several fires.
* A fire reads its input from the device once (an Array whose device
  copy is the newer).
"""

import numpy
import pytest
import torch

from znicz_tpu.core.memory import Array as JaxArray
from znicz_tpu.core.workflow import Workflow as JaxWorkflow
from znicz_tpu.units.accumulator import FixAccumulator as JaxFix
from znicz_tpu.units.accumulator import RangeAccumulator as JaxRange
from znicz_tpu.units.labels_printer import LabelsPrinter as JaxPrinter
from znicz_tpu_torch.core import memory
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.units.accumulator import FixAccumulator, \
    RangeAccumulator
from znicz_tpu_torch.units.labels_printer import LabelsPrinter

DTYPES = [numpy.float32, numpy.float64]


def _pair(jax_cls, cls, **kwargs):
    j, t = jax_cls(JaxWorkflow(None), **kwargs), cls(Workflow(None),
                                                     **kwargs)
    return j, t


def _feed(j, t, values):
    """Both units' input set to ``values`` (the port's as a device copy
    newer than the host's), both run."""
    j.input = JaxArray(values.copy())
    t.input = Array(name="input")
    t.input.set_dev(torch.from_numpy(values.copy()))
    j.run()
    t.run()


def _fix_fires(kind, dtype):
    lo, hi = (0, 10000) if kind == "relu" else (-1.7159, 1.7159)
    r = numpy.random.RandomState(4)
    edges = numpy.array([lo, hi, numpy.nextafter(lo, -numpy.inf),
                         numpy.nextafter(hi, numpy.inf), lo - 1, hi + 1,
                         (lo + hi) / 2], numpy.float64)
    return [
        edges.astype(dtype),
        r.uniform(lo - (hi - lo) / 4, hi + (hi - lo) / 4,
                  (6, 50)).astype(dtype),
        numpy.full(9, lo, dtype),
        r.uniform(lo, hi, 333).astype(dtype),
    ]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,bars", [("relu", 200), ("tanh", 200),
                                       ("tanh", 7), ("relu", 1)])
@pytest.mark.parametrize("reset", [True, False])
def test_fix_accumulator_bars_equal_jax(kind, bars, dtype, reset):
    j, t = _pair(JaxFix, FixAccumulator, type=kind, bars=bars)
    j.initialize()
    t.initialize(device="cpu")
    for values in _fix_fires(kind, dtype):
        j.reset_flag <<= reset
        t.reset_flag <<= reset
        _feed(j, t, values)
        assert t.output.mem.dtype == numpy.int64
        assert numpy.array_equal(t.output.mem, j.output.mem)
        assert t.n_bars == j.n_bars == [bars + 2]
    assert (t.min, t.max) == (j.min, j.max)
    # a value at min lands in the overflow bar, as in JAX
    if reset:
        _feed(j, t, numpy.full(3, t.min, dtype))
        assert t.output.mem[-1] == 3 and t.output.mem[0] == 0


def test_fix_accumulator_refuses_an_unknown_type():
    t = FixAccumulator(Workflow(None), type="sigmoid")
    t.initialize(device="cpu")
    t.input = Array(numpy.zeros(3, numpy.float32))
    with pytest.raises(ValueError, match="Unsupported type sigmoid"):
        t.run()


def _range_fires(dtype):
    r = numpy.random.RandomState(8)
    return [
        numpy.full(5, 0.25, dtype),                   # the single bin
        numpy.full(3, 0.25, dtype),                   # stays single
        r.uniform(0.0, 1.0, 40).astype(dtype),        # widens from it
        r.uniform(0.2, 0.8, 40).astype(dtype),        # inside
        r.uniform(-2.0, 0.5, 40).astype(dtype),       # widens down
        r.uniform(0.5, 3.0, (4, 10)).astype(dtype),   # widens up
        numpy.zeros(0, dtype),                        # nothing to add
    ]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bars", [20, 3])
def test_range_accumulator_equals_jax(dtype, bars):
    j, t = _pair(JaxRange, RangeAccumulator, bars=bars)
    j.initialize()
    t.initialize(device="cpu")
    for i, values in enumerate(_range_fires(dtype) * 2):
        reset = i == 7        # the second pass starts with a reset
        j.reset_flag <<= reset
        t.reset_flag <<= reset
        _feed(j, t, values)
        assert (t.x, t.y, t.x_out, t.y_out) == (j.x, j.y, j.x_out, j.y_out)
        assert (t.gl_min, t.gl_max) == (j.gl_min, j.gl_max)
    assert t.y_out and len(t.x) == bars


@pytest.mark.parametrize("fires", [1, 4])
def test_labels_printer_counter_equals_jax(fires):
    r = numpy.random.RandomState(fires)
    j, t = _pair(JaxPrinter, LabelsPrinter, top_number=3)
    j.initialize()
    t.initialize(device="cpu")
    for _ in range(fires):
        _feed(j, t, r.randint(0, 7, 25).astype(numpy.int32))
    assert dict(t.counter) == dict(j.counter)
    assert sum(t.counter.values()) == 25 * fires
    t.print_top()
    t.reset()
    assert not t.counter


@pytest.mark.parametrize("cls,kwargs", [
    (FixAccumulator, {"type": "relu"}), (RangeAccumulator, {}),
    (LabelsPrinter, {})])
def test_a_fire_reads_the_device_once(monkeypatch, cls, kwargs):
    reads = []
    real = memory._to_host
    monkeypatch.setattr(memory, "_to_host",
                        lambda t: reads.append(t.shape) or real(t))
    unit = cls(Workflow(None), **kwargs)
    unit.initialize(device="cpu")
    for _ in range(3):
        unit.input = Array(name="input")
        unit.input.set_dev(torch.arange(12, dtype=torch.float32 if
                                        cls is not LabelsPrinter
                                        else torch.int32))
        unit.run()
    assert len(reads) == 3
