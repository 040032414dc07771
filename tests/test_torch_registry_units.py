"""The rest of the port's layer registry against the JAX package's
units, on the CPU, in float64: ``Cutter`` / ``GDCutter``, ``Cutter1D``,
``ZeroFiller``, ``Multiplier`` / ``GDMultiplier``, ``Summator`` /
``GDSummator``, ``ResizableAll2All`` (grow, then shrink) and
``GDRProp``, and the "gabor" weight filling (``fill_gabor_filters`` and
a conv filled with it).

Each case is one of ``tests/unit/test_misc_units.py:21-247`` and
``tests/unit/test_parity_holes.py:80-110``, run in both packages from
the same seeded numpy input (the JAX units on the JAX CPU device, the
port's with ``device="cpu"``); every array it produces, forward and
GD, is compared.  Bit-equal where the computation is a copy, a mask,
an elementwise product or sum, or the same host draws (cutter,
Cutter1D, zero filler, multiplier, summator, the resized weights, the
gabor banks); within 1e-12 of the tensor's largest magnitude where a
matrix product or a convolution enters (the resized layer's and the
gabor conv's outputs, and every RProp array: its steps follow the
gradient's sign).
"""

import numpy
import pytest
import torch

from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.memory import Array as JaxArray
from znicz_tpu.core.workflow import DummyWorkflow
from znicz_tpu.units import all2all as jax_all2all
from znicz_tpu.units import conv as jax_conv
from znicz_tpu.units import cutter as jax_cutter
from znicz_tpu.units import multiplier as jax_multiplier
from znicz_tpu.units import resizable_all2all as jax_resizable
from znicz_tpu.units import rprop_gd as jax_rprop
from znicz_tpu.units import summator as jax_summator
from znicz_tpu.units import zerofilling as jax_zerofilling
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.accelerated_units import AcceleratedWorkflow
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.units import (all2all, conv, cutter, multiplier,
                                   resizable_all2all, rprop_gd, summator,
                                   zerofilling)

RTOL = 1e-12

MODULES = {
    "jax": dict(all2all=jax_all2all, conv=jax_conv, cutter=jax_cutter,
                multiplier=jax_multiplier, resizable=jax_resizable,
                rprop=jax_rprop, summator=jax_summator,
                zerofilling=jax_zerofilling, prng=jax_prng),
    "torch": dict(all2all=all2all, conv=conv, cutter=cutter,
                  multiplier=multiplier, resizable=resizable_all2all,
                  rprop=rprop_gd, summator=summator,
                  zerofilling=zerofilling, prng=prng)}


class _Pkg(object):
    """One package's units, workflow, Arrays and device."""

    def __init__(self, name):
        self.name = name
        self.m = MODULES[name]
        self.wf = DummyWorkflow() if name == "jax" else \
            AcceleratedWorkflow(None)
        self.device = JaxDevice() if name == "jax" else "cpu"

    def array(self, value):
        if self.name == "jax":
            return JaxArray(value.copy())
        arr = Array(value.copy())
        arr.device = torch.device("cpu")
        return arr


def _host(arr):
    return numpy.array(arr.mem)


def _cutter(pkg, r):
    x = r.uniform(-1, 1, (2, 6, 7, 3))
    err = r.uniform(-1, 1, (2, 3, 5, 3))
    cut = pkg.m["cutter"].Cutter(pkg.wf, padding=(1, 2, 1, 1))
    cut.input = pkg.array(x)
    cut.initialize(device=pkg.device)
    cut.run()
    gd = pkg.m["cutter"].GDCutter(pkg.wf, padding=(1, 2, 1, 1))
    gd.err_output = pkg.array(err)
    gd.link_attrs(cut, "input")
    gd.initialize(device=pkg.device)
    gd.run()
    return {"output": _host(cut.output), "err_input": _host(gd.err_input)}


def _cutter1d(pkg, r):
    x = r.uniform(-1, 1, (3, 10))
    y0 = r.uniform(-1, 1, (3, 8))
    c = pkg.m["cutter"].Cutter1D(pkg.wf, alpha=2.0, beta=0.5, input_offset=3,
                                 output_offset=1, length=4)
    c.input = pkg.array(x)
    c.output.reset(y0.copy())
    c.initialize(device=pkg.device)
    c.run()
    first = _host(c.output)
    c.beta = 0
    c.run()
    return {"output": first, "output_beta0": _host(c.output)}


def _zerofiller(pkg, r):
    w = r.uniform(-1, 1, (4, 6))
    zf = pkg.m["zerofilling"].ZeroFiller(pkg.wf, grouping=2)
    zf.weights = pkg.array(w)
    zf.initialize(device=pkg.device)
    zf.run()
    out = {"weights": _host(zf.weights), "mask": _host(zf.mask)}
    # a 4-D conv weights tensor masks over (n_kernels, size // n_kernels)
    zf3 = pkg.m["zerofilling"].ZeroFiller(pkg.wf, grouping=3)
    zf3.weights = pkg.array(r.uniform(-1, 1, (6, 2, 2, 3)))
    zf3.initialize(device=pkg.device)
    zf3.run()
    out["weights_g3"] = _host(zf3.weights)
    return out


def _multiplier(pkg, r):
    x, y, err = (r.uniform(-1, 1, (4, 5)) for _ in range(3))
    m = pkg.m["multiplier"].Multiplier(pkg.wf)
    m.x, m.y = pkg.array(x), pkg.array(y)
    m.initialize(device=pkg.device)
    m.run()
    gm = pkg.m["multiplier"].GDMultiplier(pkg.wf)
    gm.x, gm.y, gm.err_output = pkg.array(x), pkg.array(y), pkg.array(err)
    gm.initialize(device=pkg.device)
    gm.run()
    return {"output": _host(m.output), "err_x": _host(gm.err_x),
            "err_y": _host(gm.err_y)}


def _summator(pkg, r):
    x, y, err = (r.uniform(-1, 1, (4, 5)) for _ in range(3))
    s = pkg.m["summator"].Summator(pkg.wf)
    s.x, s.y = pkg.array(x), pkg.array(y)
    s.initialize(device=pkg.device)
    s.run()
    gs = pkg.m["summator"].GDSummator(pkg.wf)
    gs.err_output = pkg.array(err)
    gs.initialize(device=pkg.device)
    gs.run()
    return {"output": _host(s.output), "err_x": _host(gs.err_x),
            "err_y": _host(gs.err_y)}


def _resizable(pkg, r):
    x = r.uniform(-1, 1, (4, 6))
    u = pkg.m["resizable"].ResizableAll2All(
        pkg.wf, output_sample_shape=(5,), weights_stddev=0.1,
        bias_stddev=0.1)
    u.rand = pkg.m["prng"].RandomGenerator().seed(3)
    u.input = pkg.array(x)
    u.initialize(device=pkg.device)
    out = {"weights5": _host(u.weights), "bias5": _host(u.bias)}
    u.output_sample_shape = (8,)
    out.update(weights8=_host(u.weights), bias8=_host(u.bias))
    u.output_sample_shape = (3,)
    out.update(weights3=_host(u.weights), bias3=_host(u.bias))
    u.run()
    out["output"] = _host(u.output)
    return out


def _rprop(pkg, r):
    x = r.uniform(-1, 1, (8, 4))
    errs = [r.uniform(-0.1, 0.1, (8, 3)) for _ in range(3)]
    fwd = pkg.m["all2all"].All2All(pkg.wf, output_sample_shape=(3,),
                                   weights_stddev=0.1, bias_stddev=0.1)
    fwd.rand = pkg.m["prng"].RandomGenerator().seed(4)
    fwd.input = pkg.array(x)
    fwd.initialize(device=pkg.device)
    fwd.run()
    gd = pkg.m["rprop"].GDRProp(pkg.wf)
    gd.err_output = pkg.array(errs[0])
    gd.link_attrs(fwd, "output", "input", "weights", "bias")
    gd.initialize(device=pkg.device)
    out = {"output": _host(fwd.output)}
    for step, err in enumerate(errs):
        gd.err_output = pkg.array(err)
        gd.run()
        for attr in ("weights", "bias", "weight_lrs", "bias_lrs",
                     "err_input"):
            out["%s%d" % (attr, step)] = _host(getattr(gd, attr))
    return out


def _gabor_fill(pkg, r):
    fill = pkg.m["conv"].fill_gabor_filters
    w = numpy.zeros((8, 5 * 5 * 2), numpy.float32)
    fill(w, 5, 5, 2, 0.05, pkg.m["prng"].RandomGenerator().seed(2))
    w2 = numpy.zeros((100, 25))
    fill(w2, 5, 5, 1, 0.05, pkg.m["prng"].RandomGenerator().seed(3))
    k = pkg.m["conv"].gabor_kernel(5, 5, sigma=1.0, theta=0.0, lambd=4.0,
                                   gamma=1.0, psi=0.0)
    return {"bank8": w, "bank100": w2, "kernel": k}


def _gabor_conv(pkg, r):
    unit = pkg.m["conv"].Conv(
        pkg.wf, n_kernels=4, kx=3, ky=3, weights_filling="gabor",
        rand=pkg.m["prng"].RandomGenerator().seed(1))
    unit.input = pkg.array(r.uniform(-1, 1, (2, 8, 8, 3)))
    unit.initialize(device=pkg.device)
    unit.run()
    return {"weights": _host(unit.weights), "output": _host(unit.output)}


#: (case, the arrays a matrix product enters, held within RTOL; the
#: others bit-equal)
CASES = [(_cutter, ()), (_cutter1d, ()), (_zerofiller, ()),
         (_multiplier, ()), (_summator, ()), (_resizable, ("output",)),
         (_rprop, "all"), (_gabor_fill, ()), (_gabor_conv, ("output",))]


@pytest.mark.parametrize("case,inexact", CASES,
                         ids=[c.__name__[1:] for c, _ in CASES])
def test_registry_unit_matches_jax(case, inexact):
    seed = sum(map(ord, case.__name__))
    want = case(_Pkg("jax"), numpy.random.RandomState(seed))
    got = case(_Pkg("torch"), numpy.random.RandomState(seed))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if inexact != "all" and key not in inexact:
            assert numpy.array_equal(g, w), key
        else:
            scale = max(numpy.abs(w).max(), 1e-300)
            assert numpy.abs(g - w).max() <= RTOL * scale, key


def test_zero_filler_masks_in_place_on_every_run():
    """The filler multiplies the tensor the next unit reads, in place,
    on every run: a GD update that moves masked entries is undone by
    the next run, and the Array's host copy follows."""
    pkg = _Pkg("torch")
    w = numpy.random.RandomState(5).uniform(1, 2, (6, 8))
    zf = zerofilling.ZeroFiller(pkg.wf, grouping=2)
    zf.weights = pkg.array(w)
    zf.initialize(device="cpu")
    zf.run()
    dev = zf.weights.dev
    mask = zerofilling.grouping_mask((6, 8), 2, w.dtype)
    assert numpy.array_equal(_host(zf.weights), w * mask)
    zf.weights.set_dev(dev + 1.0)   # an update moves every entry
    zf.run()
    assert numpy.array_equal(_host(zf.weights), (w * mask + 1.0) * mask)
    assert (mask == 0).sum() * 2 == mask.size


@pytest.mark.parametrize("grouping,err", [(1, ValueError),
                                          (2.0, TypeError)])
def test_zero_filler_validates_grouping(grouping, err):
    with pytest.raises(err):
        zerofilling.ZeroFiller(AcceleratedWorkflow(None), grouping=grouping)


def test_zero_filler_refuses_a_non_multiple_width():
    pkg = _Pkg("torch")
    zf = zerofilling.ZeroFiller(pkg.wf, grouping=4)
    zf.weights = pkg.array(numpy.ones((4, 6)))
    with pytest.raises(ValueError, match="Non-multiple"):
        zf.initialize(device="cpu")
