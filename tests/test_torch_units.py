"""The port's Unit/Workflow engine (znicz_tpu_torch.core) against the
JAX package's (znicz_tpu.core), on the CPU, on tiny graphs:

* ``Bool`` expressions give the same truth tables in both packages;
* ``gate_block`` consumes a signal and ``gate_skip`` passes it on
  without running, the same runs in both;
* ``link_attrs`` aliases attributes (two-way writes forward, one-way
  writes detach);
* a ``Repeater`` loop ends on ``complete``, after the same runs;
* ``Array``'s ``map_*`` semantics, and ``mem`` never aliases ``dev``.

``prng_streams_restored`` (autouse here, imported by the other
``test_torch_*`` workflow files) saves both packages' prng streams 1
and 2 and restores them after the test: later tests draw from the
process-global streams too.
"""

import itertools

import numpy
import pytest
import torch

from znicz_tpu.core import mutable as jax_mutable
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core import units as jax_units
from znicz_tpu.core import workflow as jax_workflow
from znicz_tpu_torch.core import mutable, prng, units, workflow
from znicz_tpu_torch.core.memory import Array

PACKAGES = {"jax": (jax_mutable, jax_units, jax_workflow),
            "torch": (mutable, units, workflow)}


@pytest.fixture(autouse=True)
def prng_streams_restored():
    saved = [(p, k, p.get(k).get_state()) for p in (jax_prng, prng)
             for k in (1, 2)]
    yield
    for p, k, state in saved:
        p.get(k).set_state(state)


def _truth_table(mod):
    a, b = mod.Bool(False), mod.Bool(False)
    exprs = [~a, a | b, a & b, a ^ b, ~(a | b) & ~b, (a ^ b) | ~a]
    rows = []
    for va, vb in itertools.product((False, True), repeat=2):
        a <<= va
        b <<= vb
        rows.append([bool(e) for e in exprs])
    return rows


def test_bool_expressions_match_jax():
    got, want = _truth_table(mutable), _truth_table(jax_mutable)
    assert got == want
    assert want[0] == [True, False, False, False, True, True]
    with pytest.raises(ValueError):
        e = ~mutable.Bool(True)
        e <<= True


def _counting_unit(units_mod):
    class Counting(units_mod.Unit):
        def __init__(self, workflow, **kwargs):
            super(Counting, self).__init__(workflow, **kwargs)
            self.runs = 0

        def run(self):
            self.runs += 1
    return Counting


def _gated_chain(pkg, block, skip):
    """start -> a -> b -> c -> end; ``b`` gated; the units' run counts
    and whether the end point was reached."""
    mut, units_mod, wf_mod = PACKAGES[pkg]
    counting = _counting_unit(units_mod)
    wf = wf_mod.Workflow(None, name="wf")
    a, b, c = (counting(wf, name=n) for n in "abc")
    a.link_from(wf.start_point)
    b.link_from(a)
    c.link_from(b)
    wf.end_point.link_from(c)
    b.gate_block = mut.Bool(block)
    b.gate_skip = mut.Bool(skip)
    wf.initialize()
    wf.run()
    return [u.runs for u in (a, b, c)], wf.end_point.run_was_called


@pytest.mark.parametrize("block,skip", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_gates_match_jax(block, skip):
    got = _gated_chain("torch", block, skip)
    assert got == _gated_chain("jax", block, skip)
    runs, ended = got
    assert runs == [1, int(not (block or skip)), int(not block)]
    assert ended == (not block)


def test_link_attrs_aliases():
    for pkg in PACKAGES:
        _, units_mod, wf_mod = PACKAGES[pkg]
        wf = wf_mod.Workflow(None)
        src, dst = units_mod.Unit(wf, name="src"), units_mod.Unit(
            wf, name="dst")
        src.value, src.other = 1, 10
        dst.link_attrs(src, ("mine", "value"))
        dst.link_attrs(src, "other", two_way=False)
        assert (dst.mine, dst.other) == (1, 10)
        src.value, src.other = 2, 20          # reads are live
        assert (dst.mine, dst.other) == (2, 20)
        dst.mine = 3                          # a two-way write forwards
        assert src.value == 3
        dst.other = 30                        # a one-way write detaches
        assert (src.other, dst.other) == (20, 30)
        src.other = 40
        assert dst.other == 30


def _loop(pkg, n):
    """start -> repeater -> body -> (repeater | end), the body setting
    ``complete`` on its n-th run: (body runs, repeater runs)."""
    mut, units_mod, wf_mod = PACKAGES[pkg]
    counting = _counting_unit(units_mod)
    wf = wf_mod.Workflow(None)
    complete = mut.Bool(False)

    class Body(counting):
        def run(self):
            nonlocal complete
            super(Body, self).run()
            complete <<= self.runs >= n
    rep = wf_mod.Repeater(wf, name="repeater")
    body = Body(wf, name="body")
    rep.link_from(wf.start_point)
    body.link_from(rep)
    rep.link_from(body)
    wf.end_point.link_from(body)
    rep.gate_block = complete
    wf.end_point.gate_block = ~complete
    wf.initialize()
    wf.run()
    return body.runs, rep.run_count_


@pytest.mark.parametrize("n", [1, 4])
def test_repeater_loop_ends_on_complete(n):
    assert _loop("torch", n) == _loop("jax", n) == (n, n)


def test_array_map_semantics_and_no_aliasing():
    a = Array(numpy.arange(6, dtype=numpy.float64).reshape(2, 3))
    a.device = torch.device("cpu")
    assert a.shape == (2, 3) and a.dtype == numpy.float64
    dev = a.dev                       # upload: a private copy
    a.map_write()
    a.mem[0, 0] = 100.0
    assert float(dev[0, 0]) == 0.0
    t = torch.full((2, 3), 7.0, dtype=torch.float64)
    a.set_dev(t)                      # a device write
    assert a.shape == (2, 3) and a.dev is t
    a.map_read()                      # the download is a private copy
    host = a.mem
    assert (host == 7.0).all()
    host[1, 1] = -1.0
    assert float(t[1, 1]) == 7.0
    t[0, 0] = 5.0
    assert host[0, 0] == 7.0
    a.map_invalidate()                # host authoritative, no download
    a.mem[...] = 2.0
    assert (a.dev == 2.0).all() and a.dev is not t and a[0, 2] == 2.0
    b = Array()
    b.set_dev(torch.zeros(4, dtype=torch.int32))
    b.map_invalidate()
    assert b.mem.shape == (4,) and b.mem.dtype == numpy.int32
    assert not Array() and Array().dev is None
    with pytest.raises(ValueError, match="no device"):
        Array(numpy.zeros(2)).dev
