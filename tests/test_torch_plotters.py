"""The plotters (``core/plotting_units.py``, ``units/nn_plotting_units.py``,
``units/diversity.py``) and the status server's page of them, held
against ``znicz_tpu``'s on the same inputs, on the CPU.

* Every plotter's recorded data equals JAX's: values and counts
  exactly, floats within 1e-12 in float64 (JAX ``tests/unit/
  test_amenities.py:144-170`` and the four Kohonen plotters of
  ``tests/unit/test_parity_holes.py:124-190``); ``TableMaxMin`` reads
  an Array only the device holds in one copy, to the same values.
* ``get_similar_kernels`` returns JAX's pairs (``test_amenities.py:172``)
  and ``SimilarWeights2D`` records JAX's pairs and grid.
* With plotting enabled each plotter writes its PNG under
  ``<cache>/plots``; the status server's ``/`` lists them and
  ``/plots/<name>`` serves them.  Plotting enabled without matplotlib
  raises ``ImportError``: no render is skipped quietly.
"""

import json
import os
import sys
import urllib.error
import urllib.parse
import urllib.request

import numpy
import pytest
import torch

from test_torch_mnist import _restored
from znicz_tpu.core import plotting_units as jax_pu
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.core.memory import Array as JaxArray
from znicz_tpu.core.workflow import DummyWorkflow
from znicz_tpu.units import diversity as jax_div
from znicz_tpu.units import nn_plotting_units as jax_nnp
from znicz_tpu_torch.core import memory
from znicz_tpu_torch.core import plotting_units as pu
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.status_server import StatusServer
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.units import diversity
from znicz_tpu_torch.units import nn_plotting_units as nnp

SIDES = {"torch": (pu, nnp, diversity, Workflow, Array),
         "jax": (jax_pu, jax_nnp, jax_div, DummyWorkflow, JaxArray)}


def _both(make):
    """``make(side modules)`` for each package: ``{pkg: plotter}``."""
    return {pkg: make(*mods) for pkg, mods in SIDES.items()}


def _eq(a, b):
    """Recorded data equal: arrays (and nested lists / tuples of them)
    element for element, NaN equal to NaN, dtypes of the same kind."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
        return
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _eq(a[k], b[k])
        return
    a, b = numpy.asarray(a), numpy.asarray(b)
    assert a.shape == b.shape
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        nan = numpy.isnan(b)
        assert numpy.array_equal(numpy.isnan(a), nan)
        a, b = numpy.where(nan, 0.0, a), numpy.where(nan, 0.0, b)
        scale = max(float(numpy.abs(b).max(initial=0.0)), 1e-300)
        diff = numpy.abs(a.astype(numpy.float64) - b)
        assert diff.max(initial=0.0) <= 1e-12 * scale
    else:
        assert numpy.array_equal(a, b)


def _fire(plotters):
    for p in plotters.values():
        p.run()


@pytest.fixture
def r():
    return numpy.random.RandomState(1234)


# -- recorded data ------------------------------------------------------------

def test_accumulating_plotter(r):
    inputs = [[None, 5.0, 1.0], [None, 3.0, 1.0], numpy.array([2.0, 7.5]),
              [None, None, 4.0]]
    ps = _both(lambda pu_, nnp_, div_, wf, arr: pu_.AccumulatingPlotter(
        wf(), input_field=1))
    offs = _both(lambda pu_, nnp_, div_, wf, arr: pu_.AccumulatingPlotter(
        wf(), input_field=2, input_offset=1))
    for value in inputs:
        for p in ps.values():
            p.input = value
        _fire(ps)
    for pkg, (_, _, _, _, arr) in SIDES.items():
        offs[pkg].input = [None, None, arr(numpy.array([0.5, 9.25]))]
    _fire(offs)
    assert ps["torch"].values == ps["jax"].values == [5.0, 3.0, 7.5]
    assert offs["torch"].values == offs["jax"].values == [9.25]


def test_matrix_plotter(r):
    m = r.randint(0, 9, (5, 5)).astype(numpy.int32)
    ps = _both(lambda pu_, nnp_, div_, wf, arr: pu_.MatrixPlotter(wf()))
    for pkg, p in ps.items():
        p.input = SIDES[pkg][4](m.copy())
    _fire(ps)
    _eq(ps["torch"].current, ps["jax"].current)
    assert ps["torch"].current.shape == (5, 5)


@pytest.mark.parametrize("shape", [(6, 16), (10, 27), (5, 13), (4, 3, 3, 2)])
@pytest.mark.parametrize("transposed", [False, True])
def test_weights2d(r, shape, transposed):
    w = r.uniform(-1, 1, shape)
    ps = _both(lambda pu_, nnp_, div_, wf, arr: nnp_.Weights2D(
        wf(), limit=4, transposed=transposed))
    for pkg, p in ps.items():
        p.input = SIDES[pkg][4](w.copy())
    if transposed and len(shape) > 2:
        return
    _fire(ps)
    _eq(ps["torch"].grid, ps["jax"].grid)
    assert 0 < len(ps["torch"].grid) <= 4


def test_weights2d_reads_a_device_array_and_skips_an_empty_one(r):
    w = r.uniform(-1, 1, (9, 25))
    ps = _both(lambda pu_, nnp_, div_, wf, arr: nnp_.Weights2D(wf()))
    ps["jax"].input = JaxArray(w.copy())
    ps["torch"].input = Array().set_dev(torch.from_numpy(w.copy()))
    assert ps["torch"].input.host_stale
    _fire(ps)
    _eq(ps["torch"].grid, ps["jax"].grid)
    for pkg, p in _both(lambda pu_, nnp_, div_, wf, arr: nnp_.Weights2D(
            wf())).items():
        p.input = SIDES[pkg][4]()
        p.run()
        assert p.grid is None


def test_mse_histogram(r):
    mse = r.uniform(0, 1, 50)
    ps = _both(lambda pu_, nnp_, div_, wf, arr: nnp_.MSEHistogram(
        wf(), bars=5))
    for pkg, p in ps.items():
        p.mse = SIDES[pkg][4](mse.copy())
    _fire(ps)
    t, j = ps["torch"], ps["jax"]
    _eq(t.hist, j.hist)
    _eq(t.edges, j.edges)
    assert (t.mse_min, t.mse_max) == (j.mse_min, j.mse_max)
    assert t.hist.sum() == 50


def test_multi_histogram(r):
    w = r.normal(0, 0.1, (20, 3, 3, 4))
    ps = _both(lambda pu_, nnp_, div_, wf, arr: pu_.MultiHistogram(
        wf(), hist_number=6, n_bars=9))
    for pkg, p in ps.items():
        p.input = SIDES[pkg][4](w.copy())
    _fire(ps)
    _eq(ps["torch"].histograms, ps["jax"].histograms)
    assert len(ps["torch"].histograms) == 6
    empty = _both(lambda pu_, nnp_, div_, wf, arr: pu_.MultiHistogram(wf()))
    for pkg, p in empty.items():
        p.input = SIDES[pkg][4]()
        p.run()
        assert p.histograms == []


def test_image_and_immediate_plotters(r):
    out = r.uniform(-1, 1, (4, 6, 6, 3))
    inp = r.uniform(0, 1, (4, 6, 6, 1))
    curves = [r.normal(size=(4, 7)), r.normal(size=(4, 3))]
    images = _both(lambda pu_, nnp_, div_, wf, arr: pu_.ImagePlotter(wf()))
    lines = _both(lambda pu_, nnp_, div_, wf, arr: pu_.ImmediatePlotter(
        wf()))
    for pkg, p in images.items():
        arr = SIDES[pkg][4]
        p.inputs += [arr(out.copy()), arr(inp.copy())]
        p.input_fields += [0, 2]
    for pkg, p in lines.items():
        del p.inputs[:], p.input_fields[:]
        for c in curves:
            p.inputs.append(SIDES[pkg][4](c.copy()))
            p.input_fields.append(1)
    _fire(images)
    _fire(lines)
    _eq(images["torch"].current, images["jax"].current)
    _eq(lines["torch"].current, lines["jax"].current)


def test_table_max_min_reads_the_device_once(r, monkeypatch):
    arrays = [r.normal(size=(5, 4)), None, r.uniform(size=7), "empty",
              r.normal(size=(3,)), "device", numpy.float64(2.0)]
    dev = r.normal(size=(6, 2))
    ps = _both(lambda pu_, nnp_, div_, wf, arr: pu_.TableMaxMin(wf()))
    for pkg, p in ps.items():
        arr = SIDES[pkg][4]
        for k, a in enumerate(arrays):
            if a is None:
                p.y.append(None)
            elif isinstance(a, str) and a == "empty":
                p.y.append(arr())
            elif isinstance(a, str):
                p.y.append(arr(dev.copy()) if pkg == "jax" else
                           Array().set_dev(torch.from_numpy(dev.copy())))
            else:
                p.y.append(arr(numpy.array(a)))
            p.col_labels.append("c%d" % k)
    fetches = []
    real = memory.host_fetch
    monkeypatch.setattr(pu, "host_fetch",
                        lambda tree: fetches.append(len(tree)) or real(tree))
    for _ in range(2):
        _fire(ps)
    assert fetches == [1, 1]
    _eq(ps["torch"].rows, ps["jax"].rows)
    assert numpy.isnan(ps["torch"].rows[0][1][0])
    assert ps["torch"].y[5].host_stale   # read without a host copy


# -- the Kohonen plotters ------------------------------------------------------

def _grid(cls):
    p = cls(Workflow())
    p.shape = (4, 3)
    return p


def _kohonen(name, setup):
    got = _grid(getattr(nnp, name))
    want = getattr(jax_nnp, name)(DummyWorkflow())
    want.shape = (4, 3)
    for k, v in setup.items():
        setattr(got, k, v)
        setattr(want, k, v)
    got.fill()
    want.fill()
    return got, want


def test_kohonen_hits(r):
    got, want = _kohonen("KohonenHits", {"input": r.randint(0, 9, 12)})
    _eq((got.hits, got.sizes), (want.hits, want.sizes))
    _eq(got.hex_centers(), want.hex_centers())
    assert got.hex_centers()[0][4] == 0.5


def test_kohonen_input_maps(r):
    got, want = _kohonen("KohonenInputMaps",
                         {"input": r.uniform(-1, 1, (12, 5))})
    _eq(got.maps, want.maps)
    assert len(got.maps) == 5


def test_kohonen_neighbor_map(r):
    w = r.uniform(-1, 1, (12, 5))
    got, want = _kohonen("KohonenNeighborMap", {"input": w})
    assert got.links == want.links
    _eq(got.link_values, want.link_values)
    assert len(got.links) == (4 - 1) * 3 + (2 * 4 - 1) * (3 - 1)


def test_kohonen_validation_results():
    got, want = _kohonen("KohonenValidationResults", {
        "input": numpy.arange(12), "result": {0: {0, 1}, 1: {5}},
        "fitness": 0.5, "fitness_by_label": {0: 0.4, 1: 0.6},
        "fitness_by_neuron": {0: 0.3, 1: 0.2, 5: 0.9}})
    _eq((got.neuron_labels, got.neuron_fitness),
        (want.neuron_labels, want.neuron_fitness))
    assert got.neuron_labels[5] == 1 and got.neuron_labels[7] == -1


# -- diversity -----------------------------------------------------------------

def test_similar_kernels_as_in_jax(r):
    w = r.uniform(-1, 1, (6, 27))
    w[1] = w[0] + r.uniform(-1e-3, 1e-3, 27)
    w[4] = w[2] + r.uniform(-1e-3, 1e-3, 27)
    got = diversity.get_similar_kernels(w, channels=3)
    assert got == jax_div.get_similar_kernels(w, channels=3)
    assert (0, 1) in got
    ps = _both(lambda pu_, nnp_, div_, wf, arr: div_.SimilarWeights2D(wf()))
    for pkg, p in ps.items():
        p.input = SIDES[pkg][4](w.copy())
    _fire(ps)
    assert ps["torch"].similar_pairs == ps["jax"].similar_pairs == got
    _eq(ps["torch"].grid, ps["jax"].grid)
    odd = _both(lambda pu_, nnp_, div_, wf, arr: div_.SimilarWeights2D(wf()))
    for pkg, p in odd.items():   # 13 inputs a row: no square kernel
        p.input = SIDES[pkg][4](r.uniform(size=(4, 13)))
        p.run()
        assert p.similar_pairs == [] and p.grid is None


# -- rendering and the status server -------------------------------------------

@pytest.fixture
def plotting(tmp_path):
    with _restored(root.common.disable, root.common.dirs,
                   jax_root.common.disable, jax_root.common.dirs):
        root.common.disable.plotting = False
        root.common.dirs.cache = str(tmp_path)
        yield tmp_path


def _all_plotters(r):
    wf = Workflow()
    acc = pu.AccumulatingPlotter(wf, name="acc", input_field=0)
    acc.input = [1.0]
    mat = pu.MatrixPlotter(wf, name="mat")
    mat.input = Array(numpy.eye(3))
    hist = pu.MultiHistogram(wf, name="hist")
    hist.input = Array(r.normal(size=(4, 9)))
    img = pu.ImagePlotter(wf, name="img")
    img.inputs.append(Array(r.uniform(size=(2, 5, 5, 3))))
    img.input_fields.append(0)
    imm = pu.ImmediatePlotter(wf, name="imm")
    imm.inputs.append(Array(r.normal(size=(2, 8))))
    imm.input_fields.append(0)
    w2 = nnp.Weights2D(wf, name="w2")
    w2.input = Array(r.uniform(size=(4, 16)))
    mse = nnp.MSEHistogram(wf, name="mse")
    mse.mse = Array(r.uniform(size=30))
    out = [acc, mat, hist, img, imm, w2, mse]
    for cls, setup in (
            (nnp.KohonenHits, {"input": numpy.arange(12)}),
            (nnp.KohonenInputMaps, {"input": r.uniform(size=(12, 3))}),
            (nnp.KohonenNeighborMap, {"input": r.uniform(size=(12, 3))}),
            (nnp.KohonenValidationResults, {
                "input": numpy.arange(12), "result": {0: {0}, 1: {5}},
                "fitness": 0.5, "fitness_by_label": {0: 0.4, 1: 0.6},
                "fitness_by_neuron": {0: 0.3, 5: 0.9}})):
        p = cls(wf)
        p.shape = (4, 3)
        for k, v in setup.items():
            setattr(p, k, v)
        out.append(p)
    return wf, out


def test_each_plotter_writes_its_png_and_the_server_serves_it(plotting, r):
    pytest.importorskip("matplotlib")
    wf, plotters = _all_plotters(r)
    for p in plotters:
        p.run()
        assert p._fig_path == os.path.join(str(plotting), "plots",
                                           p.name + ".png")
        with open(p._fig_path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    server = StatusServer(wf, port=0).start()
    try:
        base = "http://127.0.0.1:%d" % server.port
        with urllib.request.urlopen(base + "/", timeout=10) as reply:
            page = reply.read().decode()
        status = json.loads(urllib.request.urlopen(
            base + "/status.json", timeout=10).read())
        names = sorted(p.name + ".png" for p in plotters)
        assert status["plots"] == names
        for name in names:
            url = "/plots/" + urllib.parse.quote(name)
            assert '<img src="%s"' % url in page
            with urllib.request.urlopen(base + url, timeout=10) as reply:
                assert reply.headers["Content-Type"] == "image/png"
                with open(os.path.join(str(plotting), "plots", name),
                          "rb") as f:
                    assert reply.read() == f.read()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/plots/missing.png", timeout=10)
        assert e.value.code == 404
    finally:
        server.stop()


def test_plotting_disabled_renders_nothing(tmp_path, r):
    with _restored(root.common.dirs):
        root.common.dirs.cache = str(tmp_path)
        _, plotters = _all_plotters(r)
        for p in plotters:
            p.run()
            assert p._fig_path is None
    assert not os.path.exists(str(tmp_path / "plots"))


def test_plotting_enabled_without_matplotlib_raises(plotting, r,
                                                    monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    _, plotters = _all_plotters(r)
    for p in plotters:
        with pytest.raises(ImportError):
            p.run()
