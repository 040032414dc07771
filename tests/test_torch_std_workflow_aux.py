"""``StandardWorkflow``'s auxiliary linkers and the units they link,
held against ``znicz_tpu``'s on the same runs, on the CPU.

* JAX's ``tests/functional/test_std_workflow_aux.py``, mirrored: the
  full auxiliary graph on Wine (the data saver, the err_y, histogram,
  similar-weights and table plotters, the publisher, the shell), the
  stream's replay through ``MinibatchesLoader`` (the port reads JAX's
  stream and JAX's loader the port's), and the plotter linkers on
  weightless layers; the port's publisher metrics, plotters' data and
  saved records equal JAX's (arrays within 1e-12 in float64, headers
  equal).
* The image saver writes JAX's file names (JAX ``tests/unit/
  test_amenities.py:127``).
* ``link_meandispnorm`` and ``link_gd_diff_stats`` (JAX
  ``tests/unit/test_misc_units.py:249-345``): the normalizer's output
  and the diff-stats history within 1e-12 of JAX's in float64, the
  history flushed when the workflow finishes.
* The fused trainer's ``weight_views`` are the net's live weights
  whenever a plotter of them fires (after the steps, a restore or a
  rollback), and the weights plotter reads the fused graph through
  them.
"""

import os
import pickle

import numpy
import pytest
import torch

import znicz_tpu.loader.loader_mnist  # noqa: F401
import znicz_tpu.loader.loader_wine  # noqa: F401
import znicz_tpu_torch.loader.loader_mnist  # noqa: F401
import znicz_tpu_torch.loader.loader_wine  # noqa: F401
from test_torch_autoencoder import _close
from test_torch_mnist import _restored, f64  # noqa: F401
from test_torch_plotters import _eq
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.core.memory import Array as JaxArray
from znicz_tpu.core.workflow import DummyWorkflow
from znicz_tpu.loader.saver import MinibatchesLoader as JaxReplay
from znicz_tpu.loader.saver import read_minibatch_stream as jax_read
from znicz_tpu.standard_workflow import StandardWorkflow as JaxStandard
from znicz_tpu.units.image_saver import ImageSaver as JaxImageSaver
from znicz_tpu.units.mean_disp_normalizer import \
    MeanDispNormalizer as JaxNormalizer
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.loader.saver import (MinibatchesLoader,
                                          read_minibatch_stream)
from znicz_tpu_torch.standard_workflow import StandardWorkflow
from znicz_tpu_torch.units.image_saver import ImageSaver
from znicz_tpu_torch.units.mean_disp_normalizer import MeanDispNormalizer

LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 12,
                                    "weights_stddev": 0.05,
                                    "bias_stddev": 0.05},
     "<-": {"learning_rate": 0.3}},
    {"type": "softmax", "->": {"output_sample_shape": 3,
                               "weights_stddev": 0.05,
                               "bias_stddev": 0.05},
     "<-": {"learning_rate": 0.3}},
]
RTOL = 1e-12
PKG = {"torch": (StandardWorkflow, prng, "cpu"),
       "jax": (JaxStandard, jax_prng, None)}


@pytest.fixture
def caches(tmp_path):
    """Both packages' cache directories under ``tmp_path``."""
    with _restored(root.common.dirs, jax_root.common.dirs):
        root.common.dirs.cache = str(tmp_path / "torch" / "cache")
        jax_root.common.dirs.cache = str(tmp_path / "jax" / "cache")
        yield tmp_path


def _build(pkg, tmp_path, max_epochs=2, **kwargs):
    cls, streams, _ = PKG[pkg]
    streams.get(1).seed(1234)
    streams.get(2).seed(5678)
    return cls(None, layers=[dict(layer) for layer in LAYERS],
               loader_name="wine_loader",
               loader_config={"minibatch_size": 10},
               decision_config={"max_epochs": max_epochs,
                                "fail_iterations": 50},
               snapshotter_config={"prefix": "aux-test", "interval": 1,
                                   "time_interval": 0, "compression": "",
                                   "directory": str(tmp_path / pkg)},
               **kwargs)


def _init_run(pkg, wf):
    wf.initialize(device="cpu" if pkg == "torch" else JaxDevice())
    wf.run()
    return wf


def _full_graph(pkg, tmp_path):
    wf = _build(pkg, tmp_path)
    stream = str(tmp_path / pkg / "stream.sav")
    wf.link_data_saver(wf.loader, file_name=stream, only_epoch=0)
    wf.link_err_y_plotter(wf.decision)
    wf.link_multi_hist_plotter(wf.decision)
    wf.link_similar_weights_plotter(wf.decision)
    wf.link_table_plotter(wf.decision)
    wf.link_publisher(wf.decision, directory=str(tmp_path / pkg / "reports"))
    wf.link_ipython(wf.decision)
    return _init_run(pkg, wf), stream


def _records_equal(got, want):
    (gh, grs), (jh, jrs) = got, want
    assert gh == jh
    assert len(grs) == len(jrs)
    for g, j in zip(grs, jrs):
        assert (g["minibatch_class"], g["minibatch_size"]) == \
            (j["minibatch_class"], j["minibatch_size"])
        assert numpy.array_equal(g["labels"], j["labels"])
        _close(g["data"], j["data"], RTOL, "stream data")


def test_aux_linkers_full_graph_as_jax(f64, caches):
    twf, tstream = _full_graph("torch", caches)
    jwf, jstream = _full_graph("jax", caches)
    for wf in (twf, jwf):
        assert wf.decision.epoch_number >= 2
        assert wf.publisher.report is not None
        md = [d for d in wf.publisher.destinations if d.endswith(".md")][0]
        assert "decision" in open(md).read()
        assert wf.ipython.interactions == 0
        assert wf.table_plotter.rows and wf.err_y_plotters[-1].values
    # the publisher's metrics, the plotters' data, the saved stream
    assert twf.publisher.report["metrics"] == jwf.publisher.report["metrics"]
    assert twf.publisher.report["loader"] == jwf.publisher.report["loader"]
    for t, j in zip(twf.err_y_plotters, jwf.err_y_plotters):
        _eq(t.values, j.values)
    _eq(twf.table_plotter.rows, jwf.table_plotter.rows)
    assert twf.table_plotter.col_labels == jwf.table_plotter.col_labels
    for t, j in zip(twf.multi_hist_plotter, jwf.multi_hist_plotter):
        assert t.name == j.name
        _eq(t.histograms, j.histograms)
    for t, j in zip(twf.similar_weights_plotter,
                    jwf.similar_weights_plotter):
        assert t.similar_pairs == j.similar_pairs
    got, want = read_minibatch_stream(tstream), jax_read(jstream)
    assert got[0]["class_lengths"] == [0, 0, 178]
    assert sum(r["minibatch_size"] for r in got[1]) == 178
    _records_equal(got, want)


@pytest.mark.parametrize("reader", ["torch", "jax"])
def test_minibatches_loader_replays_either_stream(f64, caches, reader):
    streams = {}
    for pkg in ("torch", "jax"):
        wf = _build(pkg, caches)
        streams[pkg] = str(caches / pkg / "stream.sav")
        wf.link_data_saver(wf.loader, file_name=streams[pkg], only_epoch=0)
        _init_run(pkg, wf)
    data = {}
    for pkg, path in streams.items():
        if reader == "torch":
            ldr = MinibatchesLoader(None, file_name=path, minibatch_size=10)
            ldr.initialize(device="cpu")
        else:
            ldr = JaxReplay(None, file_name=path, minibatch_size=10)
            ldr.initialize()
        assert list(ldr.class_lengths) == [0, 0, 178]
        ldr.run()
        assert int(ldr.minibatch_size) == 10
        assert ldr.minibatch_data.mem.shape[1:] == (13,)
        data[pkg] = (numpy.array(ldr.original_data.mem),
                     list(ldr.original_labels))
    _close(data["torch"][0], data["jax"][0], RTOL, "replayed rows")
    assert data["torch"][1] == data["jax"][1]


def test_plotter_linkers_on_weightless_layers_as_jax(f64, caches):
    got = {}
    for pkg in ("torch", "jax"):
        cls, streams, _ = PKG[pkg]
        streams.get(1).seed(1234)
        streams.get(2).seed(5678)
        wf = cls(
            None,
            layers=[{"type": "conv_tanh",
                     "->": {"n_kernels": 2, "kx": 3, "ky": 3},
                     "<-": {"learning_rate": 0.1}},
                    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
                    {"type": "activation_tanh"},
                    {"type": "softmax", "->": {"output_sample_shape": 10},
                     "<-": {"learning_rate": 0.1}}],
            loader_name="mnist_loader",
            loader_config={"synthetic_train": 40, "synthetic_valid": 20,
                           "minibatch_size": 20},
            decision_config={"max_epochs": 1, "fail_iterations": 10},
            snapshotter_config={"prefix": "wl", "interval": 100,
                                "time_interval": 1e9,
                                "directory": str(caches / pkg)})
        wf.link_multi_hist_plotter(wf.decision)
        wf.link_similar_weights_plotter(wf.decision)
        wf.link_table_plotter(wf.decision)
        wf.link_image_plotter(wf.decision)
        got[pkg] = _init_run(pkg, wf)
    t, j = got["torch"], got["jax"]
    assert t.decision.epoch_number >= 1 and t.table_plotter.rows
    _eq(t.table_plotter.rows, j.table_plotter.rows)
    _eq(t.image_plotter.current, j.image_plotter.current)
    assert [p.name for p in t.multi_hist_plotter] == \
        [p.name for p in j.multi_hist_plotter]
    for a, b in zip(t.multi_hist_plotter, j.multi_hist_plotter):
        _eq(a.histograms, b.histograms)


def test_image_saver_writes_jaxs_names(tmp_path):
    r = numpy.random.RandomState(0)
    x = r.uniform(0, 1, (5, 8, 8))
    names = {}
    for cls, wf, arr in ((ImageSaver, Workflow(), Array),
                         (JaxImageSaver, DummyWorkflow(), JaxArray)):
        out = tmp_path / cls.__module__.split(".")[0]
        sv = cls(wf, out_dirs=[str(out / c) for c in ("t", "v", "tr")],
                 limit=2)
        sv.input = arr(x.copy())
        sv.indices = arr(numpy.arange(10, 15, dtype=numpy.int32))
        sv.labels = arr(numpy.array([0, 1, 2, 3, 4], dtype=numpy.int32))
        sv.max_idx = arr(numpy.array([0, 3, 2, 1, 0], dtype=numpy.int32))
        sv.minibatch_class = 2
        sv.minibatch_size = 5
        sv.epoch_number = 0
        sv.run()
        names[cls] = sorted(os.listdir(str(out / "tr")))
    # misclassified: samples 1, 3, 4; the limit keeps the first two
    assert names[ImageSaver] == names[JaxImageSaver] == \
        ["1_as_3.11.png", "3_as_1.13.png"]


def _normalized(pkg, tmp_path):
    """JAX's ``test_std_workflow_meandispnorm_and_gd_diff_stats_linkers``."""
    cls, streams, _ = PKG[pkg]
    streams.get(1).seed(1234)
    streams.get(2).seed(5678)
    wf = cls(
        None,
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 16},
                 "<-": {"learning_rate": 0.1}},
                {"type": "softmax", "->": {"output_sample_shape": 10},
                 "<-": {"learning_rate": 0.1}}],
        loader_name="mnist_loader",
        loader_config={"synthetic_train": 60, "synthetic_valid": 30,
                       "minibatch_size": 30, "normalization_type": "none"},
        decision_config={"max_epochs": 2, "fail_iterations": 10},
        snapshotter_config={"prefix": "mdn", "interval": 100,
                            "time_interval": 1e9,
                            "directory": str(tmp_path / pkg)},
        preprocessing=True)
    wf.link_repeater(wf.start_point)
    wf.link_loader(wf.repeater)
    ldr = wf.loader
    device = "cpu" if pkg == "torch" else JaxDevice()
    ldr.initialize(device=device)
    arr = Array if pkg == "torch" else JaxArray
    # float64 statistics: the forwards then run in float64 (the
    # normalizer casts the minibatch to float32 first, as JAX's does)
    data = ldr.original_data.mem.astype(numpy.float64)
    ldr.mean = arr(data.mean(axis=0))
    ldr.rdisp = arr(1.0 / (data.std(axis=0) + 1.0))
    if pkg == "torch":
        ldr.mean.device = ldr.rdisp.device = device
    norm = wf.link_meandispnorm(wf.loader)
    # the output in float64 before initialize, so that JAX's forwards
    # (whose weights take their input's dtype) run in float64 too
    norm.output.reset(numpy.zeros(ldr.minibatch_data.shape))
    wf.link_forwards(("input", "output"), norm)
    wf.link_evaluator(wf.forwards[-1])
    wf.link_decision(wf.evaluator)
    wf.link_snapshotter(wf.decision)
    last_gd = wf.link_gds(wf.snapshotter)
    stats = wf.link_gd_diff_stats(
        last_gd, file_name=str(tmp_path / pkg / "ds.pickle"))
    wf.link_loop(stats)
    wf.link_end_point(stats)
    return _init_run(pkg, wf)


def test_meandispnorm_and_gd_diff_stats_as_jax(f64, tmp_path):
    twf, jwf = _normalized("torch", tmp_path), _normalized("jax", tmp_path)
    t, j = twf.gd_diff_stats, jwf.gd_diff_stats
    assert twf.decision.epoch_number >= 2
    assert len(t.history) == len(j.history) == 4   # a TRAIN minibatch each
    for a, b in zip(t.history, j.history):
        assert sorted(a) == sorted(b)
        for unit in a:
            assert sorted(a[unit]) == sorted(b[unit]) == ["gradient_weights"]
            want = b[unit]["gradient_weights"]
            # relative to the array's largest magnitude (a softmax
            # gradient's mean is 0 up to rounding)
            scale = max(abs(want["min"]), abs(want["max"]), 1e-300)
            for k, v in a[unit]["gradient_weights"].items():
                assert abs(v - want[k]) <= RTOL * scale, (unit, k)
    with open(str(tmp_path / "torch" / "ds.pickle"), "rb") as f:
        assert pickle.load(f) == t.history
    out, jout = twf.meandispnorm.output.mem, jwf.meandispnorm.output.mem
    assert out.dtype == numpy.float64
    _close(out, jout, RTOL, "normalized minibatch")
    for a, b in zip(twf.forwards, jwf.forwards):
        _close(a.weights.mem, b.weights.mem, RTOL, "weights")


def test_normalizer_unit_and_its_shape_checks(f64):
    r = numpy.random.RandomState(3)
    x = r.uniform(0, 255, (4, 5, 5, 2))
    mean, rdisp = x.mean(axis=0), 1.0 / (x.std(axis=0) + 1.0)
    outs = []
    for cls, wf, arr, dev in ((MeanDispNormalizer, Workflow(), Array, "cpu"),
                              (JaxNormalizer, DummyWorkflow(), JaxArray,
                               JaxDevice())):
        unit = cls(wf)
        unit.input, unit.mean, unit.rdisp = (arr(a.copy())
                                             for a in (x, mean, rdisp))
        unit.initialize(dev)
        unit.run()
        outs.append(numpy.array(unit.output.mem))
    want = (x.astype(numpy.float32) - mean) * rdisp
    _close(outs[0], outs[1], RTOL, "output")
    _close(outs[0], want, RTOL, "output")
    # a known difference: the port allocates the output in the dtype its
    # run produces (float64 here), JAX in float32
    fresh = MeanDispNormalizer(Workflow())
    fresh.input, fresh.mean, fresh.rdisp = Array(x), Array(mean), Array(rdisp)
    fresh.initialize("cpu")
    assert fresh.output.dtype == numpy.float64
    jfresh = JaxNormalizer(DummyWorkflow())
    jfresh.input, jfresh.mean, jfresh.rdisp = (JaxArray(a)
                                               for a in (x, mean, rdisp))
    jfresh.initialize(JaxDevice())
    assert jfresh.output.mem.dtype == numpy.float32
    bad = MeanDispNormalizer(Workflow())
    bad.input, bad.mean, bad.rdisp = Array(x), Array(mean[:2]), Array(rdisp)
    with pytest.raises(ValueError, match="mean shape"):
        bad.initialize("cpu")


def test_fused_weight_views_follow_the_net(tmp_path):
    wf = _build("torch", tmp_path, fused=True)
    trainer = wf.fused_trainer
    assert [i for i, _ in trainer.weight_views] == [0, 1]
    assert [v.name for _, v in trainer.weight_views] == \
        ["all2all_tanh_0_weights", "softmax_1_weights"]
    assert not any(v for _, v in trainer.weight_views)   # before initialize
    wf.link_weights_plotter(wf.decision)
    assert all(p.before_fill == trainer.point_weight_views
               for p in wf.weights_plotter)
    untouched = []
    real = type(trainer).run

    def run(unit):
        before = [v.dev for _, v in unit.weight_views]
        real(unit)
        # the steps leave the views alone: only a plotter points them
        untouched.append(all(v.dev is old for (_, v), old in
                             zip(unit.weight_views, before)))
    trainer.run = lambda: run(trainer)
    _init_run("torch", wf)
    assert untouched and all(untouched)
    for p, (i, view) in zip(wf.weights_plotter, trainer.weight_views):
        assert p.input is view
        live = trainer.net.params[i]["w"].numpy()
        assert view.dev is trainer.net.params[i]["w"]
        assert numpy.array_equal(view.mem, live)
        grid = [numpy.asarray(g) for g in p.grid]
        assert len(grid) == min(64, live.shape[0])
    # a restore replaces the tensors: the next point follows them, and
    # a view already on its tensor keeps its host copy
    before = [v.dev for _, v in trainer.weight_views]
    trainer.fused_state = trainer.fused_state
    trainer.point_weight_views()
    for (i, view), old in zip(trainer.weight_views, before):
        assert view.dev is trainer.net.params[i]["w"] and view.dev is not old
        assert torch.equal(view.dev, old)
        view.map_read()
    trainer.point_weight_views()
    assert not any(v.host_stale for _, v in trainer.weight_views)


def test_a_rollback_re_points_the_weight_views(tmp_path):
    """``FusedNNRollback``'s restore replaces the net's tensors, of a
    trainer or of a bare net (as the card's health check builds one):
    the weights plotter, when it fires, reads the restored ones."""
    import types
    from znicz_tpu_torch.units.fused_trainer import FusedNNRollback
    wf = _build("torch", tmp_path, max_epochs=1, fused=True)
    wf.link_weights_plotter(wf.decision)
    _init_run("torch", wf)
    trainer = wf.fused_trainer
    for target in (trainer, types.SimpleNamespace(net=trainer.net,
                                                  gd_proxies=[])):
        rb = FusedNNRollback(Workflow(), trainer=target, minus_steps=1)
        rb.improved = True
        rb.run()
        stored = [p["w"].clone() for p in trainer.net.params if p]
        for p in trainer.net.params:
            if p:
                p["w"] = p["w"] + 1.0
        rb.improved = False
        rb.run()
        live = [p["w"] for p in trainer.net.params if p]
        assert all(torch.equal(a, b) for a, b in zip(live, stored))
        for p, (i, view) in zip(wf.weights_plotter, trainer.weight_views):
            p.run()
            assert view.dev is trainer.net.params[i]["w"]
            assert numpy.array_equal(view.mem,
                                     trainer.net.params[i]["w"].numpy())
