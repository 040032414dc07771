"""The slice as a whole, on the CPU: the reference imagenet workflow's
shape (repeater -> ``imagenet_loader_base`` -> ``link_meandispnorm`` on
the loader's own mean and rdisp -> the forwards -> evaluator ->
decision -> snapshotter -> GD units -> loop), composed only of the
``link_*`` functions the JAX package has, over ImagenetLoaderBase's
files written by the test, held against ``znicz_tpu``'s same workflow.

A small net (a conv, a max pool, a softmax) over 16x16x3 uint8 records,
48 TRAIN and 16 VALID rows, in float64, through the unit graph for 2
epochs: each segment's n_err and confusion equal JAX's, every final
weight and bias within 1e-10 of the tensor's largest magnitude; the
same through the launcher (``python -m znicz_tpu_torch WF.py --device
cpu``), which also closes ``samples.dat`` when the run returns.
"""

import json
import os
import pickle

import numpy
import pytest

from test_torch_mnist import _recorded, _restored, f64  # noqa: F401
from test_torch_units import prng_streams_restored  # noqa: F401
import znicz_tpu.loader.imagenet_loader  # noqa: F401 (registers it)
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.standard_workflow import StandardWorkflow as JaxStandard
import znicz_tpu_torch.loader  # noqa: F401
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core import workflow as workflow_mod
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.standard_workflow import StandardWorkflow

RTOL = 1e-10
SIZE, N_TRAIN, N_VALID, BATCH, EPOCHS, CLASSES = 16, 48, 16, 8, 2, 4
LAYERS = [
    {"name": "conv1", "type": "conv",
     "->": {"n_kernels": 5, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1),
            "weights_stddev": 0.05, "bias_stddev": 0.05},
     "<-": {"learning_rate": 0.02, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
    {"name": "pool1", "type": "max_pooling",
     "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"name": "fc", "type": "softmax",
     "->": {"output_sample_shape": CLASSES, "weights_stddev": 0.05,
            "bias_stddev": 0.05},
     "<-": {"learning_rate": 0.02, "gradient_moment": 0.9}},
]
WF = '''"""The slice's workflow shape over ImagenetLoaderBase's files."""
import os

import znicz_tpu_torch.loader  # noqa: F401 (imagenet_loader_base)
from znicz_tpu_torch.standard_workflow import StandardWorkflow

HERE = os.path.dirname(os.path.abspath(__file__))
LAYERS = %r
FILES = %r


def build(**kwargs):
    wf = StandardWorkflow(
        layers=LAYERS, loader_name="imagenet_loader_base",
        loader_config=dict(FILES, sy=%d, sx=%d, minibatch_size=%d),
        decision_config={"max_epochs": %d, "fail_iterations": 100},
        snapshotter_config={"prefix": "stream", "interval": 1000,
                            "time_interval": 1e9,
                            "directory": os.path.join(HERE, "snaps")},
        preprocessing=True, **kwargs)
    wf.link_repeater(wf.start_point)
    wf.link_loader(wf.repeater)
    norm = wf.link_meandispnorm(wf.loader)
    wf.link_forwards(("input", "output"), norm)
    wf.link_evaluator(wf.forwards[-1])
    wf.link_decision(wf.evaluator)
    wf.link_snapshotter(wf.decision)
    last_gd = wf.link_gds(wf.snapshotter)
    wf.link_loop(last_gd)
    wf.link_end_point(last_gd)
    return wf


def run(load, main):
    load(build)
    main()
'''


def _files(directory, dtype=numpy.float64):
    """ImagenetLoaderBase's four files; the matrixes' mean in ``dtype``
    (in float64 the normalizer's output, and so the forwards, run in
    float64 in either package)."""
    n = N_TRAIN + N_VALID
    r = numpy.random.RandomState(21)
    samples = r.randint(0, 256, (n, SIZE, SIZE, 3), dtype=numpy.uint8)
    labels = r.randint(0, CLASSES, n)
    files = {k: os.path.join(directory, f) for k, f in (
        ("samples_filename", "samples.dat"),
        ("original_labels_filename", "labels.pickle"),
        ("count_samples_filename", "count.json"),
        ("matrixes_filename", "matrixes.pickle"))}
    samples.tofile(files["samples_filename"])
    with open(files["original_labels_filename"], "wb") as f:
        pickle.dump([("c%d" % v, int(v)) for v in labels], f)
    with open(files["count_samples_filename"], "w") as f:
        json.dump({"test": 0, "val": N_VALID, "train": N_TRAIN}, f)
    flat = samples.reshape(n, -1).astype(numpy.float64)
    with open(files["matrixes_filename"], "wb") as f:
        pickle.dump([flat.mean(axis=0).reshape(SIZE, SIZE, 3).astype(dtype),
                     (1.0 / (flat.std(axis=0) + 1.0)).reshape(
                         SIZE, SIZE, 3)], f)
    return files


def _link(wf):
    wf.link_repeater(wf.start_point)
    wf.link_loader(wf.repeater)
    norm = wf.link_meandispnorm(wf.loader)
    wf.link_forwards(("input", "output"), norm)
    wf.link_evaluator(wf.forwards[-1])
    wf.link_decision(wf.evaluator)
    wf.link_snapshotter(wf.decision)
    last_gd = wf.link_gds(wf.snapshotter)
    wf.link_loop(last_gd)
    wf.link_end_point(last_gd)
    return norm


def _jax_run(files, snapdir):
    jax_prng.get(1).seed(1234)
    jax_prng.get(2).seed(5678)
    wf = JaxStandard(
        None, layers=[dict(layer) for layer in LAYERS],
        loader_name="imagenet_loader_base",
        loader_config=dict(files, sy=SIZE, sx=SIZE, minibatch_size=BATCH),
        decision_config={"max_epochs": EPOCHS, "fail_iterations": 100},
        snapshotter_config={"prefix": "stream", "interval": 1000,
                            "time_interval": 1e9, "directory": snapdir},
        preprocessing=True)
    norm = _link(wf)
    # JAX allocates the normalizer's output in float32 (a known
    # difference): allocate it in float64 first, so that its forwards
    # run in float64 as the port's do
    norm.output.reset(numpy.zeros((BATCH, SIZE, SIZE, 3)))
    hist = _recorded(wf)
    wf.initialize(device=JaxDevice())
    wf.run()
    return wf, hist


def _torch_run(files, snapdir):
    prng.get(1).seed(1234)
    prng.get(2).seed(5678)
    wf = StandardWorkflow(
        None, layers=[dict(layer) for layer in LAYERS],
        loader_name="imagenet_loader_base",
        loader_config=dict(files, sy=SIZE, sx=SIZE, minibatch_size=BATCH),
        decision_config={"max_epochs": EPOCHS, "fail_iterations": 100},
        snapshotter_config={"prefix": "stream", "interval": 1000,
                            "time_interval": 1e9, "directory": snapdir},
        preprocessing=True)
    _link(wf)
    hist = _recorded(wf)
    wf.initialize(device="cpu")
    wf.run()
    return wf, hist


def _same_as_jax(twf, thist, jwf, jhist):
    assert [h[0] for h in thist] == [TRAIN, VALID] * EPOCHS
    assert [h[:2] for h in thist] == [h[:2] for h in jhist]
    for t, j in zip(thist, jhist):
        assert (t[2] == j[2]).all()
    assert twf.meandispnorm.output.dtype == numpy.float64
    assert twf.loader.minibatch_data.dtype == numpy.uint8
    n = 0
    for t, j in zip(twf.forwards, jwf.forwards):
        for attr in ("weights", "bias"):
            got, want = getattr(t, attr), getattr(j, attr)
            if not got:
                continue
            got, want = numpy.array(got.mem), numpy.array(want.mem)
            assert got.dtype == want.dtype == numpy.float64
            assert numpy.abs(got - want).max() <= \
                RTOL * numpy.abs(want).max()
            n += 1
    assert n == 4


def test_the_stream_workflow_trains_as_jax(f64, tmp_path):
    files = _files(str(tmp_path))
    jwf, jhist = _jax_run(files, str(tmp_path / "jax"))
    twf, thist = _torch_run(files, str(tmp_path / "torch"))
    _same_as_jax(twf, thist, jwf, jhist)
    assert [tuple(f.output.shape) for f in twf.forwards] == [
        (BATCH, SIZE, SIZE, 5), (BATCH, 8, 8, 5), (BATCH, CLASSES)]
    assert twf.loader._file_samples is None   # closed when the run ended


def test_the_stream_workflow_through_the_launcher(f64, tmp_path,
                                                  monkeypatch):
    files = _files(str(tmp_path))
    wf_file = str(tmp_path / "imagenet_stream_wf.py")
    with open(wf_file, "w") as f:
        f.write(WF % (LAYERS, files, SIZE, SIZE, BATCH, EPOCHS))
    runs, hists = [], []
    real = workflow_mod.Workflow.run

    def run(wf):
        if wf.workflow is None or not isinstance(
                wf.workflow, workflow_mod.Workflow):
            runs.append(wf)
            hists.append(_recorded(wf))
        return real(wf)
    monkeypatch.setattr(workflow_mod.Workflow, "run", run)
    prng.get(1).seed(1234)
    prng.get(2).seed(5678)
    with _restored(root.common):
        cli.main([wf_file, "--device", "cpu"])
    monkeypatch.undo()
    assert len(runs) == 1
    jwf, jhist = _jax_run(files, str(tmp_path / "jax"))
    _same_as_jax(runs[0], hists[0], jwf, jhist)
    assert type(runs[0].loader).__name__ == "ImagenetLoaderBase"
    assert runs[0].loader._file_samples is None


GROUPED = [
    dict(LAYERS[0], **{"->": dict(LAYERS[0]["->"], n_kernels=4)}),
    LAYERS[1],
    {"name": "grouping1", "type": "zero_filter", "grouping": 2},
    {"name": "conv2", "type": "conv_str",
     "->": {"n_kernels": 6, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1),
            "weights_stddev": 0.05, "bias_stddev": 0.05},
     "<-": {"learning_rate": 0.02}},
    {"name": "relu7", "type": "activation_str"},
    LAYERS[2]]


def test_the_forward_workflow_with_the_printer_and_accumulators(tmp_path):
    """The chip phase's (b) on the CPU: the trained stream workflow's
    extracted forward workflow (a zero filter among its forwards) behind
    an ``InteractiveLoader`` fed the VALID rows, normalized on the host,
    with a LabelsPrinter on ``max_idx``, a FixAccumulator on relu7 and a
    RangeAccumulator on the softmax: the outputs equal the trained
    graph's own forwards on the same rows, the printer's tally their
    argmax's, the bars numpy's by JAX's rule.  JAX's
    ``extract_forward_workflow`` raises on the zero filter (no weight
    broadcast): a known difference."""
    from znicz_tpu_torch.loader.interactive import InteractiveLoader
    from znicz_tpu_torch.units.accumulator import (FixAccumulator,
                                                   RangeAccumulator)
    from znicz_tpu_torch.units.labels_printer import LabelsPrinter
    files = _files(str(tmp_path), numpy.float32)
    prng.get(1).seed(1234)
    prng.get(2).seed(5678)
    config = dict(loader_name="imagenet_loader_base",
                  loader_config=dict(files, sy=SIZE, sx=SIZE,
                                     minibatch_size=N_VALID),
                  decision_config={"max_epochs": 1, "fail_iterations": 9},
                  snapshotter_config={"prefix": "stream", "interval": 1000,
                                      "time_interval": 1e9,
                                      "directory": str(tmp_path / "s")},
                  preprocessing=True)
    wf = StandardWorkflow(None, layers=[dict(la) for la in GROUPED],
                          **config)
    _link(wf)
    wf.initialize(device="cpu")
    wf.run()
    loader = wf.loader
    raw = numpy.fromfile(files["samples_filename"], numpy.uint8).reshape(
        -1, SIZE, SIZE, 3)[:N_VALID]
    rows = (raw.astype(numpy.float32) - loader.mean.mem) * loader.rdisp.mem
    assert rows.dtype == numpy.float32
    held = []

    def factory(fwd_wf):
        held.append(InteractiveLoader(fwd_wf, sample_shape=rows.shape[1:],
                                      minibatch_size=N_VALID))
        return held[-1]
    fwd_wf = wf.extract_forward_workflow(loader_factory=factory)
    assert [type(f).__name__ for f in fwd_wf.forwards][2] == "ZeroFiller"
    head = fwd_wf.forwards[-1]
    relu7 = {f.name: f for f in fwd_wf.forwards}["relu7_forward"]
    printer = LabelsPrinter(fwd_wf, name="printer")
    printer.input = head.max_idx
    fix = FixAccumulator(fwd_wf, name="fix", type="relu", bars=30)
    fix.input = relu7.output
    rng = RangeAccumulator(fwd_wf, name="range", bars=7)
    rng.input = head.output
    for unit in (printer, fix, rng):
        unit.link_from(head)
    fwd_wf.end_point.link_from(printer, fix, rng)
    fwd_wf.initialize(device="cpu")
    for row in rows:
        held[0].feed(row)
    held[0].finish()
    fwd_wf.run()
    assert (printer.run_count_, fix.run_count_, rng.run_count_) == (1, 1, 1)
    out = numpy.array(head.output.mem)
    # the trained graph's own forwards on the same rows
    x = wf.forwards[0].input
    x.map_write()
    x.mem[...] = rows
    for f in wf.forwards:
        f.forward_mode = True
        f.run()
    assert numpy.array_equal(out, wf.forwards[-1].output.mem)
    tally = {}
    for v in out.argmax(axis=1):
        tally[int(v)] = tally.get(int(v), 0) + 1
    assert dict(printer.counter) == tally
    hidden = numpy.array(relu7.output.mem).ravel()
    bars = numpy.zeros(32, numpy.int64)
    below, inside = hidden < 0, (hidden > 0) & (hidden <= 10000)
    bars[0] += below.sum()
    bars[31] += (~below & ~inside).sum()
    numpy.add.at(bars, numpy.floor(
        (hidden[inside] - 0) * (29 / 10000)).astype(int), 1)
    assert numpy.array_equal(fix.output.mem, bars)
    hist, _ = numpy.histogram(out.ravel(), bins=7,
                              range=(float(out.min()), float(out.max())))
    assert rng.y == hist.tolist()
    # JAX's extraction of the same graph
    jax_prng.get(1).seed(1234)
    jax_prng.get(2).seed(5678)
    jwf = JaxStandard(None, layers=[dict(la) for la in GROUPED], **config)
    _link(jwf)
    from znicz_tpu.loader.interactive import InteractiveLoader as JaxLoader
    with pytest.raises(AttributeError, match="generate_data_for_slave"):
        jwf.extract_forward_workflow(loader_factory=lambda w: JaxLoader(
            w, sample_shape=rows.shape[1:], minibatch_size=N_VALID))
