"""The port's Lines sample and the mcdnnic topology
(``samples/lines.py``, ``standard_workflow_base.py``) against the JAX
package's, on the CPU.

* The mcdnnic parser: the layer list of the JAX test's topology
  ``8x32x32-6C4-MP2-6C4-MP3-16N-4N`` (``tests/functional/
  test_samples.py:40-56``) and of the published
  ``12x256x256-32C4-MP2-64C4-MP3-32N-4N`` equal JAX's
  ``_get_layers_from_mcdnnic``, with ``mcdnnic_parameters`` in every
  layer; the input part sets the loader's ``minibatch_size`` and
  ``scale``; layers and a topology together raise, as no layers
  without ``preprocessing`` does; ``dictify`` / ``config2kwargs`` /
  ``loader_factory``.
* The synthetic writer writes the JAX writer's PNGs, byte for byte.
* Lines at the JAX test's topology on data under ``tmp_path``, seeded
  as ``test_torch_zoo._train``: in float64 the (class, n_err) at every
  segment end equals JAX's and every weight and bias is within
  ``RTOL`` = 1e-12 of the largest of JAX's (the zoo's tolerance), in
  the unit graph and through ``--fused pool_impl=offsets``; in float32
  it clears JAX's "clearly learning" bar (best TRAIN error under 40%).
* ``python -m znicz_tpu_torch lines --device cpu`` trains with a
  capped ``max_epochs``; without CUDA and without ``--device cpu`` it
  raises.
"""

import os

import numpy
import pytest
import torch

from test_torch_autoencoder import _close, f64  # noqa: F401
from test_torch_mnist import _one_torch_thread, _restored  # noqa: F401
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.samples import lines as jax_lines
from znicz_tpu.standard_workflow_base import \
    StandardWorkflowBase as JaxBase
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.samples import lines
from znicz_tpu_torch.standard_workflow import StandardWorkflow
from znicz_tpu_torch.standard_workflow_base import StandardWorkflowBase
import znicz_tpu_torch.loader.loader_wine  # noqa: F401 (wine_loader)

RTOL = 1e-12
TOPOLOGY = "8x32x32-6C4-MP2-6C4-MP3-16N-4N"
PARAMETERS = {"<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The JAX test's synthetic set (32x32, 12 + 4 images a class),
    written once by the port's writer."""
    base = tmp_path_factory.mktemp("lines")
    return lines.materialize_synthetic(str(base / "lines"), size=32)


def _loader(data):
    return {"train_paths": [os.path.join(data, "learn")],
            "validation_paths": [os.path.join(data, "test")]}


def _train(module, device, data, snapdir, epochs, **kwargs):
    """Seed both streams as ``test_torch_zoo._train``, build at the
    JAX test's topology, initialize and run; returns the workflow and
    its (class, n_err) at every segment end."""
    for p in (prng, jax_prng):
        p.get(1).seed(1234)
        p.get(2).seed(5678)
    if module is lines:
        kwargs["snapshotter_config"] = {"directory": str(snapdir)}
    wf = module.build(
        mcdnnic_topology=TOPOLOGY, mcdnnic_parameters=PARAMETERS,
        loader_config=_loader(data),
        decision_config={"max_epochs": epochs, "fail_iterations": 100},
        **kwargs)
    seq, d = [], wf.decision
    real = d.on_last_minibatch

    def on_last_minibatch():
        real()
        c = d.minibatch_class
        seq.append((int(c), int(d.epoch_n_err[c])))
    d.on_last_minibatch = on_last_minibatch
    wf.initialize(device=device)
    wf.run()
    return wf, seq


def _params(wf):
    if getattr(wf, "fused_trainer", None) is not None:
        return [(numpy.array(p["w"]), numpy.array(p["b"]))
                for p in wf.fused_trainer.net.host_params() if p]
    return [(numpy.array(f.weights.mem), numpy.array(f.bias.mem))
            for f in wf.forwards if f.weights]


# -- the mcdnnic topology ----------------------------------------------------

@pytest.mark.parametrize("topology,parameters", [
    (TOPOLOGY, PARAMETERS),
    ("12x256x256-32C4-MP2-64C4-MP3-32N-4N", {"<-": {"learning_rate": 0.01}}),
    ("784x28x28-32C5-MP2-100N-10N", None),
    ("4x8x8-3C3-2N", {"->": {"weights_stddev": 0.1}, "<-": {}})])
def test_layers_from_mcdnnic_equal_jax(topology, parameters):
    got = StandardWorkflowBase._get_layers_from_mcdnnic(
        _Parser(parameters), topology)
    want = JaxBase._get_layers_from_mcdnnic(_Parser(parameters), topology)
    assert got == want
    assert [l["type"] for l in got][-1] == "softmax"
    kwargs = StandardWorkflowBase._update_loader_kwargs_from_mcdnnic(
        {"minibatch_size": 99}, topology)
    assert kwargs == JaxBase._update_loader_kwargs_from_mcdnnic(
        {"minibatch_size": 99}, topology)
    b, h, w = (int(v) for v in topology.split("-")[0].split("x"))
    assert kwargs == {"minibatch_size": b, "scale": (h, w)}


class _Parser(object):
    """The parser's state: its ``mcdnnic_parameters`` alone."""

    mcdnnic_layer_pattern = StandardWorkflowBase.mcdnnic_layer_pattern

    def __init__(self, parameters):
        self.mcdnnic_parameters = parameters

    def _get_mcdnnic_parameters(self, arrow):
        return StandardWorkflowBase._get_mcdnnic_parameters(self, arrow)

    dictify = staticmethod(StandardWorkflowBase.dictify)
    _parse_mcdnnic_c = staticmethod(StandardWorkflowBase._parse_mcdnnic_c)
    _parse_mcdnnic_mp = staticmethod(StandardWorkflowBase._parse_mcdnnic_mp)
    _parse_mcdnnic_n = staticmethod(StandardWorkflowBase._parse_mcdnnic_n)


def test_the_sample_builds_from_its_topology(data, tmp_path):
    wf = lines.build(mcdnnic_topology=TOPOLOGY, loader_config=_loader(data),
                     snapshotter_config={"directory": str(tmp_path)})
    assert wf.layers == JaxBase._get_layers_from_mcdnnic(
        _Parser(root.lines.mcdnnic_parameters.as_dict()), TOPOLOGY)
    assert wf.loader.max_minibatch_size == 8
    assert tuple(wf.loader.scale) == (32, 32)
    assert wf.loader.normalization_type == "mean_disp"
    assert [type(f).__name__ for f in wf.forwards] == [
        "Conv", "MaxPooling", "Conv", "MaxPooling", "All2All",
        "All2AllSoftmax"]
    assert [g.learning_rate for g in wf.gds] == [0.01] * 6
    wf.initialize(device="cpu")
    assert [tuple(f.output.shape) for f in wf.forwards] == [
        (8, 29, 29, 6), (8, 15, 15, 6), (8, 12, 12, 6), (8, 4, 4, 6),
        (8, 16), (8, 4)]
    assert wf.loader.class_lengths == [0, 16, 48]
    assert wf.loader.labels_mapping == {
        "diag_down": 0, "diag_up": 1, "horizontal": 2, "vertical": 3}
    assert wf.loader.has_labels


def test_topology_and_layers_config():
    kwargs = dict(loader_name="wine_loader")
    with pytest.raises(ValueError, match="same time"):
        StandardWorkflowBase(None, mcdnnic_topology=TOPOLOGY,
                             layers=[{"type": "softmax"}], **kwargs)
    with pytest.raises(ValueError, match="mcdnnic_topology is not defined"):
        StandardWorkflowBase(None, **kwargs)
    with pytest.raises(ValueError, match="list of dicts"):
        StandardWorkflowBase(None, layers=["softmax"], **kwargs)
    pre = StandardWorkflowBase(None, preprocessing=True, **kwargs)
    assert pre.layers == [{}] and pre.preprocessing
    wf = StandardWorkflow(None, preprocessing=True, **kwargs)
    assert wf.loader is None and not wf.forwards
    with pytest.raises(TypeError, match="callable"):
        StandardWorkflowBase(None, mcdnnic_topology=TOPOLOGY,
                             loader_factory="wine_loader")


def test_config_plumbing():
    node = root.lines.loader
    assert StandardWorkflowBase.dictify(node) == node.as_dict()
    assert StandardWorkflowBase.dictify({"a": 1}) == {"a": 1}
    wf = StandardWorkflowBase(None, mcdnnic_topology=TOPOLOGY,
                              loader_name="wine_loader",
                              loader_config={"minibatch_size": 3})
    assert wf.config2kwargs(None) == {}
    assert wf.config2kwargs(root.lines.decision) == \
        root.lines.decision.as_dict()
    assert wf.loader_name == "wine_loader"
    # the topology's input part wins over the loader config
    assert wf.loader_factory(wf).max_minibatch_size == 8
    made = []
    wf.loader_factory = lambda w: made.append(w) or "a loader"
    assert wf.loader_name is None and wf.loader_factory(wf) == "a loader"
    assert made == [wf]


def test_materialize_writes_the_jax_pngs(tmp_path):
    got = lines.materialize_synthetic(str(tmp_path / "port"), size=16,
                                      per_class=3)
    want = jax_lines.materialize_synthetic(str(tmp_path / "jax"), size=16,
                                           per_class=3)
    files = sorted(os.path.relpath(os.path.join(d, f), want)
                   for d, _, fs in os.walk(want) for f in fs)
    assert len(files) == 4 * (3 + 2)
    assert files == sorted(os.path.relpath(os.path.join(d, f), got)
                           for d, _, fs in os.walk(got) for f in fs)
    for f in files:
        with open(os.path.join(got, f), "rb") as a, \
                open(os.path.join(want, f), "rb") as b:
            assert a.read() == b.read(), f
    # an existing set is left as it is
    assert lines.materialize_synthetic(got, size=8) == got


# -- training against znicz_tpu ----------------------------------------------

def test_matches_jax_float64(f64, data, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_root.common.dirs, "snapshots", str(tmp_path))
    jwf, jseq = _train(jax_lines, JaxDevice(), data, tmp_path, 4)
    twf, tseq = _train(lines, "cpu", data, tmp_path, 4)
    assert tseq == jseq and len(tseq) == 8
    assert twf.loader.class_lengths == list(jwf.loader.class_lengths)
    assert twf.layers == jwf.layers
    assert [tuple(f.output.shape) for f in twf.forwards] == \
        [tuple(f.output.shape) for f in jwf.forwards]
    got, want = _params(twf), _params(jwf)
    assert len(got) == len(want) == 4
    for (gw, gb), (ww, wb) in zip(got, want):
        assert gw.dtype == numpy.float64
        _close(gw, ww, RTOL, "weights")
        _close(gb, wb, RTOL, "bias")


def test_fused_matches_jax_float64(f64, data, tmp_path, monkeypatch):
    """``--fused pool_impl=offsets`` (both kernels' plain versions on
    the CPU) against JAX's unit graph: the same steps give the same
    run."""
    monkeypatch.setattr(jax_root.common.dirs, "snapshots", str(tmp_path))
    jwf, jseq = _train(jax_lines, JaxDevice(), data, tmp_path, 3)
    twf, tseq = _train(lines, "cpu", data, tmp_path, 3,
                       fused={"pool_impl": "offsets"})
    assert twf.fused_trainer is not None
    assert tseq == jseq
    for (gw, gb), (ww, wb) in zip(_params(twf), _params(jwf)):
        _close(gw, ww, RTOL, "weights")
        _close(gb, wb, RTOL, "bias")


def test_learns_float32(data, tmp_path):
    """JAX's bar (``test_lines_mcdnnic_topology_trains``): the 4
    orientations are clearly learnable at the test topology."""
    wf, _ = _train(lines, "cpu", data, tmp_path, 40)
    assert wf.forwards[-1].output.shape[1] == 4
    assert wf.forwards[0].weights.mem.dtype == numpy.float32
    assert wf.loader.class_lengths[VALID] > 0
    assert wf.decision.best_n_err_pt[TRAIN] < 40.0, wf.decision.best_n_err_pt


# -- the CLI -----------------------------------------------------------------

def _argv(data, tmp_path, *extra):
    return ["lines",
            "--config", "lines.mcdnnic_topology=%s" % TOPOLOGY,
            "--config", "lines.loader.train_paths=[%r]"
            % os.path.join(data, "learn"),
            "--config", "lines.loader.validation_paths=[%r]"
            % os.path.join(data, "test"),
            "--config", "lines.decision.max_epochs=2",
            "--config", "lines.snapshotter.directory=%s" % tmp_path
            ] + list(extra)


def _lines_config():
    return _restored(root.lines, root.lines.loader, root.lines.decision,
                     root.lines.snapshotter)


@pytest.mark.parametrize("extra", [(), ("--fused", "pool_impl=offsets")],
                         ids=["units", "fused"])
def test_cli_trains_lines_on_cpu(data, tmp_path, capsys, extra):
    with _lines_config():
        assert cli.main(_argv(data, tmp_path, "--device", "cpu",
                              *extra)) == 0
        wf = cli.run_workflow_cli(_argv(data, tmp_path, "--device", "cpu",
                                        *extra))
    assert wf.loader.epoch_number == 2
    assert (wf.fused_trainer is None) == (not extra)
    assert "best val/train err%: [None, " in capsys.readouterr().out
    assert any(f.startswith("lines_") for f in os.listdir(tmp_path))


def test_cli_needs_cuda_unless_cpu_asked(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with _lines_config():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(_argv(data, tmp_path, "--dry-run"))
        assert cli.main(_argv(data, tmp_path, "--dry-run", "--device",
                              "cpu")) == 0
