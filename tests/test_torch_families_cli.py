"""The four samples of the Kohonen, RBM and LSTM families through the
port's CLI (``python -m znicz_tpu_torch NAME``), on the CPU:

* ``--dry-run --device cpu`` builds and initializes each at its
  published config (the (8, 8) maps, the 784 -> 1000 RBM, the 32-unit
  scan LSTM);
* without CUDA and without ``--device cpu`` each raises "CUDA is not
  available" before it trains;
* each trains an epoch or two with ``--device cpu`` and a short
  ``--config``.
"""

import os

import numpy
import pytest
import torch

from test_torch_mnist import _one_torch_thread, _restored  # noqa: F401
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.samples import (demo_kohonen, mnist_rbm,  # noqa: F401
                                     sequence)
from znicz_tpu_torch.samples.research import spam_kohonen  # noqa: F401

NAMES = ("demo_kohonen", "research.spam_kohonen", "mnist_rbm", "sequence")


def _argv(name, tmp_path, *extra):
    """The CLI's arguments, with every file the run writes under
    ``tmp_path``."""
    argv = [name]
    if name == "research.spam_kohonen":
        argv += ["--config", "spam_kohonen.exporter.file=%s"
                 % (tmp_path / "classified.txt")]
    if name == "sequence":
        argv += ["--config", "sequence.snapshotter.directory=%s" % tmp_path]
    return argv + list(extra)


def _config(name):
    ns = {"demo_kohonen": "kohonen", "research.spam_kohonen":
          "spam_kohonen"}.get(name, name)
    node = getattr(root, ns)
    return _restored(*[node] + [getattr(node, k) for k in
                                ("decision", "exporter", "snapshotter",
                                 "loader", "rbm")
                                if k in node.__dict__])


@pytest.fixture
def launched(monkeypatch):
    """The workflows the launcher built, in order."""
    from znicz_tpu_torch import launcher
    built = []
    real = launcher.Launcher.main

    def main(self, **kwargs):
        built.append(real(self, **kwargs))
        return built[-1]
    monkeypatch.setattr(launcher.Launcher, "main", main)
    return built


@pytest.mark.parametrize("name", NAMES)
def test_dry_run_builds_on_cpu(name, tmp_path, launched):
    with _config(name):
        assert cli.main(_argv(name, tmp_path, "--dry-run", "--device",
                              "cpu")) == 0
    wf = launched[-1]
    if name == "mnist_rbm":
        assert wf.hidden.weights.shape == (1000, 784)
        assert wf.loader.max_minibatch_size == 128
    elif name == "sequence":
        assert wf.forwards[0].hidden == 32
        assert wf.loader.minibatch_data.shape == (50, 12, 8)
    else:
        assert wf.trainer.weights.shape[0] == 64
        assert wf.trainer.weights.dev.device.type == "cpu"
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("name", NAMES)
def test_needs_cuda_unless_cpu_asked(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with _config(name):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(_argv(name, tmp_path))


@pytest.mark.parametrize("name,overrides", [
    ("demo_kohonen", ["kohonen.decision.epochs=2"]),
    ("research.spam_kohonen", ["spam_kohonen.decision.epochs=1"]),
    ("mnist_rbm", ["mnist_rbm.decision.max_epochs=1",
                   "mnist_rbm.loader.synthetic_train=256",
                   "mnist_rbm.rbm.h_size=32"]),
    ("sequence", ["sequence.decision.max_epochs=1"])])
def test_cli_trains_on_cpu(name, overrides, tmp_path, launched):
    extra = ["--device", "cpu"]
    for o in overrides:
        extra += ["--config", o]
    with _config(name):
        assert cli.main(_argv(name, tmp_path, *extra)) == 0
    wf = launched[-1]
    assert wf.decision.complete
    if name == "mnist_rbm":
        assert numpy.isfinite(wf.reconstruction_mse())
        assert wf.loader.epoch_number == 1
    elif name == "sequence":
        assert wf.decision.epoch_number == 1
        assert any(f.startswith("sequence_") for f in os.listdir(tmp_path))
    else:
        assert numpy.isfinite(wf.trainer.weights.mem).all()
    if name == "research.spam_kohonen":
        lines = (tmp_path / "classified.txt").read_text().splitlines()
        assert len(lines) == 400
