"""Determinism is the training default on the card.

``core.backends.deterministic`` on a ``torch.device("cuda")`` (made
here without a card: it only reads the device's type) sets
``cudnn.deterministic`` and clears ``cudnn.benchmark`` unless
``root.common.engine.deterministic`` is False, and changes nothing for
the CPU.  The workflow CLI (the launcher), the forward and GD units and
``FusedNet`` call it with their device.  ``chip_smoke.py``'s CIFAR
replay holds it on the card.
"""

import contextlib

import pytest
import torch

from test_torch_mnist import _restored
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch import launcher
from znicz_tpu_torch.core import backends
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.parallel import fused
from znicz_tpu_torch.samples import cifar
from znicz_tpu_torch.units import nn_units


@contextlib.contextmanager
def _cudnn_flags(deterministic, benchmark):
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = benchmark
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def test_deterministic_is_the_default_on_cuda():
    assert root.common.engine.deterministic is True
    with _cudnn_flags(False, True):
        assert backends.deterministic(torch.device("cuda")) is True
        assert torch.backends.cudnn.deterministic is True
        assert torch.backends.cudnn.benchmark is False


def test_the_knob_lets_cudnn_choose():
    with _restored(root.common.engine), _cudnn_flags(True, True):
        root.common.engine.deterministic = False
        assert backends.deterministic(torch.device("cuda")) is False
        assert torch.backends.cudnn.deterministic is False
        assert torch.backends.cudnn.benchmark is True


def test_cpu_flags_untouched():
    with _cudnn_flags(False, True):
        assert backends.deterministic(torch.device("cpu")) is True
        assert torch.backends.cudnn.deterministic is False
        assert torch.backends.cudnn.benchmark is True


@pytest.fixture
def calls(monkeypatch):
    """Every call of ``deterministic`` from the launcher, the units and
    FusedNet, by caller."""
    seen = []
    for mod in (launcher, nn_units, fused):
        def record(device, mod=mod):
            seen.append((mod.__name__.rsplit(".", 1)[-1], device.type))
            return backends.deterministic(device)
        monkeypatch.setattr(mod, "deterministic", record)
    return seen


def _cifar_argv(tmp_path, *extra):
    return ["cifar", "--dry-run", "--device", "cpu",
            "--config", "cifar.loader.synthetic_train=40",
            "--config", "cifar.loader.synthetic_valid=20",
            "--config", "cifar.loader.minibatch_size=20",
            "--config", "cifar.snapshotter.directory=%s" % tmp_path
            ] + list(extra)


@pytest.mark.parametrize("extra", [(), ("--fused", "pool_impl=offsets")],
                         ids=["units", "fused"])
def test_the_cli_path_calls_it(tmp_path, calls, extra):
    with _restored(root.cifar, root.cifar.loader, root.cifar.snapshotter):
        assert cli.main(_cifar_argv(tmp_path, *extra)) == 0
    assert calls[0] == ("launcher", "cpu")
    callers = {c for c, _ in calls}
    assert ("fused" in callers) == bool(extra)
    assert ("nn_units" in callers) != bool(extra)


def test_fused_net_calls_it(calls):
    fused.FusedNet(cifar.root.cifar.layers, (32, 32, 3),
                   pool_impl="offsets", device="cpu")
    assert calls == [("fused", "cpu")]
