"""The port's import rule and device rule.

* Importing every module of ``znicz_tpu_torch`` (and ``chip_smoke``)
  in a fresh interpreter brings in no ``jax*`` module and nothing of
  ``znicz_tpu`` — careful: ``znicz_tpu_torch`` itself starts with
  ``znicz_tpu``.
* Entry points run on CUDA unless told ``device="cpu"``; without CUDA
  they raise instead of carrying on on the CPU.
"""

import json
import os
import subprocess
import sys

import numpy
import pytest
import torch

from znicz_tpu_torch.core.backends import default_device
from znicz_tpu_torch.serving.engine import InferenceEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
before = set(sys.modules)
import znicz_tpu_torch
names = ["znicz_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(znicz_tpu_torch.__path__,
                                          "znicz_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
new = set(sys.modules) - before
bad = sorted(n for n in new if n.startswith("jax") or n == "znicz_tpu"
             or n.startswith("znicz_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_znicz_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    doc = json.loads(out.strip().splitlines()[-1])
    assert doc["bad"] == []
    for name in ("znicz_tpu_torch.ops.cuda_pooling",
                 "znicz_tpu_torch.ops.cuda_pooling_backward",
                 "znicz_tpu_torch.ops.gd_math",
                 "znicz_tpu_torch.ops.evaluator",
                 "znicz_tpu_torch.ops.init",
                 "znicz_tpu_torch.core.prng",
                 "znicz_tpu_torch.parallel.fused",
                 "znicz_tpu_torch.serving.server",
                 "znicz_tpu_torch.samples.alexnet",
                 "znicz_tpu_torch.core.mutable",
                 "znicz_tpu_torch.core.units",
                 "znicz_tpu_torch.core.workflow",
                 "znicz_tpu_torch.core.memory",
                 "znicz_tpu_torch.core.accelerated_units",
                 "znicz_tpu_torch.core.normalization",
                 "znicz_tpu_torch.core.snapshotter",
                 "znicz_tpu_torch.loader.base",
                 "znicz_tpu_torch.units.evaluator",
                 "znicz_tpu_torch.units.decision",
                 "znicz_tpu_torch.units.nn_units",
                 "znicz_tpu_torch.units.fused_trainer",
                 "znicz_tpu_torch.standard_workflow_base",
                 "znicz_tpu_torch.standard_workflow",
                 "znicz_tpu_torch.launcher",
                 "znicz_tpu_torch.__main__",
                 "znicz_tpu_torch.units.all2all",
                 "znicz_tpu_torch.units.conv",
                 "znicz_tpu_torch.units.pooling",
                 "znicz_tpu_torch.units.gd",
                 "znicz_tpu_torch.units.gd_conv",
                 "znicz_tpu_torch.units.gd_pooling",
                 "znicz_tpu_torch.units.activation",
                 "znicz_tpu_torch.units.dropout",
                 "znicz_tpu_torch.units.normalization",
                 "znicz_tpu_torch.loader.loader_mnist",
                 "znicz_tpu_torch.samples.mnist",
                 "znicz_tpu_torch.params",
                 "znicz_tpu_torch.ops.dense",
                 "znicz_tpu_torch.ops.conv",
                 "znicz_tpu_torch.ops.normalization",
                 "znicz_tpu_torch.units.deconv",
                 "znicz_tpu_torch.units.depooling",
                 "znicz_tpu_torch.units.zerofilling",
                 "znicz_tpu_torch.units.cutter",
                 "znicz_tpu_torch.units.multiplier",
                 "znicz_tpu_torch.units.summator",
                 "znicz_tpu_torch.units.resizable_all2all",
                 "znicz_tpu_torch.units.rprop_gd",
                 "znicz_tpu_torch.samples.mnist7",
                 "znicz_tpu_torch.samples.mnist_ae",
                 "znicz_tpu_torch.units.lr_adjust",
                 "znicz_tpu_torch.loader.loader_cifar",
                 "znicz_tpu_torch.samples.cifar",
                 "znicz_tpu_torch.export",
                 "znicz_tpu_torch.serving.quant",
                 "znicz_tpu_torch.serving.breaker",
                 "znicz_tpu_torch.serving.engine",
                 "znicz_tpu_torch.serving.registry",
                 "znicz_tpu_torch.serving.continuous",
                 "znicz_tpu_torch.serving.accuracy",
                 "znicz_tpu_torch.loader.image",
                 "znicz_tpu_torch.loader.loader_stl",
                 "znicz_tpu_torch.loader.loader_wine",
                 "znicz_tpu_torch.samples.research",
                 "znicz_tpu_torch.samples.research.stl10",
                 "znicz_tpu_torch.samples.research.mnist_simple",
                 "znicz_tpu_torch.samples.research.wine_relu",
                 "znicz_tpu_torch.samples.research.hands",
                 "znicz_tpu_torch.samples.research.tv_channels",
                 "znicz_tpu_torch.samples.wine",
                 "znicz_tpu_torch.samples.yale_faces",
                 "znicz_tpu_torch.loader.image_mse",
                 "znicz_tpu_torch.samples.approximator",
                 "znicz_tpu_torch.samples.kanji",
                 "znicz_tpu_torch.samples.research.video_ae",
                 "znicz_tpu_torch.samples.research.imagenet_ae",
                 "znicz_tpu_torch.core.telemetry",
                 "znicz_tpu_torch.core.faults",
                 "znicz_tpu_torch.core.health",
                 "znicz_tpu_torch.core.status_server",
                 "znicz_tpu_torch.units.nn_rollback"):
        assert name in doc["modules"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_needs_cuda_unless_cpu_asked(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_device("cuda")
    assert default_device("cpu") == torch.device("cpu")


def test_engine_refuses_to_fall_back_to_cpu(no_cuda):
    # a one-layer package: 4 inputs -> softmax over 2 classes
    package = ({"format": 1, "input_sample_shape": [4], "layers": [
        {"type": "softmax", "arrays": {"weights": "w.npy", "bias": "b.npy"}}]},
        {"w.npy": numpy.ones((2, 4), numpy.float32),
         "b.npy": numpy.zeros(2, numpy.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(package, max_batch=2)
    engine = InferenceEngine(package, max_batch=2, device="cpu")
    assert engine.device.type == "cpu" and engine.ready
