"""The port's import rule and device rule.

* Importing every module of ``znicz_tpu_torch`` (and ``chip_smoke``)
  in a fresh interpreter brings in no ``jax*`` module and nothing of
  ``znicz_tpu`` — careful: ``znicz_tpu_torch`` itself starts with
  ``znicz_tpu``; nor do the ranks of a gloo gang.
* Entry points run on CUDA unless told ``device="cpu"``; without CUDA
  they raise instead of carrying on on the CPU.
* The analysis layer (``znicz_tpu_torch.analysis``) imports only the
  port's config, not torch itself.
* The avatar's producer thread makes no call into ``torch.cuda`` (nor
  into any other part of torch): a thread's first CUDA product would
  take a cuBLAS workspace for the life of the process.
"""

import ast
import collections
import json
import os
import subprocess
import sys
import threading

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
                 "znicz_tpu_torch.units.nn_rollback",
                 "znicz_tpu_torch.core.profiler",
                 "znicz_tpu_torch.core.timeseries",
                 "znicz_tpu_torch.core.pyprof",
                 "znicz_tpu_torch.core.blackbox",
                 "znicz_tpu_torch.serving.latency",
                 "znicz_tpu_torch.serving.slo",
                 "znicz_tpu_torch.serving.reqtrace",
                 "znicz_tpu_torch.serving.wire",
                 "znicz_tpu_torch.serving.router",
                 "znicz_tpu_torch.samples.lines",
                 "znicz_tpu_torch.loader.interactive",
                 "znicz_tpu_torch.parity",
                 "znicz_tpu_torch.core.distributable",
                 "znicz_tpu_torch.core.input_joiner",
                 "znicz_tpu_torch.ops.kohonen",
                 "znicz_tpu_torch.ops.recurrent",
                 "znicz_tpu_torch.units.kohonen",
                 "znicz_tpu_torch.units.rbm_units",
                 "znicz_tpu_torch.units.lstm",
                 "znicz_tpu_torch.units.lstm_scan",
                 "znicz_tpu_torch.samples.demo_kohonen",
                 "znicz_tpu_torch.samples.research.spam_kohonen",
                 "znicz_tpu_torch.samples.mnist_rbm",
                 "znicz_tpu_torch.samples.sequence",
                 "znicz_tpu_torch.core.avatar",
                 "znicz_tpu_torch.core.plotting_units",
                 "znicz_tpu_torch.core.publishing",
                 "znicz_tpu_torch.core.downloader",
                 "znicz_tpu_torch.core.interaction",
                 "znicz_tpu_torch.units.nn_plotting_units",
                 "znicz_tpu_torch.units.diversity",
                 "znicz_tpu_torch.units.image_saver",
                 "znicz_tpu_torch.units.mean_disp_normalizer",
                 "znicz_tpu_torch.units.diff_stats",
                 "znicz_tpu_torch.loader.saver",
                 "znicz_tpu_torch.core.genetics",
                 "znicz_tpu_torch.parallel.population",
                 "znicz_tpu_torch.loader.caffe",
                 "znicz_tpu_torch.loader.lmdb_native",
                 "znicz_tpu_torch.loader.loader_lmdb",
                 "znicz_tpu_torch.loader.pickles",
                 "znicz_tpu_torch.loader.imagenet_loader",
                 "znicz_tpu_torch.units.accumulator",
                 "znicz_tpu_torch.units.labels_printer",
                 "znicz_tpu_torch.testing",
                 "znicz_tpu_torch.core.compile_cache",
                 "znicz_tpu_torch.analysis",
                 "znicz_tpu_torch.analysis.locksmith",
                 "znicz_tpu_torch.analysis.graftlint",
                 "znicz_tpu_torch.parallel.mesh",
                 "znicz_tpu_torch.parallel.multihost",
                 "znicz_tpu_torch.parallel.sequence",
                 "znicz_tpu_torch.samples.research.long_context"):
        assert name in doc["modules"]


def test_a_gang_s_ranks_import_no_jax_and_no_znicz_tpu():
    """The ranks of a gloo gang (``testing.run_gang``, fresh spawned
    processes) that import every multi-process module of the port and
    the gang's test bodies hold no ``jax*`` module and nothing of
    ``znicz_tpu``, although the test process holds both."""
    import torch_gang
    from znicz_tpu_torch import testing
    assert "jax" in sys.modules
    assert testing.run_gang(torch_gang.imported, 2, timeout_s=120) == \
        [[], []]


def test_the_analysis_layer_imports_no_torch_itself():
    """The sanitizer and the checkers import the port's config alone
    (the package's ``__init__`` brings torch in, they do not), and
    importing them brings in nothing of jax or ``znicz_tpu``."""
    for name in ("locksmith", "graftlint"):
        path = os.path.join(REPO, "znicz_tpu_torch", "analysis",
                            name + ".py")
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        mods = {a.name for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names} | {
            n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom)}
        assert {m.split(".")[0] for m in mods} <= {
            "ast", "os", "re", "sys", "threading", "traceback",
            "concurrent", "znicz_tpu_torch"}, mods
        assert {m for m in mods if m.startswith("znicz_tpu_torch")} <= {
            "znicz_tpu_torch.core.config", "znicz_tpu_torch.core"}, mods
    probe = ("import json, sys\n"
             "from znicz_tpu_torch.analysis import graftlint, locksmith\n"
             "graftlint.load_vocabulary()\n"
             "print(json.dumps(sorted(m for m in sys.modules if m in "
             "('jax', 'znicz_tpu') or "
             "m.startswith(('jax.', 'znicz_tpu.')))))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


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


def test_the_avatar_producer_calls_nothing_of_torch_cuda():
    """Every call on an avatar's producer thread is seen through
    ``threading.setprofile``: none lands in ``torch.cuda`` or anywhere
    else in torch, while the producer served minibatches."""
    import znicz_tpu_torch.loader.loader_wine  # noqa: F401
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.avatar import THREAD_PREFIX, Avatar
    from znicz_tpu_torch.core.workflow import Workflow
    from znicz_tpu_torch.loader.loader_wine import WineLoader
    calls = collections.Counter()
    cuda = collections.Counter()
    seen = set()

    def watch(frame, event, arg):
        name = threading.current_thread().name
        if not name.startswith(THREAD_PREFIX):
            return
        seen.add(name)
        if event == "call":
            mod = frame.f_globals.get("__name__", "")
        elif event == "c_call":
            mod = getattr(arg, "__module__", None) or ""
        else:
            return
        calls[mod.split(".")[0]] += 1
        if mod.startswith("torch"):
            (cuda if mod.startswith("torch.cuda") else calls)[mod] += 1

    loader = WineLoader(None, minibatch_size=16,
                        prng=prng.RandomGenerator().seed(7))
    av = Avatar(Workflow(), loader=loader)
    av.initialize(device="cpu")
    threading.setprofile(watch)
    try:
        for _ in range(24):
            av.run()
    finally:
        threading.setprofile(None)
        av.stop()
    assert seen == {THREAD_PREFIX + loader.name}
    assert calls["znicz_tpu_torch"] > 0 and calls["numpy"] > 0
    assert not cuda and calls["torch"] == 0, (dict(cuda), dict(calls))
