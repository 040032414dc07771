"""Stl10 — the reference's STL-10 convnet
(``python -m znicz_tpu_torch research.stl10 [--fused pool_impl=offsets]``).

Counterpart of ``znicz_tpu/samples/research/stl10.py``: ``root.stl``,
the published network (conv 32 5x5 pad 2 -> max pool 3x3/s2 -> strict
relu -> LRN -> conv 32 5x5 pad 2 -> strict relu -> avg pool 3x3/s2 ->
LRN -> softmax; gaussian fillings, ``factor_ortho`` 0.001 on the
convs, momentum 0.9, ``weights_decay`` 1.0 on the head, minibatch 50,
``internal_mean``; a published 35.10% validation error), trained by
either graph; :func:`materialize_synthetic`, :class:`Stl10Workflow`,
:func:`build`, :func:`run_sample` and :func:`run`, the launcher
contract.  The data is
:class:`~znicz_tpu_torch.loader.loader_stl.STL10FullBatchLoader`'s.
Where ``directory`` holds no ``train_X.bin``, :func:`build` writes the
JAX package's synthetic set there (the same bytes from the same seed).
As in the JAX package, the head's width is the loader's label count
(10 on the published files, 4 on the synthetic set).  On the card,
pool1 (96x96x32 at minibatch 50, 48x48 windows, the last row and
column overhanging) runs the hand-written forward kernel on every
minibatch and the backward kernel on every TRAIN minibatch.
"""

import os

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.standard_workflow import StandardWorkflow
import znicz_tpu_torch.loader.loader_stl  # noqa: F401 (registers it)

DATA_DIR = os.path.join(root.common.dirs.datasets, "stl10_binary")

_CONV_BWD = {"learning_rate": 0.001, "learning_rate_bias": 0.002,
             "weights_decay": 0.0005, "weights_decay_bias": 0.0005,
             "factor_ortho": 0.001, "gradient_moment": 0.9,
             "gradient_moment_bias": 0.9}

root.stl.update({
    "decision": {"fail_iterations": 200, "max_epochs": 1000},
    "loss_function": "softmax",
    "snapshotter": {"prefix": "stl10", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loader_name": "full_batch_stl_10",
    "loader": {"minibatch_size": 50,
               "normalization_type": "internal_mean",
               "directory": DATA_DIR},
    "layers": [
        {"name": "conv1", "type": "conv",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5,
                "padding": (2, 2, 2, 2), "sliding": (1, 1),
                "weights_filling": "gaussian", "weights_stddev": 0.0001,
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": dict(_CONV_BWD)},
        {"name": "pool1", "type": "max_pooling",
         "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"name": "relu1", "type": "activation_str"},
        {"name": "norm1", "type": "norm",
         "alpha": 0.00005, "beta": 0.75, "n": 3, "k": 1},
        {"name": "conv2", "type": "conv",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5,
                "padding": (2, 2, 2, 2), "sliding": (1, 1),
                "weights_filling": "gaussian", "weights_stddev": 0.01,
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": dict(_CONV_BWD)},
        {"name": "relu2", "type": "activation_str"},
        {"name": "pool2", "type": "avg_pooling",
         "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"name": "norm2", "type": "norm",
         "alpha": 0.00005, "beta": 0.75, "n": 3, "k": 1},
        {"name": "fc_softmax", "type": "softmax",
         "->": {"output_sample_shape": 10,
                "weights_filling": "gaussian", "weights_stddev": 0.01,
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": {"learning_rate": 0.001, "learning_rate_bias": 0.002,
                "weights_decay": 1.0, "weights_decay_bias": 0,
                "gradient_moment": 0.9, "gradient_moment_bias": 0.9}}],
})


def materialize_synthetic(directory=None, n_train=40, n_valid=20,
                          size=96, seed=0x57110):
    """Write a synthetic STL-10 in the real binary format into
    ``directory`` (unless it already holds ``train_X.bin``): 4 classes
    of noisy prototype images, CHW uint8, 1-based labels.  Returns the
    directory."""
    directory = directory or DATA_DIR
    if os.path.isdir(directory) and \
            os.path.exists(os.path.join(directory, "train_X.bin")):
        return directory
    os.makedirs(directory, exist_ok=True)
    names = ["airplane", "bird", "car", "cat"]
    with open(os.path.join(directory, "class_names.txt"), "w") as f:
        f.write("\n".join(names))
    r = numpy.random.RandomState(seed)
    protos = r.uniform(0, 255, (len(names), 3, size, size))
    for prefix, n in (("train", n_train), ("test", n_valid)):
        y = (numpy.arange(n) % len(names)).astype(numpy.uint8)
        x = numpy.empty((n, 3, size, size), numpy.uint8)
        for i in range(n):
            img = protos[y[i]] + r.normal(0, 30, (3, size, size))
            x[i] = numpy.clip(img, 0, 255).astype(numpy.uint8)
        x.tofile(os.path.join(directory, "%s_X.bin" % prefix))
        (y + 1).tofile(os.path.join(directory, "%s_y.bin" % prefix))
    return directory


class Stl10Workflow(StandardWorkflow):
    """The STL-10 workflow (``StandardWorkflow``)."""


def build(layers=None, loader_config=None, decision_config=None,
          snapshotter_config=None, **kwargs):
    """A :class:`Stl10Workflow` from ``root.stl``, with the given config
    dicts merged over it; the synthetic set is written into the
    loader's ``directory`` if it holds no ``train_X.bin``."""
    cfg = root.stl
    loader_cfg = cfg.loader.as_dict()
    loader_cfg.update(loader_config or {})
    directory = loader_cfg.get("directory", DATA_DIR)
    if not os.path.exists(os.path.join(directory, "train_X.bin")):
        materialize_synthetic(directory)
    decision_cfg = cfg.decision.as_dict()
    decision_cfg.update(decision_config or {})
    snap_cfg = cfg.snapshotter.as_dict()
    snap_cfg.update(snapshotter_config or {})
    kwargs.setdefault("loss_function", cfg.loss_function)
    return Stl10Workflow(
        layers=layers if layers is not None else cfg.layers,
        loader_name=cfg.loader_name, loader_config=loader_cfg,
        decision_config=decision_cfg, snapshotter_config=snap_cfg,
        **kwargs)


def run_sample(device=None, **kwargs):
    """Build, initialize on ``device`` (the card unless "cpu") and
    train."""
    wf = build(**kwargs)
    wf.initialize(device=device)
    wf.run()
    return wf


def run(load, main):
    """The launcher contract (``python -m znicz_tpu_torch
    research.stl10``)."""
    load(build)
    main()
