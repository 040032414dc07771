"""Mnist7 — MNIST digits regressed onto seven-segment display codes
(``python -m znicz_tpu_torch mnist7 [--fused]``).

Counterpart of ``znicz_tpu/samples/research/mnist7.py``: each digit's
target is its seven-segment code in {-1, 1}^7; ``all2all_tanh``
layers [100, 100, 7] (the head's width set from the loader's
``targets_shape``), ``loss_function="mse"`` (``EvaluatorMSE`` with
``class_targets``, so the nearest-code error ``n_err`` is counted, and
``DecisionMSE``), minibatch 60.  The data is the port's MNIST loader
with the MSE targets (:class:`Mnist7Loader`).
"""

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.loader.base import FullBatchLoaderMSEMixin, \
    IFullBatchLoader
from znicz_tpu_torch.loader.loader_mnist import MnistLoader
from znicz_tpu_torch.standard_workflow import StandardWorkflow

#: the seven-segment codes of the digits 0..9
SEVEN_SEGMENT = numpy.array(
    [[1, 1, 1, -1, 1, 1, 1],      # 0
     [-1, -1, 1, -1, -1, 1, -1],  # 1
     [1, -1, 1, 1, 1, -1, 1],     # 2
     [1, -1, 1, 1, -1, 1, 1],     # 3
     [-1, 1, 1, 1, -1, 1, -1],    # 4
     [1, 1, -1, 1, -1, 1, 1],     # 5
     [1, 1, -1, 1, 1, 1, 1],      # 6
     [1, 1, 1, -1, -1, 1, -1],    # 7
     [1, 1, 1, 1, 1, 1, 1],       # 8
     [1, 1, 1, 1, -1, 1, 1]],     # 9
    dtype=numpy.float32)


class Mnist7Loader(FullBatchLoaderMSEMixin, MnistLoader, IFullBatchLoader):
    """MNIST rows with their digits' seven-segment codes as targets."""

    MAPPING = "mnist7_loader"

    def load_data(self):
        super(Mnist7Loader, self).load_data()
        self.class_targets = Array(SEVEN_SEGMENT.copy(),
                                   name="class_targets")
        self.original_targets.reset(
            SEVEN_SEGMENT[numpy.asarray(self.original_labels)])


root.mnist7.update({
    "decision": {"fail_iterations": 25, "max_epochs": 1000},
    "snapshotter": {"prefix": "mnist7", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loss_function": "mse",
    "loader_name": "mnist7_loader",
    "loader": {"minibatch_size": 60, "normalization_type": "linear"},
    "layers": [
        {"name": "fc_tanh1", "type": "all2all_tanh",
         "->": {"output_sample_shape": 100},
         "<-": {"learning_rate": 0.01, "weights_decay": 0.00005}},
        {"name": "fc_tanh2", "type": "all2all_tanh",
         "->": {"output_sample_shape": 100},
         "<-": {"learning_rate": 0.01, "weights_decay": 0.00005}},
        {"name": "fc_out", "type": "all2all_tanh",
         "->": {},  # the width comes from the loader's targets_shape
         "<-": {"learning_rate": 0.01, "weights_decay": 0.00005}}],
})


class Mnist7Workflow(StandardWorkflow):
    """The seven-segment regression workflow (``StandardWorkflow``)."""


def build(layers=None, loader_config=None, decision_config=None,
          snapshotter_config=None, **kwargs):
    """A :class:`Mnist7Workflow` from ``root.mnist7``, with the given
    config dicts merged over it."""
    cfg = root.mnist7
    loader_cfg = cfg.loader.as_dict()
    loader_cfg.update(loader_config or {})
    decision_cfg = cfg.decision.as_dict()
    decision_cfg.update(decision_config or {})
    snap_cfg = cfg.snapshotter.as_dict()
    snap_cfg.update(snapshotter_config or {})
    kwargs.setdefault("loss_function", cfg.loss_function)
    return Mnist7Workflow(
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
    """The launcher contract (``python -m znicz_tpu_torch mnist7``)."""
    load(build)
    main()
