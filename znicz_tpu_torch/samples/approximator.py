"""Approximator — an MLP regressor trained on the MSE objective
(``python -m znicz_tpu_torch approximator``).

Counterpart of ``znicz_tpu/samples/approximator.py``
(``root.approximator``: ``all2all_tanh`` 81 -> ``all2all_tanh`` as wide
as the targets, uniform fillings of 0.05, learning rate 0.02, momentum
0.9, minibatch 100; ``mean_disp`` normalization of the data and of the
targets).  :class:`ApproximatorLoader` reads the ``dataset_file`` /
``targets_file`` ``.npy`` pair where both exist (a quarter VALID) and
otherwise draws the JAX package's synthetic map, a smooth nonlinear
R^10 -> R^3 (``RandomState(0xA112)``, 600 TRAIN and 200 VALID rows).
"""

import os

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import (FullBatchLoaderMSE, IFullBatchLoader,
                                         TEST, TRAIN, VALID)
from znicz_tpu_torch.standard_workflow import StandardWorkflow


class ApproximatorLoader(FullBatchLoaderMSE, IFullBatchLoader):
    """Full-batch (data, target) rows, TRAIN and VALID."""

    MAPPING = "approximator_loader"

    #: the synthetic set's geometry (where no dataset files exist)
    SYNTH_TRAIN = 600
    SYNTH_VALID = 200
    N_IN = 10
    N_OUT = 3

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("normalization_type", "mean_disp")
        kwargs.setdefault("targets_normalization_type", "mean_disp")
        super(ApproximatorLoader, self).__init__(workflow, **kwargs)
        self.dataset_file = kwargs.get("dataset_file", os.path.join(
            root.common.dirs.datasets, "approximator", "data.npy"))
        self.targets_file = kwargs.get("targets_file", os.path.join(
            root.common.dirs.datasets, "approximator", "targets.npy"))

    def _synthesize(self):
        """The smooth nonlinear map's rows, from a fixed seed."""
        n = self.SYNTH_TRAIN + self.SYNTH_VALID
        r = numpy.random.RandomState(0xA112)
        x = r.uniform(-1.0, 1.0, (n, self.N_IN)).astype(numpy.float32)
        w = r.uniform(-1.0, 1.0, (self.N_IN, self.N_OUT))
        y = numpy.stack([
            numpy.sin(x @ w[:, 0]),
            numpy.cos(x @ w[:, 1]) * (x @ w[:, 2]),
            numpy.tanh(2.0 * x @ w[:, 2]),
        ], axis=1).astype(numpy.float32)
        return x, y

    def load_data(self):
        if os.path.exists(self.dataset_file) and \
                os.path.exists(self.targets_file):
            x = numpy.load(self.dataset_file).astype(numpy.float32)
            y = numpy.load(self.targets_file).astype(numpy.float32)
            if x.shape[0] != y.shape[0]:
                raise ValueError(
                    "%s has %d samples but %s has %d targets"
                    % (self.dataset_file, x.shape[0],
                       self.targets_file, y.shape[0]))
            n_valid = max(1, x.shape[0] // 4)
        else:
            x, y = self._synthesize()
            n_valid = self.SYNTH_VALID
        # the dataset's layout: [TEST | VALID | TRAIN]
        self.original_data.reset(numpy.ascontiguousarray(x))
        self.original_targets.reset(numpy.ascontiguousarray(y))
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = n_valid
        self.class_lengths[TRAIN] = x.shape[0] - n_valid


root.approximator.update({
    "decision": {"fail_iterations": 20, "max_epochs": 75},
    "snapshotter": {"prefix": "approximator", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loss_function": "mse",
    "loader_name": "approximator_loader",
    "loader": {"minibatch_size": 100},
    "layers": [
        {"name": "fc_tanh1", "type": "all2all_tanh",
         "->": {"output_sample_shape": 81,
                "weights_filling": "uniform", "weights_stddev": 0.05,
                "bias_filling": "uniform", "bias_stddev": 0.05},
         "<-": {"learning_rate": 0.02, "weights_decay": 0.0,
                "gradient_moment": 0.9}},
        # the width comes from the loader's targets_shape
        {"name": "fc_out", "type": "all2all_tanh",
         "->": {"weights_filling": "uniform", "weights_stddev": 0.05,
                "bias_filling": "uniform", "bias_stddev": 0.05},
         "<-": {"learning_rate": 0.02, "weights_decay": 0.0,
                "gradient_moment": 0.9}}],
})


class ApproximatorWorkflow(StandardWorkflow):
    """The function approximator (``StandardWorkflow``, MSE)."""


def build(layers=None, loader_config=None, decision_config=None,
          snapshotter_config=None, **kwargs):
    """An :class:`ApproximatorWorkflow` from ``root.approximator``, with
    the given config dicts merged over it."""
    cfg = root.approximator
    loader_cfg = cfg.loader.as_dict()
    loader_cfg.update(loader_config or {})
    decision_cfg = cfg.decision.as_dict()
    decision_cfg.update(decision_config or {})
    snap_cfg = cfg.snapshotter.as_dict()
    snap_cfg.update(snapshotter_config or {})
    kwargs.setdefault("loss_function", cfg.loss_function)
    return ApproximatorWorkflow(
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
    approximator``)."""
    load(build)
    main()
