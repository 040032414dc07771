"""DemoKohonen — an unsupervised self-organizing map over 2-D points
(``python -m znicz_tpu_torch demo_kohonen``).

Counterpart of ``znicz_tpu/samples/demo_kohonen.py``: ``root.kohonen``
(an (8, 8) map, minibatch 10, 200 epochs, the gradient and radius
decays), :class:`KohonenLoader` (``MAPPING = "kohonen_loader"``: rows
of whitespace-separated features, gzipped, from
``<dirs.datasets>/kohonen/kohonen.txt.gz``, which the checkout holds;
the deterministic synthetic clusters are written only where the file
is absent) and :class:`KohonenWorkflow`::

    repeater -> loader -> KohonenTrainer -> KohonenForward(total)
      -> KohonenDecision -> (back to repeater) / end_point

:func:`run_sample` and :func:`run`, the launcher contract.
"""

import gzip
import os

import numpy

from znicz_tpu_torch.core.accelerated_units import AcceleratedWorkflow
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.workflow import Repeater
from znicz_tpu_torch.loader.base import (FullBatchLoader, IFullBatchLoader,
                                         TRAIN)
from znicz_tpu_torch.units import kohonen as koh_units

DATASET_FILE = os.path.join(root.common.dirs.datasets, "kohonen",
                            "kohonen.txt.gz")

root.kohonen.update({
    "forward": {"shape": (8, 8), "weights_stddev": 0.05,
                "weights_filling": "uniform"},
    "decision": {"epochs": 200},
    "loader": {"minibatch_size": 10,
               "dataset_file": DATASET_FILE},
    "train": {"gradient_decay": lambda t: 0.05 / (1.0 + t * 0.005),
              "radius_decay": lambda t: 1.0 / (1.0 + t * 0.005)},
})


class KohonenLoader(FullBatchLoader, IFullBatchLoader):
    """Whitespace-separated feature rows, optionally gzipped, all
    TRAIN."""

    MAPPING = "kohonen_loader"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("normalization_type", "pointwise")
        super(KohonenLoader, self).__init__(workflow, **kwargs)
        self.dataset_file = kwargs.get("dataset_file", DATASET_FILE)

    def _materialize(self):
        """Deterministic 2-D gaussian clusters."""
        r = numpy.random.RandomState(0x50A1)
        centers = numpy.array(
            [[2.0, 2.0], [-2.0, 2.0], [0.0, -2.0], [3.0, -1.5]])
        labels = r.randint(0, len(centers), 400)
        pts = centers[labels] + r.normal(0, 0.25, (400, 2))
        os.makedirs(os.path.dirname(self.dataset_file), exist_ok=True)
        with gzip.open(self.dataset_file, "wt") as f:
            for row in pts:
                f.write(" ".join("%.6f" % v for v in row) + "\n")

    def load_data(self):
        if not os.path.exists(self.dataset_file):
            self._materialize()
        opener = gzip.open if self.dataset_file.endswith(".gz") else open
        with opener(self.dataset_file, "rt") as f:
            rows = [[float(v) for v in line.split()]
                    for line in f if line.strip()]
        self.original_data.mem = numpy.array(rows, dtype=numpy.float32)
        self.class_lengths[TRAIN] = len(rows)


class KohonenWorkflow(AcceleratedWorkflow):
    """The SOM's training loop, with the forward's ``total`` table of
    every sample's winner."""

    def __init__(self, workflow=None, **kwargs):
        super(KohonenWorkflow, self).__init__(workflow, **kwargs)
        cfg = root.kohonen
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        loader_cfg = cfg.loader.as_dict()
        loader_cfg.update(kwargs.get("loader_config") or {})
        self.loader = KohonenLoader(self, name="loader", **loader_cfg)
        self.loader.link_from(self.repeater)

        fwd_cfg = cfg.forward.as_dict()
        self.trainer = koh_units.KohonenTrainer(
            self, shape=tuple(fwd_cfg["shape"]),
            weights_stddev=fwd_cfg.get("weights_stddev", 0.05),
            weights_filling=fwd_cfg.get("weights_filling", "uniform"),
            gradient_decay=cfg.train.gradient_decay,
            radius_decay=cfg.train.radius_decay)
        self.trainer.link_from(self.loader)
        self.trainer.link_attrs(self.loader, ("input", "minibatch_data"))

        self.forward = koh_units.KohonenForward(self, total=True)
        self.forward.link_from(self.trainer)
        self.forward.link_attrs(self.loader, ("input", "minibatch_data"),
                                ("batch_size", "total_samples"),
                                "minibatch_offset", "minibatch_size")
        self.forward.link_attrs(self.trainer, "weights", "argmins")

        epochs = kwargs.get("epochs", cfg.decision.epochs)
        self.decision = koh_units.KohonenDecision(
            self, name="decision", max_epochs=epochs)
        self.decision.link_from(self.forward)
        self.decision.link_attrs(self.loader, "minibatch_class",
                                 "last_minibatch", "minibatch_size",
                                 "class_lengths", "epoch_ended",
                                 "epoch_number")
        self.decision.link_attrs(self.trainer, "weights", "winners")

        self.repeater.link_from(self.decision)
        self.repeater.gate_block = self.decision.complete
        self.loader.gate_block = self.decision.complete
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete


def run_sample(device=None, **kwargs):
    wf = KohonenWorkflow(**kwargs)
    wf.initialize(device=device)
    wf.run()
    return wf


def run(load, main):
    """The launcher contract."""
    load(KohonenWorkflow)
    main()
