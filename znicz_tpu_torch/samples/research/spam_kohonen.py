"""SpamKohonen — spam clustering on an (8, 8) SOM, with validation
(``python -m znicz_tpu_torch research.spam_kohonen``).

Counterpart of ``znicz_tpu/samples/research/spam_kohonen.py``:
``root.spam_kohonen`` (24 features, minibatch 80, 60 epochs, the
gradient and radius decays), :class:`SpamLoader` (``MAPPING =
"spam_loader"``: a label, then the features, a row; from
``<dirs.datasets>/spam/spam.txt.gz``, which the checkout holds; the
synthetic bag-of-words set is written only where it is absent),
:class:`ResultsExporter` (one winner id a sample, in dataset order,
once the run is complete) and :class:`SpamKohonenWorkflow`::

    repeater -> loader -> KohonenTrainer -> KohonenForward(total)
      -> KohonenValidator -> KohonenDecision -> ResultsExporter
      -> (back to repeater) / end_point

:func:`build`, :func:`run_sample` and :func:`run`, the launcher
contract.
"""

import gzip
import os

import numpy

from znicz_tpu_torch.core.accelerated_units import AcceleratedWorkflow
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.core.workflow import Repeater
from znicz_tpu_torch.loader.base import (FullBatchLoader, IFullBatchLoader,
                                         TRAIN)
from znicz_tpu_torch.units import kohonen as koh_units

DATASET_FILE = os.path.join(root.common.dirs.datasets, "spam",
                            "spam.txt.gz")
N_FEATURES = 24

root.spam_kohonen.update({
    "forward": {"shape": (8, 8), "weights_stddev": 0.05,
                "weights_filling": "uniform"},
    "decision": {"epochs": 60},
    "loader": {"minibatch_size": 80,
               "file": DATASET_FILE},
    "train": {"gradient_decay": lambda t: 0.002 / (1.0 + t * 0.00002),
              "radius_decay": lambda t: 1.0 / (1.0 + t * 0.00002)},
    "exporter": {"file": "classified.txt"},
})


class SpamLoader(FullBatchLoader, IFullBatchLoader):
    """Rows of a class id, then the lemma frequencies; all TRAIN, with
    ``samples_by_label`` for the validator."""

    MAPPING = "spam_loader"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("normalization_type", "pointwise")
        super(SpamLoader, self).__init__(workflow, **kwargs)
        self.file = kwargs.get("file", DATASET_FILE)
        self.samples_by_label = {}

    def _materialize(self):
        r = numpy.random.RandomState(0x5BA1)
        os.makedirs(os.path.dirname(self.file), exist_ok=True)
        # two word distributions; each message samples 30 word draws
        p_spam = r.dirichlet(numpy.full(N_FEATURES, 0.15))
        p_ham = r.dirichlet(numpy.full(N_FEATURES, 0.15))
        with gzip.open(self.file, "wt") as f:
            for i in range(400):
                label = int(i % 2)
                p = p_spam if label else p_ham
                counts = r.multinomial(30, p)
                f.write("%d %s\n" % (label,
                                     " ".join(str(c) for c in counts)))

    def load_data(self):
        if not os.path.exists(self.file):
            self._materialize()
        opener = gzip.open if self.file.endswith(".gz") else open
        labels, rows = [], []
        with opener(self.file, "rt") as f:
            for line in f:
                vals = line.split()
                if not vals:
                    continue
                labels.append(int(vals[0]))
                rows.append([float(v) for v in vals[1:]])
        self.original_data.mem = numpy.array(rows, dtype=numpy.float32)
        del self._original_labels[:]
        self._original_labels.extend(labels)
        self.class_lengths[TRAIN] = len(rows)
        self.samples_by_label = {}
        for i, label in enumerate(labels):
            self.samples_by_label.setdefault(label, set()).add(i)


class ResultsExporter(Unit):
    """Writes one winner-neuron id a sample, in dataset order."""

    def __init__(self, workflow, file_name, **kwargs):
        super(ResultsExporter, self).__init__(workflow, **kwargs)
        self.file_name = file_name
        self.demand("total", "shuffled_indices")

    def run(self):
        total = self.total.mem
        order = numpy.argsort(numpy.asarray(self.shuffled_indices))
        os.makedirs(os.path.dirname(os.path.abspath(self.file_name)),
                    exist_ok=True)
        with open(self.file_name, "w") as f:
            for i in order:
                f.write("%d\n" % int(total[i]))
        self.info("exported %d results -> %s", len(order), self.file_name)


class SpamKohonenWorkflow(AcceleratedWorkflow):
    """The SOM's training loop with the validator, and the exporter at
    the end."""

    def __init__(self, workflow=None, **kwargs):
        super(SpamKohonenWorkflow, self).__init__(workflow, **kwargs)
        cfg = root.spam_kohonen
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        loader_cfg = cfg.loader.as_dict()
        loader_cfg.update(kwargs.get("loader_config") or {})
        loader_cfg.setdefault("file", cfg.loader.file)
        self.loader = SpamLoader(self, name="loader", **loader_cfg)
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

        self.validator = koh_units.KohonenValidator(self)
        self.validator.link_attrs(self.trainer, "shape")
        self.validator.link_attrs(self.forward, ("input", "output"))
        self.validator.link_attrs(self.loader, "minibatch_indices",
                                  "minibatch_size", "samples_by_label")
        self.validator.link_from(self.forward)

        epochs = kwargs.get("epochs", cfg.decision.epochs)
        self.decision = koh_units.KohonenDecision(
            self, name="decision", max_epochs=epochs)
        self.decision.link_from(self.validator)
        self.decision.link_attrs(self.loader, "minibatch_class",
                                 "last_minibatch", "minibatch_size",
                                 "class_lengths", "epoch_ended",
                                 "epoch_number")
        self.decision.link_attrs(self.trainer, "weights", "winners")

        self.exporter = ResultsExporter(
            self, kwargs.get("exporter_file",
                             os.path.join(root.common.dirs.cache,
                                          cfg.exporter.file)))
        self.exporter.link_from(self.decision)
        self.exporter.link_attrs(self.forward, "total")
        self.exporter.link_attrs(self.loader, "shuffled_indices")
        self.exporter.gate_skip = ~self.decision.complete

        self.repeater.link_from(self.decision)
        self.repeater.gate_block = self.decision.complete
        self.loader.gate_block = self.decision.complete
        self.end_point.link_from(self.exporter)
        self.end_point.gate_block = ~self.decision.complete


def build(**kwargs):
    return SpamKohonenWorkflow(**kwargs)


def run_sample(device=None, **kwargs):
    wf = build(**kwargs)
    wf.initialize(device=device)
    wf.run()
    return wf


def run(load, main):
    """The launcher contract."""
    load(SpamKohonenWorkflow)
    main()
