"""Sequence classification — the scan LSTM trained end to end
(``python -m znicz_tpu_torch sequence``).

Counterpart of ``znicz_tpu/samples/sequence.py``: ``root.sequence``
(an ``lstm_scan`` layer of 32 hidden units, then a softmax of 4, each
with learning rate 0.1 and momentum 0.9; minibatch 50 over 600 TRAIN
and 200 VALID sequences of 12 steps of 8 features; 25 epochs),
:class:`SequenceRecallLoader` (``MAPPING = "sequence_recall"``: the
"delayed recall" task — each sequence carries its class's prototype in
its first three steps and uniform noise after them, so the model must
keep the early evidence in its memory cell across the tail) and
:class:`SequenceWorkflow`, the standard training graph over those
layers.  :func:`build`, :func:`run_sample` and :func:`run`, the
launcher contract.
"""

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import FullBatchLoader, TEST, TRAIN, VALID
from znicz_tpu_torch.standard_workflow import StandardWorkflow


root.sequence.update({
    "decision": {"fail_iterations": 50, "max_epochs": 25},
    "loss_function": "softmax",
    "loader_name": "sequence_recall",
    "snapshotter": {"prefix": "sequence", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loader": {"minibatch_size": 50, "n_classes": 4, "seq_len": 12,
               "features": 8, "n_train": 600, "n_valid": 200},
    "layers": [
        {"name": "lstm1", "type": "lstm_scan",
         "->": {"output_sample_shape": 32, "weights_stddev": 0.2,
                "bias_stddev": 0.2},
         "<-": {"learning_rate": 0.1, "weights_decay": 0.0,
                "gradient_moment": 0.9}},
        {"name": "sm", "type": "softmax",
         "->": {"output_sample_shape": 4},
         "<-": {"learning_rate": 0.1, "weights_decay": 0.0,
                "gradient_moment": 0.9}}],
})


class SequenceRecallLoader(FullBatchLoader):
    """Synthetic delayed-recall sequences ``(B, T, F)``: the class's
    prototype pattern in steps 0..2, uniform noise in the rest."""

    MAPPING = "sequence_recall"

    def __init__(self, workflow, **kwargs):
        super(SequenceRecallLoader, self).__init__(workflow, **kwargs)
        self.n_classes = kwargs.get("n_classes", 4)
        self.seq_len = kwargs.get("seq_len", 12)
        self.features = kwargs.get("features", 8)
        self.n_train = kwargs.get("n_train", 600)
        self.n_valid = kwargs.get("n_valid", 200)

    def load_data(self):
        total = self.n_train + self.n_valid
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = self.n_valid
        self.class_lengths[TRAIN] = self.n_train
        r = numpy.random.RandomState(20260730)
        protos = r.uniform(-1, 1, (self.n_classes, 3, self.features))
        labels = r.randint(0, self.n_classes, total).astype(numpy.int32)
        data = r.uniform(-0.5, 0.5,
                         (total, self.seq_len, self.features))
        data[:, :3, :] = protos[labels]
        self.original_data.reset(data.astype(numpy.float32))
        self._original_labels[:] = labels.tolist()


class SequenceWorkflow(StandardWorkflow):
    """The scan LSTM and a softmax head over the standard train
    graph."""


def build(layers=None, loader_config=None, decision_config=None,
          snapshotter_config=None, **kwargs):
    cfg = root.sequence
    loader_cfg = cfg.loader.as_dict()
    loader_cfg.update(loader_config or {})
    decision_cfg = cfg.decision.as_dict()
    decision_cfg.update(decision_config or {})
    snap_cfg = cfg.snapshotter.as_dict()
    snap_cfg.update(snapshotter_config or {})
    kwargs.setdefault("loss_function", cfg.loss_function)
    return SequenceWorkflow(
        layers=layers if layers is not None else cfg.layers,
        loader_name=cfg.loader_name,
        loader_config=loader_cfg,
        decision_config=decision_cfg,
        snapshotter_config=snap_cfg,
        **kwargs)


def run_sample(device=None, **kwargs):
    wf = build(**kwargs)
    wf.initialize(device=device)
    wf.run()
    return wf


def run(load, main):
    """The launcher contract."""
    load(build)
    main()
