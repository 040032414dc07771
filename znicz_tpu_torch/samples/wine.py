"""Wine — the smallest end-to-end sample: UCI Wine through a hand-built
MLP graph (``python -m znicz_tpu_torch wine``).

Counterpart of ``znicz_tpu/samples/wine.py`` (:14-135, :183-186):
``root.wine`` (layers [8, 3], learning rate 0.3, minibatch 10; it
converges within 100 epochs) and :class:`WineWorkflow`, the
reference's canonical training loop wired unit by unit on an
``NNWorkflow``::

    repeater -> loader -> All2AllTanh ... -> All2AllSoftmax
      -> EvaluatorSoftmax -> DecisionGD -> NNSnapshotterToFile
      -> GDSoftmax -> GDTanh ... -> (back to repeater) / end_point

:func:`run_sample` and :func:`run`, the launcher contract.  The data is
:class:`~znicz_tpu_torch.loader.loader_wine.WineLoader`'s.
:func:`population_evaluator` is ``--optimize``'s population path, a
whole generation trained at once (:mod:`znicz_tpu_torch.parallel.
population`).
"""

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.loader_wine import WineLoader
from znicz_tpu_torch.units import all2all, decision, evaluator, gd, nn_units


root.wine.update({
    "decision": {"fail_iterations": 200, "max_epochs": 100},
    "snapshotter": {"prefix": "wine", "time_interval": 1, "interval": 1},
    "loader": {"minibatch_size": 10},
    "learning_rate": 0.3,
    "weights_decay": 0.0,
    "layers": [8, 3],
})


class WineWorkflow(nn_units.NNWorkflow):
    """An MLP with the softmax loss on the UCI Wine data: a tanh layer
    of each width in ``layers`` but the last, then the softmax head."""

    def __init__(self, workflow=None, **kwargs):
        super(WineWorkflow, self).__init__(workflow, **kwargs)
        layers = kwargs.get("layers", root.wine.layers)

        self.repeater.link_from(self.start_point)

        self.loader = WineLoader(
            self, minibatch_size=root.wine.loader.minibatch_size,
            name="loader")
        self.loader.link_from(self.repeater)

        # the forward chain
        del self.forwards[:]
        for i, layer in enumerate(layers):
            cls = all2all.All2AllTanh if i < len(layers) - 1 \
                else all2all.All2AllSoftmax
            aa = cls(self, output_sample_shape=(layer,),
                     weights_stddev=0.05, bias_stddev=0.05,
                     name="fwd%d" % i)
            self.forwards.append(aa)
            if i:
                aa.link_from(self.forwards[-2])
                aa.link_attrs(self.forwards[-2], ("input", "output"))
            else:
                aa.link_from(self.loader)
                aa.link_attrs(self.loader, ("input", "minibatch_data"))

        self.evaluator = evaluator.EvaluatorSoftmax(self, name="evaluator")
        self.evaluator.link_from(self.forwards[-1])
        self.evaluator.link_attrs(self.forwards[-1], "output", "max_idx")
        self.evaluator.link_attrs(self.loader,
                                  ("batch_size", "minibatch_size"),
                                  ("labels", "minibatch_labels"))

        self.decision = decision.DecisionGD(
            self, fail_iterations=root.wine.decision.fail_iterations,
            max_epochs=root.wine.decision.max_epochs, name="decision")
        self.decision.link_from(self.evaluator)
        self.decision.link_attrs(self.loader, "minibatch_class",
                                 "last_minibatch", "epoch_ended",
                                 "epoch_number")
        self.decision.link_attrs(
            self.evaluator,
            ("minibatch_n_err", "n_err"),
            ("minibatch_confusion_matrix", "confusion_matrix"),
            ("minibatch_max_err_y_sum", "max_err_output_sum"))

        self.snapshotter = nn_units.NNSnapshotterToFile(
            self, prefix=root.wine.snapshotter.prefix, compression="",
            interval=root.wine.snapshotter.interval,
            time_interval=root.wine.snapshotter.time_interval,
            name="snapshotter")
        self.snapshotter.link_from(self.decision)
        self.snapshotter.link_attrs(self.decision,
                                    ("suffix", "snapshot_suffix"))
        self.snapshotter.gate_skip = ~self.loader.epoch_ended
        self.snapshotter.skip = ~self.decision.improved

        self.end_point.link_from(self.snapshotter)
        self.end_point.gate_block = ~self.decision.complete

        # the backward chain, last layer first
        self.gds[:] = [None] * len(self.forwards)
        self.gds[-1] = gd.GDSoftmax(
            self, learning_rate=root.wine.learning_rate,
            weights_decay=root.wine.weights_decay,
            name="gd%d" % (len(self.forwards) - 1)) \
            .link_from(self.snapshotter) \
            .link_attrs(self.evaluator, "err_output") \
            .link_attrs(self.forwards[-1], "output", "input",
                        "weights", "bias") \
            .link_attrs(self.loader, ("batch_size", "minibatch_size"))
        self.gds[-1].gate_skip = self.decision.gd_skip
        self.gds[-1].gate_block = self.decision.complete
        for i in range(len(self.forwards) - 2, -1, -1):
            self.gds[i] = gd.GDTanh(
                self, learning_rate=root.wine.learning_rate,
                weights_decay=root.wine.weights_decay, name="gd%d" % i) \
                .link_from(self.gds[i + 1]) \
                .link_attrs(self.gds[i + 1], ("err_output", "err_input")) \
                .link_attrs(self.forwards[i], "output", "input",
                            "weights", "bias") \
                .link_attrs(self.loader, ("batch_size", "minibatch_size"))
            self.gds[i].gate_skip = self.decision.gd_skip
        self.gds[0].need_err_input = False
        self.repeater.link_from(self.gds[0])
        self.loader.gate_block = self.decision.complete


def run_sample(device=None, **kwargs):
    """Build, initialize on ``device`` (the card unless "cpu") and
    train; returns the workflow."""
    wf = WineWorkflow(**kwargs)
    wf.initialize(device=device)
    wf.run()
    return wf


def run(load, main):
    """The launcher contract (``python -m znicz_tpu_torch wine``)."""
    load(WineWorkflow)
    main()


def population_evaluator(sites, epochs=None, seed=12, device=None):
    """``--optimize``'s population path for Wine (JAX :138): the
    topology of ``root.wine.layers`` as fused layers, every Range site
    with a key of ``population.HYPER_KEYS`` mapped onto their hyper
    slots, and a generation trained as one batched computation a step
    on ``device`` (the card unless "cpu") over all 178 rows; None (the
    serial fallback) where a site is no hyper slot."""
    import numpy
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.workflow import Workflow
    from znicz_tpu_torch.parallel import fused
    from znicz_tpu_torch.parallel.population import (
        config_values_to_hypers, make_population_evaluator)
    n_hidden, n_classes = root.wine.layers
    layers = [
        {"type": "all2all_tanh",
         "->": {"output_sample_shape": int(n_hidden)}},
        {"type": "softmax", "->": {"output_sample_shape": int(n_classes)}},
    ]
    defaults = {"wd": float(root.wine.weights_decay),
                "lr": float(root.wine.learning_rate)}
    loader = WineLoader(Workflow(None),
                        minibatch_size=root.wine.loader.minibatch_size)
    loader.initialize()
    x = numpy.array(loader.original_data.mem)
    y = numpy.array(loader.original_labels, dtype=numpy.int32)
    specs = tuple(fused.build_specs(layers, x.shape[1], defaults))
    mapper = config_values_to_hypers(sites, layers, specs)
    if mapper is None:
        return None
    return make_population_evaluator(
        layers, x.shape[1], x, y, x, y, mapper,
        epochs=epochs or int(root.wine.decision.max_epochs),
        minibatch_size=int(root.wine.loader.minibatch_size),
        rand=prng.RandomGenerator().seed(seed), defaults=defaults,
        device=device)
