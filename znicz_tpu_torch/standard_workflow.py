"""StandardWorkflow — the training-graph builder.

Counterpart of ``znicz_tpu/standard_workflow.py`` (``create_workflow``
:49-60, ``create_fused_workflow`` :62, ``link_fused_trainer`` :76,
``link_gds`` :120-172, ``link_evaluator`` :174-210, ``link_decision``
:212, ``link_snapshotter`` :236, ``link_lr_adjuster`` :252-281,
``link_rollback`` :283-300, ``link_loop``, ``link_end_point``).
The unit-at-a-time graph, the default (``fused=None``)::

    repeater -> loader -> forwards[0..n] -> evaluator -> decision
      -> snapshotter -> gds[n..0] -> (back to repeater) / end_point

where each forward unit runs one layer on the device and each GD unit
its backward and update, one minibatch at a time; and the fused graph
(``fused=True`` or a config dict)::

    repeater -> loader -> fused_trainer -> evaluator -> decision
      -> snapshotter -> (back to repeater) / end_point

Both have ``decision.complete`` blocking the repeater and the loader
and opening the end point, and the snapshotter firing at epoch ends
that improved; the GD units skip VALID minibatches
(``decision.gd_skip``).  ``loss_function="mse"`` trains against the
loader's ``minibatch_targets`` through ``EvaluatorMSE`` and
``DecisionMSE`` (and, fused, the trainer's MSE windows).
``link_lr_adjuster`` adds the learning-rate schedule to either graph,
``link_rollback`` the divergence recovery (``NNRollback`` over the GD
units, ``FusedNNRollback`` over the fused trainer).
``extract_forward_workflow`` (JAX :612-642) builds the forward-only
workflow of a trained one, from either graph, with its weights handed
over through the forwards' weight broadcast (``apply_data_from_master``;
a fused trainer's through ``host_params``).  A mesh and the plotters
are not in this slice of the port (``ROADMAP.md``).
"""

from znicz_tpu_torch.core.snapshotter import SnapshotterRegistry
from znicz_tpu_torch.standard_workflow_base import StandardWorkflowBase
from znicz_tpu_torch.units.decision import DecisionsRegistry
from znicz_tpu_torch.units.conv import ConvolutionalBase
from znicz_tpu_torch.units.evaluator import EvaluatorsRegistry
from znicz_tpu_torch.units.fused_trainer import (FusedForwardBackward,
                                                 FusedNNRollback)
from znicz_tpu_torch.units.gd_pooling import GDPooling
from znicz_tpu_torch.units.lr_adjust import LearningRateAdjust
from znicz_tpu_torch.units.nn_rollback import NNRollback


class StandardWorkflow(StandardWorkflowBase):

    def __init__(self, workflow=None, **kwargs):
        super(StandardWorkflow, self).__init__(workflow, **kwargs)
        self.loss_function = kwargs.get("loss_function", "softmax")
        if self.loss_function not in EvaluatorsRegistry.evaluators:
            raise ValueError("Unknown loss_function %r (known: %s)" % (
                self.loss_function, sorted(EvaluatorsRegistry.evaluators)))
        self.decision_name = kwargs.get(
            "decision_name", "decision_gd" if self.loss_function == "softmax"
            else "decision_mse")
        self.snapshotter_name = kwargs.get("snapshotter_name", "nnfile")
        self.evaluator_config = self.config2kwargs(
            kwargs.get("evaluator_config"))
        self.decision_config = self.config2kwargs(
            kwargs.get("decision_config"))
        self.snapshotter_config = self.config2kwargs(
            kwargs.get("snapshotter_config"))
        if not self.preprocessing:
            self.create_workflow()

    def create_workflow(self):
        if self.fused_config is not None:
            return self.create_fused_workflow()
        self.link_repeater(self.start_point)
        self.link_loader(self.repeater)
        self.link_forwards(("input", "minibatch_data"), self.loader)
        self.link_evaluator(self.forwards[-1])
        self.link_decision(self.evaluator)
        self.link_snapshotter(self.decision)
        last_gd = self.link_gds(self.snapshotter)
        self.link_loop(last_gd)
        self.link_end_point(last_gd)

    def create_fused_workflow(self):
        self.link_repeater(self.start_point)
        self.link_loader(self.repeater)
        self.link_fused_trainer(self.loader)
        self.link_evaluator(self.fused_trainer)
        self.link_decision(self.evaluator)
        self.link_snapshotter(self.decision)
        self.link_loop(self.snapshotter)
        self.link_end_point(self.snapshotter)

    def link_fused_trainer(self, *parents):
        """The fused train-step unit from the ``layers`` config; the
        ``fused`` config's keys are its keyword arguments."""
        cfg = dict(self.fused_config)
        cfg.setdefault("loss", self.loss_function)
        self.fused_trainer = FusedForwardBackward(
            self, name="fused_trainer", layers=self.layers, **cfg)
        self.fused_trainer.link_from(*parents)
        self.fused_trainer.link_attrs(
            self.loader, ("input", "minibatch_data"),
            ("labels", "minibatch_labels"),
            "minibatch_class", "minibatch_size")
        if self.loss_function == "mse":
            self.fused_trainer.link_attrs(
                self.loader, ("target", "minibatch_targets"))
        # window collection drives the loader directly
        self.fused_trainer.loader_unit = self.loader
        # the trainer is the forward chain for the evaluator
        self.forwards[:] = [self.fused_trainer]
        return self.fused_trainer

    def link_gds(self, *parents):
        """Create each forward's GD unit, chained last layer first:
        each takes ``err_output`` from the previous GD's ``err_input``
        (the last layer's from the evaluator), the forward's input,
        weights, bias, offsets, output and geometry, and skips VALID
        minibatches; the first layer's computes no input gradient.
        Returns the GD unit that runs last."""
        self.gds[:] = [None] * len(self.layers)
        first_gd = None
        units_to_delete = []
        for i, layer in reversed(list(enumerate(self.layers))):
            tpe, _, kwargs = self._get_layer_type_kwargs(layer, i)
            if not isinstance(self.forwards[i], self.layer_map[tpe].forward):
                raise TypeError(
                    "Forward layer %s at position %d is not an instance "
                    "of %s" % (self.forwards[i], i,
                               self.layer_map[tpe].forward))
            try:
                backward_cls = next(self.layer_map[tpe].backwards)
            except StopIteration:
                units_to_delete.append(i)
                continue
            unit = backward_cls(self, **kwargs)
            self.gds[i] = unit
            if hasattr(unit, "bind_forward"):
                # a pair sharing structured parameters (the scan LSTM's
                # gates) takes its forward, not a singular weights/bias
                unit.bind_forward(self.forwards[i])
            if first_gd is not None:
                unit.link_from(first_gd) \
                    .link_attrs(first_gd, ("err_output", "err_input"))
            else:
                unit.link_from(*parents) \
                    .link_attrs(self.evaluator, "err_output")
            first_gd = unit
            try_link = {"input", "weights", "bias", "input_offset",
                        "mask", "output"}
            if isinstance(unit, ConvolutionalBase):
                try_link.update(ConvolutionalBase.CONV_ATTRS)
            if isinstance(unit, GDPooling):
                try_link.update(GDPooling.POOL_ATTRS)
            attrs = [a for a in sorted(try_link)
                     if getattr(self.forwards[i], a, None) is not None]
            unit.link_attrs(self.forwards[i], *attrs)
            unit.link_attrs(self.loader, ("batch_size", "minibatch_size"))
            if "mask" in attrs:
                unit.link_attrs(self.loader, "minibatch_class")
            unit.gate_skip = self.decision.gd_skip
        for i in units_to_delete:
            del self.gds[i]
        self.gds[0].need_err_input = False
        return first_gd

    def link_evaluator(self, *parents):
        self.evaluator = EvaluatorsRegistry.evaluators[self.loss_function](
            self, name="evaluator", **self.evaluator_config)
        self.evaluator.link_from(*parents) \
            .link_attrs(self.forwards[-1], "output") \
            .link_attrs(self.loader, ("batch_size", "minibatch_size"),
                        ("labels", "minibatch_labels"), "class_lengths",
                        ("offset", "minibatch_offset"))
        if self.loss_function == "softmax":
            self.evaluator.link_attrs(self.forwards[-1], "max_idx")
        else:
            self.evaluator.link_attrs(self.loader,
                                      ("target", "minibatch_targets"))
            if hasattr(self.loader, "class_targets"):
                # resolved at run time: a loader fills it in load_data
                self.evaluator.link_attrs(self.loader, "class_targets")
        if self.fused_trainer is not None:
            # windowed TRAIN dispatches hand the evaluator their own
            # stats, computed with the evaluator's flags
            self.evaluator.stats_source = self.fused_trainer
            self.fused_trainer.stats_sink = self.evaluator
            self.fused_trainer.stats_mean = self.evaluator.mean
            if self.loss_function == "mse":
                self.fused_trainer.stats_root = self.evaluator.root
        return self.evaluator

    def link_decision(self, *parents):
        self.decision = DecisionsRegistry.decisions[self.decision_name](
            self, name="decision", **self.decision_config)
        self.decision.link_from(*parents) \
            .link_attrs(self.loader, "minibatch_class", "last_minibatch",
                        "epoch_ended", "epoch_number")
        self.decision.link_attrs(self.evaluator,
                                 ("minibatch_n_err", "n_err"))
        if self.decision_name == "decision_mse":
            self.decision.link_attrs(self.loader, "class_lengths")
            self.decision.link_attrs(self.evaluator,
                                     ("minibatch_metrics", "metrics"))
        else:
            self.decision.link_attrs(
                self.evaluator,
                ("minibatch_confusion_matrix", "confusion_matrix"),
                ("minibatch_max_err_y_sum", "max_err_output_sum"))
        self.repeater.gate_block = self.decision.complete
        self.loader.gate_block = self.decision.complete
        return self.decision

    def link_snapshotter(self, *parents):
        self.snapshotter = SnapshotterRegistry.mapping[
            self.snapshotter_name](
            self, name="snapshotter", **self.snapshotter_config)
        self.snapshotter.link_from(*parents) \
            .link_attrs(self.decision, ("suffix", "snapshot_suffix"))
        self.snapshotter.gate_skip = ~self.loader.epoch_ended
        self.snapshotter.skip = ~self.decision.improved
        return self.snapshotter

    def link_lr_adjuster(self, *parents, **kwargs):
        """The learning-rate schedule on every GD unit, its config from
        ``lr_adjuster_config`` or the keyword arguments.  Unit graph: it
        takes the GD units and runs after ``parents`` (the caller
        re-links the first GD unit after it).  Fused graph: it takes the
        trainer's proxies and runs between the loader and the trainer
        (``parents`` are not used), gated on the loader's TRAIN class,
        and the trainer calls it after each minibatch it collects into
        a window, so update k uses ``policy(k)`` in both graphs."""
        cfg = dict(kwargs.pop("lr_adjuster_config", None) or kwargs)
        self.lr_adjuster = LearningRateAdjust(
            self, name="lr_adjuster", **cfg)
        if self.fused_trainer is not None:
            for proxy in self.fused_trainer.gd_proxies:
                self.lr_adjuster.add_gd_unit(proxy)
            self.lr_adjuster.train_gate_loader = self.loader
            self.fused_trainer.unlink_from(self.loader)
            self.lr_adjuster.link_from(self.loader)
            self.fused_trainer.link_from(self.lr_adjuster)
            self.fused_trainer.hyper_tick = self.lr_adjuster.run
            return self.lr_adjuster
        for gd in self.gds:
            self.lr_adjuster.add_gd_unit(gd)
        self.lr_adjuster.link_from(*parents)
        return self.lr_adjuster

    def link_lr_schedule(self, cfg):
        """The sample's schedule: ``link_lr_adjuster`` with ``cfg`` (an
        ``lr_adjuster`` config dict) when its ``do`` is true.  In the
        unit graph the adjuster runs after the snapshotter and the first
        GD unit after it; in the fused graph ``link_lr_adjuster`` puts
        it between the loader and the trainer."""
        cfg = dict(cfg)
        if not cfg.pop("do", False):
            return None
        self.link_lr_adjuster(self.snapshotter, **cfg)
        if self.fused_trainer is None:
            self.gds[-1].unlink_from(self.snapshotter)
            self.gds[-1].link_from(self.lr_adjuster)
        return self.lr_adjuster

    def link_rollback(self, *parents, **kwargs):
        """Divergence recovery (reference standard_workflow.py:594-600)
        after ``parents``, fed the decision's ``improved`` and gated on
        the epoch's end: :class:`FusedNNRollback` over the fused
        trainer, else :class:`NNRollback` over every GD unit."""
        if self.fused_trainer is not None:
            self.rollback = FusedNNRollback(
                self, name="rollback", trainer=self.fused_trainer, **kwargs)
        else:
            self.rollback = NNRollback(self, name="rollback", **kwargs)
            for gd in self.gds:
                self.rollback.add_gd(gd)
        self.rollback.link_from(*parents)
        self.rollback.link_attrs(self.decision, "improved")
        self.rollback.gate_skip = ~self.loader.epoch_ended
        return self.rollback

    def link_loop(self, *parents):
        """Close the training loop back into the repeater."""
        self.repeater.link_from(*parents)
        return self.repeater

    def link_end_point(self, *parents):
        self.end_point.link_from(*parents)
        self.end_point.gate_block = ~self.decision.complete
        return self.end_point

    def extract_forward_workflow(self, loader_name=None, loader_config=None,
                                 loader_factory=None):
        """A forward-only :class:`StandardWorkflowBase` of this
        workflow's layers, its loader from ``loader_name`` (with
        ``loader_config``), ``loader_factory`` or else this workflow's
        factory, and its forwards holding this workflow's weights (in
        ``forward_mode``).  Call ``initialize`` on it before ``run``."""
        kwargs = dict(layers=self.layers, preprocessing=False)
        if loader_name is not None:
            kwargs["loader_name"] = loader_name
        elif loader_factory is not None:
            kwargs["loader_factory"] = loader_factory
        else:
            kwargs["loader_factory"] = self.loader_factory
        if loader_config is not None:
            kwargs["loader_config"] = loader_config
        fwd_wf = StandardWorkflowBase(None, **kwargs)
        fwd_wf.create_workflow()
        if self.fused_trainer is not None:
            # the fused parameters map one to one onto the layer list;
            # a pool's dict is empty
            params = self.fused_trainer.host_params()
            for fwd_imp, p in zip(fwd_wf.forwards, params):
                if p:
                    fwd_imp.apply_data_from_master(
                        [p.get("w"), p.get("b")])
                fwd_imp.forward_mode = True
            return fwd_wf
        for fwd_exp, fwd_imp in zip(self.forwards, fwd_wf.forwards):
            data = fwd_exp.generate_data_for_slave(None)
            if data is not None:
                fwd_imp.apply_data_from_master(data)
            fwd_imp.forward_mode = True
        return fwd_wf
