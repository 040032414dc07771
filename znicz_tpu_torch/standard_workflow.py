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
a fused trainer's through ``host_params``).

The auxiliary linkers (JAX :303-604) add, after the units they name:
``link_avatar`` (the loader's prefetching mirror; call it right after
``link_loader``, before anything links to the loader, in the unit
graph), the plotters (``link_error_plotter``, ``link_weights_plotter``
— through the fused trainer's ``weight_views`` in the fused graph —
``link_conf_matrix_plotter``, ``link_mse_plotter``,
``link_err_y_plotter``, ``link_multi_hist_plotter``,
``link_similar_weights_plotter``, ``link_table_plotter``,
``link_min_max_plotter``, ``link_image_plotter``,
``link_immediate_plotter``; each fires at an epoch's end),
``link_image_saver``, ``link_meandispnorm``, ``link_gd_diff_stats``,
``link_downloader``, ``link_ipython``, ``link_publisher`` (at the
decision's ``complete``) and ``link_data_saver``.
``link_fused_trainer`` takes the ``fused`` config's ``mesh`` (a rank
count, or "hybrid") and ``model_parallel`` (JAX :84-95).
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
        ``fused`` config's keys are its keyword arguments, but ``mesh``
        (a rank count: a mesh over the ``torch.distributed`` world, or
        "hybrid": its model axis inside one host) and
        ``model_parallel`` (the model axis of either), which become
        the trainer's mesh (JAX :84-95)."""
        cfg = dict(self.fused_config)
        mesh = cfg.pop("mesh", None)
        model_parallel = int(cfg.pop("model_parallel", 1))
        if mesh == "hybrid":
            from znicz_tpu_torch.parallel import multihost
            mesh = multihost.make_hybrid_mesh(model_parallel=model_parallel)
        elif isinstance(mesh, int):
            from znicz_tpu_torch.parallel.mesh import make_mesh
            mesh = make_mesh(mesh, model_parallel=model_parallel)
        cfg.setdefault("loss", self.loss_function)
        self.fused_trainer = FusedForwardBackward(
            self, name="fused_trainer", layers=self.layers, mesh=mesh,
            **cfg)
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

    def link_image_saver(self, *parents, **kwargs):
        """Dump misclassified samples, gated on improvement
        (reference standard_workflow.py:533-569)."""
        from znicz_tpu_torch.units.image_saver import ImageSaver
        self.image_saver = ImageSaver(self, name="image_saver", **kwargs)
        self.image_saver.link_from(*parents)
        self.image_saver.link_attrs(self.forwards[-1], "output")
        if self.loss_function == "softmax":
            self.image_saver.link_attrs(self.forwards[-1], "max_idx")
        self.image_saver.link_attrs(
            self.loader,
            ("input", "minibatch_data"),
            ("indices", "minibatch_indices"),
            ("labels", "minibatch_labels"),
            "minibatch_class", "minibatch_size", "epoch_number")
        self.image_saver.gate_skip = ~self.decision.improved
        return self.image_saver

    def link_error_plotter(self, *parents):
        """Per-epoch error curve (reference standard_workflow.py:672-700)."""
        from znicz_tpu_torch.core.plotting_units import AccumulatingPlotter
        self.error_plotter = []
        prev = parents
        for i in (1, 2):  # validation, train
            p = AccumulatingPlotter(self, name="error_%d" % i,
                                    input_field=i)
            p.input = self.decision.epoch_n_err_pt
            p.link_from(*prev)
            p.gate_skip = ~self.decision.epoch_ended
            self.error_plotter.append(p)
            prev = (p,)
        return self.error_plotter[-1]

    def _plottable_weight_sources(self):
        """``([(index, weights Array)], before_fill)`` across both
        execution modes: the unit graph's forward units' weights and
        None, or the fused trainer's weight views and the call that
        points them at the net's live weights before a plotter reads
        them."""
        if self.fused_trainer is not None:
            return (list(self.fused_trainer.weight_views),
                    self.fused_trainer.point_weight_views)
        return [(i, fwd.weights) for i, fwd in enumerate(self.forwards)
                if getattr(fwd, "weights", None) is not None], None

    def link_weights_plotter(self, *parents, **kwargs):
        """Weight-image grids per layer
        (reference standard_workflow.py:853-891); works in fused mode
        through the trainer's weight views."""
        from znicz_tpu_torch.units.nn_plotting_units import Weights2D
        limit = kwargs.get("limit", 64)
        self.weights_plotter = []
        prev = parents
        sources, before_fill = self._plottable_weight_sources()
        for i, weights in sources:
            p = Weights2D(self, name="weights_%d" % i, limit=limit)
            p.input = weights
            p.before_fill = before_fill
            p.link_from(*prev)
            p.gate_skip = ~self.decision.epoch_ended
            self.weights_plotter.append(p)
            prev = (p,)
        return self.weights_plotter[-1] if self.weights_plotter \
            else parents[0]

    def link_conf_matrix_plotter(self, *parents):
        """(reference standard_workflow.py:723-743)"""
        from znicz_tpu_torch.core.plotting_units import MatrixPlotter
        self.conf_matrix_plotter = MatrixPlotter(
            self, name="conf_matrix")
        self.conf_matrix_plotter.input = self.evaluator.confusion_matrix
        self.conf_matrix_plotter.link_from(*parents)
        self.conf_matrix_plotter.gate_skip = ~self.decision.epoch_ended
        return self.conf_matrix_plotter

    def link_mse_plotter(self, *parents):
        """(reference standard_workflow.py:702-721)"""
        from znicz_tpu_torch.units.nn_plotting_units import MSEHistogram
        self.mse_plotter = MSEHistogram(self, name="mse_histogram")
        self.mse_plotter.link_attrs(self.evaluator, "mse")
        self.mse_plotter.link_from(*parents)
        self.mse_plotter.gate_skip = ~self.decision.epoch_ended
        return self.mse_plotter

    def link_err_y_plotter(self, *parents):
        """Last-layer max gradient sum curve
        (reference standard_workflow.py:738-771)."""
        from znicz_tpu_torch.core.plotting_units import AccumulatingPlotter
        self.err_y_plotters = []
        prev = parents
        for i in (1, 2):  # validation, train
            p = AccumulatingPlotter(
                self, name="err_y_%d" % i, input_field=i)
            p.input = self.decision.max_err_y_sums
            p.link_from(*prev)
            p.gate_skip = ~self.decision.epoch_ended
            self.err_y_plotters.append(p)
            prev = (p,)
        return self.err_y_plotters[-1]

    def link_multi_hist_plotter(self, *parents, **kwargs):
        """Per-layer weight histograms
        (reference standard_workflow.py:773-816)."""
        from znicz_tpu_torch.core.plotting_units import MultiHistogram
        weights_input = kwargs.get("weights_input", "weights")
        self.multi_hist_plotter = []
        prev = parents
        if weights_input == "weights":
            sources, before_fill = self._plottable_weight_sources()
        else:
            sources = [(i, getattr(fwd, weights_input))
                       for i, fwd in enumerate(self.forwards)
                       if getattr(fwd, weights_input, None) is not None]
            before_fill = None
        for i, arr in sources:
            p = MultiHistogram(self, name="hist_%d" % i,
                               hist_number=kwargs.get("hist_number", 16),
                               n_bars=kwargs.get("n_bars", 25))
            p.input = arr
            p.before_fill = before_fill
            p.link_from(*prev)
            p.gate_skip = ~self.decision.epoch_ended
            self.multi_hist_plotter.append(p)
            prev = (p,)
        return self.multi_hist_plotter[-1] if self.multi_hist_plotter \
            else parents[0]

    def link_similar_weights_plotter(self, *parents, **kwargs):
        """Weight-diversity grids (reference standard_workflow.py:874-931,
        znicz diversity.SimilarWeights2D)."""
        from znicz_tpu_torch.units.diversity import SimilarWeights2D
        weights_input = kwargs.pop("weights_input", "weights")
        self.similar_weights_plotter = []
        prev = parents
        for i, fwd in enumerate(self.forwards):
            if getattr(fwd, weights_input, None) is None:
                continue
            # non-square weight rows are skipped at RUN time by
            # SimilarWeights2D.fill (shapes are unknown at link time)
            p = SimilarWeights2D(self, name="similar_%d" % i, **kwargs)
            p.input = getattr(fwd, weights_input)
            p.link_from(*prev)
            p.gate_skip = ~self.decision.epoch_ended
            self.similar_weights_plotter.append(p)
            prev = (p,)
        return self.similar_weights_plotter[-1] \
            if self.similar_weights_plotter else parents[0]

    def link_table_plotter(self, *parents):
        """Max/min table over weights and gradients
        (reference standard_workflow.py:934-969)."""
        from znicz_tpu_torch.core.plotting_units import TableMaxMin
        self.table_plotter = TableMaxMin(self, name="table")
        for i, fwd in enumerate(self.forwards):
            if getattr(fwd, "weights", None) is None:
                continue
            self.table_plotter.y.append(fwd.weights)
            self.table_plotter.col_labels.append("weights_%d" % i)
        for i, g in enumerate(self.gds):
            if g is None or getattr(g, "gradient_weights", None) is None:
                continue
            self.table_plotter.y.append(g.gradient_weights)
            self.table_plotter.col_labels.append("gd_%d" % i)
        self.table_plotter.link_from(*parents)
        self.table_plotter.gate_skip = ~self.decision.epoch_ended
        return self.table_plotter

    def link_min_max_plotter(self, is_min, *parents):
        """Epoch-metric extremum curve
        (reference standard_workflow.py:1004-1042)."""
        from znicz_tpu_torch.core.plotting_units import AccumulatingPlotter
        p = AccumulatingPlotter(
            self, name="mse_min" if is_min else "mse_max",
            input_field=2, input_offset=2 if is_min else 1)
        p.input = self.decision.epoch_metrics
        p.link_from(*parents)
        p.gate_skip = ~self.decision.epoch_ended
        if is_min:
            self.min_plotter = p
        else:
            self.max_plotter = p
        return p

    def link_image_plotter(self, *parents):
        """Output vs input sample images
        (reference standard_workflow.py:1044-1066)."""
        from znicz_tpu_torch.core.plotting_units import ImagePlotter
        self.image_plotter = ImagePlotter(self, name="output_sample")
        self.image_plotter.inputs.append(self.forwards[-1].output)
        self.image_plotter.input_fields.append(0)
        self.image_plotter.inputs.append(self.forwards[0].input)
        self.image_plotter.input_fields.append(0)
        self.image_plotter.link_from(*parents)
        self.image_plotter.gate_skip = ~self.decision.epoch_ended
        return self.image_plotter

    def link_immediate_plotter(self, *parents):
        """Data / target / output curves
        (reference standard_workflow.py:1068-1101)."""
        from znicz_tpu_torch.core.plotting_units import ImmediatePlotter
        self.immediate_plotter = ImmediatePlotter(
            self, name="immediate")
        del self.immediate_plotter.inputs[:]
        del self.immediate_plotter.input_fields[:]
        for src in (self.loader.minibatch_data,
                    getattr(self.loader, "minibatch_targets", None),
                    self.forwards[-1].output):
            if src is None:
                continue
            self.immediate_plotter.inputs.append(src)
            self.immediate_plotter.input_fields.append(0)
        self.immediate_plotter.link_from(*parents)
        self.immediate_plotter.gate_skip = ~self.decision.epoch_ended
        return self.immediate_plotter

    # -- aux-service linkers (reference 386-411, 648-670, 1121-1149) --------
    def link_avatar(self, *extra_attrs):
        """Replace the just-linked loader with its prefetching Avatar so
        host-side loading overlaps device compute.  Call right after
        link_loader, BEFORE anything links against the loader (same
        constraint as the reference, standard_workflow.py:386-404)."""
        from znicz_tpu_torch.core.avatar import Avatar
        real = self.loader
        avatar = Avatar(self, loader=real, extra_attrs=tuple(extra_attrs),
                        name="avatar")
        parents = list(real.links_from)
        real.unlink_all()  # the producer thread drives the real loader
        # out of the container too: a snapshot must not take the state
        # of a loader that runs ahead of the consumed stream, so an
        # avatar workflow's snapshot restarts the loader's stream
        self.del_ref(real)
        if parents:
            avatar.link_from(*parents)
        self.real_loader = real
        self.loader = avatar
        return avatar

    def link_meandispnorm(self, *parents):
        """On-the-fly minibatch normalization from the loader's
        mean/rdisp arrays (reference standard_workflow.py:603-624);
        wire the forwards from its ("input", "output")."""
        from znicz_tpu_torch.units.mean_disp_normalizer import \
            MeanDispNormalizer
        self.meandispnorm = MeanDispNormalizer(self, name="meandispnorm")
        self.meandispnorm.link_attrs(
            self.loader, ("input", "minibatch_data"), "mean", "rdisp")
        self.meandispnorm.link_from(*parents)
        return self.meandispnorm

    def link_gd_diff_stats(self, *parents, **kwargs):
        """Gradient-statistics probe over the backward chain
        (reference standard_workflow.py:626-646).  The history is
        flushed to ``file_name`` when the workflow finishes."""
        from znicz_tpu_torch.units.diff_stats import DiffStats
        kwargs.setdefault("arrays",
                          {u: ("gradient_weights",)
                           for u in self.gds if u is not None})
        self.gd_diff_stats = DiffStats(self, name="gd_diff_stats",
                                       **kwargs)
        self.gd_diff_stats.link_from(*parents)
        self.gd_diff_stats.gate_skip = self.decision.gd_skip
        self.on_workflow_finished(self.gd_diff_stats.flush)
        return self.gd_diff_stats

    def link_downloader(self, *parents, **kwargs):
        """(reference standard_workflow.py:407-411)"""
        from znicz_tpu_torch.core.downloader import Downloader
        self.downloader = Downloader(self, name="downloader", **kwargs)
        self.downloader.link_from(*parents)
        return self.downloader

    def link_ipython(self, *parents):
        """Between-epochs interactive shell
        (reference standard_workflow.py:648-661)."""
        from znicz_tpu_torch.core.interaction import Shell
        self.ipython = Shell(self, name="shell")
        self.ipython.link_from(*parents)
        self.ipython.gate_skip = ~self.decision.epoch_ended
        return self.ipython

    def link_publisher(self, *parents, **kwargs):
        """End-of-training report (reference standard_workflow.py:663-670)."""
        from znicz_tpu_torch.core.publishing import Publisher
        self.publisher = Publisher(self, name="publisher", **kwargs)
        self.publisher.link_from(*parents)
        self.publisher.result_providers.add(self.decision)
        self.publisher.loader_unit = getattr(self, "real_loader",
                                             self.loader)
        self.publisher.gate_skip = ~self.decision.complete
        return self.publisher

    def link_data_saver(self, *parents, **kwargs):
        """Record the observed minibatch stream
        (reference standard_workflow.py:1121-1149)."""
        from znicz_tpu_torch.loader.saver import MinibatchesSaver
        self.data_saver = MinibatchesSaver(self, name="data_saver",
                                           **kwargs)
        self.data_saver.link_attrs(
            self.loader, "minibatch_data", "minibatch_labels",
            "minibatch_class", "minibatch_size", "class_lengths",
            "max_minibatch_size", "has_labels", "epoch_ended")
        self.data_saver.link_from(*parents)
        return self.data_saver

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
            # a zero filter has no weights of its own (it masks the next
            # forward's) and no broadcast: JAX's raises AttributeError
            generate = getattr(fwd_exp, "generate_data_for_slave", None)
            data = generate(None) if generate is not None else None
            if data is not None:
                fwd_imp.apply_data_from_master(data)
            fwd_imp.forward_mode = True
        return fwd_wf
