"""ImagenetAE — the convolutional autoencoder ladder on ImageNet-sized
images, trained stage by stage through the unit graph
(``python -m znicz_tpu_torch research.imagenet_ae``).

Counterpart of ``znicz_tpu/samples/research/imagenet_ae.py``
(``root.imagenet_ae``, the published ladder: conv 108 9x9/s3, 192
5x5, 224 5x5, 256 3x3, each followed by stochastic abs pooling 3x3/s2
in ceil mode).  A workflow of ``n_stages`` stages runs the earlier
stages as frozen forwards (conv -> ``StochasticAbsPooling``) and trains
only the last: conv -> ``StochasticAbsPooling`` -> depooling
(``GDMaxAbsPooling`` run as a forward stage over the pool's stochastic
winners: the backward kernel on the card) -> ``Deconv`` sharing the
last conv's weights -> ``EvaluatorMSE`` against that conv's input ->
``DecisionMSE``, with ``GDDeconv`` the only gradient unit.
:func:`restore_stage_weights` carries the earlier stages' trained conv
weights from the previous stage's snapshot into a grown workflow (the
reference's ``from_snapshot_add_layer``); the workflow's
``restore_snapshot`` applies it at initialize, and the CLI takes
``--config imagenet_ae.n_stages=N`` and
``--config imagenet_ae.restore_snapshot=PATH``.

The data is :class:`SyntheticImageLoader`'s smooth random RGB fields
(the JAX package's ``RandomState(0xAE)`` draw).  At the default
``size`` of 63 only two stages fit (conv2's 5x5 window does not fit
pool1's 2x2 map); any ``size`` of 150 or more grows all four.
"""

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import (FullBatchLoader, IFullBatchLoader,
                                         TEST, TRAIN, VALID)
from znicz_tpu_torch.units import conv as conv_units
from znicz_tpu_torch.units import decision as decision_units
from znicz_tpu_torch.units import deconv as deconv_units
from znicz_tpu_torch.units import evaluator as evaluator_units
from znicz_tpu_torch.units import gd_pooling as gd_pooling_units
from znicz_tpu_torch.units import nn_units
from znicz_tpu_torch.units import pooling as pooling_units

root.imagenet_ae.update({
    "decision": {"fail_iterations": 20, "max_epochs": 1000},
    "snapshotter": {"prefix": "imagenet_ae", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loader": {"minibatch_size": 8, "size": 63, "n_images": 32},
    "learning_rate": 0.0000003,
    "weights_decay": 0.00005,
    "gradient_moment": 0.00001,
    "include_bias": False,
    "unsafe_padding": True,
    "pooling": {"kx": 3, "ky": 3, "sliding": (2, 2)},
    #: the stage-wise pretraining ladder
    "stages": [
        {"n_kernels": 108, "kx": 9, "ky": 9, "sliding": (3, 3)},
        {"n_kernels": 192, "kx": 5, "ky": 5, "sliding": (1, 1)},
        {"n_kernels": 224, "kx": 5, "ky": 5, "sliding": (1, 1)},
        {"n_kernels": 256, "kx": 3, "ky": 3, "sliding": (1, 1)}],
})


class SyntheticImageLoader(FullBatchLoader, IFullBatchLoader):
    """``n_images`` smooth random ``size`` x ``size`` RGB fields (four
    low-frequency cosine products each, scaled per channel, plus
    noise); a quarter VALID, the rest TRAIN."""

    MAPPING = "imagenet_ae_loader"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("normalization_type", "linear")
        super(SyntheticImageLoader, self).__init__(workflow, **kwargs)
        self.size = kwargs.get("size", 63)
        self.n_images = kwargs.get("n_images", 32)

    def load_data(self):
        r = numpy.random.RandomState(0xAE)
        n, s = self.n_images, self.size
        yy, xx = numpy.mgrid[0:s, 0:s].astype(numpy.float32) / s
        data = numpy.empty((n, s, s, 3), numpy.float32)
        for i in range(n):
            img = numpy.zeros((s, s))
            for _ in range(4):
                fx, fy = r.uniform(1, 4, 2)
                ph = r.uniform(0, 2 * numpy.pi, 2)
                img += r.uniform(0.2, 1.0) * numpy.cos(
                    2 * numpy.pi * fx * xx + ph[0]) * numpy.cos(
                    2 * numpy.pi * fy * yy + ph[1])
            for c in range(3):
                data[i, :, :, c] = img * r.uniform(0.5, 1.0) + \
                    r.normal(0, 0.05, (s, s))
        self.original_data.reset(data)
        n_valid = n // 4
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = n_valid
        self.class_lengths[TRAIN] = n - n_valid


class ImagenetAEWorkflow(nn_units.NNWorkflow):
    """``n_stages`` stages of the ladder (``stages=`` overrides
    ``root.imagenet_ae.stages``): the earlier ones frozen, the last one
    the autoencoder that trains."""

    def __init__(self, workflow=None, **kwargs):
        super(ImagenetAEWorkflow, self).__init__(workflow, **kwargs)
        cfg = root.imagenet_ae
        loader_cfg = cfg.loader.as_dict()
        loader_cfg.update(kwargs.get("loader_config") or {})
        decision_cfg = cfg.decision.as_dict()
        decision_cfg.update(kwargs.get("decision_config") or {})
        snap_cfg = cfg.snapshotter.as_dict()
        snap_cfg.update(kwargs.get("snapshotter_config") or {})
        stages = kwargs.get("stages") or cfg.stages
        self.n_stages = int(kwargs.get("n_stages", 1))
        #: the previous stage's snapshot, restored at initialize
        self.restore_snapshot = kwargs.get("restore_snapshot")
        if not 1 <= self.n_stages <= len(stages):
            raise ValueError("n_stages must be 1..%d" % len(stages))
        pool = dict(kx=cfg.pooling.kx, ky=cfg.pooling.ky,
                    sliding=tuple(cfg.pooling.sliding))

        self.repeater.link_from(self.start_point)
        self.loader = SyntheticImageLoader(self, name="loader",
                                           **loader_cfg)
        self.loader.link_from(self.repeater)

        self.convs, self.pools = [], []
        prev_unit, prev_attr = self.loader, "minibatch_data"
        for s in range(self.n_stages):
            geo = dict(stages[s])
            conv = conv_units.Conv(
                self, name="conv%d" % s, n_kernels=geo["n_kernels"],
                kx=geo["kx"], ky=geo["ky"],
                sliding=tuple(geo.get("sliding", (1, 1))),
                weights_filling="uniform", include_bias=cfg.include_bias)
            conv.link_from(prev_unit)
            conv.link_attrs(prev_unit, ("input", prev_attr))
            self.convs.append(conv)
            stage_pool = pooling_units.StochasticAbsPooling(
                self, name="pool%d" % s, **pool)
            stage_pool.link_from(conv)
            stage_pool.link_attrs(conv, ("input", "output"))
            self.pools.append(stage_pool)
            prev_unit, prev_attr = stage_pool, "output"
        self.conv, self.pool = self.convs[-1], self.pools[-1]

        # the depooling: the abs pool's backward as a forward stage
        self.depool = gd_pooling_units.GDMaxAbsPooling(
            self, name="depool", **pool)
        self.depool.link_from(self.pool)
        self.depool.link_attrs(self.pool, "input", "input_offset",
                               ("err_output", "output"))

        self.deconv = deconv_units.Deconv(
            self, name="deconv", unsafe_padding=cfg.unsafe_padding)
        self.deconv.link_from(self.depool)
        self.deconv.link_attrs(self.conv, "weights")
        self.deconv.link_conv_attrs(self.conv)
        self.deconv.link_attrs(self.depool, ("input", "err_input"))
        self.deconv.link_attrs(self.conv, ("output_shape_source", "input"))
        self.forwards[:] = [u for pair in zip(self.convs, self.pools)
                            for u in pair] + [self.deconv]

        # the last stage reconstructs its own input (the raw images for
        # stage 0)
        self.evaluator = evaluator_units.EvaluatorMSE(self, name="evaluator")
        self.evaluator.link_from(self.deconv)
        self.evaluator.link_attrs(self.deconv, "output")
        self.evaluator.link_attrs(self.loader,
                                  ("batch_size", "minibatch_size"))
        self.evaluator.link_attrs(self.conv, ("target", "input"))

        self.decision = decision_units.DecisionMSE(
            self, name="decision",
            fail_iterations=decision_cfg.get("fail_iterations", 20),
            max_epochs=decision_cfg.get("max_epochs", 1000))
        self.decision.link_from(self.evaluator)
        self.decision.link_attrs(self.loader, "minibatch_class",
                                 "last_minibatch", "class_lengths",
                                 "epoch_ended", "epoch_number")
        self.decision.link_attrs(self.evaluator,
                                 ("minibatch_metrics", "metrics"))

        self.snapshotter = nn_units.NNSnapshotterToFile(
            self, name="snapshotter", **snap_cfg)
        self.snapshotter.link_from(self.decision)
        self.snapshotter.link_attrs(self.decision,
                                    ("suffix", "snapshot_suffix"))
        self.snapshotter.gate_skip = \
            ~self.loader.epoch_ended | ~self.decision.improved

        self.gd_deconv = deconv_units.GDDeconv(
            self, name="gd_deconv", learning_rate=cfg.learning_rate,
            weights_decay=cfg.weights_decay,
            gradient_moment=cfg.gradient_moment, need_err_input=False)
        self.gd_deconv.link_attrs(self.evaluator, "err_output")
        self.gd_deconv.link_attrs(
            self.deconv, "weights", "input", "hits", "n_kernels", "kx", "ky",
            "sliding", "padding")
        self.gd_deconv.link_from(self.snapshotter)
        self.gd_deconv.gate_skip = self.decision.gd_skip
        self.gds[:] = [self.gd_deconv]

        self.repeater.link_from(self.gd_deconv)
        self.end_point.link_from(self.gd_deconv)
        self.end_point.gate_block = ~self.decision.complete
        self.loader.gate_block = self.decision.complete

    def initialize(self, device=None, **kwargs):
        super(ImagenetAEWorkflow, self).initialize(device=device, **kwargs)
        if self.restore_snapshot:
            names = restore_stage_weights(self.restore_snapshot, self)
            self.info("restored stage weights: %s", ", ".join(names))

    def reconstruction_mse(self):
        """The last epoch's TRAIN ``(avg, max, min)`` MSE."""
        return self.decision.epoch_metrics[2]


def restore_stage_weights(snapshot_path, wf):
    """Load the conv weights of a previous stage's snapshot into a
    built, initialized (grown) workflow; only the ``conv*`` units
    restore, so the decision, the loader and the prng streams start
    afresh.  A snapshot conv whose weights do not fit the built one
    raises ``ValueError``.  Returns the restored names, sorted."""
    from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
    state = SnapshotterToFile.import_(snapshot_path)
    units = {u.name: u for u in wf.units}
    conv_states = {}
    for name, ustate in state["units"].items():
        if not name.startswith("conv") or name not in units:
            continue
        saved_w = ustate.get("weights")
        built_w = units[name].weights
        if saved_w is not None and built_w and \
                tuple(saved_w.shape) != tuple(built_w.shape):
            raise ValueError(
                "%s: snapshot weights %s do not fit the built conv %s — "
                "stage geometry changed since the snapshot"
                % (name, saved_w.shape, built_w.shape))
        conv_states[name] = ustate
    nn_units.load_snapshot_into_workflow({"units": conv_states}, wf)
    return sorted(conv_states)


def build(n_stages=1, **kwargs):
    return ImagenetAEWorkflow(n_stages=n_stages, **kwargs)


def run_sample(device=None, restore_snapshot=None, **kwargs):
    """Build, initialize on ``device`` (the card unless "cpu"), restore
    the earlier stages from ``restore_snapshot`` and train."""
    wf = build(restore_snapshot=restore_snapshot, **kwargs)
    wf.initialize(device=device)
    wf.run()
    return wf


def run(load, main):
    """The launcher contract (``python -m znicz_tpu_torch
    research.imagenet_ae``): one stage, as in the JAX sample, unless
    ``--config imagenet_ae.n_stages=N`` grows the ladder, with
    ``--config imagenet_ae.restore_snapshot=PATH`` the previous
    stage's snapshot."""
    cfg = root.imagenet_ae
    load(ImagenetAEWorkflow, n_stages=cfg.get("n_stages", 1),
         restore_snapshot=cfg.get("restore_snapshot"))
    main()
