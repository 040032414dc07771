"""MnistAE — the convolutional autoencoder on MNIST, trained by the
unit-at-a-time graph (``python -m znicz_tpu_torch mnist_ae``).

Counterpart of ``znicz_tpu/samples/research/mnist_ae.py``: conv 5x5x5
(no bias) -> ``StochasticAbsPooling`` 3x3 sliding (2, 2) -> depooling
(``GDMaxAbsPooling`` run as a forward stage on every minibatch, over
the pool's stochastic winners: the backward kernel on the card) ->
``Deconv`` with the conv's weights and geometry -> ``EvaluatorMSE``
against the input frames -> ``DecisionMSE``, with ``GDDeconv`` the only
gradient unit (``root.mnist_ae``, the published config).  The data is
the port's MNIST loader, reshaped to NHWC with one channel
(:class:`MnistAELoader`).
"""

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.loader_mnist import MnistLoader
from znicz_tpu_torch.units import conv as conv_units
from znicz_tpu_torch.units import decision as decision_units
from znicz_tpu_torch.units import deconv as deconv_units
from znicz_tpu_torch.units import evaluator as evaluator_units
from znicz_tpu_torch.units import gd_pooling as gd_pooling_units
from znicz_tpu_torch.units import nn_units
from znicz_tpu_torch.units import pooling as pooling_units


class MnistAELoader(MnistLoader):
    """MNIST with an explicit channel axis: the deconv's output shape
    comes from the conv's input, which must be NHWC."""

    MAPPING = "mnist_ae_loader"

    def load_data(self):
        super(MnistAELoader, self).load_data()
        d = self.original_data.mem
        self.original_data.reset(d.reshape(d.shape[0], 28, 28, 1))


root.mnist_ae.update({
    "decision": {"fail_iterations": 20, "max_epochs": 1000},
    "snapshotter": {"prefix": "mnist_ae", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loader": {"minibatch_size": 100, "normalization_type": "linear"},
    "learning_rate": 0.000001,
    "weights_decay": 0.00005,
    "gradient_moment": 0.00001,
    "n_kernels": 5,
    "kx": 5,
    "ky": 5,
    "include_bias": False,
    "unsafe_padding": True,
    "pooling": {"kx": 3, "ky": 3, "sliding": (2, 2)},
})


class MnistAEWorkflow(nn_units.NNWorkflow):
    """conv -> stochastic abs pool -> depool -> deconv with the conv's
    weights, trained to reproduce its input."""

    def __init__(self, workflow=None, **kwargs):
        super(MnistAEWorkflow, self).__init__(workflow, **kwargs)
        cfg = root.mnist_ae
        loader_cfg = cfg.loader.as_dict()
        loader_cfg.update(kwargs.get("loader_config") or {})
        decision_cfg = cfg.decision.as_dict()
        decision_cfg.update(kwargs.get("decision_config") or {})
        snap_cfg = cfg.snapshotter.as_dict()
        snap_cfg.update(kwargs.get("snapshotter_config") or {})
        pool = dict(kx=cfg.pooling.kx, ky=cfg.pooling.ky,
                    sliding=tuple(cfg.pooling.sliding))

        self.repeater.link_from(self.start_point)

        self.loader = MnistAELoader(self, name="loader", **loader_cfg)
        self.loader.link_from(self.repeater)

        self.conv = conv_units.Conv(
            self, name="conv", n_kernels=cfg.n_kernels, kx=cfg.kx,
            ky=cfg.ky, weights_filling="uniform",
            include_bias=cfg.include_bias)
        self.conv.link_from(self.loader)
        self.conv.link_attrs(self.loader, ("input", "minibatch_data"))

        self.pool = pooling_units.StochasticAbsPooling(self, name="pool",
                                                       **pool)
        self.pool.link_from(self.conv)
        self.pool.link_attrs(self.conv, ("input", "output"))

        # the depooling: the abs pool's backward as a forward stage, its
        # err_output the pool's output, its err_input the input's shape
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
        self.forwards[:] = [self.conv, self.pool, self.deconv]

        self.evaluator = evaluator_units.EvaluatorMSE(self, name="evaluator")
        self.evaluator.link_from(self.deconv)
        self.evaluator.link_attrs(self.deconv, "output")
        self.evaluator.link_attrs(
            self.loader, ("batch_size", "minibatch_size"),
            ("target", "minibatch_data"))

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
            self.deconv, "weights", "input", "n_kernels", "kx", "ky",
            "sliding", "padding")
        self.gd_deconv.link_from(self.snapshotter)
        self.gd_deconv.gate_skip = self.decision.gd_skip
        self.gds[:] = [self.gd_deconv]

        self.repeater.link_from(self.gd_deconv)
        self.end_point.link_from(self.gd_deconv)
        self.end_point.gate_block = ~self.decision.complete
        self.loader.gate_block = self.decision.complete

    def reconstruction_mse(self):
        """The last epoch's TRAIN ``(avg, max, min)`` MSE."""
        return self.decision.epoch_metrics[2]


def build(**kwargs):
    return MnistAEWorkflow(**kwargs)


def run_sample(device=None, **kwargs):
    """Build, initialize on ``device`` (the card unless "cpu") and
    train."""
    wf = build(**kwargs)
    wf.initialize(device=device)
    wf.run()
    return wf


def run(load, main):
    """The launcher contract (``python -m znicz_tpu_torch mnist_ae``)."""
    load(MnistAEWorkflow)
    main()
