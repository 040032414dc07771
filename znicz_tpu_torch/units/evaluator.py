"""Evaluator units — ``err_output`` and the classification stats of
the last forward.

Counterpart of ``znicz_tpu/units/evaluator.py`` (``EvaluatorsRegistry``
:17, ``EvaluatorBase`` :37, ``EvaluatorSoftmax`` :85-200,
``EvaluatorMSE`` :202-325).  The stats come from
:mod:`znicz_tpu_torch.ops.evaluator` on the workflow's device and fold
into host accumulators in one readback a minibatch, or — when the
fused trainer ran a window — from the window's own stats
(``_consume_window_stats``).  The accumulators keep the output's dtype,
as the JAX package's do, and ride a snapshot (a mid-epoch resume
continues their fold).  ``mean`` (default True) divides ``err_output``
by the batch size; ``testing`` (JAX :45-75) merges every minibatch's
output into ``merged_output``, at the loader's running offset, when
the evaluator is built with it: the launcher's ``--testing`` sets the
flag after ``initialize``, as the JAX launcher does, and then nothing
is merged.
"""

import numpy

from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.memory import Array, host_fetch
from znicz_tpu_torch.ops import evaluator as ev_ops


class EvaluatorsRegistry(type):
    """LOSS-string registry."""

    evaluators = {}

    def __init__(cls, name, bases, clsdict):
        super(EvaluatorsRegistry, cls).__init__(name, bases, clsdict)
        loss = clsdict.get("LOSS", None)
        if loss:
            EvaluatorsRegistry.evaluators[loss] = cls


class EvaluatorBase(AcceleratedUnit, metaclass=EvaluatorsRegistry):
    """Allocates ``err_output`` like the last forward's ``output``."""

    LOSS = None

    def __init__(self, workflow, **kwargs):
        super(EvaluatorBase, self).__init__(workflow, **kwargs)
        self.mean = kwargs.get("mean", True)
        self.testing = kwargs.get("testing", False)
        self.err_output = Array(name="err_output")
        self._merged_output = None
        self.demand("output", "batch_size")
        if self.testing:
            # the merge position is the loader's running offset
            self.demand("offset")

    @property
    def merged_output(self):
        return self._merged_output

    def initialize(self, device=None, **kwargs):
        super(EvaluatorBase, self).initialize(device=device, **kwargs)
        self.err_output.reset(numpy.zeros(self.output.shape,
                                          dtype=self.output.dtype))
        if self.testing:
            total = getattr(self, "class_lengths", None)
            n = sum(total) if total else self.output.shape[0]
            self._merged_output = numpy.zeros(
                (n,) + tuple(self.output.shape[1:]), dtype=self.output.dtype)

    def merge_output(self):
        """Testing mode: the minibatch's output rows into
        ``merged_output`` (reference evaluator.py:122-131)."""
        if self._merged_output is None:
            return
        bs = int(self.batch_size)
        off = int(self.offset)
        self.output.map_read()
        self._merged_output[off - bs:off] = self.output.mem[:bs]


class EvaluatorSoftmax(EvaluatorBase):
    """Softmax cross-entropy gradient and classification stats."""

    MAPPING = "evaluator_softmax"
    LOSS = "softmax"

    def __init__(self, workflow, **kwargs):
        super(EvaluatorSoftmax, self).__init__(workflow, **kwargs)
        self.confusion_matrix = Array(name="confusion_matrix")
        self.n_err = Array(name="n_err")
        self.max_err_output_sum = Array(name="max_err_output_sum")
        #: a unit exposing ``window_stats`` (the fused trainer): when it
        #: carries the stats of the window it just ran, those are folded
        #: — the output then holds only the window's last minibatch
        self.stats_source = None
        self.demand("labels", "max_idx")
        self.exports = ["n_err", "confusion_matrix", "max_err_output_sum"]

    def initialize(self, device=None, **kwargs):
        super(EvaluatorSoftmax, self).initialize(device=device, **kwargs)
        out_size = int(numpy.prod(self.output.shape[1:]))
        self.n_err.reset(numpy.zeros(2, dtype=numpy.int32))
        self.max_err_output_sum.reset(numpy.zeros(1, self.output.dtype))
        self.confusion_matrix.reset(numpy.zeros((out_size, out_size),
                                                dtype=numpy.int32))

    def _accumulate_stats(self, n_err_delta, conf_delta, max_err_sum):
        """Fold one minibatch's or window's host stats."""
        self.n_err.map_write()
        self.n_err.mem += numpy.asarray(n_err_delta)
        self.confusion_matrix.map_write()
        self.confusion_matrix.mem += numpy.asarray(conf_delta)
        self.max_err_output_sum.map_write()
        self.max_err_output_sum.mem[0] = max(
            float(self.max_err_output_sum.mem[0]), float(max_err_sum))

    def _consume_window_stats(self):
        ws = getattr(self.stats_source, "window_stats", None) \
            if self.stats_source is not None else None
        if ws is None:
            return False
        if ws.get("deferred"):
            # a mid-segment window: its stats ride the trainer's device
            # accumulators (or were folded by the trainer already); the
            # segment-final window delivers the rest, folded here
            return True
        self.fold_window_stats(ws)
        if self.testing:
            self.merge_output()
        return True

    def fold_window_stats(self, ws):
        """Fold a fused window's host stats."""
        self._accumulate_stats(ws["n_err"], ws["confusion"],
                               ws["max_err_sum"])

    def run(self):
        if self._consume_window_stats():
            return
        out = self.output.dev
        out2 = out.reshape(out.shape[0], -1)
        err, n_err, conf, mx = ev_ops.softmax_ce(
            out2, self.max_idx.dev, self.labels.dev, int(self.batch_size),
            int(out2.shape[1]), mean=self.mean)
        self.err_output.set_dev(err.reshape(out.shape))
        self._accumulate_stats(*host_fetch((n_err, conf, mx)))
        if self.testing:
            self.merge_output()


class EvaluatorMSE(EvaluatorBase):
    """The MSE gradient, the ``[sum, max, min]`` of the per-sample MSE
    (``root``: of its square root) and, where the loader has
    ``class_targets``, the nearest-class-target error ``n_err``."""

    MAPPING = "evaluator_mse"
    LOSS = "mse"

    def __init__(self, workflow, **kwargs):
        super(EvaluatorMSE, self).__init__(workflow, **kwargs)
        self.metrics = Array(name="metrics")
        self.mse = Array(name="mse")
        self.n_err = Array(name="n_err")
        self.root = kwargs.get("root", True)
        self.squared_mse = kwargs.get("squared_mse", False)
        self.class_targets = None
        self.labels = None
        #: a unit exposing ``window_stats`` with "metrics" (the fused
        #: trainer's MSE windows), as ``EvaluatorSoftmax.stats_source``
        self.stats_source = None
        self.demand("target")
        self.exports = ["metrics", "mse", "n_err"]

    def initialize(self, device=None, **kwargs):
        super(EvaluatorMSE, self).initialize(device=device, **kwargs)
        if self.output.size != self.target.size or \
                self.output.shape[0] != self.target.shape[0]:
            raise ValueError(
                "output shape %s and target shape %s are incompatible"
                % (self.output.shape, self.target.shape))
        self.metrics.reset(numpy.zeros(3, dtype=self.output.dtype))
        self.metrics.mem[2] = numpy.inf
        self.mse.reset(numpy.zeros(self.output.shape[0],
                                   dtype=self.output.dtype))
        self.n_err.reset(numpy.zeros(2, dtype=numpy.int32))
        self.mse.device = self.device

    def _accumulate_stats(self, metrics_delta, n_err_delta):
        """Fold one minibatch's or window's host stats."""
        self.metrics.map_write()
        md = numpy.asarray(metrics_delta)
        self.metrics.mem[0] += md[0]
        self.metrics.mem[1] = max(self.metrics.mem[1], md[1])
        self.metrics.mem[2] = min(self.metrics.mem[2], md[2])
        if n_err_delta is not None:
            self.n_err.map_write()
            self.n_err.mem += numpy.asarray(n_err_delta)

    def _counts_targets(self):
        return self.class_targets is not None and \
            bool(self.class_targets) and self.labels is not None

    def _consume_window_stats(self):
        ws = getattr(self.stats_source, "window_stats", None) \
            if self.stats_source is not None else None
        if ws is None:
            return False
        if ws.get("deferred"):
            # a mid-segment window: see EvaluatorSoftmax
            return True
        self.fold_window_stats(ws)
        if self.testing:
            self.merge_output()
        return True

    def fold_window_stats(self, ws):
        """Fold a fused MSE window's host stats."""
        if ws.get("mse_per") is not None:
            self.mse.mem = numpy.asarray(ws["mse_per"])
        self._accumulate_stats(
            ws["metrics"], ws.get("n_err") if self._counts_targets()
            else None)

    def run(self):
        if self._consume_window_stats():
            return
        out = self.output.dev
        bs = int(self.batch_size)
        err, md, mse_per = ev_ops.mse(out, self.target.dev, bs,
                                      root=self.root, mean=self.mean)
        self.err_output.set_dev(err)
        self.mse.set_dev(mse_per)
        n_err = None
        if self._counts_targets():
            if self.class_targets.device is None:
                self.class_targets.device = self.device
            n_err = ev_ops.nearest_target_errors(
                out, self.class_targets.dev, self.labels.dev, bs)
        self._accumulate_stats(*host_fetch((md, n_err)))
        if self.testing:
            self.merge_output()
