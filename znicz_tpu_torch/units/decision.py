"""Decision units — the training loop's termination and bookkeeping.

Counterpart of ``znicz_tpu/units/decision.py`` (``DecisionsRegistry``
:38, ``DecisionBase`` :54, ``TrivialDecision`` :197, ``DecisionGD``
:201-383, ``DecisionMSE`` :384-448).  A slave's decision (``is_slave``)
completes every minibatch and keeps its statistics for the master
(JAX :80-83, :308-309).
At each epoch's end ``train_improved`` takes ``train_improve_condition``
(JAX :89), and each TRAIN segment's end calls ``on_training_finished``
(JAX :104), the hooks through which ``KohonenDecision`` stops on its
weights' change.  ``DecisionGD``
keeps the per-class epoch errors (``epoch_n_err``, ``best_n_err_pt``),
the minimax(valid, train) improvement that gates the snapshotter
(``improved``), early stopping (``fail_iterations``, ``max_epochs`` ->
``complete``), the snapshot suffix (``validation_1.92_train_0.04``)
and ``gd_skip <<= minibatch_class != TRAIN``.  ``DecisionMSE`` keeps
each class's epoch ``[avg, max, min]`` MSE (``epoch_metrics``) and
improves on the average MSE of the epoch's last segment.  At each
TRAIN segment's end the health monitor's divergence detector takes
``health_metric()`` (the TRAIN error %, or the TRAIN average MSE; JAX
:99-113), and every epoch end journals a ``train.epoch`` event.
``testing`` (JAX :116-118) completes the run after one epoch.
``DecisionGD.get_metric_names`` / ``get_metric_values`` (JAX :330-348)
are the best errors and epochs a publisher reports.
"""

import time

import numpy

from znicz_tpu_torch.core import health, telemetry
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.loader.base import TEST, VALID, TRAIN, CLASS_NAME


def nvl(value, default):
    return default if value is None else value


def nmax(*values):
    """max of the non-None values; the last argument is the fallback."""
    vals = [v for v in values[:-1] if v is not None]
    return max(vals) if vals else values[-1]


def pt_str(pt, percent_sign=True):
    if pt is None:
        return "None"
    return ("%.2f%%" % pt) if percent_sign else ("%.2f" % pt)


class DecisionsRegistry(type):
    """MAPPING registry."""

    decisions = {}

    def __init__(cls, name, bases, clsdict):
        super(DecisionsRegistry, cls).__init__(name, bases, clsdict)
        mapping = clsdict.get("MAPPING", None)
        if mapping:
            DecisionsRegistry.decisions[mapping] = cls


class DecisionBase(Unit, metaclass=DecisionsRegistry):
    """Epoch bookkeeping base."""

    def __init__(self, workflow, **kwargs):
        super(DecisionBase, self).__init__(workflow, **kwargs)
        self.complete = Bool(False, name="complete")
        self.improved = Bool(False, name="improved")
        self.train_improved = Bool(False, name="train_improved")
        self.max_epochs = kwargs.get("max_epochs", None)
        self.improved_epoch_number = 0
        self.snapshot_suffix = ""
        self.testing = kwargs.get("testing", False)
        self._epoch_timestamp = None
        self.demand("last_minibatch", "minibatch_class", "epoch_number",
                    "epoch_ended")

    def initialize(self, device=None, **kwargs):
        super(DecisionBase, self).initialize(device=device, **kwargs)
        if self.max_epochs is not None:
            self.info("Will allow max %d epochs", self.max_epochs)

    def run(self):
        if self._epoch_timestamp is None:
            self._epoch_timestamp = time.time()
        self.on_run()
        if self.is_slave:
            self.complete <<= True
            self.on_last_minibatch()
            self._print_statistics()
        elif self.last_minibatch:
            self._on_last_minibatch()

    def _on_last_minibatch(self):
        self.on_last_minibatch()
        if self.epoch_ended:
            self.train_improved <<= self.train_improve_condition()
            improved = self.improve_condition()
            if improved:
                self.improved_epoch_number = self.epoch_number
            self.improved <<= improved
            suffixes = []
            self.fill_snapshot_suffixes(suffixes)
            self.snapshot_suffix = "_".join(suffixes)
            self.complete <<= self._stop_condition()
            telemetry.record_event(
                "train.epoch", epoch=int(self.epoch_number),
                improved=bool(self.improved), suffix=self.snapshot_suffix)
        if self.minibatch_class == TRAIN:
            self.on_training_finished()
            if health.enabled():
                metric = self.health_metric()
                if metric is not None:
                    health.observe_loss(metric, unit=self,
                                        source="epoch_train")
        self._print_statistics()

    def _stop_condition(self):
        if self.testing:
            return True
        return self.stop_condition() or (
            self.max_epochs is not None and
            self.epoch_number >= self.max_epochs)

    def _print_statistics(self):
        stats = []
        self.fill_statistics(stats)
        now = time.time()
        self.info("Epoch %d class %s %s in %.2f sec",
                  self.epoch_number, CLASS_NAME[self.minibatch_class],
                  " ".join(stats), now - self._epoch_timestamp)
        self._epoch_timestamp = now

    # -- subclass hooks ------------------------------------------------------
    def on_run(self):
        pass

    def on_last_minibatch(self):
        pass

    def improve_condition(self):
        return False

    def train_improve_condition(self):
        return False

    def stop_condition(self):
        return False

    def on_training_finished(self):
        pass

    def fill_statistics(self, stats):
        pass

    def fill_snapshot_suffixes(self, suffixes):
        pass

    def health_metric(self):
        """The scalar the divergence detector watches at each TRAIN
        segment's end (None: nothing to watch)."""
        return None


class TrivialDecision(DecisionBase):
    """A decision with no condition of its own: it stops at
    ``max_epochs`` (the RBM sample's, and the base of
    ``KohonenDecision``)."""


class DecisionGD(DecisionBase):
    """Classification decision."""

    MAPPING = "decision_gd"
    LOSS = "softmax"
    BIGNUM = 1.0e30

    def __init__(self, workflow, **kwargs):
        super(DecisionGD, self).__init__(workflow, **kwargs)
        self.fail_iterations = kwargs.get("fail_iterations", 100)
        self.gd_skip = Bool(False, name="gd_skip")
        self.epoch_n_err = [None] * 3
        self.epoch_n_evaluated_samples = [0] * 3
        self.epoch_n_err_pt = [None] * 3
        self.best_n_err_pt = [None] * 3
        self.best_n_err_pt_epoch_number = [None] * 3
        self.best_minimax_n_err_pt = [None] * 3
        self.best_minimax_n_err_pt_epoch_number = -1
        self.minibatch_n_err = None          # linked from the evaluator
        self.minibatch_confusion_matrix = None
        self.minibatch_max_err_y_sum = None
        self.confusion_matrixes = [None] * 3
        self.max_err_y_sums = [0] * 3
        #: the whole bookkeeping rides snapshots, so a resumed run makes
        #: the improve and stop decisions the uninterrupted one makes
        self.exports = ["epoch_n_err", "epoch_n_err_pt", "best_n_err_pt",
                        "snapshot_suffix", "improved_epoch_number",
                        "epoch_n_evaluated_samples",
                        "best_n_err_pt_epoch_number",
                        "best_minimax_n_err_pt",
                        "best_minimax_n_err_pt_epoch_number",
                        "confusion_matrixes", "max_err_y_sums"]

    def on_run(self):
        self.gd_skip <<= (self.minibatch_class != TRAIN)

    def on_last_minibatch(self):
        clazz = self.minibatch_class
        if self.minibatch_confusion_matrix:
            self.confusion_matrixes[clazz] = numpy.array(
                self.minibatch_confusion_matrix.mem)
        if self.minibatch_n_err:
            self.epoch_n_err[clazz] = int(self.minibatch_n_err[0])
            self.epoch_n_evaluated_samples[clazz] = int(
                self.minibatch_n_err[1])
            if self.epoch_n_evaluated_samples[clazz]:
                self.epoch_n_err_pt[clazz] = (
                    100.0 * self.epoch_n_err[clazz] /
                    self.epoch_n_evaluated_samples[clazz])
                if (self.epoch_n_err_pt[clazz] <
                        nvl(self.best_n_err_pt[clazz], self.BIGNUM)):
                    self.best_n_err_pt[clazz] = self.epoch_n_err_pt[clazz]
                    self.best_n_err_pt_epoch_number[clazz] = \
                        self.epoch_number
        if self.minibatch_max_err_y_sum:
            self.max_err_y_sums[clazz] = float(
                self.minibatch_max_err_y_sum[0])

    def improve_condition(self):
        """Minimax(valid, train) improvement — called at epoch end,
        where minibatch_class is VALID when validation exists."""
        clazz = self.minibatch_class
        if (nmax(self.epoch_n_err_pt[clazz], self.epoch_n_err_pt[TRAIN],
                 self.BIGNUM) <
                nmax(self.best_minimax_n_err_pt[clazz],
                     self.best_minimax_n_err_pt[TRAIN], self.BIGNUM)):
            for i in (clazz, TRAIN, TEST):
                self.best_minimax_n_err_pt[i] = self.epoch_n_err_pt[i]
            self.best_minimax_n_err_pt_epoch_number = self.epoch_number
            return True
        return False

    def stop_condition(self):
        if all(nvl(self.best_minimax_n_err_pt[i], 0) <= 0
               for i in (VALID, TRAIN)):
            return True
        return (self.epoch_number - self.improved_epoch_number >
                self.fail_iterations)

    def fill_statistics(self, stats):
        clazz = self.minibatch_class
        if self.minibatch_n_err is not None and \
                self.epoch_n_err[clazz] is not None:
            stats.append("n_err %d of %d (%.2f%%)" % (
                self.epoch_n_err[clazz],
                self.epoch_n_evaluated_samples[clazz],
                nvl(self.epoch_n_err_pt[clazz], 0.0)))
        if not self.is_slave:
            self.reset_statistics()

    def fill_snapshot_suffixes(self, suffixes):
        for clazz in (TEST, VALID, TRAIN):
            if self.epoch_n_err_pt[clazz] is not None:
                suffixes.append("%s_%s" % (
                    CLASS_NAME[clazz],
                    pt_str(self.epoch_n_err_pt[clazz], False)))

    def health_metric(self):
        return self.epoch_n_err_pt[TRAIN]

    def get_metric_names(self):
        if not self.testing:
            return {"Min errors", "Accuracy", "EvaluationFitness",
                    "Best epoch"}
        return set()

    def get_metric_values(self):
        if self.testing:
            return {}
        t, v = CLASS_NAME[TRAIN], CLASS_NAME[VALID]
        return {
            "Min errors": {t: pt_str(self.best_n_err_pt[TRAIN]),
                           v: pt_str(self.best_n_err_pt[VALID])},
            "EvaluationFitness": 1 - nvl(self.best_n_err_pt[VALID],
                                         100.0) / 100.0,
            "Best epoch": {
                t: nvl(self.best_n_err_pt_epoch_number[TRAIN], "None"),
                v: nvl(self.best_n_err_pt_epoch_number[VALID], "None")},
        }

    def reset_statistics(self):
        for vec in (self.minibatch_n_err, self.minibatch_max_err_y_sum,
                    self.minibatch_confusion_matrix):
            if vec is None or not vec:
                continue
            vec.map_invalidate()
            vec.mem[:] = 0


class DecisionMSE(DecisionGD):
    """The regression decision: the evaluator's ``[sum, max, min]``
    become each class's ``epoch_metrics`` ``(sum / class length, max,
    min)``; an epoch improves when its last segment's average is the
    best yet, and training stops ``fail_iterations`` epochs after the
    last improvement."""

    MAPPING = "decision_mse"
    LOSS = "mse"

    def __init__(self, workflow, **kwargs):
        super(DecisionMSE, self).__init__(workflow, **kwargs)
        self.epoch_metrics = [None] * 3
        self.best_metrics = [None] * 3
        self.minibatch_metrics = None  # linked from the evaluator
        self.demand("minibatch_metrics", "class_lengths")
        self.exports = list(self.exports) + ["epoch_metrics",
                                             "best_metrics"]

    def on_last_minibatch(self):
        super(DecisionMSE, self).on_last_minibatch()
        clazz = self.minibatch_class
        if self.minibatch_metrics is not None and self.minibatch_metrics:
            m = self.minibatch_metrics.mem
            n = max(self.class_lengths[clazz], 1)
            self.epoch_metrics[clazz] = (float(m[0]) / n, float(m[1]),
                                         float(m[2]))

    def improve_condition(self):
        clazz = self.minibatch_class
        cur = self.epoch_metrics[clazz]
        if cur is None:
            return False
        if self.best_metrics[clazz] is None or \
                cur[0] < self.best_metrics[clazz][0]:
            self.best_metrics[clazz] = cur
            return True
        return False

    def stop_condition(self):
        return (self.epoch_number - self.improved_epoch_number >
                self.fail_iterations)

    def fill_statistics(self, stats):
        clazz = self.minibatch_class
        if self.epoch_metrics[clazz] is not None:
            stats.append("avg_mse %.6f max %.6f min %.6f" %
                         self.epoch_metrics[clazz])
        super(DecisionMSE, self).fill_statistics(stats)

    def fill_snapshot_suffixes(self, suffixes):
        for clazz in (TEST, VALID, TRAIN):
            if self.epoch_metrics[clazz] is not None:
                suffixes.append("%s_%.6f" % (CLASS_NAME[clazz],
                                             self.epoch_metrics[clazz][0]))

    def health_metric(self):
        m = self.epoch_metrics[TRAIN]
        return m[0] if m is not None else None

    def reset_statistics(self):
        super(DecisionMSE, self).reset_statistics()
        if self.minibatch_metrics is not None and self.minibatch_metrics:
            self.minibatch_metrics.map_invalidate()
            self.minibatch_metrics.mem[:] = 0
            self.minibatch_metrics.mem[2] = numpy.inf
