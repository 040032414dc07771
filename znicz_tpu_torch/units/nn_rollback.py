"""NNRollback — divergence recovery by a weight history and learning
rate adaptation, in the unit graph.

Counterpart of ``znicz_tpu/units/nn_rollback.py`` (reference
nn_rollback.py:44-190): on an improvement each GD unit's learning
rates grow by ``lr_plus`` and its weights, bias and gradients are
stored (a history of ``history_limit``); after ``minus_steps``
epochs without one (at once on a NaN) the rates shrink by
``lr_minus`` and the oldest stored arrays are written back.  As in the
JAX package, and unlike the reference, whose write is a no-op
(``setattr(gd, "weights.mem[:]", ...)``), the rollback restores the
arrays.  The fused graph's counterpart is
:class:`znicz_tpu_torch.units.fused_trainer.FusedNNRollback`.
"""

import numpy

from znicz_tpu_torch.core.units import Unit


class NNRollback(Unit):
    """(reference nn_rollback.py:44-190)"""

    weights_names = ("weights", "bias", "gradient_weights", "gradient_bias")

    def __init__(self, workflow, **kwargs):
        super(NNRollback, self).__init__(workflow, **kwargs)
        self.lr_plus = kwargs.get("lr_plus", 1.04)
        self.lr_minus = kwargs.get("lr_minus", 0.65)
        self.plus_steps = kwargs.get("plus_steps", 1)
        self.minus_steps = kwargs.get("minus_steps", 3)
        self._plus_steps = self.plus_steps
        self._minus_steps = self.minus_steps
        self.history_limit = kwargs.get("history_limit", 2)
        self.improved = None
        self.demand("improved")
        self._gds = {}
        self._first_run = True

    def add_gd(self, gd, lr_plus=None, lr_minus=None):
        kv = self._gds.get(gd, {})
        kv["lr_plus"] = lr_plus
        kv["lr_minus"] = lr_minus
        self._gds[gd] = kv

    def reset(self):
        self._gds.clear()

    def _store_weights(self, gd, name, kv):
        arr = getattr(gd, name)
        arr.map_read()   # the unit graph's Arrays: a host copy each
        history = kv.setdefault(name, [])
        history.append(numpy.array(arr.mem))
        while len(history) > self.history_limit:
            history.pop(0)

    def _count_nans(self, gd, name):
        arr = getattr(gd, name, None)
        if arr is None or not arr:
            return 0
        arr.map_read()
        return int(numpy.count_nonzero(numpy.isnan(arr.mem)))

    def _rollback_weights(self, gd, name, kv, rollback_to):
        arr = getattr(gd, name)
        history = kv.get(name)
        if not history:
            self.warning("No rollback for %s", name)
            return
        self.info("Rolling back %s of %r", name, gd.name)
        arr.map_write()
        arr.mem[...] = history[rollback_to]
        if rollback_to >= 0:
            del history[rollback_to + 1:]

    def run(self):
        if self.improved:
            self._plus_steps += 1
            if self._plus_steps < self.plus_steps:
                return
            self._plus_steps = 0
            self._minus_steps = 0
            for gd, kv in self._gds.items():
                k = kv.get("lr_plus")
                if k is None:
                    k = self.lr_plus
                gd.learning_rate *= k
                gd.learning_rate_bias *= k
                self.debug("Increased lr of %r by %.2f, new lr %.2e",
                           gd.name, k, gd.learning_rate)
                for name in self.weights_names:
                    if getattr(gd, name, None):
                        self._store_weights(gd, name, kv)
        elif not self._first_run:
            rollback_to = 0
            # NaN check forces an immediate rollback to the oldest snapshot
            for gd, kv in self._gds.items():
                nz = sum(self._count_nans(gd, name)
                         for name in self.weights_names)
                if nz:
                    self.warning("NaNs encountered, rolling back")
                    self._minus_steps = self.minus_steps
                    rollback_to = 0
                    break
            self._minus_steps += 1
            if self._minus_steps < self.minus_steps:
                return
            self._minus_steps = 0
            self._plus_steps = 0
            for gd, kv in self._gds.items():
                k = kv.get("lr_minus")
                if k is None:
                    k = self.lr_minus
                gd.learning_rate *= k
                gd.learning_rate_bias *= k
                self.debug("Decreased lr of %r by %.2f, new lr %.2e",
                           gd.name, k, gd.learning_rate)
                for name in self.weights_names:
                    if getattr(gd, name, None):
                        self._rollback_weights(gd, name, kv, rollback_to)
        self._first_run = False
