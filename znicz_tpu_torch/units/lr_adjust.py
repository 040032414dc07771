"""Learning-rate schedules applied per TRAIN minibatch to GD units.

Counterpart of ``znicz_tpu/units/lr_adjust.py``: the policies,
registered by name — ``exp``, ``fixed``, ``step_exp``, ``inv`` and
``arbitrary_step`` — and :class:`LearningRateAdjust`, which runs before
the GD units of every TRAIN minibatch and sets their
``learning_rate`` / ``learning_rate_bias`` to ``policy(k)``, ``k`` the
count of TRAIN minibatches before this one.  In the unit graph it takes
the GD units; in the fused graph the trainer's ``GDProxy`` objects,
whose values reach the window's per-step hypers.
"""

import math

from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.loader.base import TRAIN


class LRAdjustPolicyRegistry(type):
    """Registry of the policies by their ``MAPPING`` name."""

    policies = {}

    def __init__(cls, name, bases, clsdict):
        super(LRAdjustPolicyRegistry, cls).__init__(name, bases, clsdict)
        mapping = clsdict.get("MAPPING", None)
        if mapping:
            LRAdjustPolicyRegistry.policies[mapping] = cls


class PolicyBase(object, metaclass=LRAdjustPolicyRegistry):
    """A pickleable callable: iteration number -> learning rate."""


class ExpPolicy(PolicyBase):
    """base * gamma ** (a_ratio * iter)."""

    MAPPING = "exp"

    def __init__(self, lr_to_adjust, **kwargs):
        self.base_lr = kwargs.get("base_lr", lr_to_adjust)
        self.gamma = kwargs["gamma"]
        self.a_ratio = kwargs["a_ratio"]

    def __call__(self, itr):
        return self.base_lr * (self.gamma ** (self.a_ratio * itr))


class FixedAjustPolicy(PolicyBase):
    """base."""

    MAPPING = "fixed"

    def __init__(self, lr_to_adjust, **kwargs):
        self.base_lr = kwargs.get("base_lr", lr_to_adjust)

    def __call__(self, itr):
        return self.base_lr


class StepExpPolicy(PolicyBase):
    """base * gamma ** floor(iter / step)."""

    MAPPING = "step_exp"

    def __init__(self, lr_to_adjust, **kwargs):
        self.base_lr = kwargs.get("base_lr", lr_to_adjust)
        self.gamma = kwargs["gamma"]
        self.step = kwargs["step"]

    def __call__(self, itr):
        return self.base_lr * (
            self.gamma ** math.floor(float(itr) / float(self.step)))


class InvAdjustPolicy(PolicyBase):
    """base * (1 + gamma * iter) ** -pow_ratio."""

    MAPPING = "inv"

    def __init__(self, lr_to_adjust, **kwargs):
        self.base_lr = kwargs.get("base_lr", lr_to_adjust)
        self.gamma = kwargs["gamma"]
        self.pow_ratio = kwargs["pow_ratio"]

    def __call__(self, itr):
        return self.base_lr * (1.0 + self.gamma * itr) ** (-self.pow_ratio)


class ArbitraryStepPolicy(PolicyBase):
    """Piecewise constant from ``lrs_with_lengths`` ``[(coeff,
    n_iters), ...]``: ``coeff * base`` for the segment's ``n_iters``
    iterations, 0 past the last segment."""

    MAPPING = "arbitrary_step"

    def __init__(self, lr_to_adjust, **kwargs):
        base_lr = kwargs.get("base_lr", lr_to_adjust)
        lrs_with_lengths = kwargs["lrs_with_lengths"]
        if lrs_with_lengths is None:
            raise ValueError("arbitrary_step needs lrs_with_lengths")
        self.bounds = []  # (first iteration after the segment, lr)
        cur = 0
        for coeff, length in lrs_with_lengths:
            if coeff * base_lr < 0 or length <= 0:
                raise ValueError(
                    "arbitrary_step wants a rate >= 0 and a length > 0 in "
                    "each segment, got (%r, %r) over base %r"
                    % (coeff, length, base_lr))
            cur += length
            self.bounds.append((cur, coeff * base_lr))

    def __call__(self, itr):
        for bound, lr in self.bounds:
            if itr < bound:
                return lr
        return 0.0


class LearningRateAdjust(Unit):
    """Sets every added GD unit's learning rates from the policies.

    The schedule's base is each unit's rate when it is added (at link
    time, the config's value), so a resumed run, whose GD units or
    proxies hold an already-scheduled rate, keeps the original base;
    ``_minibatches_count`` is exported, so the schedule continues
    exactly.  In the fused graph the adjuster runs between the loader
    and the trainer, before the decision sets ``gd_skip`` for the
    minibatch, so it gates on ``train_gate_loader``'s current
    minibatch class instead."""

    def __init__(self, workflow, **kwargs):
        super(LearningRateAdjust, self).__init__(workflow, **kwargs)
        self._gd_units = []
        self._minibatches_count = 0
        self.train_gate_loader = None
        self.lr_policy_name = kwargs.get("lr_policy_name", None)
        self.bias_lr_policy_name = kwargs.get("bias_lr_policy_name", None)
        self.lr_parameters = kwargs.get("lr_parameters", {})
        self.bias_lr_parameters = kwargs.get("bias_lr_parameters", {})
        self._base_lr = {}
        self._base_lr_bias = {}
        self._policies = {}       # (id(gd), kind) -> policy instance
        self.exports = ["_minibatches_count"]

    def add_gd_unit(self, gd_unit):
        self.gate_skip = gd_unit.gate_skip
        self._gd_units.append(gd_unit)
        self._base_lr[gd_unit] = gd_unit.learning_rate
        self._base_lr_bias[gd_unit] = gd_unit.learning_rate_bias

    def _adjusted(self, gd, kind, base, policy_name, params):
        if policy_name is None:
            return None
        key = (id(gd), kind)
        policy = self._policies.get(key)
        if policy is None:
            policy = self._policies[key] = \
                LRAdjustPolicyRegistry.policies[policy_name](base, **params)
        return float(policy(self._minibatches_count))

    def run(self):
        if self.is_slave:
            # a slave takes its rates from the master (JAX :157)
            return
        if self.train_gate_loader is not None and \
                int(self.train_gate_loader.minibatch_class) != TRAIN:
            return
        for gd in self._gd_units:
            lr = self._adjusted(gd, "w", self._base_lr[gd],
                                self.lr_policy_name, self.lr_parameters)
            if lr is not None:
                gd.learning_rate = lr
            lr_bias = self._adjusted(
                gd, "b", self._base_lr_bias[gd], self.bias_lr_policy_name,
                self.bias_lr_parameters)
            if lr_bias is not None:
                gd.learning_rate_bias = lr_bias
        self._minibatches_count += 1
