"""Standalone activation units, forward and backward.

Counterpart of ``znicz_tpu/units/activation.py`` (:16-261).  Type
strings: activation_tanh, activation_sigmoid, activation_relu,
activation_str, activation_log, activation_tanhlog, activation_sincos
and activation_mul.  The "core" activations share the layer epilogues
of :mod:`znicz_tpu_torch.ops.activations` (their derivatives from the
output); log, tanhlog and sincos differentiate through the input
(``ext_apply`` / ``ext_derivative``); ``mul`` scales by a factor that
its first minibatch sets when none is given.
"""

import numpy

from znicz_tpu_torch.ops import activations as act_ops
from znicz_tpu_torch.units.nn_units import Forward, GradientDescentBase


class ActivationForward(Forward):
    """``y = f(x)`` elementwise."""

    MAPPING = set()
    hide_from_registry = True
    ACTIVATION = None
    KIND = "core"

    def __init__(self, workflow, **kwargs):
        super(ActivationForward, self).__init__(workflow, **kwargs)
        self.weights.reset()
        self.bias.reset()
        self.include_bias = False

    def initialize(self, device=None, **kwargs):
        super(ActivationForward, self).initialize(device=device, **kwargs)
        if not self.output or self.output.shape != self.input.shape:
            self.output.reset(numpy.zeros(self.input.shape,
                                          self.input.dtype))

    def _apply(self, x):
        if self.KIND == "core":
            return act_ops.apply(self.ACTIVATION, x)
        return act_ops.ext_apply(self.ACTIVATION, x)

    def run(self):
        self.output.set_dev(self._apply(self.input.dev))


class ActivationBackward(GradientDescentBase):
    """``err_input = err_output * f'``."""

    MAPPING = set()
    hide_from_registry = True
    ACTIVATION = None
    KIND = "core"

    def __init__(self, workflow, **kwargs):
        super(ActivationBackward, self).__init__(workflow, **kwargs)
        self.demand("output")

    def _derivative(self):
        if self.KIND == "core":
            return act_ops.derivative(self.ACTIVATION, self.output.dev)
        return act_ops.ext_derivative(self.ACTIVATION, self.input.dev,
                                      self.output.dev)

    def run(self):
        err = self.err_output.dev
        self.err_input.set_dev(err * self._derivative().reshape(err.shape))


class ForwardTanh(ActivationForward):
    MAPPING = {"activation_tanh"}
    ACTIVATION = "tanh"


class BackwardTanh(ActivationBackward):
    MAPPING = {"activation_tanh"}
    ACTIVATION = "tanh"


class ForwardSigmoid(ActivationForward):
    MAPPING = {"activation_sigmoid"}
    ACTIVATION = "sigmoid"


class BackwardSigmoid(ActivationBackward):
    MAPPING = {"activation_sigmoid"}
    ACTIVATION = "sigmoid"


class ForwardRELU(ActivationForward):
    """Softplus."""
    MAPPING = {"activation_relu"}
    ACTIVATION = "relu"


class BackwardRELU(ActivationBackward):
    MAPPING = {"activation_relu"}
    ACTIVATION = "relu"


class ForwardStrictRELU(ActivationForward):
    """``max(0, x)``."""
    MAPPING = {"activation_str"}
    ACTIVATION = "strict_relu"


class BackwardStrictRELU(ActivationBackward):
    MAPPING = {"activation_str"}
    ACTIVATION = "strict_relu"


class ForwardLog(ActivationForward):
    """``log(x + sqrt(x^2 + 1))``."""
    MAPPING = {"activation_log"}
    ACTIVATION = "log"
    KIND = "ext"


class BackwardLog(ActivationBackward):
    """``1 / sqrt(x^2 + 1)``."""
    MAPPING = {"activation_log"}
    ACTIVATION = "log"
    KIND = "ext"


class ForwardTanhLog(ActivationForward):
    """The tanh/log hybrid."""
    MAPPING = {"activation_tanhlog"}
    ACTIVATION = "tanhlog"
    KIND = "ext"


class BackwardTanhLog(ActivationBackward):
    MAPPING = {"activation_tanhlog"}
    ACTIVATION = "tanhlog"
    KIND = "ext"


class ForwardSinCos(ActivationForward):
    """``sin(x)`` at odd flat indices, ``cos(x)`` at even ones."""
    MAPPING = {"activation_sincos"}
    ACTIVATION = "sincos"
    KIND = "ext"


class BackwardSinCos(ActivationBackward):
    MAPPING = {"activation_sincos"}
    ACTIVATION = "sincos"
    KIND = "ext"


class ForwardMul(ActivationForward):
    """``y = k x``; ``k`` from the first minibatch (``0.75 / max |x|``)
    when not given."""

    MAPPING = {"activation_mul"}
    ACTIVATION = "mul"

    def __init__(self, workflow, **kwargs):
        super(ForwardMul, self).__init__(workflow, **kwargs)
        self._factor = kwargs.get("factor")
        self.exports.append("factor")

    @property
    def factor(self):
        return self._factor

    @factor.setter
    def factor(self, value):
        self._factor = None if value is None else float(value)

    def run(self):
        if self.factor is None:
            # one readback, on the first minibatch only
            mx = float(self.input.dev.abs().max())
            self.factor = 0.75 / mx if mx else 0.75
            self.info("Autosetting factor to %f", self.factor)
        self.output.set_dev(self.input.dev * self.factor)


class BackwardMul(ActivationBackward):
    """``err_input = err_output * k``."""

    MAPPING = {"activation_mul"}
    ACTIVATION = "mul"

    def __init__(self, workflow, **kwargs):
        super(BackwardMul, self).__init__(workflow, **kwargs)
        self.factor = float(kwargs.get("factor", 1.0))

    def run(self):
        self.err_input.set_dev(self.err_output.dev * self.factor)
