"""Fully-connected backward (gradient-descent) units.

Counterpart of ``znicz_tpu/units/gd.py`` (:21-120), registered under
the forward type strings.  Each run: (1) the chain rule through the
activation, ``err_output *= f'(output)``, written into the Array the
next unit's backward owns (the linked ``err_output``), as the JAX
graph does; (2) the input gradient; (3) the weight and bias gradients
(:func:`znicz_tpu_torch.ops.dense.backward`); (4) the update algebra of
:class:`~znicz_tpu_torch.units.nn_units.GradientDescentBase`.  All on
the device, nothing read back.
"""

from znicz_tpu_torch.ops import activations, dense
from znicz_tpu_torch.units.nn_units import (
    GradientDescentBase, GradientDescentWithActivation)


def err_output_update(unit):
    """``err_output *= f'(output)`` for a non-linear ``unit.ACTIVATION``,
    into the linked ``err_output`` Array."""
    if unit.ACTIVATION == "linear":
        return
    err = unit.err_output.dev
    d = activations.derivative(unit.ACTIVATION,
                               unit.output.dev.reshape(err.shape))
    unit.err_output.set_dev(err * d)


class GradientDescent(GradientDescentBase):
    """The backward of All2All."""

    MAPPING = {"all2all"}
    ACTIVATION = "linear"

    def __init__(self, workflow, **kwargs):
        super(GradientDescent, self).__init__(workflow, **kwargs)
        self.demand("weights")
        if self.include_bias:
            self.demand("bias")

    def run(self):
        err_output_update(self)
        err_in, grad_w, grad_b = dense.backward(
            self.input.dev, self.err_output.dev, self.weights.dev,
            weights_transposed=self.weights_transposed,
            need_err_input=self.need_err_input,
            include_bias=self.include_bias and self.bias is not None)
        if self.need_err_input:
            self.set_err_input(err_in)
        if self.need_gradient_weights:
            self.apply_update("weights", grad_w)
            if self.include_bias and self.bias:
                self.apply_update("bias", grad_b)


class GDSoftmax(GradientDescent):
    """``err_output`` is already the softmax-CE gradient."""
    MAPPING = {"softmax"}
    ACTIVATION = "linear"


class GDTanh(GradientDescentWithActivation, GradientDescent):
    """``f'(y) = 1.14381894 - 0.388484177 y^2``."""
    MAPPING = {"all2all_tanh"}
    ACTIVATION = "tanh"


class GDRELU(GradientDescentWithActivation, GradientDescent):
    """``f'(y) = 1 - e^-y``."""
    MAPPING = {"all2all_relu"}
    ACTIVATION = "relu"


class GDStrictRELU(GradientDescentWithActivation, GradientDescent):
    """``f'(y) = [y > 0]``."""
    MAPPING = {"all2all_str"}
    ACTIVATION = "strict_relu"


class GDSigmoid(GradientDescentWithActivation, GradientDescent):
    """``f'(y) = y (1 - y)``."""
    MAPPING = {"all2all_sigmoid"}
    ACTIVATION = "sigmoid"
