"""Convolutional backward (gradient-descent) units.

Counterpart of ``znicz_tpu/units/gd_conv.py`` (:21-115), registered
under the conv type strings: the chain rule through the activation
(as :mod:`znicz_tpu_torch.units.gd`), the input and weight gradients
of :func:`znicz_tpu_torch.ops.conv.backward`, then the update algebra.
"""

from znicz_tpu_torch.ops import conv as conv_ops
from znicz_tpu_torch.units.conv import ConvolutionalBase
from znicz_tpu_torch.units.gd import err_output_update
from znicz_tpu_torch.units.nn_units import (
    GradientDescentBase, GradientDescentWithActivation, as_nhwc)


class GradientDescentConv(ConvolutionalBase, GradientDescentBase):
    """The backward of Conv."""

    MAPPING = {"conv"}
    ACTIVATION = "linear"

    def __init__(self, workflow, **kwargs):
        super(GradientDescentConv, self).__init__(workflow, **kwargs)
        self.demand("weights", "n_kernels", "kx", "ky", "padding", "sliding")
        if self.include_bias:
            self.demand("bias")

    def run(self):
        err_output_update(self)
        err_in, grad_w, grad_b = conv_ops.backward(
            as_nhwc(self.input.dev), self.err_output.dev, self.weights2d_dev,
            self.ky, self.kx, self.padding, self.sliding,
            need_err_input=self.need_err_input,
            include_bias=self.include_bias and self.bias is not None)
        if self.need_err_input:
            self.set_err_input(err_in.reshape(self.input.shape))
        if self.need_gradient_weights:
            if self.weights_transposed:
                grad_w = grad_w.T.reshape(self.weights.shape)
            self.apply_update("weights", grad_w)
            if self.include_bias and self.bias:
                self.apply_update("bias", grad_b)


class GDTanhConv(GradientDescentWithActivation, GradientDescentConv):
    MAPPING = {"conv_tanh"}
    ACTIVATION = "tanh"


class GDSigmoidConv(GradientDescentWithActivation, GradientDescentConv):
    MAPPING = {"conv_sigmoid"}
    ACTIVATION = "sigmoid"


class GDRELUConv(GradientDescentWithActivation, GradientDescentConv):
    MAPPING = {"conv_relu"}
    ACTIVATION = "relu"


class GDStrictRELUConv(GradientDescentWithActivation, GradientDescentConv):
    MAPPING = {"conv_str"}
    ACTIVATION = "strict_relu"
