"""The transposed convolution units, the autoencoders' decoder.

Counterpart of ``znicz_tpu/units/deconv.py`` (``Deconv`` :18,
``GDDeconv`` :123).  A :class:`Deconv` has no bias and no weights of
its own: it takes its conv's ``weights`` Array (``deconv.weights is
conv.weights``) and geometry (``link_conv_attrs``), and its output
shape from ``output_shape_source``.  The forward is
:func:`znicz_tpu_torch.ops.conv.deconv_forward`; with
``unsafe_padding`` it is divided by ``hits``, each output cell's
window count.  :class:`GDDeconv` trains the shared weights through
:func:`znicz_tpu_torch.ops.conv.deconv_backward`, the gradient of the
undivided scatter, as the JAX package's does.
"""

import numpy
import torch

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.ops import conv as conv_ops
from znicz_tpu_torch.units.conv import ConvolutionalBase
from znicz_tpu_torch.units.nn_units import (Forward, GradientDescentBase,
                                            as_nhwc)


class Deconv(ConvolutionalBase, Forward):
    """The transposed convolution with its conv's weights."""

    MAPPING = {"deconv"}

    @staticmethod
    def compute_padding(sx, sy, kx, ky, sliding):
        """The padding that makes the deconv the inverse geometry of a
        conv over an ``(sy, sx)`` input."""
        return (kx - sliding[1], ky - sliding[0],
                kx - sx % sliding[1] if sx % sliding[1] != 0
                else kx - sliding[1],
                ky - sy % sliding[0] if sy % sliding[0] != 0
                else ky - sliding[0])

    @staticmethod
    def check_padding_is_safe(kx, ky, sliding):
        if sliding[0] > (ky >> 1) or sliding[1] > (kx >> 1):
            raise ValueError(
                "sliding should not be greater than half of the kernel size")
        if kx % sliding[0] != 0 or ky % sliding[1] != 0:
            raise ValueError("Kernel size should be multiple of sliding")

    def __init__(self, workflow, **kwargs):
        super(Deconv, self).__init__(workflow, **kwargs)
        self.unsafe_padding = kwargs.get("unsafe_padding", False)
        self.hits = Array(name="hits")
        self.padding = kwargs.get("padding")
        self.sliding = tuple(kwargs.get("sliding", (1, 1)))
        self.n_kernels = kwargs.get("n_kernels")
        self.kx = kwargs.get("kx")
        self.ky = kwargs.get("ky")
        self.include_bias = False
        self.demand("n_kernels", "kx", "ky", "sliding", "input", "weights",
                    "output_shape_source")

    def initialize(self, device=None, **kwargs):
        super(Deconv, self).initialize(device=device, **kwargs)
        if self.bias:
            raise ValueError("bias should not be set")
        if (len(self.input.shape) != 4 or
                self.input.shape[3] != self.n_kernels):
            raise ValueError("Incorrectly shaped input encountered")
        weights_shape = (tuple(reversed(self.weights.shape))
                         if self.weights_transposed else self.weights.shape)
        if (len(weights_shape) != 2 or
                weights_shape[0] != self.n_kernels or
                weights_shape[1] % (self.kx * self.ky) != 0):
            raise ValueError("Incorrectly shaped weights encountered")
        output_shape = tuple(self.output_shape_source.shape)
        if len(output_shape) != 4:
            raise ValueError("Incorrect output_shape_source shape")
        if output_shape[0] != self.input.shape[0]:
            raise ValueError("output_shape_source.shape[0] != input.shape[0]")
        try:
            self.check_padding_is_safe(self.kx, self.ky, self.sliding)
        except ValueError:
            if not self.unsafe_padding:
                raise
            self.warning("The padding will be unsafe")
        computed = self.compute_padding(
            output_shape[2], output_shape[1], self.kx, self.ky, self.sliding)
        if self.padding is None:
            self.padding = computed
        elif tuple(self.padding) != computed and not self.unsafe_padding:
            raise ValueError(
                "Expected padding %s but got %s" % (computed, self.padding))
        self.padding = tuple(self.padding)
        if not self.output or self.output.shape != output_shape:
            self.output.reset(numpy.zeros(output_shape, self.input.dtype))
        if self.unsafe_padding:
            hits = conv_ops.deconv_hits(
                tuple(self.input.shape[:3]), self.ky, self.kx, self.padding,
                self.sliding, output_shape, dtype=torch.float64)
            self.hits.reset(torch.clamp(hits, min=1)[..., None].numpy()
                            .astype(self.input.dtype))
            self.hits.device = self.device

    def run(self):
        out = conv_ops.deconv_forward(
            self.input.dev, self.weights2d_dev, self.ky, self.kx,
            self.padding, self.sliding, tuple(self.output.shape))
        if self.unsafe_padding and self.hits:
            out = out / self.hits.dev[:out.shape[0]]
        self.output.set_dev(out)


class GDDeconv(ConvolutionalBase, GradientDescentBase):
    """The backward of :class:`Deconv`: the shared weights' update from
    the gradient of the undivided scatter, and the input gradient when
    ``need_err_input``."""

    MAPPING = {"deconv"}

    def __init__(self, workflow, **kwargs):
        super(GDDeconv, self).__init__(workflow, **kwargs)
        self.include_bias = False
        self.demand("weights", "n_kernels", "kx", "ky", "padding", "sliding")

    def run(self):
        err_in, grad_w = conv_ops.deconv_backward(
            as_nhwc(self.input.dev), as_nhwc(self.err_output.dev),
            self.weights2d_dev, self.ky, self.kx, tuple(self.padding),
            tuple(self.sliding))
        if self.need_err_input:
            self.set_err_input(err_in.reshape(self.input.shape))
        if self.need_gradient_weights:
            if self.weights_transposed:
                grad_w = grad_w.T.reshape(self.weights.shape)
            self.apply_update("weights", grad_w)
