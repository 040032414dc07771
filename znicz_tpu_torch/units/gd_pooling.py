"""Pooling backward units.

Counterpart of ``znicz_tpu/units/gd_pooling.py`` (``GDPooling`` :15,
``GDMaxPooling`` / ``GDMaxAbsPooling`` :41-74, ``GDAvgPooling`` :77).
The max variants route each window's err to the winner its forward
recorded through :func:`znicz_tpu_torch.ops.pooling.
max_pooling_backward`, the hand-written backward kernel on the card
(it needs the window: ``kx``, ``ky``, ``sliding`` from ``POOL_ATTRS``);
the stochastic poolings route the same way (they record offsets as
max pooling does); avg spreads err over the truncated window.  As a
forward stage, ``GDMaxAbsPooling`` is the autoencoders' depooling
(``samples/mnist_ae.py``): linked to a pool's ``output`` as its
``err_output`` and left ungated, it puts the pooled values back at their
winners on every minibatch.  The JAX unit graph's
backward is a scatter-add in window order and the kernel adds in
(dy, dx) order: the two are bit-equal where at most two windows share a
winner (every non-overlapping pool) and agree to rounding elsewhere.
"""

import numpy

from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.units.nn_units import GradientDescentBase, as_nhwc
from znicz_tpu_torch.units.pooling import PoolingBase


class GDPooling(PoolingBase, GradientDescentBase):
    """The pooling backward base."""

    MAPPING = set()
    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(GDPooling, self).__init__(workflow, **kwargs)
        self.kx = kwargs.get("kx")
        self.ky = kwargs.get("ky")
        self.sliding = kwargs.get("sliding")
        if self.kx is None or self.ky is None:
            self.demand("kx", "ky")
        if self.sliding is None:
            self.demand("sliding")

    def initialize(self, device=None, **kwargs):
        out_size = int(numpy.prod(self.output_shape))
        if self.err_output.size != out_size:
            raise ValueError(
                "err_output size %d differs from the size computed from "
                "kx/ky and input shape (%d)"
                % (self.err_output.size, out_size))
        super(GDPooling, self).initialize(device=device, **kwargs)


class GDMaxPooling(GDPooling):
    """err to the recorded winners (the backward kernel on the card)."""

    MAPPING = {"max_pooling", "stochastic_pooling", "stochastic_pool_depool",
               "stochastic_abs_pool_depool"}

    def __init__(self, workflow, **kwargs):
        super(GDMaxPooling, self).__init__(workflow, **kwargs)
        self.demand("input_offset")

    def initialize(self, device=None, **kwargs):
        super(GDMaxPooling, self).initialize(device=device, **kwargs)
        if self.err_output.size != self.input_offset.size:
            raise ValueError("err_output size differs from input_offset's")

    def run(self):
        x_shape = as_nhwc(tuple(self.input.shape))
        err = self.err_output.dev.reshape(self.input_offset.shape)
        self.err_input.set_dev(pool_ops.max_pooling_backward(
            err.contiguous(), self.input_offset.dev, x_shape, self.ky,
            self.kx, tuple(self.sliding)).reshape(self.input.shape))


class GDMaxAbsPooling(GDMaxPooling):
    """The same routing as :class:`GDMaxPooling`."""
    MAPPING = {"maxabs_pooling", "stochastic_abs_pooling"}


class GDAvgPooling(GDPooling):
    """err over the truncated window size, spread on the window."""

    MAPPING = {"avg_pooling"}

    def run(self):
        x_shape = as_nhwc(tuple(self.input.shape))
        err = self.err_output.dev.reshape(self.output_shape)
        self.err_input.set_dev(pool_ops.avg_pooling_backward(
            err, self.ky, self.kx, tuple(self.sliding), x_shape).reshape(
                self.input.shape))
