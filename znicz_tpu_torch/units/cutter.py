"""Input-cutting units.

Counterpart of ``znicz_tpu/units/cutter.py`` (:16-174): ``Cutter``
(type string "cutter") crops a rectangle from each NHWC sample,
``padding`` = (left, top, right, bottom) the margins cut away;
``GDCutter`` pads the error back with zeros; ``Cutter1D`` is the strided
1-D copy ``y[:, oo:oo+len] = alpha * x[:, io:io+len] + beta * y[...]``
(LSTM glue).  Each runs on its device, nothing read back.
"""

import numpy
import torch.nn.functional as F

from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.units.nn_units import Forward, GradientDescentBase


class CutterBase(object):
    """The carrier of ``padding`` and the cut shape."""

    def init_padding(self, kwargs):
        self.padding = kwargs["padding"]

    @property
    def padding(self):
        return self._padding

    @padding.setter
    def padding(self, value):
        if value is None:
            raise ValueError("padding may not be None")
        if not isinstance(value, (tuple, list)):
            raise TypeError("padding must be a tuple or list")
        if len(value) != 4:
            raise ValueError(
                "padding must be (left, top, right, bottom)")
        self._padding = tuple(value)

    def compute_cut_shape(self, input_shape):
        if len(input_shape) != 4:
            raise ValueError("input must be (n_samples, sy, sx, n_channels)")
        if self.padding[0] < 0 or self.padding[1] < 0:
            raise ValueError("padding[0], padding[1] must be >= 0")
        shape = list(input_shape)
        shape[2] -= self.padding[0] + self.padding[2]
        shape[1] -= self.padding[1] + self.padding[3]
        if shape[2] <= 0 or shape[1] <= 0:
            raise ValueError("Resulted output shape is empty")
        return tuple(shape)


class Cutter(CutterBase, Forward):
    """Crops a rectangle from each sample."""

    MAPPING = {"cutter"}

    def __init__(self, workflow, **kwargs):
        super(Cutter, self).__init__(workflow, **kwargs)
        self.init_padding(kwargs)
        self.weights.reset()
        self.bias.reset()
        self.include_bias = False
        self.exports.append("padding")

    def initialize(self, device=None, **kwargs):
        super(Cutter, self).initialize(device=device, **kwargs)
        self.output_shape = self.compute_cut_shape(self.input.shape)
        if self.output and self.output.shape[1:] != self.output_shape[1:]:
            raise ValueError("%s: output %s is not %s" % (
                self.name, self.output.shape, self.output_shape))
        if not self.output or self.output.shape[0] != self.output_shape[0]:
            self.output.reset(numpy.zeros(self.output_shape,
                                          self.input.dtype))

    def run(self):
        left, top = self.padding[0], self.padding[1]
        x = self.input.dev
        self.output.set_dev(x[:, top:top + self.output_shape[1],
                              left:left + self.output_shape[2], :].clone())


class GDCutter(CutterBase, GradientDescentBase):
    """Pads the error back with zeros."""

    MAPPING = {"cutter"}

    def __init__(self, workflow, **kwargs):
        super(GDCutter, self).__init__(workflow, **kwargs)
        self.init_padding(kwargs)

    def initialize(self, device=None, **kwargs):
        self.output_shape = self.compute_cut_shape(self.input.shape)
        if self.err_output.size != int(numpy.prod(self.output_shape)):
            raise ValueError(
                "Computed err_output size differs from the assigned one")
        super(GDCutter, self).initialize(device=device, **kwargs)

    def run(self):
        left, top, right, bottom = self.padding
        out = self.err_output.dev.reshape(self.output_shape)
        self.set_err_input(F.pad(out, (0, 0, left, right, top, bottom)))


class Cutter1D(AcceleratedUnit):
    """``y[:, oo:oo+len] = alpha * x[:, io:io+len] + beta * y[...]``."""

    def __init__(self, workflow, **kwargs):
        super(Cutter1D, self).__init__(workflow, **kwargs)
        self.alpha = kwargs.get("alpha")
        self.beta = kwargs.get("beta")
        self.input_offset = kwargs.get("input_offset", 0)
        self.output_offset = kwargs.get("output_offset", 0)
        self.length = kwargs.get("length")
        self.output = Array(name="output")
        self.demand("alpha", "beta", "input", "length")

    def initialize(self, device=None, **kwargs):
        super(Cutter1D, self).initialize(device=device, **kwargs)
        if not self.output or self.output.shape[0] != self.input.shape[0]:
            self.output.reset(numpy.zeros(
                (self.input.shape[0], self.output_offset + self.length),
                dtype=self.input.dtype))
        elif self.output.sample_size < self.output_offset + self.length:
            raise ValueError("%s: output %s is too narrow" % (
                self.name, self.output.shape))
        self.output.device = self.device

    def run(self):
        y = self.output.dev
        y2 = y.reshape(y.shape[0], -1).clone()
        x2 = self.input.dev.reshape(self.input.shape[0], -1)
        dst = slice(self.output_offset, self.output_offset + self.length)
        patch = x2[:, self.input_offset:self.input_offset + self.length] * \
            self.alpha
        if self.beta:
            patch = patch + y2[:, dst] * self.beta
        y2[:, dst] = patch
        self.output.set_dev(y2.reshape(y.shape))
