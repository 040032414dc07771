"""Pooling forward units.

Counterpart of ``znicz_tpu/units/pooling.py`` (``PoolingBase`` :17,
``MaxPooling`` / ``MaxAbsPooling`` :122-149, ``AvgPooling`` :254).
Type strings: max_pooling, maxabs_pooling, avg_pooling.  Geometry and
offsets are :mod:`znicz_tpu_torch.ops.pooling`'s (ceil-mode windows,
flat NHWC input offsets of the winners).  On a CUDA tensor
:class:`MaxPooling` runs the hand-written max-pooling kernel
(:func:`znicz_tpu_torch.ops.pooling.max_pooling`); on the card a unit
launches it or raises, and never falls back.  The stochastic variants
are not in the port yet (``ROADMAP.md``).
"""

import numpy

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.units.nn_units import Forward, as_nhwc

_LATER = "is not in this slice of the port (see ROADMAP.md)"


class PoolingBase(object):
    """The carrier of ``POOL_ATTRS`` and the pooling geometry."""

    POOL_ATTRS = ("kx", "ky", "sliding")

    @property
    def input_batch_size(self):
        return self.input.shape[0]

    @property
    def sy(self):
        return self.input.shape[1]

    @property
    def sx(self):
        return self.input.shape[2]

    @property
    def n_channels(self):
        return self.input.size // (self.input_batch_size * self.sx * self.sy)

    @property
    def out_sxy(self):
        ny, nx = pool_ops.output_spatial(self.sy, self.sx, self.ky, self.kx,
                                         self.sliding)
        return nx, ny

    @property
    def output_shape(self):
        nx, ny = self.out_sxy
        return (self.input_batch_size, ny, nx, self.n_channels)


class Pooling(PoolingBase, Forward):
    """The pooling forward base: no weights, an NHWC output."""

    MAPPING = set()
    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(Pooling, self).__init__(workflow, **kwargs)
        self.kx = kwargs["kx"]
        self.ky = kwargs["ky"]
        self.sliding = tuple(kwargs.get("sliding") or (self.kx, self.ky))
        self.exports.extend(self.POOL_ATTRS)
        self.weights.reset()
        self.bias.reset()
        self.include_bias = False

    def initialize(self, device=None, **kwargs):
        super(Pooling, self).initialize(device=device, **kwargs)
        if len(self.input.shape) not in (3, 4):
            raise ValueError("pooling input must be (B,H,W[,C])")
        shape = self.output_shape
        if self.output and self.output.shape[1:] != shape[1:]:
            raise ValueError("%s: output %s is not %s" % (
                self.name, self.output.shape, shape))
        if not self.output or self.output.shape[0] != shape[0]:
            self.output.reset(numpy.zeros(shape, self.input.dtype))


class OffsetPooling(Pooling):
    """Records the flat input offsets of the values it passes through
    (``input_offset``, int32)."""

    MAPPING = set()
    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(OffsetPooling, self).__init__(workflow, **kwargs)
        self.input_offset = Array(name="input_offset")

    def initialize(self, device=None, **kwargs):
        super(OffsetPooling, self).initialize(device=device, **kwargs)
        shape = self.output_shape
        if not self.input_offset or self.input_offset.shape != shape:
            self.input_offset.reset(numpy.zeros(shape, dtype=numpy.int32))
        self.input_offset.device = self.device


class MaxPooling(OffsetPooling):
    """The window's largest value and its winner's offset, first winner
    on ties (the kernel on the card)."""

    MAPPING = {"max_pooling"}
    USE_ABS = False

    def run(self):
        out, offs = pool_ops.max_pooling(
            as_nhwc(self.input.dev).contiguous(), self.ky, self.kx,
            self.sliding, use_abs=self.USE_ABS)
        self.output.set_dev(out)
        self.input_offset.set_dev(offs)


class MaxAbsPooling(MaxPooling):
    """The winner is the largest ``|x|``; passes the SIGNED value."""

    MAPPING = {"maxabs_pooling"}
    USE_ABS = True


class StochasticPoolingBase(OffsetPooling):
    """The stochastic poolings: not in this slice of the port."""

    MAPPING = set()
    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        raise NotImplementedError("%s %s" % (type(self).__name__, _LATER))


class StochasticPooling(StochasticPoolingBase):
    MAPPING = {"stochastic_pooling"}


class StochasticAbsPooling(StochasticPoolingBase):
    MAPPING = {"stochastic_abs_pooling"}


class StochasticPoolingDepooling(StochasticPoolingBase):
    MAPPING = {"stochastic_pool_depool"}


class StochasticAbsPoolingDepooling(StochasticPoolingBase):
    MAPPING = {"stochastic_abs_pool_depool"}


class AvgPooling(Pooling):
    """The mean over the (truncated) window."""

    MAPPING = {"avg_pooling"}

    def run(self):
        self.output.set_dev(pool_ops.avg_pooling(
            as_nhwc(self.input.dev), self.ky, self.kx, self.sliding))
