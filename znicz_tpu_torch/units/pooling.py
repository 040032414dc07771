"""Pooling forward units.

Counterpart of ``znicz_tpu/units/pooling.py`` (``PoolingBase`` :17,
``MaxPooling`` / ``MaxAbsPooling`` :122-149, the stochastic poolings
:152-251, ``AvgPooling`` :254).  Type strings: max_pooling,
maxabs_pooling, stochastic_pooling, stochastic_abs_pooling,
stochastic_pool_depool, stochastic_abs_pool_depool, avg_pooling.
Geometry and offsets are :mod:`znicz_tpu_torch.ops.pooling`'s
(ceil-mode windows, flat NHWC input offsets of the winners).  On a
CUDA tensor :class:`MaxPooling` runs the hand-written max-pooling
kernel (:func:`znicz_tpu_torch.ops.pooling.max_pooling`); on the card
a unit launches it or raises, and never falls back.  The stochastic
poolings draw their uint16 stream on the host from ``prng.get()``, as
the JAX package's do, so the same seed picks the same winners in
either package.
"""

import numpy

import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.units.nn_units import Forward, as_nhwc


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

    def generate_data_for_slave(self, slave=None):
        """A pool has no weights to broadcast."""
        return None

    def apply_data_from_master(self, data):
        pass


class OffsetPooling(Pooling):
    """Records the flat input offsets of the values it passes through
    (``input_offset``, int32, on the window grid)."""

    MAPPING = set()
    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(OffsetPooling, self).__init__(workflow, **kwargs)
        self.input_offset = Array(name="input_offset")

    def initialize(self, device=None, **kwargs):
        super(OffsetPooling, self).initialize(device=device, **kwargs)
        # the window grid: the output's shape, but not for the in-place
        # depooling variants, whose output is the input's
        nx, ny = self.out_sxy
        grid = (self.input_batch_size, ny, nx, self.n_channels)
        if not self.input_offset or self.input_offset.shape != grid:
            self.input_offset.reset(numpy.zeros(grid, dtype=numpy.int32))
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
    """Samples each window's winner with probability proportional to its
    (abs) positive value, from a uint16 stream drawn on the host from
    ``uniform`` (``prng.get()`` by default), one value a window."""

    MAPPING = set()
    hide_from_registry = True
    USE_ABS = False

    def __init__(self, workflow, **kwargs):
        super(StochasticPoolingBase, self).__init__(workflow, **kwargs)
        self.uniform = kwargs.get("uniform") or prng.get()

    def _rand(self):
        """This run's stream, one value a window, on the unit's device."""
        nx, ny = self.out_sxy
        size = self.input_batch_size * ny * nx * self.n_channels
        u16 = self.uniform.randint(0, 1 << 16, size=size, dtype=numpy.uint16)
        return torch.from_numpy(u16.astype(numpy.int32)).to(self.device)

    def run(self):
        out, offs = pool_ops.stochastic_pooling(
            as_nhwc(self.input.dev), self._rand(), self.ky, self.kx,
            self.sliding, use_abs=self.USE_ABS)
        self.output.set_dev(out)
        self.input_offset.set_dev(offs)


class StochasticPooling(StochasticPoolingBase):
    MAPPING = {"stochastic_pooling"}


class StochasticAbsPooling(StochasticPoolingBase):
    MAPPING = {"stochastic_abs_pooling"}
    USE_ABS = True


class StochasticPoolingDepooling(StochasticPoolingBase):
    """Stochastic pooling and depooling in one unit: one winner a
    non-overlapping window keeps its value, every other cell becomes 0;
    the output has the input's shape."""

    MAPPING = {"stochastic_pool_depool"}

    @property
    def output_shape(self):
        return tuple(self.input.shape)

    def initialize(self, device=None, **kwargs):
        if tuple(self.sliding) != (self.kx, self.ky):
            raise ValueError(
                "stochastic_pool_depool requires sliding == (kx, ky), "
                "have %r != (%d, %d)" % (self.sliding, self.kx, self.ky))
        super(StochasticPoolingDepooling, self).initialize(
            device=device, **kwargs)

    def run(self):
        out, offs = pool_ops.stochastic_pool_depool(
            as_nhwc(self.input.dev), self._rand(), self.ky, self.kx,
            use_abs=self.USE_ABS)
        self.output.set_dev(out.reshape(self.output.shape))
        self.input_offset.set_dev(offs)


class StochasticAbsPoolingDepooling(StochasticPoolingDepooling):
    MAPPING = {"stochastic_abs_pool_depool"}
    USE_ABS = True


class AvgPooling(Pooling):
    """The mean over the (truncated) window."""

    MAPPING = {"avg_pooling"}

    def run(self):
        self.output.set_dev(pool_ops.avg_pooling(
            as_nhwc(self.input.dev), self.ky, self.kx, self.sliding))
