"""Histogram accumulators: ``FixAccumulator`` and ``RangeAccumulator``.

Counterpart of ``znicz_tpu/units/accumulator.py`` (:18-127), the units
that feed the histogram plotters.  ``FixAccumulator`` bins into a fixed
range chosen by the activation type, with an underflow and an overflow
bar; ``RangeAccumulator`` widens its range to cover what it saw,
re-binning its counts by bin centres, and hands its bars out on a
reset.  Each fire reads its input from the device once (``map_read``)
and bins it on the host with JAX's numpy code, so the bars equal the
JAX unit's bar for bar: the bin of a value is ``floor((v - min) *
scale)`` in the input's dtype, a subtraction and then a
multiplication, and a value equal to ``min`` falls into the overflow
bar, as in JAX (:85-95).
"""

import sys

import numpy

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.units import Unit


class FixAccumulator(Unit):
    """A histogram over a fixed range (JAX :18-60)."""

    def __init__(self, workflow, **kwargs):
        super(FixAccumulator, self).__init__(workflow, **kwargs)
        self.bars = kwargs.get("bars", 200)
        self.type = kwargs.get("type", "relu")
        self.input = None
        self.output = Array(name="hist")
        self.reset_flag = Bool(True)
        self.n_bars = [0]
        self.max = 100
        self.min = 0

    def initialize(self, device=None, **kwargs):
        super(FixAccumulator, self).initialize(device=device, **kwargs)
        self.output.reset(numpy.zeros(self.bars + 2, dtype=numpy.int64))

    def run(self):
        if self.type == "relu":
            self.max, self.min = 10000, 0
        elif self.type == "tanh":
            self.max, self.min = 1.7159, -1.7159
        else:
            raise ValueError("Unsupported type %s" % self.type)
        d = self.max - self.min
        if not d:
            return
        self.output.map_write()
        self.input.map_read()
        scale = (self.bars - 1) / d
        if self.reset_flag:
            self.output.mem[:] = 0
        self.n_bars[0] = self.bars + 2
        vals = self.input.mem.ravel()
        below = vals < self.min
        inside = (vals > self.min) & (vals <= self.max)
        # JAX's control flow: y < min -> bar 0; min < y <= max ->
        # floor((y - min) * scale), which shares bar 0 with the
        # underflow; everything else (y > max, and y == min) falls
        # through to the overflow bar
        idx = numpy.floor((vals[inside] - self.min) * scale).astype(int)
        self.output.mem[0] += int(below.sum())
        self.output.mem[self.bars + 1] += int(
            (~below & ~inside).sum())
        numpy.add.at(self.output.mem, idx, 1)


class RangeAccumulator(Unit):
    """A histogram whose range widens to cover the data (JAX :63-127):
    the bar grid is re-binned over the union range; ``x`` / ``y`` are
    the bars' centres and counts, ``x_out`` / ``y_out`` those handed out
    at the last reset."""

    def __init__(self, workflow, **kwargs):
        super(RangeAccumulator, self).__init__(workflow, **kwargs)
        self.bars = kwargs.get("bars", 20)
        self.squash = kwargs.get("squash", True)
        self.input = None
        self.reset_flag = Bool(False)
        self.x = []
        self.y = []
        self.x_out = []
        self.y_out = []
        self.gl_min = sys.float_info.max
        self.gl_max = -sys.float_info.max

    def _rebin(self, new_min, new_max):
        """Redistribute accumulated counts onto a grid over the widened
        range (by bin centers — bounded memory, unlike keeping raw
        samples)."""
        hist = numpy.zeros(self.bars, dtype=numpy.int64)
        if self.y and new_max > new_min:
            width = (new_max - new_min) / self.bars
            for cx, cy in zip(self.x, self.y):
                i = min(int((cx - new_min) / width), self.bars - 1)
                hist[max(i, 0)] += cy
        return hist

    def run(self):
        if self.reset_flag:
            self.x_out = list(self.x)
            self.y_out = list(self.y)
            self.x = []
            self.y = []
            self.gl_min = sys.float_info.max
            self.gl_max = -sys.float_info.max
        self.input.map_read()
        vals = numpy.asarray(self.input.mem).ravel()
        if not vals.size:
            return
        new_min = min(self.gl_min, float(vals.min()))
        new_max = max(self.gl_max, float(vals.max()))
        if new_max == new_min:
            self.x = [new_min]
            self.y = [(self.y[0] if self.y else 0) + vals.size]
            self.gl_min, self.gl_max = new_min, new_max
            return
        hist = self._rebin(new_min, new_max) \
            if (new_min < self.gl_min or new_max > self.gl_max) and self.y \
            else numpy.asarray(self.y if self.y else
                               numpy.zeros(self.bars, numpy.int64),
                               dtype=numpy.int64)
        if hist.shape[0] != self.bars:  # previous degenerate single bin
            hist = self._rebin(new_min, new_max)
        add, edges = numpy.histogram(vals, bins=self.bars,
                                     range=(new_min, new_max))
        hist = hist + add
        self.gl_min, self.gl_max = new_min, new_max
        self.x = ((edges[:-1] + edges[1:]) / 2).tolist()
        self.y = hist.tolist()
