"""Pointwise multiplier (LSTM glue).

Counterpart of ``znicz_tpu/units/multiplier.py`` (:13-81): ``output =
x * y``; the backward ``err_x = err_output * y``, ``err_y = err_output
* x``, on the unit's device.
"""

import numpy

from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.memory import Array


def like_first(arrays, device):
    """Zero each Array of ``arrays`` ``{Array: source Array}`` like its
    source where the source is allocated and the batch differs, and put
    it on ``device`` (the LSTM wiring may allocate a source later)."""
    for arr, src in arrays.items():
        if src and (not arr or arr.shape[0] != src.shape[0]):
            arr.reset(numpy.zeros(src.shape, src.dtype))
        arr.device = device


class Multiplier(AcceleratedUnit):
    """``output = x * y``."""

    def __init__(self, workflow, **kwargs):
        super(Multiplier, self).__init__(workflow, **kwargs)
        self.output = Array(name="output")
        self.demand("x", "y")

    def initialize(self, device=None, **kwargs):
        super(Multiplier, self).initialize(device=device, **kwargs)
        like_first({self.output: self.x if self.x else self.y}, self.device)
        if self.x and self.y and \
                not self.output.shape == self.x.shape == self.y.shape:
            raise ValueError("%s: x %s, y %s and output %s differ" % (
                self.name, self.x.shape, self.y.shape, self.output.shape))

    def run(self):
        self.output.set_dev(self.x.dev * self.y.dev)


class GDMultiplier(AcceleratedUnit):
    """``err_x = err_output * y``, ``err_y = err_output * x``."""

    def __init__(self, workflow, **kwargs):
        super(GDMultiplier, self).__init__(workflow, **kwargs)
        self.err_x = Array(name="err_x")
        self.err_y = Array(name="err_y")
        self.demand("x", "y", "err_output")

    def initialize(self, device=None, **kwargs):
        super(GDMultiplier, self).initialize(device=device, **kwargs)
        like_first({self.err_x: self.x, self.err_y: self.y}, self.device)

    def run(self):
        err = self.err_output.dev
        self.err_x.set_dev(err * self.y.dev)
        self.err_y.set_dev(err * self.x.dev)
