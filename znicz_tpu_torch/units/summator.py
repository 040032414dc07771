"""Pointwise summator (LSTM glue).

Counterpart of ``znicz_tpu/units/summator.py`` (:13-79): ``output = x +
y``; the backward hands ``err_output`` to both ``err_x`` and ``err_y``,
on the unit's device.
"""

from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.units.multiplier import like_first


class Summator(AcceleratedUnit):
    """``output = x + y``."""

    def __init__(self, workflow, **kwargs):
        super(Summator, self).__init__(workflow, **kwargs)
        self.output = Array(name="output")
        self.demand("x", "y")

    def initialize(self, device=None, **kwargs):
        super(Summator, self).initialize(device=device, **kwargs)
        like_first({self.output: self.x if self.x else self.y}, self.device)
        if self.x and self.y and \
                not self.output.shape == self.x.shape == self.y.shape:
            raise ValueError("%s: x %s, y %s and output %s differ" % (
                self.name, self.x.shape, self.y.shape, self.output.shape))

    def run(self):
        self.output.set_dev(self.x.dev + self.y.dev)


class GDSummator(AcceleratedUnit):
    """``err_x = err_y = err_output``."""

    def __init__(self, workflow, **kwargs):
        super(GDSummator, self).__init__(workflow, **kwargs)
        self.err_x = Array(name="err_x")
        self.err_y = Array(name="err_y")
        self.demand("err_output")

    def initialize(self, device=None, **kwargs):
        super(GDSummator, self).initialize(device=device, **kwargs)
        like_first({self.err_x: self.err_output,
                    self.err_y: self.err_output}, self.device)

    def run(self):
        err = self.err_output.dev
        # private copies: a later unit may write one in place
        self.err_x.set_dev(err.clone())
        self.err_y.set_dev(err.clone())
