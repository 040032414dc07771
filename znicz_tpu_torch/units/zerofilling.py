"""ZeroFiller — the grouping mask of the next layer's weights.

Counterpart of ``znicz_tpu/units/zerofilling.py`` (``ZeroFiller``
:15-79), type string "zero_filter".  ``StandardWorkflowBase.
link_forwards`` links the NEXT forward's ``weights`` Array into it
(``LINKS_NEXT_WEIGHTS``); AlexNet emulates its two-group convolutions
with it.  The mask is ``(k % g) != (c % g)`` over ``(n_kernels,
size // n_kernels)``, built on the first run (the next layer's weights
do not exist when this unit initializes, since it comes first in the
graph).  Every run, TRAIN and VALID, multiplies the weights by it in
place on their device: one ``mul_``, no kernel of its own.  The tensor
is the one the forward and the GD unit read next, because both hold
this same Array.
"""

import numpy

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.units.nn_units import ForwardBase


def grouping_mask(shape, grouping, dtype=numpy.float32):
    """The mask over ``shape`` = (kernels, weights per kernel): 1 where
    ``k % grouping != c % grouping``."""
    k = numpy.arange(shape[0])[:, None] % grouping
    c = numpy.arange(shape[1])[None, :] % grouping
    return (k != c).astype(dtype)


class ZeroFiller(ForwardBase):
    """Zeroes the grouped-out entries of the linked ``weights``."""

    MAPPING = {"zero_filter"}
    #: StandardWorkflowBase links the next forward's weights into this unit
    LINKS_NEXT_WEIGHTS = True

    def __init__(self, workflow, **kwargs):
        super(ZeroFiller, self).__init__(workflow, **kwargs)
        self.mask = Array(name="mask")
        self.grouping = kwargs.get("grouping", 2)
        self.demand("weights")

    @property
    def effective_shape(self):
        return (self.weights.shape[0],
                self.weights.size // self.weights.shape[0])

    @property
    def grouping(self):
        return self._grouping

    @grouping.setter
    def grouping(self, value):
        if not isinstance(value, int):
            raise TypeError("grouping must be an integer")
        if value < 2:
            raise ValueError("grouping value %d is invalid" % value)
        self._grouping = value

    def initialize(self, device=None, **kwargs):
        super(ZeroFiller, self).initialize(device=device, **kwargs)
        self.mask.device = self.device
        if self.weights:
            self._ensure_mask()

    def _ensure_mask(self):
        if self.mask:
            if self.mask.shape != self.effective_shape:
                raise ValueError("%s: mask %s does not fit weights %s" % (
                    self.name, self.mask.shape, self.weights.shape))
            return
        if self.effective_shape[1] % self.grouping != 0:
            raise ValueError(
                "Non-multiple of grouping weights shape: %s, grouping=%d"
                % (self.weights.shape, self.grouping))
        self.mask.reset(grouping_mask(self.effective_shape, self.grouping,
                                      self.weights.dtype))

    def run(self):
        self._ensure_mask()
        w = self.weights.dev
        w.mul_(self.mask.dev.view(w.shape))
        # the tensor changed under the Array: its host copy is stale
        self.weights.set_dev(w)
