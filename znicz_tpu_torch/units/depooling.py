"""The depooling unit, the autoencoders' inverse of an offset pooling.

Counterpart of ``znicz_tpu/units/depooling.py`` (``Depooling`` :15):
the input put back at ``output_offset``, the flat winner offsets that
the tied max or stochastic pooling recorded, in zeros shaped like
``output_shape_source`` (the pool's input).  On the card it runs the
hand-written backward kernel (:func:`znicz_tpu_torch.ops.pooling.
depooling`), which walks each cell's covering windows, so it also takes
the pool's window: ``kx``, ``ky`` and ``sliding``, given or linked from
the pool.
"""

import numpy

from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.units.nn_units import Forward, as_nhwc


class Depooling(Forward):
    """Scatters its input to the tied pool's winners."""

    MAPPING = {"depooling"}

    def __init__(self, workflow, **kwargs):
        super(Depooling, self).__init__(workflow, **kwargs)
        self.weights.reset()
        self.bias.reset()
        self.include_bias = False
        self.kx = kwargs.get("kx")
        self.ky = kwargs.get("ky")
        self.sliding = kwargs.get("sliding")
        self.demand("input", "output_offset", "output_shape_source", "kx",
                    "ky", "sliding")

    def initialize(self, device=None, **kwargs):
        super(Depooling, self).initialize(device=device, **kwargs)
        if self.output_offset.shape != self.input.shape:
            raise ValueError("output_offset shape %s != input shape %s"
                             % (self.output_offset.shape, self.input.shape))
        output_shape = tuple(self.output_shape_source.shape)
        if output_shape[0] != self.input.shape[0]:
            raise ValueError("output_shape_source.shape[0] != input.shape[0]")
        if not self.output or self.output.shape != output_shape:
            self.output.reset(numpy.zeros(output_shape, self.input.dtype))

    def run(self):
        shape = tuple(self.output.shape)
        self.output.set_dev(pool_ops.depooling(
            as_nhwc(self.input.dev).contiguous(),
            as_nhwc(self.output_offset.dev),
            as_nhwc(shape), self.ky, self.kx,
            tuple(self.sliding)).reshape(shape))
