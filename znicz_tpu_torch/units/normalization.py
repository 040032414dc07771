"""Local response normalization units (AlexNet/Caffe cross-channel).

Counterpart of ``znicz_tpu/units/normalization.py``
(``LRNormalizerForward`` / ``LRNormalizerBackward`` :25-77).  Type
string "norm"; the forward is :func:`znicz_tpu_torch.ops.normalization.
lrn_forward`, the backward autograd over it
(:func:`~znicz_tpu_torch.ops.normalization.lrn_backward`).
"""

import numpy

from znicz_tpu_torch.ops import normalization as lrn_ops
from znicz_tpu_torch.units.nn_units import Forward, GradientDescentBase


class LRNParams(object):
    def init_lrn(self, kwargs):
        self.alpha = kwargs.get("alpha", 0.0001)
        self.beta = kwargs.get("beta", 0.75)
        self.k = kwargs.get("k", 2)
        self.n = kwargs.get("n", 5)

    @property
    def _lrn_kwargs(self):
        return dict(alpha=self.alpha, beta=self.beta, k=self.k, n=self.n)


class LRNormalizerForward(LRNParams, Forward):
    """The LRN forward."""

    MAPPING = {"norm"}

    def __init__(self, workflow, **kwargs):
        super(LRNormalizerForward, self).__init__(workflow, **kwargs)
        self.init_lrn(kwargs)
        self.weights.reset()
        self.bias.reset()
        self.include_bias = False
        self.exports.extend(("alpha", "beta", "k", "n"))

    def initialize(self, device=None, **kwargs):
        super(LRNormalizerForward, self).initialize(device=device, **kwargs)
        if len(self.input.shape) != 4:
            raise ValueError("LRN input must be NHWC")
        if not self.output or self.output.shape != self.input.shape:
            self.output.reset(numpy.zeros(self.input.shape,
                                          self.input.dtype))

    def run(self):
        self.output.set_dev(lrn_ops.lrn_forward(self.input.dev,
                                                **self._lrn_kwargs))


class LRNormalizerBackward(LRNParams, GradientDescentBase):
    """The LRN backward."""

    MAPPING = {"norm"}

    def __init__(self, workflow, **kwargs):
        super(LRNormalizerBackward, self).__init__(workflow, **kwargs)
        self.init_lrn(kwargs)

    def run(self):
        self.err_input.set_dev(lrn_ops.lrn_backward(
            self.input.dev, self.err_output.dev, **self._lrn_kwargs))
