"""Fully-connected forward units.

Counterpart of ``znicz_tpu/units/all2all.py`` (:21-143).  Type strings:
all2all, all2all_tanh, all2all_relu, all2all_str, all2all_sigmoid,
softmax.  The product, bias and activation are
:func:`znicz_tpu_torch.ops.dense.forward`; the weight-magnitude
heuristic and the fillings are the JAX package's, drawn from the same
host stream.
"""

import numpy

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.ops import dense
from znicz_tpu_torch.ops.init import weights_magnitude
from znicz_tpu_torch.units.nn_units import FullyConnectedOutput, NNLayerBase


class All2All(FullyConnectedOutput, NNLayerBase):
    """``y = x @ W^T + b`` with a linear activation."""

    MAPPING = {"all2all"}
    ACTIVATION = "linear"
    C = 10  # the weight-magnitude constant

    def __init__(self, workflow, **kwargs):
        super(All2All, self).__init__(workflow, **kwargs)
        self.demand("input", "output_sample_shape")

    def get_weights_magnitude(self):
        return weights_magnitude(self.C, self.input.sample_size,
                                 numpy.prod(self.output_sample_shape),
                                 self.weights_filling)

    def initialize(self, device=None, **kwargs):
        super(All2All, self).initialize(device=device, **kwargs)
        if self.weights_stddev is None:
            self.weights_stddev = min(self.get_weights_magnitude(), 0.5)
        if self.bias_stddev is None:
            self.bias_stddev = self.weights_stddev
        weights_shape = (self.neurons_number, self.input.sample_size)
        if not self.weights:
            w = numpy.zeros(weights_shape, dtype=self.input.dtype)
            self.fill_array(self.weights_filling, w, self.weights_stddev)
            if self.weights_transposed:
                w = w.T.copy()
            self.weights.reset(w)
        if self.include_bias and not self.bias:
            b = numpy.zeros(self.neurons_number, dtype=self.input.dtype)
            self.fill_array(self.bias_filling, b, self.bias_stddev)
            self.bias.reset(b)
        if not self.output or self.output.shape[0] != self.input.shape[0]:
            self.output.reset(numpy.zeros(
                (self.input.shape[0],) + self.output_sample_shape,
                dtype=self.input.dtype))

    def run(self):
        y = dense.forward(
            self.input.dev, self.weights.dev,
            self.bias.dev if self.include_bias else None,
            activation=self.ACTIVATION,
            weights_transposed=self.weights_transposed,
            include_bias=self.include_bias)
        self.output.set_dev(y.reshape(self.output.shape))


class All2AllTanh(All2All):
    """``1.7159 tanh(0.6666 x)``."""
    MAPPING = {"all2all_tanh"}
    ACTIVATION = "tanh"
    C = 9.0


class All2AllRELU(All2All):
    """Softplus ``log(1 + e^x)``."""
    MAPPING = {"all2all_relu"}
    ACTIVATION = "relu"


class All2AllStrictRELU(All2All):
    """``max(x, 0)``."""
    MAPPING = {"all2all_str"}
    ACTIVATION = "strict_relu"


class All2AllSigmoid(All2All):
    """``1 / (1 + e^-x)``."""
    MAPPING = {"all2all_sigmoid"}
    ACTIVATION = "sigmoid"
    C = 1


class All2AllSoftmax(All2All):
    """Linear, then exp-normalized, with the winner index of each row in
    ``max_idx`` (int32)."""

    MAPPING = {"softmax"}
    ACTIVATION = "linear"

    def __init__(self, workflow, **kwargs):
        super(All2AllSoftmax, self).__init__(workflow, **kwargs)
        self.max_idx = Array(name="max_idx")

    def initialize(self, device=None, **kwargs):
        super(All2AllSoftmax, self).initialize(device=device, **kwargs)
        if self.neurons_number <= 1:
            raise ValueError(
                "Output sample size should be greater than 1 for SoftMax")
        if not self.max_idx or self.max_idx.shape[0] != self.output.shape[0]:
            self.max_idx.reset(numpy.zeros(self.output.shape[0],
                                           dtype=numpy.int32))
        self.max_idx.device = self.device

    def run(self):
        super(All2AllSoftmax, self).run()
        y = self.output.dev
        sm, idx = dense.softmax(y.reshape(y.shape[0], -1))
        self.output.set_dev(sm.reshape(y.shape))
        self.max_idx.set_dev(idx)
