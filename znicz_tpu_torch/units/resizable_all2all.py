"""Resizable fully-connected layer.

Counterpart of ``znicz_tpu/units/resizable_all2all.py`` (:13-66), type
string "all2all_resizable": setting ``output_sample_shape`` after
initialize grows the weight matrix (the new rows, and bias entries,
drawn from the unit's host stream with its fillings) or shrinks it,
keeping the rows that stay; the output is reallocated.
"""

import numpy

from znicz_tpu_torch.units.all2all import All2All


class ResizableAll2All(All2All):
    """An All2All whose neuron count changes after initialize."""

    MAPPING = {"all2all_resizable"}

    @All2All.output_sample_shape.setter
    def output_sample_shape(self, value):
        old = self.neurons_number if self.initialized else 0
        All2All.output_sample_shape.fset(self, value)
        if not self.initialized:
            return
        if self.neurons_number <= 0:
            raise ValueError(
                "Neurons number must be greater than 0 (got %d)"
                % self.neurons_number)
        self._adjust_neurons_number(self.neurons_number - old)

    def _adjust_neurons_number(self, delta):
        if delta == 0:
            return
        w = self.weights.mem
        # the neurons run along axis 0, or axis 1 when transposed
        axis = 1 if self.weights_transposed else 0
        old_nn = w.shape[axis]
        shape = list(w.shape)
        shape[axis] = old_nn + delta
        new_w = numpy.zeros(shape, w.dtype)
        keep = [slice(None), slice(None)]
        keep[axis] = slice(0, min(old_nn, old_nn + delta))
        new_w[tuple(keep)] = w[tuple(keep)]
        if delta > 0:
            grown = [slice(None), slice(None)]
            grown[axis] = slice(old_nn, None)
            self.fill_array(self.weights_filling, new_w[tuple(grown)],
                            self.weights_stddev)
        self.weights.reset(new_w)
        if self.include_bias and self.bias:
            old_b = self.bias.mem
            new_b = numpy.zeros(old_b.shape[0] + delta, self.bias.dtype)
            n = min(old_b.shape[0], new_b.shape[0])
            new_b[:n] = old_b[:n]
            if delta > 0:
                self.fill_array(self.bias_filling, new_b[n:],
                                self.bias_stddev)
            self.bias.reset(new_b)
        self.output.reset(numpy.zeros(
            (self.input.shape[0],) + self.output_sample_shape,
            dtype=self.input.dtype))
