"""MeanDispNormalizer — per-minibatch ``(input - mean) * rdisp``.

Counterpart of ``znicz_tpu/units/mean_disp_normalizer.py``: the
normalization stage for a loader that serves raw data, from its
``mean`` and reciprocal-dispersion ``rdisp`` Arrays (one value a
sample element).  The JAX unit's ``jax_run`` (:49) is torch ops on the
unit's device: the input cast to float32 (as JAX casts it), minus the
mean, times ``rdisp``, in the promoted dtype, which is also the dtype
the output is allocated in at initialize (JAX allocates float32).
"""

import numpy
import torch

from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.memory import Array


class MeanDispNormalizer(AcceleratedUnit):
    """demand: input (B, *sample), mean (*sample), rdisp (*sample)."""

    def __init__(self, workflow, **kwargs):
        super(MeanDispNormalizer, self).__init__(workflow, **kwargs)
        self.output = Array(name="output")
        self.demand("input", "mean", "rdisp")

    def initialize(self, device=None, **kwargs):
        super(MeanDispNormalizer, self).initialize(device=device,
                                                   **kwargs)
        if tuple(self.mean.shape) != tuple(self.input.shape[1:]):
            raise ValueError(
                "mean shape %s != sample shape %s"
                % (self.mean.shape, self.input.shape[1:]))
        if tuple(self.rdisp.shape) != tuple(self.mean.shape):
            raise ValueError("rdisp shape %s != mean shape %s"
                             % (self.rdisp.shape, self.mean.shape))
        for arr in (self.input, self.mean, self.rdisp):
            if arr.device is None:
                arr.device = self.device
        if (not self.output or
                self.output.shape != tuple(self.input.shape)):
            # the dtype the run produces (JAX allocates float32 and its
            # forwards then mix float32 weights with float64 statistics)
            self.output.reset(numpy.zeros(self.input.shape, numpy.result_type(
                numpy.float32, self.mean.dtype, self.rdisp.dtype)))
        self.output.device = self.device

    def run(self):
        x = self.input.dev.to(torch.float32)
        self.output.set_dev((x - self.mean.dev) * self.rdisp.dev)
