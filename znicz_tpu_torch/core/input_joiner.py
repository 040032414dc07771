"""InputJoiner — several input Arrays concatenated along the feature
axis.

Counterpart of ``znicz_tpu/core/input_joiner.py`` (the LSTM cell's
``[x, h_prev]``).  ``initialize`` records each input's slice of the
joined row as ``offset_N`` / ``length_N``, which the LSTM backward's
``Cutter1D`` glue reads; ``run`` concatenates on the unit's device.
"""

import numpy
import torch

from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.memory import Array


class InputJoiner(AcceleratedUnit):
    def __init__(self, workflow, **kwargs):
        super(InputJoiner, self).__init__(workflow, **kwargs)
        self.inputs = kwargs.get("inputs", [])
        self.output = Array(name="joined")
        self.demand("inputs")

    def link_inputs(self, other, *attrs):
        """Add attributes of ``other`` as inputs (live references)."""
        for attr in attrs:
            self.inputs.append((other, attr))
        return self

    def _resolved_inputs(self):
        out = []
        for item in self.inputs:
            if isinstance(item, tuple):
                unit, attr = item
                out.append(getattr(unit, attr))
            else:
                out.append(item)
        return out

    def initialize(self, device=None, **kwargs):
        super(InputJoiner, self).initialize(device=device, **kwargs)
        ins = self._resolved_inputs()
        if not ins:
            raise ValueError(
                "%s: no inputs configured (pass inputs= or call "
                "link_inputs())" % self.name)
        batch = ins[0].shape[0]
        width = sum(a.sample_size for a in ins)
        self.output.reset(numpy.zeros((batch, width), dtype=ins[0].dtype))
        self.output.device = self.device
        off = 0
        for i, a in enumerate(ins):
            setattr(self, "offset_%d" % i, off)
            setattr(self, "length_%d" % i, a.sample_size)
            off += a.sample_size

    def run(self):
        ins = self._resolved_inputs()
        self.output.set_dev(torch.cat(
            [a.dev.reshape(a.shape[0], -1) for a in ins], dim=1))
