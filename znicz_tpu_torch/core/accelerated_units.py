"""Accelerated units — compute nodes on the workflow's device.

Counterpart of ``znicz_tpu/core/accelerated_units.py``
(``AcceleratedUnit``, ``AcceleratedWorkflow`` :29-100).  The JAX
package forks ``run`` into ``numpy_run`` / ``jax_run``; here there is
one run path on tensors and the CPU is just a device.  The device is
``default_device(device)``: the card unless the caller asks for the
CPU, and an error without CUDA.
"""

from znicz_tpu_torch.core.backends import default_device
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.core.workflow import Workflow


class AcceleratedUnit(Unit):
    """A unit whose ``run`` computes on ``self.device``."""

    def __init__(self, workflow, **kwargs):
        super(AcceleratedUnit, self).__init__(workflow, **kwargs)
        self.device = None

    def initialize(self, device=None, **kwargs):
        super(AcceleratedUnit, self).initialize(device=device, **kwargs)
        self.device = default_device(device)


class AcceleratedWorkflow(Workflow):
    """Workflow carrying the device of its accelerated units."""

    def initialize(self, device=None, **kwargs):
        return super(AcceleratedWorkflow, self).initialize(
            device=default_device(device), **kwargs)
