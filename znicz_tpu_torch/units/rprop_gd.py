"""RProp gradient descent — sign-based per-weight learning rates.

Counterpart of ``znicz_tpu/units/rprop_gd.py`` (``GDRProp`` :23-86),
type string "rprop_gd".  Each weight's rate grows by ``increase`` while
its gradient keeps its sign and shrinks by ``decrease`` on a flip,
clipped to [``min_learning_rate``, ``max_learning_rate``]; the update
is ``w -= sign(grad) * rate``.  The JAX package runs it on the host;
here it runs on the unit's device.  It keeps the JAX package's two
deliberate fixes to the reference: the rates start at
``initial_learning_rate`` (the reference starts them at zero, which the
first clip snaps to ``min_learning_rate``, freezing training), and the
decrease is applied (the reference drops the product).
"""

import numpy
import torch

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.ops import dense
from znicz_tpu_torch.units.gd import GradientDescent, err_output_update


class GDRProp(GradientDescent):
    """The RProp backward of an All2All."""

    MAPPING = {"rprop_gd"}

    def __init__(self, workflow, **kwargs):
        super(GDRProp, self).__init__(workflow, **kwargs)
        self.initial_learning_rate = kwargs.get("initial_learning_rate",
                                                0.01)
        self.min_learning_rate = kwargs.get("min_learning_rate", 1e-6)
        self.max_learning_rate = kwargs.get("max_learning_rate", 1.0)
        self.increase = kwargs.get("increase", 1.05)
        self.decrease = kwargs.get("decrease", 0.80)
        self.weight_lrs = Array(name="weight_lrs")
        self.bias_lrs = Array(name="bias_lrs")

    def initialize(self, device=None, **kwargs):
        super(GDRProp, self).initialize(device=device, **kwargs)
        if not self.weight_lrs:
            self.weight_lrs.reset(numpy.full(
                self.weights.shape, self.initial_learning_rate,
                self.weights.dtype))
        if self.include_bias and self.bias and not self.bias_lrs:
            self.bias_lrs.reset(numpy.full(
                self.bias.shape, self.initial_learning_rate,
                self.bias.dtype))
        self.weight_lrs.device = self.bias_lrs.device = self.device

    def _rprop_step(self, which, lrs, grad):
        """The rates and ``which`` ("weights" or "bias") after one step
        on ``grad``; the gradient is kept for the next step's sign."""
        vec = getattr(self, which)
        prev = getattr(self, "gradient_" + which)
        delta_sign = torch.sign(prev.dev * grad)
        rates = lrs.dev
        rates = torch.where(delta_sign > 0, rates * self.increase, rates)
        rates = torch.where(delta_sign < 0, rates * self.decrease, rates)
        rates = rates.clamp(self.min_learning_rate, self.max_learning_rate)
        lrs.set_dev(rates)
        vec.set_dev(vec.dev - torch.sign(grad) * rates)
        prev.set_dev(grad)

    def run(self):
        err_output_update(self)
        err_in, grad_w, grad_b = dense.backward(
            self.input.dev, self.err_output.dev, self.weights.dev,
            weights_transposed=self.weights_transposed,
            need_err_input=self.need_err_input,
            include_bias=self.include_bias and self.bias is not None)
        if self.need_err_input:
            self.set_err_input(err_in)
        self._rprop_step("weights", self.weight_lrs, grad_w)
        if self.include_bias and self.bias:
            self._rprop_step("bias", self.bias_lrs, grad_b)
