"""The trainable sequence LSTM — the whole unroll as one unit.

Counterpart of ``znicz_tpu/units/lstm_scan.py``: ``LSTMScan`` (:122)
maps ``(batch, T, features)`` minibatches to the last step's hidden
state ``(batch, hidden)``, so a softmax or MSE head chains as after an
All2All, and ``GDLSTMScan`` (:225) backpropagates through the whole
unroll, then updates each gate's weights and bias with the shared
update algebra (:func:`znicz_tpu_torch.ops.gd_math.update`, with JAX's
``_hyper`` / ``_flags``: the ``variant_moment`` momentum, a velocity
slot a parameter).  Both register as ``lstm_scan``::

    {"type": "lstm_scan", "->": {"output_sample_shape": HIDDEN},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}

The gate parameters live in the All2All layout (``{gate: {"w": (H,
F + H), "b": (H,)}}``), drawn from the unit's stream in ``GATES``
order, weights then bias, with ``forget_bias`` added to the forget
gate's.  JAX's forward is ``lax.scan`` and its backward ``jax.vjp``
through it (:239-263, from ``h0 = c0 = 0``, with only the last step's
error); the port's forward is :func:`znicz_tpu_torch.ops.recurrent.
lstm_scan`, a loop over ``T``, and its backward autograd through that
loop.  Nothing is read back.  The master/slave methods are stubs, as in
JAX.
"""

import numpy
import torch

from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.distributable import IDistributable
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.ops import gd_math, recurrent
from znicz_tpu_torch.ops.recurrent import GATES
from znicz_tpu_torch.params import tree_map
from znicz_tpu_torch.units.nn_units import (
    Forward, FullyConnectedOutput, MatchingObject)


class LSTMScan(FullyConnectedOutput, Forward):
    """Forward: ``(B, T, F)`` -> the last hidden state ``(B, H)``."""

    MAPPING = {"lstm_scan"}

    def __init__(self, workflow, **kwargs):
        super(LSTMScan, self).__init__(workflow, **kwargs)
        self.gate_arrays = {}
        #: added to the forget gate's bias at init: the gate starts open
        #: (sigmoid(1) ~ 0.73), so gradients survive long distractor
        #: spans; 0 gives the unit-graph cell's init
        self.forget_bias = kwargs.get("forget_bias", 1.0)
        self.demand("input", "output_sample_shape")
        self.exports.append("gate_state")

    @property
    def hidden(self):
        return int(numpy.prod(self.output_sample_shape))

    def initialize(self, device=None, **kwargs):
        super(LSTMScan, self).initialize(device=device, **kwargs)
        if len(self.input.shape) != 3:
            raise ValueError(
                "lstm_scan wants (batch, T, features) minibatches, got %s"
                % (self.input.shape,))
        batch, _, feats = self.input.shape
        h = self.hidden
        stddev = self.weights_stddev if self.weights_stddev is not None \
            else 0.1
        bias_stddev = self.bias_stddev if self.bias_stddev is not None \
            else stddev
        if not self.gate_arrays:
            for name in GATES:
                w = numpy.zeros((h, feats + h), dtype=self.input.dtype)
                self.fill_array(self.weights_filling, w, stddev)
                b = numpy.zeros(h, dtype=self.input.dtype)
                self.fill_array(self.bias_filling, b, bias_stddev)
                if name == "forget_gate":
                    b += self.forget_bias
                self.gate_arrays[name] = {
                    "w": Array(w, name=name + "_w"),
                    "b": Array(b, name=name + "_b")}
            pending = getattr(self, "_pending_gate_state", None)
            if pending is not None:
                self._pending_gate_state = None
                self.gate_state = pending
        for p in self.gate_arrays.values():
            p["w"].device = p["b"].device = self.device
        if not self.output or self.output.shape[0] != batch:
            self.output.reset(numpy.zeros((batch, h),
                                          dtype=self.input.dtype))

    # -- snapshot state ------------------------------------------------------
    @property
    def gate_state(self):
        if not self.gate_arrays:
            return getattr(self, "_pending_gate_state", None)
        return {name: {"w": numpy.array(p["w"].mem),
                       "b": numpy.array(p["b"].mem)}
                for name, p in self.gate_arrays.items()}

    @gate_state.setter
    def gate_state(self, value):
        if value is None:
            return
        if not self.gate_arrays:
            self._pending_gate_state = value
            return
        for name, p in value.items():
            for key in ("w", "b"):
                arr = self.gate_arrays[name][key]
                arr.reset(numpy.array(p[key], dtype=arr.dtype))

    def params_dev(self):
        """The gate parameters as device tensors."""
        return {name: {"w": p["w"].dev, "b": p["b"].dev}
                for name, p in self.gate_arrays.items()}

    def run(self):
        xs = self.input.dev.transpose(0, 1)          # (T, B, F)
        h0 = torch.zeros((xs.shape[1], self.hidden), dtype=xs.dtype,
                         device=xs.device)
        with torch.no_grad():
            _, h, _ = recurrent.lstm_scan(self.params_dev(), xs, h0, h0)
        self.output.set_dev(h)

    # -- the weight broadcast ------------------------------------------------
    def generate_data_for_slave(self, slave=None):
        return self.gate_state

    def apply_data_from_master(self, data):
        if data is not None:
            self.gate_state = data


class GDLSTMScan(AcceleratedUnit, IDistributable, metaclass=MatchingObject):
    """Backward: autograd through the unroll, then the shared update of
    each gate's weights and bias."""

    MAPPING = {"lstm_scan"}
    _registry_role = "backward"

    def __init__(self, workflow, **kwargs):
        super(GDLSTMScan, self).__init__(workflow, **kwargs)
        self.gate_skip = Bool(False)
        self.learning_rate = kwargs.get("learning_rate", 0.01)
        self.learning_rate_bias = kwargs.get("learning_rate_bias",
                                             self.learning_rate)
        self.weights_decay = kwargs.get("weights_decay", 0.00005)
        self.weights_decay_bias = kwargs.get("weights_decay_bias", 0.0)
        self.l1_vs_l2 = kwargs.get("l1_vs_l2", 0.0)
        self.l1_vs_l2_bias = kwargs.get("l1_vs_l2_bias", self.l1_vs_l2)
        self.gradient_moment = kwargs.get("gradient_moment", 0.0)
        self.gradient_moment_bias = kwargs.get("gradient_moment_bias",
                                               self.gradient_moment)
        self.need_err_input = kwargs.get("need_err_input", True)
        self.err_input = Array(name="err_input")
        self.forward_unit = None
        self._opt_state = None
        self.demand("input", "err_output")
        self.exports = ["scan_opt_state"]

    def bind_forward(self, forward):
        """The scan pair shares the gate parameters: the standard
        workflow hands the forward over instead of linking a singular
        ``weights`` / ``bias``."""
        self.forward_unit = forward

    # -- snapshot state ------------------------------------------------------
    @property
    def scan_opt_state(self):
        if self._opt_state is None:
            return getattr(self, "_pending_opt_state", None)
        return tree_map(lambda t: t.detach().cpu().numpy(), self._opt_state)

    @scan_opt_state.setter
    def scan_opt_state(self, value):
        if value is None:
            return
        if self._opt_state is None:
            self._pending_opt_state = value
        else:
            self._opt_state = self._to_device(value)

    def _to_device(self, tree):
        return {name: {k: {s: torch.tensor(numpy.asarray(v),
                                           device=self.device)
                           for s, v in slots.items()}
                       for k, slots in p.items()}
                for name, p in tree.items()}

    def initialize(self, device=None, **kwargs):
        super(GDLSTMScan, self).initialize(device=device, **kwargs)
        if self.forward_unit is None:
            raise ValueError("GDLSTMScan needs bind_forward(lstm_scan)")
        if self.need_err_input and (
                not self.err_input or
                self.err_input.shape != self.input.shape):
            self.err_input.reset(numpy.zeros(self.input.shape,
                                             dtype=self.input.dtype))
        self.err_input.device = self.device
        if self._opt_state is None:
            flags = self._flags()
            self._opt_state = {
                name: {key: gd_math.init_state(t, flags)
                       for key, t in p.items()}
                for name, p in self.forward_unit.params_dev().items()}
            pending = getattr(self, "_pending_opt_state", None)
            if pending is not None:
                self._opt_state = self._to_device(pending)
                self._pending_opt_state = None

    def _hyper(self, bias=False):
        return dict(
            lr=float(self.learning_rate_bias if bias
                     else self.learning_rate),
            wd=float(self.weights_decay_bias if bias
                     else self.weights_decay),
            l1_vs_l2=float(self.l1_vs_l2_bias if bias else self.l1_vs_l2),
            moment=float(self.gradient_moment_bias if bias
                         else self.gradient_moment),
            acc_alpha=0.0, acc_beta=0.0, gd_alpha=0.0, gd_beta=1.0,
            factor_ortho=0.0)

    def _flags(self):
        return dict(accumulate=False, apply=True, solvers=frozenset(),
                    ortho=False, variant_moment=True, need_vel=True)

    def run(self):
        if self.gate_skip:
            return
        fwd = self.forward_unit
        params = {name: {k: t.detach().requires_grad_()
                         for k, t in p.items()}
                  for name, p in fwd.params_dev().items()}
        xs = self.input.dev.transpose(0, 1).detach()  # (T, B, F)
        if self.need_err_input:
            xs.requires_grad_()
        err_h = self.err_output.dev.reshape(self.err_output.shape[0], -1)
        h0 = torch.zeros((xs.shape[1], err_h.shape[1]), dtype=xs.dtype,
                         device=xs.device)
        leaves = [params[name][k] for name in GATES for k in ("w", "b")]
        with torch.enable_grad():
            _, h, _ = recurrent.lstm_scan(params, xs, h0, h0)
            grads = torch.autograd.grad(
                h, leaves + ([xs] if self.need_err_input else []),
                grad_outputs=err_h)
        flags = self._flags()
        hypers = {"w": self._hyper(False), "b": self._hyper(True)}
        for j, name in enumerate(GATES):
            for k, key in enumerate(("w", "b")):
                new_p, self._opt_state[name][key], _ = gd_math.update(
                    params[name][key].detach(), grads[2 * j + k],
                    self._opt_state[name][key], hypers[key], flags)
                fwd.gate_arrays[name][key].set_dev(new_p)
        if self.need_err_input:
            self.err_input.set_dev(grads[-1].transpose(0, 1).contiguous())

    # -- master-slave protocol stubs ----------------------------------------
    def generate_data_for_slave(self, slave=None):
        return None

    def apply_data_from_master(self, data):
        pass
