"""The LSTM cell as a composable sub-workflow.

Counterpart of ``znicz_tpu/units/lstm.py``: ``LSTM`` (:26) wires an
``InputJoiner`` (``[input, prev_output]``), three sigmoid gates and a
tanh memory maker (``All2AllSigmoid`` / ``All2AllTanh``), the
``Multiplier`` / ``Summator`` glue of ``c = i * g + f * prev_memory``
and the output ``o * tanh(c)`` (``ForwardTanh``); the state is
threaded from outside through ``prev_output`` / ``prev_memory``, one
cell a timestep, and ``link_weights`` shares another cell's gates.
``GDLSTM`` (:105) is the mirrored backward: ``GDMultiplier``,
``BackwardTanh``, ``GDSigmoid`` / ``GDTanh`` accumulating into one
joined error (``err_input_alpha = err_input_beta = 1``), sliced back
into ``err_input`` and ``err_prev_output`` by ``Cutter1D``.  Both
register as ``LSTM``.  Every unit runs on the cell's device.
"""

import weakref

from znicz_tpu_torch.core.accelerated_units import AcceleratedWorkflow
from znicz_tpu_torch.core.input_joiner import InputJoiner
from znicz_tpu_torch.units.activation import BackwardTanh, ForwardTanh
from znicz_tpu_torch.units.all2all import All2AllSigmoid, All2AllTanh
from znicz_tpu_torch.units.cutter import Cutter1D
from znicz_tpu_torch.units.gd import GDSigmoid, GDTanh
from znicz_tpu_torch.units.multiplier import GDMultiplier, Multiplier
from znicz_tpu_torch.units.nn_units import (FullyConnectedOutput,
                                            MatchingObject)
from znicz_tpu_torch.units.summator import Summator


class LSTM(FullyConnectedOutput, AcceleratedWorkflow,
           metaclass=MatchingObject):
    """One LSTM cell: ``output`` and ``memory`` from ``input``,
    ``prev_output`` and ``prev_memory``."""

    MAPPING = {"LSTM"}
    _registry_role = "forward"

    def __init__(self, workflow, **kwargs):
        super(LSTM, self).__init__(workflow, **kwargs)
        self.simple = kwargs.pop("simple", True)

        self.ij = InputJoiner(self)
        self.input_gate = All2AllSigmoid(self, name="input_gate", **kwargs)
        self.forget_gate = All2AllSigmoid(self, name="forget_gate",
                                          **kwargs)
        self.memory_maker = All2AllTanh(self, name="memory_maker", **kwargs)
        if not self.simple:
            self.ij_output = InputJoiner(self)
        self.output_gate = All2AllSigmoid(self, name="output_gate",
                                          **kwargs)
        self.output_activation = ForwardTanh(
            self, name="output_activation")
        self.input_mul = Multiplier(self, name="input_mul")
        self.forget_mul = Multiplier(self, name="forget_mul")
        self.summator = Summator(self, name="memory_cell")
        self.output_mul = Multiplier(self, name="output_mul")

        # control flow
        self.ij.link_from(self.start_point)
        self.input_gate.link_from(self.ij)
        self.forget_gate.link_from(self.ij)
        self.memory_maker.link_from(self.ij)
        self.input_mul.link_from(self.input_gate, self.memory_maker)
        self.forget_mul.link_from(self.forget_gate)
        self.summator.link_from(self.input_mul, self.forget_mul)
        if not self.simple:
            self.ij_output.link_from(self.summator, self.ij)
            self.output_gate.link_from(self.ij_output)
        else:
            self.output_gate.link_from(self.ij)
        self.output_activation.link_from(self.summator)
        self.output_mul.link_from(self.output_activation, self.output_gate)
        self.end_point.link_from(self.output_mul)

        # attributes
        self.ij.link_inputs(self, "input", "prev_output")
        self.input_gate.link_attrs(self.ij, ("input", "output"))
        self.forget_gate.link_attrs(self.ij, ("input", "output"))
        self.memory_maker.link_attrs(self.ij, ("input", "output"))
        self.input_mul.link_attrs(self.input_gate, ("x", "output"))
        self.input_mul.link_attrs(self.memory_maker, ("y", "output"))
        self.forget_mul.link_attrs(self.forget_gate, ("x", "output"))
        self.forget_mul.link_attrs(self, ("y", "prev_memory"))
        self.summator.link_attrs(self.input_mul, ("x", "output"))
        self.summator.link_attrs(self.forget_mul, ("y", "output"))
        self.output_activation.link_attrs(self.summator,
                                          ("input", "output"))
        if not self.simple:
            self.ij_output.link_inputs(self.ij, "output")
            self.ij_output.link_inputs(self.summator, "output")
            self.output_gate.link_attrs(self.ij_output,
                                        ("input", "output"))
        else:
            self.output_gate.link_attrs(self.ij, ("input", "output"))
        self.output_mul.link_attrs(self.output_gate, ("x", "output"))
        self.output_mul.link_attrs(self.output_activation, ("y", "output"))
        self.link_attrs(self.output_mul, "output")
        self.link_attrs(self.summator, ("memory", "output"))
        self.demand("input", "prev_output", "prev_memory")

    def link_weights(self, src):
        """Share the gate weights of another LSTM cell."""
        for attr in ("input_gate", "forget_gate", "memory_maker",
                     "output_gate"):
            getattr(self, attr).link_attrs(
                getattr(src, attr), "weights", "bias")


class GDLSTM(AcceleratedWorkflow, metaclass=MatchingObject):
    """The backward sub-workflow of an :class:`LSTM` cell."""

    MAPPING = {"LSTM"}
    _registry_role = "backward"

    def __init__(self, workflow, forward, **kwargs):
        if forward is None:
            raise ValueError("forward must be provided")
        super(GDLSTM, self).__init__(workflow, **kwargs)

        self.gd_output_mul = GDMultiplier(self, name="gd_output_mul")
        self.gd_output_activation = BackwardTanh(
            self, name="gd_output_activation")
        self.gd_output_gate = GDSigmoid(self, name="gd_output_gate",
                                        **kwargs)
        if not forward.simple:
            self.og_to_summator = Cutter1D(self, name="og_to_summator",
                                           alpha=1, beta=1)
            self.og_to_ij = Cutter1D(self, name="og_to_ij", alpha=1, beta=0)
        self.gd_forget_mul = GDMultiplier(self, name="gd_forget_mul")
        self.gd_input_mul = GDMultiplier(self, name="gd_input_mul")
        self.gd_memory_maker = GDTanh(
            self, name="gd_memory_maker",
            err_input_alpha=1, err_input_beta=1, **kwargs)
        self.gd_forget_gate = GDSigmoid(
            self, name="gd_forget_gate", err_input_alpha=1,
            err_input_beta=1, **kwargs)
        self.gd_input_gate = GDSigmoid(
            self, name="gd_input_gate", err_input_alpha=1,
            err_input_beta=1, **kwargs)
        self.ij_to_input = Cutter1D(self, name="ij_to_input",
                                    alpha=1, beta=0)
        self.ij_to_prev_output = Cutter1D(self, name="ij_to_prev_output",
                                          alpha=1, beta=0)

        prev = self.gd_output_mul.link_from(self.start_point)
        prev = self.gd_output_activation.link_from(prev)
        prev = self.gd_output_gate.link_from(prev)
        if not forward.simple:
            prev = self.og_to_summator.link_from(prev)
            prev = self.og_to_ij.link_from(prev)
        prev = self.gd_forget_mul.link_from(prev)
        prev = self.gd_input_mul.link_from(prev)
        prev = self.gd_forget_gate.link_from(prev)
        prev = self.gd_memory_maker.link_from(prev)
        prev = self.gd_input_gate.link_from(prev)
        prev = self.ij_to_input.link_from(prev)
        prev = self.ij_to_prev_output.link_from(prev)
        self.end_point.link_from(prev)

        self.gd_output_mul.link_attrs(self, "err_output")
        self.gd_output_mul.link_attrs(forward.output_mul, "x", "y")

        self.gd_output_gate.link_attrs(
            self.gd_output_mul, ("err_output", "err_x"))
        self.gd_output_gate.link_attrs(
            forward.output_gate, "weights", "bias", "input", "output")

        self.gd_output_activation.link_attrs(
            self.gd_output_mul, ("err_output", "err_y"))
        self.gd_output_activation.link_attrs(
            forward.output_activation, "input", "output")

        if not forward.simple:
            self.og_to_summator.link_attrs(
                self.gd_output_gate, ("input", "err_input"))
            self.og_to_summator.link_attrs(
                forward.ij_output, ("input_offset", "offset_1"),
                ("length", "length_1"))
            self.og_to_summator.link_attrs(
                self.gd_output_activation, ("output", "err_input"))
            self.og_to_ij.link_attrs(
                self.gd_output_gate, ("input", "err_input"))
            self.og_to_ij.link_attrs(
                forward.ij_output, ("input_offset", "offset_0"),
                ("length", "length_0"))
            first, first_attr = self.og_to_ij, "output"
        else:
            first, first_attr = self.gd_output_gate, "err_input"

        self.gd_forget_mul.link_attrs(
            self.gd_output_activation, ("err_output", "err_input"))
        self.gd_forget_mul.link_attrs(forward.forget_mul, "x", "y")
        self.link_attrs(self.gd_forget_mul, ("err_prev_memory", "err_y"))

        self.gd_forget_gate.link_attrs(
            self.gd_forget_mul, ("err_output", "err_x"))
        self.gd_forget_gate.link_attrs(
            forward.forget_gate, "weights", "bias", "input", "output")
        self.gd_forget_gate.link_attrs(first, ("err_input", first_attr))

        self.gd_input_mul.link_attrs(
            self.gd_output_activation, ("err_output", "err_input"))
        self.gd_input_mul.link_attrs(forward.input_mul, "x", "y")

        self.gd_input_gate.link_attrs(
            self.gd_input_mul, ("err_output", "err_x"))
        self.gd_input_gate.link_attrs(
            forward.input_gate, "weights", "bias", "input", "output")
        self.gd_input_gate.link_attrs(first, ("err_input", first_attr))

        self.gd_memory_maker.link_attrs(
            self.gd_input_mul, ("err_output", "err_y"))
        self.gd_memory_maker.link_attrs(
            forward.memory_maker, "weights", "bias", "input", "output")
        self.gd_memory_maker.link_attrs(first, ("err_input", first_attr))

        self.ij_to_input.link_attrs(first, ("input", first_attr))
        self.ij_to_input.link_attrs(
            forward.ij, ("input_offset", "offset_0"),
            ("length", "length_0"))
        self.link_attrs(self.ij_to_input, ("err_input", "output"))

        self.ij_to_prev_output.link_attrs(first, ("input", first_attr))
        self.ij_to_prev_output.link_attrs(
            forward.ij, ("input_offset", "offset_1"),
            ("length", "length_1"))
        self.link_attrs(self.ij_to_prev_output,
                        ("err_prev_output", "output"))

        self.demand("err_output", "err_memory")
        self.forward = weakref.proxy(forward)
