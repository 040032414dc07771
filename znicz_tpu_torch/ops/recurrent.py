"""The LSTM cell and its unroll over a sequence, on tensors.

Counterpart of ``znicz_tpu/ops/recurrent.py`` (``GATES`` :32,
``lstm_cell_jax`` :35, ``lstm_scan_jax`` :54, ``params_from_cell``
:68).  The math is the unit-graph cell's (``units/lstm.py``):

* the joined input ``z = [x, h_prev]`` (``InputJoiner`` order);
* the framework's activations — the SCALED tanh ``1.7159 tanh(2x/3)``
  for the memory maker and the output squash, the plain sigmoid for the
  three gates, each differentiated through its output as the JAX
  package's are;
* ``c = i * g + f * c_prev``, ``y = o * tanh(c)`` (the simple
  topology: the output gate reads ``z``, not the memory cell).

Gate parameters are ``{gate: {"w": (hidden, in + hidden), "b":
(hidden,)}}`` in the All2All layout (``y = z @ W.T + b``).  JAX unrolls
under ``lax.scan``; here :func:`lstm_scan` is a loop over the ``T``
steps, differentiable by autograd.  It packs the four gates into one
product a step, the sigmoid gates first, and projects every step's
input part in one product before the loop; only ``h_prev @ W_h.T`` is
left inside it.
"""

import torch

from znicz_tpu_torch.ops import activations
from znicz_tpu_torch.params import lstm_params_to_numpy

#: gate order in the packed parameter dict
GATES = ("input_gate", "forget_gate", "memory_maker", "output_gate")
#: the order of the gates' rows in the packed product: the three
#: sigmoid gates, then the memory maker
_PACKED = ("input_gate", "forget_gate", "output_gate", "memory_maker")


def lstm_cell(params, x, h, c):
    """One cell step: ``(y, c_new)``."""
    z = torch.cat([x, h], dim=1)

    def gate(name, act):
        p = params[name]
        return activations.apply(act, z @ p["w"].T + p["b"])

    i = gate("input_gate", "sigmoid")
    f = gate("forget_gate", "sigmoid")
    g = gate("memory_maker", "tanh")
    o = gate("output_gate", "sigmoid")
    c_new = i * g + f * c
    y = o * activations.apply("tanh", c_new)
    return y, c_new


def lstm_scan(params, xs, h0, c0):
    """Unroll the cell over ``xs`` ``(T, B, in)``: ``(ys, h_T, c_T)``
    with ``ys`` stacked ``(T, B, hidden)``."""
    t_len, batch, n_in = xs.shape
    hidden = h0.shape[1]
    w = torch.cat([params[name]["w"] for name in _PACKED])
    b = torch.cat([params[name]["b"] for name in _PACKED])
    proj = (xs.reshape(t_len * batch, n_in) @ w[:, :n_in].T + b).reshape(
        t_len, batch, 4 * hidden)
    w_h = w[:, n_in:].T
    h, c = h0, c0
    ys = []
    for t in range(t_len):
        pre = proj[t] + h @ w_h
        sig = activations.apply("sigmoid", pre[:, :3 * hidden])
        i, f, o = sig[:, :hidden], sig[:, hidden:2 * hidden], \
            sig[:, 2 * hidden:]
        g = activations.apply("tanh", pre[:, 3 * hidden:])
        c = i * g + f * c
        h = o * activations.apply("tanh", c)
        ys.append(h)
    return torch.stack(ys), h, c


def params_from_cell(cell):
    """The packed parameter dict of a built unit-graph
    :class:`znicz_tpu_torch.units.lstm.LSTM` cell, as host numpy."""
    return lstm_params_to_numpy(cell)
