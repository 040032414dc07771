"""Activation functions on tensors, with the JAX package's gradients.

Counterpart of ``znicz_tpu/ops/activations.py`` (``apply_jax`` :71,
``ext_apply_jax`` :127, ``ext_derivative_jax`` :135, ``derivative_jax``
:143), with the reference's constants:

* tanh is the SCALED tanh ``1.7159 * tanh(0.6666 x)``;
* "relu" is Znicz's softplus ``log(1 + e^x)``, the identity above
  x > 15 (the seam of the reference kernel);
* "strict_relu" is ``max(x, 0)``;
* sigmoid is ``1 / (1 + e^-x)``;
* the standalone-unit family: log ``log(x + sqrt(x^2 + 1))``, the
  tanhlog hybrid and sincos (cos on even flat indices, sin on odd).

:func:`apply_numpy` and :func:`ext_apply_numpy` are the numpy twins
(JAX :131, :160) that ``export.run_package_numpy`` runs in float64.

Gradients.  The JAX package differentiates tanh, softplus "relu",
sigmoid and strict relu through their OUTPUT y with the reference's
rounded constants (``_with_output_vjp`` :44-69): tanh'
``1.14381894 - 0.388484177 y^2``, softplus' ``1 - e^-y``, strict
relu' ``[y > 0]`` (0 at the tie, where autograd of ``max`` would give
0.5), sigmoid' ``y (1 - y)``.  :func:`apply` does the same through a
``torch.autograd.Function`` when its input needs a gradient; plain
autograd of ``torch.tanh`` differs from the rounded constants by about
1e-9 per layer.
"""

import numpy
import torch

TANH_A = 1.7159
TANH_B = 0.6666
TANH_DA = 1.14381894     # A * B
TANH_DB = -0.388484177   # -(B / A)

# TanhLog hybrid constants (reference activation.py:525-532)
TANHLOG_D = 3
TANHLOG_A = 0.242528761112
TANHLOG_B = 305.459953195


def _forward(name, x):
    if name == "tanh":
        return TANH_A * torch.tanh(TANH_B * x)
    if name == "relu":
        return torch.where(x > 15, x,
                           torch.log1p(torch.exp(torch.clamp(x, max=15.0))))
    if name == "strict_relu":
        return torch.clamp(x, min=0)
    if name == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-x))
    raise ValueError("unknown activation %r" % name)


def derivative(name, y):
    """f'(x) expressed through the output y = f(x)."""
    if name == "linear":
        return torch.ones_like(y)
    if name == "tanh":
        return y * y * TANH_DB + TANH_DA
    if name == "relu":
        return 1.0 - torch.exp(-y)
    if name == "strict_relu":
        return (y > 0).to(y.dtype)
    if name == "sigmoid":
        return y * (1.0 - y)
    raise ValueError("unknown activation %r" % name)


class _OutputGrad(torch.autograd.Function):
    """f(x) whose backward is ``ct * derivative(name, y)``."""

    @staticmethod
    def forward(ctx, x, name):
        y = _forward(name, x)
        ctx.save_for_backward(y)
        ctx.name = name
        return y

    @staticmethod
    def backward(ctx, ct):
        y, = ctx.saved_tensors
        return ct * derivative(ctx.name, y), None


def apply(name, x):
    """A fused-layer activation epilogue by name."""
    if name == "linear":
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _OutputGrad.apply(x, name)
    return _forward(name, x)


def ext_apply(name, x):
    """The standalone-unit activations (log, tanhlog, sincos)."""
    if name == "log":
        return torch.log(x + torch.sqrt(torch.square(x) + 1))
    if name == "tanhlog":
        logv = torch.log(torch.abs(x) * TANHLOG_B + 1e-30) * TANHLOG_A
        return torch.where(
            x > TANHLOG_D, logv,
            torch.where(x < -TANHLOG_D, -logv,
                        TANH_A * torch.tanh(TANH_B * x)))
    if name == "sincos":
        flat = x.reshape(-1)
        odd = torch.arange(flat.shape[0], device=x.device) % 2 == 1
        return torch.where(odd, torch.sin(flat),
                           torch.cos(flat)).reshape(x.shape)
    raise ValueError("unknown activation %r" % name)


def ext_derivative(name, x, y):
    """d/dx of the standalone-unit activations from the input ``x`` (and
    the output ``y`` for tanhlog)."""
    if name == "log":
        return 1.0 / torch.sqrt(torch.square(x) + 1)
    if name == "tanhlog":
        return torch.where(
            x > TANHLOG_D, TANHLOG_A / x,
            torch.where(x < -TANHLOG_D, -TANHLOG_A / x,
                        torch.square(y) * TANH_DB + TANH_DA))
    if name == "sincos":
        flat = x.reshape(-1)
        odd = torch.arange(flat.shape[0], device=x.device) % 2 == 1
        return torch.where(odd, torch.cos(flat),
                           -torch.sin(flat)).reshape(x.shape)
    raise ValueError("unknown activation %r" % name)


# -- the numpy twins (the package runner's executable spec) -------------------

def apply_numpy(name, x):
    """:func:`apply` on a numpy array."""
    if name == "linear":
        return x
    if name == "tanh":
        return TANH_A * numpy.tanh(TANH_B * x)
    if name == "relu":
        return numpy.where(x > 15, x,
                           numpy.log1p(numpy.exp(numpy.minimum(x, 15.0))))
    if name == "strict_relu":
        return numpy.maximum(x, 0)
    if name == "sigmoid":
        return 1.0 / (1.0 + numpy.exp(-x))
    raise ValueError("unknown activation %r" % name)


def ext_apply_numpy(name, x):
    """:func:`ext_apply` on a numpy array: log, tanhlog or sincos."""
    if name == "log":
        return numpy.log(x + numpy.sqrt(numpy.square(x) + 1))
    if name == "tanhlog":
        big = numpy.log(numpy.abs(x) * TANHLOG_B + 1e-30) * TANHLOG_A
        return numpy.where(x > TANHLOG_D, big,
                           numpy.where(x < -TANHLOG_D, -big,
                                       TANH_A * numpy.tanh(TANH_B * x)))
    if name == "sincos":
        flat = x.reshape(-1)
        odd = numpy.arange(flat.shape[0]) % 2 == 1
        return numpy.where(odd, numpy.sin(flat),
                           numpy.cos(flat)).reshape(x.shape)
    raise ValueError("unknown activation %r" % name)
