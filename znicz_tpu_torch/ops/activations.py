"""Activation functions (forward) on tensors.

Counterpart of ``znicz_tpu/ops/activations.py`` (``apply_jax`` :71,
``ext_apply_jax`` :127), with the reference's constants:

* tanh is the SCALED tanh ``1.7159 * tanh(0.6666 x)``;
* "relu" is Znicz's softplus ``log(1 + e^x)``, the identity above
  x > 15 (the seam of the reference kernel);
* "strict_relu" is ``max(x, 0)``;
* sigmoid is ``1 / (1 + e^-x)``;
* the standalone-unit family: log ``log(x + sqrt(x^2 + 1))``, the
  tanhlog hybrid and sincos (cos on even flat indices, sin on odd).
"""

import torch

TANH_A = 1.7159
TANH_B = 0.6666

# TanhLog hybrid constants (reference activation.py:525-532)
TANHLOG_D = 3
TANHLOG_A = 0.242528761112
TANHLOG_B = 305.459953195


def apply(name, x):
    """A fused-layer activation epilogue by name."""
    if name == "linear":
        return x
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
