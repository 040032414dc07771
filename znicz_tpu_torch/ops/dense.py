"""Fully-connected forward and softmax on tensors.

Counterpart of ``znicz_tpu/ops/dense.py`` (``forward_jax`` :27,
``softmax_jax`` :37).  ``weights`` is ``(neurons, input_size)`` unless
``weights_transposed``; the forward is ``y = x @ W^T + b``.  The
product is ``torch.matmul`` — the JAX package leaves it to XLA.
"""

import torch

from znicz_tpu_torch.ops import activations


def forward(x, weights, bias, activation="linear",
            weights_transposed=False, include_bias=True):
    x2 = x.reshape(x.shape[0], -1)
    y = x2 @ weights if weights_transposed else x2 @ weights.T
    if include_bias:
        y = y + bias
    return activations.apply(activation, y)


def softmax(y):
    """Exp-normalize with winner index: ``(softmax(y), argmax(y))``
    (argmax as int32)."""
    max_idx = torch.argmax(y, dim=1).to(torch.int32)
    e = torch.exp(y - torch.amax(y, dim=1, keepdim=True))
    return e / torch.sum(e, dim=1, keepdim=True), max_idx
