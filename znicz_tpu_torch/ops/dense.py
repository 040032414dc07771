"""Fully-connected forward, softmax and backward on tensors.

Counterpart of ``znicz_tpu/ops/dense.py`` (``forward_jax`` :27,
``softmax_jax`` :37, ``backward_jax`` :66).  ``weights`` is
``(neurons, input_size)`` unless ``weights_transposed``; the forward
is ``y = x @ W^T + b``.  The products are ``torch.matmul`` — the JAX
package leaves them to XLA.  :func:`forward_numpy` and
:func:`softmax_numpy` are the numpy twins (JAX :46, :55) that
``export.run_package_numpy`` runs.
"""

import numpy
import torch

from znicz_tpu_torch.ops import activations


def forward(x, weights, bias, activation="linear",
            weights_transposed=False, include_bias=True):
    x2 = x.reshape(x.shape[0], -1)
    y = x2 @ weights if weights_transposed else x2 @ weights.T
    if include_bias:
        y = y + bias
    return activations.apply(activation, y)


def forward_numpy(x, weights, bias, activation="linear",
                  weights_transposed=False, include_bias=True):
    """:func:`forward` on numpy arrays."""
    x2 = x.reshape(x.shape[0], -1)
    y = x2 @ weights if weights_transposed else x2 @ weights.T
    if include_bias:
        y = y + bias
    return activations.apply_numpy(activation, y)


def softmax_numpy(y):
    """:func:`softmax` on a numpy array."""
    max_idx = numpy.argmax(y, axis=1).astype(numpy.int32)
    e = numpy.exp(y - numpy.max(y, axis=1, keepdims=True))
    return e / numpy.sum(e, axis=1, keepdims=True), max_idx


def softmax(y):
    """Exp-normalize with winner index: ``(softmax(y), argmax(y))``
    (argmax as int32)."""
    max_idx = torch.argmax(y, dim=1).to(torch.int32)
    e = torch.exp(y - torch.amax(y, dim=1, keepdim=True))
    return e / torch.sum(e, dim=1, keepdim=True), max_idx


def backward(inp, err_output, weights, weights_transposed=False,
             need_err_input=True, include_bias=True):
    """``(err_input, grad_weights, grad_bias)``: ``grad_w = e^T x``
    (``x^T e`` for transposed weights), ``grad_b = sum_rows(e)`` and
    ``err_input = e W`` (``e W^T``) in ``inp``'s shape; the first is
    None unless ``need_err_input``, the last unless ``include_bias``."""
    x2 = inp.reshape(inp.shape[0], -1)
    e2 = err_output.reshape(err_output.shape[0], -1)
    if weights_transposed:
        grad_w = x2.T @ e2
        err_in = e2 @ weights.T if need_err_input else None
    else:
        grad_w = e2.T @ x2
        err_in = e2 @ weights if need_err_input else None
    grad_b = e2.sum(dim=0) if include_bias else None
    if err_in is not None:
        err_in = err_in.reshape(inp.shape)
    return err_in, grad_w, grad_b
