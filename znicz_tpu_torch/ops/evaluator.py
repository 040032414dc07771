"""The softmax evaluator's per-minibatch stats on tensors.

Counterpart of the single-device branch of the fused window's in-scan
stats (``znicz_tpu/parallel/fused.py::_eval_stats`` :845-903, with
``mean`` on, as the fused trainer runs it), reference
evaluator.py:271-312:

* rows at or past ``batch_size`` and rows labelled -1 are masked out;
* ``err_output = (softmax - onehot(label)) / batch_size``;
* ``n_err = [misclassified, evaluated]`` int32;
* ``confusion[pred, label]`` int32, as a one-hot product in float32
  (exact for counts under 2^24), as the JAX package computes it;
* ``max_err_sum``: the largest ``sum |err_output|`` of a valid row.

``batch_size`` is a host int: nothing here reads the device back.
"""

import torch
import torch.nn.functional as F


def eval_stats(probs, max_idx, labels, batch_size, n_classes):
    """``(n_err[2], confusion[C, C], max_err_sum)`` of one minibatch:
    softmax rows ``probs (B, C)``, their int32 argmax and int labels
    ``(B,)``."""
    valid = (torch.arange(labels.shape[0], device=labels.device) <
             batch_size) & (labels >= 0)
    onehot = F.one_hot(labels.clamp(min=0).long(), n_classes)
    pred = F.one_hot(max_idx.long(), n_classes).to(torch.float32) * \
        valid[:, None].to(torch.float32)
    conf = (pred.T @ onehot.to(torch.float32)).to(torch.int32)
    err = (probs - onehot.to(probs.dtype)) * (1.0 / max(batch_size, 1))
    mx = torch.where(valid, err.abs().sum(dim=1), 0).max()
    n_total = valid.sum()
    n_ok = (valid & (max_idx == labels)).sum()
    return torch.stack([n_total - n_ok, n_total]).to(torch.int32), conf, mx
