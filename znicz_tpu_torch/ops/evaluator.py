"""The softmax evaluator on tensors: the softmax-CE gradient and the
classification stats of a minibatch.

Counterpart of ``znicz_tpu/ops/evaluator.py::softmax_ce_jax`` (:25)
and of the single-device branch of the fused window's in-scan stats
(``znicz_tpu/parallel/fused.py::_eval_stats`` :845-903), both with
``mean`` on, as every caller runs them; reference evaluator.py:271-312:

* rows at or past ``batch_size`` and rows labelled -1 are masked out;
* ``err_output = (softmax - onehot(label)) / batch_size``, zero on
  masked rows;
* ``n_err = [misclassified, evaluated]`` int32;
* ``confusion[pred, label]`` int32, as a one-hot product in float32
  (exact for counts under 2^24);
* ``max_err_sum``: the largest ``sum |err_output|`` of a valid row.

``batch_size`` is a host int: nothing here reads the device back.
"""

import torch
import torch.nn.functional as F


def softmax_ce(output, max_idx, labels, batch_size, n_classes):
    """``(err_output, n_err[2], confusion[C, C], max_err_sum)`` of one
    minibatch: softmax rows ``output (B, C)``, their int argmax and int
    labels ``(B,)``."""
    valid = (torch.arange(labels.shape[0], device=labels.device) <
             batch_size) & (labels >= 0)
    lbl = labels.clamp(min=0).long()
    onehot = F.one_hot(lbl, output.shape[1]).to(output.dtype)
    err = torch.where(valid[:, None],
                      (output - onehot) * (1.0 / max(batch_size, 1)), 0)
    n_total = valid.sum()
    n_ok = (valid & (max_idx == labels)).sum()
    n_err = torch.stack([n_total - n_ok, n_total]).to(torch.int32)
    # a one-hot product in float32, exact for counts under 2^24
    pred = F.one_hot(max_idx.long(), n_classes).to(torch.float32) * \
        valid[:, None].to(torch.float32)
    conf = (pred.T @ F.one_hot(lbl, n_classes).to(torch.float32)).to(
        torch.int32)
    mx = torch.where(valid, err.abs().sum(dim=1), 0).max()
    return err, n_err, conf, mx


def eval_stats(probs, max_idx, labels, batch_size, n_classes):
    """``(n_err[2], confusion[C, C], max_err_sum)`` of one minibatch,
    as the fused window folds them (those of :func:`softmax_ce`)."""
    return softmax_ce(probs, max_idx, labels, batch_size, n_classes)[1:]
