"""The evaluators on tensors: the softmax-CE gradient and the
classification stats of a minibatch, and the MSE gradient and metrics.

Counterpart of ``znicz_tpu/ops/evaluator.py::softmax_ce_jax`` (:25)
and of the single-device branch of the fused window's in-scan stats
(``znicz_tpu/parallel/fused.py::_eval_stats`` :845-903); reference
evaluator.py:271-312:

* rows at or past ``batch_size`` and rows labelled -1 are masked out;
* ``err_output = (softmax - onehot(label)) / batch_size`` (without
  the division under ``mean=False``), zero on masked rows;
* ``n_err = [misclassified, evaluated]`` int32;
* ``confusion[pred, label]`` int32, as a one-hot product in float32
  (exact for counts under 2^24);
* ``max_err_sum``: the largest ``sum |err_output|`` of a valid row.

:func:`mse` is the counterpart of ``mse_jax`` (:79; reference
evaluator.py:334-556).

``batch_size`` is a host int: nothing here reads the device back.
"""

import torch


def _one_hot(idx, n, dtype):
    """``(B, n)`` one-hot rows of ``idx``; an index at or past ``n``
    gives a zero row, as ``jax.nn.one_hot``'s does (a label the head
    has no column for: the softmax head's width is the count of
    distinct labels, which a label past it can exceed)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


def softmax_ce(output, max_idx, labels, batch_size, n_classes, mean=True):
    """``(err_output, n_err[2], confusion[C, C], max_err_sum)`` of one
    minibatch: softmax rows ``output (B, C)``, their int argmax and int
    labels ``(B,)``."""
    valid = (torch.arange(labels.shape[0], device=labels.device) <
             batch_size) & (labels >= 0)
    lbl = labels.clamp(min=0).long()
    onehot = _one_hot(lbl, output.shape[1], output.dtype)
    mult = 1.0 / max(batch_size, 1) if mean else 1.0
    err = torch.where(valid[:, None], (output - onehot) * mult, 0)
    n_total = valid.sum()
    n_ok = (valid & (max_idx == labels)).sum()
    n_err = torch.stack([n_total - n_ok, n_total]).to(torch.int32)
    # a one-hot product in float32, exact for counts under 2^24
    pred = _one_hot(max_idx.long(), n_classes, torch.float32) * \
        valid[:, None].to(torch.float32)
    conf = (pred.T @ _one_hot(lbl, n_classes, torch.float32)).to(
        torch.int32)
    mx = torch.where(valid, err.abs().sum(dim=1), 0).max()
    return err, n_err, conf, mx


def eval_stats(probs, max_idx, labels, batch_size, n_classes, mean=True):
    """``(n_err[2], confusion[C, C], max_err_sum)`` of one minibatch,
    as the fused window folds them (those of :func:`softmax_ce`)."""
    return softmax_ce(probs, max_idx, labels, batch_size, n_classes,
                      mean)[1:]


def mse(output, target, batch_size, root=False, mean=True):
    """``(err_output, metrics[3], mse_per)`` of one minibatch:

    * ``err_output = (output - target) / batch_size`` (without the
      division under ``mean=False``), zero on rows at or past
      ``batch_size``;
    * ``mse_per`` the per-sample mean of the squared difference (its
      square root with ``root``), 0 on masked rows;
    * ``metrics = [sum, max, min]`` of ``mse_per`` over the batch, the
      min over the rows in the batch only."""
    b = output.shape[0]
    o2 = output.reshape(b, -1)
    t2 = target.reshape(b, -1).to(o2.dtype)
    in_batch = torch.arange(b, device=o2.device) < batch_size
    diff = torch.where(in_batch[:, None], o2 - t2, 0)
    err = diff * (1.0 / max(batch_size, 1) if mean else 1.0)
    mse_per = (diff * diff).sum(dim=1) / o2.shape[1]
    if root:
        mse_per = torch.sqrt(mse_per)
    mn = torch.where(in_batch, mse_per, float("inf")).min()
    metrics = torch.stack([mse_per.sum(), mse_per.max(), mn])
    return err.reshape(output.shape), metrics, mse_per


def nearest_target_errors(output, class_targets, labels, batch_size):
    """``n_err[2] = [wrong, evaluated]`` int32 of the nearest-class-
    target rule: a row counts as right when the class target at the
    least squared distance from it (the first on ties) is its label's
    (reference ``mse_find_closest``)."""
    b = output.shape[0]
    o2 = output.reshape(b, -1)
    ct = class_targets.reshape(class_targets.shape[0], -1).to(o2.dtype)
    pred = ((ct[None, :, :] - o2[:, None, :]) ** 2).sum(dim=2).argmin(dim=1)
    in_batch = torch.arange(b, device=o2.device) < batch_size
    n_ok = (in_batch & (pred == labels.long())).sum()
    return torch.stack([batch_size - n_ok, n_ok.new_tensor(batch_size)]).to(
        torch.int32)
