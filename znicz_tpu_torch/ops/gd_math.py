"""The gradient-descent update algebra on tensors.

Counterpart of ``znicz_tpu/ops/gd_math.py`` (``update`` :45-100,
``init_state`` :143), the per-layer optimizer the whole framework
shares (reference nn_units.py:696-719, gd.py:314-419):

1. ``step = grad + wd * ((1 - l1_vs_l2) * w + 0.5 * l1_vs_l2 * sign(w))
   [+ ortho]``; ``gradient = -lr * step``.  Ortho (weights only): each
   row i gains ``(col_sums - w[i]) * factor_ortho / n_rows``;
2. accumulate: ``acc = acc_alpha * gradient + acc_beta * acc``,
   ``gradient = gd_beta * gradient + gd_alpha * acc``;
3. moment: ``vel = gradient + moment * vel`` (or the
   ``(1 - moment)``-weighted variant); the applied gradient is ``vel``;
4. the adagrad, adadelta and fast solvers transform it;
5. ``w += gradient`` when ``apply``.

The JAX package leaves this elementwise work to XLA; here it is plain
torch ops under ``torch.no_grad()`` on the parameters' device, in the
JAX package's operation order, returning new tensors (the inputs are
not written).  :func:`register_update_cost` counts an update's work for
the profiler's cost registry (JAX :121-136).
"""

import torch


def _gradient_step(w, grad, lr, wd, l1_vs_l2, factor_ortho, use_ortho):
    step = grad + wd * ((1.0 - l1_vs_l2) * w +
                        0.5 * l1_vs_l2 * torch.sign(w))
    if use_ortho:
        # over the rows of the last two axes: a leading axis is a
        # population of weights (parallel/population.py)
        col_sums = w.sum(dim=-2, keepdim=True)
        step = step + (col_sums - w) * (factor_ortho / w.shape[-2])
    return lr * step


@torch.no_grad()
def update(w, grad, state, hyper, flags):
    """One parameter update: ``(new_w, new_state, applied_gradient)``.

    hyper: dict(lr, wd, l1_vs_l2, moment, acc_alpha, acc_beta, gd_alpha,
    gd_beta, factor_ortho[, adagrad_eps, adadelta_eps, adadelta_adom,
    fast_lr]); flags: dict(accumulate, apply, solvers, variant_moment,
    ortho); state: dict(acc, vel, [adagrad], [adadelta_v, adadelta_gv],
    [fast]).  A hyper may be a tensor that broadcasts against ``w``: a
    population's, one value an individual along a leading axis."""
    gradient = -_gradient_step(
        w, grad, hyper["lr"], hyper["wd"], hyper["l1_vs_l2"],
        hyper.get("factor_ortho", 0.0), flags.get("ortho", False))
    new_state = dict(state)
    if flags.get("accumulate") and state.get("acc") is not None:
        acc = hyper["acc_alpha"] * gradient + hyper["acc_beta"] * state["acc"]
        gradient = hyper["gd_beta"] * gradient + hyper["gd_alpha"] * acc
        new_state["acc"] = acc
    if state.get("vel") is not None:
        if flags.get("variant_moment", True):
            vel = gradient + hyper["moment"] * state["vel"]
        else:
            vel = ((1.0 - hyper["moment"]) * gradient +
                   hyper["moment"] * state["vel"])
        new_state["vel"] = vel
        gradient = vel
    solvers = flags.get("solvers") or frozenset()
    if "adagrad" in solvers:
        ada = state["adagrad"] + new_state["vel"] ** 2
        gradient = gradient * torch.sqrt(ada + hyper.get("adagrad_eps",
                                                         1e-8))
        new_state["adagrad"] = ada
    if "adadelta" in solvers:
        eps = hyper.get("adadelta_eps", 1e-8)
        adom = hyper.get("adadelta_adom", 0.3)
        gv = (adom * state["adadelta_gv"] +
              (1.0 - adom) * new_state["vel"] ** 2)
        s1 = torch.sqrt(state["adadelta_v"] + eps)
        s2 = torch.sqrt(gv + eps)
        gradient = gradient * (s1 / s2)
        v = adom * state["adadelta_v"] + (1.0 - adom) * gradient ** 2
        new_state["adadelta_gv"] = gv
        new_state["adadelta_v"] = v
    if "fast" in solvers:
        fast = (state["fast"] * 0.95 +
                hyper.get("fast_lr", 0.02) * new_state["vel"])
        new_state["fast"] = fast
    new_w = w
    if flags.get("apply", True):
        new_w = w + gradient
        if "fast" in solvers:
            new_w = new_w - new_state["fast"]
    return new_w, new_state, gradient


def init_state(w, flags):
    """The optimizer-state slots of one parameter tensor, zeros like
    ``w``."""
    state = {}
    if flags.get("accumulate"):
        state["acc"] = torch.zeros_like(w)
    if flags.get("need_vel", True):
        state["vel"] = torch.zeros_like(w)
    solvers = flags.get("solvers") or frozenset()
    if "adagrad" in solvers:
        state["adagrad"] = torch.zeros_like(w)
    if "adadelta" in solvers:
        state["adadelta_v"] = torch.zeros_like(w)
        state["adadelta_gv"] = torch.zeros_like(w)
    if "fast" in solvers:
        state["fast"] = torch.zeros_like(w)
    return state


def register_update_cost(name, w):
    """The cost-registry hook of the GD update (the profiler's
    :func:`~znicz_tpu_torch.core.profiler.count_cost`): a context in
    which the first update dispatched under ``name`` is counted, with
    the parameter's element count as meta.  Call sites guard with
    ``profiler.enabled()``; a registered name is one dict lookup."""
    from znicz_tpu_torch.core import profiler
    return profiler.count_cost(name, param_elements=int(w.numel()))
