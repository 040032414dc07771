"""The numbers that decide ``correct``, and their judgement.

Training, over the checked steps (a one-step window, then a window of
the traffic's length): each step's loss, the first gradient as the
optimizer got it and the parameters' change after all the steps, the
last two leaf by leaf through their norms: the gap between the
program's norm and the reference's, over the reference's norm of that
leaf or of the median leaf, whichever is larger; the worst leaf is the
number.  A leaf whose reference gradient is under a thousandth of the
median leaf's moves by round-off alone and is left out of the change.
"""

import math

import numpy

#: a leaf's reference gradient under this share of the median leaf's is
#: rounding, and the leaf is left out of the change
STILL_LEAF = 1e-3


def _median(values):
    return float(numpy.median(numpy.asarray(values, dtype=numpy.float64)))


def norm_gap(prog, ref, include=None):
    """The worst leaf's ``|prog - ref| / max(ref, median(ref))`` over
    the leaves ``include`` keeps (all by default)."""
    med = _median(ref)
    worst = 0.0
    for i, (p, r) in enumerate(zip(prog, ref)):
        if include is not None and not include[i]:
            continue
        gap = abs(p - r) / max(r, med, 1e-30)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def train_numbers(prog, ref):
    """``{"loss_gap", "grad_gap", "change_gap"}`` of the program's
    readings ``prog`` against the reference's ``ref``; each is a dict
    of ``losses`` (one a step), ``grad_norms`` and ``change_norms`` (a leaf
    each)."""
    loss_gap = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                   for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    med = _median(ref["grad_norms"])
    moving = [g >= STILL_LEAF * med for g in ref["grad_norms"]]
    return {"loss_gap": loss_gap,
            "grad_gap": norm_gap(prog["grad_norms"], ref["grad_norms"]),
            "change_gap": norm_gap(prog["change_norms"],
                                   ref["change_norms"], moving)}


def judge(numbers, limits):
    """``(correct, checks)``: each number beside its limit, and whether
    every one is finite and within it."""
    checks = {}
    ok = True
    for name, spec in limits["numbers"].items():
        value = numbers.get(name)
        limit = float(spec["limit"])
        checks[name] = {"value": value, "limit": limit}
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks
