"""The port's learning-rate schedules (``znicz_tpu_torch.units.
lr_adjust``) against the JAX package's (``znicz_tpu.units.lr_adjust``),
on the CPU.

* Each of the five policies — "exp", "fixed", "step_exp", "inv" and
  "arbitrary_step" — from the same base and parameters gives the JAX
  policy's rate, as the same float, at iterations on either side of
  every boundary and past the end of the schedule; both registries
  hold the same names.
* ``LearningRateAdjust`` on three GD-like units, one without a bias
  policy: the rates it sets step by step equal the JAX adjuster's; on
  a loader's VALID minibatches (``train_gate_loader``) neither moves
  its count nor touches a rate; the base is taken when a unit is added,
  so a unit that already holds a scheduled rate keeps the config's
  base.
* ``_minibatches_count`` goes through a snapshot file: an adjuster
  restored from it continues with the rates of the uninterrupted JAX
  schedule.
"""

import pytest

from znicz_tpu.core.workflow import Workflow as JaxWorkflow
from znicz_tpu.units import lr_adjust as jax_lr
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.units import lr_adjust
from znicz_tpu_torch.units.nn_units import load_snapshot_into_workflow

#: (policy, base, parameters, iterations to read): each boundary with
#: its neighbours, and iterations past the end
POLICIES = [
    ("exp", 0.01, {"gamma": 0.999, "a_ratio": 0.5}, [0, 1, 2, 999, 1000,
                                                      123456]),
    ("fixed", 0.003, {}, [0, 1, 10 ** 9]),
    ("fixed", 0.003, {"base_lr": 0.5}, [0, 7]),
    ("step_exp", 0.02, {"gamma": 0.1, "step": 5},
     [0, 4, 5, 6, 9, 10, 11, 49, 50, 10 ** 6]),
    ("inv", 0.01, {"gamma": 0.0001, "pow_ratio": 0.75},
     [0, 1, 9999, 10000, 10 ** 7]),
    ("arbitrary_step", 0.001,
     {"lrs_with_lengths": [(1, 60000), (0.1, 5000), (0.01, 100000000)]},
     [0, 1, 59999, 60000, 60001, 64999, 65000, 65001, 100064999,
      100065000, 100065001, 10 ** 10]),
    ("arbitrary_step", 0.002,
     {"lrs_with_lengths": [(1, 3), (0.1, 4)], "base_lr": 0.05},
     [0, 2, 3, 4, 6, 7, 8, 100]),
]
SCHEDULE = {"lr_policy_name": "arbitrary_step",
            "bias_lr_policy_name": "step_exp",
            "lr_parameters": {"lrs_with_lengths": [(1, 3), (0.1, 4),
                                                   (0.01, 2)]},
            "bias_lr_parameters": {"gamma": 0.5, "step": 2}}


def test_policy_registries_agree():
    assert sorted(lr_adjust.LRAdjustPolicyRegistry.policies) == \
        sorted(jax_lr.LRAdjustPolicyRegistry.policies) == \
        ["arbitrary_step", "exp", "fixed", "inv", "step_exp"]


@pytest.mark.parametrize("name,base,params,iters", POLICIES,
                         ids=["%s-%d" % (p[0], i)
                              for i, p in enumerate(POLICIES)])
def test_policy_matches_jax(name, base, params, iters):
    got = lr_adjust.LRAdjustPolicyRegistry.policies[name](base, **params)
    want = jax_lr.LRAdjustPolicyRegistry.policies[name](base, **params)
    for itr in iters:
        g, w = got(itr), want(itr)
        assert type(g) is type(w) and g == w, (name, itr, g, w)
    if name == "arbitrary_step":
        assert got(iters[-1]) == 0.0


class _GD(object):
    """The attributes the adjuster reads and sets on a GD unit."""

    def __init__(self, lr, lr_bias, gate_skip):
        self.learning_rate = lr
        self.learning_rate_bias = lr_bias
        self.gate_skip = gate_skip


class _Loader(object):
    minibatch_class = TRAIN


def _adjuster(module, workflow, gate_skip, **kwargs):
    adj = module.LearningRateAdjust(workflow, name="lr_adjuster",
                                    **dict(SCHEDULE, **kwargs))
    gds = [_GD(0.01, 0.02, gate_skip), _GD(0.001, 0.001, gate_skip),
           _GD(0.5, 0.25, gate_skip)]
    for gd in gds:
        adj.add_gd_unit(gd)
    adj.train_gate_loader = _Loader()
    return adj, gds


def _rates(gds):
    return [(gd.learning_rate, gd.learning_rate_bias) for gd in gds]


def test_adjuster_matches_jax_step_by_step():
    from znicz_tpu.core.mutable import Bool as JaxBool
    got, got_gds = _adjuster(lr_adjust, Workflow(None), Bool(False))
    want, want_gds = _adjuster(jax_lr, JaxWorkflow(None), JaxBool(False))
    assert got.gate_skip is got_gds[0].gate_skip
    assert got.exports == want.exports == ["_minibatches_count"]
    classes = [TRAIN] * 4 + [VALID] * 3 + [TRAIN] * 8
    for clazz in classes:
        got.train_gate_loader.minibatch_class = clazz
        want.train_gate_loader.minibatch_class = clazz
        before = _rates(got_gds)
        got.run()
        want.run()
        assert _rates(got_gds) == _rates(want_gds)
        if clazz == VALID:
            assert _rates(got_gds) == before
        assert got._minibatches_count == want._minibatches_count
    assert got._minibatches_count == classes.count(TRAIN) == 12
    # the base was each unit's rate when it was added; the weights'
    # schedule (9 iterations) has ended at the 12th
    assert got_gds[0].learning_rate == 0.0
    assert got_gds[2].learning_rate_bias == 0.25 * 0.5 ** 5
    # no bias policy: the bias rates stay as they are
    plain, plain_gds = _adjuster(lr_adjust, Workflow(None), Bool(False),
                                 bias_lr_policy_name=None)
    plain.run()
    assert [b for _, b in _rates(plain_gds)] == [0.02, 0.001, 0.25]
    assert [w for w, _ in _rates(plain_gds)] == [0.01, 0.001, 0.5]


def test_count_survives_a_snapshot(tmp_path):
    from znicz_tpu.core.mutable import Bool as JaxBool
    wf = Workflow(None)
    adj, _ = _adjuster(lr_adjust, wf, Bool(False))
    snap = SnapshotterToFile(wf, directory=str(tmp_path), compression="")
    for _ in range(5):
        adj.run()
    state = SnapshotterToFile.import_(snap.export())
    assert state["units"]["lr_adjuster"] == {"_minibatches_count": 5}
    # a resumed workflow: its units already hold scheduled rates, its
    # adjuster's base comes from the config (the rates when linked)
    wf2 = Workflow(None)
    resumed, gds = _adjuster(lr_adjust, wf2, Bool(False))
    for gd in gds:   # as a restore leaves them: rates already scheduled
        gd.learning_rate, gd.learning_rate_bias = 1e-7, 2e-7
    load_snapshot_into_workflow(state, wf2)
    assert resumed._minibatches_count == 5
    want, want_gds = _adjuster(jax_lr, JaxWorkflow(None), JaxBool(False))
    for _ in range(5):
        want.run()
    for _ in range(6):
        resumed.run()
        want.run()
        assert _rates(gds) == _rates(want_gds)
    assert resumed._minibatches_count == want._minibatches_count == 11
    assert gds[1].learning_rate_bias == 0.001 * 0.5 ** 5


@pytest.mark.parametrize("steps", [None, [(1, 3), (0.1, 0)], [(-1, 3)]],
                         ids=["none", "empty-segment", "negative-rate"])
def test_arbitrary_step_rejects_a_bad_schedule(steps):
    """Where the JAX policy asserts, the port raises ``ValueError``
    (an assert is gone under ``python -O``)."""
    with pytest.raises(ValueError, match="arbitrary_step"):
        lr_adjust.ArbitraryStepPolicy(0.01, lrs_with_lengths=steps)
