"""The master-slave roles and the GD units' gradient protocol, against
the JAX package's (``core/units.py:218-229``, ``core/workflow.py:74-116``,
``launcher.py:89-99``, ``units/nn_units.py:457-500``), and
``testing.multi_device_mesh`` in a one-rank world.

A launcher and a workflow are standalone; a unit takes its workflow's
role.  A slave's GD units apply no update, keep their velocity for the
master (``generate_data_for_master``) and take the master's rates with
zeroed gradients (``apply_data_from_master``); the master folds a
slave's velocity into its weights (``apply_data_from_slave``).  A
slave's decision completes every minibatch and keeps its statistics,
and its learning-rate adjuster leaves the rates to the master.
"""

import unittest

import numpy
import pytest

from znicz_tpu.core import workflow as jax_workflow
from znicz_tpu.core.backends import NumpyDevice
from znicz_tpu.core.memory import Array as JaxArray
from znicz_tpu.launcher import Launcher as JaxLauncher
from znicz_tpu.units import gd as jax_gd
from znicz_tpu_torch import testing
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.launcher import Launcher
from znicz_tpu_torch.units import gd


def _roles(obj):
    return (obj.is_master, obj.is_slave, obj.is_standalone)


def test_launcher_workflow_and_unit_roles_as_jax():
    assert _roles(Launcher(device="cpu")) == _roles(JaxLauncher()) == \
        (False, False, True)
    wf, jwf = Workflow(None), jax_workflow.Workflow(None)
    assert _roles(wf) == _roles(jwf) == (False, False, True)
    unit = Unit(wf)
    assert _roles(unit) == (False, False, True)
    for flag, want in (("_is_slave", (False, True, False)),
                       ("_is_master", (True, False, False))):
        setattr(wf, flag, True)
        setattr(jwf, flag, True)
        assert _roles(wf) == _roles(jwf) == want
        assert _roles(unit) == want
        setattr(wf, flag, False)
        setattr(jwf, flag, False)
    assert _roles(Unit(None)) == (False, False, True)


def _gd_pair(slave=False, moment=0.5):
    """The port's and JAX's ``GradientDescent`` on the same weights,
    bias and velocity, in a workflow of the given role."""
    r = numpy.random.RandomState(4)
    w = r.uniform(-1, 1, (3, 5))
    b = r.uniform(-1, 1, 3)
    vel_w, vel_b = r.uniform(-1, 1, (3, 5)), r.uniform(-1, 1, 3)
    units = []
    for wf_cls, array, cls in ((Workflow, Array, gd.GradientDescent),
                               (jax_workflow.Workflow, JaxArray,
                                jax_gd.GradientDescent)):
        wf = wf_cls(None)
        wf._is_slave = slave
        u = cls(wf, learning_rate=0.1, gradient_moment=moment,
                gradient_moment_bias=moment, weights_decay=0.01)
        u.weights, u.bias = array(w.copy()), array(b.copy())
        u.gradient_weights_with_moment.reset(vel_w.copy())
        u.gradient_bias_with_moment.reset(vel_b.copy())
        u.gradient_weights.reset(numpy.ones_like(w))
        u.gradient_bias.reset(numpy.ones_like(b))
        units.append(u)
    return units


def test_slave_gd_applies_no_update():
    for slave in (False, True):
        port, jax_unit = _gd_pair(slave)
        assert port.apply_gradient == jax_unit.apply_gradient == (not slave)


def test_gd_protocol_as_jax():
    port, jax_unit = _gd_pair()
    assert port.generate_data_for_slave() == \
        jax_unit.generate_data_for_slave()
    # nothing to send before a run
    assert port.generate_data_for_master() is None
    assert jax_unit.generate_data_for_master() is None
    port.gradient_changed = jax_unit.gradient_changed = True
    got, want = port.generate_data_for_master(), \
        jax_unit.generate_data_for_master()
    for a, b in zip(got, want):
        numpy.testing.assert_array_equal(a, b)
    assert not port.gradient_changed and not jax_unit.gradient_changed
    data = (numpy.full((3, 5), 0.25), numpy.full(3, -0.5))
    port.apply_data_from_slave(data)
    jax_unit.apply_data_from_slave(data)
    for attr in ("weights", "bias", "gradient_weights_with_moment",
                 "gradient_bias_with_moment"):
        numpy.testing.assert_array_equal(getattr(port, attr).mem,
                                         getattr(jax_unit, attr).mem)
    rates = (0.2, 0.001, 0.9, 0.3, 0.0, 0.8)
    port.apply_data_from_master(rates)
    jax_unit.apply_data_from_master(rates)
    assert port.generate_data_for_slave() == rates == \
        jax_unit.generate_data_for_slave()
    for attr in ("gradient_weights_with_moment", "gradient_bias_with_moment",
                 "gradient_weights", "gradient_bias"):
        numpy.testing.assert_array_equal(getattr(port, attr).mem,
                                         getattr(jax_unit, attr).mem)
        assert not getattr(port, attr).mem.any()


def test_slave_gd_keeps_a_velocity_without_a_moment():
    """Outside a standalone run the velocity Arrays exist even at a
    zero moment (JAX :350-362)."""
    port, jax_unit = _gd_pair(slave=True, moment=0.0)
    for u in (port, jax_unit):
        u.gradient_weights_with_moment.reset()
        u.gradient_bias_with_moment.reset()
        u.input = type(u.weights)(numpy.zeros((2, 5)))
        u.err_output = type(u.weights)(numpy.zeros((2, 3)))
        u.output = type(u.weights)(numpy.zeros((2, 3)))
    port.initialize(device="cpu")
    jax_unit.initialize(device=NumpyDevice())
    for u in (port, jax_unit):
        assert u.gradient_weights_with_moment
        assert u.gradient_bias_with_moment


def test_multi_device_mesh_skips_with_the_recipe():
    with pytest.raises(unittest.SkipTest, match="torchrun --nproc-per-node 8"):
        testing.multi_device_mesh(8)
    mesh = testing.multi_device_mesh(1)
    assert mesh.shape == {"data": 1, "model": 1}


def test_slave_decision_completes_every_minibatch():
    """A slave's decision completes at once, mid-epoch (JAX :80-83); a
    standalone one waits for the epoch's end."""
    from znicz_tpu.units import decision as jax_decision
    from znicz_tpu_torch.units import decision
    for slave in (False, True):
        done = []
        for wf_cls, mod in ((Workflow, decision),
                            (jax_workflow.Workflow, jax_decision)):
            wf = wf_cls(None)
            wf._is_slave = slave
            d = mod.TrivialDecision(wf)
            d.last_minibatch, d.minibatch_class = False, 2
            d.epoch_number, d.epoch_ended = 0, False
            d.run()
            done.append(bool(d.complete))
        assert done == [slave, slave]


def test_slave_lr_adjuster_leaves_the_rates_to_the_master():
    from znicz_tpu.units import lr_adjust as jax_lr
    from znicz_tpu_torch.units import lr_adjust

    class _GD(object):
        learning_rate = learning_rate_bias = 0.5
        gate_skip = False
    for wf_cls, mod in ((Workflow, lr_adjust),
                        (jax_workflow.Workflow, jax_lr)):
        wf = wf_cls(None)
        wf._is_slave = True
        adj = mod.LearningRateAdjust(wf, lr_policy_name="exp",
                                     lr_parameters={"gamma": 0.1})
        unit = _GD()
        adj.add_gd_unit(unit)
        adj.run()
        assert (unit.learning_rate, adj._minibatches_count) == (0.5, 0)
