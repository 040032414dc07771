"""Divergence recovery: the port's ``NNRollback`` (the unit graph) and
``FusedNNRollback`` (the fused graph), linked by
``StandardWorkflow.link_rollback``, against ``znicz_tpu``'s.

The UCI Wine rows through ``StandardWorkflow`` ([8 tanh, 3 softmax],
minibatch 10, learning rate 0.5 so that some epochs do not improve),
float64, both packages' prng streams 1 and 2 seeded alike, 8 epochs,
the rollback run after each epoch's end with ``minus_steps`` 1 or 2.
At every rollback run the decision's ``improved``, each GD unit's (or
proxy's) learning rates and the parameters are recorded: the two
packages' records are within 1e-12 (f64) of each other, and improved
runs, learning-rate decays and restores all happen.  The fused
rollback's history holds tensors on the net's device (clones, no host
copy) and restores them bit for bit (``tests/functional/
test_fused_workflow.py:257``); a NaN in a parameter forces the
rollback at once in both graphs.
"""

import numpy
import pytest
import torch

from test_torch_faults import faults_health_isolated  # noqa: F401
from test_torch_resilience import f64  # noqa: F401
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.standard_workflow import StandardWorkflow as JaxStandardWorkflow
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.standard_workflow import StandardWorkflow
from znicz_tpu_torch.units.fused_trainer import FusedNNRollback
from znicz_tpu_torch.units.nn_rollback import NNRollback

RTOL = 1e-12
LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.5, "learning_rate_bias": 0.5}},
    {"type": "softmax", "->": {"output_sample_shape": 3},
     "<-": {"learning_rate": 0.5, "learning_rate_bias": 0.5}},
]


def _build(pkg, tmp_path, fused, epochs=8, **rollback):
    if pkg == "jax":
        import znicz_tpu.loader.loader_wine  # noqa: F401 (registry)
        p, workflow = jax_prng, JaxStandardWorkflow
    else:
        import znicz_tpu_torch.loader.loader_wine  # noqa: F401
        p, workflow = prng, StandardWorkflow
    p.get(1).seed(1234)
    p.get(2).seed(5678)
    kwargs = {"fused": {"window": 4}} if fused else {}
    wf = workflow(None, layers=[dict(layer) for layer in LAYERS],
                  loader_name="wine_loader",
                  loader_config={"minibatch_size": 10},
                  decision_config={"max_epochs": epochs,
                                   "fail_iterations": 100},
                  snapshotter_config={"prefix": "rb", "interval": 10 ** 9,
                                      "time_interval": 1e9,
                                      "compression": "",
                                      "directory": str(tmp_path / pkg)},
                  **kwargs)
    last = wf.snapshotter if fused else wf.gds[0]
    rb = wf.link_rollback(last, **rollback)
    wf.repeater.unlink_from(last)
    wf.repeater.link_from(rb)
    wf.end_point.unlink_from(last)
    wf.end_point.link_from(rb)
    return wf, rb


def _params(pkg, wf):
    if wf.fused_trainer is not None:
        return [{k: numpy.asarray(v) for k, v in p.items()}
                for p in wf.fused_trainer.host_params() if p]
    out = []
    for f in wf.forwards:
        f.weights.map_read()
        f.bias.map_read()
        out.append({"w": numpy.array(f.weights.mem),
                    "b": numpy.array(f.bias.mem)})
    return out


def _lrs(wf):
    units = wf.fused_trainer.gd_proxies if wf.fused_trainer is not None \
        else wf.gds
    return [(float(u.learning_rate), float(u.learning_rate_bias))
            for u in units]


def _trajectory(pkg, tmp_path, fused, **rollback):
    wf, rb = _build(pkg, tmp_path, fused, **rollback)
    record = []
    real = rb.run

    def run():
        before = (rb._plus_steps, rb._minus_steps)
        real()
        record.append((bool(wf.decision.improved), before, _lrs(wf),
                       _params(pkg, wf)))

    rb.run = run
    if pkg == "jax":
        wf.initialize(device=JaxDevice())
    else:
        wf.initialize(device="cpu")
    wf.run()
    return wf, rb, record


def _assert_records_close(got, want):
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[:2] == w[:2], "epoch %d" % (i + 1)
        numpy.testing.assert_allclose(g[2], w[2], rtol=RTOL,
                                      err_msg="epoch %d" % (i + 1))
        for layer, (pg, pw) in enumerate(zip(g[3], w[3])):
            for k in pw:
                scale = float(numpy.abs(pw[k]).max()) or 1.0
                assert float(numpy.abs(pg[k] - pw[k]).max()) <= \
                    RTOL * scale, "epoch %d layer %d %s" % (i + 1, layer, k)


@pytest.mark.parametrize("fused", [False, True], ids=["units", "fused"])
@pytest.mark.parametrize("minus_steps", [1, 2])
def test_rollback_trajectory_matches_jax(tmp_path, fused, minus_steps):
    wf, rb, got = _trajectory("torch", tmp_path, fused,
                              minus_steps=minus_steps)
    _, _, want = _trajectory("jax", tmp_path, fused, minus_steps=minus_steps)
    _assert_records_close(got, want)
    assert isinstance(rb, FusedNNRollback if fused else NNRollback)
    improved = [r[0] for r in got]
    assert any(improved) and not all(improved[1:]), improved
    # a rollback decayed the rates below their starting 0.5 * lr_plus^k
    assert min(r[2][0][0] for r in got) < 0.5


def test_fused_rollback_history_stays_on_the_device(tmp_path):
    wf, rb, _ = _trajectory("torch", tmp_path, True, minus_steps=2)
    assert rb._history
    from znicz_tpu_torch.core.health import _leaves
    net = wf.fused_trainer.net
    live = {t.data_ptr() for t in _leaves([net.params, net.state])}
    for entry in rb._history:
        leaves = _leaves([entry["params"], entry["opt"]])
        assert leaves and all(isinstance(t, torch.Tensor) and
                              t.device == net.device for t in leaves)
        assert not live & {t.data_ptr() for t in leaves}


def test_fused_rollback_restores_state(tmp_path):
    """Force two epochs without an improvement: the learning rates
    decay and the stored state comes back bit for bit (parameters,
    optimizer slots and the generator)."""
    wf, rb, _ = _trajectory("torch", tmp_path, True, minus_steps=2)
    trainer = wf.fused_trainer
    stored = rb._history[0]
    want = {"params": [{k: t.clone() for k, t in p.items()}
                       for p in stored["params"]],
            "key": stored["key"].clone()}
    lr = trainer.gd_proxies[0].learning_rate
    wf.decision.improved <<= False
    rb._first_run = False
    rb._minus_steps = 0
    rb.run()
    rb.run()
    assert trainer.gd_proxies[0].learning_rate == pytest.approx(lr * 0.65)
    for p_want, p_got in zip(want["params"], trainer.net.params):
        for k in p_want:
            assert torch.equal(p_want[k], p_got[k])
    assert torch.equal(trainer.net._gen.get_state(), want["key"])
    # restoring does not alias the history: a step leaves it intact
    trainer.net.params[0]["w"].add_(1.0)
    assert torch.equal(rb._history[0]["params"][0]["w"],
                       want["params"][0]["w"])


@pytest.mark.parametrize("fused", [False, True], ids=["units", "fused"])
def test_nan_forces_an_immediate_rollback(tmp_path, fused):
    """One epoch without an improvement and a NaN in the parameters:
    the rollback fires at once, though ``minus_steps`` is 3."""
    wf, rb, _ = _trajectory("torch", tmp_path, fused, minus_steps=3)
    assert rb._history if fused else rb._gds
    lrs = _lrs(wf)
    if fused:
        wf.fused_trainer.net.params[0]["w"][0, 0] = float("nan")
    else:
        wf.forwards[0].weights.map_write()
        wf.forwards[0].weights.mem[0, 0] = numpy.nan
    wf.decision.improved <<= False
    rb._first_run = False
    rb._minus_steps = 0
    rb.run()
    assert _lrs(wf)[0][0] == pytest.approx(lrs[0][0] * 0.65)
    params = _params("torch", wf)
    assert numpy.isfinite(params[0]["w"]).all()
