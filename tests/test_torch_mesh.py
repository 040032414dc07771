"""The port's mesh and ``FusedNet(mesh=...)`` over gloo gangs, against
the JAX package's mesh runs.

* ``make_mesh``: the ``(data, model)`` layout of JAX's device array
  (rank ``r`` at ``(r // model, r % model)``), the axis lines and the
  divisibility errors, over 8 ranks and in a process without a world;
* ``FusedMLP`` with ``tests/unit/test_fused.py``'s ``LAYERS`` on 8
  ranks at model_parallel 1 and 2 memorizes 64 samples;
* float64 ``FusedNet`` steps on 4 ranks as a 2x2 mesh (a conv, a max
  pool on the offsets path, two FC layers split over the model axis)
  within 1e-10 of JAX's ``make_mesh(4, model_parallel=2)`` steps and of
  the port's single-device steps; ``run_steps`` equals stepwise; a
  batch the data axis does not divide raises;
* dropout and a stochastic pool under a mesh draw the global batch's
  masks and winners, so a mesh run equals the single-device run;
* ``ops.kohonen.train_step_sharded`` on 8 ranks within 1e-12 of JAX's.
"""

import numpy
import pytest

from znicz_tpu.core import prng as jax_prng
from znicz_tpu.ops import kohonen as jax_kohonen
from znicz_tpu.parallel import FusedNet as JaxFusedNet
from znicz_tpu.parallel import make_mesh as jax_make_mesh
import torch_gang
from znicz_tpu_torch import testing
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.parallel import FusedNet
from znicz_tpu_torch.parallel.mesh import make_mesh

F64_TOL = 1e-10

#: tests/unit/test_fused.py's LAYERS
LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8,
                                    "weights_stddev": 0.05,
                                    "bias_stddev": 0.05},
     "<-": {"learning_rate": 0.3, "weights_decay": 0.0}},
    {"type": "softmax", "->": {"output_sample_shape": 4,
                               "weights_stddev": 0.05,
                               "bias_stddev": 0.05},
     "<-": {"learning_rate": 0.3, "weights_decay": 0.0}},
]

CONV_NET = [
    {"type": "conv_tanh", "->": {"n_kernels": 4, "kx": 3, "ky": 3},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.05}},
]

RANDOM_NET = [
    {"type": "conv_tanh", "->": {"n_kernels": 4, "kx": 3, "ky": 3},
     "<-": {"learning_rate": 0.05}},
    {"type": "stochastic_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.05}},
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "softmax", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.05}},
]


def _batch(n=16, f=13, c=4, seed=3):
    """tests/unit/test_fused.py's linearly separable batch."""
    r = numpy.random.RandomState(seed)
    x = r.uniform(-1, 1, (n, f))
    proj = r.uniform(-1, 1, (f, c))
    return x, numpy.argmax(x @ proj, axis=1).astype(numpy.int32)


def _images(steps=3, batch=8, seed=11):
    r = numpy.random.RandomState(seed)
    return (r.uniform(-1, 1, (steps, batch, 8, 8)),
            r.randint(0, 4, (steps, batch)).astype(numpy.int32))


def _close(got, want, tol=F64_TOL, where="params"):
    """Every array of a pytree within ``tol`` of ``want``'s, relative to
    its largest magnitude."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], tol, "%s.%s" % (where, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, tol, "%s[%d]" % (where, i))
    else:
        want = numpy.asarray(want)
        scale = float(numpy.abs(want).max()) if want.size else 0.0
        diff = float(numpy.abs(numpy.asarray(got) - want).max()) \
            if want.size else 0.0
        assert diff <= tol * (scale or 1.0), "%s: %g" % (where, diff)


@pytest.fixture(scope="module")
def gang8():
    """The 8-rank cases: layouts, the memorizing MLP, Kohonen."""
    x, labels = _batch(n=64)
    r = numpy.random.RandomState(7)
    kx = r.uniform(-1, 1, (32, 6))
    kw = r.uniform(-0.05, 0.05, (9, 6))
    calls = [("layouts", "mesh_layouts", ()),
             ("mlp", "mlp_memorizes", (LAYERS, x, labels, 120)),
             ("kohonen", "kohonen_step", (kx, kw, 1.4, 0.05))]
    return testing.run_gang(torch_gang.suite, 8, args=(calls,),
                            timeout_s=240), (kx, kw)


@pytest.fixture(scope="module")
def gang4():
    """The 4-rank cases: a 2x2 and a 4x1 mesh over the conv net, and
    the random net on a 2x2 mesh."""
    xs, ls = _images()
    calls = [("2x2", "fused_steps", (CONV_NET, (8, 8), xs, ls, 2)),
             ("4x1", "fused_steps", (CONV_NET, (8, 8), xs, ls, 1)),
             ("random", "fused_steps", (RANDOM_NET, (8, 8), xs, ls, 2, 3))]
    return testing.run_gang(torch_gang.suite, 4, args=(calls,),
                            timeout_s=240)


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_make_mesh_lays_ranks_out_as_jax_lays_devices(gang8, mp):
    jmesh = jax_make_mesh(8, model_parallel=mp)
    ids = numpy.vectorize(lambda d: d.id)(jmesh.devices)
    for rank, out in enumerate(gang8[0]):
        shape, coords, data_line, model_line = out["layouts"][mp]
        assert shape == dict(jmesh.shape)
        d, m = numpy.argwhere(ids == rank)[0]
        assert coords == {"data": d, "model": m}
        assert data_line == list(ids[:, m])
        assert model_line == list(ids[d, :])


def test_make_mesh_errors(gang8):
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(8, model_parallel=3)
    for out in gang8[0]:
        lay = out["layouts"]
        assert lay["mp3"] == str(jax_err.value)
        assert "requested 16 devices, have 8" in lay["n16"]
        assert "torchrun --nproc-per-node 16" in lay["n16"]
        assert "a mesh spans the whole world" in lay["n4"]


def test_one_rank_mesh_without_a_world():
    """``make_mesh(1)`` in a process that never initialized a world: no
    groups, no collective; more ranks raise with the launch recipe."""
    mesh = make_mesh(1)
    assert mesh.shape == {"data": 1, "model": 1}
    assert not any(mesh.groups.values())
    assert mesh.gather_rows(numpy.zeros(2)) is not None
    assert not mesh.counts
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        make_mesh(2)
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        make_mesh(1, model_parallel=2)


@pytest.mark.parametrize("mp", [1, 2])
def test_fused_on_mesh(gang8, mp):
    """JAX's ``test_fused_on_mesh``: 120 steps on 8 ranks converge and
    memorize 64 samples, with the 8-wide and the 4-wide layer split
    over the model axis at model_parallel 2."""
    for rank, out in enumerate(gang8[0]):
        first, last, n_err, rows = out["mlp"][mp]
        assert last < first
        assert n_err == 0, "should memorize 64 samples"
        if mp == 1:
            assert rows == [None, None]
        else:
            m = rank % 2
            assert rows == [(4 * m, 4 * m + 4), (2 * m, 2 * m + 2)]


def test_kohonen_train_step_sharded_matches_jax(gang8):
    kx, kw = gang8[1]
    coords = jax_kohonen.make_coords(9)
    want = jax_kohonen.train_step_sharded(jax_make_mesh(8), kx, kw, coords,
                                          1.4, 0.05)
    for out in gang8[0]:
        new_w, hist, argmins = out["kohonen"]
        assert numpy.abs(new_w - numpy.asarray(want[0])).max() < 1e-12
        numpy.testing.assert_array_equal(hist, numpy.asarray(want[1]))
        numpy.testing.assert_array_equal(argmins, numpy.asarray(want[2]))


def _jax_steps(layers, xs, ls, mp):
    net = JaxFusedNet(layers, (8, 8), mesh=jax_make_mesh(4, model_parallel=mp),
                      rand=jax_prng.RandomGenerator().seed(7),
                      dtype=numpy.float64)
    params, losses = [], []
    for x, lbl in zip(xs, ls):
        m = net.step(x, lbl)
        params.append(net.host_params())
        losses.append(float(m["loss"]))
    return params, losses


def _port_steps(layers, xs, ls, **kwargs):
    net = FusedNet(layers, (8, 8), rand=prng.RandomGenerator().seed(7),
                   dtype=numpy.float64, device="cpu", pool_impl="offsets",
                   **kwargs)
    params, losses, errs = [], [], []
    for x, lbl in zip(xs, ls):
        m = net.step(x, lbl)
        params.append(net.host_params())
        losses.append(float(m["loss"]))
        errs.append(int(m["n_err"]))
    return net, params, losses, errs, m


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_fused_net_steps_equal_jax_mesh_and_single_device(gang4, mesh):
    """Each step's parameters (the split layers gathered whole) within
    1e-10 of JAX's steps on ``make_mesh(4, model_parallel=mp)`` and of
    the port's single-device steps; the losses and n_err too, and the
    gathered output and predict are the single device's."""
    mp = 2 if mesh == "2x2" else 1
    xs, ls = _images()
    jax_params, jax_losses = _jax_steps(CONV_NET, xs, ls, mp)
    net, params, losses, errs, m = _port_steps(CONV_NET, xs, ls)
    for rank, out in enumerate(gang4):
        got = out[mesh]
        for step in range(len(xs)):
            _close(got["params"][step], jax_params[step])
            _close(got["params"][step], params[step])
        numpy.testing.assert_allclose(got["loss"], jax_losses, rtol=F64_TOL)
        numpy.testing.assert_allclose(got["loss"], losses, rtol=F64_TOL)
        assert got["n_err"] == errs
        assert numpy.abs(got["output"] - m["output"].numpy()).max() < 1e-12
        numpy.testing.assert_array_equal(got["max_idx"], m["max_idx"])
        probs, idx = net.predict_with_idx(xs[0])
        assert numpy.abs(got["predict"][0] - probs.numpy()).max() < 1e-12
        _close(got["state"]["params"], net.state_dict()["params"])
        _close(got["state"]["opt"], net.state_dict()["opt"])
        if mp == 2:
            m_ = rank % 2
            assert got["split"][2:] == [(4 * m_, 4 * m_ + 4),
                                        (2 * m_, 2 * m_ + 2)]
            assert got["counts"]["all_gather"] > 0


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_run_steps_equal_stepwise_on_the_mesh(gang4, mesh):
    for out in gang4:
        got = out[mesh]
        params, metrics = got["run_steps"]
        _close(params, got["params"][-1], 1e-12)
        numpy.testing.assert_allclose(metrics["loss"], got["loss"],
                                      rtol=1e-12)
        assert list(metrics["n_err"]) == got["n_err"]


def test_a_batch_the_data_axis_does_not_divide_raises(gang4):
    for out in gang4:
        assert out["2x2"]["odd_batch"] == \
            "batch 7 not divisible by data-parallel 2"
        assert out["4x1"]["odd_batch"] == \
            "batch 7 not divisible by data-parallel 4"


def test_random_layers_draw_the_global_batch_s_stream(gang4):
    """Dropout and a stochastic pool on a 2x2 mesh: each rank draws the
    global batch's masks and winners from the shared generator and
    keeps its rows, so the run is the single-device run's."""
    xs, ls = _images()
    _, params, losses, errs, _ = _port_steps(RANDOM_NET, xs, ls,
                                             dropout_seed=3)
    for out in gang4:
        got = out["random"]
        for step in range(len(xs)):
            _close(got["params"][step], params[step])
        numpy.testing.assert_allclose(got["loss"], losses, rtol=F64_TOL)
        assert got["n_err"] == errs


def test_the_one_step_all_reduce_is_counted(gang4):
    """A step is one all-reduce over the data axis (gradients, loss,
    n_err and the output rows in one buffer)."""
    for out in gang4:
        counts = out["4x1"]["counts"]
        # 3 steps + 3 run_steps steps + the predict's gather
        assert counts == {"all_reduce": 7}


def test_the_kernels_stay_on_under_a_mesh(monkeypatch):
    """Known difference: JAX leaves its Pallas forward off under a mesh
    (``prefer_pallas``, ``znicz_tpu/parallel/fused.py:1026-1029``); the
    port keeps ``pool_impl="offsets"`` on every rank's rows, which are
    an ordinary single-device batch (the kernels on the card, their
    plain versions here)."""
    from znicz_tpu_torch.ops import pooling as pool_ops
    jax_net = JaxFusedNet(CONV_NET, (8, 8), mesh=jax_make_mesh(4),
                          rand=jax_prng.RandomGenerator().seed(7))
    assert jax_net.specs[1].prefer_pallas is False
    calls = []
    real = pool_ops.max_pooling_train
    monkeypatch.setattr(pool_ops, "max_pooling_train",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    net = FusedNet(CONV_NET, (8, 8), mesh=make_mesh(1), device="cpu",
                   pool_impl="offsets", rand=prng.RandomGenerator().seed(7))
    xs, ls = _images(steps=1)
    net.step(xs[0], ls[0])
    assert net.specs[1].impl == "offsets"
    assert calls == [(8, 6, 6, 4)]


def test_a_layer_with_an_ortho_term_stays_whole():
    """Known difference: JAX splits every FC layer whose width divides by
    the model axis; the port keeps one with an ortho term whole, since
    the term sums over all of the layer's rows."""
    from znicz_tpu_torch.parallel.mesh import Mesh
    layers = [dict(CONV_NET[2], **{"<-": {"factor_ortho": 0.001}}),
              dict(CONV_NET[3])]
    net = FusedNet(layers, 13, mesh=Mesh(1, 2, rank=1), device="cpu",
                   rand=prng.RandomGenerator().seed(7))
    assert [getattr(s, "rows", None) for s in net.specs] == [None, (2, 4)]
    assert net.params[1]["w"].shape == (2, 8)
