"""The avatar (``core/avatar.py``) and ``StandardWorkflow.link_avatar``
held against ``znicz_tpu``'s, on the CPU.

* The avatar serves the stream of a twin loader, minibatch for
  minibatch, through its own Arrays (JAX
  ``tests/unit/test_observability.py:109-145``), and JAX's avatar over
  JAX's loader serves the same rows; without a loader it raises.
* The Wine workflow with ``link_avatar`` ends with the weights of the
  port's workflow without it, bit for bit in float64, and within 1e-12
  of JAX's avatar workflow (JAX ``tests/functional/
  test_std_workflow_aux.py:92-112``); the real loader is out of the
  container, and no producer thread is alive once ``run`` returns.
* A loader that raises on the producer surfaces on the consumer as
  JAX's ``RuntimeError("avatar producer failed")`` (its error the
  cause), the producer joined.
* A snapshot of an avatar workflow holds neither the loader nor the
  avatar, and a resume from it trains as JAX's resume does (within
  1e-12 in float64).
* While the profiler is armed the data wait is the consumer's queue
  wait, and the breakdown's parts still sum to its wall within 5%.
"""

import threading

import numpy
import pytest
import torch

import znicz_tpu.loader.loader_wine  # noqa: F401
import znicz_tpu_torch.loader.loader_wine  # noqa: F401
from test_torch_autoencoder import _close
from test_torch_mnist import f64  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.avatar import Avatar as JaxAvatar
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.snapshotter import SnapshotterToFile as JaxToFile
from znicz_tpu.core.workflow import DummyWorkflow
from znicz_tpu.loader.loader_wine import WineLoader as JaxWineLoader
from znicz_tpu.standard_workflow import StandardWorkflow as JaxStandard
from znicz_tpu.units.nn_units import \
    load_snapshot_into_workflow as jax_load_snapshot
from znicz_tpu_torch.core import prng, profiler
from znicz_tpu_torch.core.avatar import THREAD_PREFIX, Avatar
from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.loader.loader_wine import WineLoader
from znicz_tpu_torch.standard_workflow import StandardWorkflow
from znicz_tpu_torch.units.nn_units import load_snapshot_into_workflow

LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 12,
                                    "weights_stddev": 0.05,
                                    "bias_stddev": 0.05},
     "<-": {"learning_rate": 0.3}},
    {"type": "softmax", "->": {"output_sample_shape": 3,
                               "weights_stddev": 0.05,
                               "bias_stddev": 0.05},
     "<-": {"learning_rate": 0.3}},
]
RTOL = 1e-12


def _producers():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(THREAD_PREFIX)]


def _seed(pkg):
    streams = prng if pkg == "torch" else jax_prng
    streams.get(1).seed(1234)
    streams.get(2).seed(5678)


def _build(pkg, tmp_path, avatar=True, max_epochs=2, loader_run=None):
    """The JAX test's Wine workflow, its graph linked by hand with
    ``link_avatar`` right after the loader."""
    _seed(pkg)
    cls = StandardWorkflow if pkg == "torch" else JaxStandard
    wf = cls(None, layers=[dict(layer) for layer in LAYERS],
             loader_name="wine_loader", loader_config={"minibatch_size": 10},
             decision_config={"max_epochs": max_epochs,
                              "fail_iterations": 50},
             snapshotter_config={"prefix": "avatar_" + pkg, "interval": 1,
                                 "time_interval": 0, "compression": "",
                                 "directory": str(tmp_path / pkg)},
             preprocessing=True)
    wf.link_repeater(wf.start_point)
    wf.link_loader(wf.repeater)
    if loader_run is not None:
        wf.loader.run = loader_run(wf.loader)
    if avatar:
        wf.link_avatar()
    wf.link_forwards(("input", "minibatch_data"), wf.loader)
    wf.link_evaluator(wf.forwards[-1])
    wf.link_decision(wf.evaluator)
    wf.link_snapshotter(wf.decision)
    last_gd = wf.link_gds(wf.snapshotter)
    wf.link_loop(last_gd)
    wf.link_end_point(last_gd)
    wf.initialize(device="cpu" if pkg == "torch" else JaxDevice())
    return wf


def _params(wf):
    return [(numpy.array(f.weights.mem), numpy.array(f.bias.mem))
            for f in wf.forwards]


def test_avatar_serves_the_twin_loaders_stream():
    real = WineLoader(None, minibatch_size=16,
                      prng=prng.RandomGenerator().seed(4321))
    av = Avatar(Workflow(), loader=real, queue_depth=2)
    av.initialize(device="cpu")
    twin = WineLoader(None, minibatch_size=16,
                      prng=prng.RandomGenerator().seed(4321))
    twin.initialize(device="cpu")
    jreal = JaxWineLoader(None, minibatch_size=16,
                          prng=jax_prng.RandomGenerator().seed(4321))
    jav = JaxAvatar(DummyWorkflow(), loader=jreal, queue_depth=2)
    jav.initialize()
    mirrors = (av.minibatch_data, av.minibatch_labels)
    try:
        for _ in range(30):   # past the epoch's end and its reshuffle
            av.run()
            twin.run()
            jav.run()
            n = int(av.minibatch_size)
            assert n == int(twin.minibatch_size) == int(jav.minibatch_size)
            assert (av.minibatch_class, bool(av.epoch_ended),
                    av.epoch_number) == (twin.minibatch_class,
                                         bool(twin.epoch_ended),
                                         twin.epoch_number)
            for name in ("minibatch_data", "minibatch_labels",
                         "minibatch_indices"):
                got = getattr(av, name).mem[:n]
                assert numpy.array_equal(got, getattr(twin, name).mem[:n])
                assert numpy.array_equal(got, getattr(jav, name).mem[:n])
            # the mirrors are the avatar's own, made once, and adopt the
            # producer's private copy (the loader's buffer runs ahead)
            assert (av.minibatch_data, av.minibatch_labels) == mirrors
            assert not numpy.shares_memory(av.minibatch_data.mem,
                                           real.minibatch_data.mem)
            assert torch.device(av.minibatch_data.device).type == "cpu"
    finally:
        av.stop()
        jav.stop()
    assert not _producers()


@pytest.mark.parametrize("cls,wf_cls", [(Avatar, Workflow),
                                        (JaxAvatar, DummyWorkflow)])
def test_avatar_needs_a_loader(cls, wf_cls):
    with pytest.raises(ValueError, match="needs a loader"):
        cls(wf_cls()).initialize()


def test_wine_with_the_avatar_trains_as_without_it_and_as_jax(f64,
                                                               tmp_path):
    plain = _build("torch", tmp_path / "plain", avatar=False)
    plain.run()
    wf = _build("torch", tmp_path)
    assert type(wf.loader) is Avatar
    assert type(wf.real_loader) is WineLoader
    assert wf.real_loader not in wf.units and wf.loader in wf.units
    wf.run()
    assert not _producers() and wf.loader._thread is None
    jwf = _build("jax", tmp_path)
    jwf.run()
    assert type(jwf.loader).__name__ == "Avatar"
    assert wf.decision.epoch_number == jwf.decision.epoch_number == 2
    assert wf.decision.best_n_err_pt == plain.decision.best_n_err_pt == \
        jwf.decision.best_n_err_pt
    assert wf.decision.best_n_err_pt[2] < 50.0
    for (w, b), (pw, pb), (jw, jb) in zip(_params(wf), _params(plain),
                                          _params(jwf)):
        assert w.dtype == numpy.float64
        assert numpy.array_equal(w, pw) and numpy.array_equal(b, pb)
        _close(w, jw, RTOL, "weights")
        _close(b, jb, RTOL, "bias")


def _raising(after):
    def wrap(loader):
        real = type(loader).run
        calls = [0]

        def run():
            calls[0] += 1
            if calls[0] > after:
                raise OSError("disk gone at minibatch %d" % calls[0])
            real(loader)
        return run
    return wrap


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_raising_loader_surfaces_on_the_consumer(pkg, tmp_path):
    wf = _build(pkg, tmp_path, loader_run=_raising(5))
    with pytest.raises(RuntimeError, match="avatar producer failed") as e:
        wf.run()
    assert isinstance(e.value.__cause__, OSError)
    if pkg == "torch":
        # the run's on_workflow_finished joined the producer
        assert not _producers() and wf.loader._thread is None
    else:
        wf.loader.stop()
    assert wf.decision.epoch_number == 0


def test_resume_of_an_avatar_workflow_as_in_jax(f64, tmp_path):
    """JAX takes the real loader out of the container, so a snapshot
    has no loader state and a resume serves the loader's stream from
    its start; the port does the same."""
    final = {}
    for pkg in ("torch", "jax"):
        first = _build(pkg, tmp_path / "first", max_epochs=1)
        first.run()
        path = first.snapshotter.destination
        state = (SnapshotterToFile if pkg == "torch" else
                 JaxToFile).import_(path)
        assert "loader" not in state["units"]
        assert "avatar" not in state["units"]
        assert "all2all_tanh_0_forward" in state["units"]
        resumed = _build(pkg, tmp_path / "resumed", max_epochs=3)
        (load_snapshot_into_workflow if pkg == "torch" else
         jax_load_snapshot)(state, resumed)
        resumed.run()
        final[pkg] = (resumed.decision.epoch_number,
                      list(resumed.decision.epoch_n_err),
                      resumed.real_loader.epoch_number, _params(resumed))
    assert not _producers()
    got, want = final["torch"], final["jax"]
    assert got[:3] == want[:3]
    for (w, b), (jw, jb) in zip(got[3], want[3]):
        _close(w, jw, RTOL, "weights")
        _close(b, jb, RTOL, "bias")


def test_the_breakdown_partitions_its_wall_with_the_avatar(tmp_path):
    profiler.reset()
    profiler.enable()
    try:
        wf = _build("torch", tmp_path)
        assert wf.real_loader.notes_data_wait is False
        wf.run()
        bd = profiler.breakdown_summary()
    finally:
        profiler.disable()
        profiler.reset()
    assert bd["parts_seconds"]["data_wait"] > 0
    assert bd["steps"] > 0
    total = sum(bd["parts_seconds"].values())
    assert abs(total - bd["wall_seconds"]) <= \
        max(0.05 * bd["wall_seconds"], 1e-3), bd
