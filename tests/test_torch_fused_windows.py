"""The fused trainer's three window forms and its stochastic pools
against the JAX package's, on the CPU.

* The window forms (``units/fused_trainer.py``): ``device_data`` and
  ``device_perm`` select the form the JAX trainer selects — rows
  gathered from the dataset on the device by index, sliced from the
  epoch's shuffled dataset (``device_perm=True``), or stacked on the
  host (``device_data=False``, or a loader whose fill the device
  cannot replay) — and raise where it raises.  One difference, on
  purpose: an MSE window over device data gathers by index unless
  ``device_perm=True``, where the JAX trainer always slices; the same
  rows give the same run (window 8 against the JAX trainer's sliced
  window 8, within 1e-12 in float64).
* The pins of ``tests/functional/test_fused_window.py``, reproduced:
  the approximator in float64, window 8 equal to window 1 within 1e-12
  with a padded tail (800 TRAIN rows at minibatch 64: 13 minibatches,
  the last of 32); the host-stacked, sliced and indexed windows bit
  for bit; kanji with class targets, window 4 (host-stacked, and
  gathered) against window 1, n_err equal integer for integer and the
  metrics and parameters within 1e-12; the MNIST MLP's softmax windows
  in all three forms against window 1, with no VALID segment too (the
  epoch's last minibatch reshuffles the loader in place while a window
  starting with it is collected); ``FusedNet.run_window`` equal to K
  ``step`` calls.
* The four stochastic pooling types in ``FusedNet``: handed the same
  uint16 stream (``fused.draw_u16`` replaced), each equals
  ``ops.pooling.stochastic_pooling`` / ``stochastic_pool_depool`` and
  the JAX ops bit for bit, values and winners; on the net's own
  generator each window's winner frequencies over 40,000 windows
  follow ``|x| / sum |x|`` (``max(x, 0) / sum`` without abs) within a
  chi-square of 16.27 (3 degrees of freedom, p = 0.001); ``predict``
  draws too, and a ``state_dict`` resumes the draws bit for bit.
"""

import numpy
import pytest
import torch

import jax.numpy as jnp
from test_torch_autoencoder import _bits, _close, f64  # noqa: F401
from test_torch_mnist import _restored  # noqa: F401
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.ops import pooling as jax_pool
from znicz_tpu.samples import approximator as jax_approximator
from znicz_tpu.samples import mnist as jax_mnist
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.parallel import fused
from znicz_tpu_torch.samples import approximator, kanji, mnist

RTOL = 1e-12
STOCHASTIC = ("stochastic_pooling", "stochastic_abs_pooling",
              "stochastic_pool_depool", "stochastic_abs_pool_depool")
#: chi-square of 3 degrees of freedom at p = 0.001
CHI2_BOUND = 16.27


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def npy_pair(tmp_path_factory):
    """1,066 rows of the approximator's map: 800 TRAIN (13 minibatches
    of 64, the last of 32) and 266 VALID."""
    base = tmp_path_factory.mktemp("approximator")
    r = numpy.random.RandomState(0xA112)
    x = r.uniform(-1, 1, (1066, 10)).astype(numpy.float32)
    w = r.uniform(-1, 1, (10, 3))
    y = numpy.stack([numpy.sin(x @ w[:, 0]),
                     numpy.cos(x @ w[:, 1]) * (x @ w[:, 2]),
                     numpy.tanh(2 * x @ w[:, 2])], axis=1)
    paths = {"dataset_file": str(base / "x.npy"),
             "targets_file": str(base / "y.npy")}
    numpy.save(paths["dataset_file"], x)
    numpy.save(paths["targets_file"], y.astype(numpy.float32))
    return paths


def _seed():
    for p in (prng, jax_prng):
        p.get(1).seed(1234)
        p.get(2).seed(5678)


def _approximator(module, device, tmp_path, fused_cfg, npy_pair,
                  max_epochs=3, run=True):
    _seed()
    wf = module.build(
        loader_config=dict(npy_pair, minibatch_size=64),
        decision_config={"max_epochs": max_epochs, "fail_iterations": 100},
        snapshotter_config={"prefix": "fwm", "interval": 100,
                            "time_interval": 1e9, "compression": "",
                            "directory": str(tmp_path)},
        fused=dict(fused_cfg))
    wf.initialize(device=device)
    if run:
        wf.run()
    return wf


def _params(wf):
    return [{k: numpy.array(v) for k, v in p.items()}
            for p in wf.fused_trainer.net.host_params() if p]


def _same_mse_run(a, b, rtol=RTOL):
    for ma, mb in zip(a.decision.epoch_metrics, b.decision.epoch_metrics):
        assert (ma is None) == (mb is None)
        if ma is not None:
            _close(numpy.array(ma), numpy.array(mb), rtol, "metrics")
    assert list(a.decision.epoch_n_err) == list(b.decision.epoch_n_err)
    for pa, pb in zip(_params(a), _params(b)):
        for k in pb:
            if rtol == 0:
                assert numpy.array_equal(_bits(pa[k]), _bits(pb[k])), k
            else:
                _close(pa[k], pb[k], rtol, k)


def _form(trainer):
    if trainer.window == 1:
        return "step"
    if not trainer._use_device_data:
        return "stacked"
    return "sliced" if trainer._use_sliced else "indexed"


# -- the window forms ---------------------------------------------------------

@pytest.mark.parametrize("cfg,port,jax_form", [
    ({}, "indexed", "sliced"),
    ({"device_perm": True}, "sliced", "sliced"),
    ({"window": 4}, "indexed", "sliced"),
    ({"window": 4, "device_data": False}, "stacked", "stacked"),
    ({"device_data": False}, "step", "step"),
    ({"window": 4, "device_perm": False}, "stacked", "stacked"),
    ({"window": 1}, "step", "step")])
def test_keys_select_the_jax_form(tmp_path, npy_pair, cfg, port, jax_form):
    """Each ``device_data`` / ``device_perm`` setting selects the JAX
    trainer's window form (the MSE device-data window gathers by index
    unless ``device_perm=True``: same rows, see
    :func:`test_mse_window8_equals_jax_sliced_float64`)."""
    twf = _approximator(approximator, "cpu", tmp_path, cfg, npy_pair,
                        run=False)
    jwf = _approximator(jax_approximator, JaxDevice(), tmp_path, cfg,
                        npy_pair, run=False)
    assert _form(twf.fused_trainer) == port
    assert _form(jwf.fused_trainer) == jax_form
    assert twf.fused_trainer.window == jwf.fused_trainer.window
    assert twf.loader.skip_fill == jwf.loader.skip_fill


@pytest.mark.parametrize("cfg,match", [
    ({"device_data": True, "device_perm": False}, "device_data=True"),
    ({"device_perm": True, "window": 1}, "device_perm=True"),
    ({"device_perm": True, "device_data": False, "window": 4},
     "device_perm=True"),
    ({"device_data": "yes"}, "'auto', True or False")])
def test_keys_raise_where_jax_raises(tmp_path, npy_pair, cfg, match):
    for module, dev in ((approximator, "cpu"),
                        (jax_approximator, JaxDevice())):
        if module is jax_approximator and cfg.get("device_data") == "yes":
            continue   # the JAX trainer takes any other value as False
        with pytest.raises(ValueError, match=match):
            _approximator(module, dev, tmp_path, cfg, npy_pair, run=False)


class _CustomFill(approximator.ApproximatorLoader):
    """A loader whose fill the device cannot replay."""

    MAPPING = "test_torch_custom_fill_approximator"

    def fill_minibatch(self):
        super(_CustomFill, self).fill_minibatch()


def test_custom_fill_stacks_its_windows(f64, tmp_path, npy_pair):
    """A loader with its own fill: window 1 by default, a host-stacked
    window when asked, ``device_data=True`` refused; the stacked window
    equals the steps."""
    def run(cfg):
        with _restored(approximator.root.approximator):
            approximator.root.approximator.loader_name = _CustomFill.MAPPING
            return _approximator(approximator, "cpu", tmp_path, cfg,
                                 npy_pair)
    with pytest.raises(ValueError, match="device_data=True"):
        run({"device_data": True})
    steps, stacked = run({}), run({"window": 4})
    assert isinstance(steps.loader, _CustomFill)
    assert _form(steps.fused_trainer) == "step"
    assert _form(stacked.fused_trainer) == "stacked"
    _same_mse_run(stacked, steps)


# -- the pins of tests/functional/test_fused_window.py ------------------------

def test_mse_window8_equals_window1(f64, tmp_path, npy_pair):
    wf_w = _approximator(approximator, "cpu", tmp_path, {"window": 8},
                         npy_pair)
    wf_1 = _approximator(approximator, "cpu", tmp_path, {"window": 1},
                         npy_pair)
    assert wf_w.loader.class_lengths == [0, 266, 800]
    assert _form(wf_w.fused_trainer) == "indexed"
    assert wf_w.decision.epoch_number == 3
    _same_mse_run(wf_w, wf_1)


def test_mse_window_host_stacked_equals_sliced_and_indexed(f64, tmp_path,
                                                           npy_pair):
    """The three forms read the same rows: bit for bit."""
    runs = {form: _approximator(approximator, "cpu", tmp_path, cfg,
                                npy_pair)
            for form, cfg in (("stacked", {"window": 4,
                                           "device_data": False}),
                              ("sliced", {"window": 4,
                                          "device_perm": True}),
                              ("indexed", {"window": 4}))}
    for form, wf in runs.items():
        assert _form(wf.fused_trainer) == form
    _same_mse_run(runs["stacked"], runs["sliced"], rtol=0)
    _same_mse_run(runs["indexed"], runs["sliced"], rtol=0)


def test_mse_window8_equals_jax_sliced_float64(f64, tmp_path, npy_pair,
                                               monkeypatch):
    """The known difference: the port's default MSE window gathers by
    index, the JAX trainer's slices; the run is the same within
    1e-12."""
    monkeypatch.setattr(jax_root.common.dirs, "snapshots", str(tmp_path))
    twf = _approximator(approximator, "cpu", tmp_path, {}, npy_pair)
    jwf = _approximator(jax_approximator, JaxDevice(), tmp_path, {},
                        npy_pair)
    assert _form(twf.fused_trainer) == "indexed"
    assert _form(jwf.fused_trainer) == "sliced"
    for ma, mb in zip(twf.decision.epoch_metrics, jwf.decision.epoch_metrics):
        if mb is not None:
            _close(numpy.array(ma), numpy.array(mb), RTOL, "metrics")
    got = _params(twf)
    want = [{k: numpy.array(v) for k, v in p.items()}
            for p in jwf.fused_trainer.net.host_params() if p]
    for pa, pb in zip(got, want):
        for k in pb:
            _close(pa[k], pb[k], RTOL, k)


@pytest.mark.parametrize("cfg", [{"window": 4, "device_data": False},
                                 {"window": 4}], ids=["stacked", "indexed"])
def test_mse_window_class_targets_equals_window1(f64, tmp_path, cfg):
    """Kanji with class targets: the in-window nearest-class-target
    n_err equals the per-minibatch evaluator's integer for integer."""
    data = kanji.materialize_synthetic(str(tmp_path / "kj"))

    def run(fused_cfg):
        _seed()
        wf = kanji.build(
            loader_config={"minibatch_size": 30,
                           "train_paths": [data + "/train"],
                           "target_paths": [data + "/target"]},
            decision_config={"max_epochs": 2, "fail_iterations": 100},
            snapshotter_config={"prefix": "kw", "interval": 100,
                                "time_interval": 1e9,
                                "directory": str(tmp_path)},
            fused=dict(fused_cfg))
        wf.initialize(device="cpu")
        wf.run()
        return wf
    wf_w, wf_1 = run(cfg), run({"window": 1})
    assert _form(wf_w.fused_trainer) == ("stacked" if "device_data" in cfg
                                         else "indexed")
    assert wf_w.fused_trainer.net.class_targets is not None
    _same_mse_run(wf_w, wf_1)
    assert wf_w.decision.epoch_n_err[2] is not None


def _mnist(tmp_path, fused_cfg, valid=60):
    """The MNIST MLP on 130 TRAIN rows at minibatch 40 (4 minibatches,
    the last of 10), 2 epochs, in float64."""
    prng.get(1).seed(1234)
    prng.get(2).seed(5678)
    wf = mnist.build(
        loader_config={"synthetic_train": 130, "synthetic_valid": valid,
                       "minibatch_size": 40},
        decision_config={"max_epochs": 3, "fail_iterations": 100},
        snapshotter_config={"directory": str(tmp_path), "interval": 1000,
                            "time_interval": 1e9},
        fused=dict(fused_cfg))
    wf.initialize(device="cpu")
    wf.run()
    return wf


@pytest.mark.parametrize("valid", [60, 0], ids=["valid", "no_valid"])
@pytest.mark.parametrize("cfg", [{"window": 3, "device_data": False},
                                 {"window": 3, "device_perm": True},
                                 {"window": 3}],
                         ids=["stacked", "sliced", "indexed"])
def test_softmax_windows_equal_window1(f64, tmp_path, cfg, valid):
    """Windows of 3 over 4 minibatches: the second window of an epoch
    is its last minibatch alone; with no VALID segment, that minibatch
    reshuffled the loader as it was served."""
    wf_w, wf_1 = _mnist(tmp_path, cfg, valid), _mnist(tmp_path,
                                                      {"window": 1}, valid)
    assert _form(wf_w.fused_trainer) == ("stacked" if "device_data" in cfg
                                         else "sliced" if "device_perm"
                                         in cfg else "indexed")
    assert list(wf_w.decision.epoch_n_err) == list(wf_1.decision.epoch_n_err)
    for ca, cb in zip(wf_w.decision.confusion_matrixes,
                      wf_1.decision.confusion_matrixes):
        assert numpy.array_equal(numpy.asarray(ca), numpy.asarray(cb))
    for a, b in zip(wf_w.decision.max_err_y_sums,
                    wf_1.decision.max_err_y_sums):
        assert abs(a - b) < 1e-12
    for pa, pb in zip(_params(wf_w), _params(wf_1)):
        for k in pb:
            _close(pa[k], pb[k], RTOL, k)


def test_softmax_host_stacked_matches_jax(f64, tmp_path, monkeypatch):
    """The host-stacked softmax window, the port's against the JAX
    trainer's, in float64."""
    monkeypatch.setattr(jax_root.common.dirs, "snapshots", str(tmp_path))
    cfg = {"window": 3, "device_data": False}
    twf = _mnist(tmp_path, cfg)
    jax_prng.get(1).seed(1234)
    jax_prng.get(2).seed(5678)
    jwf = jax_mnist.build(
        loader_config={"synthetic_train": 130, "synthetic_valid": 60,
                       "minibatch_size": 40},
        decision_config={"max_epochs": 3, "fail_iterations": 100},
        fused=dict(cfg))
    jwf.initialize(device=JaxDevice())
    jwf.run()
    assert not jwf.fused_trainer._use_device_data
    assert list(twf.decision.epoch_n_err) == list(jwf.decision.epoch_n_err)
    want = [{k: numpy.array(v) for k, v in p.items()}
            for p in jwf.fused_trainer.net.host_params() if p]
    for pa, pb in zip(_params(twf), want):
        for k in pb:
            _close(pa[k], pb[k], RTOL, k)


def _mlp(seed=1):
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 7},
               "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
              {"type": "softmax", "->": {"output_sample_shape": 3},
               "<-": {"learning_rate": 0.1}}]
    return fused.FusedNet(layers, (5,), rand=prng.RandomGenerator().seed(
        seed), dtype=numpy.float64, device="cpu")


def test_run_window_equals_steps():
    """``run_window`` over K host-stacked minibatches, the last one a
    padded tail, equals K ``step`` calls on the same rows (the padded
    rows labelled -1) bit for bit, and its stats count the real rows."""
    r = numpy.random.RandomState(5)
    xs = r.uniform(-1, 1, (3, 4, 5))
    labels = r.randint(0, 3, (3, 4)).astype(numpy.int32)
    sizes = [4, 4, 2]
    a, b = _mlp(), _mlp()
    stats = a.run_window(xs, labels, sizes, fused.stack_hypers(a.hypers, 3))
    n_err = 0
    for k in range(3):
        lbl = labels[k].copy()
        lbl[sizes[k]:] = -1
        m = b.step(xs[k], lbl)
        n_err += int(m["n_err"])
    for pa, pb in zip(a.host_params(), b.host_params()):
        for key in pb:
            assert numpy.array_equal(_bits(pa[key]), _bits(pb[key]))
    assert int(stats["n_err"][1]) == 10
    assert int(stats["n_err"][0]) == n_err


# -- the stochastic pools in FusedNet -----------------------------------------

def _stochastic_net(tpe, shape=(6, 6, 2), seed=3):
    layers = [{"name": "pool", "type": tpe,
               "->": {"kx": 2, "ky": 2, "sliding": (2, 2)}},
              {"type": "all2all", "->": {"output_sample_shape": 3}}]
    return fused.FusedNet(layers, shape, objective="mse",
                          dtype=numpy.float64, dropout_seed=seed,
                          device="cpu")


@pytest.mark.parametrize("tpe", STOCHASTIC)
def test_shared_stream_equals_the_unit_op(tpe, monkeypatch):
    """The fused pool handed a stream equals the unit op (and the JAX
    op) on that stream bit for bit, values and winners."""
    r = numpy.random.RandomState(7)
    x = r.normal(0, 1, (3, 7, 7, 2))
    x[0, :2, :2] = 0   # a zero-sum window
    net = _stochastic_net(tpe, (7, 7, 2))
    spec = net.specs[0]
    u16 = torch.as_tensor(r.randint(0, 1 << 16, 3 * 4 * 4 * 2),
                          dtype=torch.int32)
    seen = []

    def draw(generator, n):
        seen.append(n)
        return u16[:n]
    monkeypatch.setattr(fused, "draw_u16", draw)
    xt = torch.as_tensor(x)
    got = fused._stochastic_pool(spec, xt, net._gen)
    use_abs = "abs" in tpe
    if tpe.endswith("_depool"):
        want = pool_ops.stochastic_pool_depool(xt, u16, 2, 2, use_abs)
        jwant = jax_pool.stochastic_pool_depool_jax(
            jnp.asarray(x), jnp.asarray(u16.numpy().astype(numpy.uint16)),
            2, 2, use_abs=use_abs)
    else:
        want = pool_ops.stochastic_pooling(xt, u16, 2, 2, (2, 2), use_abs)
        jwant = jax_pool.stochastic_pooling_jax(
            jnp.asarray(x), jnp.asarray(u16.numpy().astype(numpy.uint16)),
            2, 2, (2, 2), use_abs=use_abs)
    assert seen == [3 * 4 * 4 * 2]
    for g, w, jw in zip(got, want, jwant):
        assert numpy.array_equal(_bits(g.numpy()), _bits(w.numpy()))
        assert numpy.array_equal(_bits(g.numpy()), _bits(numpy.asarray(jw)))
    # the whole net's forward takes the same stream
    y = fused.forward(net.params, xt, net.specs, generator=net._gen)
    direct = fused.forward(net.params[1:], want[0], net.specs[1:])
    assert torch.equal(y, direct)


@pytest.mark.parametrize("tpe", STOCHASTIC)
def test_device_draw_follows_the_distribution(tpe):
    """40,000 2x2 windows of the same four values, drawn on the net's
    generator: each cell wins as often as its weight says (|x| / sum,
    or max(x, 0) / sum without abs, a negative cell never), within a
    chi-square of 16.27."""
    cells = numpy.array([0.5, -1.5, 2.0, 1.0])
    n = 40000
    x = numpy.tile(cells.reshape(1, 2, 2, 1), (n, 1, 1, 1))
    net = _stochastic_net(tpe, (2, 2, 1))
    _, offsets = fused._stochastic_pool(net.specs[0], torch.as_tensor(x),
                                        net._gen)
    cell = offsets.numpy().reshape(-1) % 4
    counts = numpy.bincount(cell, minlength=4)
    weight = numpy.abs(cells) if "abs" in tpe else numpy.maximum(cells, 0)
    p = weight / weight.sum()
    assert counts[p == 0].sum() == 0
    expected = p[p > 0] * n
    chi2 = ((counts[p > 0] - expected) ** 2 / expected).sum()
    assert chi2 < CHI2_BOUND, (counts, expected, chi2)


@pytest.mark.parametrize("tpe", STOCHASTIC)
def test_stochastic_net_trains_predicts_and_resumes(tpe):
    """Steps and windows draw from the generator (each step its own
    winners), ``predict`` draws too, and a ``state_dict`` resumes the
    draws and the training bit for bit."""
    r = numpy.random.RandomState(9)
    x = r.normal(0, 1, (4, 6, 6, 2))
    t = r.normal(0, 1, (4, 3))
    net = _stochastic_net(tpe)
    outs = [net.step_mse(x, t)["output"] for _ in range(2)]
    assert not torch.equal(outs[0], outs[1])
    p0 = net.predict(x)
    sd = net.state_dict()
    other = _stochastic_net(tpe, seed=99)
    other.load_state_dict(sd)
    for a, b in ((net, other),):
        pa, pb = a.predict(x), b.predict(x)
        assert torch.equal(pa, pb) and not torch.equal(pa, p0)
        a.step_mse(x, t), b.step_mse(x, t)
    for pa, pb in zip(net.host_params(), other.host_params()):
        for k in pb:
            assert numpy.array_equal(_bits(pa[k]), _bits(pb[k]))
    net.set_dataset(x, None, t)
    stats = net.run_window_mse_indexed(numpy.array([[0, 1], [2, 3]]),
                                       [2, 2],
                                       fused.stack_hypers(net.hypers, 2))
    assert numpy.isfinite(stats["loss"].numpy()).all()
