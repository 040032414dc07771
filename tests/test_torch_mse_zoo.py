"""The port's MSE samples (``samples/approximator.py``, ``samples/kanji.py``
with ``loader/image_mse.py``, ``samples/research/video_ae.py`` and
``samples/research/imagenet_ae.py``) against the JAX package's, on the
CPU.

* ``GOLDEN_ZOO2`` (``tests/functional/test_research_models.py``: seeds
  1234 / 5678, its configs): video_ae, approximator and imagenet_ae
  reproduce it in float32, the integer columns exactly and the MSE
  within its ``MSE_RTOL`` (1e-6 relative), in the unit graph and, for
  the two ``StandardWorkflow`` samples, the fused graph.
* Float64 against ``znicz_tpu``, all four samples: every epoch's
  ``[avg, max, min]`` metrics and n_err, every weight and bias (and
  ImagenetAE's ``GDDeconv`` velocity) within 1e-12 of the largest, and
  ImagenetAE's stochastic winners equal.
* ImagenetAE's ladder grown stage by stage on a narrow ladder (4 / 6 /
  8 / 8 kernels at the published kernel sizes and strides) at
  ``size`` 176, in float64: each stage grown from the previous one's
  snapshot, the frozen stages' weights bit-equal across its run, its
  own conv's weights moved, every stage within 1e-12 of the JAX
  package's, and a snapshot whose geometry does not fit raises.  The
  issue asked for ``size`` 152, where the stage-3 conv leaves a 1x1
  map that a 3x3/s2 pool does not cover (no window): 174 is the least
  size that grows all four, and at 176 the stage-0 deconv leaves an
  uncovered border (canvas 174 < 176), as at 227 (225 < 227).
* Kanji's loader: the same PNGs from the same seed, the same targets
  and class targets in the targets' normalized space.
* The launcher resolves ``research.imagenet_ae``, ``research.video_ae``,
  ``approximator`` and ``kanji`` and ``--list`` prints them; each runs
  with ``--device cpu`` and raises without CUDA otherwise.
"""

import glob
import os

import numpy
import pytest
import torch

from test_torch_autoencoder import RESEARCH, _bits, _close, f64  # noqa: F401
from test_torch_mnist import _restored
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.samples import approximator as jax_approximator
from znicz_tpu.samples import kanji as jax_kanji
from znicz_tpu.samples.research import imagenet_ae as jax_imagenet_ae
from znicz_tpu.samples.research import video_ae as jax_video_ae
from znicz_tpu.units import pooling as jax_pooling_units
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch import launcher
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.samples import approximator, kanji
from znicz_tpu_torch.samples.research import imagenet_ae, video_ae
from znicz_tpu_torch.units import pooling as pooling_units

RTOL = 1e-12
PORT = {"video_ae": video_ae, "approximator": approximator,
        "imagenet_ae": imagenet_ae, "kanji": kanji}
JAX = {"video_ae": jax_video_ae, "approximator": jax_approximator,
       "imagenet_ae": jax_imagenet_ae, "kanji": jax_kanji}
#: the narrow ladder: the published kernel sizes and strides
NARROW = [{"n_kernels": 4, "kx": 9, "ky": 9, "sliding": (3, 3)},
          {"n_kernels": 6, "kx": 5, "ky": 5, "sliding": (1, 1)},
          {"n_kernels": 8, "kx": 5, "ky": 5, "sliding": (1, 1)},
          {"n_kernels": 8, "kx": 3, "ky": 3, "sliding": (1, 1)}]
NARROW_SIZE = 176


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and their thread pools would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def kanji_data(tmp_path_factory):
    return kanji.materialize_synthetic(
        str(tmp_path_factory.mktemp("kanji")))


def _config(name, snapdir, kanji_dir=None):
    """The JAX tests' configs (``GOLDEN_ZOO2``'s builders,
    ``tests/functional/test_research_models.py:388-427``; kanji's of
    ``tests/functional/test_fused_window.py:270-290``)."""
    if name == "video_ae":
        return dict(decision_config={"max_epochs": 3, "fail_iterations": 10})
    if name == "approximator":
        return dict(loader_config={"minibatch_size": 100},
                    decision_config={"max_epochs": 3,
                                     "fail_iterations": 20},
                    snapshotter_config={"directory": str(snapdir),
                                        "interval": 1000,
                                        "time_interval": 1e9})
    if name == "kanji":
        return dict(loader_config={
            "minibatch_size": 30,
            "train_paths": [os.path.join(kanji_dir, "train")],
            "target_paths": [os.path.join(kanji_dir, "target")]},
            decision_config={"max_epochs": 2, "fail_iterations": 100},
            snapshotter_config={"directory": str(snapdir),
                                "interval": 100, "time_interval": 1e9})
    return dict(decision_config={"max_epochs": 2, "fail_iterations": 5},
                snapshotter_config={"directory": str(snapdir),
                                    "interval": 1000, "time_interval": 1e9})


class _Winners(object):
    """Records every stochastic pool's winners, by device package, while
    installed (both packages' ``StochasticPoolingBase.run``)."""

    def __init__(self, monkeypatch):
        self.got = {"torch": [], "jax": []}
        for key, cls in (("torch", pooling_units.StochasticPoolingBase),
                         ("jax", jax_pooling_units.StochasticPoolingBase)):
            real = cls.run

            def run(unit, real=real, key=key):
                real(unit)
                self.got[key].append(numpy.array(unit.input_offset.mem))
            monkeypatch.setattr(cls, "run", run)


def _train(module, device, snapdir, seeds=(1234, 5678), state=None,
           **kwargs):
    """Seed both packages' streams, build, initialize (restoring the
    earlier stages from ``state``, a snapshot path, for ImagenetAE) and
    run; returns the workflow and its ``(class, n_err or -1, round(avg
    MSE, 9))`` and metrics at every segment end."""
    for p in (prng, jax_prng):
        p.get(1).seed(seeds[0])
        p.get(2).seed(seeds[1])
    if module is jax_imagenet_ae:
        kwargs.pop("snapshotter_config", None)   # it reads the config
    wf = module.build(**kwargs)
    seq, metrics, d = [], [], wf.decision
    real = d.on_last_minibatch

    def on_last_minibatch():
        real()
        c = d.minibatch_class
        err, met = d.epoch_n_err[c], d.epoch_metrics[c]
        seq.append((int(c), -1 if err is None else int(err),
                    None if met is None else round(float(met[0]), 9)))
        metrics.append(None if met is None else numpy.array(met))
    d.on_last_minibatch = on_last_minibatch
    wf.initialize(device=device)
    if state is not None:
        module.restore_stage_weights(state, wf)
    wf.run()
    return wf, seq, metrics


def _params(wf):
    """Every weight and bias (and the autoencoder's velocity), by name."""
    if getattr(wf, "fused_trainer", None) is not None:
        out = {}
        for i, p in enumerate(wf.fused_trainer.net.host_params()):
            out.update({"%d.%s" % (i, k): numpy.array(v)
                        for k, v in p.items()})
        return out
    if hasattr(wf, "convs"):
        out = {c.name: numpy.array(c.weights.mem) for c in wf.convs}
        out["velocity"] = numpy.array(
            wf.gd_deconv.gradient_weights_with_moment.mem)
        return out
    out = {}
    for i, f in enumerate(wf.forwards):
        out["%d.w" % i] = numpy.array(f.weights.mem)
        out["%d.b" % i] = numpy.array(f.bias.mem)
    return out


def _same_run(got, want, rtol=RTOL):
    """Two ``_train`` results: segments' classes and n_err equal,
    metrics and every parameter within ``rtol``."""
    gwf, gseq, gmet = got
    wwf, wseq, wmet = want
    assert [s[:2] for s in gseq] == [s[:2] for s in wseq]
    for g, w in zip(gmet, wmet):
        _close(g, w, rtol, "metrics")
    gp, wp = _params(gwf), _params(wwf)
    assert sorted(gp) == sorted(wp) and gp
    for key in wp:
        _close(gp[key], wp[key], rtol, key)


# -- GOLDEN_ZOO2 --------------------------------------------------------------

@pytest.mark.parametrize("name,fused", [
    ("video_ae", None), ("video_ae", {}), ("approximator", None),
    ("approximator", {}), ("imagenet_ae", None)],
    ids=["video_ae-units", "video_ae-fused", "approximator-units",
         "approximator-fused", "imagenet_ae-units"])
def test_reproduces_the_golden_trajectory(tmp_path, name, fused):
    """(ImagenetAE is a unit graph of its own, with no fused mode.)"""
    kwargs = _config(name, tmp_path)
    if fused is not None:
        kwargs["fused"] = fused
    wf, seq, _ = _train(PORT[name], "cpu", tmp_path, **kwargs)
    RESEARCH._assert_trajectory(name, seq, RESEARCH.GOLDEN_ZOO2[name])
    assert (getattr(wf, "fused_trainer", None) is None) == (fused is None)


# -- float64 against znicz_tpu ------------------------------------------------

@pytest.mark.parametrize("name", ["video_ae", "approximator", "imagenet_ae",
                                  "kanji"])
def test_matches_jax_float64(f64, tmp_path, monkeypatch, kanji_data, name):
    monkeypatch.setattr(jax_root.common.dirs, "snapshots", str(tmp_path))
    winners = _Winners(monkeypatch)
    cfg = _config(name, tmp_path, kanji_data)
    want = _train(JAX[name], JaxDevice(), tmp_path, **cfg)
    got = _train(PORT[name], "cpu", tmp_path, **_config(name, tmp_path,
                                                         kanji_data))
    _same_run(got, want)
    assert got[0].loader.class_lengths == list(want[0].loader.class_lengths)
    for v in _params(got[0]).values():
        assert v.dtype == numpy.float64
    if name == "imagenet_ae":
        assert len(winners.got["torch"]) == len(winners.got["jax"]) == 8
        for g, w in zip(winners.got["torch"], winners.got["jax"]):
            assert numpy.array_equal(g, w)
    if name == "kanji":
        # the nearest-class-target error counts every row
        n_err = got[0].decision.epoch_n_err[2]
        assert n_err is not None
        assert n_err == want[0].decision.epoch_n_err[2]


# -- ImagenetAE: the ladder, grown --------------------------------------------

def _ladder_config(snapdir, n_stages):
    return dict(n_stages=n_stages, stages=NARROW,
                loader_config={"size": NARROW_SIZE, "n_images": 16},
                decision_config={"max_epochs": 1, "fail_iterations": 5},
                snapshotter_config={"directory": str(snapdir)})


def _newest(snapdir):
    snaps = sorted(glob.glob(os.path.join(str(snapdir), "*.pickle")),
                   key=os.path.getmtime)
    assert snaps
    return snaps[-1]


def test_imagenet_ae_grows_its_ladder_as_jax(f64, tmp_path, monkeypatch):
    """Four stages, each grown from the previous one's snapshot, in
    both packages: the frozen stages bit-equal across the stage's run,
    the new conv moved, and every stage's run within 1e-12 of JAX's."""
    winners = _Winners(monkeypatch)
    state = {"torch": None, "jax": None}
    for n in range(1, 5):
        runs = {}
        for key, module, dev in (("jax", jax_imagenet_ae, JaxDevice()),
                                 ("torch", imagenet_ae, "cpu")):
            snapdir = tmp_path / key / str(n)
            snapdir.mkdir(parents=True)
            monkeypatch.setattr(jax_root.common.dirs, "snapshots",
                                str(snapdir))
            for p in (prng, jax_prng):
                p.get(1).seed(1234)
                p.get(2).seed(5678)
            cfg = _ladder_config(snapdir, n)
            if key == "jax":
                cfg.pop("snapshotter_config")
            wf = module.build(**cfg)
            wf.initialize(device=dev)
            if state[key] is not None:
                restored = module.restore_stage_weights(state[key], wf)
                assert restored == ["conv%d" % i for i in range(n - 1)]
            before = [numpy.array(c.weights.mem) for c in wf.convs]
            wf.run()
            after = [numpy.array(c.weights.mem) for c in wf.convs]
            for b, a in zip(before[:-1], after[:-1]):
                assert numpy.array_equal(_bits(a), _bits(b))
            assert numpy.abs(after[-1] - before[-1]).max() > 0
            runs[key] = wf
            state[key] = _newest(snapdir)
        got, want = _params(runs["torch"]), _params(runs["jax"])
        for name in want:
            _close(got[name], want[name], RTOL, "stage %d %s" % (n, name))
        _close(runs["torch"].reconstruction_mse(),
               numpy.array(runs["jax"].reconstruction_mse()), RTOL, "mse")
        shapes = [tuple(p.output.shape) for p in runs["torch"].pools]
        assert shapes == [tuple(p.output.shape) for p in runs["jax"].units
                          if p.name.startswith("pool")]
    assert shapes == [(8, 28, 28, 4), (8, 12, 12, 6), (8, 4, 4, 8),
                      (8, 1, 1, 8)]
    # the stage-0 deconv's canvas (174) leaves a border of 176 uncovered
    wf = runs["torch"]
    assert tuple(wf.convs[0].input.shape[1:3]) == (NARROW_SIZE, NARROW_SIZE)
    assert (wf.convs[0].output.shape[1] - 1) * 3 + 9 == 174
    for g, w in zip(winners.got["torch"], winners.got["jax"]):
        assert numpy.array_equal(g, w)
    assert len(winners.got["torch"]) == len(winners.got["jax"]) > 0


def test_imagenet_ae_geometry_mismatch_raises(tmp_path):
    """A snapshot conv whose weights do not fit the grown workflow's
    raises ``ValueError`` (the JAX package's message)."""
    cfg = _ladder_config(tmp_path, 1)
    imagenet_ae.run_sample(device="cpu", **cfg)
    snap = _newest(tmp_path)
    other = [dict(NARROW[0], n_kernels=5)] + NARROW[1:]
    wf = imagenet_ae.build(**dict(_ladder_config(tmp_path, 2),
                                  stages=other))
    wf.initialize(device="cpu")
    with pytest.raises(ValueError, match="stage geometry changed"):
        imagenet_ae.restore_stage_weights(snap, wf)
    # restored at initialize through ``restore_snapshot``
    wf = imagenet_ae.build(restore_snapshot=snap,
                           **_ladder_config(tmp_path, 2))
    wf.initialize(device="cpu")
    from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
    saved = SnapshotterToFile.import_(snap)["units"]["conv0"]["weights"]
    assert numpy.array_equal(wf.convs[0].weights.mem, saved)


def test_imagenet_ae_graph(tmp_path):
    """The graph of the JAX sample: the stages' units in order, the
    deconv sharing the last conv's weights, the evaluator against the
    last conv's input, ``GDDeconv`` the only gradient unit."""
    wf = imagenet_ae.build(n_stages=2, snapshotter_config={
        "directory": str(tmp_path)})
    jwf = jax_imagenet_ae.build(n_stages=2)
    names = [u.name for u in wf.units]
    for name in ("conv0", "pool0", "conv1", "pool1"):
        assert name in names and name in [u.name for u in jwf.units]
    assert wf.deconv.weights is wf.conv.weights is wf.convs[1].weights
    assert wf.gds == [wf.gd_deconv]
    assert type(wf.pools[0]).__name__ == "StochasticAbsPooling"
    with pytest.raises(ValueError, match="n_stages"):
        imagenet_ae.build(n_stages=5)


# -- kanji's loader -----------------------------------------------------------

def test_kanji_loader_serves_the_jax_targets(tmp_path, kanji_data):
    jdir = jax_kanji.materialize_synthetic(str(tmp_path / "jax"))
    for sub in ("target/glyph00.png", "train/glyph03/007.png"):
        with open(os.path.join(jdir, sub), "rb") as f:
            want = f.read()
        with open(os.path.join(kanji_data, sub), "rb") as f:
            assert f.read() == want
    loaders = {}
    for key, module, dev in (("jax", jax_kanji, JaxDevice()),
                             ("torch", kanji, "cpu")):
        for p in (prng, jax_prng):
            p.get(2).seed(5678)
        wf = module.build(**_config("kanji", tmp_path, kanji_data))
        wf.loader.initialize(device=dev)
        loaders[key] = wf.loader
    got, want = loaders["torch"], loaders["jax"]
    assert got.class_lengths == list(want.class_lengths)
    assert got.targets_shape == want.targets_shape == (24, 24)
    for attr in ("original_data", "original_targets", "class_targets"):
        assert numpy.array_equal(getattr(got, attr).mem,
                                 numpy.asarray(getattr(want, attr).mem))
    assert list(got.original_labels) == list(want.original_labels)
    # the class targets lie in the targets' normalized space
    assert got.class_targets.mem.min() == got.original_targets.mem.min()


def test_approximator_reads_the_npy_pair(tmp_path):
    """With ``dataset_file`` and ``targets_file`` present the loader
    reads them (a quarter VALID); a count mismatch raises."""
    r = numpy.random.RandomState(2)
    x, y = r.uniform(-1, 1, (40, 10)), r.uniform(-1, 1, (40, 3))
    paths = {k: str(tmp_path / (k + ".npy")) for k in ("x", "y", "bad")}
    numpy.save(paths["x"], x)
    numpy.save(paths["y"], y)
    numpy.save(paths["bad"], y[:39])
    wf = approximator.build(
        loader_config={"dataset_file": paths["x"],
                       "targets_file": paths["y"], "minibatch_size": 10},
        snapshotter_config={"directory": str(tmp_path)})
    wf.loader.initialize(device="cpu")
    assert wf.loader.class_lengths == [0, 10, 30]
    assert wf.loader.targets_shape == (3,)
    wf = approximator.build(
        loader_config={"dataset_file": paths["x"],
                       "targets_file": paths["bad"]},
        snapshotter_config={"directory": str(tmp_path)})
    with pytest.raises(ValueError, match="targets"):
        wf.loader.initialize(device="cpu")


def test_video_ae_published_frames():
    """``frame_shape`` sets the frames (the published 90x160); the
    targets are the frames, flattened."""
    wf = video_ae.build(loader_config={"frame_shape": (90, 160),
                                       "n_frames": 20})
    wf.loader.initialize(device="cpu")
    assert wf.loader.original_data.shape == (20, 90, 160)
    assert wf.loader.targets_shape == (90 * 160,)
    assert wf.loader.class_lengths == [0, 4, 16]


# -- the launcher -------------------------------------------------------------

SAMPLES = {"research.imagenet_ae": (imagenet_ae, "imagenet_ae"),
           "research.video_ae": (video_ae, "video_ae"),
           "approximator": (approximator, "approximator"),
           "kanji": (kanji, "kanji")}


def _argv(name, tmp_path, kanji_dir):
    ns = SAMPLES[name][1]
    argv = [name, "--config", "%s.decision.max_epochs=1" % ns,
            "--config", "%s.snapshotter.directory=%s" % (ns, tmp_path)]
    if name == "kanji":
        argv += ["--config", "kanji.loader.train_paths=['%s/train']"
                 % kanji_dir,
                 "--config", "kanji.loader.target_paths=['%s/target']"
                 % kanji_dir]
    return argv


def _sample_config(ns):
    node = getattr(root, ns)
    return _restored(node, node.loader, node.decision, node.snapshotter)


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_names_resolve_and_list(name, capsys):
    assert launcher.resolve_workflow_module(name) is SAMPLES[name][0]
    assert cli.main(["--list"]) == 0
    assert name in capsys.readouterr().out.split()


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_cli_trains_on_cpu_and_needs_cuda_otherwise(name, tmp_path,
                                                    monkeypatch, kanji_data):
    ns = SAMPLES[name][1]
    with _sample_config(ns):
        assert cli.main(_argv(name, tmp_path, kanji_data) +
                        ["--device", "cpu"]) == 0
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(_argv(name, tmp_path, kanji_data) + ["--dry-run"])
    assert any(f.startswith(ns) for f in os.listdir(tmp_path))


def test_cli_grows_imagenet_ae(tmp_path):
    """``--config imagenet_ae.n_stages=2`` with the stage-1 snapshot as
    ``restore_snapshot`` grows the ladder through the CLI: the stage-2
    snapshot holds both convs, the first as the stage-1 run left it."""
    from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
    with _restored(root.imagenet_ae, root.imagenet_ae.decision,
                   root.imagenet_ae.snapshotter):
        argv = _argv("research.imagenet_ae", tmp_path / "s1", None)
        assert cli.main(argv + ["--device", "cpu"]) == 0
        snap = _newest(tmp_path / "s1")
        argv = _argv("research.imagenet_ae", tmp_path / "s2", None) + [
            "--config", "imagenet_ae.n_stages=2",
            "--config", "imagenet_ae.restore_snapshot=%s" % snap]
        assert cli.main(argv + ["--device", "cpu"]) == 0
    first = SnapshotterToFile.import_(snap)["units"]
    grown = SnapshotterToFile.import_(_newest(tmp_path / "s2"))["units"]
    assert "conv1" not in first and "conv1" in grown
    assert numpy.array_equal(grown["conv0"]["weights"],
                             first["conv0"]["weights"])
