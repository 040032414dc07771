"""The port's image and Wine loaders (``loader/image.py``,
``loader/loader_stl.py``, ``loader/loader_wine.py``) against the JAX
package's, on the same files, on the CPU.

* STL-10 (``full_batch_stl_10``): the CHW bytes served HWC as the JAX
  loader serves them, the 1-based labels mapped through
  ``class_names.txt``, the test split as VALID; data, labels,
  ``labels_mapping``, the ``internal_mean`` rows and the served
  minibatches bit-equal.  The synthetic writer writes the JAX writer's
  bytes.
* The auto-label loaders, full-batch and streaming, with
  ``validation_ratio``: the same VALID / TRAIN split (one
  ``permutation`` of the loader's stream, drawn before any shuffle),
  the same rows in the same order, labels and mapping.  The streaming
  loader's normalizer, fitted on at most ``normalizer_analysis_limit``
  TRAIN images, normalizes each minibatch as the JAX loader does.
* The file-list loaders with ``scale`` (PIL bilinear, a channel at a
  time): the same rescaled rows; a line without a label takes its
  directory's name.
* Wine: the same rows and 0-based labels, pointwise normalization
  whatever the caller asks; an absent file is written from
  scikit-learn's copy as the JAX loader writes it, byte for byte; the
  ``testing`` mode serves every row as TEST, as the JAX loader does.
* Importing the image loaders and training STL-10 imports no PIL.
"""

import os
import subprocess
import sys

import numpy
import pytest
import torch

from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.workflow import Workflow as JaxWorkflow
from znicz_tpu.loader.base import UserLoaderRegistry as JaxRegistry
from znicz_tpu.samples.research import stl10 as jax_stl10
import znicz_tpu.loader.image  # noqa: F401 (registers the JAX loaders)
import znicz_tpu.loader.loader_stl  # noqa: F401
import znicz_tpu.loader.loader_wine  # noqa: F401
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.loader.base import TEST, TRAIN, VALID, \
    UserLoaderRegistry
from znicz_tpu_torch.loader import image, loader_wine
from znicz_tpu_torch.samples.research import stl10
import znicz_tpu_torch.loader.loader_stl  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits_equal(a, b):
    a, b = numpy.ascontiguousarray(a), numpy.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        numpy.array_equal(a.view(numpy.uint8), b.view(numpy.uint8))


def _pair(mapping, **kwargs):
    """The JAX and the port loader of ``mapping``, each initialized
    from its package's stream 2 seeded alike."""
    jax_prng.get(2).seed(5678)
    prng.get(2).seed(5678)
    j = JaxRegistry.get_factory(mapping)(JaxWorkflow(None), **kwargs)
    t = UserLoaderRegistry.get_factory(mapping)(Workflow(None), **kwargs)
    j.initialize()
    t.initialize(device="cpu")
    return j, t


def _served(loader, n):
    """``n`` minibatches: (class, size, indices, data, labels)."""
    out = []
    for _ in range(n):
        loader.run()
        size = loader.minibatch_size
        out.append((loader.minibatch_class, size,
                    numpy.array(loader.minibatch_indices.mem[:size]),
                    numpy.array(loader.minibatch_data.mem[:size]),
                    numpy.array(loader.minibatch_labels.mem[:size])))
    return out


def _same_loaders(j, t, n_served):
    assert t.class_lengths == list(j.class_lengths)
    assert t.labels_mapping == j.labels_mapping
    assert t.unique_labels_count == j.unique_labels_count
    for clazz in (TEST, VALID, TRAIN):
        assert t._keys[clazz] == j._keys[clazz]
    for (tc, ts, ti, td, tl), (jc, js, ji, jd, jl) in zip(
            _served(t, n_served), _served(j, n_served)):
        assert (tc, ts) == (jc, js)
        assert numpy.array_equal(ti, ji) and numpy.array_equal(tl, jl)
        assert _bits_equal(td, jd)


# -- STL-10 ---------------------------------------------------------------

def test_synthetic_stl10_writes_the_jax_bytes(tmp_path):
    for mod, sub in ((jax_stl10, "jax"), (stl10, "torch")):
        mod.materialize_synthetic(str(tmp_path / sub), n_train=12,
                                  n_valid=5, size=96)
    for name in ("class_names.txt", "train_X.bin", "train_y.bin",
                 "test_X.bin", "test_y.bin"):
        with open(str(tmp_path / "jax" / name), "rb") as f:
            want = f.read()
        with open(str(tmp_path / "torch" / name), "rb") as f:
            assert f.read() == want, name
    # a directory that holds a set is left as it is
    assert stl10.materialize_synthetic(str(tmp_path / "torch"),
                                       n_train=1) == str(tmp_path / "torch")
    assert os.path.getsize(str(tmp_path / "torch" / "train_y.bin")) == 12


def test_stl10_loader_serves_the_jax_rows(tmp_path):
    directory = stl10.materialize_synthetic(str(tmp_path / "stl"),
                                            n_train=13, n_valid=6)
    j, t = _pair("full_batch_stl_10", directory=directory,
                 minibatch_size=4, normalization_type="internal_mean")
    assert t.class_lengths == [0, 6, 13]
    assert t.labels_mapping == {"airplane": 0, "bird": 1, "car": 2,
                                "cat": 3}
    assert t.original_labels == list(j.original_labels)
    assert t.original_labels[:6] == [0, 1, 2, 3, 0, 1]
    assert t.original_data.shape == (19, 96, 96, 3)
    # internal_mean fitted on the TRAIN rows and applied to all
    assert _bits_equal(t.original_data.mem, j.original_data.mem)
    assert _bits_equal(t.normalizer.state["mean"],
                       j.normalizer.state["mean"])
    # the raw bytes, CHW to HWC: pixel (y, x) channel c of VALID row 2
    with open(os.path.join(directory, "test_X.bin"), "rb") as f:
        raw = numpy.frombuffer(f.read(), numpy.uint8).reshape(6, 3, 96, 96)
    row = t.get_image_data((VALID, 2))
    assert row.shape == (96, 96, 3) and row[5, 7, 1] == raw[2, 1, 5, 7]
    _same_loaders(j, t, 12)


def test_stl10_loader_refuses_bad_files(tmp_path):
    directory = stl10.materialize_synthetic(str(tmp_path / "stl"),
                                            n_train=4, n_valid=2)
    with open(os.path.join(directory, "train_y.bin"), "ab") as f:
        f.write(b"\x01")
    loader = UserLoaderRegistry.get_factory("full_batch_stl_10")(
        Workflow(None), directory=directory)
    with pytest.raises(ValueError, match="4 images != 5 labels"):
        loader.load_data()
    loader = UserLoaderRegistry.get_factory("full_batch_stl_10")(
        Workflow(None), directory=str(tmp_path / "none"))
    with pytest.raises(ValueError, match="must be a directory"):
        loader.load_data()


# -- auto-label and file-list loaders -------------------------------------

def _write_png(path, arr):
    from PIL import Image
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _image_dirs(base, shape, per_class=7, seed=5):
    r = numpy.random.RandomState(seed)
    for label in ("cats", "dogs", "owls"):
        for i in range(per_class):
            _write_png(os.path.join(base, label, "%d.png" % i),
                       r.randint(0, 256, shape, dtype=numpy.uint8))
    return base


@pytest.mark.parametrize("mapping", ["full_batch_auto_label_file_image",
                                     "auto_label_file_image"])
@pytest.mark.parametrize("norm", ["none", "linear", "mean_disp"])
def test_auto_label_loader_with_validation_ratio(tmp_path, mapping, norm):
    base = _image_dirs(str(tmp_path / "train"), (10, 12, 3))
    j, t = _pair(mapping, train_paths=[base], minibatch_size=4,
                 validation_ratio=0.3, normalization_type=norm)
    # VALID carved out of TRAIN: int(21 * 0.3) keys, the rest TRAIN
    assert t.class_lengths == [0, 6, 15]
    assert t.labels_mapping == {"cats": 0, "dogs": 1, "owls": 2}
    assert sorted(t._keys[VALID] + t._keys[TRAIN]) == sorted(
        image.AutoLabelFileImageLoader.get_keys(t, TRAIN))
    if mapping.startswith("full_batch"):
        assert _bits_equal(t.original_data.mem, j.original_data.mem)
        assert t.original_labels == list(j.original_labels)
    else:
        assert type(t.normalizer).__name__ == type(j.normalizer).__name__
    # two epochs: the TRAIN order is reshuffled from the same stream
    _same_loaders(j, t, 2 * (4 + 2))


def test_streaming_normalizer_fit_is_capped(tmp_path):
    """The streaming loader fits its normalizer on the first
    ``normalizer_analysis_limit`` TRAIN images, as the JAX loader does,
    and normalizes each minibatch with it."""
    from znicz_tpu_torch.core import normalization
    base = _image_dirs(str(tmp_path / "train"), (8, 8), per_class=4)
    j, t = _pair("auto_label_file_image", train_paths=[base],
                 minibatch_size=5, normalization_type="mean_disp",
                 normalizer_analysis_limit=3)

    def images(keys):
        return numpy.stack([t._prepare_image(t.get_image_data(k))
                            for k in keys]).reshape(len(keys), -1)
    capped = normalization.create("mean_disp")
    capped.analyze(images(t._keys[TRAIN][:3]))
    whole = normalization.create("mean_disp")
    whole.analyze(images(t._keys[TRAIN]))
    assert not numpy.array_equal(capped.state["mean"], whole.state["mean"])
    for key in capped.state:
        assert _bits_equal(t.normalizer.state[key], capped.state[key])
    served, jserved = _served(t, 1)[0][3], _served(j, 1)[0][3]
    assert served.shape == (5, 8, 8, 1) and _bits_equal(served, jserved)
    want = images([t._key_of_global_index(int(i))
                   for i in t.minibatch_indices.mem[:5]])
    capped.normalize(want)
    assert _bits_equal(served.reshape(5, -1), want)
    _same_loaders(j, t, 4)


@pytest.mark.parametrize("mapping", ["full_batch_file_list_image",
                                     "file_list_image"])
def test_file_list_loader_with_scale(tmp_path, mapping):
    r = numpy.random.RandomState(6)
    lines = []
    for i in range(5):
        # images of two sizes, all rescaled to 6x7
        shape = (9, 9, 3) if i % 2 else (11, 5, 3)
        p = str(tmp_path / ("class%d" % (i % 2)) / ("img%d.png" % i))
        _write_png(p, r.randint(0, 256, shape, dtype=numpy.uint8))
        # the last line has no label: its directory names it
        lines.append(p if i == 4 else "%s %d" % (p, i % 2))
    list_file = str(tmp_path / "train.txt")
    with open(list_file, "w") as f:
        f.write("\n".join(lines) + "\n\n")
    j, t = _pair(mapping, train_paths=list_file, scale=(6, 7),
                 minibatch_size=2)
    assert t.class_lengths == [0, 0, 5]
    assert t.labels_mapping == {"class0": 0}
    assert t.get_image_label(t._keys[TRAIN][4]) == "class0"
    if mapping.startswith("full_batch"):
        assert t.original_data.shape == (5, 6, 7, 3)
        assert _bits_equal(t.original_data.mem, j.original_data.mem)
        assert t.original_labels == list(j.original_labels)
    assert t.get_image_info(t._keys[TRAIN][0]) == ((11, 5), "RGB")
    _same_loaders(j, t, 3)


# -- Wine -----------------------------------------------------------------

def test_wine_loader_serves_the_jax_rows():
    j, t = _pair("wine_loader", minibatch_size=10,
                 normalization_type="linear")
    assert t.normalization_type == "pointwise"
    assert t.class_lengths == [0, 0, 178]
    assert t.original_data.shape == (178, 13)
    assert _bits_equal(t.original_data.mem, j.original_data.mem)
    assert t.original_labels == [int(v) for v in j.original_labels]
    assert sorted(set(t.original_labels)) == [0, 1, 2]
    assert t.unique_labels_count == 3
    for (tc, ts, ti, td, tl), (jc, js, ji, jd, jl) in zip(
            _served(t, 20), _served(j, 20)):
        assert (tc, ts) == (jc, js)
        assert numpy.array_equal(ti, ji) and numpy.array_equal(tl, jl)
        assert _bits_equal(td, jd)


def test_wine_file_is_written_as_jax_writes_it(tmp_path):
    pytest.importorskip("sklearn")
    paths = {}
    for key, registry, wf in (("jax", JaxRegistry, JaxWorkflow(None)),
                              ("torch", UserLoaderRegistry, Workflow(None))):
        paths[key] = str(tmp_path / key / "wine" / "wine.txt")
        registry.get_factory("wine_loader")(
            wf, dataset_file=paths[key]).load_data()
    with open(paths["jax"], "rb") as f:
        want = f.read()
    with open(paths["torch"], "rb") as f:
        assert f.read() == want
    with open(os.path.join(REPO, ".data", "wine", "wine.txt"), "rb") as f:
        assert f.read() == want


def test_wine_testing_mode_is_not_in_this_slice():
    """The ``testing`` mode, once left out, serves every row as TEST
    with the JAX loader's class lengths (JAX ``loader_wine.py:44-49``);
    without it every row is TRAIN."""
    path = os.path.join(REPO, ".data", "wine", "wine.txt")
    for testing in (True, False):
        got = loader_wine.WineLoader(Workflow(None), dataset_file=path,
                                     testing=testing)
        want = JaxRegistry.get_factory("wine_loader")(
            JaxWorkflow(None), dataset_file=path, testing=testing)
        got.load_data()
        want.load_data()
        assert got.class_lengths == list(want.class_lengths)
        assert got.class_lengths == ([178, 0, 0] if testing
                                     else [0, 0, 178])
        assert got.original_labels == list(want.original_labels)


# -- lazy imports ---------------------------------------------------------

def test_stl10_path_imports_no_pil(tmp_path):
    """The image loaders and the STL-10 sample import PIL only where
    an image file is read or rescaled: building and training STL-10
    does neither, so a card without PIL trains it."""
    code = (
        "import sys\n"
        "import znicz_tpu_torch.loader.image\n"
        "from znicz_tpu_torch.core.config import root\n"
        "from znicz_tpu_torch.samples.research import stl10\n"
        "d = stl10.materialize_synthetic(%r, n_train=4, n_valid=2)\n"
        "wf = stl10.build(loader_config={'directory': d,\n"
        "                                'minibatch_size': 2},\n"
        "                 decision_config={'max_epochs': 1},\n"
        "                 snapshotter_config={'directory': %r})\n"
        "wf.initialize(device='cpu')\n"
        "wf.run()\n"
        "bad = [m for m in ('PIL', 'jax', 'znicz_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n" % (str(tmp_path / "stl"), str(tmp_path / "snap")))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
