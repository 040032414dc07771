"""The port's ``imagenet_loader_base`` and ``full_batch_pickles_image``
loaders (``loader/{imagenet_loader,pickles}.py``) against the JAX
package's, on the CPU, on files the tests write.

* ImagenetLoaderBase: the class lengths, ``mean`` / ``rdisp`` and every
  minibatch (class, indices, uint8 bytes, labels) over 2 epochs equal
  to JAX's from the same prng seeds; each of its ``OSError`` /
  ``ValueError`` checks (JAX :58-119) fires on a damaged file set, in
  both packages alike; ``stop`` closes ``samples.dat``, which the
  loader's workflow calls when its run returns, and a later fill opens
  it again.
* PicklesImageFullBatchLoader: CIFAR batch dicts and raw arrays, CHW
  rows served HWC, the per-split fallback labels of unlabeled pickles
  (JAX ``tests/unit/test_loaders.py:290-400``): data, labels and the
  served minibatches equal JAX's.  A known difference: with a
  normalization, the port's CHW rows are normalized (JAX's normalizer
  writes to a reshaped copy of its transposed rows and leaves them as
  read).
* Importing ``znicz_tpu_torch.loader`` registers the loaders by their
  JAX names.
"""

import json
import os
import pickle

import numpy
import pytest

from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.workflow import Workflow as JaxWorkflow
from znicz_tpu.loader.base import UserLoaderRegistry as JaxRegistry
import znicz_tpu.loader  # noqa: F401 (registers the JAX loaders)
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.loader.base import UserLoaderRegistry
from znicz_tpu_torch.loader.imagenet_loader import ImagenetLoaderBase
from znicz_tpu_torch.loader.pickles import PicklesImageFullBatchLoader

SY, SX = 12, 10
COUNTS = {"test": 2, "val": 5, "train": 13}


def _bits_equal(a, b):
    a, b = numpy.ascontiguousarray(a), numpy.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        numpy.array_equal(a.view(numpy.uint8), b.view(numpy.uint8))


def _imagenet_files(directory, counts=COUNTS, seed=3):
    """samples.dat, labels.pickle, count.json and matrixes.pickle;
    returns (samples, int labels, paths)."""
    n = sum(counts.values())
    r = numpy.random.RandomState(seed)
    samples = r.randint(0, 256, (n, SY, SX, 3), dtype=numpy.uint8)
    labels = r.randint(0, 4, n)
    paths = {k: os.path.join(directory, f) for k, f in (
        ("samples_filename", "samples.dat"),
        ("original_labels_filename", "labels.pickle"),
        ("count_samples_filename", "count.json"),
        ("matrixes_filename", "matrixes.pickle"))}
    samples.tofile(paths["samples_filename"])
    with open(paths["original_labels_filename"], "wb") as f:
        pickle.dump([("class_%d" % v, int(v)) for v in labels], f)
    with open(paths["count_samples_filename"], "w") as f:
        json.dump(counts, f)
    flat = samples.reshape(n, -1).astype(numpy.float64)
    with open(paths["matrixes_filename"], "wb") as f:
        pickle.dump([flat.mean(axis=0).reshape(SY, SX, 3),
                     (1.0 / (flat.std(axis=0) + 1.0)).reshape(SY, SX, 3)],
                    f)
    return samples, labels, paths


def _pair(mapping, **kwargs):
    jax_prng.get(2).seed(5678)
    prng.get(2).seed(5678)
    j = JaxRegistry.get_factory(mapping)(JaxWorkflow(None), **kwargs)
    t = UserLoaderRegistry.get_factory(mapping)(Workflow(None), **kwargs)
    return j, t


def _served(loader, n):
    out = []
    for _ in range(n):
        loader.run()
        size = loader.minibatch_size
        out.append((loader.minibatch_class, size,
                    numpy.array(loader.minibatch_indices.mem[:size]),
                    numpy.array(loader.minibatch_data.mem[:size]),
                    numpy.array(loader.minibatch_labels.mem[:size])))
    return out


def _same_served(t, j, n):
    for (tc, ts, ti, td, tl), (jc, js, ji, jd, jl) in zip(_served(t, n),
                                                           _served(j, n)):
        assert (tc, ts) == (jc, js)
        assert numpy.array_equal(ti, ji) and numpy.array_equal(tl, jl)
        assert _bits_equal(td, jd)


def test_registered_by_the_jax_names():
    import znicz_tpu_torch.loader  # noqa: F401
    for name in ("lmdb", "full_batch_lmdb", "imagenet_loader_base",
                 "full_batch_pickles_image", "full_batch_stl_10",
                 "interactive", "minibatches"):
        assert UserLoaderRegistry.get_factory(name).__name__ == \
            JaxRegistry.get_factory(name).__name__


@pytest.mark.parametrize("minibatch_size", [4, 13])
def test_imagenet_loader_serves_the_jax_minibatches(tmp_path,
                                                    minibatch_size):
    samples, labels, paths = _imagenet_files(str(tmp_path))
    j, t = _pair("imagenet_loader_base", sy=SY, sx=SX,
                 minibatch_size=minibatch_size, **paths)
    j.initialize()
    t.initialize(device="cpu")
    assert t.class_lengths == list(j.class_lengths) == [2, 5, 13]
    assert t.has_mean_file and j.has_mean_file
    assert _bits_equal(t.mean.mem, j.mean.mem)
    assert _bits_equal(t.rdisp.mem, j.rdisp.mem)
    assert t.rdisp.mem.dtype == numpy.float32
    assert t.labels_mapping == j.labels_mapping
    assert numpy.array_equal(t.original_labels, j.original_labels)
    assert t.minibatch_data.dtype == numpy.uint8
    per_epoch = sum(-(-c // minibatch_size) for c in COUNTS.values())
    _same_served(t, j, 2 * per_epoch)
    assert t.epoch_number == j.epoch_number == 2
    # the rows are samples.dat's at the indices, the labels the pickle's
    t.run()
    n = t.minibatch_size
    idx = t.minibatch_indices.mem[:n]
    assert numpy.array_equal(t.minibatch_data.mem[:n], samples[idx])
    assert numpy.array_equal(t.minibatch_labels.mem[:n], labels[idx])
    t.stop()
    j.stop()


def _damage(paths, what):
    """Break one file of the set the way ``what`` says."""
    if what.startswith("missing "):
        os.remove(paths[what.split(" ", 1)[1]])
        return
    if what == "labels count":
        with open(paths["original_labels_filename"], "rb") as f:
            labels = pickle.load(f)
        with open(paths["original_labels_filename"], "wb") as f:
            pickle.dump(labels[:-1], f)
    elif what == "samples size":
        with open(paths["samples_filename"], "ab") as f:
            f.write(bytes(SY * SX * 3))
    else:
        with open(paths["matrixes_filename"], "rb") as f:
            mean, rdisp = pickle.load(f)
        if what == "rdisp nan":
            rdisp[0, 0, 0] = numpy.nan
        elif what == "rdisp inf":
            rdisp[1, 2, 0] = numpy.inf
        elif what == "shapes differ":
            rdisp = rdisp[:, :-1]
        elif what == "mean shape":
            mean, rdisp = mean[:-1], rdisp[:-1]
        with open(paths["matrixes_filename"], "wb") as f:
            pickle.dump([mean, rdisp], f)


@pytest.mark.parametrize("what,error,match", [
    ("missing original_labels_filename", OSError, "original_labels_filename"),
    ("missing count_samples_filename", OSError, "count_samples_filename"),
    ("missing samples_filename", OSError, "samples_filename"),
    ("missing matrixes_filename", OSError, "matrixes_filename"),
    ("labels count", ValueError, "number of labels"),
    ("samples size", ValueError, "wrong samples.dat size"),
    ("rdisp nan", ValueError, "NaNs"),
    ("rdisp inf", ValueError, "Infs"),
    ("shapes differ", ValueError, r"mean.shape != rdisp.shape"),
    ("mean shape", ValueError, r"mean.shape != \(12, 10\)"),
])
def test_imagenet_loader_checks_fire_as_in_jax(tmp_path, what, error,
                                               match):
    _, _, paths = _imagenet_files(str(tmp_path))
    _damage(paths, what)
    j, t = _pair("imagenet_loader_base", sy=SY, sx=SX, minibatch_size=4,
                 **paths)
    with pytest.raises(error, match=match):
        j.initialize()
    with pytest.raises(error, match=match):
        t.initialize(device="cpu")
    for loader in (j, t):
        loader.stop()


def test_imagenet_loader_closes_its_file_when_the_run_returns(tmp_path):
    samples, _, paths = _imagenet_files(str(tmp_path))
    wf = Workflow(None)
    t = ImagenetLoaderBase(wf, sy=SY, sx=SX, minibatch_size=4, **paths)
    t.link_from(wf.start_point)
    wf.end_point.link_from(t)
    t.initialize(device="cpu")
    assert t._file_samples is not None
    wf.run()
    assert t._file_samples is None        # closed by the run's end
    first = numpy.array(t.minibatch_data.mem[:t.minibatch_size])
    idx = t.minibatch_indices.mem[:t.minibatch_size]
    assert numpy.array_equal(first, samples[idx])
    wf.run()                              # a later run opens it again
    idx = t.minibatch_indices.mem[:t.minibatch_size]
    assert numpy.array_equal(t.minibatch_data.mem[:t.minibatch_size],
                             samples[idx])
    assert t._file_samples is None


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


def test_pickles_loader_dicts_and_raw_arrays_as_jax(tmp_path):
    """JAX's ``test_pickles_image_loader``, both packages."""
    r = numpy.random.RandomState(3)
    train = {b"data": r.randint(0, 256, (20, 3 * 8 * 8), numpy.uint8),
             b"labels": list(numpy.arange(20) % 4)}
    valid = r.randint(0, 256, (6, 3 * 8 * 8)).astype(numpy.uint8)
    kwargs = dict(train_pickles=[_dump(tmp_path / "data_batch_1", train)],
                  validation_pickles=[_dump(tmp_path / "valid", valid)],
                  image_shape=(3, 8, 8), minibatch_size=5)
    j, t = _pair("full_batch_pickles_image", **kwargs)
    assert type(t) is PicklesImageFullBatchLoader
    j.initialize()
    t.initialize(device="cpu")
    assert t.class_lengths == list(j.class_lengths) == [0, 6, 20]
    assert t.original_data.shape == (26, 8, 8, 3)
    assert _bits_equal(t.original_data.mem, j.original_data.mem)
    assert list(t.original_labels) == list(j.original_labels)
    want = valid[0].reshape(3, 8, 8).transpose(1, 2, 0)
    assert numpy.array_equal(t.original_data.mem[0], want)
    _same_served(t, j, 12)


@pytest.mark.parametrize("normalization", ["none", "linear"])
def test_pickles_loader_per_split_fallback_labels_as_jax(tmp_path,
                                                         normalization):
    """JAX's ``test_pickles_per_split_fallback_labels``: unlabeled
    pickles take their position within their class list, counted from
    0 again in each class."""
    r = numpy.random.RandomState(1)

    def dump(name):
        return _dump(tmp_path / name, r.randint(
            0, 256, (4, 3 * 8 * 8)).astype(numpy.uint8))
    kwargs = dict(validation_pickles=[dump("cat_v"), dump("dog_v")],
                  train_pickles=[dump("cat_t"), dump("dog_t")],
                  test_pickles=[dump("bird_test")],
                  image_shape=(3, 8, 8), minibatch_size=4,
                  normalization_type=normalization)
    j, t = _pair("full_batch_pickles_image", **kwargs)
    j.initialize()
    t.initialize(device="cpu")
    assert list(t.original_labels) == list(j.original_labels) == \
        [0] * 4 + [0] * 4 + [1] * 4 + [0] * 4 + [1] * 4
    if normalization == "none":
        assert _bits_equal(t.original_data.mem, j.original_data.mem)
        _same_served(t, j, 10)
        return
    # a known difference: JAX's rows stay in the transposed view's order
    # and its normalizer writes to a reshaped copy, so they stay as read;
    # the port's are normalized, with JAX's fitted normalizer
    raw = numpy.array(j.original_data.mem)
    assert raw.min() == 0 and raw.max() == 255
    assert t.normalizer.state == j.normalizer.state
    want = numpy.ascontiguousarray(raw)
    j.normalizer.normalize(want.reshape(len(want), -1))
    assert want.min() == -1 and want.max() == 1
    assert _bits_equal(t.original_data.mem, want)


def test_pickles_loader_without_pickles_raises():
    t = PicklesImageFullBatchLoader(Workflow(None))
    with pytest.raises(ValueError, match="no pickles configured"):
        t.initialize(device="cpu")
