"""The port's Caffe codec, native LMDB and LMDB loaders
(``loader/{caffe,lmdb_native,loader_lmdb}.py``) against the JAX
package's, on the CPU, on files the tests write.

* ``Datum`` / ``BlobProto``: the same fields give the same bytes in
  either package, and each package decodes the other's.
* ``write_lmdb``: byte-equal databases from the same items; each
  package's ``LMDBReader`` reads the other's, branch pages and overflow
  chains included (JAX ``tests/unit/test_loaders.py:82``).
* ``lmdb`` and ``full_batch_lmdb`` over Caffe databases (CHW Datums):
  the same minibatches (class, size, indices, bytes, labels) over 2
  epochs from the same prng seeds, with ``normalization_type`` none and
  linear, bit for bit.  ``lmdb`` is installed nowhere the port runs, so
  both packages read through their native readers.
"""

import numpy
import pytest

from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.workflow import Workflow as JaxWorkflow
from znicz_tpu.loader import caffe as jax_caffe
from znicz_tpu.loader import lmdb_native as jax_lmdb
from znicz_tpu.loader.base import UserLoaderRegistry as JaxRegistry
import znicz_tpu.loader.loader_lmdb  # noqa: F401 (registers the JAX loaders)
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.loader import caffe, lmdb_native
from znicz_tpu_torch.loader.base import UserLoaderRegistry
from znicz_tpu_torch.loader.loader_lmdb import FullBatchLMDBLoader, \
    LMDBLoader

DATUMS = [
    {"channels": 3, "height": 4, "width": 5, "data": bytes(range(60)),
     "label": 7, "float_data": [1.5, -2.25]},
    {"channels": 1, "height": 2, "width": 2, "data": b"\x00\xff\x10\x80",
     "label": 0},
    {"label": -3, "float_data": [0.125] * 9},
    {"channels": 3, "height": 300, "width": 1, "data": bytes(900),
     "label": 2 ** 30},
]


def _bits_equal(a, b):
    a, b = numpy.ascontiguousarray(a), numpy.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        numpy.array_equal(a.view(numpy.uint8), b.view(numpy.uint8))


def _datum_fields(d):
    return (d.channels, d.height, d.width, d.data, d.label,
            list(d.float_data))


@pytest.mark.parametrize("fields", DATUMS)
def test_datum_bytes_equal_jax_and_decode_both_ways(fields):
    mine = caffe.Datum(**fields).SerializeToString()
    theirs = jax_caffe.Datum(**fields).SerializeToString()
    assert mine == theirs
    assert _datum_fields(caffe.Datum().ParseFromString(theirs)) == \
        _datum_fields(jax_caffe.Datum().ParseFromString(mine))
    assert _datum_fields(caffe.Datum().ParseFromString(mine)) == (
        fields.get("channels", 0), fields.get("height", 0),
        fields.get("width", 0), fields.get("data", b""),
        fields.get("label", 0), list(fields.get("float_data", [])))


@pytest.mark.parametrize("data", [[0.5, 1.0, -1.0, 2.0], [], [3.25] * 600])
def test_blobproto_bytes_equal_jax_and_decode_both_ways(data):
    blobs = []
    for mod in (caffe, jax_caffe):
        b = mod.BlobProto()
        b.num, b.channels, b.height, b.width = 1, 3, 2, 2
        b.data = list(data)
        b.diff = [-x for x in data[:3]]
        blobs.append(b.SerializeToString())
    assert blobs[0] == blobs[1]
    mine = caffe.BlobProto().ParseFromString(blobs[1])
    theirs = jax_caffe.BlobProto().ParseFromString(blobs[0])
    for b in (mine, theirs):
        assert (b.num, b.channels, b.height, b.width) == (1, 3, 2, 2)
        assert b.data == list(data) and b.diff == [-x for x in data[:3]]


def _items(n, big):
    items = [(b"k%04d" % i, bytes([i % 251]) * (40 + 113 * (i % 9)))
             for i in range(n)]
    if big:
        items.append((b"zz_big", b"\xAB" * 30000))  # an overflow chain
    return items


@pytest.mark.parametrize("n,big", [(0, False), (3, False), (400, True),
                                   (1500, True)])
def test_write_lmdb_bytes_equal_and_readers_read_each_other(tmp_path, n,
                                                            big):
    items = _items(n, big)
    mine = lmdb_native.write_lmdb(str(tmp_path / "torch"), items)
    theirs = jax_lmdb.write_lmdb(str(tmp_path / "jax"), items)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    for reader, path in ((lmdb_native.LMDBReader, theirs),
                         (jax_lmdb.LMDBReader, mine)):
        r = reader(path)
        assert r.entries == len(items)
        assert list(r.items()) == sorted(items)
        for key, value in items[::37]:
            assert r.get(key) == value
        assert r.get(b"missing") is None
    if big:
        assert lmdb_native.LMDBReader(theirs).get(b"zz_big") == \
            b"\xAB" * 30000


def test_native_reader_refuses_a_file_without_meta(tmp_path):
    path = str(tmp_path / "data.mdb")
    with open(path, "wb") as f:
        f.write(bytes(3 * lmdb_native.PAGESIZE))
    with pytest.raises(lmdb_native.LMDBError, match="no valid LMDB meta"):
        lmdb_native.LMDBReader(path)


def _caffe_db(path, n, seed, size=(3, 6, 5)):
    """A Caffe database of ``n`` CHW uint8 Datums (labels 0-3)."""
    r = numpy.random.RandomState(seed)
    items = []
    for i in range(n):
        img = r.randint(0, 256, size, dtype=numpy.uint8)
        items.append((b"%08d" % i, caffe.Datum(
            channels=size[0], height=size[1], width=size[2],
            data=img.tobytes(), label=int(r.randint(4))).SerializeToString()))
    lmdb_native.write_lmdb(path, items)


def _served(loader, n):
    out = []
    for _ in range(n):
        loader.run()
        size = loader.minibatch_size
        out.append((loader.minibatch_class, size,
                    numpy.array(loader.minibatch_indices.mem[:size]),
                    numpy.array(loader.minibatch_data.mem[:size]),
                    numpy.array(loader.minibatch_labels.mem[:size]),
                    bool(loader.epoch_ended)))
    return out


@pytest.mark.parametrize("mapping,cls", [("lmdb", LMDBLoader),
                                         ("full_batch_lmdb",
                                          FullBatchLMDBLoader)])
@pytest.mark.parametrize("normalization", ["none", "linear"])
def test_lmdb_loaders_serve_the_jax_minibatches(tmp_path, mapping, cls,
                                                normalization):
    _caffe_db(str(tmp_path / "train"), 22, seed=1)
    _caffe_db(str(tmp_path / "valid"), 7, seed=2)
    _caffe_db(str(tmp_path / "test"), 3, seed=3)
    kwargs = dict(train_path=str(tmp_path / "train"),
                  validation_path=str(tmp_path / "valid"),
                  test_path=str(tmp_path / "test"), minibatch_size=4,
                  normalization_type=normalization)
    jax_prng.get(2).seed(5678)
    prng.get(2).seed(5678)
    j = JaxRegistry.get_factory(mapping)(JaxWorkflow(None), **kwargs)
    t = UserLoaderRegistry.get_factory(mapping)(Workflow(None), **kwargs)
    assert type(t) is cls
    j.initialize()
    t.initialize(device="cpu")
    assert t.class_lengths == list(j.class_lengths) == [3, 7, 22]
    assert t.unique_labels_count == j.unique_labels_count
    # 2 epochs: 1 TEST, 2 VALID and 6 TRAIN minibatches an epoch
    got, want = _served(t, 18), _served(j, 18)
    assert [g[5] for g in got].count(True) == 2
    for (tc, ts, ti, td, tl, te), (jc, js, ji, jd, jl, je) in zip(got, want):
        assert (tc, ts, te) == (jc, js, je)
        assert numpy.array_equal(ti, ji) and numpy.array_equal(tl, jl)
        assert _bits_equal(td, jd)
    if mapping == "full_batch_lmdb":
        assert _bits_equal(t.original_data.mem, j.original_data.mem)
    else:
        # the Datum cache: each served row is one lookup
        assert (t.cache_hits, t.cache_misses) == (j.cache_hits,
                                                  j.cache_misses)


def test_lmdb_loader_decodes_chw_datums_to_hwc(tmp_path):
    r = numpy.random.RandomState(9)
    chw = r.randint(0, 256, (5, 3, 4, 6), dtype=numpy.uint8)
    lmdb_native.write_lmdb(str(tmp_path / "train"), [
        (b"%08d" % i, caffe.Datum(channels=3, height=4, width=6,
                                  data=chw[i].tobytes(),
                                  label=i).SerializeToString())
        for i in range(5)])
    t = LMDBLoader(Workflow(None), train_path=str(tmp_path / "train"),
                   minibatch_size=5)
    t.initialize(device="cpu")
    t.run()
    idx = t.minibatch_indices.mem[:5]
    assert numpy.array_equal(t.minibatch_data.mem[:5],
                             chw[idx].transpose(0, 2, 3, 1))
    assert numpy.array_equal(t.minibatch_labels.mem[:5], idx)


def test_lmdb_loader_without_paths_raises():
    t = LMDBLoader(Workflow(None))
    with pytest.raises(OSError, match="no LMDB paths"):
        t.initialize(device="cpu")
