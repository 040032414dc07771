"""The Caffe LMDB loaders: ``lmdb`` (streaming) and ``full_batch_lmdb``.

Counterpart of ``znicz_tpu/loader/loader_lmdb.py``: Caffe intermediate
databases whose values are serialized ``Datum`` records, keyed in
iteration order, read through the ``lmdb`` package where it imports
and through the port's pure-Python reader
(:mod:`znicz_tpu_torch.loader.lmdb_native`) otherwise (JAX :22-40).

kwargs, as JAX's: ``test_path`` / ``validation_path`` / ``train_path``
(a database directory for each class), ``db_shape`` (H, W, C) for
records whose Datum carries no geometry, ``db_splitted_channels``
(CHW record bytes, Caffe's layout, against HWC), ``db_colorspace``
and ``use_cache``.  Images are served HWC, as floats, through
:class:`~znicz_tpu_torch.loader.image.ImageLoaderBase`.
"""

import numpy

from znicz_tpu_torch.loader.caffe import Datum
from znicz_tpu_torch.loader.image import (FullBatchImageLoader,
                                         IImageLoader, ImageLoaderBase)


def _open_db(path):
    try:
        import lmdb
    except ImportError:
        from znicz_tpu_torch.loader.lmdb_native import LMDBReader
        return LMDBReader(path)
    env = lmdb.open(path, readonly=True, lock=False)

    class _Env(object):
        def items(self):
            with env.begin() as txn:
                with txn.cursor() as cur:
                    yield from iter(cur)

        def get(self, key):
            with env.begin() as txn:
                return txn.get(key)

    return _Env()


class LMDBLoader(ImageLoaderBase, IImageLoader):
    MAPPING = "lmdb"

    def __init__(self, workflow, **kwargs):
        super(LMDBLoader, self).__init__(workflow, **kwargs)
        self._files = (kwargs.get("test_path"),
                       kwargs.get("validation_path"),
                       kwargs.get("train_path"))
        self.original_shape = tuple(kwargs.get("db_shape", (256, 256, 3)))
        self.db_color_space = kwargs.get("db_colorspace", "RGB")
        self.db_splitted_channels = kwargs.get("db_splitted_channels", True)
        self.use_cache = kwargs.get("use_cache", True)
        self._dbs = [None] * 3
        self._cache = (None, None)
        self._cache_hits = 0
        self._cache_misses = 0
        self._labels_by_key = {}

    @property
    def files(self):
        return self._files

    @property
    def cache_hits(self):
        return self._cache_hits

    @property
    def cache_misses(self):
        return self._cache_misses

    def _db(self, index):
        if self._dbs[index] is None:
            if self._files == (None, None, None):
                raise OSError(
                    "no LMDB paths: pass test_path/validation_path/"
                    "train_path")
            path = self._files[index]
            if not path:
                return None
            self._dbs[index] = _open_db(path)
        return self._dbs[index]

    # -- Datum access -------------------------------------------------------
    def get_datum(self, key):
        index, dkey = key
        datum = Datum()
        datum.ParseFromString(self._db(index).get(dkey))
        self._cache = (key, datum)
        return datum

    def get_cached_data(self, key):
        if self.use_cache:
            if key != self._cache[0]:
                self._cache_misses += 1
                return self.get_datum(key)
            self._cache_hits += 1
            return self._cache[1]
        return self.get_datum(key)

    # -- ImageLoader contract -----------------------------------------------
    def get_keys(self, index):
        db = self._db(index)
        if db is None:
            return []
        # capture labels during the sweep: each value is already in hand,
        # saving the label pre-scan's N point lookups + Datum re-parses
        keys = []
        for k, v in db.items():
            key = (index, k)
            keys.append(key)
            self._labels_by_key[key] = Datum().ParseFromString(v).label
        return keys

    def get_image_label(self, key):
        label = self._labels_by_key.get(key)
        if label is not None:
            return label
        return self.get_cached_data(key).label

    def get_image_info(self, key):
        datum = self.get_cached_data(key)
        return (datum.height, datum.width), self.db_color_space

    def get_image_data(self, key):
        datum = self.get_cached_data(key)
        if datum.data:
            img = numpy.frombuffer(datum.data, dtype=numpy.uint8)
        else:
            img = numpy.asarray(datum.float_data, dtype=numpy.float32)
        if datum.height and datum.width:
            shape = (datum.height, datum.width,
                     datum.channels or self.original_shape[-1])
        else:
            shape = self.original_shape
        if self.db_splitted_channels:
            # Caffe CHW record -> HWC
            img = numpy.transpose(
                img.reshape((shape[-1],) + shape[:-1]), (1, 2, 0))
        else:
            img = img.reshape(shape)
        return img


class FullBatchLMDBLoader(FullBatchImageLoader, LMDBLoader):
    """Whole LMDB decoded up front (for sets that fit in host RAM)."""

    MAPPING = "full_batch_lmdb"
