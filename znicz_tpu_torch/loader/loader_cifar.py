"""The CIFAR-10 loader.

Counterpart of ``znicz_tpu/loader/loader_cifar.py``: reads the python
pickle batches of ``cifar-10-batches-py`` (``data_path``,
``root.common.dirs.datasets``/cifar-10-batches-py by default), each
row's CHW bytes reshaped to NHWC float32 pixels, laid out [VALID
``test_batch`` 10,000 | TRAIN ``data_batch_1..5`` 50,000] and
normalized by the loader's normalizer.  Where the pickles are absent,
``synthetic`` "auto" (the default) falls back to the JAX package's
deterministic synthetic set: ten smoothed 32x32x3 prototypes plus
noise drawn from ``RandomState(20260730)``, so the port draws the JAX
package's rows bit for bit, ``synthetic_train`` / ``synthetic_valid``
rows (1000 / 250 by default).  ``synthetic=False`` requires the
pickles, ``synthetic=True`` forces the fallback.
"""

import os
import pickle

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import FullBatchLoader, TEST, TRAIN, VALID


class CifarLoader(FullBatchLoader):
    MAPPING = "cifar_loader"

    def __init__(self, workflow, **kwargs):
        super(CifarLoader, self).__init__(workflow, **kwargs)
        self.data_path = kwargs.get(
            "data_path", os.path.join(root.common.dirs.datasets,
                                      "cifar-10-batches-py"))
        self.synthetic = kwargs.get("synthetic", "auto")
        self.synthetic_train = kwargs.get("synthetic_train", 1000)
        self.synthetic_valid = kwargs.get("synthetic_valid", 250)

    def _batch_files(self):
        train = [os.path.join(self.data_path, "data_batch_%d" % i)
                 for i in range(1, 6)]
        return train, os.path.join(self.data_path, "test_batch")

    def _real_files_present(self):
        train, test = self._batch_files()
        return all(os.access(f, os.R_OK) for f in train + [test])

    @staticmethod
    def _read_batch(path):
        """``(data NHWC float32, labels int32)`` of one pickle batch."""
        with open(path, "rb") as fin:
            d = pickle.load(fin, encoding="bytes")
        data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        labels = numpy.asarray(d[b"labels"], dtype=numpy.int32)
        return data.astype(numpy.float32), labels

    def _load_real(self):
        train_files, test_file = self._batch_files()
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = 10000
        self.class_lengths[TRAIN] = 50000
        data = numpy.zeros((60000, 32, 32, 3), dtype=numpy.float32)
        labels = numpy.zeros(60000, dtype=numpy.int32)
        data[:10000], labels[:10000] = self._read_batch(test_file)
        for i, f in enumerate(train_files):
            sl = slice(10000 + i * 10000, 10000 + (i + 1) * 10000)
            data[sl], labels[sl] = self._read_batch(f)
        self.original_data.reset(data)
        self._original_labels[:] = labels.tolist()

    def _load_synthetic(self):
        """The deterministic CIFAR-like set: 10 smoothed class
        prototypes plus noise, clipped to [0, 255]."""
        n_valid, n_train = self.synthetic_valid, self.synthetic_train
        total = n_valid + n_train
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = n_valid
        self.class_lengths[TRAIN] = n_train
        r = numpy.random.RandomState(20260730)
        protos = r.uniform(0, 255, (10, 32, 32, 3)).astype(numpy.float32)
        for _ in range(2):
            protos = (protos +
                      numpy.roll(protos, 1, 1) + numpy.roll(protos, -1, 1) +
                      numpy.roll(protos, 1, 2) + numpy.roll(protos, -1, 2)
                      ) / 5.0
        labels = r.randint(0, 10, total).astype(numpy.int32)
        noise = r.normal(0, 32.0, (total, 32, 32, 3)).astype(numpy.float32)
        self.original_data.reset(numpy.clip(protos[labels] + noise, 0, 255))
        self._original_labels[:] = labels.tolist()

    def load_data(self):
        if self._real_files_present() and self.synthetic is not True:
            self.info("Loading CIFAR-10 pickles from %s", self.data_path)
            self._load_real()
        elif self.synthetic in (True, "auto"):
            self.info("CIFAR-10 pickles absent; using the deterministic "
                      "synthetic set (%d train / %d validation)",
                      self.synthetic_train, self.synthetic_valid)
            self._load_synthetic()
        else:
            raise OSError(
                "No CIFAR-10 data in %s and the synthetic set disabled; "
                "put the cifar-10-batches-py pickles there" % self.data_path)
