"""The MNIST loader.

Counterpart of ``znicz_tpu/loader/loader_mnist.py``: the IDX parser
(magic 2049 for labels, 2051 for images, big-endian headers, :44-100)
reading ``data_path`` (``root.common.dirs.datasets``/MNIST by default),
laid out [VALID 10000 | TRAIN 60000] as float32 pixels, normalized by
the loader's normalizer.  Where the files are absent, ``synthetic``
"auto" (the default) falls back to the JAX package's deterministic
synthetic set (:98-128): ten smoothed prototype blobs plus noise drawn
from ``RandomState(20260729)``, so the port draws the JAX package's
rows bit for bit, with nothing to download, ``synthetic_train`` /
``synthetic_valid`` rows (2000 / 500 by default).  ``synthetic=False``
requires the files, ``synthetic=True`` forces the fallback.
"""

import os
import struct

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import FullBatchLoader, TEST, TRAIN, VALID


class MnistLoader(FullBatchLoader):
    MAPPING = "mnist_loader"

    TEST_IMAGES = "t10k-images.idx3-ubyte"
    TEST_LABELS = "t10k-labels.idx1-ubyte"
    TRAIN_IMAGES = "train-images.idx3-ubyte"
    TRAIN_LABELS = "train-labels.idx1-ubyte"

    def __init__(self, workflow, **kwargs):
        super(MnistLoader, self).__init__(workflow, **kwargs)
        self.data_path = kwargs.get(
            "data_path", os.path.join(root.common.dirs.datasets, "MNIST"))
        self.synthetic = kwargs.get("synthetic", "auto")
        self.synthetic_train = kwargs.get("synthetic_train", 2000)
        self.synthetic_valid = kwargs.get("synthetic_valid", 500)

    # -- IDX parsing ---------------------------------------------------------
    @staticmethod
    def _load_idx_labels(path, count):
        with open(path, "rb") as fin:
            header, = struct.unpack(">i", fin.read(4))
            if header != 2049:
                raise ValueError("Wrong header in %s" % path)
            n_labels, = struct.unpack(">i", fin.read(4))
            if n_labels != count:
                raise ValueError("Wrong number of labels in %s" % path)
            arr = numpy.frombuffer(fin.read(n_labels), dtype=numpy.uint8)
            if len(arr) != n_labels:
                raise ValueError("EOF while reading labels from %s" % path)
        return arr.astype(numpy.int32)

    @staticmethod
    def _load_idx_images(path, count):
        with open(path, "rb") as fin:
            header, = struct.unpack(">i", fin.read(4))
            if header != 2051:
                raise ValueError("Wrong header in %s" % path)
            n_images, = struct.unpack(">i", fin.read(4))
            if n_images != count:
                raise ValueError("Wrong number of images in %s" % path)
            n_rows, n_cols = struct.unpack(">2i", fin.read(8))
            if n_rows != 28 or n_cols != 28:
                raise ValueError("Images in %s should be 28x28" % path)
            pixels = numpy.frombuffer(
                fin.read(n_images * n_rows * n_cols), dtype=numpy.uint8)
            if len(pixels) != n_images * n_rows * n_cols:
                raise ValueError("EOF while reading images from %s" % path)
        return pixels.astype(numpy.float32).reshape(n_images, 28, 28)

    def _real_files_present(self):
        return all(os.access(os.path.join(self.data_path, f), os.R_OK)
                   for f in (self.TEST_IMAGES, self.TEST_LABELS,
                             self.TRAIN_IMAGES, self.TRAIN_LABELS))

    def _load_real(self):
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = 10000
        self.class_lengths[TRAIN] = 60000
        data = numpy.zeros((70000, 28, 28), dtype=numpy.float32)
        labels = numpy.zeros(70000, dtype=numpy.int32)
        path = self.data_path
        labels[:10000] = self._load_idx_labels(
            os.path.join(path, self.TEST_LABELS), 10000)
        data[:10000] = self._load_idx_images(
            os.path.join(path, self.TEST_IMAGES), 10000)
        labels[10000:] = self._load_idx_labels(
            os.path.join(path, self.TRAIN_LABELS), 60000)
        data[10000:] = self._load_idx_images(
            os.path.join(path, self.TRAIN_IMAGES), 60000)
        self.original_data.reset(data)
        self._original_labels[:] = labels.tolist()

    def _load_synthetic(self):
        """The deterministic MNIST-like set: 10 class-prototype blobs
        plus noise."""
        n_valid, n_train = self.synthetic_valid, self.synthetic_train
        total = n_valid + n_train
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = n_valid
        self.class_lengths[TRAIN] = n_train
        r = numpy.random.RandomState(20260729)
        protos = r.uniform(0, 255, (10, 28, 28)).astype(numpy.float32)
        # smoothing gives the prototypes digit-like large-scale structure
        for _ in range(2):
            protos = (protos +
                      numpy.roll(protos, 1, 1) + numpy.roll(protos, -1, 1) +
                      numpy.roll(protos, 1, 2) + numpy.roll(protos, -1, 2)
                      ) / 5.0
        labels = r.randint(0, 10, total).astype(numpy.int32)
        noise = r.normal(0, 32.0, (total, 28, 28)).astype(numpy.float32)
        self.original_data.reset(numpy.clip(protos[labels] + noise, 0, 255))
        self._original_labels[:] = labels.tolist()

    def load_data(self):
        if self._real_files_present() and self.synthetic is not True:
            self.info("Loading original MNIST files from %s", self.data_path)
            self._load_real()
        elif self.synthetic in (True, "auto"):
            self.info("MNIST files absent; using the deterministic "
                      "synthetic set (%d train / %d validation)",
                      self.synthetic_train, self.synthetic_valid)
            self._load_synthetic()
        else:
            raise OSError(
                "No MNIST data in %s and the synthetic set disabled; put "
                "the IDX files there" % self.data_path)
