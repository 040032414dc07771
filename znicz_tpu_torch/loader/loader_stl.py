"""The STL-10 loader (``full_batch_stl_10``).

Counterpart of ``znicz_tpu/loader/loader_stl.py``: the binary files
``train_X.bin`` / ``train_y.bin`` / ``test_X.bin`` / ``test_y.bin`` and
``class_names.txt`` in ``directory``; 96x96x3 images stored
channel-planar (CHW) uint8, labels 1-based indices into
``class_names.txt``; the test split is served as VALID.  Each image's
CHW bytes are transposed to HWC as the JAX loader does it (the
official files are column-major in each plane, so this serves them
with x and y swapped, as the JAX package does: parity wins).
"""

import os

import numpy

from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.loader.image import FullBatchImageLoader, IImageLoader


class STL10FullBatchLoader(FullBatchImageLoader, IImageLoader):
    MAPPING = "full_batch_stl_10"
    SIZE = (96, 96)
    SQUARE = SIZE[0] * SIZE[1] * 3

    #: the files that serve each class (the test split as VALID)
    FILES = {TRAIN: ("train_X.bin", "train_y.bin"),
             VALID: ("test_X.bin", "test_y.bin")}

    def __init__(self, workflow, **kwargs):
        super(STL10FullBatchLoader, self).__init__(workflow, **kwargs)
        self.directory = kwargs["directory"]
        self._bytes = {}
        self._labels = {}
        self._class_names = []

    def _load_files(self):
        if self._bytes:
            return
        if not os.path.isdir(self.directory):
            raise ValueError('"%s" must be a directory' % self.directory)
        with open(os.path.join(self.directory, "class_names.txt")) as fin:
            self._class_names = fin.read().split()
        for clazz, (xfile, yfile) in self.FILES.items():
            with open(os.path.join(self.directory, xfile), "rb") as f:
                self._bytes[clazz] = f.read()
            self._labels[clazz] = numpy.fromfile(
                os.path.join(self.directory, yfile), dtype=numpy.uint8)
            if len(self._bytes[clazz]) // self.SQUARE != \
                    len(self._labels[clazz]):
                raise ValueError(
                    "%s: %d images != %d labels" % (
                        xfile, len(self._bytes[clazz]) // self.SQUARE,
                        len(self._labels[clazz])))

    def get_keys(self, index):
        if index not in self.FILES:
            return []
        self._load_files()
        return [(index, i)
                for i in range(len(self._bytes[index]) // self.SQUARE)]

    def get_image_label(self, key):
        # 1-based indices into class_names.txt
        return self._class_names[self._labels[key[0]][key[1]] - 1]

    def get_image_info(self, key):
        return self.SIZE, "RGB"

    def get_image_data(self, key):
        clazz, i = key
        raw = self._bytes[clazz][i * self.SQUARE:(i + 1) * self.SQUARE]
        return numpy.transpose(
            numpy.frombuffer(raw, dtype=numpy.uint8).reshape(
                (3,) + self.SIZE), (1, 2, 0))
