"""The UCI Wine loader (``wine_loader``).

Counterpart of ``znicz_tpu/loader/loader_wine.py``: ``dataset_file``
(``root.common.dirs.datasets``/wine/wine.txt by default) holds CSV rows
of ``label,feature...`` with 1-based labels, served 0-based; pointwise
normalization, whatever the caller asks; every row is TRAIN, or under
``testing`` every row TEST (JAX :44-49).  Where the file is absent it
is written once from scikit-learn's bundled copy of the same data, in
the JAX loader's ``savetxt`` format (``%.6g``), so both packages read
the same bytes; nothing is downloaded.
"""

import os

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import (
    FullBatchLoader, IFullBatchLoader, TEST, TRAIN, VALID)


class WineLoader(FullBatchLoader, IFullBatchLoader):
    MAPPING = "wine_loader"

    def __init__(self, workflow, **kwargs):
        kwargs["normalization_type"] = "pointwise"
        super(WineLoader, self).__init__(workflow, **kwargs)
        self.dataset_file = kwargs.get("dataset_file", os.path.join(
            root.common.dirs.datasets, "wine", "wine.txt"))

    def _materialize_dataset(self):
        from sklearn.datasets import load_wine
        wine = load_wine()
        os.makedirs(os.path.dirname(self.dataset_file), exist_ok=True)
        rows = numpy.hstack([(wine.target + 1)[:, None].astype(numpy.float32),
                             wine.data.astype(numpy.float32)])
        numpy.savetxt(self.dataset_file, rows, delimiter=",", fmt="%.6g")

    def load_data(self):
        if not os.path.exists(self.dataset_file):
            self._materialize_dataset()
        arr = numpy.loadtxt(self.dataset_file, delimiter=",",
                            dtype=numpy.float32)
        self.original_data.reset(arr[:, 1:].copy())
        self._original_labels[:] = (
            arr[:, 0].ravel().astype(numpy.int32) - 1).tolist()
        if not self.testing:
            self.class_lengths[TEST] = self.class_lengths[VALID] = 0
            self.class_lengths[TRAIN] = self.original_data.shape[0]
        else:
            self.class_lengths[TEST] = self.original_data.shape[0]
            self.class_lengths[VALID] = self.class_lengths[TRAIN] = 0
