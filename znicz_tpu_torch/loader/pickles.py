"""The pickled-image full-batch loader (``full_batch_pickles_image``).

Counterpart of ``znicz_tpu/loader/pickles.py``: each class is a list of
pickle files, each holding a CIFAR batch dict (``{b"data": (N, rows)
uint8, b"labels": [...]}``) or a raw array of images.  Flat rows take
``image_shape`` (CIFAR's (3, 32, 32) by default) and a CHW layout is
served HWC.  A pickle without labels gives all its rows one label, a
file's position within its class list, counted again from 0 in each
class, so the same position is the same class in TRAIN and VALID.

A known difference: the port's rows are C-ordered, so the configured
normalization applies to CHW pickles; JAX's loader keeps them in the
transposed view's order, and its normalizer then normalizes a reshaped
copy and leaves ``original_data`` as read.
"""

import pickle

import numpy

from znicz_tpu_torch.loader.base import (FullBatchLoader, IFullBatchLoader,
                                         TEST, TRAIN, VALID)


class PicklesImageFullBatchLoader(FullBatchLoader, IFullBatchLoader):
    """kwargs: ``test_pickles`` / ``validation_pickles`` /
    ``train_pickles`` (lists of file paths), ``color_space`` (metadata),
    optional ``image_shape`` to reshape flat rows (default: CIFAR-style
    (3, 32, 32) CHW, transposed to HWC)."""

    MAPPING = "full_batch_pickles_image"

    def __init__(self, workflow, **kwargs):
        super(PicklesImageFullBatchLoader, self).__init__(workflow,
                                                          **kwargs)
        self.test_pickles = list(kwargs.get("test_pickles", ()))
        self.validation_pickles = list(
            kwargs.get("validation_pickles", ()))
        self.train_pickles = list(kwargs.get("train_pickles", ()))
        self.color_space = kwargs.get("color_space", "RGB")
        self.image_shape = kwargs.get("image_shape", (3, 32, 32))

    def reshape(self, data):
        """Flat rows -> image batch.  CHW pickle layouts transpose to
        the framework's NHWC."""
        shape = tuple(self.image_shape)
        data = data.reshape((-1,) + shape)
        if len(shape) == 3 and shape[0] in (1, 3, 4) and \
                shape[0] < shape[2]:
            data = data.transpose(0, 2, 3, 1)
        return data

    def _read_pickle(self, path):
        with open(path, "rb") as fin:
            d = pickle.load(fin, encoding="bytes")
        if isinstance(d, dict):
            data = d.get(b"data", d.get("data"))
            labels = d.get(b"labels", d.get("labels"))
        else:
            data, labels = d, None
        data = numpy.asarray(data)
        if data.ndim == 2:
            data = self.reshape(data)
        if labels is not None:
            labels = numpy.asarray(labels, dtype=numpy.int32)
        # C order: a CHW pickle's rows are a transposed view, and the
        # normalizer works on a reshape of them in place (JAX's keeps
        # the view's order, and its normalizer then writes to a copy)
        return numpy.ascontiguousarray(data, dtype=numpy.float32), labels

    def load_data(self):
        datas = []
        del self._original_labels[:]
        for clazz, files in ((TEST, self.test_pickles),
                             (VALID, self.validation_pickles),
                             (TRAIN, self.train_pickles)):
            count = 0
            # per-file fallback labels restart PER SPLIT so the same
            # file position means the same class in train and valid
            next_label = 0
            for path in files:
                data, labels = self._read_pickle(path)
                datas.append(data)
                count += data.shape[0]
                if labels is not None:
                    self._original_labels.extend(int(v) for v in labels)
                else:
                    # unlabeled pickle: one label per FILE (the
                    # reference's per-pickle class convention)
                    self._original_labels.extend(
                        [next_label] * data.shape[0])
                    next_label += 1
            self.class_lengths[clazz] = count
        if not datas:
            raise ValueError("no pickles configured")
        self.original_data.reset(numpy.concatenate(datas, axis=0))
