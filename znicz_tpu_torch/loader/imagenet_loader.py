"""The ImageNet preprocessed-dataset loader (``imagenet_loader_base``).

Counterpart of ``znicz_tpu/loader/imagenet_loader.py``: a flat
``samples.dat`` of uint8 (sy, sx, channels) records, the
``original_labels_filename`` pickle of (text label, int label) pairs,
the ``count_samples_filename`` JSON ``{"test": n, "val": n, "train":
n}`` and the ``matrixes_filename`` pickle of the ``[mean, rdisp]``
arrays that ``MeanDispNormalizer`` takes (``link_meandispnorm``).  The
loader streams: it holds ``samples.dat`` open and seeks and reads one
record a row (JAX :126-137), so the set never has to fit in memory.
The minibatch stays uint8 on the host; the normalizer uploads it once
a minibatch and makes it floats on its device.  The file is closed by
:meth:`stop`, which the loader's workflow calls when its run returns
or raises; a later run opens it again.
"""

import json
import os
import pickle

import numpy

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.loader.base import ILoader, Loader, TEST, TRAIN, VALID


class ImagenetLoaderBase(Loader, ILoader):
    MAPPING = "imagenet_loader_base"

    def __init__(self, workflow, **kwargs):
        super(ImagenetLoaderBase, self).__init__(workflow, **kwargs)
        self.mean = Array(name="mean")
        self.rdisp = Array(name="rdisp")
        self.sx = kwargs.get("sx", 256)
        self.sy = kwargs.get("sy", 256)
        self.channels = kwargs.get("channels", 3)
        self.original_labels_filename = kwargs.get(
            "original_labels_filename")
        self.count_samples_filename = kwargs.get("count_samples_filename")
        self.matrixes_filename = kwargs.get("matrixes_filename")
        self.samples_filename = kwargs.get("samples_filename")
        self.class_keys_path = kwargs.get("class_keys_path")
        self.final_sy = self.sy
        self.final_sx = self.sx
        self.class_keys = None
        self.has_mean_file = False
        self._file_samples = None
        self._original_labels_list = []
        self._int_labels = None
        self._stop_linked = False

        if self.class_keys_path is not None:
            with open(self.class_keys_path) as fin:
                self.class_keys = json.load(fin)

    @property
    def sample_bytes(self):
        return self.sy * self.sx * self.channels

    @property
    def original_labels(self):
        return self._int_labels if self._int_labels is not None else []

    def _require(self, path, what):
        if path is None or not os.path.exists(path):
            raise OSError(
                "%s %s does not exist or None. Generate it with the "
                "dataset preparation tooling first." % (what, path))

    def load_data(self):
        self._require(self.original_labels_filename,
                      "original_labels_filename")
        self._require(self.count_samples_filename,
                      "count_samples_filename")
        self._require(self.samples_filename, "samples_filename")

        with open(self.original_labels_filename, "rb") as fin:
            for txt_lbl, int_lbl in pickle.load(fin):
                self._original_labels_list.append(txt_lbl)
                self._labels_mapping[txt_lbl] = int(int_lbl)

        with open(self.count_samples_filename) as fin:
            set_type = {"test": TEST, "val": VALID, "train": TRAIN}
            for key, value in json.load(fin).items():
                self.class_lengths[set_type[key]] = value

        if self.total_samples != len(self._original_labels_list):
            raise ValueError(
                "number of labels (%d) mismatches sum of class lengths "
                "(%d)" % (len(self._original_labels_list),
                          self.total_samples))
        self._int_labels = numpy.array(
            [self._labels_mapping[l] for l in self._original_labels_list],
            dtype=numpy.int32)

        self._file_samples = open(self.samples_filename, "rb")
        n = self._file_samples.seek(0, 2) // self.sample_bytes
        if n != len(self._original_labels_list):
            raise ValueError(
                "wrong samples.dat size: %d samples != %d labels"
                % (n, len(self._original_labels_list)))
        if self.matrixes_filename is not None:
            self.load_mean()

    def load_mean(self):
        """The ``[mean, rdisp]`` arrays for ``MeanDispNormalizer``, with
        JAX's checks (:101-119)."""
        self._require(self.matrixes_filename, "matrixes_filename")
        with open(self.matrixes_filename, "rb") as fin:
            matrixes = pickle.load(fin)
        self.mean.reset(numpy.asarray(matrixes[0]))
        self.rdisp.reset(numpy.asarray(matrixes[1], dtype=numpy.float32))
        if numpy.count_nonzero(numpy.isnan(self.rdisp.mem)):
            raise ValueError("rdisp matrix has NaNs")
        if numpy.count_nonzero(numpy.isinf(self.rdisp.mem)):
            raise ValueError("rdisp matrix has Infs")
        if self.mean.shape != self.rdisp.shape:
            raise ValueError("mean.shape != rdisp.shape")
        if self.mean.shape[0] != self.sy or self.mean.shape[1] != self.sx:
            raise ValueError("mean.shape != (%d, %d)" % (self.sy, self.sx))
        self.has_mean_file = True

    def initialize(self, device=None, **kwargs):
        super(ImagenetLoaderBase, self).initialize(device=device, **kwargs)
        finished = getattr(self.workflow, "on_workflow_finished", None)
        if finished is not None and not self._stop_linked:
            finished(self.stop)
            self._stop_linked = True

    def create_minibatch_data(self):
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size, self.final_sy, self.final_sx,
             self.channels), dtype=numpy.uint8))

    def fill_minibatch(self):
        idx = self.minibatch_indices.mem
        self.minibatch_data.map_invalidate()
        self.minibatch_labels.map_write()
        if self._file_samples is None:   # closed by the last run's end
            self._file_samples = open(self.samples_filename, "rb")
        for i in range(self.minibatch_size):
            sample_index = int(idx[i])
            self._file_samples.seek(sample_index * self.sample_bytes)
            raw = self._file_samples.read(self.sample_bytes)
            self.minibatch_data.mem[i] = numpy.frombuffer(
                raw, dtype=numpy.uint8).reshape(
                    self.sy, self.sx, self.channels)
            self.minibatch_labels.mem[i] = self._int_labels[sample_index]

    def stop(self):
        super(ImagenetLoaderBase, self).stop()
        if self._file_samples is not None:
            self._file_samples.close()
            self._file_samples = None
