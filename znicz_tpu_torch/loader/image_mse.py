"""Image loaders whose targets are one image per label (the Kanji
pattern).

Counterpart of ``znicz_tpu/loader/image_mse.py``: the data images are
labelled by their directory, each label's target image is read from
``target_paths`` (``<label>.<ext>``, or inside a ``<label>/``
directory), rescaled to ``targets_shape`` where given, and served as the
MSE target of every image of that label.  ``class_targets`` holds one
target a distinct data label, in the label mapping's order, normalized
as the targets are: the evaluator's nearest-class-target error.
"""

import os

import numpy

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.loader.base import (FullBatchLoaderMSEMixin, TEST,
                                         TRAIN, VALID)
from znicz_tpu_torch.loader.image import (AutoLabelFileImageLoader,
                                          FullBatchImageLoader, IImageLoader)


class FullBatchImageLoaderMSE(FullBatchLoaderMSEMixin, FullBatchImageLoader):
    """The full-batch image loader with a target image a label."""

    MAPPING = None

    def __init__(self, workflow, **kwargs):
        super(FullBatchImageLoaderMSE, self).__init__(workflow, **kwargs)
        self.target_paths = kwargs.get("target_paths") or []
        if isinstance(self.target_paths, str):
            self.target_paths = [self.target_paths]
        self.targets_scale = kwargs.get("targets_shape")
        self.class_targets = Array(name="class_targets")
        self._target_by_label = {}

    def _load_targets(self):
        exts = AutoLabelFileImageLoader.EXTENSIONS
        for base in self.target_paths:
            for dirpath, _, files in sorted(os.walk(base)):
                for name in sorted(files):
                    stem, ext = os.path.splitext(name)
                    if ext.lower() not in exts:
                        continue
                    label = stem if os.path.abspath(dirpath) == \
                        os.path.abspath(base) else os.path.basename(dirpath)
                    self._target_by_label[label] = self._prepare_target(
                        os.path.join(dirpath, name))
        if not self._target_by_label:
            raise ValueError("%s: no target images under %s"
                             % (self.name, self.target_paths))

    def _prepare_target(self, path):
        from PIL import Image
        img = numpy.asarray(Image.open(path))
        if img.ndim == 3 and img.shape[2] == 1:
            img = img[:, :, 0]
        if self.targets_scale is not None and \
                img.shape[:2] != tuple(self.targets_scale):
            pil = Image.fromarray(img).resize(
                (self.targets_scale[1], self.targets_scale[0]),
                Image.BILINEAR)
            img = numpy.asarray(pil)
        return img.astype(self.source_dtype)

    def load_data(self):
        self._load_targets()
        super(FullBatchImageLoaderMSE, self).load_data()
        targets = []
        for clazz in (TEST, VALID, TRAIN):   # the dataset's layout
            for key in self._keys[clazz]:
                label = self.get_image_label(key)
                if label not in self._target_by_label:
                    raise KeyError("no target image for label %r" % (label,))
                targets.append(self._target_by_label[label])
        self.original_targets.reset(numpy.stack(targets))
        # one target a distinct data label, in the int mapping's order;
        # a target whose label no image has is skipped (it would add a
        # class no sample can be)
        by_int = {}
        for label, img in self._target_by_label.items():
            if label in self._label_to_int:
                by_int[self._label_to_int[label]] = img
            else:
                self.warning("target image for unused label %r skipped",
                             label)
        self.class_targets.reset(numpy.stack(
            [by_int[i] for i in sorted(by_int)]))

    def _apply_target_normalization(self):
        super(FullBatchImageLoaderMSE, self)._apply_target_normalization()
        # the class targets in the targets' normalized space
        ct = self.class_targets.mem
        self.target_normalizer.normalize(ct.reshape(ct.shape[0], -1))


class FullBatchAutoLabelFileImageLoaderMSE(FullBatchImageLoaderMSE,
                                           AutoLabelFileImageLoader,
                                           IImageLoader):
    """Kanji's loader: images under directories named for their labels,
    decoded once, with a target image a label."""

    MAPPING = "full_batch_auto_label_file_image_mse"
