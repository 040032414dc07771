"""Image loaders — keys, labels and pixels from files, served NHWC.

Counterpart of ``znicz_tpu/loader/image.py``: subclasses provide

* ``get_keys(index)``       -> the keys of class ``index`` (TEST,
  VALID, TRAIN);
* ``get_image_data(key)``   -> a numpy array (H, W[, C]);
* ``get_image_label(key)``  -> an int or a string label;
* ``get_image_info(key)``   -> ((H, W), color space).

:class:`ImageLoaderBase` (streaming: it decodes each minibatch's images
when it serves them) maps string labels to ints in the order TEST,
VALID, TRAIN (``labels_mapping``), carves VALID out of TRAIN with
``validation_ratio`` when the source has no VALID keys (one
``prng.permutation`` of the loader's stream, drawn before any
shuffle), rescales each image to ``scale`` (PIL bilinear, one channel
at a time) and fits the normalizer on up to
``normalizer_analysis_limit`` TRAIN images.  :class:`FullBatchImageLoader`
decodes the whole set into ``original_data`` once, at load time, and
serves it as ``FullBatchLoader`` does.  The file loaders read images
listed in text files (``file_list_image``,
``full_batch_file_list_image``) or found under directories whose name
is the label (``auto_label_file_image``,
``full_batch_auto_label_file_image``).  PIL is imported only where an
image file is opened or rescaled.
"""

import os

import numpy

from znicz_tpu_torch.core import normalization
from znicz_tpu_torch.loader.base import (
    FullBatchLoader, ILoader, IFullBatchLoader, Loader, TEST, TRAIN, VALID)


class IImageLoader(ILoader):
    """Marker interface."""


class ImageLoaderBase(Loader):
    """The streaming image loader: each minibatch's images are decoded
    when it is served; the whole set is never in memory."""

    MAPPING = None

    def __init__(self, workflow, **kwargs):
        super(ImageLoaderBase, self).__init__(workflow, **kwargs)
        #: the target (H, W), or None to keep the source's size
        self.scale = kwargs.get("scale")
        self.source_dtype = numpy.float32
        #: TRAIN images decoded for the normalizer's fit at most
        self.normalizer_analysis_limit = kwargs.get(
            "normalizer_analysis_limit", 2048)
        #: the share of TRAIN carved out as VALID when the source has
        #: no VALID keys
        self.validation_ratio = kwargs.get("validation_ratio", 0.0)
        self._keys = {TEST: [], VALID: [], TRAIN: []}
        self._label_to_int = {}
        self._distinct_labels = set()

    # -- to be provided by subclasses ---------------------------------------
    def get_keys(self, index):
        raise NotImplementedError

    def get_image_data(self, key):
        raise NotImplementedError

    def get_image_label(self, key):
        raise NotImplementedError

    def get_image_info(self, key):
        raise NotImplementedError

    # -- labels and images ---------------------------------------------------
    @property
    def labels_mapping(self):
        """String label -> int, in the order first seen."""
        return self._label_to_int

    @property
    def unique_labels_count(self):
        if self._distinct_labels:
            return len(self._distinct_labels)
        return super(ImageLoaderBase, self).unique_labels_count

    def _map_label(self, label):
        if isinstance(label, (int, numpy.integer)):
            self._distinct_labels.add(int(label))
            return int(label)
        if label not in self._label_to_int:
            self._label_to_int[label] = len(self._label_to_int)
        mapped = self._label_to_int[label]
        self._distinct_labels.add(mapped)
        return mapped

    def _prepare_image(self, img):
        """An (H, W, C) float sample, rescaled to ``scale`` if set."""
        img = numpy.asarray(img)
        if img.ndim == 2:
            img = img[:, :, None]
        if self.scale is not None and \
                tuple(img.shape[:2]) != tuple(self.scale):
            from PIL import Image
            chans = []
            for c in range(img.shape[2]):
                pil = Image.fromarray(img[:, :, c])
                # PIL's size is (W, H)
                pil = pil.resize((self.scale[1], self.scale[0]),
                                 Image.BILINEAR)
                chans.append(numpy.asarray(pil))
            img = numpy.stack(chans, axis=2)
        return img.astype(self.source_dtype)

    def _sample_shape(self):
        for clazz in (TRAIN, VALID, TEST):
            if self._keys[clazz]:
                return self._prepare_image(
                    self.get_image_data(self._keys[clazz][0])).shape
        raise ValueError("%s: no keys in any class" % self.name)

    # -- the Loader contract -------------------------------------------------
    def load_data(self):
        # labels are mapped in dataset order, so the int mapping (and
        # the softmax head) is deterministic
        for clazz in (TEST, VALID, TRAIN):
            self._keys[clazz] = list(self.get_keys(clazz))
            for key in self._keys[clazz]:
                self._map_label(self.get_image_label(key))
        if self.validation_ratio > 0 and not self._keys[VALID] and \
                self._keys[TRAIN]:
            n = len(self._keys[TRAIN])
            n_valid = max(1, int(n * self.validation_ratio))
            # the loader's stream, before its first shuffle
            perm = self.prng.permutation(n)
            keys = self._keys[TRAIN]
            self._keys[VALID] = [keys[i] for i in sorted(perm[:n_valid])]
            self._keys[TRAIN] = [keys[i] for i in sorted(perm[n_valid:])]
        for clazz in (TEST, VALID, TRAIN):
            self.class_lengths[clazz] = len(self._keys[clazz])

    def create_minibatch_data(self):
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + tuple(self._sample_shape()),
            dtype=self.source_dtype))

    def initialize(self, device=None, **kwargs):
        super(ImageLoaderBase, self).initialize(device=device, **kwargs)
        if self.normalizer is None:
            self._fit_normalizer()

    def _fit_normalizer(self):
        """Fit the normalizer on up to ``normalizer_analysis_limit``
        TRAIN images (VALID or TEST when there are none);
        ``fill_minibatch`` then normalizes every minibatch."""
        if self.normalization_type in (None, "none"):
            self.normalizer = normalization.NoneNormalizer()
            return
        self.normalizer = normalization.create(
            self.normalization_type, **self.normalization_parameters)
        keys = self._keys[TRAIN] or self._keys[VALID] or self._keys[TEST]
        keys = keys[:self.normalizer_analysis_limit]
        sample = numpy.stack([
            self._prepare_image(self.get_image_data(k)) for k in keys])
        self.normalizer.analyze(sample.reshape(len(keys), -1))

    def _key_of_global_index(self, idx):
        for clazz in (TEST, VALID, TRAIN):
            start, end = self.class_index_range(clazz)
            if start <= idx < end:
                return self._keys[clazz][idx - start]
        raise IndexError(idx)

    def fill_minibatch(self):
        idx = self.minibatch_indices.mem
        self.minibatch_data.map_invalidate()
        self.minibatch_labels.map_write()
        n = self.minibatch_size
        for i in range(n):
            key = self._key_of_global_index(int(idx[i]))
            self.minibatch_data.mem[i] = self._prepare_image(
                self.get_image_data(key))
            self.minibatch_labels.mem[i] = self._map_label(
                self.get_image_label(key))
        if self.normalizer is not None:
            self.normalizer.normalize(
                self.minibatch_data.mem[:n].reshape(n, -1))


class FullBatchImageLoader(ImageLoaderBase, FullBatchLoader,
                           IFullBatchLoader):
    """Decodes the whole set into ``original_data`` once, at load time
    (one array, filled in dataset order), and serves, normalizes and
    fills minibatches as ``FullBatchLoader`` does.  Its minibatch
    methods are ``FullBatchLoader``'s own functions (the JAX class
    wraps them), so the fused trainer, which gathers only a stock fill's
    rows on the device, runs its TRAIN windows over this loader."""

    MAPPING = None
    # ImageLoaderBase's come first in the MRO
    create_minibatch_data = FullBatchLoader.create_minibatch_data
    fill_minibatch = FullBatchLoader.fill_minibatch

    def load_data(self):
        ImageLoaderBase.load_data(self)
        shape = self._sample_shape()
        data = numpy.zeros((self.total_samples,) + tuple(shape),
                           dtype=self.source_dtype)
        pos = 0
        for clazz in (TEST, VALID, TRAIN):   # the dataset's layout
            for key in self._keys[clazz]:
                data[pos] = self._prepare_image(self.get_image_data(key))
                self._original_labels.append(
                    self._map_label(self.get_image_label(key)))
                pos += 1
        self.original_data.reset(data)


class FileListImageLoader(ImageLoaderBase, IImageLoader):
    """Images listed in text files of ``path [label]`` lines, one list
    (or a list of them) per class; without a label, the image's
    directory name is its label."""

    MAPPING = "file_list_image"

    def __init__(self, workflow, **kwargs):
        super(FileListImageLoader, self).__init__(workflow, **kwargs)
        self.path_to_test_text_file = kwargs.get("test_paths")
        self.path_to_val_text_file = kwargs.get("validation_paths")
        self.path_to_train_text_file = kwargs.get("train_paths")
        self.base_directory = kwargs.get("base_directory", "")
        self._lists = {TEST: self.path_to_test_text_file,
                       VALID: self.path_to_val_text_file,
                       TRAIN: self.path_to_train_text_file}

    def get_keys(self, index):
        paths = self._lists.get(index)
        if not paths:
            return []
        if isinstance(paths, str):
            paths = [paths]
        keys = []
        for list_file in paths:
            with open(list_file) as fin:
                for line in fin:
                    parts = line.split()
                    if not parts:
                        continue
                    path = os.path.join(self.base_directory, parts[0])
                    label = parts[1] if len(parts) > 1 else \
                        os.path.basename(os.path.dirname(path))
                    keys.append((path, label))
        return keys

    def get_image_data(self, key):
        from PIL import Image
        return numpy.asarray(Image.open(key[0]))

    def get_image_label(self, key):
        try:
            return int(key[1])
        except (TypeError, ValueError):
            return key[1]

    def get_image_info(self, key):
        from PIL import Image
        with Image.open(key[0]) as img:
            return (img.height, img.width), img.mode


class FullBatchFileListImageLoader(FullBatchImageLoader,
                                   FileListImageLoader):
    """The list loader's keys and images, decoded once (the full-batch
    methods come first in the MRO)."""

    MAPPING = "full_batch_file_list_image"


class AutoLabelFileImageLoader(ImageLoaderBase, IImageLoader):
    """Images found under directories (walked in sorted order); each
    image's label is the name of the directory that holds it."""

    MAPPING = "auto_label_file_image"
    EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".pgm", ".ppm")

    def __init__(self, workflow, **kwargs):
        super(AutoLabelFileImageLoader, self).__init__(workflow, **kwargs)
        self._dirs = {TEST: kwargs.get("test_paths"),
                      VALID: kwargs.get("validation_paths"),
                      TRAIN: kwargs.get("train_paths")}

    def get_keys(self, index):
        dirs = self._dirs.get(index)
        if not dirs:
            return []
        if isinstance(dirs, str):
            dirs = [dirs]
        keys = []
        for base in dirs:
            for dirpath, _, files in sorted(os.walk(base)):
                for name in sorted(files):
                    if os.path.splitext(name)[1].lower() in self.EXTENSIONS:
                        keys.append((os.path.join(dirpath, name),
                                     os.path.basename(dirpath)))
        return keys

    get_image_data = FileListImageLoader.get_image_data
    get_image_label = FileListImageLoader.get_image_label
    get_image_info = FileListImageLoader.get_image_info


class FullBatchAutoLabelFileImageLoader(FullBatchImageLoader,
                                        AutoLabelFileImageLoader):
    """The auto-label loader's keys and images, decoded once."""

    MAPPING = "full_batch_auto_label_file_image"
