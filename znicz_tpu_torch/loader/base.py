"""Loader base classes — the minibatch-serving contract.

Counterpart of ``znicz_tpu/loader/base.py`` (:49-466): ``Loader``,
``FullBatchLoader``, ``IFullBatchLoader``, ``UserLoaderRegistry``, the
``TEST`` / ``VALID`` / ``TRAIN`` classes and the MSE mixins
(``LoaderMSEMixin``, ``FullBatchLoaderMSEMixin``, ``FullBatchLoaderMSE``
:467-530: per-sample regression targets, optional class targets, a
targets normalizer), with the ``loader.fill`` fault site and its
bounded retry (JAX :317-333) and the profiler's hooks (JAX :254-304:
the serve of a minibatch is its data wait, unless an avatar serves
it ahead and notes its own wait, and the epoch boundary runs the
memory ledger's leak check), without the telemetry hooks.

Epoch semantics, as the JAX package's:

* one epoch serves every class segment with samples in the order
  TEST -> TRAIN -> VALID (VALID last, after the epoch's training);
* ``last_minibatch`` is true on each segment's final minibatch,
  ``epoch_ended`` also on the epoch's final segment, and
  ``epoch_number`` counts the epochs served;
* the TRAIN order is reshuffled every epoch from the loader's stream,
  ``prng.get(2)`` (:86, :246), and every reshuffle bumps
  ``shuffle_serial``;
* the tail minibatch of a segment keeps the buffer size constant and
  sets ``minibatch_size`` to the true count; padded labels are -1;
* ``skip_fill``: the fused trainer consumes TRAIN minibatches as
  device gathers from their indices, so the host fill is skipped for
  them (``minibatch_data`` / ``minibatch_labels`` then hold the
  previous fill).

The loader's streams are numpy's, as in the JAX package, so the same
seed serves the same rows in the same order in either package.
"""

import time

import numpy

from znicz_tpu_torch.core import faults, normalization, profiler
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.units import Unit

TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAME = {TEST: "test", VALID: "validation", TRAIN: "train"}

#: serving order within one epoch
SERVE_ORDER = (TEST, TRAIN, VALID)


class ILoader(object):
    """Marker interface."""


class IFullBatchLoader(ILoader):
    pass


class UserLoaderRegistry(type):
    """Registry of loader classes by their ``MAPPING`` name."""

    loaders = {}

    def __init__(cls, name, bases, clsdict):
        super(UserLoaderRegistry, cls).__init__(name, bases, clsdict)
        mapping = clsdict.get("MAPPING", None)
        if mapping:
            UserLoaderRegistry.loaders[mapping] = cls

    @staticmethod
    def get_factory(name):
        try:
            return UserLoaderRegistry.loaders[name]
        except KeyError:
            raise KeyError("Unknown loader %r; known: %s"
                           % (name, sorted(UserLoaderRegistry.loaders)))


class Loader(Unit, metaclass=UserLoaderRegistry):
    """Serves minibatches; subclasses provide the data."""

    #: called once the data is loaded and the buffers allocated, before
    #: normalization (the workflow sets the softmax head's width here)
    on_initialized = None

    def __init__(self, workflow, **kwargs):
        super(Loader, self).__init__(workflow, **kwargs)
        self.max_minibatch_size = kwargs.get("minibatch_size", 100)
        self.prng = kwargs.get("prng", prng.get(2))
        self.normalization_type = kwargs.get("normalization_type", "none")
        self.normalization_parameters = kwargs.get(
            "normalization_parameters", {})
        #: a loader that reads its test set serves it all as TEST
        self.testing = kwargs.get("testing", False)
        self.class_lengths = [0, 0, 0]
        self._labels_mapping = {}
        self.minibatch_data = Array(name="minibatch_data")
        self.minibatch_labels = Array(name="minibatch_labels")
        self.minibatch_indices = Array(name="minibatch_indices")
        self.minibatch_size = 0
        self.minibatch_class = TRAIN
        #: the served minibatch's first row within its class's order
        self.minibatch_class_offset = 0
        #: the rows served in this epoch up to and with this minibatch
        #: (the testing evaluator's merge position)
        self.minibatch_offset = 0
        self._global_offset = 0
        self.last_minibatch = Bool(False)
        self.epoch_ended = Bool(False)
        #: the TRAIN segment's last minibatch was served
        self.train_ended = Bool(False)
        #: the loader has nothing more to serve (a forward workflow's
        #: stop, beside ``epoch_ended``; never set by a file loader)
        self.complete = Bool(False)
        self.epoch_number = 0
        self.skip_fill = False
        self.shuffle_serial = 0
        self._indices = {}       # class -> index array into the dataset
        self._segment = 0        # position in the serving order
        self._offset_in_class = 0
        #: with the prng streams, the iteration state makes a resumed
        #: run serve exactly what the uninterrupted run would have
        self.exports = ["epoch_number", "_segment", "_offset_in_class",
                        "_global_offset", "_indices", "shuffle_serial"]
        self.normalizer = None
        #: the armed profiler's data wait is this loader's serve time
        #: (an avatar, which serves it ahead, notes its own queue wait)
        self.notes_data_wait = True

    # -- to be provided by subclasses ---------------------------------------
    def load_data(self):
        """Fill class_lengths and prepare the dataset."""
        raise NotImplementedError

    def create_minibatch_data(self):
        """Allocate minibatch_data for max_minibatch_size samples."""
        raise NotImplementedError

    def fill_minibatch(self):
        """Copy the samples at minibatch_indices into minibatch buffers."""
        raise NotImplementedError

    # -- common ------------------------------------------------------------
    @property
    def total_samples(self):
        return int(sum(self.class_lengths))

    @property
    def unique_labels_count(self):
        """Number of distinct labels — sets the softmax head width."""
        labels = getattr(self, "original_labels", None)
        if labels is not None and len(labels):
            return len(set(labels))
        raise AttributeError("loader cannot derive unique_labels_count")

    @property
    def labels_mapping(self):
        """String label -> int (empty where the labels are ints)."""
        return self._labels_mapping

    @property
    def has_labels(self):
        """Whether the dataset carries labels: read from the loader's
        label source, never from ``minibatch_labels`` (always
        allocated)."""
        return bool(self._labels_mapping)

    @property
    def shuffled_indices(self):
        """The epoch's serving order as dataset indices, segment after
        segment in ``SERVE_ORDER`` (what ``minibatch_offset`` walks):
        where an exporter writes the row served at a position."""
        parts = [self._indices[c] for c in self._serve_order()
                 if c in self._indices and len(self._indices[c])]
        if not parts:
            return numpy.arange(0)
        return numpy.concatenate(parts)

    def _serve_order(self):
        return [c for c in SERVE_ORDER if self.class_lengths[c] > 0]

    def class_index_range(self, clazz):
        """[start, end) of this class in the dataset's sample axis,
        laid out [TEST | VALID | TRAIN]."""
        start = sum(self.class_lengths[:clazz])
        return start, start + self.class_lengths[clazz]

    def initialize(self, device=None, **kwargs):
        super(Loader, self).initialize(device=device, **kwargs)
        self.load_data()
        if self.total_samples == 0:
            raise ValueError("%s loaded zero samples" % self.name)
        if self.max_minibatch_size < 1:
            raise ValueError("minibatch_size must be >= 1")
        self.max_minibatch_size = min(self.max_minibatch_size,
                                      max(self.class_lengths))
        for clazz in range(3):
            start, end = self.class_index_range(clazz)
            self._indices[clazz] = numpy.arange(start, end,
                                                dtype=numpy.int32)
        self._shuffle()
        self.create_minibatch_data()
        if not self.minibatch_data:
            raise ValueError("create_minibatch_data did not allocate "
                             "minibatch_data")
        if not self.minibatch_labels:
            self.minibatch_labels.reset(numpy.zeros(
                self.max_minibatch_size, dtype=numpy.int32))
        self.minibatch_indices.reset(numpy.zeros(
            self.max_minibatch_size, dtype=numpy.int32))
        for arr in (self.minibatch_data, self.minibatch_labels,
                    self.minibatch_indices):
            arr.device = device
        self._segment = 0
        self._offset_in_class = 0
        self._global_offset = 0
        if self.on_initialized is not None:
            self.on_initialized()
        self.info(
            "%s: %d samples (test %d, validation %d, train %d), mb=%d",
            self.name, self.total_samples, self.class_lengths[TEST],
            self.class_lengths[VALID], self.class_lengths[TRAIN],
            self.max_minibatch_size)

    @property
    def train_indices(self):
        """The epoch's shuffled TRAIN order (global dataset indices)."""
        return self._indices[TRAIN]

    def _shuffle(self):
        self.prng.shuffle(self._indices[TRAIN])
        self.shuffle_serial += 1

    def run(self):
        # the step-time breakdown: the whole serve (index walk, fill,
        # epoch bookkeeping) is this minibatch's data wait
        prof_t0 = time.perf_counter() if profiler.enabled() else None
        order = self._serve_order()
        clazz = order[self._segment]
        length = self.class_lengths[clazz]
        off = self._offset_in_class
        n = min(self.max_minibatch_size, length - off)
        sel = self._indices[clazz][off:off + n]

        self.minibatch_class = clazz
        self.minibatch_size = int(n)
        self.minibatch_class_offset = int(off)
        self._global_offset += n
        self.minibatch_offset = self._global_offset

        self.minibatch_indices.map_write()
        idx = self.minibatch_indices.mem
        idx[:n] = sel
        idx[n:] = -1
        if not (self.skip_fill and clazz == TRAIN):
            self._fill_resilient()
            if n < self.max_minibatch_size:
                self.minibatch_labels.map_write()
                self.minibatch_labels.mem[n:] = -1

        seg_done = off + n >= length
        epoch_done = seg_done and self._segment == len(order) - 1
        self.last_minibatch <<= seg_done
        self.epoch_ended <<= epoch_done
        self.train_ended <<= seg_done and clazz == TRAIN
        if epoch_done:
            self.epoch_number += 1
            if prof_t0 is not None:
                # the ledger's epoch-boundary leak check
                profiler.epoch_check(self.epoch_number)
            self._segment = 0
            self._offset_in_class = 0
            self._global_offset = 0
            self._shuffle()
        elif seg_done:
            self._segment += 1
            self._offset_in_class = 0
        else:
            self._offset_in_class = off + n
        if prof_t0 is not None and self.notes_data_wait:
            profiler.note_data_wait(time.perf_counter() - prof_t0)

    def _serve_fill(self):
        """One fill, with the ``loader.fill`` fault site inside the
        retried region: an injected transient I/O error is recovered as
        a flaky read would be, a ``stall`` delays the fill."""
        if faults.enabled():
            faults.check("loader.fill")
        self.fill_minibatch()

    def _fill_resilient(self):
        """``fill_minibatch`` with the bounded exponential-backoff retry
        of transient failures (``root.common.retry``); a terminal error
        still fails the run."""
        faults.retry_call(self._serve_fill, "loader.fill")

    def fill_window_slot(self, x_out=None, labels_out=None,
                         targets_out=None, indices_out=None):
        """Copy the just-served minibatch's rows, labels, targets (the
        MSE mixins') and indices into rows of the caller's staging
        buffers, those given; the indices are valid under ``skip_fill``
        too."""
        if x_out is not None:
            x_out[...] = self.minibatch_data.mem.reshape(x_out.shape)
        if labels_out is not None:
            labels_out[...] = self.minibatch_labels.mem.reshape(
                labels_out.shape)
        if targets_out is not None:
            targets_out[...] = self.minibatch_targets.mem.reshape(
                targets_out.shape)
        if indices_out is not None:
            indices_out[...] = self.minibatch_indices.mem.reshape(
                indices_out.shape)


class FullBatchLoader(Loader):
    """Loader keeping the whole dataset in memory
    (``original_data`` / ``original_labels`` + normalization)."""

    def __init__(self, workflow, **kwargs):
        super(FullBatchLoader, self).__init__(workflow, **kwargs)
        self.original_data = Array(name="original_data")
        self._original_labels = []
        self._labels_array = None

    @property
    def original_labels(self):
        return self._original_labels

    @property
    def has_labels(self):
        return bool(self._original_labels) or bool(self._labels_mapping)

    def create_minibatch_data(self):
        dtype = root.common.engine.get("precision_dtype")
        if dtype is None:
            dtype = self.original_data.dtype
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + tuple(self.original_data.shape[1:]),
            dtype=dtype))

    def initialize(self, device=None, **kwargs):
        self._labels_array = None
        super(FullBatchLoader, self).initialize(device=device, **kwargs)
        self._apply_normalization()

    def _fit_and_normalize(self, array, norm_type, norm_params):
        """Fit a normalizer on the TRAIN slice of ``array`` and normalize
        the whole array in place; returns the normalizer."""
        if norm_type in (None, "none"):
            return normalization.NoneNormalizer()
        normalizer = normalization.create(norm_type, **norm_params)
        array.map_write()
        data = array.mem
        flat = data.reshape(data.shape[0], -1)
        start, end = self.class_index_range(TRAIN)
        normalizer.analyze(flat[start:end] if end > start else flat)
        normalizer.normalize(flat)
        return normalizer

    def _apply_normalization(self):
        self.normalizer = self._fit_and_normalize(
            self.original_data, self.normalization_type,
            self.normalization_parameters)

    def fill_minibatch(self):
        n = self.minibatch_size
        sel = self.minibatch_indices.mem[:n]
        self.minibatch_data.map_invalidate()
        self.minibatch_data.mem[:n] = self.original_data.mem[sel]
        self.minibatch_labels.map_write()
        if self._original_labels:
            labels = self._labels_array
            if labels is None or len(labels) != len(self._original_labels):
                labels = self._labels_array = numpy.asarray(
                    self._original_labels)
            self.minibatch_labels.mem[:n] = labels[sel]


class LoaderMSEMixin(object):
    """Per-sample regression targets, the contract ``EvaluatorMSE``
    trains against: ``minibatch_targets`` (the evaluator's ``target``),
    optional ``class_targets`` (the nearest-class-target error) and a
    targets normalizer apart from the data's."""

    def __init__(self, workflow, **kwargs):
        super(LoaderMSEMixin, self).__init__(workflow, **kwargs)
        self.minibatch_targets = Array(name="minibatch_targets")
        self.targets_normalization_type = kwargs.get(
            "targets_normalization_type", "none")
        self.targets_normalization_parameters = kwargs.get(
            "targets_normalization_parameters", {})
        self.target_normalizer = None
        self.class_targets = None

    @property
    def targets_shape(self):
        return tuple(self.minibatch_targets.shape[1:])


class FullBatchLoaderMSEMixin(LoaderMSEMixin):
    """The whole ``original_targets`` in memory, served per minibatch
    beside the data."""

    def __init__(self, workflow, **kwargs):
        super(FullBatchLoaderMSEMixin, self).__init__(workflow, **kwargs)
        self.original_targets = Array(name="original_targets")

    def create_minibatch_data(self):
        super(FullBatchLoaderMSEMixin, self).create_minibatch_data()
        if not self.original_targets:
            raise ValueError(
                "%s.load_data must fill original_targets" % self.name)
        self.minibatch_targets.reset(numpy.zeros(
            (self.max_minibatch_size,) +
            tuple(self.original_targets.shape[1:]),
            dtype=self.minibatch_data.dtype))

    def initialize(self, device=None, **kwargs):
        super(FullBatchLoaderMSEMixin, self).initialize(
            device=device, **kwargs)
        self.minibatch_targets.device = device
        self._apply_target_normalization()

    def _apply_target_normalization(self):
        self.target_normalizer = self._fit_and_normalize(
            self.original_targets, self.targets_normalization_type,
            self.targets_normalization_parameters)

    def fill_minibatch(self):
        super(FullBatchLoaderMSEMixin, self).fill_minibatch()
        n = self.minibatch_size
        idx = self.minibatch_indices.mem[:n]
        self.minibatch_targets.map_invalidate()
        self.minibatch_targets.mem[:n] = self.original_targets.mem[idx]


class FullBatchLoaderMSE(FullBatchLoaderMSEMixin, FullBatchLoader):
    """A concrete base for full-batch MSE loaders."""
