"""The interactive loader: samples fed one at a time.

Counterpart of ``znicz_tpu/loader/interactive.py``
(``InteractiveLoader``, ``MAPPING = "interactive"``): a forward
workflow (``StandardWorkflowBase.create_workflow``, or
``StandardWorkflow.extract_forward_workflow``) pulls minibatches from
a host queue that :meth:`InteractiveLoader.feed` fills::

    loader = InteractiveLoader(wf, sample_shape=(28, 28, 1))
    loader.feed(img1); loader.feed(img2)
    loader.finish()           # no more samples; the epoch ends when drained
    wf.run()                  # the forward workflow consumes the queue

Every minibatch is of class TEST.  A feed after a drained session
re-arms the loader, so the workflow runs again.  The minibatch buffer
holds the engine's ``precision_dtype`` (float32 unless set); a fed
sample is first cast to float32, as the JAX loader stores it.
"""

import collections

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.loader.base import TEST, UserLoaderRegistry


class InteractiveLoader(Unit):
    """The loader contract over a host queue (class TEST)."""

    MAPPING = "interactive"

    def __init__(self, workflow, **kwargs):
        super(InteractiveLoader, self).__init__(workflow, **kwargs)
        self.sample_shape = tuple(kwargs["sample_shape"])
        self.max_minibatch_size = int(kwargs.get("minibatch_size", 1))
        #: the number of classes served (0: unknown, and the softmax
        #: head keeps its configured width)
        self.unique_labels_count = int(
            kwargs.get("unique_labels_count", 0))
        self.minibatch_data = Array(name="minibatch_data")
        self.minibatch_labels = Array(name="minibatch_labels")
        self.minibatch_size = 0
        self.minibatch_class = TEST
        self.minibatch_offset = 0
        self.epoch_number = 0
        self.epoch_ended = Bool(False)
        self.last_minibatch = Bool(False)
        self.train_ended = Bool(False)
        self.complete = Bool(False)
        self.class_lengths = [0, 0, 0]
        #: called after initialize (the softmax head's width hook)
        self.on_initialized = None
        self._queue = collections.deque()
        self._finished = False
        self._served = 0

    def initialize(self, device=None, **kwargs):
        super(InteractiveLoader, self).initialize(device=device, **kwargs)
        dtype = root.common.engine.get("precision_dtype") or numpy.float32
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + self.sample_shape, dtype))
        self.minibatch_labels.reset(numpy.zeros(
            self.max_minibatch_size, numpy.int32))
        for arr in (self.minibatch_data, self.minibatch_labels):
            arr.device = device
        if self.on_initialized is not None:
            self.on_initialized()

    # -- the producer side --------------------------------------------------
    def feed(self, sample, label=-1):
        """Queue one sample (a host array of ``sample_shape``).  A feed
        after a drained session clears the epoch flags, so the workflow
        runs again."""
        sample = numpy.asarray(sample, numpy.float32)
        if tuple(sample.shape) != self.sample_shape:
            raise ValueError("sample shape %s != %s"
                             % (sample.shape, self.sample_shape))
        if self._finished:
            self._finished = False
            self.complete <<= False
            self.epoch_ended <<= False
            self.last_minibatch <<= False
            self.train_ended <<= False
        self._queue.append((sample, int(label)))

    def finish(self):
        """No more samples: the epoch ends once the queue is drained."""
        self._finished = True

    # -- the consumer side --------------------------------------------------
    def run(self):
        n = min(len(self._queue), self.max_minibatch_size)
        if n == 0 and not self._finished:
            raise RuntimeError(
                "InteractiveLoader ran with an empty queue: feed() "
                "samples or finish() before running the workflow")
        self.minibatch_data.map_invalidate()
        self.minibatch_labels.map_write()
        for i in range(n):
            sample, label = self._queue.popleft()
            self.minibatch_data.mem[i] = sample
            self.minibatch_labels.mem[i] = label
        self.minibatch_size = n
        self.minibatch_offset = self._served + n
        self._served += n
        self.class_lengths[TEST] = self._served
        drained = self._finished and not self._queue
        self.last_minibatch <<= drained
        self.epoch_ended <<= drained
        self.train_ended <<= drained
        self.complete <<= drained
        if drained:
            self.epoch_number += 1


# a Unit, not a Loader: the metaclass does not register it
UserLoaderRegistry.loaders[InteractiveLoader.MAPPING] = InteractiveLoader
