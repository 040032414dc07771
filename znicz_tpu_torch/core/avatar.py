"""Avatar — a prefetching mirror of a loader.

Counterpart of ``znicz_tpu/core/avatar.py``: a producer thread runs
the real loader one minibatch (up to ``queue_depth``) ahead of the
workflow and hands each minibatch over through a bounded queue, so the
loader's host work (the gather of a minibatch, the epoch's shuffle)
overlaps the device's.  The avatar mirrors the loader's attributes, so
units linked to it (``link_attrs(avatar, "minibatch_data")``, gates on
``~avatar.epoch_ended``) see the stream the loader serves.

The producer touches no CUDA: it runs ``loader.run()`` (host numpy)
and takes private numpy copies of the minibatch.  The consumer
(:meth:`Avatar.run`, on the workflow's thread) adopts those copies
into its mirror Arrays (``Array.reset``), whose ``device`` is the
loader's, so a unit's ``.dev`` uploads them on the workflow's thread.
The JAX avatar copies each minibatch a second time into its mirror
(``cur.mem[...] = value``); adopting the producer's private copy
instead is a difference in how, not in what (``ROADMAP.md``).

No fallback: a producer that raises surfaces on the consumer as
``RuntimeError("avatar producer failed")`` (the loader's error as its
cause), and :meth:`Avatar.stop`, registered with the workflow's
``on_workflow_finished``, joins the producer whenever the run returns
or raises.  While the profiler is armed the data wait of a minibatch
is the consumer's wait on the queue; the loader's own serve time
(which runs ahead, on the producer) is not counted again.
"""

import queue
import threading
import time

import numpy

from znicz_tpu_torch.core import profiler
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.units import Unit

#: the loader's attributes mirrored each minibatch
MINIBATCH_ATTRS = (
    "minibatch_data", "minibatch_labels", "minibatch_indices",
    "minibatch_targets", "minibatch_class", "minibatch_size",
    "minibatch_offset", "epoch_ended", "epoch_number", "last_minibatch",
)

#: its attributes cloned at initialize
STATIC_ATTRS = (
    "class_lengths", "max_minibatch_size", "total_samples", "has_labels",
    "labels_mapping", "normalizer", "target_normalizer", "class_targets",
)

#: the producer thread's name prefix
THREAD_PREFIX = "znicz:loader-avatar-"


class Avatar(Unit):
    """Prefetching mirror of ``loader``.  kwargs: ``loader`` (the real
    loader unit), ``queue_depth`` (minibatches prefetched, default 2),
    ``extra_attrs`` (more attribute names mirrored each minibatch)."""

    def __init__(self, workflow, **kwargs):
        super(Avatar, self).__init__(workflow, **kwargs)
        self.loader = kwargs.get("loader")
        self.queue_depth = int(kwargs.get("queue_depth", 2))
        self.extra_attrs = tuple(kwargs.get("extra_attrs", ()))
        self._queue = None
        self._thread = None
        self._stop_evt = threading.Event()
        self._error = None
        self._cloned = False
        if self.loader is not None:
            # now, so that gate expressions built at link time
            # (~avatar.epoch_ended) hold this unit's own Bools
            self.clone()

    # -- cloning ------------------------------------------------------------
    def clone(self):
        """Copy the loader's static and current minibatch attributes
        onto this unit.  Arrays and Bools become the avatar's own
        objects, made once and then updated, so links and gates built
        against the avatar stay valid while the loader runs ahead."""
        names = [n for n in STATIC_ATTRS + MINIBATCH_ATTRS +
                 self.extra_attrs if hasattr(self.loader, n)]
        if self._cloned:
            self._merge({n: _snapshot(getattr(self.loader, n))
                         for n in names})
            return
        self._cloned = True
        for name in names:
            value = getattr(self.loader, name)
            if isinstance(value, Array):
                mirror = Array(name="%s@avatar" % name)
                mirror.device = value.device
                if value:
                    mirror.reset(_snapshot(value))
                setattr(self, name, mirror)
            elif isinstance(value, Bool):
                setattr(self, name, Bool(bool(value)))
            else:
                setattr(self, name, _snapshot(value))

    def initialize(self, device=None, **kwargs):
        super(Avatar, self).initialize(device=device, **kwargs)
        if self.loader is None:
            raise ValueError("Avatar needs a loader")
        if not self.loader.initialized:
            self.loader.initialize(device=device, **kwargs)
        self.clone()
        for name in MINIBATCH_ATTRS + self.extra_attrs:
            mirror = getattr(self, name, None)
            src = getattr(self.loader, name, None)
            if isinstance(mirror, Array) and isinstance(src, Array):
                mirror.device = src.device
        # the consumer notes the data wait (the queue's); the loader's
        # own serve runs ahead on the producer
        self.loader.notes_data_wait = False
        self._queue = queue.Queue(maxsize=self.queue_depth)
        self._stop_evt.clear()
        if self.workflow is not None:
            self.workflow.on_workflow_finished(self.stop)

    def _ensure_producer(self):
        # started at the first minibatch, not in initialize: the
        # workflow's initialize may still touch the real loader
        if self._thread is None:
            self._stop_evt.clear()
            self._error = None
            self._thread = threading.Thread(
                target=self._produce, name=THREAD_PREFIX + self.loader.name,
                daemon=True)
            self._thread.start()

    # -- producer side ------------------------------------------------------
    def _put(self, item):
        while not self._stop_evt.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _produce(self):
        try:
            while not self._stop_evt.is_set():
                self.loader.run()
                self._put({name: _snapshot(getattr(self.loader, name))
                           for name in MINIBATCH_ATTRS + self.extra_attrs
                           if hasattr(self.loader, name)})
        except BaseException as e:  # noqa: BLE001 - raised on the consumer
            self._error = e
            self._put(None)

    # -- consumer side ------------------------------------------------------
    def run(self):
        self._ensure_producer()
        t0 = time.perf_counter() if profiler.enabled() else None
        item = self._queue.get()
        if item is None:
            raise RuntimeError("avatar producer failed") from self._error
        self._merge(item)
        if t0 is not None:
            profiler.note_data_wait(time.perf_counter() - t0)

    def _merge(self, item):
        """Update the mirrored attributes in place: an Array adopts the
        producer's private copy, a Bool takes its value."""
        for name, value in item.items():
            cur = getattr(self, name, None)
            if isinstance(cur, Array):
                if isinstance(value, numpy.ndarray):
                    cur.reset(value)
                # else: the loader's Array is still empty; keep the mirror
            elif isinstance(cur, Bool):
                cur <<= bool(value)
            else:
                setattr(self, name, value)

    def stop(self):
        """Stop and join the producer (minibatches it made ahead are
        dropped)."""
        self._stop_evt.set()
        thread, self._thread = self._thread, None
        if thread is None:
            return
        while thread.is_alive():
            # unblock a producer waiting on a full queue
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.1)


def _snapshot(value):
    """A copy safe to hand across the thread boundary: a private numpy
    copy of an Array's host data (None for an empty Array), of an
    ndarray, or a Bool's value."""
    if isinstance(value, Array):
        if not value:
            return None
        return numpy.array(value.mem)
    if isinstance(value, numpy.ndarray):
        return value.copy()
    if isinstance(value, Bool):
        return bool(value)
    return value
