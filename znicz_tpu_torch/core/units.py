"""The Unit dataflow-graph node.

Counterpart of ``znicz_tpu/core/units.py`` (``Unit`` :40-248) without
its telemetry hooks:

* ``link_from(*parents)`` / ``unlink_from(*parents)`` /
  ``unlink_all()`` — control edges; a unit fires when ALL parents have
  signalled (a ``Repeater`` fires on ANY);
* ``link_attrs(other, "a", ("mine", "theirs"))`` — live attribute
  aliasing: reads and writes forward to the source unit;
* ``gate_block`` / ``gate_skip`` — :class:`~znicz_tpu_torch.core.
  mutable.Bool` gates: *block* consumes the signal (no run, no
  propagation); *skip* propagates without running;
* ``demand("attr")`` — attributes that must be non-None by
  ``initialize``;
* ``exports`` — the attribute names a snapshot captures;
* ``stop()`` — a hook a unit with a thread or an open file overrides
  (the avatar's producer, the data saver's stream);
* ``is_master`` / ``is_slave`` / ``is_standalone`` (:216-229) — the
  role of the unit's workflow in the reference's master-slave run.

The graph is the epoch-level control plane and, in the unit-at-a-time
training graph, the per-minibatch one too (a unit a layer); in the
fused graph the per-minibatch compute lives in the trainer's tensors.
"""

import time

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.core.mutable import Bool


class Unit(Logger):
    """A node in the control-plane dataflow graph."""

    def __init__(self, workflow, **kwargs):
        self.name = kwargs.get("name", type(self).__name__)
        super(Unit, self).__init__(logger_name=self.name)
        self._links_from = {}      # src unit -> fired flag
        self._links_to = {}        # dst unit -> True
        self._linked_attrs_ = {}   # my attr -> (src unit, src attr, two_way)
        self.gate_block = kwargs.get("gate_block", Bool(False))
        self.gate_skip = kwargs.get("gate_skip", Bool(False))
        self._demanded = set()
        self._initialized = False
        self.run_was_called = False
        #: wall seconds and count of this unit's runs
        self.run_time_ = 0.0
        self.run_count_ = 0
        self.workflow = None
        if workflow is not None:
            workflow.add_unit(self)

    # -- attribute forwarding ----------------------------------------------
    def __getattr__(self, name):
        # only called when normal lookup fails
        if name.startswith("_"):
            raise AttributeError(name)
        linked = self.__dict__.get("_linked_attrs_")
        if linked and name in linked:
            src, src_attr, _ = linked[name]
            return getattr(src, src_attr)
        raise AttributeError("%s has no attribute %r" % (self.name, name))

    def __setattr__(self, name, value):
        linked = self.__dict__.get("_linked_attrs_")
        if linked and name in linked:
            src, src_attr, two_way = linked[name]
            if two_way:
                setattr(src, src_attr, value)
            else:
                del linked[name]  # a local write detaches a one-way alias
                object.__setattr__(self, name, value)
            return
        object.__setattr__(self, name, value)

    def link_attrs(self, other, *args, two_way=True):
        """Alias attributes of ``other`` as my own (live references).
        ``two_way=False`` makes a read-only alias: a local write
        detaches the link instead of mutating the source unit."""
        for arg in args:
            mine, theirs = arg if isinstance(arg, tuple) else (arg, arg)
            self.__dict__.pop(mine, None)
            self._linked_attrs_[mine] = (other, theirs, two_way)
        return self

    def has_linked_attr(self, name):
        return name in self._linked_attrs_

    # -- demands ------------------------------------------------------------
    def demand(self, *names):
        self._demanded.update(names)

    def _check_demands(self):
        missing = []
        for name in sorted(self._demanded):
            try:
                v = getattr(self, name)
            except AttributeError:
                v = None
            if v is None:
                missing.append(name)
        return missing

    # -- control edges -------------------------------------------------------
    def link_from(self, *parents):
        for p in parents:
            self._links_from[p] = False
            p._links_to[self] = True
        return self

    def unlink_from(self, *parents):
        for p in parents:
            self._links_from.pop(p, None)
            p._links_to.pop(self, None)
        return self

    def unlink_all(self):
        """Drop every control edge into and out of this unit."""
        for p in list(self._links_from):
            self.unlink_from(p)
        for d in list(self._links_to):
            d.unlink_from(self)
        return self

    @property
    def links_from(self):
        return self._links_from

    @property
    def links_to(self):
        return self._links_to

    # -- firing protocol -----------------------------------------------------
    def _signal(self, src):
        """A parent finished; fire when all parents have."""
        if src in self._links_from:
            self._links_from[src] = True
        if self._ready_to_fire():
            self.workflow._schedule(self)

    def _ready_to_fire(self):
        return all(self._links_from.values())

    def _reset_fired(self):
        for k in self._links_from:
            self._links_from[k] = False

    def _fire(self):
        """Called by the workflow scheduler when this unit's turn comes."""
        self._reset_fired()
        if bool(self.gate_block):
            return  # consume the signal
        if not bool(self.gate_skip):
            t0 = time.perf_counter()
            self.run()
            self.run_time_ += time.perf_counter() - t0
            self.run_count_ += 1
            self.run_was_called = True
        for dst in list(self._links_to):
            dst._signal(self)

    # -- lifecycle ------------------------------------------------------------
    @property
    def initialized(self):
        return self._initialized

    # -- the role in a master-slave run -----------------------------------
    @property
    def is_slave(self):
        wf = self.workflow
        return wf.is_slave if wf is not None else False

    @property
    def is_master(self):
        wf = self.workflow
        return wf.is_master if wf is not None else False

    @property
    def is_standalone(self):
        return not self.is_slave and not self.is_master

    def initialize(self, device=None, **kwargs):
        """Allocate buffers etc.  Subclasses override; call super() first."""
        self._initialized = True

    def run(self):
        pass

    def stop(self):
        pass

    def __repr__(self):
        return "<%s %r>" % (type(self).__name__, self.name)
