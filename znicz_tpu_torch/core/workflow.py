"""Workflow — a container of units with a FIFO dataflow scheduler.

Counterpart of ``znicz_tpu/core/workflow.py`` (:22-294: ``NoMoreJobs``,
``StartPoint``, ``EndPoint``, ``Repeater``, ``Workflow``) without the
profiler hooks and the Dummy* helpers.  Units fire when all their
parents have signalled and their gates permit; a ``Repeater`` fires
on any parent and closes the training loop:

    repeater -> loader -> trainer -> evaluator -> decision
      -> snapshotter -> (back to repeater) / end_point

with ``decision.complete`` blocking the repeater and opening the end
point.
"""

from collections import deque

from znicz_tpu_torch.core.units import Unit


class NoMoreJobs(Exception):
    """Raised by a unit when the run is over."""


class StartPoint(Unit):
    pass


class EndPoint(Unit):
    def run(self):
        self.workflow._on_end_point()


class Repeater(Unit):
    """Fires on ANY parent signal — the loop-closing unit."""

    def _ready_to_fire(self):
        return any(self._links_from.values()) or not self._links_from


class Workflow(Unit):
    """A unit container and scheduler.  Nestable (a Workflow is a Unit)."""

    def __init__(self, workflow=None, **kwargs):
        self._units = []
        super(Workflow, self).__init__(workflow, **kwargs)
        self.start_point = StartPoint(self, name="start_point")
        self.end_point = EndPoint(self, name="end_point")
        self._queue = deque()
        self._running = False

    # -- container -----------------------------------------------------------
    def add_unit(self, unit):
        if unit.workflow is not None and unit.workflow is not self:
            raise ValueError("%s already belongs to workflow %s"
                             % (unit.name, unit.workflow.name))
        if unit.workflow is None:
            unit.workflow = self
            self._units.append(unit)
        return unit

    @property
    def units(self):
        return list(self._units)

    # -- lifecycle -----------------------------------------------------------
    def initialize(self, device=None, **kwargs):
        """Initialize every unit in graph order, retrying units whose
        demanded attributes another unit's initialize produces, until
        none is left (or none can make progress: then raise)."""
        super(Workflow, self).initialize(device=device, **kwargs)
        pending = [u for u in self._units if not u.initialized]
        order = self._graph_order()
        pending.sort(key=lambda u: order.get(u, len(order)))
        while pending:
            deferred = []
            for u in pending:
                missing = u._check_demands()
                if missing:
                    deferred.append((u, missing))
                    continue
                u.initialize(device=device, **kwargs)
                u._initialized = True
            if len(deferred) == len(pending):
                raise RuntimeError(
                    "Workflow.initialize deadlock — unsatisfied demands: "
                    + "; ".join("%s needs %s" % (u.name, m)
                                for u, m in deferred))
            pending = [u for u, _ in deferred]
        return self

    def _graph_order(self):
        """BFS order over control links from start_point."""
        order = {}
        q = deque([self.start_point])
        seen = {self.start_point}
        while q:
            u = q.popleft()
            order[u] = len(order)
            for dst in u._links_to:
                if dst not in seen:
                    seen.add(dst)
                    q.append(dst)
        return order

    # -- scheduler -----------------------------------------------------------
    def _schedule(self, unit):
        self._queue.append(unit)

    def run(self):
        """Run the dataflow until quiescence or the end point."""
        self._running = True
        self._queue.clear()
        for u in self._units:
            u._reset_fired()
        self._schedule(self.start_point)
        try:
            while self._queue and self._running:
                self._queue.popleft()._fire()
        except NoMoreJobs:
            pass
        self._running = False
        return self

    def _on_end_point(self):
        self._running = False
