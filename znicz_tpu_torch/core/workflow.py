"""Workflow — a container of units with a FIFO dataflow scheduler.

Counterpart of ``znicz_tpu/core/workflow.py`` (:22-294: ``NoMoreJobs``,
``StartPoint``, ``EndPoint``, ``Repeater``, ``Workflow``, with
``del_ref`` :93, ``stop`` / ``stopped`` / ``on_workflow_finished``
:213-219, ``as_dot``, ``dump_graph``, ``run_profiled`` and
``log_unit_timings`` :228-300, the journal's ``config`` and
``workflow.run`` events :134, :192, and the armed profiler's
device-memory sample at the end of a run) without the Dummy* helpers.
The callbacks given to ``on_workflow_finished`` run once each time
``run`` returns, also when it raises (the avatar's producer thread is
joined, the data saver's stream closed, either way).  Units fire when all their
parents have signalled and their gates permit; a ``Repeater`` fires
on any parent and closes the training loop:

    repeater -> loader -> trainer -> evaluator -> decision
      -> snapshotter -> (back to repeater) / end_point

with ``decision.complete`` blocking the repeater and opening the end
point.
"""

from collections import deque

from znicz_tpu_torch.core import profiler, telemetry
from znicz_tpu_torch.core.config import root
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
        self._finished_callbacks = []
        self._is_slave = False
        self._is_master = False

    # -- container -----------------------------------------------------------
    def add_unit(self, unit):
        if unit.workflow is not None and unit.workflow is not self:
            raise ValueError("%s already belongs to workflow %s"
                             % (unit.name, unit.workflow.name))
        if unit.workflow is None:
            unit.workflow = self
            self._units.append(unit)
        return unit

    def add_ref(self, unit):
        return self.add_unit(unit)

    def del_ref(self, unit):
        """Take ``unit`` out of the container (its links stay): it is
        neither initialized nor snapshotted by this workflow."""
        if unit in self._units:
            self._units.remove(unit)
            unit.workflow = None

    @property
    def units(self):
        return list(self._units)

    # -- roles (JAX :105-116): a workflow is standalone unless a
    # master-slave launcher marks it -----------------------------------------
    @property
    def is_slave(self):
        return self._is_slave

    @property
    def is_master(self):
        return self._is_master

    @property
    def is_standalone(self):
        return not (self._is_slave or self._is_master)

    # -- lifecycle -----------------------------------------------------------
    def initialize(self, device=None, **kwargs):
        """Initialize every unit in graph order, retrying units whose
        demanded attributes another unit's initialize produces, until
        none is left (or none can make progress: then raise)."""
        super(Workflow, self).initialize(device=device, **kwargs)
        if telemetry.journal_enabled():
            # the journal's first entry: which workflow, which config
            telemetry.record_event("config", workflow=self.name,
                                   config=root.as_dict())
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
        telemetry.record_event("workflow.run", workflow=self.name)
        try:
            try:
                while self._queue and self._running:
                    self._queue.popleft()._fire()
            except NoMoreJobs:
                pass
        except BaseException:
            self._running = False
            self._run_finished_callbacks(raising=True)
            raise
        self._running = False
        if profiler.enabled():
            # the caching allocator's counters at the end of a run
            profiler.sample_device_memory()
        self._run_finished_callbacks()
        return self

    def _run_finished_callbacks(self, raising=False):
        """Each ``on_workflow_finished`` callback once; while the run
        raises, a callback's own error is logged and the run's error
        propagates."""
        for cb in list(self._finished_callbacks):
            if not raising:
                cb()
                continue
            try:
                cb()
            except Exception:   # noqa: BLE001 - the run's error wins
                self.exception("on_workflow_finished callback %r failed "
                               "while the run raised", cb)

    def _on_end_point(self):
        self._running = False

    def stop(self):
        """End the run after the unit firing now."""
        self._running = False

    def stopped(self):
        return not self._running

    def on_workflow_finished(self, callback=None):
        """Call ``callback()`` whenever :meth:`run` returns or raises."""
        if callback is not None:
            self._finished_callbacks.append(callback)

    # -- graph, profiling and timings ---------------------------------------
    def as_dot(self):
        """Graphviz DOT text of the control graph: a box a unit (its
        name, and its class where they differ), an edge a control
        link."""
        lines = ["digraph %s {" % type(self).__name__,
                 '  rankdir=TB; node [shape=box, fontsize=10];']
        ids = {u: "u%d" % i for i, u in enumerate(self._units)}
        for u in self._units:
            label = u.name if u.name == type(u).__name__ else \
                "%s\\n(%s)" % (u.name, type(u).__name__)
            lines.append('  %s [label="%s"];' % (ids[u], label))
        for u in self._units:
            for child in u._links_to:
                if child in ids:
                    lines.append("  %s -> %s;" % (ids[u], ids[child]))
        lines.append("}")
        return "\n".join(lines)

    def dump_graph(self, path):
        """Write the DOT graph to ``path`` (render with graphviz)."""
        with open(path, "w") as f:
            f.write(self.as_dot())
        self.info("workflow graph -> %s", path)
        return path

    def run_profiled(self, log_dir):
        """Run under the device trace the profiler's capture takes
        (``profiler.traced``): ``<log_dir>/trace.json``, a Chrome trace
        of the host and the card, drained before it closes.  Pair with
        :meth:`log_unit_timings` for the host's view."""
        with profiler.traced(str(log_dir)):
            self.run()
        return self

    def unit_timings(self):
        """``[(unit, total_seconds, run_count)]`` sorted by total time,
        longest first.  Work on the card is enqueued asynchronously, so
        a unit's time is its host time: the device's lands on whichever
        unit waits for it first."""
        rows = [(u, getattr(u, "run_time_", 0.0),
                 getattr(u, "run_count_", 0)) for u in self._units
                if getattr(u, "run_count_", 0)]
        rows.sort(key=lambda r: -r[1])
        return rows

    def log_unit_timings(self):
        """Log the per-unit wall-time table at INFO."""
        rows = self.unit_timings()
        total = sum(r[1] for r in rows) or 1.0
        self.info("unit timings (%d runs total):", sum(r[2] for r in rows))
        for unit, t, n in rows:
            self.info("  %-28s %8.3fs %6d runs  %5.1f%%",
                      unit.name, t, n, 100.0 * t / total)
