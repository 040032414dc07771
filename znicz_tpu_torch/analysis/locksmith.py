"""Runtime lock-order sanitizer — the dynamic half of graftlint.

Counterpart of ``znicz_tpu/analysis/locksmith.py``, with the same API
(:func:`enabled`, :func:`lock`, :func:`rlock`, :func:`condition`,
:func:`arm`, :func:`disarm`, :func:`reset`, :func:`report`,
:func:`assert_clean`, :func:`note_blocking`,
:class:`LockOrderViolation`).

The serving plane is a web of threaded modules whose locks nest: the
registry lock around engine load locks, dispatch slots around the
batcher's condition, breaker locks under the engine's breaker lock,
the kernels' build locks under whatever first runs a forward.  The
static ``lock-guard`` checker pins each class's guard discipline; this
module watches what no intraprocedural analysis sees, the global
acquisition ORDER:

* every lock made through :func:`lock` / :func:`rlock` /
  :func:`condition` while the sanitizer is enabled is a tracked
  wrapper that records, per thread, the stack of locks it holds;
* acquiring B while holding A adds the edge ``A -> B`` (role names,
  the first-seen acquisition stacks of both ends kept) to a
  process-wide graph; an edge that closes a cycle is a potential ABBA
  deadlock and is recorded as a violation with BOTH stacks;
* **blocking while holding**: ``concurrent.futures.Future.result``
  (patched by :func:`arm`) and ``Condition.wait`` entered while the
  thread holds any OTHER tracked lock record a violation carrying the
  blocked call's stack and each held lock's acquisition stack.  The
  port's engines warm up on one long-lived thread and the caller waits
  in ``future.result()`` (``serving/engine.py`` ``on_warm_thread``),
  so a warm-up reached under a tracked lock is exactly this class.

Gate discipline (as in ``core/health.py``): everything is behind
``root.common.analysis.lock_sanitizer``.  Off, the factories read ONE
config predicate and return plain ``threading`` primitives: no
wrapper, no per-acquire cost.  Tracking is decided when a lock is
MADE, so arm the sanitizer before building the objects under test;
:func:`arm` also wraps the known MODULE-level locks (made at import,
before any arm) in place, around the existing lock, and
:func:`disarm` puts the originals back.

Violations are recorded, never raised mid-flight: a sanitizer must
observe the race, not perturb it.  :func:`assert_clean` raises
:class:`LockOrderViolation` with the full report.  Beyond the JAX
package's report, :func:`report` counts the tracked locks and the
acquisitions by role (``locks``, ``acquisitions``).
"""

import sys
import threading
import traceback

from znicz_tpu_torch.core.config import root

_cfg = root.common.analysis

#: stack-capture depth for violation reports — enough to see the call
#: path without drowning the report in pytest frames
_STACK_LIMIT = 16


class LockOrderViolation(RuntimeError):
    """Raised by :func:`assert_clean` when the armed sanitizer saw a
    cycle or a blocking call under a held lock.  Carries the full
    report (``.report``) including both stacks per violation."""

    def __init__(self, message, report):
        super().__init__(message)
        self.report = report


def enabled():
    """The one gate (a live config read)."""
    return bool(_cfg.get("lock_sanitizer", False))


# ---------------------------------------------------------------------------
# Process-wide state
# ---------------------------------------------------------------------------

_tls = threading.local()

#: guards the graph, the counts and the violation lists (a plain lock
#: on purpose: the sanitizer must never track itself)
_state_lock = threading.Lock()

#: (from_role, to_role) -> {"stack_from", "stack_to", "count"} —
#: first-seen stacks per edge
_edges = {}
#: adjacency view of _edges for the cycle search
_adj = {}
#: recorded cycle violations (deduplicated by node set)
_cycles = []
_cycle_keys = set()
#: recorded blocking-while-holding violations
_blocking = []
#: role -> tracked locks made (or module locks wrapped)
_made = {}
#: role -> acquisitions of its tracked locks
_acquired = {}


def _held():
    """This thread's stack of (tracked lock, acquisition stack)."""
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _capture():
    return "".join(traceback.format_stack(limit=_STACK_LIMIT)[:-2])


def _find_path(src, dst):
    """DFS: a role path src -> ... -> dst through recorded edges, or
    None.  Called under _state_lock."""
    stack, seen = [(src, (src,))], {src}
    while stack:
        node, path = stack.pop()
        for nxt in _adj.get(node, ()):
            if nxt == dst:
                return path + (dst,)
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + (nxt,)))
    return None


def _record_edge(held_entry, target, acq_stack):
    """Holding ``held_entry``'s lock, the thread is acquiring
    ``target``: record the order edge and check for a cycle."""
    a, b = held_entry[0].role, target.role
    if a == b:
        # same role, another instance (two engines' load locks): no
        # order to learn; an RLock's re-entry of the SAME instance
        # never reaches here
        return
    with _state_lock:
        edge = _edges.get((a, b))
        if edge is None:
            # b ~> a is searched BEFORE a -> b goes in, so the path
            # reported is the earlier order this acquisition contradicts
            rev = _find_path(b, a)
            _edges[(a, b)] = {"stack_from": held_entry[1],
                              "stack_to": acq_stack, "count": 1}
            _adj.setdefault(a, set()).add(b)
            if rev is not None:
                key = frozenset(rev)
                if key not in _cycle_keys:
                    _cycle_keys.add(key)
                    fwd = _edges[(a, b)]
                    rev_edge = _edges.get((rev[0], rev[1])) or {}
                    _cycles.append({
                        "kind": "lock-order-cycle",
                        "cycle": list(rev) + [b],
                        "edge": [a, b],
                        "held_stack": fwd["stack_from"],
                        "acquire_stack": fwd["stack_to"],
                        "reverse_edge": [rev[0], rev[1]],
                        "reverse_held_stack": rev_edge.get(
                            "stack_from", ""),
                        "reverse_acquire_stack": rev_edge.get(
                            "stack_to", ""),
                    })
        else:
            edge["count"] += 1


def note_blocking(what, ignore=None):
    """Record a blocking-while-holding violation if this thread holds
    any tracked lock (other than ``ignore``: a Condition's own lock is
    RELEASED by its wait).  The public hook for call sites that want
    to annotate their own blocking operations."""
    held = [e for e in _held() if e[0] is not ignore]
    if not held:
        return None
    v = {"kind": "blocking-under-lock",
         "blocking": what,
         "held": [e[0].role for e in held],
         "held_stacks": {e[0].role: e[1] for e in held},
         "stack": _capture()}
    with _state_lock:
        _blocking.append(v)
    return v


# ---------------------------------------------------------------------------
# Tracked primitives
# ---------------------------------------------------------------------------

class _TrackedLock(object):
    """Order-tracking wrapper over a ``threading`` lock.  ``role`` is
    the name edges aggregate by (two registries' locks are one role);
    re-entry of the SAME instance (RLock) is tracked by depth and
    never records an edge; a plain lock's blocking re-acquire by its
    holder is a one-lock cycle, its try-acquire is not."""

    def __init__(self, role, inner, reentrant=False):
        self.role = role
        self._inner = inner
        self._reentrant = reentrant
        with _state_lock:
            _made[role] = _made.get(role, 0) + 1

    def acquire(self, blocking=True, timeout=-1):
        held = _held()
        mine = [e for e in held if e[0] is self]
        if not mine:
            # the would-be edges are recorded BEFORE blocking on the
            # inner lock: a real ABBA interleaving is reported, not
            # hung on.  A re-entered RLock sits in the held stack once
            # a level: one edge a DISTINCT held lock
            stack = _capture()
            seen = set()
            for entry in held:
                if id(entry[0]) not in seen:
                    seen.add(id(entry[0]))
                    _record_edge(entry, self, stack)
        elif not self._reentrant and blocking:
            # a plain Lock taken again by its holder, blocking, is a
            # certain self-deadlock: reported as a one-lock cycle.  A
            # try-acquire (blocking=False) returns False at once and
            # hangs nothing, so it records nothing
            with _state_lock:
                _cycles.append({
                    "kind": "lock-order-cycle",
                    "cycle": [self.role, self.role],
                    "edge": [self.role, self.role],
                    "held_stack": mine[0][1],
                    "acquire_stack": _capture(),
                    "reverse_edge": [self.role, self.role],
                    "reverse_held_stack": "",
                    "reverse_acquire_stack": "",
                })
        ok = (self._inner.acquire(blocking, timeout)
              if timeout != -1 else self._inner.acquire(blocking))
        if ok:
            held.append((self, _capture()))
            with _state_lock:
                _acquired[self.role] = _acquired.get(self.role, 0) + 1
        return ok

    def release(self):
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                del held[i]
                break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, name):
        # exact API parity with the wrapped primitive: locked() and
        # the rest exist on the wrapper iff the inner lock has them
        return getattr(self._inner, name)


class _TrackedCondition(_TrackedLock):
    """Condition variable with the same order tracking.  ``wait``
    RELEASES the underlying lock, so the held stack drops this lock
    for its duration; waiting while holding any OTHER tracked lock is
    blocking-under-lock and is recorded."""

    def __init__(self, role):
        super().__init__(role, threading.Condition(), reentrant=False)

    def _drop_for_wait(self):
        held = _held()
        mine = [(i, e) for i, e in enumerate(held) if e[0] is self]
        for i, _ in reversed(mine):
            del held[i]
        return [e for _, e in mine]

    def _restore_after_wait(self, entries):
        _held().extend(entries)

    def wait(self, timeout=None):
        note_blocking("Condition.wait(%s)" % self.role, ignore=self)
        entries = self._drop_for_wait()
        try:
            return self._inner.wait(timeout)
        finally:
            self._restore_after_wait(entries)

    def wait_for(self, predicate, timeout=None):
        note_blocking("Condition.wait_for(%s)" % self.role,
                      ignore=self)
        entries = self._drop_for_wait()
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._restore_after_wait(entries)

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()


# ---------------------------------------------------------------------------
# Factories — what the threaded modules call
# ---------------------------------------------------------------------------

def lock(role):
    """A mutex for ``role`` (e.g. ``"serving.registry"``): a tracked
    wrapper while the sanitizer is enabled, a plain
    ``threading.Lock`` otherwise.  The disabled path is ONE config
    predicate; tracking is decided here, at creation."""
    if not enabled():
        return threading.Lock()
    return _TrackedLock(role, threading.Lock())


def rlock(role):
    """Re-entrant variant: re-entry of the same instance never
    records."""
    if not enabled():
        return threading.RLock()
    return _TrackedLock(role, threading.RLock(), reentrant=True)


def condition(role):
    """Condition-variable variant (``wait`` drops the lock from the
    held stack; waiting while holding another tracked lock is a
    blocking-under-lock violation)."""
    if not enabled():
        return threading.Condition()
    return _TrackedCondition(role)


# ---------------------------------------------------------------------------
# Arming, reporting
# ---------------------------------------------------------------------------

_future_orig = None

#: locks made at IMPORT (always before any arm() can flip the gate, so
#: the factories handed out plain ones): arm() wraps each in place,
#: around the EXISTING lock, so a thread already inside one keeps its
#: mutual exclusion, and disarm() puts the originals back.  The
#: attribute is a dotted path from the module (a module-level object's
#: lock); the JAX package's six entries come first, then the module
#: locks it makes through the factories but never wraps, then the
#: port's own (the engine's dispatch count and warm-up thread, the
#: profiler's running count, the telemetry rings, the kernels' builds)
_MODULE_LOCKS = (
    ("znicz_tpu_torch.core.telemetry", "_lock", "telemetry.registry"),
    ("znicz_tpu_torch.core.compile_cache", "_lock", "compile_cache"),
    ("znicz_tpu_torch.core.faults", "_registry_lock", "faults.module"),
    ("znicz_tpu_torch.core.health", "_monitor_lock", "health.module"),
    ("znicz_tpu_torch.core.profiler", "_state_lock", "profiler.module"),
    ("znicz_tpu_torch.core.profiler", "_capture_lock",
     "profiler.capture"),
    ("znicz_tpu_torch.core.timeseries", "_lock", "timeseries.registry"),
    ("znicz_tpu_torch.core.status_server", "_capture_guard",
     "status_server.debug_capture"),
    ("znicz_tpu_torch.core.blackbox", "_lock", "blackbox.writer"),
    ("znicz_tpu_torch.core.pyprof", "_lock", "pyprof.state"),
    ("znicz_tpu_torch.serving.reqtrace", "_lock", "serving.reqtrace"),
    ("znicz_tpu_torch.core.telemetry", "_journal._lock",
     "telemetry.ring"),
    ("znicz_tpu_torch.core.telemetry", "_trace._lock", "telemetry.ring"),
    ("znicz_tpu_torch.core.profiler", "_running_lock",
     "profiler.running"),
    ("znicz_tpu_torch.serving.engine", "_DISPATCHES_LOCK",
     "serving.engine.dispatches"),
    ("znicz_tpu_torch.serving.engine", "_warm_lock",
     "serving.engine.warm"),
    ("znicz_tpu_torch.ops.cuda_pooling", "_lock",
     "ops.cuda_pooling.build"),
    ("znicz_tpu_torch.ops.cuda_pooling_backward", "_lock",
     "ops.cuda_pooling_backward.build"),
)
_module_lock_originals = {}


def _owner(modname, attr):
    """``(object holding the lock, its attribute name)`` of a
    ``_MODULE_LOCKS`` entry, None where its module is not imported:
    nothing here forces an import."""
    obj = sys.modules.get(modname)
    path = attr.split(".")
    for part in path[:-1]:
        if obj is None:
            return None
        obj = getattr(obj, part, None)
    if obj is None:
        return None
    return obj, path[-1]


def _wrap_module_locks():
    for modname, attr, role in _MODULE_LOCKS:
        found = _owner(modname, attr)
        if found is None:
            continue
        obj, name = found
        cur = getattr(obj, name, None)
        if cur is None or isinstance(cur, _TrackedLock):
            continue
        _module_lock_originals[(modname, attr)] = cur
        setattr(obj, name, _TrackedLock(role, cur))


def _unwrap_module_locks():
    for (modname, attr), orig in _module_lock_originals.items():
        found = _owner(modname, attr)
        if found is None:
            continue
        obj, name = found
        if isinstance(getattr(obj, name, None), _TrackedLock):
            setattr(obj, name, orig)
    _module_lock_originals.clear()


def arm(patch_future=True):
    """Enable the sanitizer: flip the gate (object locks made from
    here on are tracked), wrap the known module-level locks in place,
    and (by default) patch ``concurrent.futures.Future.result`` so a
    result() wait under any tracked lock is recorded.  Idempotent;
    pair it with :func:`disarm`."""
    global _future_orig
    root.common.analysis.lock_sanitizer = True
    _wrap_module_locks()
    if patch_future and _future_orig is None:
        import concurrent.futures
        _future_orig = concurrent.futures.Future.result

        def result(self, timeout=None):
            note_blocking("Future.result")
            return _future_orig(self, timeout)

        concurrent.futures.Future.result = result
    return True


def disarm():
    """Restore the gate, the module-level locks and
    ``Future.result``.  What was recorded stays until :func:`reset`:
    a teardown disarms first, then asserts."""
    global _future_orig
    root.common.analysis.lock_sanitizer = False
    _unwrap_module_locks()
    if _future_orig is not None:
        import concurrent.futures
        concurrent.futures.Future.result = _future_orig
        _future_orig = None
    return False


def reset():
    """Drop the recorded graph, counts and violations (one test's
    isolation).  Live threads' held stacks are thread-local and drain
    by themselves."""
    with _state_lock:
        _edges.clear()
        _adj.clear()
        _cycles[:] = []
        _cycle_keys.clear()
        _blocking[:] = []
        _made.clear()
        _acquired.clear()


def report():
    """The sanitizer's view: the acquisition-order edges (with
    counts), every recorded violation with its stacks, and the tracked
    locks and acquisitions by role."""
    with _state_lock:
        return {
            "enabled": enabled(),
            "edges": {"%s -> %s" % k: v["count"]
                      for k, v in _edges.items()},
            "cycles": [dict(c) for c in _cycles],
            "blocking": [dict(b) for b in _blocking],
            "locks": dict(_made),
            "acquisitions": dict(_acquired),
        }


def assert_clean():
    """Raise :class:`LockOrderViolation` if any cycle or
    blocking-under-lock was recorded; return the report otherwise."""
    rep = report()
    if not rep["cycles"] and not rep["blocking"]:
        return rep
    lines = []
    for c in rep["cycles"]:
        lines.append("lock-order cycle %s (edge %s -> %s):"
                     % (" -> ".join(c["cycle"]), c["edge"][0],
                        c["edge"][1]))
        lines.append("  held %s at:\n%s" % (c["edge"][0],
                                            c["held_stack"]))
        lines.append("  acquiring %s at:\n%s" % (c["edge"][1],
                                                 c["acquire_stack"]))
        if c.get("reverse_acquire_stack"):
            lines.append("  reverse edge %s -> %s acquired at:\n%s"
                         % (c["reverse_edge"][0], c["reverse_edge"][1],
                            c["reverse_acquire_stack"]))
    for b in rep["blocking"]:
        lines.append("blocking call %r while holding %s:"
                     % (b["blocking"], ", ".join(b["held"])))
        lines.append("  blocked at:\n%s" % b["stack"])
        for role, stack in b["held_stacks"].items():
            lines.append("  %s acquired at:\n%s" % (role, stack))
    raise LockOrderViolation(
        "%d lock-order cycle(s), %d blocking-under-lock call(s)\n%s"
        % (len(rep["cycles"]), len(rep["blocking"]),
           "\n".join(lines)), rep)
