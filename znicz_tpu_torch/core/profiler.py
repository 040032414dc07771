"""Performance introspection — the cost registry, the device-memory
ledger and the step-time breakdown, with the device trace.

Counterpart of ``znicz_tpu/core/profiler.py``.  It answers three
questions before any performance work starts:

* **What work does a dispatch do?**  The cost registry: every entry
  point the JAX package registers (the fused step, windows and
  predicts, the GD units' updates, the serving forward buckets)
  registers its FLOPs and bytes accessed under the JAX package's names,
  beside the analytic ``flops_per_image`` estimate and its agreement
  band.  PyTorch has no compiler cost analysis, so the port counts the
  FIRST REAL DISPATCH of each name (:func:`count_cost`), never an extra
  run: FLOPs through ``torch.utils.flop_counter.FlopCounterMode`` (the
  matrix products and convolutions, forward and backward), bytes
  through a ``TorchDispatchMode`` that sums each aten op's operand and
  result bytes (views and allocations move nothing and are left out),
  and each hand-written kernel's own work, which its wrapper reports
  (:func:`kernel_cost`): a ctypes launch is invisible to dispatch
  modes.  The counted dispatch computes what an uncounted one does, bit
  for bit.  The port's fused window is a Python loop of K steps, which
  the count walks whole: no ``scan_steps`` scaling.
* **Where did the device memory go?**  The ledger: the bytes of every
  ``core/memory.Array`` device tensor by Array name, accounted at each
  upload, ``set_dev`` and ``reset`` (logical bytes, not the caching
  allocator's), its high-water mark, an epoch-boundary leak check
  (:func:`epoch_check`), and :func:`sample_device_memory`, the caching
  allocator's allocated, reserved and peak bytes from
  ``torch.cuda.memory_stats()`` (None entries without CUDA, as the JAX
  package's on backends that lack the stats).
* **Why is the step slow?**  The breakdown: a training window's wall
  time split into data wait, host collection, dispatch, device and
  readback (:class:`_WindowProbe`; the device part is an explicit
  synchronize of the window's device, paid only while armed, which
  drains the fused trainer's asynchronous window pipeline), and a GD
  unit's into dispatch and device (:func:`note_gd_step`), summed into an
  input-, compute- or host-bound verdict (:func:`breakdown_summary`).

Plus the device trace: ``torch.profiler`` over the CPU and the card
(:func:`traced`, the one capture, taken by ``GET /debug/profile``
through :func:`capture_trace`, by the ``profile`` CLI over a whole run
and by ``Workflow.run_profiled``), exported as a Chrome trace and
reduced to a table of device time by kernel name and coarse category
(:func:`device_table`, the counterpart of ``tools/profile_summary.py``'s
trace-directory mode, which reads XLA's planes only).  One capture runs
at a time (a second raises ``RuntimeError``; HTTP answers 409), and a
capture on the card that records no device event raises
:class:`EmptyDeviceTrace` instead of passing off a CPU-only trace.

The launch log (:func:`launch_log`): while armed, each hand-written
kernel's launch is recorded (its index, kernel, stream and the thread's
current stream) and annotated in the trace (``znicz_launch:<kernel>:
<index>``), so :func:`unmatched_launches` can name the launch whose
kernel record a trace lacks.  Off, the wrappers pay one global read.

Disabled discipline, as in the JAX package: every hook site guards
with ``if profiler.enabled():`` and every public hook guards again, so
with the flag off there is no device sync, no allocation and no
profiler state (``_state`` stays None).  The report (:func:`snapshot`,
:func:`export_report`) keeps the JAX package's keys, so
``tools/profile_summary.py --roofline`` and ``--ledger`` render it.
"""

import collections
import contextlib
import json
import logging
import os
import threading
import time

import torch

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core import telemetry

logger = logging.getLogger("profiler")

_cfg = root.common.profiler

#: breakdown part names, display order (sum over parts == wall)
PARTS = ("data_wait", "host_collect", "dispatch", "device", "readback")

#: the possible :func:`breakdown_summary` verdicts
VERDICTS = ("input-bound", "compute-bound", "host-bound")


def enabled():
    """The one gate every hook site tests (a live config read)."""
    return bool(_cfg.get("enabled", False))


def enable(**overrides):
    """Arm the profiler (optionally overriding config knobs)."""
    for k, v in overrides.items():
        setattr(root.common.profiler, k, v)
    root.common.profiler.enabled = True
    return True


def disable():
    root.common.profiler.enabled = False
    return False


# ---------------------------------------------------------------------------
# Process-global state (created on first ENABLED use only)
# ---------------------------------------------------------------------------

class DeviceLedger(object):
    """Byte-accounting of live device tensors, attributed by Array
    name.  ``swap(name, old, new)`` is the one mutation: it frees
    ``old`` bytes and allocates ``new`` (either may be 0), matching the
    replace-don't-mutate lifecycle of ``memory.Array._dev``."""

    def __init__(self):
        self.by_name = collections.defaultdict(int)
        self.live_bytes = 0
        self.high_water_bytes = 0
        self.allocs = 0
        self.frees = 0
        #: frees of bytes the ledger never saw allocated (clamped to
        #: keep counts non-negative): the observation missed
        #: allocations, and the live totals are lower bounds
        self.clamped_frees = 0
        self._lock = locksmith.lock("profiler.ledger")

    def swap(self, name, old_nbytes, new_nbytes):
        name = name or "<unnamed>"
        with self._lock:
            if old_nbytes:
                self.frees += 1
                drop = min(int(old_nbytes), self.by_name[name])
                if drop < int(old_nbytes):
                    self.clamped_frees += 1
                self.by_name[name] -= drop
                self.live_bytes -= drop
            if new_nbytes:
                self.allocs += 1
                self.by_name[name] += int(new_nbytes)
                self.live_bytes += int(new_nbytes)
                if self.live_bytes > self.high_water_bytes:
                    self.high_water_bytes = self.live_bytes

    def summary(self, top=16):
        with self._lock:
            names = {k: v for k, v in self.by_name.items() if v}
            live, hwm = self.live_bytes, self.high_water_bytes
            allocs, frees = self.allocs, self.frees
            clamped = self.clamped_frees
        ranked = sorted(names.items(), key=lambda kv: -kv[1])
        return {
            "live_bytes": live,
            "high_water_bytes": hwm,
            "allocs": allocs,
            "frees": frees,
            # every observed free was matched by an observed allocation
            "balanced": clamped == 0,
            "clamped_frees": clamped,
            "by_name": dict(ranked[:top]),
            "tracked_names": len(names),
        }


class _ProfilerState(object):
    """Everything the armed profiler accumulates."""

    def __init__(self):
        self.cost = {}                    # name -> cost-registry entry
        self.ledger = DeviceLedger()
        self.parts = collections.defaultdict(float)
        self.wall = 0.0
        self.windows = 0
        self.steps = 0
        self.probes_active = 0
        #: (epoch, ledger live bytes) at each epoch boundary
        self.epoch_bytes = []
        self.leak_suspects = 0
        self.lock = locksmith.lock("profiler.state")


_state = None
_state_lock = locksmith.lock("profiler.module")


def _prof():
    """The process-global profiler state (created on first use)."""
    global _state
    if _state is None:
        with _state_lock:
            if _state is None:
                _state = _ProfilerState()
    return _state


def reset():
    """Fresh profiler state (tests, per-phase isolation)."""
    global _state, _device_ops
    with _state_lock:
        _state = None
        _device_ops = None


# ---------------------------------------------------------------------------
# Pillar 1: the cost registry
# ---------------------------------------------------------------------------

#: aten ops that allocate without touching memory: no bytes accessed
_NO_BYTES = frozenset(("empty", "empty_strided", "empty_like",
                       "new_empty", "new_empty_strided", "resize_",
                       "set_", "lift_fresh", "record_stream"))


def _tensor_bytes(tree):
    from torch.utils._pytree import tree_flatten
    total = 0
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def _bytes_mode_class():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _BytesMode(TorchDispatchMode):
        """Sums each aten op's operand bytes and result bytes (each
        input read once, each output written once); views and
        allocations move nothing."""

        def __init__(self):
            super().__init__()
            self.nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and \
                    func.overloadpacket.__name__ not in _NO_BYTES:
                self.nbytes += _tensor_bytes((args, kwargs)) + \
                    _tensor_bytes(out)
            return out

    return _BytesMode


class _CostCount(object):
    """One counted dispatch: the dispatch modes' tallies and the
    hand-written kernels' own reports."""

    def __init__(self):
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernels = collections.Counter()


#: counted dispatches running in the process (0: kernel_cost returns at
#: once)
_running = 0
_running_lock = locksmith.lock("profiler.running")


def _active_count():
    """The count of the dispatch being counted where this code runs:
    it rides on the bytes mode, which PyTorch's autograd engine carries
    into the threads that run a backward (so a kernel launched by a
    backward reports to its step's count), or None."""
    from torch.utils._python_dispatch import (
        _get_current_dispatch_mode_stack)
    for mode in _get_current_dispatch_mode_stack():
        count = getattr(mode, "cost_count", None)
        if count is not None:
            return count
    return None


def kernel_cost(name, flops, nbytes):
    """A hand-written kernel's wrapper reports the work of one launch
    (its operations and the bytes its bound counts); it reaches the
    registry only inside a counted dispatch."""
    if not _running:
        return
    count = _active_count()
    if count is not None:
        count.kernel_flops += float(flops)
        count.kernel_bytes += float(nbytes)
        count.kernels[name] += 1


def register_cost(name, flops, bytes_accessed, analytic_flops=None,
                  **meta):
    """Register one entry point's counted FLOPs and bytes (the
    counterpart of the JAX package's ``register_jit_cost``).  A name
    registered already returns its entry unchanged.
    ``analytic_flops`` is the closed-form estimate to cross-check
    (``3 * flops_per_image * batch * steps`` for training); the entry
    records the measured/analytic ratio and whether it is inside the
    ``cost_rtol`` band.  ``meta`` rides on the entry."""
    if not enabled():
        return None
    p = _prof()
    with p.lock:
        entry = p.cost.get(name)
    if entry is not None:
        return entry
    flops, nbytes = float(flops), float(bytes_accessed)
    entry = {"name": name, "flops": flops, "bytes_accessed": nbytes,
             "operational_intensity": flops / nbytes if nbytes else None}
    if analytic_flops:
        entry["analytic_flops"] = float(analytic_flops)
        if flops:
            ratio = flops / float(analytic_flops)
            rtol = float(_cfg.get("cost_rtol", 0.5))
            entry["flops_ratio_measured_vs_analytic"] = ratio
            entry["agreement"] = bool(1.0 - rtol <= ratio <= 1.0 + rtol)
    if meta:
        entry["meta"] = meta
    with p.lock:
        entry = p.cost.setdefault(name, entry)
        count = len(p.cost)
    telemetry.gauge("profiler.executables").set(count)
    telemetry.record_event(
        "profiler.cost_registered", name=name, flops=entry.get("flops"),
        bytes_accessed=entry.get("bytes_accessed"),
        analytic_flops=entry.get("analytic_flops"))
    return entry


@contextlib.contextmanager
def count_cost(name, analytic_flops=None, **meta):
    """Count the dispatch run inside the ``with`` as ``name``'s cost,
    on the first dispatch of ``name`` only: a registered name, a
    disabled profiler or a count already running in this thread (an
    entry point inside another's dispatch) runs it uncounted.  A
    dispatch that raises registers nothing.  Yields the count, or None
    where nothing is counted."""
    global _running
    if not enabled() or cost_entry(name) is not None or \
            (_running and _active_count() is not None):
        yield None
        return
    from torch.utils.flop_counter import FlopCounterMode
    count = _CostCount()
    flop_mode = FlopCounterMode(display=False)
    bytes_mode = _bytes_mode_class()()
    bytes_mode.cost_count = count
    with _running_lock:
        _running += 1
    try:
        with flop_mode, bytes_mode:
            yield count
    finally:
        with _running_lock:
            _running -= 1
    flops = float(flop_mode.get_total_flops()) + count.kernel_flops
    nbytes = float(bytes_mode.nbytes) + count.kernel_bytes
    if count.kernels:
        meta["kernel_launches"] = dict(count.kernels)
    register_cost(name, flops, nbytes, analytic_flops=analytic_flops,
                  **meta)


def cost_entry(name):
    """The registered entry for ``name`` (None when absent/disabled)."""
    if _state is None:
        return None
    with _state.lock:
        return _state.cost.get(name)


def cost_registry():
    """All registered entries, in registration order (empty when the
    profiler never armed)."""
    if _state is None:
        return []
    with _state.lock:
        return list(_state.cost.values())


def cost_entries_by_meta(**match):
    """Registered entries whose ``meta`` carries every given
    key=value, e.g. ``cost_entries_by_meta(dtype="int8")``."""
    return [e for e in cost_registry()
            if all((e.get("meta") or {}).get(k) == v
                   for k, v in match.items())]


def cost_report():
    """The cross-check view: every entry with an analytic estimate and
    an overall ``agree`` (True only when every comparable entry sits
    inside the ``cost_rtol`` band)."""
    entries = cost_registry()
    compared = [e for e in entries if e.get("analytic_flops")
                and e.get("flops")]
    return {
        "executables": entries,
        "compared": len(compared),
        "agree": all(e.get("agreement", False) for e in compared)
        if compared else None,
        "cost_rtol": float(_cfg.get("cost_rtol", 0.5)),
    }


# ---------------------------------------------------------------------------
# Pillar 2: the device-memory ledger
# ---------------------------------------------------------------------------

def ledger_swap(name, old_nbytes, new_nbytes):
    """``memory.Array`` hook: the Array ``name`` replaced a device
    tensor of ``old_nbytes`` with one of ``new_nbytes`` (either 0).
    Call sites guard with :func:`enabled`; this guards again."""
    if not enabled():
        return None
    p = _prof()
    p.ledger.swap(name, old_nbytes, new_nbytes)
    telemetry.gauge("profiler.ledger_bytes").set(p.ledger.live_bytes)
    telemetry.gauge("profiler.ledger_high_water_bytes").set(
        p.ledger.high_water_bytes)
    return True


def ledger_summary(top=16):
    """Ledger totals and per-name attribution (zeros when never armed)."""
    if _state is None:
        return DeviceLedger().summary(top)
    return _state.ledger.summary(top)


def epoch_check(epoch):
    """Epoch-boundary leak check (``Loader.run`` calls it when an epoch
    wraps): record the ledger's live bytes and flag a leak suspect
    after ``leak_epochs`` CONSECUTIVE epochs of growth totalling at
    least ``leak_min_bytes``.  Returns the suspect dict when one fired,
    else None."""
    if not enabled():
        return None
    p = _prof()
    with p.lock:
        p.epoch_bytes.append((int(epoch), p.ledger.live_bytes))
        window = int(_cfg.get("leak_epochs", 3))
        tail = p.epoch_bytes[-(window + 1):]
        if len(tail) < window + 1:
            return None
        deltas = [b - a for (_, a), (_, b) in zip(tail, tail[1:])]
        growth = tail[-1][1] - tail[0][1]
        if not (all(d > 0 for d in deltas)
                and growth >= int(_cfg.get("leak_min_bytes", 1 << 20))):
            return None
        p.leak_suspects += 1
    suspect = {"epoch": int(epoch), "grown_bytes": int(growth),
               "epochs": window, "live_bytes": tail[-1][1]}
    telemetry.counter("profiler.leak_suspects").inc()
    telemetry.record_event("profiler.leak_suspect", **suspect)
    logger.warning("device-memory leak suspect: ledger grew %d bytes "
                   "over %d consecutive epochs (live %d)",
                   growth, window, tail[-1][1])
    return suspect


def sample_device_memory():
    """The caching allocator's counters of each CUDA device
    (``torch.cuda.memory_stats``: ``bytes_in_use``, ``bytes_reserved``,
    ``peak_bytes_in_use``), gauged as
    ``profiler.device_bytes_in_use.device_<N>``; ``{"cpu": None}``
    without CUDA and None for a device CUDA has not initialized (the
    call never initializes it)."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = None
        if torch.cuda.is_initialized():
            st = torch.cuda.memory_stats(i)
            stats = {
                "bytes_in_use": int(st.get("allocated_bytes.all.current",
                                           0)),
                "bytes_reserved": int(st.get("reserved_bytes.all.current",
                                             0)),
                "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak",
                                                0)),
            }
            telemetry.gauge(telemetry.labeled(
                "profiler.device_bytes_in_use", device=i)).set(
                stats["bytes_in_use"])
        out[str(i)] = stats
    return out


# ---------------------------------------------------------------------------
# Pillar 3: the step-time breakdown
# ---------------------------------------------------------------------------

def _add_parts(parts, wall, steps=0, windows=0):
    p = _prof()
    with p.lock:
        for k, v in parts.items():
            if v:
                p.parts[k] += v
        p.wall += wall
        p.steps += steps
        p.windows += windows
    for k, v in parts.items():
        if v:
            telemetry.histogram("profiler.%s_seconds" % k).observe(v)


def _wait_for(tree):
    """Wait until the work behind the CUDA tensors of ``tree`` is done:
    one synchronize of each of their devices (nothing to wait on the
    CPU, whose ops return done)."""
    from torch.utils._pytree import tree_flatten
    devices = {leaf.device for leaf in tree_flatten(tree)[0]
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def note_data_wait(dt):
    """Loader hook: ``dt`` seconds were spent serving (selecting and
    filling) one minibatch.  Inside a window probe the wall time is
    the probe's; standalone (the unit graph, VALID fills) it advances
    the global wall too, so the parts always sum to wall."""
    if not enabled():
        return None
    p = _prof()
    with p.lock:
        p.parts["data_wait"] += dt
        if p.probes_active == 0:
            p.wall += dt
    telemetry.histogram("profiler.data_wait_seconds").observe(dt)
    return True


def note_gd_step(unit, t0):
    """Unit-graph hook (a GD unit's run): split its step into host
    dispatch (``t0`` to now) and device compute (a synchronize of the
    device of the unit's weights and bias, paid only while armed)."""
    if not enabled():
        return None
    t1 = time.perf_counter()
    dev = []
    for attr in ("weights", "bias"):
        arr = getattr(unit, attr, None)
        # the device side as it is, without a transfer ("dev"/"sync"
        # are memory.py's state constants; memory imports this module)
        if arr is not None and \
                getattr(arr, "_state", None) in ("dev", "sync"):
            d = getattr(arr, "_dev", None)
            if d is not None:
                dev.append(d)
    t2 = t1
    if dev:
        _wait_for(dev)
        t2 = time.perf_counter()
    _add_parts({"dispatch": t1 - t0, "device": t2 - t1},
               wall=t2 - t0, steps=1)
    return True


class _WindowProbe(object):
    """One training window's wall-time partition.  Lifecycle (driven
    by the fused trainer):

    ``probe = profiler.window_probe()`` (None when disabled) ->
    ``probe.collected()`` once the minibatch window is assembled ->
    ``probe.dispatched(tree)`` right after the dispatch returns (this
    waits for the tree's device: device time becomes explicit) ->
    ``probe.done(steps)`` after the host readback.

    Parts: ``data_wait`` (loader time inside the collection, reported
    by ``Loader.run`` itself), ``host_collect`` (collection minus
    loader), ``dispatch``, ``device``, ``readback``; their sum is the
    probe's wall time by construction.  The armed probe's wait drains
    the trainer's asynchronous window pipeline, so a breakdown taken
    while profiling is the synchronous schedule's."""

    __slots__ = ("t0", "t_collect", "t_dispatch", "t_device", "_wait0",
                 "_closed")

    def __init__(self):
        p = _prof()
        with p.lock:
            p.probes_active += 1
            self._wait0 = p.parts["data_wait"]
        self.t0 = time.perf_counter()
        self.t_collect = None
        self.t_dispatch = None
        self.t_device = None
        self._closed = False

    def collected(self):
        self.t_collect = time.perf_counter()

    def dispatched(self, tree):
        self.t_dispatch = time.perf_counter()
        _wait_for(tree)
        self.t_device = time.perf_counter()

    def done(self, steps=1):
        """Close the probe and accumulate its parts.  Idempotent: call
        sites close in a ``finally``, so a window that raises cannot
        leak ``probes_active``."""
        if self._closed:
            return None
        self._closed = True
        t1 = time.perf_counter()
        tc = self.t_collect if self.t_collect is not None else self.t0
        td = self.t_dispatch if self.t_dispatch is not None else tc
        tv = self.t_device if self.t_device is not None else td
        p = _prof()
        with p.lock:
            waited = max(0.0, p.parts["data_wait"] - self._wait0)
            p.probes_active = max(0, p.probes_active - 1)
        parts = {
            "data_wait": 0.0,  # accumulated by Loader.run already
            "host_collect": max(0.0, (tc - self.t0) - waited),
            "dispatch": td - tc,
            "device": tv - td,
            "readback": t1 - tv,
        }
        _add_parts(parts, wall=(t1 - self.t0), steps=steps, windows=1)
        return parts


def window_probe():
    """A new :class:`_WindowProbe`, or None when disabled."""
    if not enabled():
        return None
    return _WindowProbe()


def breakdown_summary():
    """The accumulated partition and the bound verdict.  Fractions are
    over total wall time; the verdict names the LARGEST consumer:
    ``input-bound`` (data wait), ``compute-bound`` (device), or
    ``host-bound`` (collect + dispatch + readback).  None when nothing
    was recorded."""
    if _state is None:
        return None
    p = _state
    with p.lock:
        parts = {k: p.parts.get(k, 0.0) for k in PARTS}
        wall, steps, windows = p.wall, p.steps, p.windows
    total = sum(parts.values())
    if total <= 0.0:
        return None
    data = parts["data_wait"]
    device = parts["device"]
    host = total - data - device
    if data >= device and data >= host:
        verdict = "input-bound"
    elif device >= host:
        verdict = "compute-bound"
    else:
        verdict = "host-bound"
    return {
        "parts_seconds": {k: round(v, 6) for k, v in parts.items()},
        "fractions": {"data_wait": round(data / total, 4),
                      "device": round(device / total, 4),
                      "host": round(host / total, 4)},
        "wall_seconds": round(wall, 6),
        "steps": steps,
        "windows": windows,
        "verdict": verdict,
    }


# ---------------------------------------------------------------------------
# The device trace (/debug/profile, the CLI, Workflow.run_profiled)
# ---------------------------------------------------------------------------

_capture_lock = locksmith.lock("profiler.capture")


class EmptyDeviceTrace(RuntimeError):
    """A capture on the card whose trace holds no device event: CUPTI
    traced nothing, not even the small op taken before the body."""


#: the device table of the last whole-run trace, carried by the report
_device_ops = None

#: the Chrome trace's device event categories
_DEVICE_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))


def categorize(name):
    """A device event's coarse category, after
    ``tools/profile_summary.py``'s (convolution, matmul, gather-scatter,
    reduce, copy-transpose, elementwise, other) for CUDA kernel names,
    plus ``pooling`` for the max-pooling kernels."""
    n = name.lower()
    if "pool" in n:
        return "pooling"
    if "conv" in n or "fprop" in n or "dgrad" in n or "wgrad" in n:
        return "convolution"
    if "gemm" in n or "matmul" in n or "dot" in n or "gemv" in n:
        return "matmul"
    if "gather" in n or "scatter" in n or "index" in n:
        return "gather-scatter"
    if "reduce" in n or "norm" in n or "argmax" in n or "softmax" in n:
        return "reduce"
    if "memcpy" in n or "memset" in n or "copy" in n or \
            "transpose" in n or "cat" in n:
        return "copy-transpose"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def device_table(trace_path, top=None):
    """Device time of a Chrome trace that ``torch.profiler`` wrote, by
    kernel name and by :func:`categorize`'s category: ``{"events",
    "total_ms", "by_name": [{"name", "category", "count", "ms"}, ...]
    (longest first), "by_category": {category: ms}}``."""
    with open(trace_path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    by_name = collections.defaultdict(lambda: [0, 0.0])
    n = 0
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in _DEVICE_CATS:
            continue
        row = by_name[ev.get("name", "?")]
        row[0] += 1
        row[1] += float(ev.get("dur", 0.0)) / 1e3
        n += 1
    rows = sorted(({"name": name, "category": categorize(name),
                    "count": c, "ms": round(ms, 6)}
                   for name, (c, ms) in by_name.items()),
                  key=lambda r: -r["ms"])
    by_cat = collections.defaultdict(float)
    for r in rows:
        by_cat[r["category"]] += r["ms"]
    return {"events": n,
            "total_ms": round(sum(r["ms"] for r in rows), 6),
            "by_name": rows if top is None else rows[:top],
            "by_category": {k: round(v, 6) for k, v in
                            sorted(by_cat.items(), key=lambda kv: -kv[1])}}


#: the launch log while :func:`launch_log` is armed, else None
_LAUNCH_LOG = None
#: the annotation prefix of a logged launch
LAUNCH_PREFIX = "znicz_launch:"


@contextlib.contextmanager
def launch_log():
    """Yield a list that records every kernel launch of the body: a
    dict of ``index`` (the launch order), ``kernel``, ``stream`` (the
    one the launch went to), ``current_stream`` (the calling thread's
    ``torch.cuda.current_stream()``) and ``thread``."""
    global _LAUNCH_LOG
    log = []
    _LAUNCH_LOG = log
    try:
        yield log
    finally:
        _LAUNCH_LOG = None


def launch_range(kernel, stream):
    """The context a kernel wrapper launches in: nothing unless the
    launch log is armed; then the launch is logged and annotated as
    ``znicz_launch:<kernel>:<index>`` for the trace."""
    log = _LAUNCH_LOG
    if log is None:
        return contextlib.nullcontext()
    index = len(log)
    log.append({"index": index, "kernel": kernel, "stream": int(stream),
                "current_stream": int(torch.cuda.current_stream()
                                      .cuda_stream),
                "thread": threading.current_thread().name})
    return torch.profiler.record_function(
        "%s%s:%d" % (LAUNCH_PREFIX, kernel, index))


#: the trace categories of a launch call on the host
_LAUNCH_API_CATS = frozenset(("cuda_runtime", "cuda_driver"))


def unmatched_launches(trace_path, log):
    """The entries of ``log`` (:func:`launch_log`'s) whose kernel record
    the Chrome trace at ``trace_path`` lacks, each with ``why``: the
    launch call inside its annotation has a correlation id no kernel
    event carries, or the trace holds no launch call inside it (then a
    kernel event carrying the annotation's ``External id`` still
    counts as its record)."""
    with open(trace_path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    spans, calls = {}, []
    kernel_corr, kernel_ext = set(), set()
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat"), str(ev.get("name", ""))
        args = ev.get("args") or {}
        if cat == "kernel":
            if args.get("correlation") is not None:
                kernel_corr.add(args["correlation"])
            if args.get("External id") is not None:
                kernel_ext.add(args["External id"])
        elif cat in _LAUNCH_API_CATS:
            calls.append(ev)
        elif name.startswith(LAUNCH_PREFIX) and cat != "gpu_user_annotation":
            try:
                index = int(name.rsplit(":", 1)[1])
            except ValueError:
                continue
            spans[index] = ev
    missing = []
    for entry in log:
        span = spans.get(entry["index"])
        if span is None:
            missing.append(dict(entry, why="no annotation in the trace"))
            continue
        t0 = float(span.get("ts", 0.0))
        t1 = t0 + float(span.get("dur", 0.0))
        corr = [c["args"]["correlation"] for c in calls
                if c.get("tid") == span.get("tid")
                and t0 <= float(c.get("ts", 0.0)) <= t1
                and (c.get("args") or {}).get("correlation") is not None]
        ext = (span.get("args") or {}).get("External id")
        if corr:
            if not any(c in kernel_corr for c in corr):
                missing.append(dict(entry, why="launch call correlation %s "
                                    "has no kernel event" % corr))
        elif ext is None or ext not in kernel_ext:
            missing.append(dict(entry, why="no launch call and no kernel "
                                "event linked to the annotation"))
    return missing


def kernel_events(table, name):
    """The device events of ``table`` (:func:`device_table`) whose
    kernel name contains ``name``: ``(count, ms)``."""
    rows = [r for r in table["by_name"] if name in r["name"]]
    return sum(r["count"] for r in rows), sum(r["ms"] for r in rows)


@contextlib.contextmanager
def traced(directory, cuda=None):
    """Run the ``with`` body under ``torch.profiler`` (the CPU, and the
    card unless ``cuda`` is False; by default where CUDA is available)
    and export ``<directory>/trace.json``.  Yields a dict that, once the
    body is done, holds ``trace_dir``, ``trace`` and ``device_ops``
    (:func:`device_table`).  On the card one small op runs before the
    body, and the card is synchronized before the trace closes.  One
    capture at a time: a second raises ``RuntimeError``
    (Kineto cannot nest two profilers); a capture on the card with no
    device event raises :class:`EmptyDeviceTrace`."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    if not _capture_lock.acquire(blocking=False):
        raise RuntimeError("a profiler capture is already running")
    result = {"trace_dir": directory}
    try:
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(directory, exist_ok=True)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            if cuda:
                # one small op on the card before the body: the trace's
                # first kernel is never one of the body's
                torch.ones(1, device="cuda").add_(1.0)
                torch.cuda.synchronize()
            yield result
            if cuda:
                torch.cuda.synchronize()   # drain before the trace closes
        path = os.path.join(directory, "trace.json")
        prof.export_chrome_trace(path)
    finally:
        _capture_lock.release()
    table = device_table(path)
    if cuda and not table["events"]:
        raise EmptyDeviceTrace(
            "the device trace %s holds no device event: CUPTI did not "
            "trace the card" % path)
    result.update(trace=path, device_ops=table)


def capture_trace(seconds=3.0, directory=None):
    """Capture a device trace for ``seconds`` and return ``{"trace_dir",
    "trace", "seconds", "files", "device_events"}``.  Works whether or
    not the profiler flag is armed (the request is the opt-in).  One
    small op on the device (and a synchronize) runs inside the window,
    so the trace holds at least one device event."""
    seconds = max(0.05, min(
        float(seconds), float(_cfg.get("capture_seconds_cap", 60.0))))
    base = (directory or _cfg.get("capture_dir", None)
            or os.path.join(root.common.dirs.cache, "profiles"))
    stamp = time.strftime("%Y%m%d_%H%M%S")
    path = os.path.join(base, "capture_%s_pid%d" % (stamp, os.getpid()))
    n = 0
    while os.path.exists(path):
        n += 1
        path = os.path.join(base, "capture_%s_pid%d_%d"
                            % (stamp, os.getpid(), n))
    cuda = torch.cuda.is_available()
    with traced(path, cuda=cuda) as result:
        deadline = time.perf_counter() + seconds
        while True:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            time.sleep(min(0.05, remaining))
        # the heartbeat: one op on the device the capture traces
        torch.ones(1, device="cuda" if cuda else "cpu").add_(1.0)
    files = sorted(os.path.relpath(os.path.join(d, f), path)
                   for d, _, fs in os.walk(path) for f in fs)
    telemetry.record_event("profiler.capture", trace_dir=path,
                           seconds=seconds, files=len(files))
    logger.info("profiler capture (%.2fs) -> %s (%d files)",
                seconds, path, len(files))
    return {"trace_dir": path, "trace": result["trace"],
            "seconds": seconds, "files": files,
            "device_events": result["device_ops"]["events"]}


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

def snapshot():
    """JSON-able view of all three pillars (what :func:`export_report`
    writes and ``GET /debug/profiler`` serves), with the last whole-run
    trace's device table as ``device_ops`` (None without one)."""
    return {
        "enabled": enabled(),
        "cost_registry": cost_registry(),
        "ledger": ledger_summary(),
        "breakdown": breakdown_summary(),
        "device_memory": sample_device_memory(),
        "leak_suspects": (_state.leak_suspects
                          if _state is not None else 0),
        "device_ops": _device_ops,
    }


def export_report(path):
    """Write :func:`snapshot` as JSON (the file
    ``tools/profile_summary.py --roofline / --ledger`` renders)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(snapshot(), f, indent=2, default=str)
    return path


# ---------------------------------------------------------------------------
# CLI: python -m znicz_tpu_torch profile
# ---------------------------------------------------------------------------

def _arg_value(argv, flag):
    """The value of ``flag VALUE`` or ``flag=VALUE`` in ``argv``."""
    for i, a in enumerate(argv):
        if a == flag and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith(flag + "="):
            return a.partition("=")[2]
    return None


def cli_main(argv=None):
    """``python -m znicz_tpu_torch profile TARGET [--out DIR]
    [--seconds N] [WORKFLOW ARGUMENTS]``.

    * TARGET is a URL (``http://host:port``): hit the running server's
      ``GET /debug/profile?seconds=N`` and print the reply.
    * TARGET is a workflow (sample name, dotted module, .py file): run
      it through the workflow CLI with telemetry and the profiler armed
      under one device trace (:func:`traced`), the other arguments
      (``--fused ...``, ``--config ...``, ``--device cpu``, ...) passed
      on; then write ``profiler_report.json`` beside ``trace.json`` in
      ``--out`` and print the summary.  Returns 0.
    """
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m znicz_tpu_torch profile",
        description="Capture a device trace from a running server (URL "
                    "target) or run a workflow under the profiler and "
                    "one device trace (workflow target; the workflow "
                    "CLI's arguments pass through).")
    parser.add_argument("target",
                        help="http://host:port of a running status or "
                             "serving server, or a workflow (sample "
                             "name, dotted module, .py file)")
    parser.add_argument("--seconds", type=float, default=3.0,
                        help="capture window of the URL mode (default 3)")
    parser.add_argument("--out", default=None,
                        help="output directory of the workflow mode "
                             "(default <cache>/profiles/cli_<stamp>)")
    args, rest = parser.parse_known_args(argv)

    if args.target.startswith(("http://", "https://")):
        import urllib.request
        url = (args.target.rstrip("/")
               + "/debug/profile?seconds=%g" % args.seconds)
        with urllib.request.urlopen(url,
                                    timeout=args.seconds + 60) as r:
            doc = json.loads(r.read())
        print(json.dumps(doc, indent=2))  # noqa: T201 - CLI output
        return 0

    global _device_ops
    from znicz_tpu_torch import __main__ as cli
    from znicz_tpu_torch.core.backends import default_device
    # the card unless --device says otherwise; without CUDA, raise now
    device = default_device(_arg_value(rest, "--device"))
    telemetry.enable()
    enable()
    out = args.out or os.path.join(
        root.common.dirs.cache, "profiles",
        "cli_%s" % time.strftime("%Y%m%d_%H%M%S"))
    with traced(out, cuda=device.type == "cuda") as result:
        cli.run_workflow_cli([args.target] + rest)
    _device_ops = result["device_ops"]
    report = export_report(os.path.join(out, "profiler_report.json"))
    print("device trace -> %s" % result["trace"])  # noqa: T201
    print("profiler report -> %s" % report)  # noqa: T201
    print("executables registered: %d"  # noqa: T201
          % len(cost_registry()))
    for e in cost_registry():
        print("  %-36s %10.4g GFLOP %10.4g MB  measured/analytic %s"  # noqa
              % (e["name"], (e["flops"] or 0) / 1e9,
                 (e["bytes_accessed"] or 0) / 1e6,
                 "%.3f" % e["flops_ratio_measured_vs_analytic"]
                 if "flops_ratio_measured_vs_analytic" in e else "-"))
    led = ledger_summary()
    print("ledger: live %d B, high water %d B, balanced=%s"  # noqa: T201
          % (led["live_bytes"], led["high_water_bytes"],
             led["balanced"]))
    bd = breakdown_summary()
    if bd:
        print("step breakdown: %s (data %.1f%% / device %.1f%% / "  # noqa
              "host %.1f%%)"
              % (bd["verdict"], 100 * bd["fractions"]["data_wait"],
                 100 * bd["fractions"]["device"],
                 100 * bd["fractions"]["host"]))
    ops = result["device_ops"]
    print("device time: %.3f ms in %d events"  # noqa: T201
          % (ops["total_ms"], ops["events"]))
    for row in ops["by_name"][:10]:
        print("  %10.3f ms %7d  %-14s %s"  # noqa: T201
              % (row["ms"], row["count"], row["category"],
                 row["name"][:80]))
    return 0
