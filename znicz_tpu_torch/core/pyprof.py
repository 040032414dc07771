"""Continuous statistical Python profiler — the process's CPU and GIL
ledger.

Counterpart of ``znicz_tpu/core/pyprof.py``.  A span says a reply
took 1.6 ms; the sampler says how much of it was JSON encoding holding
the GIL:

* a background sampler walks ``sys._current_frames()`` at an off-beat
  rate (``hz``, 97 by default, coprime with the other planes'
  cadences), folds each thread's stack into bounded collapsed
  flamegraph aggregates and attributes every sample to a component by
  the thread-name registry: every thread the port spawns is named
  ``znicz:<component>`` (:func:`thread_name`, :func:`name_current_thread`);
* each sample's leaf frame is classified into the fixed phases
  :data:`PHASES` (:func:`classify`);
* a calibrated scheduling-delay probe estimates GIL wait: a probe
  thread sleeps a short quantum and measures the overshoot; the first
  ``gil_calib_probes`` overshoots set the baseline (their median) and
  only the excess above it counts (``pyprof.gil_wait_ms``);
* ``GET /debug/pyprof?seconds=N[&format=collapsed|speedscope]`` on
  every :class:`~znicz_tpu_torch.core.status_server.HandlerBase` server
  (:func:`capture`), :func:`diff_snapshots`, :func:`merge_profiles`
  and the renderers :func:`collapsed` and :func:`speedscope`.

:func:`classify` answers ``device_dispatch`` for the port's own
dispatch frames where the JAX package recognises ``jax`` / ``jaxlib``
ones: frames under ``torch/`` and the ctypes launches of the
hand-written kernels (``ops/cuda_pooling.py``,
``ops/cuda_pooling_backward.py``).  Its lock is a ``locksmith`` lock.

Everything gates on ``root.common.profiler.pyprof.enabled``: off,
:func:`maybe_start` returns without touching anything, no thread
exists, no state is allocated and every hook is one config read.
Tests drive :func:`sample_once` with injected frames, thread names
and clock, and :func:`gil_probe_once` with injected delays.
"""

import os
import sys
import threading
import time

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core import telemetry

#: the config node (stable object identity — config.py declares it)
_cfg = root.common.profiler.pyprof

telemetry.register_help(
    "pyprof", "continuous Python sampling profiler (core/pyprof.py): "
              "stack samples folded and GIL-wait milliseconds")

_lock = locksmith.lock("pyprof.state")

#: the thread-name convention every spawn site uses
THREAD_PREFIX = "znicz:"

#: the data-plane phase vocabulary — the axes of the Python-tax
#: ledger.  FIXED by design: the classifier may only ever answer one
#: of these (unknowns are a loud ValueError, never a silent new
#: bucket), so a report can enumerate them.
PHASES = ("json_decode", "npy_decode", "serialize", "socket_io",
          "device_dispatch", "lock_wait", "other")

#: phases counted as the Python data-plane tax (codec + relay work a
#: zero-copy rewrite could remove) in dataplane_python_pct
DATAPLANE_PHASES = ("json_decode", "npy_decode", "serialize",
                    "socket_io")

_thread = None
_gil_thread = None
_stop = threading.Event()

#: lazily created on the first ARMED use — the disabled path never
#: allocates (zero-overhead-off contract)
_state = None


def enabled():
    """The one gate — a live read of
    ``root.common.profiler.pyprof.enabled``."""
    return bool(_cfg.get("enabled", False))


def enable(**overrides):
    for k, v in overrides.items():
        setattr(root.common.profiler.pyprof, k, v)
    root.common.profiler.pyprof.enabled = True
    return True


def disable():
    root.common.profiler.pyprof.enabled = False
    return False


# ---------------------------------------------------------------------------
# Thread-name registry
# ---------------------------------------------------------------------------

def thread_name(component):
    """The ``znicz:<component>`` name a spawn site passes to
    ``threading.Thread(name=...)``."""
    return THREAD_PREFIX + str(component)


def name_current_thread(component):
    """Adopt the convention for a thread the port did not spawn (the
    serve CLI's main thread)."""
    threading.current_thread().name = thread_name(component)


def component_of(name):
    """Thread name -> component: ``znicz:continuous-3`` ->
    ``continuous`` (one trailing ``-<index>`` pool suffix stripped so
    a pool folds into ONE component), anything off-convention ->
    ``unnamed``."""
    name = str(name or "")
    if not name.startswith(THREAD_PREFIX):
        return "unnamed"
    comp = name[len(THREAD_PREFIX):] or "unnamed"
    head, _, tail = comp.rpartition("-")
    if head and tail.isdigit():
        comp = head
    return comp


# ---------------------------------------------------------------------------
# Phase classification
# ---------------------------------------------------------------------------

_LOCK_FUNCS = frozenset(("wait", "acquire", "join",
                         "_wait_for_tstate_lock", "wait_for"))
_SOCKET_FILES = frozenset(("socket.py", "ssl.py", "selectors.py",
                           "socketserver.py", "client.py",
                           "server.py"))
_SOCKET_DIRS = ("/http/", "/urllib/", "/email/")
_JSON_DECODE_FUNCS = frozenset(("loads", "load", "decode",
                                "raw_decode", "scan_once",
                                "parse_object", "parse_array",
                                "parse_string", "JSONObject",
                                "JSONArray", "py_scanstring"))
_SERIALIZE_FUNCS = frozenset(("dumps", "dump", "encode", "iterencode",
                              "default", "floatstr",
                              "_iterencode", "_iterencode_dict",
                              "_iterencode_list", "tolist"))
_NPY_FUNCS = frozenset(("frombuffer", "read_array", "_read_bytes",
                        "read_magic", "read_array_header_1_0",
                        "write_array", "tobytes", "save"))


#: the wrappers that launch the hand-written kernels through ctypes
_KERNEL_WRAPPERS = frozenset(("cuda_pooling.py",
                              "cuda_pooling_backward.py"))


def classify(filename, funcname):
    """LEAF frame -> phase.  Total: always answers a member of
    :data:`PHASES` (the fold asserts it — a classifier change that
    invents a phase outside the vocabulary fails loudly rather than
    silently skewing the stamped ledger).  Precedence mirrors what a
    blocked thread actually shows: a thread parked in
    ``threading.wait`` is lock_wait even though threading.py is
    stdlib 'other' territory otherwise."""
    f = str(filename or "").replace("\\", "/")
    base = f.rsplit("/", 1)[-1]
    fn = str(funcname or "")
    if base in ("threading.py", "queue.py") or fn in _LOCK_FUNCS:
        return "lock_wait"
    if "/json/" in f or base in ("decoder.py", "encoder.py",
                                 "scanner.py"):
        if base == "encoder.py" or fn in _SERIALIZE_FUNCS:
            return "serialize"
        return "json_decode"
    if fn in _JSON_DECODE_FUNCS:
        return "json_decode"
    if "/numpy/lib/format" in f or ("/numpy/" in f and fn in
                                    _NPY_FUNCS):
        return "npy_decode"
    if fn in _SERIALIZE_FUNCS:
        return "serialize"
    if base in _SOCKET_FILES or any(d in f for d in _SOCKET_DIRS) \
            or fn in ("sendall", "recv", "recv_into", "readinto",
                      "accept", "makefile", "flush", "urlopen"):
        return "socket_io"
    if "/torch/" in f or base in _KERNEL_WRAPPERS \
            or fn in ("synchronize", "block_until_ready"):
        return "device_dispatch"
    if fn in _NPY_FUNCS:
        return "npy_decode"
    return "other"


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

class _State(object):
    """Cumulative aggregates since arm/reset (all mutation under
    ``_lock``)."""

    __slots__ = ("samples", "sweeps", "truncated", "components",
                 "phases", "stacks", "busy_s", "started",
                 "gil_probes", "gil_calib", "gil_baseline_s",
                 "gil_wait_s")

    def __init__(self, now):
        self.samples = 0
        self.sweeps = 0
        self.truncated = 0
        self.components = {}
        self.phases = dict.fromkeys(PHASES, 0)
        self.stacks = {}       # "comp;frame;...;leaf" -> count
        self.busy_s = 0.0      # time spent INSIDE sample sweeps
        self.started = now     # perf_counter at first armed use
        self.gil_probes = 0
        self.gil_calib = []    # overshoots until calibrated
        self.gil_baseline_s = None
        self.gil_wait_s = 0.0


def _ensure_state(now):
    global _state
    if _state is None:
        _state = _State(now)
    return _state


def _modname(path):
    base = str(path or "?").replace("\\", "/").rsplit("/", 1)[-1]
    return base[:-3] if base.endswith(".py") else base


#: code object -> (folded "module:func" label, leaf phase) memo.  The
#: sweep's hot cost is path parsing + label formatting, and blocked
#: threads re-present IDENTICAL frames every sweep — memoizing per
#: code object cuts the per-sweep cost to dict lookups, which keeps the
#: 97 Hz default cheap.
#: Bounded: cleared wholesale past a cap no real program reaches.
_code_memo = {}


def _frame_info(code):
    info = _code_memo.get(code)
    if info is None:
        if len(_code_memo) > 8192:
            _code_memo.clear()
        info = ("%s:%s" % (_modname(code.co_filename), code.co_name),
                classify(code.co_filename, code.co_name))
        _code_memo[code] = info
    return info


def _fold(frame, max_depth):
    """Frame chain -> (collapsed root-first frame list, leaf phase) —
    the flamegraph fold."""
    out = []
    phase = None
    f = frame
    while f is not None and len(out) < max_depth:
        label, leaf_phase = _frame_info(f.f_code)
        if not out:
            phase = leaf_phase
        out.append(label)
        f = f.f_back
    out.reverse()
    return out, phase


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def sample_once(frames=None, names=None, clock=None):
    """One sampler sweep: fold every live thread's stack into the
    aggregates.  Returns the number of samples recorded (0 when the
    gate is off — the disabled path reads ONE predicate and nothing
    else).  ``frames`` (ident -> frame), ``names`` (ident -> thread
    name) and ``clock`` are injectable so tests drive the fold math
    with synthetic stacks and zero real threads."""
    if not enabled():
        return 0
    clock = clock or time.perf_counter
    t0 = clock()
    if frames is None:
        frames = sys._current_frames()
    if names is None:
        names = {t.ident: t.name for t in threading.enumerate()}
    max_depth = int(_cfg.get("max_depth", 24))
    cap = int(_cfg.get("capacity", 512))
    recorded = 0
    with _lock:
        st = _ensure_state(t0)
        for ident, frame in frames.items():
            name = names.get(ident, "")
            if name.startswith(THREAD_PREFIX + "pyprof"):
                continue   # never profile the profiler's own threads
            comp = component_of(name)
            stack, phase = _fold(frame, max_depth)
            if not stack:
                continue
            if phase not in PHASES:
                raise ValueError(
                    "classify() answered %r — outside the fixed "
                    "phase vocabulary %s" % (phase, list(PHASES)))
            st.samples += 1
            st.components[comp] = st.components.get(comp, 0) + 1
            st.phases[phase] += 1
            key = comp + ";" + ";".join(stack)
            if key in st.stacks:
                st.stacks[key] += 1
            elif len(st.stacks) < cap:
                st.stacks[key] = 1
            else:
                st.truncated += 1
            recorded += 1
        st.sweeps += 1
        st.busy_s += max(0.0, clock() - t0)
    if telemetry.enabled() and recorded:
        telemetry.counter("pyprof.samples").inc(recorded)
    return recorded


def gil_probe_once(delay_s):
    """Feed one measured scheduling overshoot (actual sleep minus
    requested quantum).  The first ``gil_calib_probes`` overshoots
    calibrate the host's baseline scheduler latency (median); after
    that only the EXCESS above baseline counts as GIL/scheduler wait.
    Returns the excess seconds attributed (None when the gate is off,
    0.0 while calibrating)."""
    if not enabled():
        return None
    excess = 0.0
    with _lock:
        st = _ensure_state(time.perf_counter())
        st.gil_probes += 1
        if st.gil_baseline_s is None:
            st.gil_calib.append(max(0.0, float(delay_s)))
            if len(st.gil_calib) >= int(_cfg.get("gil_calib_probes",
                                                 20)):
                ordered = sorted(st.gil_calib)
                st.gil_baseline_s = ordered[len(ordered) // 2]
            return 0.0
        excess = max(0.0, float(delay_s) - st.gil_baseline_s)
        st.gil_wait_s += excess
    if telemetry.enabled() and excess > 0:
        telemetry.counter("pyprof.gil_wait_ms").inc(excess * 1e3)
    return excess


def _run():
    while not _stop.is_set():
        if not enabled():
            return  # gate flipped off: the thread retires itself
        t0 = time.perf_counter()
        try:
            sample_once()
        except Exception:  # noqa: BLE001 - a sampler must never die
            pass
        period = 1.0 / max(1.0, float(_cfg.get("hz", 97.0)))
        _stop.wait(max(0.001, period - (time.perf_counter() - t0)))


def _gil_run():
    while not _stop.is_set():
        if not enabled():
            return
        quantum = float(_cfg.get("gil_interval_ms", 5.0)) / 1e3
        t0 = time.perf_counter()
        if _stop.wait(quantum):
            return
        try:
            gil_probe_once(time.perf_counter() - t0 - quantum)
        except Exception:  # noqa: BLE001 - the probe must never die
            pass


def maybe_start():
    """Start the sampler (and, unless ``gil_probe`` is off, the
    scheduling-delay probe) iff the gate is on and no thread runs —
    idempotent; called by ``HttpServerBase.start`` so arming the knob
    before a server starts is all an operator does.  Returns True when
    a sampler is running after the call."""
    if not enabled():
        return False
    global _thread, _gil_thread
    with _lock:
        if _thread is not None and _thread.is_alive():
            return True
        _stop.clear()
        _ensure_state(time.perf_counter())
        _thread = threading.Thread(
            target=_run, name=thread_name("pyprof-sampler"),
            daemon=True)
        _thread.start()
        if bool(_cfg.get("gil_probe", True)):
            _gil_thread = threading.Thread(
                target=_gil_run, name=thread_name("pyprof-gil"),
                daemon=True)
            _gil_thread.start()
    return True


def stop():
    """Stop the sampler/probe threads (keeps the aggregates)."""
    global _thread, _gil_thread
    with _lock:
        threads = [t for t in (_thread, _gil_thread) if t is not None]
        _thread = _gil_thread = None
    _stop.set()
    for t in threads:
        t.join(timeout=5)
    _stop.clear()


def reset():
    """Drop every aggregate (tests)."""
    global _state
    stop()
    with _lock:
        _state = None
        _code_memo.clear()


def running():
    """True while a sampler thread is alive (tests + /statusz)."""
    with _lock:
        return _thread is not None and _thread.is_alive()


# ---------------------------------------------------------------------------
# Snapshots, captures and the fleet merge
# ---------------------------------------------------------------------------

def _attributed_pct(samples, components):
    if not samples:
        return 0.0
    unnamed = int(components.get("unnamed", 0))
    return round(100.0 * (samples - unnamed) / samples, 2)


def snapshot():
    """Cumulative JSON-able aggregates since arm/reset — what
    ``GET /debug/pyprof`` diffs over its window and the timeseries
    plane samples."""
    with _lock:
        st = _state
        if st is None:
            return {"enabled": enabled(), "samples": 0, "sweeps": 0,
                    "truncated": 0, "components": {}, "phases": {},
                    "stacks": {},
                    "gil": {"probes": 0, "baseline_ms": None,
                            "wait_ms": 0.0},
                    "overhead": {"busy_ms": 0.0, "uptime_ms": 0.0,
                                 "pct": 0.0},
                    "attributed_pct": 0.0}
        uptime = max(0.0, time.perf_counter() - st.started)
        out = {
            "enabled": enabled(),
            "samples": st.samples,
            "sweeps": st.sweeps,
            "truncated": st.truncated,
            "components": dict(st.components),
            "phases": dict(st.phases),
            "stacks": dict(st.stacks),
            "gil": {
                "probes": st.gil_probes,
                "baseline_ms": (None if st.gil_baseline_s is None
                                else round(st.gil_baseline_s * 1e3,
                                           4)),
                "wait_ms": round(st.gil_wait_s * 1e3, 3),
            },
            "overhead": {
                "busy_ms": round(st.busy_s * 1e3, 3),
                "uptime_ms": round(uptime * 1e3, 3),
                "pct": round(100.0 * st.busy_s / uptime, 3)
                if uptime > 0 else 0.0,
            },
        }
    out["attributed_pct"] = _attributed_pct(out["samples"],
                                            out["components"])
    return out


def _diff_counts(after, before):
    out = {}
    for k, v in (after or {}).items():
        d = int(v) - int((before or {}).get(k, 0))
        if d > 0:
            out[k] = d
    return out


def diff_snapshots(before, after):
    """``after - before`` over two :func:`snapshot` payloads: the
    profile of exactly the window between them (the /debug/pyprof
    capture semantics — cumulative aggregates never reset under a
    reader)."""
    samples = int(after.get("samples", 0)) - int(
        before.get("samples", 0))
    components = _diff_counts(after.get("components"),
                              before.get("components"))
    gil_a, gil_b = after.get("gil") or {}, before.get("gil") or {}
    ovh_a, ovh_b = (after.get("overhead") or {},
                    before.get("overhead") or {})
    busy = max(0.0, float(ovh_a.get("busy_ms", 0.0))
               - float(ovh_b.get("busy_ms", 0.0)))
    wall = max(0.0, float(ovh_a.get("uptime_ms", 0.0))
               - float(ovh_b.get("uptime_ms", 0.0)))
    return {
        "enabled": after.get("enabled", False),
        "samples": max(0, samples),
        "sweeps": int(after.get("sweeps", 0)) - int(
            before.get("sweeps", 0)),
        "truncated": max(0, int(after.get("truncated", 0))
                         - int(before.get("truncated", 0))),
        "components": components,
        "phases": _diff_counts(after.get("phases"),
                               before.get("phases")),
        "stacks": _diff_counts(after.get("stacks"),
                               before.get("stacks")),
        "gil": {
            "probes": int(gil_a.get("probes", 0)) - int(
                gil_b.get("probes", 0)),
            "baseline_ms": gil_a.get("baseline_ms"),
            "wait_ms": round(max(0.0, float(gil_a.get("wait_ms", 0.0))
                                 - float(gil_b.get("wait_ms", 0.0))),
                             3),
        },
        "overhead": {
            "busy_ms": round(busy, 3),
            "uptime_ms": round(wall, 3),
            "pct": round(100.0 * busy / wall, 3) if wall > 0 else 0.0,
        },
        "attributed_pct": _attributed_pct(max(0, samples),
                                          components),
    }


def capture(seconds=2.0, sleep=None):
    """Profile exactly the next ``seconds`` (clamped by
    ``capture_seconds_cap``): snapshot, wait, snapshot, diff — what
    ``GET /debug/pyprof?seconds=N`` serves.  ``{"enabled": False}``
    when the gate is off (the endpoint's honest answer); ``sleep`` is
    injectable for tests."""
    if not enabled():
        return {"enabled": False}
    seconds = max(0.05, min(
        float(seconds), float(_cfg.get("capture_seconds_cap", 30.0))))
    before = snapshot()
    (sleep or time.sleep)(seconds)
    out = diff_snapshots(before, snapshot())
    out["seconds"] = seconds
    out["pid"] = os.getpid()
    return out


def merge_profiles(payloads):
    """Merge per-process profiles into ONE stitched flamegraph (the JAX
    fleet router's ``GET /debug/pyprof`` fan-out).  ``payloads`` maps a
    source label to its capture/snapshot payload.  Counts SUM
    (components, phases, collapsed stacks, GIL wait); ``sources``
    carries each process's sample count for attribution;
    ``overhead.pct`` merges as the MAX (the conservative "worst
    replica" tax view)."""
    out = {"enabled": False, "merged": True, "sources": {},
           "samples": 0, "truncated": 0, "components": {},
           "phases": {}, "stacks": {},
           "gil": {"probes": 0, "wait_ms": 0.0},
           "overhead": {"pct": 0.0}}
    for label in sorted(payloads):
        prof = payloads[label] or {}
        out["enabled"] = out["enabled"] or bool(prof.get("enabled"))
        out["sources"][label] = int(prof.get("samples", 0))
        out["samples"] += int(prof.get("samples", 0))
        out["truncated"] += int(prof.get("truncated", 0))
        for field in ("components", "phases", "stacks"):
            dst = out[field]
            for k, v in (prof.get(field) or {}).items():
                dst[k] = dst.get(k, 0) + int(v)
        gil = prof.get("gil") or {}
        out["gil"]["probes"] += int(gil.get("probes", 0))
        out["gil"]["wait_ms"] = round(
            out["gil"]["wait_ms"] + float(gil.get("wait_ms", 0.0)), 3)
        pct = float((prof.get("overhead") or {}).get("pct", 0.0))
        out["overhead"]["pct"] = max(out["overhead"]["pct"], pct)
    out["attributed_pct"] = _attributed_pct(out["samples"],
                                            out["components"])
    return out


# ---------------------------------------------------------------------------
# Renderers
# ---------------------------------------------------------------------------

def collapsed(profile):
    """The Brendan-Gregg collapsed-stack text of a profile payload:
    one ``component;frame;...;leaf count`` line per aggregate —
    flamegraph.pl / speedscope both import it."""
    stacks = profile.get("stacks") or {}
    return "\n".join("%s %d" % (key, stacks[key])
                     for key in sorted(stacks))


def speedscope(profile, name="pyprof"):
    """A speedscope-importable ``sampled`` profile document built from
    the collapsed aggregates (weights = sample counts)."""
    stacks = profile.get("stacks") or {}
    frames = []
    index = {}
    samples = []
    weights = []
    total = 0
    for key in sorted(stacks):
        chain = key.split(";")
        sample = []
        for fr in chain:
            if fr not in index:
                index[fr] = len(frames)
                frames.append({"name": fr})
            sample.append(index[fr])
        samples.append(sample)
        weights.append(int(stacks[key]))
        total += int(stacks[key])
    return {
        "$schema": "https://www.speedscope.app/file-format-schema"
                   ".json",
        "name": name,
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled",
            "name": name,
            "unit": "none",
            "startValue": 0,
            "endValue": total,
            "samples": samples,
            "weights": weights,
        }],
    }
