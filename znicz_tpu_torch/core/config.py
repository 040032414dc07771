"""A small attribute-dict configuration tree.

Counterpart of ``znicz_tpu/core/config.py``, cut to what the port
reads: the ``root.common.serving`` knobs of the serving slice (with
the fleet's autoscaler and the ``release`` block, :375-519), the
``root.common.telemetry`` gate and journal size,
``root.common.engine.precision_dtype`` (also read by :func:`dtype_map`)
and ``deterministic``, ``root.common.disable.plotting`` (on, JAX
:221: the plotters record their data and render nothing) and
``root.common.interactive`` (the shell unit's gate),
``root.common.analysis.lock_sanitizer`` (the lock-order sanitizer's
gate, JAX :226-231),
``root.common.dirs.snapshots`` / ``datasets`` / ``cache`` of the
training workflows, the ``root.common.faults`` / ``retry`` / ``health``
knobs of the fault-injection registry, the transient retry and the
health monitor (:284-296, :329-348), the ``root.common.profiler``
block with its ``pyprof`` child and the ``root.common.telemetry``
``timeseries`` and ``blackbox`` blocks of the observability plane
(:239-330; the time-series ``prefixes`` name the port's counter
families, where the JAX package names a ``jax`` one), and the CLI's
``--config`` parser :func:`apply_override` (:535).  Namespaces
auto-vivify on attribute access; assigning a dict merges it into the
node.

The knob registry (JAX :124-200): :func:`declare` installs a default
(a scalar knob, or a whole namespace from a dict) and registers its
path; :func:`declared_knobs` / :func:`declared_nodes` /
:func:`knob_declared` read the vocabulary.  Every default below is
declared.  ``common.faults.rules`` is, as in the JAX package, an
open dict whose keys are injection sites and whose values are rule
dicts: payload, not knobs.
"""

import ast
import json
import os


class Config(object):
    """One node of the config tree."""

    def __init__(self, path="root"):
        object.__setattr__(self, "_path_", path)

    def __getattr__(self, name):
        if name.startswith("_") and name.endswith("_"):
            raise AttributeError(name)
        child = Config("%s.%s" % (self._path_, name))
        object.__setattr__(self, name, child)
        return child

    def __setattr__(self, name, value):
        if isinstance(value, dict):
            getattr(self, name).update(value)
            return
        object.__setattr__(self, name, value)

    def update(self, value):
        """Recursively merge a dict into this node."""
        for k, v in value.items():
            setattr(self, k, v)
        return self

    def get(self, name, default=None):
        return self.__dict__.get(name, default)

    def __contains__(self, name):
        return name in self.__dict__

    def items(self):
        """The node's ``(key, value)`` pairs in the order they were set."""
        return ((k, v) for k, v in self.__dict__.items()
                if not (k.startswith("_") and k.endswith("_")))

    def keys(self):
        return (k for k, _ in self.items())

    def as_dict(self):
        return {k: (v.as_dict() if isinstance(v, Config) else v)
                for k, v in self.items()}

    def to_json(self):
        """The tree as JSON text; values JSON cannot hold as their repr."""
        return json.dumps(self.as_dict(), default=repr, sort_keys=True)

    def __repr__(self):
        return "<Config %s: %s>" % (self._path_, sorted(self.as_dict()))


#: The global configuration root.
root = Config("root")
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: declared leaf knobs and namespace nodes, dotted paths under ``root``
_KNOBS = set()
_NODES = set()


def declare(path, value):
    """Declare a knob (a scalar ``value``) or a whole namespace (a dict
    ``value``) under ``root.<path>``: install its default and register
    its path.  A scalar set before its declaration (an operator's
    override) wins; an empty dict declares an open dict-valued knob."""
    parts = path.split(".")
    if not parts or not all(parts):
        raise ValueError("bad knob path %r" % path)
    node = root
    for part in parts[:-1]:
        node = getattr(node, part)
        if not isinstance(node, Config):
            raise ValueError("cannot declare %r: %s is a leaf knob, not a "
                             "namespace" % (path, node))
    if isinstance(value, (dict, Config)):
        as_dict = value if isinstance(value, dict) else value.as_dict()
        setattr(node, parts[-1], as_dict)
        if as_dict:
            _register(path, as_dict)
        else:
            _KNOBS.add(path)
    else:
        if parts[-1] not in node.__dict__:
            setattr(node, parts[-1], value)
        _KNOBS.add(path)
    for i in range(1, len(parts)):
        _NODES.add(".".join(parts[:i]))
    return path


def _register(prefix, tree):
    _NODES.add(prefix)
    for k, v in tree.items():
        sub = "%s.%s" % (prefix, k)
        if isinstance(v, dict) and v:
            _register(sub, v)
        else:
            _KNOBS.add(sub)


def declared_knobs():
    """The declared leaf knob paths."""
    return frozenset(_KNOBS)


def declared_nodes():
    """The declared namespace paths."""
    return frozenset(_NODES)


def knob_declared(path):
    """Whether ``path`` is a declared knob or namespace, or lies under a
    declared (dict-valued) knob."""
    if path in _KNOBS or path in _NODES:
        return True
    parts = path.split(".")
    return any(".".join(parts[:i]) in _KNOBS for i in range(1, len(parts)))


def dtype_map():
    """The numpy dtype the engine computes in:
    ``root.common.engine.precision_dtype``, float32 while it is unset.
    JAX :568 maps a second knob's spellings (``precision_type``); the
    port has the one knob, which its loaders and trainers read."""
    import numpy
    dtype = root.common.engine.get("precision_dtype")
    return numpy.dtype(numpy.float32 if dtype is None else dtype).type


declare("common", {
    "serving": {
        "host": "127.0.0.1",
        "port": 8899,
        "max_batch": 64,          # micro-batch ceiling = largest bucket
        "max_delay_ms": 5.0,      # batching window after first request
        "queue_limit": 256,       # queued ROWS before 429 backpressure
        "timeout_ms": 1000.0,     # per-request deadline in the queue
        "warmup": True,           # run every bucket once before ready
        "max_body_bytes": 16 << 20,  # larger request bodies get 413
        # a request slower than this (admission to reply) is logged and
        # journaled as serving.slow_request (0: never)
        "slow_request_ms": 1000.0,
        # f32-fast: buckets up to this size run the fast FC layer,
        # larger ones the strict f32 layer (read at load, in the
        # compile key)
        "latency_bucket_max": 8,
        # the serving dtype an export or a snapshot records ("f32",
        # "f32-fast", "bf16" or "int8"); an engine without dtype=
        # adopts its source's
        "dtype": "f32",
        # per-bucket circuit breakers: consecutive dispatch failures
        # that open one (0: no breakers), the open -> half-open delay
        # and the concurrent half-open probes
        "breaker_threshold": 5,
        "breaker_cooldown_ms": 1000.0,
        "breaker_half_open_max": 1,
        # the continuous batcher's dispatch slots (registry mode)
        "max_inflight": 2,
        # the registry's LRU device-memory budget (0: never evict)
        "registry_memory_budget_bytes": 0,
        # the share of queue_limit each priority admits under
        "priority_queue_pct": {"low": 50.0, "normal": 100.0,
                               "high": 100.0},
        # the server-side SLO plane (serving/slo.py): good/total from
        # request admission against slo_ms, the two burn windows, the
        # budget's target and the slo.burn threshold; off, the front
        # end pays one predicate
        "slo_ms": 100.0,
        "slo_enabled": False,
        "slo_target_pct": 99.0,
        "slo_fast_window_s": 60.0,
        "slo_slow_window_s": 600.0,
        "slo_burn_threshold": 2.0,
        # per-request trace trees (serving/reqtrace.py): every Nth
        # admitted request gets a span tree (0: off), the newest
        # trace_capacity trees are kept
        "trace_sample_n": 0,
        "trace_capacity": 256,
        # the continuous batcher's admitted-request-id ring, the fleet
        # router's retry-safety oracle (GET /admitted/<rid>)
        "admitted_rid_capacity": 4096,
        # the binary framed relay between the router and its replicas
        # (serving/wire.py)
        "wire": {
            "enabled": True,
            "conns_per_replica": 2,
            "max_frame_mb": 32.0,     # frame-body ceiling (oversize)
            "read_timeout_ms": 10000.0,  # half-frame sweep deadline
            "workers": 128,           # listener dispatch threads
        },
        # the replica fleet behind the router (serving/router.py)
        "fleet": {
            "replicas": 2,
            "spawn_timeout_s": 180.0,
            "probe_interval_s": 1.0,
            "probe_failures": 3,
            "route_retries": 2,
            "overhead_window": 512,
            # the autoscaler (serving/autoscaler.py): the fleet's size
            # bounds, its decision cadence, the scale-up signals (both
            # burn windows over the threshold, or queued rows a replica
            # over the ceiling), the scale-down hysteresis (a budget
            # this green for this many decisions) and the seconds
            # between two actions
            "min_replicas": 1,
            "max_replicas": 4,
            "autoscale_interval_s": 5.0,
            "scale_up_burn_threshold": 2.0,
            "scale_up_queue_rows": 256.0,
            "scale_down_budget_min": 0.97,
            "scale_down_evals": 3,
            "cooldown_s": 30.0,
        },
        # progressive delivery (serving/release.py): the share of live
        # traffic mirrored in shadow, the compares shadow needs before
        # it is green, the mismatches and candidate errors it tolerates,
        # the canary ladder (% of traffic), the seconds each step stays
        # green, the candidate requests a step needs, and the judge's
        # cadence; a POST /release body's "policy" overrides any of them
        # for that release
        "release": {
            "shadow_sample_pct": 100.0,
            "shadow_min_compares": 8,
            "shadow_mismatch_max": 0,
            "shadow_error_max": 3,
            "canary_steps": [5.0, 25.0, 50.0],
            "green_window_s": 5.0,
            "min_requests": 12,
            "tick_interval_s": 0.25,
        },
    },
    "telemetry": {
        "enabled": False,
        # the flight-recorder journal's ring (events kept)
        "journal_capacity": 4096,
        # the metric time-series (core/timeseries.py): a sampler thread
        # snapshotting the counters and gauges of the listed families
        # (and the p50 / p99 of their histograms) into bounded rings,
        # served at GET /debug/timeseries; off, the thread never starts
        "timeseries": {
            "enabled": False,
            "interval_ms": 1000.0,  # sampling period
            "capacity": 512,        # points kept a series
            # the port's counter families: the JAX package's "jax"
            # family (its compile counters) has no counterpart here, and
            # the profiler's, the fault registry's, the health monitor's
            # and the launcher's families are the port's additions
            "prefixes": "serving,slo,trainer,transfer,loader,pyprof,"
                        "profiler,faults,health,launcher",
        },
        # the durable blackbox (core/blackbox.py): the journal and the
        # time-series frontier written through to length-delimited
        # JSONL segments <role>.<pid>.<boot>.<nnn> under one directory,
        # read back by `python -m znicz_tpu_torch obs`; off, nothing
        # touches the filesystem
        "blackbox": {
            "enabled": False,
            "dir": None,              # None: <dirs.cache>/blackbox
            "role": None,             # the segment names' role
            "segment_bytes": 1 << 20,  # rotate (fsync file, then dir)
            "retention_bytes": 64 << 20,  # oldest segments deleted
                                          # past this total (0: never)
            "checkpoint_every_sweeps": 5,  # the time-series frontier
                                           # every Nth sampler sweep
        },
    },
    # performance introspection (core/profiler.py): the cost registry,
    # the device-memory ledger and the step-time breakdown; off, every
    # hook site is one config read, with no device sync
    "profiler": {
        "enabled": False,
        "cost_rtol": 0.5,         # measured/analytic FLOPs agreement
                                  # band: [1 - rtol, 1 + rtol]
        "leak_epochs": 3,         # consecutive growing epochs before
                                  # the ledger flags a leak suspect
        "leak_min_bytes": 1 << 20,  # smaller growth is not a leak
        "capture_seconds_cap": 60.0,  # /debug/profile?seconds= ceiling
        "capture_dir": None,      # None: <dirs.cache>/profiles
        # the Python sampling profiler (core/pyprof.py); off, no
        # sampler thread exists
        "pyprof": {
            "enabled": False,
            "hz": 97.0,             # sample rate, off-beat on purpose
            "capacity": 512,        # distinct collapsed stacks kept
            "max_depth": 24,        # frames folded a stack
            "gil_probe": True,      # the scheduling-delay probe thread
            "gil_interval_ms": 5.0,  # the probe's sleep quantum
            "gil_calib_probes": 20,  # overshoots -> median baseline
            "capture_seconds_cap": 30.0,  # /debug/pyprof?seconds= cap
        },
    },
    # the numeric training-health monitor (core/health.py); off, every
    # check site is one config read
    "health": {
        "enabled": False,
        "interval": 1,            # check every N train steps
        "policy": "warn",         # "warn" | "snapshot" | "halt"
        "grad_norm_limit": 0.0,   # 0 disables the limit
        "param_norm_limit": 0.0,
        "update_norm_limit": 0.0,
        "loss_window": 8,         # divergence detector window (epochs)
        "loss_ema_alpha": 0.3,    # EMA smoothing of the explosion test
        "divergence_factor": 3.0,  # loss > factor * EMA: explosion
        "loss_rise": 0.1,         # net rise across a window: a slope
        "crash_dir": None,        # None: <dirs.cache>/crash_reports
    },
    # deterministic fault injection (core/faults.py); off, every
    # injection site is one config read.  rules: {site: {"kind":
    # "io" | "xla" | "crash" | "stall", "at": N | "every": K | "p": x,
    # "times": M, "stall_ms": ...}}
    "faults": {"enabled": False, "seed": 0, "rules": {}},
    # bounded retry of transient faults (the loader's fill, the
    # serving dispatch)
    "retry": {"attempts": 3, "backoff_base_ms": 5.0,
              "backoff_max_ms": 200.0},
    # minibatch and trainer dtype (None: follow the data, float32);
    # deterministic: cuDNN's deterministic algorithms on the card
    # (core.backends.deterministic), False lets it pick faster
    # nondeterministic ones
    "engine": {"precision_dtype": None, "deterministic": True},
    # the kernels' compile cache (core/compile_cache.py): where enabled,
    # the CUDA libraries are built into and loaded from `dir`, so a
    # fleet's replicas after the first build none; `serve
    # --compile-cache` enables it.  JAX's XLA thresholds
    # (min_compile_time_secs, min_entry_size_bytes) have nothing to
    # select here: every kernel library is cached
    "compile_cache": {
        "enabled": False,
        "dir": None,              # default: <cache dir>/kernel_cache
    },
    # the plotters' rendering (off: the plotters still record their
    # data)
    "disable": {"plotting": True},
    # the shell unit (core/interaction.py) opens a console only when on
    # and stdin is a terminal
    "interactive": False,
    # the analysis layer (analysis/): off, the locksmith lock factories
    # hand out plain threading primitives after ONE config predicate
    "analysis": {"lock_sanitizer": False},
    # the snapshotter's default directory, the datasets' (the MNIST
    # loader's IDX files) and the runtime cache (crash reports), inside
    # the checkout
    "dirs": {"snapshots": os.path.join(_CHECKOUT, ".snapshots"),
             "datasets": os.path.join(_CHECKOUT, ".data"),
             "cache": os.path.join(_CHECKOUT, ".cache")},
})


def apply_override(assignment, root_cfg=None):
    """Apply one CLI ``dotted.path=value`` override onto the config
    root.  Values parse as Python literals, falling back to strings; a
    leading ``root.`` is accepted and stripped."""
    path, sep, raw = assignment.partition("=")
    if not sep:
        raise SystemExit("--config needs KEY=VALUE, got %r" % assignment)
    try:
        value = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        value = raw
    parts = path.strip().split(".")
    if parts and parts[0] == "root":
        parts = parts[1:]
    node = root if root_cfg is None else root_cfg
    for p in parts[:-1]:
        node = getattr(node, p)
    setattr(node, parts[-1], value)
