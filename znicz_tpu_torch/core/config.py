"""A small attribute-dict configuration tree.

Counterpart of ``znicz_tpu/core/config.py``, cut to what the port
reads: the ``root.common.serving`` knobs of the serving slice, the
``root.common.telemetry`` gate and journal size,
``root.common.engine.precision_dtype`` and ``deterministic``,
``root.common.dirs.snapshots`` / ``datasets`` / ``cache`` of the
training workflows, the ``root.common.faults`` / ``retry`` / ``health``
knobs of the fault-injection registry, the transient retry and the
health monitor (:284-296, :329-348), and the CLI's ``--config`` parser
:func:`apply_override` (:535).  Namespaces auto-vivify on attribute
access; assigning a dict merges it into the node.

The port declares no knob vocabulary; ``common.faults.rules`` is, as
in the JAX package (:150-195), an open dict whose keys are injection
sites and whose values are rule dicts: payload, not knobs.
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

    def as_dict(self):
        return {k: (v.as_dict() if isinstance(v, Config) else v)
                for k, v in self.__dict__.items()
                if not (k.startswith("_") and k.endswith("_"))}

    def to_json(self):
        """The tree as JSON text; values JSON cannot hold as their repr."""
        return json.dumps(self.as_dict(), default=repr, sort_keys=True)

    def __repr__(self):
        return "<Config %s: %s>" % (self._path_, sorted(self.as_dict()))


#: The global configuration root.
root = Config("root")
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

root.common.update({
    "serving": {
        "host": "127.0.0.1",
        "port": 8899,
        "max_batch": 64,          # micro-batch ceiling = largest bucket
        "max_delay_ms": 5.0,      # batching window after first request
        "queue_limit": 256,       # queued ROWS before 429 backpressure
        "timeout_ms": 1000.0,     # per-request deadline in the queue
        "warmup": True,           # run every bucket once before ready
        "max_body_bytes": 16 << 20,  # larger request bodies get 413
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
    },
    "telemetry": {"enabled": False,
                  # the flight-recorder journal's ring (events kept)
                  "journal_capacity": 4096},
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
