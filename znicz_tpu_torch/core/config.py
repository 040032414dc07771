"""A small attribute-dict configuration tree.

Counterpart of ``znicz_tpu/core/config.py``, cut to what the port
reads: the ``root.common.serving`` knobs of the serving slice, the
``root.common.telemetry`` gate, ``root.common.engine.precision_dtype``
and ``deterministic``, ``root.common.dirs.snapshots`` / ``datasets`` of
the training workflows, and the CLI's ``--config`` parser
:func:`apply_override` (:535).  Namespaces auto-vivify on attribute
access; assigning a dict merges it into the node.
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
    "telemetry": {"enabled": False},
    # minibatch and trainer dtype (None: follow the data, float32);
    # deterministic: cuDNN's deterministic algorithms on the card
    # (core.backends.deterministic), False lets it pick faster
    # nondeterministic ones
    "engine": {"precision_dtype": None, "deterministic": True},
    # the snapshotter's default directory and the datasets' (the MNIST
    # loader's IDX files), inside the checkout
    "dirs": {"snapshots": os.path.join(_CHECKOUT, ".snapshots"),
             "datasets": os.path.join(_CHECKOUT, ".data")},
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
