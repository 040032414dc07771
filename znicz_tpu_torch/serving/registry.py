"""Multi-model registry — several inference engines behind one server.

Counterpart of ``znicz_tpu/serving/registry.py`` (``ModelRegistry``
:82).  The registry maps URL-safe model names to
:class:`~znicz_tpu_torch.serving.engine.InferenceEngine` instances:

* **add / remove / reload by name.**  ``add`` on a new name loads and
  warms a fresh engine before it becomes routable; on an existing name
  it hot-reloads that engine in place (a failed reload leaves that
  model serving its previous generation and touches no other).
  ``remove`` drops the engine; its device memory frees with the last
  reference.
* **LRU eviction under a device-memory budget.**  When the resident
  parameters of all models exceed the budget
  (``root.common.serving.registry_memory_budget_bytes``, read live, 0
  meaning none; or the constructor's ``memory_budget_bytes``), the
  least recently used resident model is evicted (``engine.evict``),
  keeping its host copies.  Each model counts the bytes of its serving
  dtype: an int8 model about a quarter of its f32 twin.
* **Lazy restore.**  The next request to an evicted model restores it
  (:meth:`ModelRegistry.engine`), which may evict another cold one.

* **A mutation guard** (JAX :105-125): :meth:`ModelRegistry.
  set_reload_guard` installs ``fn(name, action)``, consulted before a
  hot reload, a remove and an add (a release controller vetoes
  mutations of the model it is releasing with
  :class:`~znicz_tpu_torch.serving.release.ReleaseConflictError`, a
  409).

Membership changes are journaled as ``registry.add`` and
``registry.remove`` (JAX :174, :219).  The registry lock orders
membership changes; each engine's own load lock orders its generation
swaps.  Per-model telemetry carries a
``model_<name>`` label (the engine's ``name``).
"""

import re
import time

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core import compile_cache, telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.serving.engine import InferenceEngine

#: URL-routable model names (they appear in /predict/<name> paths)
_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


class UnknownModelError(KeyError):
    """No such model in the registry (HTTP 404)."""

    def __init__(self, name, known):
        self.model = name
        super().__init__("unknown model %r (serving: %s)"
                         % (name, sorted(known) or "none"))

    def __str__(self):  # KeyError would repr() the message
        return self.args[0]


class _Entry(object):
    __slots__ = ("engine", "last_used", "added")

    def __init__(self, engine, now):
        self.engine = engine
        self.last_used = now
        self.added = now


class ModelRegistry(Logger):
    """Named engines, routing and LRU residency (see the module
    docstring).  ``models`` is an optional ``{name: source}`` loaded at
    construction; ``engine_defaults`` (``max_batch=``, ``warmup=``,
    ``device=``, ``dtype=``, ...) go to every engine it creates."""

    def __init__(self, models=None, memory_budget_bytes=None,
                 **engine_defaults):
        super().__init__(logger_name="ModelRegistry")
        self._lock = locksmith.rlock("serving.registry")
        self._entries = {}
        self._default = None
        self._budget_override = memory_budget_bytes
        self._engine_defaults = dict(engine_defaults)
        self._evictions = 0
        #: the mutation guard (serving/release.py), None: no guard
        self._reload_guard = None
        for name in sorted(models or ()):
            self.add(name, models[name])

    # -- membership ---------------------------------------------------------
    def set_reload_guard(self, fn):
        """Install (or clear, with None) the guard ``fn(name, action)``
        consulted before every reload, remove and add; it raises to
        veto."""
        with self._lock:
            self._reload_guard = fn

    def _check_guard(self, name, action):
        with self._lock:
            guard = self._reload_guard
        if guard is not None:
            guard(name, action)

    def add(self, name, source, **engine_kwargs):
        """Load (or hot-reload) model ``name`` from ``source``; returns
        the engine's version.  A reload takes only ``sample_shape``:
        remove and add a model again to change its constructor's knobs
        (its dtype among them)."""
        name = str(name)
        if not _NAME_RE.match(name):
            raise ValueError(
                "model name %r is not URL-routable (allowed: letters, "
                "digits, '.', '_', '-'; max 64 chars)" % name)
        with self._lock:
            entry = self._entries.get(name)
        self._check_guard(name, "add")
        if entry is not None:
            unsupported = set(engine_kwargs) - {"sample_shape"}
            if unsupported:
                raise ValueError(
                    "model %r exists — a hot reload cannot change %s "
                    "(remove the model and add it again)"
                    % (name, sorted(unsupported)))
            version = entry.engine.load(source, **engine_kwargs)
            self._touch(name)
            self._enforce_budget(protect=name)
            return version
        kwargs = dict(self._engine_defaults, **engine_kwargs)
        engine = InferenceEngine(source, name=name, **kwargs)
        with self._lock:
            if name in self._entries:
                raise ValueError("model %r was added concurrently" % name)
            self._entries[name] = _Entry(engine, time.monotonic())
            if self._default is None:
                self._default = name
            count = len(self._entries)
        telemetry.record_event("registry.add", model=name,
                               version=engine.version,
                               source=str(engine.source),
                               serve_dtype=engine.serve_dtype)
        if telemetry.enabled():
            telemetry.gauge("serving.registry_models").set(count)
        self.info("model %r added (v%d, %s, %d model%s registered)", name,
                  engine.version, engine.serve_dtype, count,
                  "" if count == 1 else "s")
        self._enforce_budget(protect=name)
        return engine.version

    def reload(self, name, source=None, version=None):
        """Hot-reload ``name`` (the default model when None) from
        ``source``, or from the path it was loaded from when None;
        ``version`` pins the new generation's number."""
        key = name if name is not None else self._default
        self._check_guard(key, "reload")
        entry = self._entry(key)
        src = source
        if src is None:
            src = entry.engine.source
            if not src or str(src).startswith("<"):
                raise ValueError("model %r has no source on disk to read "
                                 "again — pass a path" % key)
        version = entry.engine.load(src, version=version)
        self._touch(key)
        self._enforce_budget(protect=key)
        return version

    def remove(self, name):
        """Drop model ``name``; the default moves to the oldest one
        left.  Returns the engine."""
        self._check_guard(name, "remove")
        with self._lock:
            entry = self._entries.pop(name, None)
            if entry is None:
                raise UnknownModelError(name, self._entries)
            if self._default == name:
                left = sorted(self._entries.items(),
                              key=lambda kv: kv[1].added)
                self._default = left[0][0] if left else None
            count = len(self._entries)
        telemetry.record_event("registry.remove", model=name)
        if telemetry.enabled():
            telemetry.gauge("serving.registry_models").set(count)
            telemetry.gauge("serving.registry_resident_bytes").set(
                self.resident_bytes)
        self.info("model %r removed (%d left)", name, count)
        return entry.engine

    # -- resolution ---------------------------------------------------------
    def _entry(self, name=None):
        with self._lock:
            key = name if name is not None else self._default
            if key is None or key not in self._entries:
                raise UnknownModelError(key, self._entries)
            return self._entries[key]

    def _touch(self, name):
        with self._lock:
            entry = self._entries.get(name)
            if entry is not None:
                entry.last_used = time.monotonic()

    def engine(self, name=None):
        """The engine serving ``name`` (the default model when None),
        marked most recently used; an evicted model is restored here,
        and the budget (read live) enforced."""
        key = name if name is not None else self._default
        entry = self._entry(name)
        self._touch(key)
        if not entry.engine.resident and entry.engine.version:
            entry.engine.restore()
            self._enforce_budget(protect=key)
        elif self.budget_bytes() > 0:
            self._enforce_budget(protect=key)
        return entry.engine

    def peek(self, name=None):
        """The engine, neither marked used nor restored: health probes
        and stats must not undo the budget's evictions."""
        return self._entry(name).engine

    def names(self):
        with self._lock:
            return sorted(self._entries)

    def __contains__(self, name):
        with self._lock:
            return name in self._entries

    def __len__(self):
        with self._lock:
            return len(self._entries)

    @property
    def default(self):
        return self._default

    # -- readiness / stats --------------------------------------------------
    def readiness(self):
        """``{model: ready}``."""
        with self._lock:
            items = list(self._entries.items())
        return {name: entry.engine.ready for name, entry in items}

    @property
    def ready(self):
        """True when there is a model and every model is ready."""
        r = self.readiness()
        return bool(r) and all(r.values())

    @property
    def resident_bytes(self):
        with self._lock:
            entries = list(self._entries.values())
        return sum(e.engine.device_bytes for e in entries)

    def budget_bytes(self):
        """The constructor's budget, else the live config's (0: none)."""
        if self._budget_override is not None:
            return int(self._budget_override)
        return int(root.common.serving.get(
            "registry_memory_budget_bytes", 0) or 0)

    def memory_stats(self):
        return {"budget_bytes": self.budget_bytes(),
                "resident_bytes": self.resident_bytes,
                "evictions": self._evictions}

    def stats(self):
        """The /models payload."""
        with self._lock:
            items = sorted(self._entries.items())
            default = self._default
        return {"models": {name: e.engine.stats() for name, e in items},
                "default": default, "memory": self.memory_stats(),
                "compile_cache": compile_cache.stats()}

    # -- the LRU budget -----------------------------------------------------
    def _enforce_budget(self, protect=None):
        """Evict least recently used resident models, never
        ``protect``, until the resident total fits the budget."""
        budget = self.budget_bytes()
        while budget > 0:
            with self._lock:
                total = sum(e.engine.device_bytes
                            for e in self._entries.values())
                if total <= budget:
                    break
                victims = sorted(
                    ((e.last_used, name, e) for name, e in
                     self._entries.items()
                     if name != protect and e.engine.resident),
                    key=lambda t: t[0])
                if not victims:
                    self.warning("registry over budget (%d > %d bytes) but "
                                 "nothing evictable", total, budget)
                    break
                _, victim_name, victim = victims[0]
            # outside the registry lock: evict takes the engine's load
            # lock, which a reload may hold while it warms up
            if victim.engine.evict():
                with self._lock:
                    self._evictions += 1
                if telemetry.enabled():
                    telemetry.counter("serving.registry_evictions").inc()
                self.info("LRU-evicted model %r (budget %d bytes)",
                          victim_name, budget)
        if telemetry.enabled():
            telemetry.gauge("serving.registry_resident_bytes").set(
                self.resident_bytes)
