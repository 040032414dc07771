"""Deterministic fault injection and transient-fault recovery.

Counterpart of ``znicz_tpu/core/faults.py``, with its names, rule
vocabulary and config keys, so one chaos config arms both packages:

* **the registry** — named injection sites on the hot paths
  (``loader.fill``, ``fused.dispatch``, ``fused.host_fetch``,
  ``snapshot.write``, ``serving.forward`` and
  ``serving.forward.<model>``).  Each site calls :func:`check` behind
  :func:`enabled`, one config read, so a run without faults pays
  nothing else.  Rules fire deterministically: ``at`` (the site's N-th
  invocation), ``every`` (every K-th), or ``p`` drawn from the rule's
  own ``numpy.random.RandomState(seed)``; ``times`` caps the firings.
  The kinds: ``io`` (a loader or disk error), ``xla`` (a transient
  device-runtime error), ``stall`` (the site sleeps ``stall_ms``) and
  ``crash`` (terminal: the stand-in for a preemption, which only the
  supervised launcher survives).
* **the transient classifier and bounded retry** —
  :func:`is_transient` separates "try again" from real crashes, and
  :func:`retry_call` wraps a call in exponential backoff
  (``root.common.retry``).  The loader's fill and the serving
  dispatch retry through it.

The third piece, the supervised restart with a mid-epoch resume, is
:func:`znicz_tpu_torch.launcher.run_supervised` with the snapshotter's
``window_interval``.  Everything is counted (``faults.injected``, by
site too, ``faults.retries``), journaled (``fault.injected``,
``fault.retry``) and served at ``GET /debug/faults``.  Rules install
with :func:`install` or from ``root.common.faults.rules``::

    python -m znicz_tpu_torch wine --config common.faults.enabled=True \\
        --config "common.faults.rules={'fused.dispatch': \\
                  {'kind': 'crash', 'at': 7}}"

The registry is process-global: a restart in the same process carries
the invocation counts on, so an ``at`` rule fires once across the
attempts.
"""

import logging
import time

import numpy
import torch

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import Config, root

logger = logging.getLogger("faults")

_cfg = root.common.faults
_retry_cfg = root.common.retry

#: recognized fault kinds (see module docstring)
KINDS = ("io", "xla", "crash", "stall")

#: status tokens marking an injected device-runtime error as transient
#: (the JAX package's vocabulary, so one chaos config arms both)
TRANSIENT_TOKENS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE",
                    "DEADLINE_EXCEEDED", "ABORTED")


class FaultInjectedError(Exception):
    """Marker mixin: every injected exception derives from it, so tests
    and the classifier can tell injected faults from organic ones."""


class InjectedIOError(FaultInjectedError, OSError):
    """Injected loader/disk I/O failure (transient)."""


class InjectedXlaError(FaultInjectedError, RuntimeError):
    """Injected device-runtime failure (the kind keeps the JAX
    package's name).  The message carries a status token
    (``RESOURCE_EXHAUSTED: ...``) and the transient classifier treats
    it as the out-of-memory error it stands in for."""


class InjectedCrashError(FaultInjectedError, RuntimeError):
    """Injected hard crash (non-transient) — the stand-in for
    preemption that only the supervised launcher's restart + resume
    path survives."""


def enabled():
    """The one gate every injection site tests (live config read, so a
    mid-run flip takes effect on the next site hit)."""
    return bool(_cfg.get("enabled", False))


def enable(rules=None, seed=None):
    """Arm the registry (optionally installing ``{site: rule}`` rules
    and the default probability seed)."""
    if seed is not None:
        root.common.faults.seed = int(seed)
    if rules:
        for site, rule in dict(rules).items():
            install(site, **dict(rule))
    root.common.faults.enabled = True
    return True


def disable():
    root.common.faults.enabled = False
    return False


class _Rule(object):
    """One armed fault: where it fires (at/every/p), what it raises,
    and how many times it is allowed to fire."""

    __slots__ = ("site", "kind", "at", "every", "p", "seed", "times",
                 "stall_ms", "message", "fired", "_rand")

    def __init__(self, site, kind="io", at=None, every=None, p=None,
                 seed=None, times=None, stall_ms=50.0, message=None):
        if kind not in KINDS:
            raise ValueError("unknown fault kind %r (known: %s)"
                             % (kind, ", ".join(KINDS)))
        if at is None and every is None and p is None:
            raise ValueError(
                "rule for %r needs a trigger: at=N, every=K or p=x"
                % site)
        self.site = site
        self.kind = kind
        self.at = None if at is None else int(at)
        self.every = None if every is None else int(every)
        self.p = None if p is None else float(p)
        self.seed = seed
        self.times = (1 if self.at is not None and times is None
                      else times)  # at=N naturally fires once
        if self.times is not None:
            self.times = int(self.times)
        self.stall_ms = float(stall_ms)
        self.message = message
        self.fired = 0
        # dedicated stream per rule: the draw sequence depends only on
        # (seed, invocation index), never on other sites' traffic
        self._rand = None
        if self.p is not None:
            base = int(_cfg.get("seed", 0) or 0) if seed is None \
                else int(seed)
            self._rand = numpy.random.RandomState(base & 0x7FFFFFFF)

    def should_fire(self, invocation):
        """Deterministic trigger decision for the site's
        ``invocation``-th call (1-based)."""
        if self.times is not None and self.fired >= self.times:
            return False
        if self.at is not None and invocation == self.at:
            return True
        if self.every is not None and invocation % self.every == 0:
            return True
        if self._rand is not None and \
                float(self._rand.random_sample()) < self.p:
            return True
        return False

    def describe(self):
        d = {"kind": self.kind, "fired": self.fired}
        for k in ("at", "every", "p", "times"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.kind == "stall":
            d["stall_ms"] = self.stall_ms
        return d


class _Registry(object):
    """Process-global site bookkeeping: per-site invocation counters
    and the armed rules."""

    def __init__(self):
        self._lock = locksmith.lock("faults.registry")
        self.rules = {}        # site -> _Rule
        self.invocations = {}  # site -> int
        self.injected = {}     # site -> int
        self.retries = 0
    def rule_for(self, site):
        rule = self.rules.get(site)
        if rule is not None:
            return rule
        # lazy adoption of config-declared rules (the CLI /
        # chaos-subprocess path: --config common.faults.rules={...}).
        # The absence of a rule is NOT cached: declaring a site at
        # runtime arms it on the next hit (the live-config contract),
        # and the miss path is two dict reads — cheap, and only ever
        # taken when faults are enabled.
        declared = _cfg.get("rules")
        if declared is None:
            return None
        spec = declared.get(site) if isinstance(
            declared, (dict, Config)) else None
        if spec is None:
            return None
        if isinstance(spec, Config):
            spec = spec.as_dict()
        rule = _Rule(site, **dict(spec))
        self.rules[site] = rule
        return rule


_registry_lock = locksmith.lock("faults.module")
_registry = None


def registry():
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = _Registry()
    return _registry


def reset():
    """Fresh registry (tests, bench isolation).  Does not touch the
    config gate or declared rules."""
    global _registry
    with _registry_lock:
        _registry = None


def install(site, **spec):
    """Arm (or replace) one site's rule; see :class:`_Rule` for the
    trigger/kind vocabulary.  Returns the rule."""
    reg = registry()
    with reg._lock:
        rule = _Rule(site, **spec)
        reg.rules[site] = rule
    return rule


def clear(site=None):
    """Disarm one site's rule (or all of them)."""
    reg = registry()
    with reg._lock:
        if site is None:
            reg.rules.clear()
        else:
            reg.rules.pop(site, None)


def check(site):
    """One injection-site hit: advance the site's invocation counter
    and fire the armed rule when its deterministic trigger matches.
    ``stall`` sleeps; every other kind raises.  Call sites guard with
    ``if faults.enabled():`` — this function is never on a disabled
    hot path."""
    reg = registry()
    with reg._lock:
        n = reg.invocations.get(site, 0) + 1
        reg.invocations[site] = n
        rule = reg.rule_for(site)
        if rule is None or not rule.should_fire(n):
            return None
        rule.fired += 1
        reg.injected[site] = reg.injected.get(site, 0) + 1
        kind = rule.kind
        stall_ms = rule.stall_ms
        message = rule.message
    if telemetry.enabled():
        telemetry.counter("faults.injected").inc()
        telemetry.counter(
            telemetry.labeled("faults.injected", site=site)).inc()
    telemetry.record_event("fault.injected", site=site, fault=kind,
                           invocation=n)
    logger.warning("injected %s fault at %s (invocation %d)",
                   kind, site, n)
    if kind == "stall":
        time.sleep(stall_ms / 1e3)
        return None
    msg = message or "injected %s fault at %s (invocation %d)" % (
        kind, site, n)
    if kind == "io":
        raise InjectedIOError(msg)
    if kind == "xla":
        raise InjectedXlaError("RESOURCE_EXHAUSTED: " + msg)
    raise InjectedCrashError(msg)


# ---------------------------------------------------------------------------
# Transient-fault classification + bounded retry
# ---------------------------------------------------------------------------

def is_transient(exc):
    """Would retrying plausibly succeed?  True for I/O errors (a flaky
    disk or network read, but not a missing file or a permission wall),
    for injected device-runtime errors carrying a retryable status
    token, and for ``torch.cuda.OutOfMemoryError``.  Injected crash
    faults, and everything else, are terminal."""
    if isinstance(exc, InjectedCrashError):
        return False
    if isinstance(exc, OSError):
        return not isinstance(exc, (FileNotFoundError, PermissionError,
                                    NotADirectoryError,
                                    IsADirectoryError))
    if isinstance(exc, InjectedXlaError):
        text = str(exc)
        return any(tok in text for tok in TRANSIENT_TOKENS)
    # the card's counterpart of XLA's RESOURCE_EXHAUSTED, which the JAX
    # package retries: an allocation that failed while other work held
    # the memory may succeed once that work has released it (the
    # caching allocator frees its cache and retries inside the failed
    # call first, so this is a second chance, not the first)
    return isinstance(exc, torch.cuda.OutOfMemoryError)


def note_retry(site, attempt, exc, delay_s):
    """Meter one retry decision (the caller is about to back off and
    try again)."""
    reg = registry()
    with reg._lock:
        reg.retries += 1
    if telemetry.enabled():
        telemetry.counter("faults.retries").inc()
        telemetry.counter(
            telemetry.labeled("faults.retries", site=site)).inc()
    telemetry.record_event("fault.retry", site=site, attempt=attempt,
                           error=repr(exc),
                           backoff_ms=round(delay_s * 1e3, 3))
    logger.warning("transient fault at %s (attempt %d, backing off "
                   "%.1f ms): %r", site, attempt, delay_s * 1e3, exc)


def retry_call(fn, site, attempts=None, classify=is_transient):
    """Call ``fn()`` with bounded exponential-backoff retry on
    transient failures.  ``attempts`` is the number of RETRIES after
    the first try (default ``root.common.retry.attempts``); backoff is
    ``backoff_base_ms * 2**attempt`` capped at ``backoff_max_ms``.
    Non-transient errors (and the final transient one) propagate."""
    if attempts is None:
        attempts = int(_retry_cfg.get("attempts", 3))
    base = float(_retry_cfg.get("backoff_base_ms", 5.0)) / 1e3
    cap = float(_retry_cfg.get("backoff_max_ms", 200.0)) / 1e3
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - classified below
            if attempt >= attempts or not classify(e):
                raise
            attempt += 1
            delay = min(base * (2 ** (attempt - 1)), cap)
            note_retry(site, attempt, e, delay)
            if delay > 0:
                time.sleep(delay)


# ---------------------------------------------------------------------------
# Introspection (GET /debug/faults)
# ---------------------------------------------------------------------------

def status():
    """The ``/debug/faults`` payload — safe with the registry cold
    (reports enabled=False and empty counters without creating one)."""
    out = {"enabled": enabled(),
           "retry": {
               "attempts": int(_retry_cfg.get("attempts", 3)),
               "backoff_base_ms": float(
                   _retry_cfg.get("backoff_base_ms", 5.0)),
               "backoff_max_ms": float(
                   _retry_cfg.get("backoff_max_ms", 200.0))},
           "rules": {}, "sites": {}, "retries": 0}
    reg = _registry  # read-only: never allocate just to report
    if reg is None:
        return out
    with reg._lock:
        out["rules"] = {s: r.describe() for s, r in reg.rules.items()}
        out["sites"] = {
            s: {"invocations": n, "injected": reg.injected.get(s, 0)}
            for s, n in reg.invocations.items()}
        out["retries"] = reg.retries
    return out
