"""Per-bucket circuit breaker.

Counterpart of ``znicz_tpu/serving/breaker.py`` (``CircuitOpenError``
:36, ``CircuitBreaker`` :49).  A failing backend degrades into fast
503s instead of a pile of doomed dispatches.  One breaker guards one
shape bucket:

* **closed** — serving; ``threshold`` consecutive dispatch failures
  open it, any success resets the count;
* **open** — :meth:`~CircuitBreaker.allow` raises
  :class:`CircuitOpenError` (HTTP 503 with ``Retry-After``) without a
  dispatch until ``cooldown_s`` has passed;
* **half-open** — then up to ``half_open_max`` concurrent probes are
  admitted; a probe's success closes it, its failure opens it again.

The knobs are ``root.common.serving.breaker_threshold`` (0 turns the
breakers off), ``breaker_cooldown_ms`` and ``breaker_half_open_max``;
the engine reads them at every dispatch.  The clock is injectable.
Every transition is journaled as ``serving.breaker`` (JAX :161).
"""

import time

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core import telemetry

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitOpenError(RuntimeError):
    """The breaker is open: the request was refused without a
    dispatch; ``retry_after`` is the seconds to the next probe."""

    def __init__(self, name, retry_after):
        self.name = name
        self.retry_after = max(float(retry_after), 0.0)
        super().__init__("circuit %s is open; retry in %.3f s"
                         % (name, self.retry_after))


class CircuitBreaker(object):
    """One guarded dispatch path (see the module docstring)."""

    def __init__(self, name, threshold=5, cooldown_s=1.0, half_open_max=1,
                 clock=time.monotonic):
        self.name = name
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self.half_open_max = max(int(half_open_max), 1)
        self._clock = clock
        self._lock = locksmith.lock("serving.breaker")
        self.state = CLOSED
        self._failures = 0
        self._opened_at = None
        self._probes = 0
        self.opens = 0

    def allow(self):
        """Gate one dispatch: raises :class:`CircuitOpenError` while open
        (or half-open with every probe slot taken).  An admitted call is
        answered by exactly one ``record_*``.  Returns True when the
        admission took a half-open probe slot."""
        with self._lock:
            if self.state == CLOSED:
                return False
            now = self._clock()
            if self.state == OPEN:
                remaining = self.cooldown_s - (now - self._opened_at)
                if remaining > 0:
                    raise CircuitOpenError(self.name, remaining)
                self._transition(HALF_OPEN)
                self._probes = 0
            if self._probes >= self.half_open_max:
                raise CircuitOpenError(self.name, min(self.cooldown_s, 1.0))
            self._probes += 1
            return True

    def record_success(self):
        with self._lock:
            self._failures = 0
            if self.state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self):
        with self._lock:
            if self.state == HALF_OPEN:
                self._open()
                return
            self._failures += 1
            if self.state == CLOSED and self._failures >= self.threshold:
                self._open()

    def record_neutral(self, probe=True):
        """The call said nothing of the backend's health (a client's
        bad input): free the half-open probe slot it took, if any."""
        with self._lock:
            if probe and self.state == HALF_OPEN and self._probes > 0:
                self._probes -= 1

    def reconfigure(self, threshold, cooldown_s, half_open_max):
        """Adopt new knob values; the state stays as it is."""
        with self._lock:
            self.threshold = max(int(threshold), 1)
            self.cooldown_s = float(cooldown_s)
            self.half_open_max = max(int(half_open_max), 1)

    def _open(self):
        self._opened_at = self._clock()
        self.opens += 1
        if telemetry.enabled():
            telemetry.counter("serving.breaker_opens").inc()
        self._transition(OPEN)

    def _transition(self, state):
        prev, self.state = self.state, state
        if prev == state:
            return
        if telemetry.enabled():
            telemetry.gauge(telemetry.labeled(
                "serving.breaker_open", breaker=self.name)).set(
                    0 if state == CLOSED else 1)
        telemetry.record_event("serving.breaker", name=self.name,
                               state=state, previous=prev,
                               failures=self._failures)

    def status(self):
        with self._lock:
            st = {"state": self.state, "failures": self._failures,
                  "opens": self.opens}
            if self.state == OPEN and self._opened_at is not None:
                st["retry_after"] = round(max(
                    self.cooldown_s - (self._clock() - self._opened_at),
                    0.0), 3)
            return st
