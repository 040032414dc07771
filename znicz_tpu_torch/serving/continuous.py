"""Continuous batching — dispatch as capacity frees, over several models.

Counterpart of ``znicz_tpu/serving/continuous.py``
(``normalize_priority`` :76, ``ContinuousBatcher`` :103).  Requests
land in per-``(model, sample shape, serving dtype, priority, model
version)`` FIFO lanes as they arrive; ``max_inflight`` dispatch slots
(worker threads) each take the next run of requests of one lane the
moment they are free, up to the model's ``max_batch`` rows.  An idle
server answers one request at once; a busy one coalesces what arrives
while every slot is busy.  A slot picks the next model round-robin, so
a burst against one model cannot starve another, and within a model the
highest-priority lane first, then the lane whose head waited longest.

**Priorities** (``"high"``, ``"normal"``, ``"low"``; None is normal): a
priority admits only while the queued rows sit under its share of
``queue_limit`` (``root.common.serving.priority_queue_pct``, read
live), so under overload the low lane sheds first as 429s.

As the micro-batcher: a full queue raises :class:`QueueFullError`
(429), a request whose deadline passes in the queue fails with
:class:`RequestTimeoutError` (504) without a dispatch, ``stop(flush=
True)`` serves every queued request before the slots exit, and a
failing dispatch fails only its own batch.

**The admitted-request-id ring** (JAX :134-147, :364): the last
``admitted_rid_capacity`` request ids admitted to a lane, recorded
before the request is visible to a slot.  :meth:`ContinuousBatcher.
admitted_status` is the fleet router's retry-safety oracle (``GET
/admitted/<rid>``): an admitted rid may have been dispatched, so it is
never resent to a peer; the eviction count and the oldest retained
admission time say how far back a miss proves non-admission.  A request
whose model was removed while it queued (a release's candidate undeployed
by a rollback or an abort) ran no forward: it leaves the ring as it fails
with :class:`~znicz_tpu_torch.serving.registry.UnknownModelError`, so the
router's fallback to the live generation on a peer dispatches it once.  Request
ids ride to the engine's ``predict(x, request_ids=...)`` and key the
``queue_wait``, ``assembly`` and ``dispatch`` spans of sampled trees.

**Series** (JAX :380-613): ``serving.batches``, ``batch_rows``,
``batch_fill``, ``assembly_seconds``, ``pad_overhead``,
``request_seconds`` (also labelled by priority and by model),
``queue_wait_seconds`` (also by model), ``device_seconds``, the
``serving.inflight`` gauge, and ``serving.slow_request`` in the journal
over ``root.common.serving.slow_request_ms``.

**A pinned bucket.**  ``submit(..., bucket=B)`` dispatches the request
padded to at least bucket ``B``, in a lane of its own; every resolved
future carries the bucket its batch ran at (``future.bucket``, and
``predict(..., info={})``'s ``info["bucket"]``).  A release's shadow
compare replays a live request at its bucket that way.
"""

import collections
import concurrent.futures
import threading
import time

import numpy

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core import pyprof, telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.serving.batcher import (_DISPATCH_GRACE, _Request,
                                             BatcherStoppedError,
                                             QueueFullError,
                                             RequestTimeoutError,
                                             note_slow, note_spans)
from znicz_tpu_torch.serving.engine import (claim_blas_handle,
                                            matches_sample_shape)
from znicz_tpu_torch.serving.registry import UnknownModelError

#: priority lanes, best first (their dispatch rank)
PRIORITIES = {"high": 0, "normal": 1, "low": 2}


def normalize_priority(priority):
    """None -> "normal"; anything else must name a lane (a typo is the
    client's error, HTTP 400, never a silent default)."""
    if priority is None:
        return "normal"
    p = str(priority).strip().lower()
    if p not in PRIORITIES:
        raise ValueError("unknown priority %r (accepted: %s)" % (
            priority, "/".join(sorted(PRIORITIES, key=PRIORITIES.get))))
    return p


class _Lane(object):
    __slots__ = ("reqs", "max_batch")

    def __init__(self, max_batch):
        self.reqs = collections.deque()
        self.max_batch = max_batch


class ContinuousBatcher(Logger):
    """Continuous batching over a :class:`~znicz_tpu_torch.serving.
    registry.ModelRegistry` (``submit(..., model=name)``), one engine,
    or any ``callable(batch, request_ids=None) -> batch``.  Unset knobs
    come from ``root.common.serving`` (``max_inflight``,
    ``queue_limit``, ``timeout_ms``)."""

    def __init__(self, models, max_inflight=None, queue_limit=None,
                 timeout_ms=None):
        super().__init__(logger_name="ContinuousBatcher")
        cfg = root.common.serving
        self._registry = models if hasattr(models, "engine") and \
            hasattr(models, "names") else None
        self._single = None if self._registry is not None else models
        self.max_inflight = int(max_inflight if max_inflight is not None
                                else cfg.get("max_inflight", 2))
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else cfg.get("queue_limit", 256))
        timeout_ms = (timeout_ms if timeout_ms is not None
                      else cfg.get("timeout_ms", 1000.0))
        self.timeout = float(timeout_ms) / 1e3 if timeout_ms else None
        self._lanes = {}
        self._rows_queued = 0
        self._last_model = None    # the round-robin cursor
        self._cond = locksmith.condition("serving.continuous")
        self._running = False
        self._threads = []
        self._inflight = 0
        #: the admitted-request-id ring: a deque of (rid, wall time)
        #: and a set for membership, both under the condition lock
        self._admitted_cap = int(cfg.get("admitted_rid_capacity", 4096)
                                 or 0)
        self._admitted_ring = collections.deque()
        self._admitted_set = set()
        self._admitted_evictions = 0

    def _resolve(self, model):
        """The engine serving ``model`` at dispatch: marks it used and
        restores it when the budget had evicted it."""
        if self._registry is not None:
            return self._registry.engine(model)
        return self._single

    def _peek(self, model):
        """The engine at admission, without side effects: a request
        about to be refused must not keep a cold model resident."""
        if self._registry is not None:
            return self._registry.peek(model)
        return self._single

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        with self._cond:
            if not self._running:
                self._running = True
                self._threads = [
                    threading.Thread(
                        target=self._worker, daemon=True,
                        name=pyprof.thread_name("continuous-%d" % i))
                    for i in range(self.max_inflight)]
                for t in self._threads:
                    t.start()
        return self

    def stop(self, flush=True):
        """Stop the slots; ``flush=True`` serves what is queued first,
        ``flush=False`` fails the pending futures."""
        with self._cond:
            self._running = False
            if not flush:
                for lane in self._lanes.values():
                    while lane.reqs:
                        lane.reqs.popleft().future.set_exception(
                            BatcherStoppedError("batcher stopped"))
                self._lanes.clear()
                self._rows_queued = 0
            self._cond.notify_all()
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=30)

    # -- submission ---------------------------------------------------------
    def submit(self, x, model=None, timeout_ms=None, priority=None,
               request_id=None, bucket=None):
        """Enqueue; returns a Future of the output rows.  ``model``
        routes within a registry (None: its default model);
        ``request_id`` enters the admitted ring and keys the request's
        trace spans; ``bucket`` pins the smallest bucket it is padded
        to."""
        if not self._running:
            raise BatcherStoppedError("batcher is not running")
        priority = normalize_priority(priority)
        engine = self._peek(model)
        x = numpy.asarray(x)
        sample = getattr(engine, "sample_shape", None)
        if sample is not None and matches_sample_shape(x.shape, sample):
            x = x[None]
        if x.ndim < 2:
            x = numpy.atleast_2d(x)
        rows = x.shape[0]
        if rows == 0:
            raise ValueError("empty request")
        max_batch = int(getattr(engine, "max_batch", 0) or
                        root.common.serving.get("max_batch", 64))
        if rows > max_batch:
            raise ValueError("request of %d rows exceeds max_batch %d — "
                             "split it client-side" % (rows, max_batch))
        now = time.monotonic()
        timeout = (self.timeout if timeout_ms is None
                   else (float(timeout_ms) / 1e3 or None))
        future = concurrent.futures.Future()
        req = _Request(x, rows, future, now,
                       now + timeout if timeout else None, rid=request_id)
        # one lane per generation and dtype: a hot reload never
        # coalesces requests admitted against two generations
        key = (model, x.shape[1:], getattr(engine, "serve_dtype", None),
               priority, getattr(engine, "version", None),
               int(bucket or 0))
        pct = root.common.serving.get("priority_queue_pct", {}).get(
            priority, 100.0)
        limit = min(self.queue_limit,
                    int(self.queue_limit * float(pct) / 100.0))
        with self._cond:
            if not self._running:
                raise BatcherStoppedError("batcher is not running")
            if self._rows_queued + rows > limit:
                if telemetry.enabled():
                    telemetry.counter(telemetry.labeled(
                        "serving.rejected", priority=priority)).inc()
                raise QueueFullError(
                    "queue full for %s priority (%d rows queued, lane "
                    "limit %d of %d)" % (priority, self._rows_queued,
                                         limit, self.queue_limit))
            if request_id and self._admitted_cap > 0 and \
                    request_id not in self._admitted_set:
                # recorded before a slot can see the request: a router
                # asking after a broken connection must never hear "not
                # admitted" for a request a slot already runs
                self._admitted_ring.append((request_id, time.time()))
                self._admitted_set.add(request_id)
                while len(self._admitted_ring) > self._admitted_cap:
                    dropped, _ = self._admitted_ring.popleft()
                    self._admitted_set.discard(dropped)
                    self._admitted_evictions += 1
            lane = self._lanes.get(key)
            if lane is None:
                lane = self._lanes[key] = _Lane(max_batch)
            lane.max_batch = max_batch
            lane.reqs.append(req)
            self._rows_queued += rows
            if telemetry.enabled():
                telemetry.gauge("serving.queue_depth").set(
                    self._rows_queued)
            self._cond.notify()
        return future

    def predict(self, x, model=None, timeout_ms=None, priority=None,
                request_id=None, bucket=None, info=None):
        """Blocking submit; with a deadline the wait is bounded too.
        ``info``, a dict, receives the ``bucket`` the batch ran at."""
        timeout = (self.timeout if timeout_ms is None
                   else (float(timeout_ms) / 1e3 or None))
        future = self.submit(x, model=model, timeout_ms=timeout_ms,
                             priority=priority, request_id=request_id,
                             bucket=bucket)
        try:
            y = future.result(timeout=None if timeout is None
                              else timeout + _DISPATCH_GRACE)
        except concurrent.futures.TimeoutError:
            raise RequestTimeoutError("request did not complete within "
                                      "%.1f s" % (timeout + _DISPATCH_GRACE))
        if info is not None:
            info["bucket"] = getattr(future, "bucket", None)
        return y

    @property
    def queued_rows(self):
        return self._rows_queued

    @property
    def inflight(self):
        return self._inflight

    def _withdraw(self, rids):
        """Take ``rids`` out of the admitted ring (requests that failed
        before any forward ran for them)."""
        with self._cond:
            gone = set(rids) & self._admitted_set
            if not gone:
                return
            self._admitted_set -= gone
            self._admitted_ring = collections.deque(
                (rid, t) for rid, t in self._admitted_ring
                if rid not in gone)

    def admitted_status(self, rid):
        """The router's oracle with its coverage: a miss proves
        non-admission only for requests admitted after
        ``oldest_retained_ts`` (for all time while ``evictions`` is
        0)."""
        with self._cond:
            return {
                "admitted": bool(rid) and rid in self._admitted_set,
                "evictions": self._admitted_evictions,
                "oldest_retained_ts": (self._admitted_ring[0][1]
                                       if self._admitted_ring else None),
            }

    # -- the dispatch slots -------------------------------------------------
    def _worker(self):
        claim_blas_handle()  # a slot's cuBLAS handle lives as it does
        while True:
            taken = self._take()
            if taken is None:
                return
            with self._cond:
                self._inflight += 1
                if telemetry.enabled():
                    telemetry.gauge("serving.inflight").set(self._inflight)
            try:
                self._run_batch(*taken)
            finally:
                with self._cond:
                    self._inflight -= 1
                    if telemetry.enabled():
                        telemetry.gauge("serving.inflight").set(
                            self._inflight)

    def _next_key(self):
        """The next model after the last one served that has work; its
        best-priority lane, then the one whose head waited longest.
        Called under the condition lock."""
        pending = {}
        for key, lane in self._lanes.items():
            if lane.reqs:
                pending.setdefault(key[0], []).append(key)
        if not pending:
            return None
        models = sorted(pending, key=lambda m: (m is None, m))
        if self._last_model in models:
            i = models.index(self._last_model) + 1
            models = models[i:] + models[:i]
        model = models[0]
        self._last_model = model
        return min(pending[model], key=lambda k: (
            PRIORITIES[k[3]], self._lanes[k].reqs[0].arrived))

    def _take(self):
        """Block until there is work; pop one lane's FIFO run of at most
        its max_batch rows.  None: stopped and drained."""
        with self._cond:
            while self._running and not any(
                    lane.reqs for lane in self._lanes.values()):
                self._cond.wait()
            key = self._next_key()
            if key is None:
                return None
            lane = self._lanes[key]
            batch, rows = [], 0
            while lane.reqs and rows + lane.reqs[0].rows <= lane.max_batch:
                r = lane.reqs.popleft()
                batch.append(r)
                rows += r.rows
            if not batch:
                # a head over a cap a reload shrank: alone, so the
                # engine answers it (and the slot does not spin)
                r = lane.reqs.popleft()
                batch.append(r)
                rows = r.rows
            if not lane.reqs:
                del self._lanes[key]
            self._rows_queued -= rows
            if telemetry.enabled():
                telemetry.gauge("serving.queue_depth").set(
                    self._rows_queued)
            return key[0], batch, key[3], key[5]

    def _run_batch(self, model, batch, priority="normal", pin=0):
        now = time.monotonic()
        live = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                if telemetry.enabled():
                    telemetry.counter("serving.timeouts").inc()
                    if model is not None:
                        telemetry.counter(telemetry.labeled(
                            "serving.timeouts", model=model)).inc()
                r.future.set_exception(RequestTimeoutError(
                    "request expired after %.1f ms in queue"
                    % ((now - r.arrived) * 1e3)))
            else:
                live.append(r)
        if not live:
            return
        rows = sum(r.rows for r in live)
        try:
            # resolution (a removed model, a failed restore) and the
            # forward fail this batch, never the slot
            try:
                engine = self._resolve(model)
            except UnknownModelError:
                # removed while queued: no forward ran for these
                self._withdraw([r.rid for r in live if r.rid])
                raise
            predict = getattr(engine, "predict", engine)
            bucket_for = getattr(engine, "bucket_for", None)
            bucket = bucket_for(max(rows, pin)) if bucket_for else rows
            t_asm = time.monotonic()
            x = (live[0].arr if len(live) == 1 else
                 numpy.concatenate([r.arr for r in live], axis=0))
            t_dev = time.monotonic()
            rids = [r.rid for r in live if r.rid]
            pinned = {"bucket": pin} if pin else {}
            y = numpy.asarray(predict(x, request_ids=rids or None,
                                      **pinned))
            dev_dt = time.monotonic() - t_dev
        except Exception as e:  # noqa: BLE001 - fail the batch, not us
            if telemetry.enabled():
                telemetry.counter("serving.errors").inc()
                if model is not None:
                    telemetry.counter(telemetry.labeled(
                        "serving.errors", model=model)).inc()
            self.warning("batch of %d rows (model %s) failed: %r", rows,
                         model or "<default>", e)
            for r in live:
                r.future.set_exception(e)
            return
        done = time.monotonic()
        asm_dt = t_dev - t_asm
        if telemetry.enabled():
            telemetry.counter("serving.batches").inc()
            telemetry.histogram("serving.batch_rows").observe(rows)
            telemetry.histogram("serving.batch_fill").observe(
                rows / float(bucket))
            telemetry.histogram("serving.assembly_seconds").observe(asm_dt)
            telemetry.histogram("serving.pad_overhead").observe(
                (bucket - rows) / float(bucket))
            latency = [telemetry.histogram("serving.request_seconds"),
                       telemetry.histogram(telemetry.labeled(
                           "serving.request_seconds", priority=priority))]
            queue_wait = [telemetry.histogram("serving.queue_wait_seconds")]
            if model is not None:
                latency.append(telemetry.histogram(telemetry.labeled(
                    "serving.request_seconds", model=model)))
                queue_wait.append(telemetry.histogram(telemetry.labeled(
                    "serving.queue_wait_seconds", model=model)))
            device = telemetry.histogram("serving.device_seconds")
            for r in live:
                for h in latency:
                    h.observe(done - r.arrived)
                for h in queue_wait:
                    h.observe(max(now - r.arrived, 0.0))
                # coalesced requests share their batch's dispatch
                device.observe(dev_dt)
        note_spans(live, now, t_dev, dev_dt, rows, bucket)
        note_slow(self, live, now, done, asm_dt, dev_dt, rows, bucket,
                  model=model)
        offset = 0
        for r in live:
            r.future.bucket = bucket
            r.future.set_result(y[offset:offset + r.rows])
            offset += r.rows
