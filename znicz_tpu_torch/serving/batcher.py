"""Dynamic micro-batcher — coalesces concurrent requests into one
engine dispatch.

Counterpart of ``znicz_tpu/serving/batcher.py`` (:60-300).  Requests
(each a batch-first array of 1..max_batch rows) enter a bounded queue;
one worker thread closes a batching window when either

* ``max_batch`` rows are pending (size close), or
* ``max_delay_ms`` passed since the OLDEST pending request arrived
  (deadline close — bounded latency under trickle traffic),

runs the coalesced rows through the engine in one dispatch and hands
each caller its rows.  Overload fails fast:

* a full queue rejects new work with :class:`QueueFullError` (HTTP 429);
* a request whose deadline expires while queued fails with
  :class:`RequestTimeoutError` (HTTP 504) without costing a dispatch.

A request's id (``request_id=``) rides to the engine's ``predict(x,
request_ids=...)`` (every dispatch passes it), and keys the
``queue_wait``, ``assembly`` and ``dispatch`` spans of a sampled trace
tree (:func:`note_spans`).  A request slower than
``root.common.serving.slow_request_ms`` is logged and journaled
(:func:`note_slow`); each batch records the ``serving.assembly_seconds``
and ``serving.pad_overhead`` series.
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
from znicz_tpu_torch.serving import reqtrace
from znicz_tpu_torch.serving.engine import (claim_blas_handle,
                                            matches_sample_shape)

#: extra seconds predict() waits past the request deadline — covers a
#: dispatch that started just before the deadline
_DISPATCH_GRACE = 60.0


class QueueFullError(RuntimeError):
    """Backpressure: the bounded request queue is full (HTTP 429)."""


class BatcherStoppedError(RuntimeError):
    """Submit raced stop(): the batcher no longer admits work (503)."""


class RequestTimeoutError(TimeoutError):
    """The request's deadline expired while it waited (HTTP 504)."""


class _Request(object):
    __slots__ = ("arr", "rows", "future", "arrived", "deadline", "rid")

    def __init__(self, arr, rows, future, arrived, deadline, rid=None):
        self.arr = arr
        self.rows = rows
        self.future = future
        self.arrived = arrived
        self.deadline = deadline
        self.rid = rid


class MicroBatcher(Logger):
    """Coalesces concurrent predict requests into micro-batches.

    ``engine`` is an :class:`~znicz_tpu_torch.serving.engine.
    InferenceEngine` or any ``callable(batch, request_ids=None) ->
    batch``.  Unset knobs
    come from ``root.common.serving``; ``timeout_ms`` is the default
    per-request queue deadline (0/None disables)."""

    def __init__(self, engine, max_batch=None, max_delay_ms=None,
                 queue_limit=None, timeout_ms=None):
        super().__init__(logger_name="MicroBatcher")
        cfg = root.common.serving
        self._engine = engine if hasattr(engine, "predict") else None
        self._predict = engine.predict if self._engine else engine
        self._bucket_for = getattr(engine, "bucket_for", None)
        self.max_batch = int(max_batch if max_batch is not None
                             else getattr(engine, "max_batch", None)
                             or cfg.get("max_batch", 64))
        self.max_delay = float(max_delay_ms if max_delay_ms is not None
                               else cfg.get("max_delay_ms", 5.0)) / 1e3
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else cfg.get("queue_limit", 256))
        timeout_ms = (timeout_ms if timeout_ms is not None
                      else cfg.get("timeout_ms", 1000.0))
        self.timeout = float(timeout_ms) / 1e3 if timeout_ms else None
        self._queue = collections.deque()
        self._rows_queued = 0
        self._cond = locksmith.condition("serving.batcher")
        self._running = False
        self._thread = None

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        with self._cond:
            if not self._running:
                self._running = True
                self._thread = threading.Thread(
                    target=self._worker,
                    name=pyprof.thread_name("micro-batcher"), daemon=True)
                self._thread.start()
        return self

    def stop(self, flush=True):
        """Stop the worker.  ``flush=True`` serves what is queued
        first; ``flush=False`` fails pending futures."""
        with self._cond:
            self._running = False
            if not flush:
                while self._queue:
                    self._queue.popleft().future.set_exception(
                        BatcherStoppedError("batcher stopped"))
                self._rows_queued = 0
            self._cond.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=30)

    # -- submission ---------------------------------------------------------
    def submit(self, x, timeout_ms=None, request_id=None):
        """Enqueue a request; returns a ``Future`` of its output rows.
        ``request_id`` rides to the engine and keys the request's trace
        spans.  Raises :class:`QueueFullError` at capacity and
        ``ValueError`` for empty or oversized requests."""
        x = numpy.asarray(x)
        sample = getattr(self._engine, "sample_shape", None)
        if sample is not None and matches_sample_shape(x.shape, sample):
            x = x[None]  # one sample, not H rows
        if x.ndim < 2:
            x = numpy.atleast_2d(x)
        rows = x.shape[0]
        if rows == 0:
            raise ValueError("empty request")
        if rows > self.max_batch:
            raise ValueError("request of %d rows exceeds max_batch %d — "
                             "split it client-side" % (rows, self.max_batch))
        now = time.monotonic()
        timeout = (self.timeout if timeout_ms is None
                   else (float(timeout_ms) / 1e3 or None))
        future = concurrent.futures.Future()
        with self._cond:
            if not self._running:
                raise BatcherStoppedError("batcher is not running")
            if self._rows_queued + rows > self.queue_limit:
                telemetry.counter("serving.rejected").inc()
                raise QueueFullError("queue full (%d rows queued, limit %d)"
                                     % (self._rows_queued, self.queue_limit))
            self._queue.append(_Request(x, rows, future, now,
                                        now + timeout if timeout else None,
                                        rid=request_id))
            self._rows_queued += rows
            telemetry.gauge("serving.queue_depth").set(self._rows_queued)
            self._cond.notify_all()
        return future

    def predict(self, x, timeout_ms=None, request_id=None):
        """Blocking submit: the output rows, or what the worker raised.
        With a deadline the wait is bounded too (deadline + grace)."""
        timeout = (self.timeout if timeout_ms is None
                   else (float(timeout_ms) / 1e3 or None))
        future = self.submit(x, timeout_ms=timeout_ms,
                             request_id=request_id)
        if timeout is None:
            return future.result()
        try:
            return future.result(timeout=timeout + _DISPATCH_GRACE)
        except concurrent.futures.TimeoutError:
            raise RequestTimeoutError(
                "request did not complete within %.1f s"
                % (timeout + _DISPATCH_GRACE))

    @property
    def queued_rows(self):
        return self._rows_queued

    # -- the worker ---------------------------------------------------------
    def _worker(self):
        claim_blas_handle()  # the worker's cuBLAS handle lives as it does
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            self._run_batch(batch)

    def _take_batch(self):
        """Block until a window closes; pop FIFO requests of one sample
        shape totalling at most ``max_batch`` rows.  None = stopped and
        drained."""
        with self._cond:
            while not self._queue and self._running:
                self._cond.wait()
            if not self._queue:
                return None
            window_close = self._queue[0].arrived + self.max_delay
            while self._running and self._rows_queued < self.max_batch:
                remaining = window_close - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            if not self._queue:
                return None  # stop(flush=False) drained it meanwhile
            batch, rows = [], 0
            sample_shape = self._queue[0].arr.shape[1:]
            while self._queue and \
                    rows + self._queue[0].rows <= self.max_batch and \
                    self._queue[0].arr.shape[1:] == sample_shape:
                r = self._queue.popleft()
                batch.append(r)
                rows += r.rows
            self._rows_queued -= rows
            telemetry.gauge("serving.queue_depth").set(self._rows_queued)
            return batch

    def _run_batch(self, batch):
        now = time.monotonic()
        live = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                telemetry.counter("serving.timeouts").inc()
                r.future.set_exception(RequestTimeoutError(
                    "request expired after %.1f ms in queue"
                    % ((now - r.arrived) * 1e3)))
            else:
                live.append(r)
        if not live:
            return
        rows = sum(r.rows for r in live)
        try:
            # everything that can raise is inside the guard: a surprise
            # fails this batch's futures, never the worker thread
            bucket = (self._bucket_for(rows) if self._bucket_for
                      else self.max_batch)
            t_asm = time.monotonic()
            x = (live[0].arr if len(live) == 1 else
                 numpy.concatenate([r.arr for r in live], axis=0))
            t_dev = time.monotonic()
            rids = [r.rid for r in live if r.rid]
            y = numpy.asarray(self._predict(x, request_ids=rids or None))
            dev_dt = time.monotonic() - t_dev
        except Exception as e:  # noqa: BLE001 - fail the batch, not us
            telemetry.counter("serving.errors").inc()
            self.warning("batch of %d rows failed: %r", rows, e)
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
            for r in live:
                telemetry.histogram("serving.request_seconds").observe(
                    done - r.arrived)
                telemetry.histogram("serving.queue_wait_seconds").observe(
                    max(now - r.arrived, 0.0))
                telemetry.histogram("serving.device_seconds").observe(
                    dev_dt)
        note_spans(live, now, t_dev, dev_dt, rows, bucket)
        note_slow(self, live, now, done, asm_dt, dev_dt, rows, bucket)
        offset = 0
        for r in live:
            r.future.set_result(y[offset:offset + r.rows])
            offset += r.rows


def note_slow(logger, live, t_take, done, asm_dt, dev_dt, rows, bucket,
              **lane):
    """Log and journal (``serving.slow_request``, JAX batcher.py:378,
    continuous.py:597) each request of a batch slower than
    ``root.common.serving.slow_request_ms`` (0: never), with its
    breakdown; ``lane`` is the continuous batcher's ``model=``."""
    slow_ms = float(root.common.serving.get("slow_request_ms", 1000.0)
                    or 0.0)
    if slow_ms <= 0.0:
        return
    tracing = reqtrace.enabled()
    for r in live:
        total = done - r.arrived
        if total * 1e3 <= slow_ms:
            continue
        waited = max(t_take - r.arrived, 0.0)
        logger.warning(
            "slow request%s: total %.1f ms (queue %.1f ms, assembly %.2f "
            "ms, device %.1f ms; %d rows in a %d-row batch, bucket %d%s)",
            " " + r.rid if r.rid else "", total * 1e3, waited * 1e3,
            asm_dt * 1e3, dev_dt * 1e3, r.rows, rows, bucket,
            ", model %s" % (lane["model"] or "<default>") if lane else "")
        telemetry.record_event(
            "serving.slow_request", rid=r.rid, **lane,
            total_ms=round(total * 1e3, 3),
            queue_ms=round(waited * 1e3, 3),
            assembly_ms=round(asm_dt * 1e3, 3),
            device_ms=round(dev_dt * 1e3, 3),
            rows=r.rows, batch_rows=rows, bucket=bucket,
            # the rid is a trace exemplar where it was head-sampled
            trace_sampled=bool(tracing and r.rid
                               and reqtrace.sampled(r.rid)))


def note_spans(live, t_take, t_dev, dev_dt, rows, bucket):
    """The batcher's legs of each sampled request's span tree:
    ``queue_wait`` (the end of the tree's ``admission``, or the arrival,
    to the slot's taking of the batch), ``assembly`` (the taking to the
    engine call) and ``dispatch`` (the engine call; the engine's
    ``device`` span nests inside it): contiguous, as the partition
    wants (``reqtrace``).  Spans are added before the futures resolve,
    so a woken caller sees its tree whole."""
    if not reqtrace.enabled():
        return
    for r in live:
        if r.rid and reqtrace.sampled(r.rid):
            admitted = reqtrace.span_end(r.rid, "admission")
            reqtrace.add_span(r.rid, "queue_wait", r.arrived
                              if admitted is None else admitted, t_take)
            reqtrace.add_span(r.rid, "assembly", t_take, t_dev)
            reqtrace.add_span(r.rid, "dispatch", t_dev, t_dev + dev_dt,
                              rows=rows, requests=len(live),
                              bucket=bucket)
