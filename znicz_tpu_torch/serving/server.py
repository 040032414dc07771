"""HTTP front end: one engine behind a micro-batcher, or a model
registry behind a continuous batcher.

Counterpart of ``znicz_tpu/serving/server.py`` (``ServingServer`` :202,
``_reload`` :695, ``_admin_add`` :734, ``_admin_remove`` :827, ``main``
:1050-1215), built on :mod:`znicz_tpu_torch.core.status_server`.  Every
request thread submits to the batcher and blocks on its future, so
concurrent clients coalesce into shared dispatches.

Endpoints:

* ``POST /predict`` and ``POST /predict/<model>`` — a JSON body
  ``{"inputs": [[...], ...], "timeout_ms": ..., "model": ...,
  "priority": ...}`` (or a bare JSON array), or a raw ``.npy`` payload
  (``Content-Type: application/octet-stream``); the ``X-Priority``
  header wins over the body's priority.  Replies in kind: JSON
  ``{"outputs", "argmax", "model_version", "request_id"}`` or raw
  ``.npy`` bytes.  Status codes: 400 malformed, 404 unknown model, 413
  body over ``root.common.serving.max_body_bytes`` (refused before
  reading), 429 queue full, 503 warming up, draining or an open
  circuit breaker (with ``Retry-After``), 504 deadline expired.  Every
  reply echoes the request id in ``X-Request-Id``.
* ``POST /reload`` — ``{"path": ..., "model": optional}``: a hot
  reload; a reload that fails answers 400 and the old generation goes
  on serving.
* ``GET /models``, ``POST /models/<name>`` (``{"path": ...}``: add, or
  reload an existing name) and ``DELETE /models/<name>`` — the
  registry's membership.
* ``GET /healthz`` and ``GET /healthz/<model>`` — 200 once ready, 503
  before and while draining.  A registry answers 200 while any model
  is ready, with ``degraded`` and the per-model map.
* ``GET /metrics`` — Prometheus text of the telemetry registry.
* ``GET /statusz`` (and ``/``) — the serving stats: the engine's or the
  registry's, the queued rows, the wire port, the ``slo`` block (when
  the SLO plane is on), the device and the ``kernels`` block (the
  max-pool kernels' launch counters and the libraries this process
  built).
* ``GET /slo`` — the SLO plane (:mod:`znicz_tpu_torch.serving.slo`,
  ``root.common.serving.slo_enabled``): per-model good/total from
  request admission, the burn rates of both windows, the error budget
  remaining.
* ``GET /admitted/<rid>`` — the continuous batcher's admitted-rid
  oracle, the fleet router's retry-safety check.
* ``POST /release/<model>`` (``{"path": ..., "policy": {...}}``), ``GET
  /release[/<model>]`` and ``DELETE /release/<model>`` — the release
  plane of a registry server (:mod:`znicz_tpu_torch.serving.release`,
  JAX :771-826): the candidate deploys as ``<model>.gen<N>``, shadow
  mirrors live requests to it after their reply was written (with the
  bucket their batch ran at), the canary split rewrites a rid's model
  to the candidate (falling back to the live one where the candidate is
  gone), promote reloads the live model.  While a release is active,
  ``/reload`` and the ``/models/<name>`` mutations of its model and
  candidate answer 409.  Every 200 names the generation that answered
  (``X-Serving-Generation``, ``gen_<N>``) and, from a registry, the
  bucket its batch ran at (``X-Serving-Bucket``, the frame's
  ``bucket``); an HTTP request's ``X-Serving-Bucket`` pins the smallest
  bucket it is padded to.
* ``GET /debug/faults`` and ``GET /debug/health`` — the fault
  registry's and the health monitor's status; ``GET /debug/profile``,
  ``/debug/profiler``, ``/debug/timeseries``, ``/debug/pyprof``,
  ``/debug/trace[/<rid>]`` and ``/debug/blackbox`` — the observability
  plane's views (:mod:`znicz_tpu_torch.core.status_server`).

**The binary relay** (:mod:`znicz_tpu_torch.serving.wire`, JAX
:255-316): with ``root.common.serving.wire.enabled`` (the default) the
server arms a frame listener before its HTTP surface opens and
advertises its port as ``wire_port`` in ``/healthz``.  A REQUEST frame
runs the same /predict state machine as HTTP (the SLO accounting, the
lanes, the admitted ring, the breaker, the drain, the trace), its
``.npy`` body parsed in place; ``reply="json"`` asks for the JSON 200
(a router relaying a JSON client's request).  Every 200 carries
``X-Serving-Ms`` (admission to reply, in ms), which the router
subtracts from its own wall time.  A router's ``X-Trace-Sampled`` (or
the frame's ``sampled``) decides whether this replica traces the rid.

``serve`` names the process's main thread ``znicz:serve-main`` for the
Python sampler and arms the durable blackbox (role "serve") before the
engines build, where its knob is on (JAX :1136-1141).

CLI::

    python -m znicz_tpu_torch serve PKG.zip --port 8899 [--dtype bf16]
    python -m znicz_tpu_torch serve --latest cifar_caffe --directory DIR
    python -m znicz_tpu_torch serve alexnet=PKG.zip@int8 cifar=SNAP@bf16 \\
        --memory-budget-bytes N --max-inflight 2
    python -m znicz_tpu_torch serve alexnet=PKG.zip --fleet 2 --port 0

``--fleet N`` (JAX :981-1048) serves N replica processes behind a
:class:`~znicz_tpu_torch.serving.router.FleetRouter`: each replica runs
this command's arguments without ``--fleet``, ``--port`` and
``--host`` (``--device`` and ``--config`` pass through), the banner
reads ``fleet of N replicas behind http://HOST:PORT/``, an armed
blackbox is shared (roles "router" and "replica"), and SIGTERM drains
the fleet.  A replica whose router is gone, even SIGKILLed, drains and
exits within a second (the router's pid rides in its environment).
``--autoscale`` arms the fleet's
:class:`~znicz_tpu_torch.serving.autoscaler.Autoscaler` (JAX :959,
:1017; the banner says "autoscaler armed"; without ``--fleet`` the
parser refuses it).  ``--compile-cache`` is not in this slice of the
port (``ROADMAP.md``): the parser refuses it; the replicas' kernel
libraries are built once, under ``build/znicz_tpu_torch/``, and every
later replica finds them (the port's counterpart of the JAX fleet's
shared compile cache).
"""

import argparse
import io
import json
import math
import os
import signal
import threading
import time
import uuid

import numpy

from znicz_tpu_torch.core import blackbox, pyprof, telemetry
from znicz_tpu_torch.core.config import apply_override, root
from znicz_tpu_torch.core.status_server import (BodyTooLargeError,
                                                HandlerBase,
                                                HttpServerBase)
from znicz_tpu_torch.serving import quant, reqtrace, slo, wire
from znicz_tpu_torch.serving.batcher import (BatcherStoppedError,
                                             MicroBatcher, QueueFullError,
                                             RequestTimeoutError)
from znicz_tpu_torch.serving.breaker import CircuitOpenError
from znicz_tpu_torch.serving.continuous import (ContinuousBatcher,
                                                normalize_priority)
from znicz_tpu_torch.serving.engine import InferenceEngine
from znicz_tpu_torch.serving.registry import ModelRegistry, UnknownModelError
from znicz_tpu_torch.serving.release import (LocalTarget,
                                             ReleaseConflictError,
                                             ReleaseController,
                                             generation_label)

#: the wording of an option that a later slice of the port brings
_LATER = "is not in this slice of the port (see ROADMAP.md)"


def _parse_predict(handler):
    """``(inputs, timeout_ms, raw_reply, model, priority)`` from the
    request; an unknown priority raises here (400).  A wire exchange's
    body was parsed on the listener; an ``.npy`` HTTP body is parsed in
    place over the body's bytes (``wire.parse_npy``), no copy."""
    arr = getattr(handler, "wire_inputs", None)
    if arr is not None:
        meta = handler.meta
        model = meta.get("model")
        if model is not None and not isinstance(model, str):
            raise ValueError('"model" must be a string')
        return (arr, meta.get("timeout_ms"), meta.get("reply") != "json",
                model, normalize_priority(meta.get("priority")))
    body = handler._read_body()
    ctype = (handler.headers.get("Content-Type") or "").split(";")[0]
    priority = (handler.headers.get("X-Priority") or "").strip() or None
    if ctype == "application/octet-stream" or body[:6] == b"\x93NUMPY":
        return (wire.parse_npy(body), None, True, None,
                normalize_priority(priority))
    doc = json.loads(body.decode() or "null")
    if isinstance(doc, dict):
        inputs, timeout_ms, model = (doc.get("inputs"),
                                     doc.get("timeout_ms"), doc.get("model"))
        priority = priority or doc.get("priority")
    else:
        inputs, timeout_ms, model = doc, None, None
    if inputs is None:
        raise ValueError('body needs {"inputs": [[...], ...]} (or a raw '
                         '.npy payload)')
    if model is not None and not isinstance(model, str):
        raise ValueError('"model" must be a string')
    return inputs, timeout_ms, False, model, normalize_priority(priority)


def _read_path(handler):
    """The ``{"path": ...}`` document of an admin request."""
    doc = json.loads(handler._read_body().decode() or "{}")
    if not isinstance(doc, dict) or "path" not in doc:
        raise ValueError('body needs {"path": "..."}')
    return doc


def kernels_block():
    """The ``kernels`` block of ``/statusz``: the max-pool kernels'
    launch counters in this process, its plain max pools on the card
    (0 on the main path), the libraries it built — a fleet replica
    started after the first builds none (the port's counterpart of the
    JAX block ``compile_cache``) — and the engine dispatches of the
    process (a removed candidate's among them)."""
    from znicz_tpu_torch.ops import (cuda_build, cuda_pooling,
                                     cuda_pooling_backward, pooling)
    from znicz_tpu_torch.serving import engine
    return {
        "engine_dispatches": engine.DISPATCHES,
        "max_pooling_offsets": {
            "launches": cuda_pooling.LAUNCHES,
            "wide": cuda_pooling.LAUNCHES_WIDE,
            "narrow": cuda_pooling.LAUNCHES_NARROW},
        "max_pooling_offsets_backward": {
            "launches": cuda_pooling_backward.LAUNCHES},
        "plain_cuda_calls": pooling.PLAIN_CUDA_CALLS,
        "libraries_built": cuda_build.BUILT,
    }


class _WireExchange(object):
    """One REQUEST frame presented as the handler surface
    :meth:`ServingServer._predict` speaks (JAX :123-199): the array
    parsed in place rides in ``wire_inputs``, ``t_recv`` dates admission
    at the frame's completion on the listener loop, ``pre_spans`` holds
    the ``frame_decode`` span.  A 200 answers a RESPONSE frame, anything
    else a typed ERROR frame; ``t_sent`` is stamped just before the
    write, so the trace closes no later than the router's read."""

    __slots__ = ("request", "meta", "wire_inputs", "t_recv", "pre_spans",
                 "headers", "status", "t_sent")

    def __init__(self, request, arr, decode_span):
        meta = request.meta
        self.request = request
        self.meta = meta
        self.wire_inputs = arr
        self.t_recv = request.t_recv
        self.pre_spans = (("frame_decode",) + decode_span,)
        self.status = None
        self.t_sent = None
        headers = {"Content-Type": "application/octet-stream"}
        for key, header in (("rid", "X-Request-Id"),
                            ("priority", "X-Priority"),
                            ("sampled", "X-Trace-Sampled")):
            if meta.get(key) is not None:
                headers[header] = str(meta[key])
        self.headers = headers

    def _read_body(self):
        return b""

    def _drain_body(self):
        pass

    def _send_json(self, code, obj, headers=None):
        headers = headers or {}
        self.status = int(code)
        if int(code) == 200:
            # a JSON 200 (reply="json"): the serializer of the HTTP
            # surface, so both codecs answer the same bytes
            self._reply_frame(code, "application/json",
                              json.dumps(obj).encode(), headers)
            return
        self.t_sent = time.monotonic()
        self.request.reply(wire.error_frame(
            code, obj, rid=headers.get("X-Request-Id"),
            retry_after=headers.get("Retry-After")))

    def _send(self, code, ctype, body, headers=None):
        self.status = int(code)
        self._reply_frame(code, ctype, body, headers or {})

    def _reply_frame(self, code, ctype, body, headers):
        meta = {"status": int(code), "ctype": ctype}
        for header, key in (("X-Request-Id", "rid"),
                            ("X-Serving-Ms", "serving_ms"),
                            ("X-Serving-Generation", "generation"),
                            ("X-Serving-Bucket", "bucket")):
            if headers.get(header) is not None:
                meta[key] = headers[header]
        self.t_sent = time.monotonic()
        self.request.reply(wire.pack_frame(wire.KIND_RESPONSE, meta, body))


class ServingServer(HttpServerBase):
    """HTTP front end over ``engine`` and a micro-batcher, or over
    ``registry`` and a continuous batcher (exactly one of the two).
    When ``batcher`` is None one is made with the
    ``root.common.serving`` defaults and owned: ``stop()`` stops it
    too."""

    def __init__(self, engine=None, batcher=None, port=0, host=None,
                 registry=None):
        super().__init__(
            port=port,
            host=host or root.common.serving.get("host", "127.0.0.1"),
            logger_name="ServingServer")
        if (engine is None) == (registry is None):
            raise ValueError("pass exactly one of engine= (one model) or "
                             "registry= (several)")
        self.engine = engine
        self.registry = registry
        self._owns_batcher = batcher is None
        if batcher is None:
            batcher = (ContinuousBatcher(registry) if registry is not None
                       else MicroBatcher(engine)).start()
        self.batcher = batcher
        #: graceful-drain latch: /predict answers 503, /healthz not-ready
        self._draining = False
        self._drained = False
        #: /predict requests between admission and their reply's write;
        #: the drain waits for them before the process may exit
        self._active = 0
        self._active_cv = threading.Condition()
        #: the SLO plane, fed by _predict behind slo.enabled()
        self.slo = slo.SloTracker()
        #: the release plane over the registry (its threads start at
        #: the first POST /release/<model>)
        self.release = (ReleaseController(LocalTarget(registry, self.slo))
                        if registry is not None else None)
        #: the binary relay's listener (start() arms it)
        self._wire = None

    def start(self):
        # the listener arms BEFORE the HTTP surface: the first /healthz
        # a router reads must already carry wire_port
        if root.common.serving.get("wire", {}).get("enabled", True):
            self._wire = wire.WireListener(self._wire_group, host=self.host,
                                           name="replica").start()
        return super().start()

    @property
    def wire_port(self):
        return self._wire.port if self._wire is not None else None

    def _wire_group(self, group):
        """The listener's handler: a group's ``.npy`` bodies are parsed
        in one sweep, then each request runs the /predict state machine;
        the first on this worker, the rest on the listener's pool."""
        exchanges = []
        for req in group:
            t0 = time.monotonic()
            try:
                arr = wire.parse_npy(req.body)
            except ValueError as e:
                req.reply(wire.error_frame(
                    400, {"error": repr(e),
                          "request_id": req.meta.get("rid")},
                    rid=req.meta.get("rid")))
                continue
            exchanges.append(_WireExchange(req, arr, (t0, time.monotonic())))
        for ex in exchanges[1:]:
            self._wire.submit(self._wire_one, ex)
        if exchanges:
            self._wire_one(exchanges[0])

    def _wire_one(self, ex):
        try:
            self._predict(ex, model=ex.meta.get("model"))
        except Exception as e:  # noqa: BLE001 - always answer a frame
            self.warning("wire predict %s failed: %r", ex.meta.get("rid"), e)
            if ex.status is None:
                ex.request.reply(wire.error_frame(
                    500, {"error": repr(e),
                          "request_id": ex.meta.get("rid")},
                    rid=ex.meta.get("rid")))

    def stop(self):
        if self._wire is not None:
            self._wire.stop()
            self._wire = None
        super().stop()
        if self.release is not None:
            self.release.stop()
        if self._owns_batcher:
            self.batcher.stop()

    def drain(self, timeout_s=30.0):
        """Graceful shutdown: refuse new work, serve what the batcher
        holds, wait (at most ``timeout_s``) until every admitted request
        has written its reply, then stop.  Idempotent."""
        if self._drained:
            return
        self._drained = True
        self._draining = True
        telemetry.record_event("serving.drain")
        self.info("draining: flushing %d queued rows",
                  self.batcher.queued_rows)
        if self._owns_batcher:
            self.batcher.stop(flush=True)
        with self._active_cv:
            self._active_cv.wait_for(lambda: self._active == 0,
                                     timeout=timeout_s)
        self.stop()

    def _engine_for(self, model=None):
        """The engine serving ``model``: the registry's (raises
        :class:`UnknownModelError`, a 404), or the one engine."""
        if self.registry is not None:
            return self.registry.engine(model)
        if model is not None:
            raise UnknownModelError(model, ())
        return self.engine

    def _engines(self):
        if self.registry is None:
            return [self.engine]
        return [self.registry.peek(n) for n in self.registry.names()]

    def device(self):
        """The device the engines serve on, with the card's name."""
        engines = self._engines()
        dev = engines[0].device if engines else None
        out = {"device": str(dev.type) if dev is not None else None}
        if dev is not None and dev.type == "cuda":
            import torch
            out["device_name"] = torch.cuda.get_device_name(dev)
            out["memory_allocated"] = torch.cuda.memory_allocated(dev)
        return out

    def healthz(self):
        """``(status code, payload)`` of /healthz."""
        if self.registry is None:
            stats = dict(self.engine.stats(), wire_port=self.wire_port)
            if self._draining:
                stats.update(ready=False, draining=True)
            return (200 if stats["ready"] else 503), stats
        readiness = self.registry.readiness()
        any_ready = any(readiness.values())
        all_ready = bool(readiness) and all(readiness.values())
        payload = {"ready": all_ready and not self._draining,
                   "degraded": any_ready and not all_ready,
                   "models": readiness, "default": self.registry.default,
                   "memory": self.registry.memory_stats(),
                   "wire_port": self.wire_port}
        if self._draining:
            payload["draining"] = True
            return 503, payload
        return (200 if any_ready else 503), payload

    def statusz(self):
        """The /statusz payload."""
        if self.registry is not None:
            payload = {"registry": self.registry.stats(),
                       "ready": self.registry.ready}
        else:
            payload = dict(self.engine.stats())
        payload.update(self.device())
        payload["queued_rows"] = self.batcher.queued_rows
        payload["kernels"] = kernels_block()
        if self._wire is not None:
            payload["wire"] = {"port": self._wire.port}
        if slo.enabled():
            payload["slo"] = self.slo.status()
        if self.release is not None:
            payload["release"] = self.release.status()
        return payload

    def models(self):
        """The /models payload."""
        if self.registry is not None:
            return self.registry.stats()
        return {"models": {"default": self.engine.stats()},
                "default": "default"}

    def admitted(self, rid):
        """The /admitted/<rid> payload: ``tracked`` False where the
        batcher keeps no ring (the micro-batcher of one engine)."""
        probe = getattr(self.batcher, "admitted_status", None)
        payload = {"rid": rid, "tracked": probe is not None}
        if probe is not None:
            payload.update(probe(rid))
        else:
            payload["admitted"] = False
        return payload

    def _predict(self, handler, model=None):
        """One /predict: opens the sampled trace tree, runs the state
        machine, closes the tree and feeds the SLO tracker with the
        status sent, measured from admission (JAX :468-518)."""
        rid = (handler.headers.get("X-Request-Id") or "").strip()[:64] or \
            uuid.uuid4().hex[:12]
        t_admit = getattr(handler, "t_recv", None) or time.monotonic()
        if telemetry.enabled():
            telemetry.counter(telemetry.labeled(
                "serving.codec_requests",
                codec=("binary" if getattr(handler, "wire_inputs", None)
                       is not None else "http"))).inc()
        sampled = (handler.headers.get("X-Trace-Sampled") or "").strip()
        if sampled == "0":
            traced = False   # the router did not sample this rid
        else:
            # "1": a router upstream sampled it — trace it without
            # moving this replica's own cursor
            traced = reqtrace.enabled() and reqtrace.begin(
                rid, now=t_admit, force=sampled == "1")
        if traced:
            for kind, t0, t1 in getattr(handler, "pre_spans", ()):
                reqtrace.add_span(rid, kind, t0, t1)
        with self._active_cv:
            self._active += 1
        stamps = {}
        try:
            code, slo_model = self._predict_inner(handler, rid, model,
                                                  t_admit, traced, stamps)
        finally:
            with self._active_cv:
                self._active -= 1
                self._active_cv.notify_all()
        if traced:
            reqtrace.finish(rid, model=slo_model,
                            now=stamps.get("t_sent") or
                            getattr(handler, "t_sent", None))
        if slo.enabled():
            self.slo.record(slo_model, code,
                            (time.monotonic() - t_admit) * 1e3, rid=rid)
        return code

    def _predict_inner(self, handler, rid, model, t_admit, traced,
                       stamps):
        """The /predict state machine; returns ``(status code, model
        name)``.  A traced 200 puts the stamp its reply's write ended
        at into ``stamps["t_sent"]``, where the tree closes."""
        echo = {"X-Request-Id": rid}

        def fail(code, error, slo_model=model, **extra):
            handler._send_json(code, dict(error=error, request_id=rid),
                               headers=dict(echo, **extra))
            return code, slo_model

        if self._draining:
            handler._drain_body()
            return fail(503, "server draining", **{"Retry-After": "1"})
        try:
            inputs, timeout_ms, raw, body_model, priority = \
                _parse_predict(handler)
        except BodyTooLargeError as e:
            return fail(413, str(e))
        except Exception as e:  # noqa: BLE001 - a parse error is a 400
            return fail(400, repr(e))
        model = model if model is not None else body_model
        # the canary split: an active release may serve this rid from
        # its candidate, the same generation at every retry of the rid
        routed = model
        ctl = self.release
        if ctl is not None and ctl.active():
            routed = ctl.route(model, rid) or model
        slo_model = routed
        try:
            try:
                engine = self._engine_for(routed)
            except UnknownModelError:
                if routed is model:
                    raise
                # the candidate went between the split and here (a
                # rollback removed it): the live generation answers
                routed = slo_model = model
                engine = self._engine_for(model)
            if slo_model is None and self.registry is not None:
                # budgets are per model: the default carries its name
                slo_model = self.registry.default
        except UnknownModelError as e:
            return fail(404, str(e))
        if not engine.ready:
            return fail(503, "model warming up", slo_model)
        info = {}
        try:
            pin = handler.headers.get("X-Serving-Bucket")
            pin = int(pin) if pin else None
            x = numpy.asarray(inputs, dtype=engine.dtype)
            if traced:
                reqtrace.add_span(rid, "admission", t_admit,
                                  time.monotonic())
            if self.registry is not None:
                y = self.batcher.predict(x, model=routed,
                                         timeout_ms=timeout_ms,
                                         priority=priority, request_id=rid,
                                         bucket=pin, info=info)
            else:
                y = self.batcher.predict(x, timeout_ms=timeout_ms,
                                         request_id=rid)
        except UnknownModelError as e:  # removed while queued
            return fail(404, str(e), slo_model)
        except QueueFullError as e:
            return fail(429, str(e), slo_model)
        except RequestTimeoutError as e:
            return fail(504, str(e), slo_model)
        except BatcherStoppedError:
            return fail(503, "server draining", slo_model,
                        **{"Retry-After": "1"})
        except CircuitOpenError as e:
            return fail(503, str(e), slo_model, **{
                "Retry-After": str(max(1, int(math.ceil(e.retry_after))))})
        except (ValueError, TypeError) as e:
            # shape/dtype mismatches are the client's fault
            return fail(400, str(e), slo_model)
        except Exception as e:  # noqa: BLE001 - always answer HTTP
            self.warning("predict %s failed: %r", rid, e)
            return fail(500, repr(e), slo_model)
        t_reply = time.monotonic()
        ok = dict(echo, **{
            "X-Serving-Ms": "%.3f" % ((t_reply - t_admit) * 1e3),
            # a candidate answers under its encoded generation
            "X-Serving-Generation": generation_label(slo_model or "",
                                                     engine.version)})
        if info.get("bucket"):
            ok["X-Serving-Bucket"] = str(info["bucket"])
        if raw:
            buf = io.BytesIO()
            numpy.save(buf, numpy.ascontiguousarray(y))
            handler._send(200, "application/octet-stream", buf.getvalue(),
                          headers=ok)
        else:
            payload = {"outputs": y.tolist(),
                       "model_version": engine.version,
                       "request_id": rid}
            if model is not None:
                payload["model"] = model
            if y.ndim == 2:
                payload["argmax"] = [int(i) for i in y.argmax(axis=1)]
            handler._send_json(200, payload, headers=ok)
        if traced:
            # the reply starts where the dispatch ended (the handler
            # thread's wake-up is the reply's time, not a gap) and ends
            # where the tree closes
            dispatched = reqtrace.span_end(rid, "dispatch")
            stamps["t_sent"] = getattr(handler, "t_sent", None) or \
                time.monotonic()
            reqtrace.add_span(rid, "reply", t_reply if dispatched is None
                              else dispatched, stamps["t_sent"])
        if ctl is not None and routed is model and \
                ctl.wants_mirror(slo_model, rid):
            # the shadow mirror: the client has its reply; the compare
            # runs on the controller's worker, at this batch's bucket
            # (a frame's array is copied: its buffer is the listener's)
            ctl.mirror(slo_model, rid, numpy.array(x), y,
                       bucket=info.get("bucket"))
        return 200, slo_model

    def _reload(self, handler, model=None):
        try:
            doc = _read_path(handler)
            model = model if model is not None else doc.get("model")
        except BodyTooLargeError as e:
            return handler._send_json(413, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - a client error
            return handler._send_json(400, {"error": repr(e)})
        path = doc["path"]
        try:
            # "version" pins the generation's number: the fleet router
            # brings a replica joining after a promote to the fleet's
            pin = doc.get("version")
            pin = None if pin is None else int(pin)
            if self.registry is not None:
                version = self.registry.reload(model, path, version=pin)
                engine = self.registry.peek(model)
            else:
                engine = self._engine_for(model)
                version = engine.load(path, version=pin)
        except UnknownModelError as e:
            return handler._send_json(404, {"error": str(e)})
        except ReleaseConflictError as e:
            # mid-release, promote and rollback are the controller's
            return handler._send_json(409, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - a bad model file
            # the failed load rolled back: the old generation serves
            return handler._send_json(400, {"error": repr(e)})
        payload = {"model_version": version, "source": path,
                   "ready": engine.ready}
        if model is not None:
            payload["model"] = model
        handler._send_json(200, payload)

    def _admin_add(self, handler, name):
        """POST /models/<name>: add a model, or reload an existing one;
        it becomes routable once loaded and warm."""
        if self.registry is None:
            handler._drain_body()
            return handler._send_json(400, {
                "error": "this server hosts one engine — serve NAME=PATH "
                         "specs for a registry"})
        try:
            doc = _read_path(handler)
        except BodyTooLargeError as e:
            return handler._send_json(413, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - a client error
            return handler._send_json(400, {"error": repr(e)})
        kwargs = {k: doc[k] for k in ("max_batch", "sample_shape", "dtype")
                  if doc.get(k) is not None}
        try:
            version = self.registry.add(name, doc["path"], **kwargs)
        except ReleaseConflictError as e:
            return handler._send_json(409, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - a bad model file or name
            return handler._send_json(400, {"error": repr(e)})
        handler._send_json(200, {"model": name, "model_version": version,
                                 "source": doc["path"],
                                 "models": self.registry.names()})

    def _admin_remove(self, handler, name):
        if self.registry is None:
            return handler._send_json(400, {
                "error": "this server hosts one engine"})
        try:
            self.registry.remove(name)
        except UnknownModelError as e:
            return handler._send_json(404, {"error": str(e)})
        except ReleaseConflictError as e:
            return handler._send_json(409, {"error": str(e)})
        handler._send_json(200, {"removed": name,
                                 "models": self.registry.names()})

    # -- the release plane (JAX :771-826) ------------------------------------
    def _release_post(self, handler, name):
        """POST /release/<model>: deploy the candidate and enter
        shadow."""
        if self.release is None:
            handler._drain_body()
            return handler._send_json(400, {
                "error": "releases need a model registry — serve "
                         "NAME=PATH model specs"})
        try:
            doc = _read_path(handler)
        except BodyTooLargeError as e:
            return handler._send_json(413, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - a client error
            return handler._send_json(400, {"error": repr(e)})
        try:
            payload = self.release.start().start_release(
                name, doc["path"], policy=doc.get("policy"))
        except ReleaseConflictError as e:
            return handler._send_json(409, {"error": str(e)})
        except UnknownModelError as e:
            return handler._send_json(404, {"error": str(e)})
        except ValueError as e:
            return handler._send_json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - a bad candidate file
            return handler._send_json(400, {"error": repr(e)})
        handler._send_json(200, payload)

    def _release_get(self, handler, name=None):
        if self.release is None:
            return handler._send_json(200, {"active": {}, "recent": {}})
        try:
            handler._send_json(200, self.release.status(name))
        except KeyError as e:
            handler._send_json(404, {"error": str(e)})

    def _release_delete(self, handler, name):
        if self.release is None:
            return handler._send_json(404, {
                "error": "no release plane (one engine)"})
        try:
            handler._send_json(200, self.release.abort(name))
        except KeyError as e:
            handler._send_json(404, {"error": str(e)})

    def make_handler(self):
        server = self

        class Handler(HandlerBase):
            owner = server

            def do_GET(self):
                path = self.path.partition("?")[0]
                if path == "/healthz":
                    self._send_json(*server.healthz())
                elif path.startswith("/healthz/"):
                    name = path[len("/healthz/"):]
                    try:
                        # observation only: a probe never restores
                        engine = (server.registry.peek(name)
                                  if server.registry is not None
                                  else server._engine_for(name))
                    except UnknownModelError as e:
                        return self._send_json(404, {"error": str(e)})
                    ready = engine.ready and not server._draining
                    self._send_json(200 if ready else 503, engine.stats())
                elif path == "/models":
                    self._send_json(200, server.models())
                elif path in ("/", "/statusz"):
                    self._send_json(200, server.statusz())
                elif path == "/slo":
                    self._send_json(200, server.slo.status())
                elif path.startswith("/admitted/"):
                    self._send_json(200, server.admitted(
                        path[len("/admitted/"):]))
                elif path == "/release":
                    server._release_get(self)
                elif path.startswith("/release/"):
                    server._release_get(self, path[len("/release/"):])
                elif path == "/metrics":
                    self._send_metrics()
                elif not self._send_debug(self.path):
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                path = self.path.partition("?")[0]
                if path == "/predict":
                    server._predict(self)
                elif path.startswith("/predict/"):
                    server._predict(self, model=path[len("/predict/"):])
                elif path == "/reload":
                    server._reload(self)
                elif path.startswith("/models/"):
                    server._admin_add(self, path[len("/models/"):])
                elif path.startswith("/release/"):
                    server._release_post(self, path[len("/release/"):])
                else:
                    self._drain_body()  # keep-alive hygiene
                    self._send_json(404, {"error": "not found"})

            def do_DELETE(self):
                path = self.path.partition("?")[0]
                self._drain_body()
                if path.startswith("/models/"):
                    server._admin_remove(self, path[len("/models/"):])
                elif path.startswith("/release/"):
                    server._release_delete(self, path[len("/release/"):])
                else:
                    self._send_json(404, {"error": "not found"})

        return Handler


def _split_dtype(path):
    """``PATH[@DTYPE]``: only a suffix that names a serving dtype
    splits; an ``@`` elsewhere stays part of the path."""
    if "@" in path:
        base, _, suffix = path.rpartition("@")
        try:
            return base, quant.normalize_dtype(suffix)
        except ValueError:
            pass
    return path, None


def _parser():
    parser = argparse.ArgumentParser(
        prog="python -m znicz_tpu_torch serve",
        description="Serve trained models (snapshot pickles or package "
                    "zips) over HTTP, on the GPU unless --device cpu.  "
                    "One PATH serves one engine behind a micro-batcher; "
                    "NAME=PATH[@DTYPE] specs serve a registry behind a "
                    "continuous batcher, at /predict/<name>.  --fleet N "
                    "serves N such processes behind one router.")
    parser.add_argument("model", nargs="+",
                        help="snapshot or .zip path, NAME=PATH[@DTYPE] "
                             "specs, or with --latest a snapshot prefix "
                             "(e.g. 'cifar_caffe')")
    parser.add_argument("--latest", action="store_true",
                        help="serve the newest snapshot named for the "
                             "prefix MODEL")
    parser.add_argument("--directory", default=None,
                        help="the snapshot directory of --latest "
                             "(default: root.common.dirs.snapshots)")
    parser.add_argument("--dtype", default=None,
                        choices=("f32", "f32-fast", "bf16", "int8"),
                        help="serving dtype (default: the source's "
                             "recorded manifest, else f32)")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("--max-batch", type=int, default=None)
    parser.add_argument("--max-delay-ms", type=float, default=None)
    parser.add_argument("--queue-limit", type=int, default=None)
    parser.add_argument("--timeout-ms", type=float, default=None)
    parser.add_argument("--max-inflight", type=int, default=None,
                        help="dispatch slots of a registry's continuous "
                             "batcher")
    parser.add_argument("--memory-budget-bytes", type=int, default=None,
                        help="the registry's LRU device-memory budget "
                             "(0: none)")
    parser.add_argument("--max-body-bytes", type=int, default=None)
    parser.add_argument("--sample-shape", default=None,
                        help="per-sample input shape, e.g. '28,28,1', for "
                             "sources that record none")
    parser.add_argument("--no-warmup", action="store_true",
                        help="serve at once; the first request of each "
                             "bucket pays its warmup")
    parser.add_argument("--config", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="config-root override, e.g. common.serving."
                             "breaker_threshold=0; forwarded to every "
                             "--fleet replica")
    parser.add_argument("--fleet", type=int, default=None, metavar="N",
                        help="serve N replica processes behind the fleet "
                             "router: least-outstanding balancing, "
                             "retry only where a request was provably "
                             "never admitted, aggregated /metrics, /slo, "
                             "/healthz and /models")
    parser.add_argument("--autoscale", action="store_true",
                        help="with --fleet: arm the SLO-burn and "
                             "queue-depth autoscaler (root.common.serving."
                             "fleet.{min,max}_replicas, scale_*, "
                             "cooldown_s)")
    parser.add_argument("--compile-cache", nargs="?", const="",
                        default=None, metavar="DIR",
                        help="the JAX package's compile cache " + _LATER)
    return parser


def _parse(argv):
    parser = _parser()
    args = parser.parse_args(argv)
    if args.autoscale and args.fleet is None:
        parser.error("--autoscale sizes a fleet: it needs --fleet N")
    if args.compile_cache is not None:
        parser.error("--compile-cache " + _LATER)
    if args.fleet is not None and args.fleet < 1:
        parser.error("--fleet needs at least 1 replica")
    for assignment in args.config:
        apply_override(assignment)
    if args.max_body_bytes is not None:
        root.common.serving.max_body_bytes = args.max_body_bytes
    return parser, args


def serve(argv):
    """Build and start what ``python -m znicz_tpu_torch serve ARGV``
    serves (one process, without ``--fleet``): returns ``(server,
    label)``, the server started and owning its batcher."""
    parser, args = _parse(argv)
    if args.fleet is not None:
        parser.error("serve() builds one process; --fleet runs through "
                     "main()")
    return _serve(parser, args)


def _serve(parser, args):
    cfg = root.common.serving
    specs = [m.split("=", 1) if "=" in m else (None, m) for m in args.model]
    named = [s for s in specs if s[0] is not None]
    if named and len(named) != len(specs):
        parser.error("mix of NAME=PATH and bare PATH model specs — use one "
                     "style")
    if named and args.latest:
        parser.error("--latest applies to one model")
    if not named and len(specs) > 1:
        parser.error("several models need NAME=PATH specs")
    sample_shape = (tuple(int(d) for d in args.sample_shape.split(","))
                    if args.sample_shape else None)
    telemetry.enable()  # /metrics works out of the box
    # the sampler's attribution of the thread that blocks in the drain
    # loop, and the blackbox armed before the engines build, so their
    # start-up lands on disk too (one config read when its knob is off)
    pyprof.name_current_thread("serve-main")
    blackbox.maybe_arm("serve")
    if named:
        registry = ModelRegistry(
            memory_budget_bytes=args.memory_budget_bytes,
            max_batch=args.max_batch, sample_shape=sample_shape,
            warmup=not args.no_warmup, device=args.device, dtype=args.dtype)
        for name, path in named:
            path, dtype = _split_dtype(path)
            registry.add(name, path, **({"dtype": dtype} if dtype else {}))
        batcher = ContinuousBatcher(
            registry, max_inflight=args.max_inflight,
            queue_limit=args.queue_limit, timeout_ms=args.timeout_ms)
        engine, label = None, ", ".join(registry.names())
    else:
        model, spec_dtype = _split_dtype(specs[0][1])
        if args.latest:
            from znicz_tpu_torch.launcher import newest_snapshot
            directory = args.directory or root.common.dirs.snapshots
            found = newest_snapshot(directory, model)
            if found is None:
                raise SystemExit("no snapshot with prefix %r under %s"
                                 % (model, directory))
            model = found
        engine = InferenceEngine(model, max_batch=args.max_batch,
                                 sample_shape=sample_shape,
                                 warmup=not args.no_warmup,
                                 device=args.device,
                                 dtype=spec_dtype or args.dtype)
        registry = None
        batcher = MicroBatcher(engine, max_delay_ms=args.max_delay_ms,
                               queue_limit=args.queue_limit,
                               timeout_ms=args.timeout_ms)
        label = str(model)
    server = ServingServer(engine, batcher.start(), registry=registry,
                           port=(args.port if args.port is not None
                                 else cfg.get("port", 8899)),
                           host=args.host)
    server._owns_batcher = True
    return server.start(), label


#: router-only serve flags, dropped from the replicas' argv (flag ->
#: takes a value)
_ROUTER_ONLY_FLAGS = {"--fleet": True, "--port": True, "--host": True,
                      "--autoscale": False}


def replica_argv(raw_argv):
    """The argv every fleet replica runs: the operator's serve
    arguments without the router's own flags (each replica binds port
    0; models, ``--device``, ``--config`` and the batching flags pass
    through)."""
    out, i = [], 0
    while i < len(raw_argv):
        tok = raw_argv[i]
        flag = tok.split("=", 1)[0]
        if flag in _ROUTER_ONLY_FLAGS:
            i += 1
            if _ROUTER_ONLY_FLAGS[flag] and "=" not in tok and \
                    i < len(raw_argv):
                i += 1  # the flag's value
            continue
        out.append(tok)
        i += 1
    return out


def _serve_until_term(server, thread_of, parent=None):
    """Block until SIGTERM (or Ctrl-C, or the HTTP thread's death, or,
    where ``parent`` is a pid, until this process's parent is no longer
    that process), then drain ``server``."""
    term = threading.Event()
    orphaned = False
    try:
        signal.signal(signal.SIGTERM, lambda signum, frame: term.set())
    except ValueError:  # not the main thread (embedding)
        pass
    try:
        while not term.wait(1.0):
            thread = thread_of()
            if thread is None or not thread.is_alive():
                break
            if parent is not None and os.getppid() != parent:
                orphaned = True
                break
    except KeyboardInterrupt:
        pass
    finally:
        try:
            if term.is_set():
                print("SIGTERM: draining", flush=True)  # noqa: T201
            elif orphaned:
                print("the fleet router (pid %d) is gone: draining"  # noqa
                      % parent, flush=True)
        except OSError:
            pass  # the router that read this output is gone
        server.drain()
    return 0


def _fleet_main(args, raw_argv):
    """``serve --fleet N``: N replicas behind the router, until SIGTERM
    drains the fleet (JAX :981-1048)."""
    from znicz_tpu_torch.serving.autoscaler import Autoscaler
    from znicz_tpu_torch.serving.router import FleetRouter
    telemetry.enable()  # the router's own series and journal
    pyprof.name_current_thread("serve-main")
    argv = replica_argv(raw_argv)
    if blackbox.enabled():
        # one blackbox directory for the fleet: the router's role is
        # "router", the replicas get the resolved directory and theirs
        blackbox.maybe_arm("router")
        bb_dir = os.path.abspath(blackbox.configured_dir())
        argv += ["--config", "common.telemetry.blackbox.dir=%s" % bb_dir,
                 "--config", "common.telemetry.blackbox.role=replica"]
    router = FleetRouter(
        argv, replicas=args.fleet,
        port=(args.port if args.port is not None
              else root.common.serving.get("port", 8899)),
        host=args.host).start()
    if args.autoscale:
        router.autoscaler = Autoscaler(router).start()
    print("fleet of %d replica%s behind http://%s:%d/  (predict: POST "  # noqa
          "/predict[/<model>]; fleet health: GET /healthz; aggregated: "
          "GET /metrics, GET /slo%s)"
          % (args.fleet, "" if args.fleet == 1 else "s", router.host,
             router.port, "; autoscaler armed" if args.autoscale else ""),
          flush=True)
    return _serve_until_term(router, lambda: router._thread)


def main(argv=None):
    """The ``python -m znicz_tpu_torch serve`` entry point: serves until
    SIGTERM, then drains (in-flight requests are answered) and returns
    0."""
    import sys
    raw = list(argv) if argv is not None else sys.argv[1:]
    if argv is None and raw and raw[0] == "serve":
        raw = raw[1:]
    parser, args = _parse(raw)
    if args.fleet is not None:
        return _fleet_main(args, raw)
    from znicz_tpu_torch.serving.router import ROUTER_PID_ENV
    # a fleet replica lives no longer than its router
    parent = os.environ.get(ROUTER_PID_ENV)
    server, label = _serve(parser, args)
    print("serving %s on http://%s:%d/  (predict: POST /predict[/<model>]; "
          "health: GET /healthz; metrics: GET /metrics)"
          % (label, server.host, server.port), flush=True)
    return _serve_until_term(server, lambda: server._thread,
                             parent=int(parent) if parent else None)
