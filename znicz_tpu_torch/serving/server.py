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
* ``GET /debug/faults`` and ``GET /debug/health`` — the fault
  registry's and the health monitor's status.

CLI::

    python -m znicz_tpu_torch serve PKG.zip --port 8899 [--dtype bf16]
    python -m znicz_tpu_torch serve --latest cifar_caffe --directory DIR
    python -m znicz_tpu_torch serve alexnet=PKG.zip@int8 cifar=SNAP@bf16 \\
        --memory-budget-bytes N --max-inflight 2

The fleet, wire, SLO, release, autoscaler and tracing options of the
JAX package's server are not in the port (``ROADMAP.md``).
"""

import argparse
import io
import json
import math
import signal
import threading
import uuid

import numpy

from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import apply_override, root
from znicz_tpu_torch.core.status_server import (BodyTooLargeError,
                                                HandlerBase,
                                                HttpServerBase)
from znicz_tpu_torch.serving import quant
from znicz_tpu_torch.serving.batcher import (BatcherStoppedError,
                                             MicroBatcher, QueueFullError,
                                             RequestTimeoutError)
from znicz_tpu_torch.serving.breaker import CircuitOpenError
from znicz_tpu_torch.serving.continuous import (ContinuousBatcher,
                                                normalize_priority)
from znicz_tpu_torch.serving.engine import InferenceEngine
from znicz_tpu_torch.serving.registry import ModelRegistry, UnknownModelError


def _parse_predict(handler):
    """``(inputs, timeout_ms, raw_reply, model, priority)`` from the
    request; an unknown priority raises here (400)."""
    body = handler._read_body()
    ctype = (handler.headers.get("Content-Type") or "").split(";")[0]
    priority = (handler.headers.get("X-Priority") or "").strip() or None
    if ctype == "application/octet-stream" or body[:6] == b"\x93NUMPY":
        return (numpy.load(io.BytesIO(body), allow_pickle=False), None,
                True, None, normalize_priority(priority))
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

    def stop(self):
        super().stop()
        if self._owns_batcher:
            self.batcher.stop()

    def drain(self):
        """Graceful shutdown: refuse new work, flush what is queued,
        stop the HTTP server.  Idempotent."""
        self._draining = True
        self.info("draining: flushing %d queued rows",
                  self.batcher.queued_rows)
        self.stop()

    def _engine_for(self, model=None):
        """The engine serving ``model``: the registry's (raises
        :class:`UnknownModelError`, a 404), or the one engine."""
        if self.registry is not None:
            return self.registry.engine(model)
        if model is not None:
            raise UnknownModelError(model, ())
        return self.engine

    def healthz(self):
        """``(status code, payload)`` of /healthz."""
        if self.registry is None:
            stats = dict(self.engine.stats())
            if self._draining:
                stats.update(ready=False, draining=True)
            return (200 if stats["ready"] else 503), stats
        readiness = self.registry.readiness()
        any_ready = any(readiness.values())
        all_ready = bool(readiness) and all(readiness.values())
        payload = {"ready": all_ready and not self._draining,
                   "degraded": any_ready and not all_ready,
                   "models": readiness, "default": self.registry.default,
                   "memory": self.registry.memory_stats()}
        if self._draining:
            payload["draining"] = True
            return 503, payload
        return (200 if any_ready else 503), payload

    def models(self):
        """The /models payload."""
        if self.registry is not None:
            return self.registry.stats()
        return {"models": {"default": self.engine.stats()},
                "default": "default"}

    def _predict(self, handler, model=None):
        """The /predict state machine; returns the status code sent."""
        rid = (handler.headers.get("X-Request-Id") or "").strip()[:64] or \
            uuid.uuid4().hex[:12]
        echo = {"X-Request-Id": rid}

        def fail(code, error, **extra):
            handler._send_json(code, dict(error=error, request_id=rid),
                               headers=dict(echo, **extra))
            return code

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
        try:
            engine = self._engine_for(model)
        except UnknownModelError as e:
            return fail(404, str(e))
        if not engine.ready:
            return fail(503, "model warming up")
        try:
            x = numpy.asarray(inputs, dtype=engine.dtype)
            if self.registry is not None:
                y = self.batcher.predict(x, model=model,
                                         timeout_ms=timeout_ms,
                                         priority=priority)
            else:
                y = self.batcher.predict(x, timeout_ms=timeout_ms)
        except UnknownModelError as e:  # removed while queued
            return fail(404, str(e))
        except QueueFullError as e:
            return fail(429, str(e))
        except RequestTimeoutError as e:
            return fail(504, str(e))
        except BatcherStoppedError:
            return fail(503, "server draining", **{"Retry-After": "1"})
        except CircuitOpenError as e:
            return fail(503, str(e), **{
                "Retry-After": str(max(1, int(math.ceil(e.retry_after))))})
        except (ValueError, TypeError) as e:
            # shape/dtype mismatches are the client's fault
            return fail(400, str(e))
        except Exception as e:  # noqa: BLE001 - always answer HTTP
            self.warning("predict %s failed: %r", rid, e)
            return fail(500, repr(e))
        if raw:
            buf = io.BytesIO()
            numpy.save(buf, numpy.ascontiguousarray(y))
            handler._send(200, "application/octet-stream", buf.getvalue(),
                          headers=echo)
        else:
            payload = {"outputs": y.tolist(),
                       "model_version": engine.version,
                       "request_id": rid}
            if model is not None:
                payload["model"] = model
            if y.ndim == 2:
                payload["argmax"] = [int(i) for i in y.argmax(axis=1)]
            handler._send_json(200, payload, headers=echo)
        return 200

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
            if self.registry is not None:
                version = self.registry.reload(model, path)
                engine = self.registry.peek(model)
            else:
                engine = self._engine_for(model)
                version = engine.load(path)
        except UnknownModelError as e:
            return handler._send_json(404, {"error": str(e)})
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
        handler._send_json(200, {"removed": name,
                                 "models": self.registry.names()})

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
                elif path == "/metrics":
                    self._send_metrics()
                elif not self._send_debug(path):
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
                else:
                    self._drain_body()  # keep-alive hygiene
                    self._send_json(404, {"error": "not found"})

            def do_DELETE(self):
                path = self.path.partition("?")[0]
                self._drain_body()
                if path.startswith("/models/"):
                    server._admin_remove(self, path[len("/models/"):])
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
                    "continuous batcher, at /predict/<name>.")
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
                             "breaker_threshold=0")
    return parser


def serve(argv):
    """Build and start what ``python -m znicz_tpu_torch serve ARGV``
    serves: returns ``(server, label)``, the server started and owning
    its batcher."""
    parser = _parser()
    args = parser.parse_args(argv)
    for assignment in args.config:
        apply_override(assignment)
    cfg = root.common.serving
    if args.max_body_bytes is not None:
        cfg.max_body_bytes = args.max_body_bytes
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


def main(argv=None):
    """The ``python -m znicz_tpu_torch serve`` entry point: serves until
    SIGTERM, then drains (in-flight requests are answered) and returns
    0."""
    server, label = serve(argv)
    print("serving %s on http://%s:%d/  (predict: POST /predict[/<model>]; "
          "health: GET /healthz; metrics: GET /metrics)"
          % (label, server.host, server.port), flush=True)
    term = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda signum, frame: term.set())
    except ValueError:  # not the main thread (embedding)
        pass
    try:
        while not term.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        server.drain()
    return 0
