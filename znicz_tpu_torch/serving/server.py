"""HTTP front end over one engine and its micro-batcher.

Counterpart of the single-engine mode of
``znicz_tpu/serving/server.py`` (``ServingServer`` :202, ``main``
:1050), built on :mod:`znicz_tpu_torch.core.status_server`.  Every
request thread submits to the batcher and blocks on its future, so
concurrent clients coalesce into shared dispatches.

Endpoints:

* ``POST /predict`` — a JSON body ``{"inputs": [[...], ...],
  "timeout_ms": optional}`` (or a bare JSON array), or a raw ``.npy``
  payload (``Content-Type: application/octet-stream``).  Replies in
  kind: JSON ``{"outputs": ..., "argmax": ..., "model_version": ...,
  "request_id": ...}`` or raw ``.npy`` bytes.  Status codes: 400
  malformed, 413 body over ``root.common.serving.max_body_bytes``
  (refused before reading), 429 queue full, 503 warming up or
  draining, 504 deadline expired.  Every reply echoes the request id
  in ``X-Request-Id``.
* ``GET /healthz`` — 200 once warmup finished, 503 before (and while
  draining), with the engine's stats.
* ``GET /metrics`` — Prometheus text of the telemetry registry.

CLI::

    python -m znicz_tpu_torch serve model.zip --port 8899
    python -m znicz_tpu_torch serve model.zip --device cpu --max-batch 8
"""

import argparse
import io
import json
import uuid

import numpy

from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.status_server import (BodyTooLargeError,
                                                HandlerBase,
                                                HttpServerBase)
from znicz_tpu_torch.serving.batcher import (BatcherStoppedError,
                                             MicroBatcher, QueueFullError,
                                             RequestTimeoutError)
from znicz_tpu_torch.serving.engine import InferenceEngine


def _parse_predict(handler):
    """``(inputs, timeout_ms, raw_reply)`` from the request body."""
    body = handler._read_body()
    ctype = (handler.headers.get("Content-Type") or "").split(";")[0]
    if ctype == "application/octet-stream" or body[:6] == b"\x93NUMPY":
        return numpy.load(io.BytesIO(body), allow_pickle=False), None, True
    doc = json.loads(body.decode() or "null")
    if isinstance(doc, dict):
        inputs, timeout_ms = doc.get("inputs"), doc.get("timeout_ms")
    else:
        inputs, timeout_ms = doc, None
    if inputs is None:
        raise ValueError('body needs {"inputs": [[...], ...]} (or a raw '
                         '.npy payload)')
    return inputs, timeout_ms, False


class ServingServer(HttpServerBase):
    """HTTP front end over ``engine`` and a micro-batcher.  When
    ``batcher`` is None one is created with the ``root.common.serving``
    defaults and owned: ``stop()`` stops it too."""

    def __init__(self, engine, batcher=None, port=0, host=None):
        super().__init__(
            port=port,
            host=host or root.common.serving.get("host", "127.0.0.1"),
            logger_name="ServingServer")
        self.engine = engine
        self._owns_batcher = batcher is None
        self.batcher = batcher if batcher is not None else \
            MicroBatcher(engine).start()
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

    def healthz(self):
        stats = dict(self.engine.stats())
        if self._draining:
            stats.update(ready=False, draining=True)
        return (200 if stats["ready"] else 503), stats

    def _predict(self, handler):
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
            inputs, timeout_ms, raw = _parse_predict(handler)
        except BodyTooLargeError as e:
            return fail(413, str(e))
        except Exception as e:  # noqa: BLE001 - a parse error is a 400
            return fail(400, repr(e))
        if not self.engine.ready:
            return fail(503, "model warming up")
        try:
            x = numpy.asarray(inputs, dtype=self.engine.dtype)
            y = self.batcher.predict(x, timeout_ms=timeout_ms)
        except QueueFullError as e:
            return fail(429, str(e))
        except RequestTimeoutError as e:
            return fail(504, str(e))
        except BatcherStoppedError:
            return fail(503, "server draining", **{"Retry-After": "1"})
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
                       "model_version": self.engine.version,
                       "request_id": rid}
            if y.ndim == 2:
                payload["argmax"] = [int(i) for i in y.argmax(axis=1)]
            handler._send_json(200, payload, headers=echo)
        return 200

    def make_handler(self):
        server = self

        class Handler(HandlerBase):
            owner = server

            def do_GET(self):
                path = self.path.partition("?")[0]
                if path == "/healthz":
                    code, payload = server.healthz()
                    self._send_json(code, payload)
                elif path == "/metrics":
                    self._send_metrics()
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                if self.path.partition("?")[0] == "/predict":
                    server._predict(self)
                else:
                    self._drain_body()  # keep-alive hygiene
                    self._send_json(404, {"error": "not found"})

        return Handler


def main(argv=None):
    """The ``python -m znicz_tpu_torch serve`` entry point."""
    cfg = root.common.serving
    parser = argparse.ArgumentParser(
        prog="python -m znicz_tpu_torch serve",
        description="Serve a deployment package zip over HTTP with "
                    "dynamic micro-batching, on the GPU unless "
                    "--device cpu.")
    parser.add_argument("model", help="package .zip path")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("--max-batch", type=int, default=None)
    parser.add_argument("--max-delay-ms", type=float, default=None)
    parser.add_argument("--queue-limit", type=int, default=None)
    parser.add_argument("--timeout-ms", type=float, default=None)
    parser.add_argument("--max-body-bytes", type=int, default=None)
    parser.add_argument("--sample-shape", default=None,
                        help="per-sample input shape, e.g. '28,28,1', for "
                             "packages that record none")
    parser.add_argument("--no-warmup", action="store_true",
                        help="serve at once; the first request of each "
                             "bucket pays its warmup")
    args = parser.parse_args(argv)
    if args.max_body_bytes is not None:
        cfg.max_body_bytes = args.max_body_bytes
    telemetry.enable()  # /metrics works out of the box
    sample_shape = (tuple(int(d) for d in args.sample_shape.split(","))
                    if args.sample_shape else None)
    engine = InferenceEngine(args.model, max_batch=args.max_batch,
                             sample_shape=sample_shape,
                             warmup=not args.no_warmup, device=args.device)
    batcher = MicroBatcher(engine, max_delay_ms=args.max_delay_ms,
                           queue_limit=args.queue_limit,
                           timeout_ms=args.timeout_ms).start()
    server = ServingServer(engine, batcher,
                           port=(args.port if args.port is not None
                                 else cfg.get("port", 8899)),
                           host=args.host).start()
    print("serving %s on http://%s:%d/  (predict: POST /predict; health: "
          "GET /healthz; metrics: GET /metrics)"
          % (args.model, server.host, server.port), flush=True)
    # graceful drain on SIGTERM: flush in-flight requests, exit 0
    import signal
    import threading
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
        batcher.stop()
    return 0
