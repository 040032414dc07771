"""The debug-capture guard under back-to-back requests.

``/debug/profile`` and ``/debug/pyprof`` share one guard
(``core/status_server.py``).  A capture releases it before its reply is
written, so a client that sends the next capture the moment it has the
previous reply never meets a stale 409.
"""

import json
import urllib.request

from test_torch_workflow import _restored
from znicz_tpu_torch.core import pyprof, status_server
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.status_server import StatusServer


def test_back_to_back_pyprof_captures_all_answer_200():
    with _restored(root.common.profiler.pyprof):
        pyprof.enable(gil_probe=False)
        server = StatusServer(None, port=0).start()
        base = "http://127.0.0.1:%d" % server.port
        try:
            codes = []
            for _ in range(20):
                with urllib.request.urlopen(
                        base + "/debug/pyprof?seconds=0.01",
                        timeout=30) as r:
                    codes.append(r.status)
                    assert json.loads(r.read())["enabled"] is True
            assert codes == [200] * 20
            # the guard is free once the last reply is in
            assert status_server._capture_guard.acquire(blocking=False)
            status_server._capture_guard.release()
        finally:
            server.stop()
            pyprof.reset()
