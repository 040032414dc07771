"""The profiler's launch log on the CPU: which logged kernel launch a
Chrome trace lacks the kernel record of (``profiler.unmatched_launches``,
what ``chip_smoke.py``'s ``profile`` phase prints when a trace's kernel
events disagree with the launch counters), on synthetic traces in the
layout ``torch.profiler`` exports; and the log's off state, which costs
the kernel wrappers one global read."""

import json

from znicz_tpu_torch.core import profiler


def _log(n, kernel="max_pooling_offsets"):
    return [{"index": i, "kernel": kernel, "stream": 7,
             "current_stream": 7, "thread": "MainThread"}
            for i in range(n)]


def _trace(tmp_path, launches, lose=(), with_calls=True, ext_on_kernel=True):
    """A trace of ``launches`` annotated launches, each a runtime call
    and a kernel event, less the kernel events of the indices in
    ``lose``."""
    events = []
    for i in range(launches):
        t = 100.0 * i
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": "%smax_pooling_offsets:%d"
                       % (profiler.LAUNCH_PREFIX, i),
                       "pid": 1, "tid": 5, "ts": t, "dur": 20.0,
                       "args": {"External id": 1000 + i}})
        # its shadow on the GPU timeline is not a launch's annotation
        events.append({"ph": "X", "cat": "gpu_user_annotation",
                       "name": "%smax_pooling_offsets:%d"
                       % (profiler.LAUNCH_PREFIX, i),
                       "pid": 0, "tid": 7, "ts": t + 30.0, "dur": 5.0})
        if with_calls:
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "pid": 1, "tid": 5,
                           "ts": t + 5.0, "dur": 3.0,
                           "args": {"correlation": 50 + i}})
        if i in lose:
            continue
        args = {"correlation": 50 + i, "stream": 7}
        if ext_on_kernel:
            args["External id"] = 1000 + i
        events.append({"ph": "X", "cat": "kernel",
                       "name": "void max_pooling_offsets_kernel<float>()",
                       "pid": 0, "tid": 7, "ts": t + 30.0, "dur": 5.0,
                       "args": args})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_a_whole_trace_lacks_nothing(tmp_path):
    assert profiler.unmatched_launches(_trace(tmp_path, 12), _log(12)) == []


def test_the_lost_record_is_named_by_its_launch(tmp_path):
    missing = profiler.unmatched_launches(_trace(tmp_path, 12, lose=(7,)),
                                          _log(12))
    assert [m["index"] for m in missing] == [7]
    assert missing[0]["kernel"] == "max_pooling_offsets"
    assert (missing[0]["stream"], missing[0]["current_stream"]) == (7, 7)
    assert "57" in missing[0]["why"]


def test_without_launch_calls_the_external_id_decides(tmp_path):
    path = _trace(tmp_path, 4, lose=(2,), with_calls=False)
    assert [m["index"] for m in
            profiler.unmatched_launches(path, _log(4))] == [2]
    path = _trace(tmp_path, 4, lose=(), with_calls=False,
                  ext_on_kernel=False)
    assert [m["index"] for m in
            profiler.unmatched_launches(path, _log(4))] == [0, 1, 2, 3]


def test_a_launch_without_its_annotation(tmp_path):
    missing = profiler.unmatched_launches(_trace(tmp_path, 2), _log(3))
    assert [(m["index"], m["why"]) for m in missing] == \
        [(2, "no annotation in the trace")]


def test_the_log_is_off_outside_its_context():
    assert profiler._LAUNCH_LOG is None
    with profiler.launch_log() as log:
        assert profiler._LAUNCH_LOG is log and log == []
    assert profiler._LAUNCH_LOG is None
    # off: the wrappers' context is a no-op
    with profiler.launch_range("max_pooling_offsets", 0):
        pass
