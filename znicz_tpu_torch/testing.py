"""The user-facing test harness.

Counterpart of ``znicz_tpu/testing.py``: the helpers unit authors use to
test their own units the way the framework tests its.

* :func:`build_fc_package_zip` — a deterministic synthetic FC
  deployment package (``manifest.json`` and ``w<i>.npy`` / ``b<i>.npy``),
  the same arrays and manifest as the JAX package's for the same
  arguments;
* :func:`run_both_backends` — build and run a unit on both devices of
  :data:`DEVICES` from one factory and compare its outputs: the CPU,
  where the port runs each kernel's plain PyTorch version, and the card,
  where it launches the kernels.  Without a card it raises, as every
  entry point does;
* :func:`assert_rerun_stable` — a unit run twice on the same inputs must
  give identical outputs (hidden state leaking between runs shows);
* :func:`timeout` and :class:`AcceleratedTest`, a ``unittest`` base with
  the prng streams seeded as JAX's (:199-202), the comparisons as
  methods and every ``test*`` method under the class ``TIMEOUT``;
* :func:`multi_device_mesh` (JAX :142-154) — the mesh the sharding
  tests take, over the ranks of the current ``torch.distributed``
  world (one process a device, where JAX forces virtual CPU devices);
  a smaller world skips with the launch recipe;
* :func:`run_gang` — a function run in ``n`` gloo ranks on the CPU,
  each in a fresh process, under a hard timeout, the gang killed in a
  ``finally`` whatever happens (JAX's ``_finish_gang``).
"""

import datetime
import functools
import io
import json
import multiprocessing
import os
import queue as queue_mod
import socket
import threading
import time
import traceback
import unittest
import zipfile

import numpy

from znicz_tpu_torch.core.backends import default_device
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.workflow import Workflow

#: the (name, device) pairs :func:`run_both_backends` compares: the
#: plain versions on the CPU against the kernels on the card
DEVICES = (("cpu", "cpu"), ("cuda", "cuda"))


def build_fc_package_zip(path, dims, seed=42, scale=None,
                         weights_transposed=True):
    """Write a deterministic synthetic FC deployment package and return
    ``path``.

    ``dims`` is the layer-width chain ``[in, hidden..., out]`` (hidden
    layers ``all2all_tanh``, the head ``softmax``); ``scale`` multiplies
    the ``randn`` weights (None: raw ``randn``); ``weights_transposed``
    is recorded a layer (True stores ``(in, out)`` arrays)."""
    r = numpy.random.RandomState(seed)
    layers, arrays = [], {}
    for i in range(len(dims) - 1):
        kind = "softmax" if i == len(dims) - 2 else "all2all_tanh"
        layers.append(
            {"type": kind, "name": "l%d" % i,
             "arrays": {"weights": "w%d.npy" % i, "bias": "b%d.npy" % i},
             "include_bias": True,
             "weights_transposed": bool(weights_transposed)})
        shape = ((dims[i], dims[i + 1]) if weights_transposed
                 else (dims[i + 1], dims[i]))
        w = r.randn(*shape).astype(numpy.float32)
        if scale is not None:
            w *= scale
        arrays["w%d.npy" % i] = w
        arrays["b%d.npy" % i] = numpy.zeros(dims[i + 1], numpy.float32)
    manifest = {"format": 1, "layers": layers,
                "input_sample_shape": [int(dims[0])]}
    with zipfile.ZipFile(os.fspath(path), "w") as zf:
        zf.writestr("manifest.json", json.dumps(manifest))
        for fname, arr in arrays.items():
            buf = io.BytesIO()
            numpy.save(buf, arr)
            zf.writestr(fname, buf.getvalue())
    return path


def _collect_outputs(unit, attrs):
    out = {}
    for attr in attrs:
        value = getattr(unit, attr, None)
        if isinstance(value, Array) and value:
            value.map_read()
            out[attr] = numpy.array(value.mem)
    return out


def run_both_backends(build, outputs=("output",), atol=1e-6):
    """Build and run a unit on each device of :data:`DEVICES` and
    compare its outputs.

    ``build(workflow, device)`` constructs the unit, puts its input
    Arrays on ``device`` (``array.device = torch.device(device)``),
    initializes it (``unit.initialize(device=device)``) and returns it.
    Every
    attribute in ``outputs`` that is a non-empty Array is compared:
    same shapes, and ``max |delta| <= atol`` (``atol=0``: equal
    values).  Returns the first device's outputs.  Raises
    ``RuntimeError`` before building anything where a device is the card
    and there is none."""
    for _, device in DEVICES:
        default_device(device)
    (first, _), (second, _) = DEVICES
    results = {}
    for name, device in DEVICES:
        unit = build(Workflow(), device)
        unit.run()
        results[name] = _collect_outputs(unit, outputs)
    missing = set(results[first]) ^ set(results[second])
    if missing:
        raise AssertionError(
            "backends disagree on which outputs exist: %s" % missing)
    if not results[first]:
        raise AssertionError(
            "no outputs to compare: none of %r is a non-empty Array on the "
            "unit (a typo in the outputs tuple?)" % (outputs,))
    for attr, want in results[first].items():
        got = results[second][attr]
        if want.shape != got.shape:
            raise AssertionError(
                "%s shape differs between backends: %s vs %s"
                % (attr, want.shape, got.shape))
        diff = numpy.abs(want.astype(numpy.float64) -
                         got.astype(numpy.float64)).max()
        if not diff <= atol:  # NaN must fail, not slip past `>`
            raise AssertionError(
                "%s differs between backends: max |delta| = %g > %g"
                % (attr, diff, atol))
    return results[first]


def assert_rerun_stable(unit, outputs=("output",)):
    """Run ``unit`` twice; its outputs must be identical (hidden state
    must not leak into a rerun)."""
    unit.run()
    first = _collect_outputs(unit, outputs)
    unit.run()
    second = _collect_outputs(unit, outputs)
    if not first:
        raise AssertionError(
            "no outputs to compare: none of %r is a non-empty Array on the "
            "unit (a typo in the outputs tuple?)" % (outputs,))
    for attr, want in first.items():
        if not numpy.array_equal(want, second[attr]):
            raise AssertionError(
                "%s changed on re-run: the unit leaks state" % attr)


def timeout(seconds):
    """Fail, not hang, when the decorated function runs past
    ``seconds``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            result = {}

            def target():
                try:
                    result["value"] = fn(*args, **kwargs)
                except BaseException as e:  # raised again below
                    result["error"] = e

            t = threading.Thread(target=target, name="znicz:test-timeout",
                                 daemon=True)
            t.start()
            t.join(seconds)
            if t.is_alive():
                raise AssertionError(
                    "%s exceeded %ss timeout" % (fn.__name__, seconds))
            if "error" in result:
                raise result["error"]
            return result.get("value")
        return wrapper
    return deco


def multi_device_mesh(n=8, model_parallel=1):
    """An ``n``-rank mesh for sharding tests, over the current
    ``torch.distributed`` world; raises ``unittest.SkipTest`` with the
    launch recipe where the world has fewer ranks."""
    from znicz_tpu_torch.parallel.mesh import make_mesh, world
    if world()[1] < n:
        raise unittest.SkipTest(
            "need %d ranks; launch them with torchrun --nproc-per-node %d "
            "(gloo under --device cpu) or run the test body through "
            "znicz_tpu_torch.testing.run_gang(fn, %d)" % (n, n, n))
    return make_mesh(n, model_parallel=model_parallel)


def free_port():
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gang_rank(fn, rank, n, port, timeout_s, args, results):
    """One rank of :func:`run_gang`: a gloo world over localhost, then
    ``fn(rank, *args)``, its value or its traceback put on
    ``results``; the rank runs one thread at niceness 10."""
    import torch
    import torch.distributed as dist
    # one thread a rank, at a lower priority: a gang of CPU ranks must
    # not starve the processes beside it (a test run's other workers)
    torch.set_num_threads(1)
    os.nice(10)
    dist.init_process_group(
        "gloo", init_method="tcp://127.0.0.1:%d" % port, world_size=n,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the caller, which fails
        results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_gang(fn, n, args=(), timeout_s=120):
    """``fn(rank, *args)`` in ``n`` ranks of a gloo world on the CPU, each
    a fresh (spawned) process: returns their values by rank.  ``fn`` is
    imported by its module's name there, and its values are pickled.
    A collective waits at most ``timeout_s`` seconds and the gang has as
    long to finish; a rank that raises, dies or runs past it fails the
    call with the reason, and every process still alive is killed in a
    ``finally``."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_gang_rank, daemon=True,
                         args=(fn, r, n, port, timeout_s, tuple(args),
                               results))
             for r in range(n)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        values = {}
        while len(values) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError("gang of %d ranks ran past %ss (%d "
                                   "reported)" % (n, timeout_s, len(values)))
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in values]
                if dead:
                    raise RuntimeError("gang rank(s) died: %s" % dead)
                continue
            if not ok:
                raise RuntimeError("gang rank %d failed:\n%s"
                                   % (rank, value))
            values[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [values[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)


class AcceleratedTest(unittest.TestCase):
    """A ``unittest`` base for unit authors: prng streams 1 and 2 seeded
    (1234, 5678) before each test, the devices of :data:`DEVICES`, the
    comparisons as methods, and every ``test*`` method under the class
    ``TIMEOUT`` (``ZNICZ_TEST_TIMEOUT`` seconds, 300 by default)."""

    TIMEOUT = float(os.environ.get("ZNICZ_TEST_TIMEOUT", 300))

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for name, fn in list(vars(cls).items()):
            if name.startswith("test") and callable(fn):
                setattr(cls, name, timeout(cls.TIMEOUT)(fn))

    def setUp(self):
        from znicz_tpu_torch.core import prng
        prng.get(1).seed(1234)
        prng.get(2).seed(5678)
        (_, self.cpu_device), (_, self.card_device) = DEVICES
        self.workflow = Workflow()

    def assertBackendsAgree(self, build, outputs=("output",), atol=1e-6):
        return run_both_backends(build, outputs=outputs, atol=atol)

    def assertRerunStable(self, unit, outputs=("output",)):
        assert_rerun_stable(unit, outputs=outputs)
