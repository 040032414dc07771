#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``znicz_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

It imports neither ``jax`` nor ``znicz_tpu``.  Phases, each fatal on
failure (the script then exits non-zero and prints no result line):

1. device — the card's name and power limit (``nvidia-smi``);
2. build — ``nvcc`` builds every kernel of the port from
   ``znicz_tpu_torch/csrc`` and ptxas's registers, shared memory and
   spills of each instantiation are printed;
3. kernels — each kernel against its plain PyTorch version on the card
   at the shapes the serving path gives it (AlexNet's three max pools
   at batch 64: f32, and max_pool1 in bf16 and f16), on small
   edge-overhanging geometries, on the kernel's tile edges (output rows
   not a multiple of a tile's, channels not a multiple of a slab's,
   the MNIST pool's 87 channels) and on storage that is not 16-byte
   aligned, with forced ties, values and offsets BIT-equal; each case
   prints the vector width it launched at, and AlexNet's shapes must
   take 16-byte vectors, 87 channels and unaligned storage one
   channel.  Then kernel, plain version and ``F.max_pool2d`` (the
   library yardstick, never called by the port) timed with CUDA events
   after an L2 flush and a device spin that keeps the host's enqueue
   out of the window (median of 50 samples, 200 where the bound is
   under 10 us), beside the bound from bytes at 3.35 TB/s and the
   host's own time per call; an empty launch gives the method's floor,
   and the kernel is also timed at tile budgets of 16, 32 and 64 KB;
4. serve — a full-width AlexNet package (227x227x3, 1000 classes,
   random weights from a seed) served over HTTP by ``ServingServer``
   with every bucket up to 64 warmed; batches of 1, 3, 17 and 64 rows
   in JSON and ``.npy`` must all answer 200 with softmax rows, every
   dispatch must launch the pooling kernel exactly 3 times, and rows
   0, 1, 2, 16 and 63 of every reply (the first rows and the last row
   of each size) must match the port's plain forward run on the CPU
   within 1e-4 in log-probability, i.e. 1e-4 relative on every
   probability (float32, TF32 off on the card); the same rows run with
   TF32 let in are printed beside, as a control.  Then
   images/s over 20 back-to-back batch-64 engine dispatches, request
   latency p50/p99, and a per-layer device-time breakdown, whose pool
   layers give each pool's in-model (warm-L2) time.

The line before the last is the ``{"kernels": [...]}`` JSON — for the
pooling kernel, ``ms``, ``plain_ms``, ``library_ms``, ``bound_ms``,
``host_enqueue_ms`` and ``in_model_ms`` are per batch-64 dispatch,
summed over the three AlexNet pools, and ``launches`` and
``launches_by_width`` count the serve phase's HTTP requests only; the
last line is ``{"ok": true, "device": {...}}``.
"""

import gc
import http.client
import io
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: least device spin before each timed launch, in ms: the host's enqueue
#: of a launch takes tens of microseconds, and stalls of a millisecond
#: were seen on a shared host
SPIN_MS = 2.0
#: tile budgets (KB of shared memory a block) the kernel is also timed at
TILE_SWEEP_KB = (16, 32, 64)
#: samples per kernel timing; shapes whose bound is under 10 us take more
TIMING_ITERS, SMALL_TIMING_ITERS = 50, 200
#: the serve phase's limit on |log p_card - log p_cpu|
LOG_P_TOL = 1e-4
ALEXNET_POOLS = (("max_pool1", (64, 55, 55, 96)),
                 ("max_pool2", (64, 27, 27, 256)),
                 ("max_pool5", (64, 13, 13, 256)))
#: (sy, sx, c, ky, kx, sliding) of tests/unit/test_pooling.py GEOMS —
#: the second and third overhang the edge
GEOMS = ((6, 6, 3, 2, 2, (2, 2)), (5, 7, 2, 3, 2, (2, 3)),
         (4, 4, 1, 3, 3, (3, 3)))
#: (b, h, w, c, ky, kx, sliding) at the kernel's tile edges: 28 tiles
#: of one output row; 13 output rows in tiles of 4 over channels a
#: multiple of the 16-byte vector but not of the slab; the MNIST pool's
#: 87 channels at 2x2/s2; rows wider than a tile (column tiles of 22
#: output columns over 350, in row tiles of 2 over 3)
TILE_EDGES = ((2, 57, 57, 96, 3, 3, (2, 2)), (2, 27, 27, 36, 3, 3, (2, 2)),
              (2, 24, 24, 87, 2, 2, (2, 2)), (2, 7, 700, 32, 3, 3, (2, 2)))
#: the kernel's two widths: 16-byte vectors of channels, one channel
WIDE, NARROW = "16-byte", "1-channel"


def say(*args):
    print(*args, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available — this "
                         "script runs on a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    say("== device: %s; torch %s, CUDA %s, %d device(s)"
        % (name, torch.__version__, torch.version.cuda,
           torch.cuda.device_count()))
    say(smi)
    return name, smi


def phase_build():
    from znicz_tpu_torch.ops import cuda_build, cuda_pooling
    t0 = time.perf_counter()
    cuda_pooling.load()
    say("== build: %.2f s (nvcc of %s, or its cached library); ptxas:"
        % (time.perf_counter() - t0, cuda_pooling.SOURCE))
    for line in cuda_build.ptxas_report(cuda_pooling.SOURCE):
        say("   " + line)


def _bits(t):
    import torch
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _check_pool(torch, x, ky, kx, sliding, use_abs, label):
    """Kernel vs plain version, bit for bit; returns ``(max |diff|, the
    width the kernel launched at)``."""
    from znicz_tpu_torch.ops import cuda_pooling, pooling
    wide = cuda_pooling.LAUNCHES_WIDE
    v, o = cuda_pooling.max_pooling_offsets(x, ky, kx, sliding, use_abs)
    width = WIDE if cuda_pooling.LAUNCHES_WIDE > wide else NARROW
    pv, po = pooling.max_pooling_plain(x, ky, kx, sliding, use_abs)
    torch.cuda.synchronize()
    if v.shape != pv.shape or v.dtype != pv.dtype or \
            not torch.equal(_bits(v), _bits(pv)) or not torch.equal(o, po):
        bad = (o != po).sum().item() if o.shape == po.shape else -1
        raise RuntimeError("kernel disagrees with its plain version: %s "
                           "(%d offsets differ)" % (label, bad))
    return (v.float() - pv.float()).abs().max().item(), width


def _tied(torch, gen, shape, dtype):
    """Small integers: exact ties everywhere, |x| ties for maxabs, a
    tied top-left corner and -inf down channel 0 of row 0."""
    x = torch.randint(-3, 4, shape, generator=gen, device="cuda").to(dtype)
    if len(shape) == 4:
        x[:, 0, :2, :] = 2
        x[0, :, :, 0] = float("-inf")
    return x


def _cases(torch, gen):
    """``(label, x, ky, kx, sliding, width it must launch at or None)``
    of the kernel phase."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    for label, shape in ALEXNET_POOLS:
        yield ("%s f32" % label, torch.randn(shape, generator=gen,
                                             device="cuda"),
               3, 3, (2, 2), WIDE)
    for dtype in (bf16, f16):
        x = torch.randn(ALEXNET_POOLS[0][1], generator=gen, device="cuda")
        yield "max_pool1 %s" % dtype, x.to(dtype), 3, 3, (2, 2), WIDE
    for sy, sx, c, ky, kx, sliding in GEOMS:
        for dtype in (f32, bf16, f16):
            yield ("geom %s %s" % ((sy, sx, c, ky, kx, sliding), dtype),
                   _tied(torch, gen, (3, sy, sx, c), dtype), ky, kx,
                   sliding, None)
    for b, h, w, c, ky, kx, sliding in TILE_EDGES:
        for dtype in (f32, bf16):
            want = NARROW if c % 4 else WIDE if dtype == f32 else None
            yield ("tile edge %s %s" % ((b, h, w, c, ky, kx, sliding),
                                        dtype),
                   _tied(torch, gen, (b, h, w, c), dtype), ky, kx,
                   sliding, want)
    # contiguous, but 4 bytes past a 16-byte boundary
    shape = (2, 27, 27, 36)
    buf = _tied(torch, gen, (2 * 27 * 27 * 36 + 1,), f32)
    yield ("unaligned %s f32" % (shape,), buf[1:].view(shape), 3, 3, (2, 2),
           NARROW)


def _spin_cycles_per_ms(torch):
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on the card
    (CUDA events around one long spin, after a short one)."""
    torch.cuda._sleep(1000)
    n = 2_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(n)
    end.record()
    end.synchronize()
    return n / start.elapsed_time(end)


def _median_ms(torch, fn, flush, cycles_per_ms, iters):
    """Cold-L2 device time of ``fn`` with the host out of the window:
    ``(median device ms, median host ms of fn)`` over ``iters`` samples.

    Each sample enqueues ``flush`` (reads that leave the L2 holding
    clean lines of another buffer), then a device spin longer than the
    host takes to enqueue ``fn`` (at least ``SPIN_MS``, and four times
    the slowest of three warm-up calls), then the start event, ``fn``
    and the end event, and waits for the end.  So the device reaches the
    start event with ``fn``'s work already queued and never idles inside
    the window on the host.  Raises if the host's enqueue, from the spin
    to the end event, ever reaches the spin's length."""
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        warm.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    spin_ms = max(SPIN_MS, 4e3 * max(warm))
    cycles = int(spin_ms * cycles_per_ms)
    device, host, window = [], [], []
    gc.disable()  # no collection inside a window
    try:
        for _ in range(iters):
            flush()
            torch.cuda._sleep(cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            t1 = time.perf_counter()
            fn()
            t2 = time.perf_counter()
            end.record()
            window.append((time.perf_counter() - t0) * 1e3)
            host.append((t2 - t1) * 1e3)
            end.synchronize()
            device.append(start.elapsed_time(end))
    finally:
        gc.enable()
    if max(window) >= spin_ms:
        raise RuntimeError("the host took %.4f ms to enqueue, the device "
                           "spin lasts %.4f ms" % (max(window), spin_ms))
    return statistics.median(device), statistics.median(host)


def _tile_sweep(torch, cuda_pooling, fn, flush, cycles_per_ms, iters):
    """Kernel ms of ``fn`` at each tile budget of ``TILE_SWEEP_KB``."""
    chosen = cuda_pooling.TILE_BYTES
    sweep = {}
    try:
        for kb in TILE_SWEEP_KB:
            cuda_pooling.TILE_BYTES = kb << 10
            cuda_pooling.launch_plan.cache_clear()
            sweep[kb] = _median_ms(torch, fn, flush, cycles_per_ms, iters)[0]
    finally:
        cuda_pooling.TILE_BYTES = chosen
        cuda_pooling.launch_plan.cache_clear()
    return sweep


def phase_kernels(torch, card, cycles_per_ms):
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import cuda_pooling, pooling
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    max_err = 0.0
    n_cases = 0
    for label, x, ky, kx, sliding, want in _cases(torch, gen):
        widths = set()
        for use_abs in (False, True):
            err, width = _check_pool(torch, x, ky, kx, sliding, use_abs,
                                     "%s use_abs=%s" % (label, use_abs))
            max_err = max(max_err, err)
            widths.add(width)
            n_cases += 1
        plan = cuda_pooling.launch_plan(
            tuple(x.shape), x.element_size(), cuda_pooling.vector_width(x),
            ky, kx, sliding)
        say("   %s: bit-equal, max and maxabs, at width %s; %s"
            % (label, "/".join(sorted(widths)), plan))
        if want is not None and widths != {want}:
            raise RuntimeError("%s launched at width %s, not %s"
                               % (label, widths, want))
    say("== kernels: max_pooling_offsets bit-equal to max_pooling_plain "
        "on %d cases (values and int32 offsets)" % n_cases)
    flush = torch.ones(32 << 20, device=dev).sum  # reads 128 MiB
    say("   timing: CUDA events around each launch after an L2 flush by "
        "reading 128 MiB and a device spin of at least %.1f ms (%.0f "
        "cycles/ms); median of %d samples, %d where the bound is under "
        "10 us" % (SPIN_MS, cycles_per_ms, TIMING_ITERS,
                   SMALL_TIMING_ITERS))
    say("   an empty launch between the events: %.4f ms, the method's "
        "floor; %s" % (_median_ms(torch, lambda: torch.cuda._sleep(0), flush,
                                  cycles_per_ms, SMALL_TIMING_ITERS)[0],
                       card))
    rows = {}
    for label, shape in ALEXNET_POOLS:
        x = torch.randn(shape, generator=gen, device=dev)
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, no copy
        b, h, w, c = shape
        ny, nx = pooling.output_spatial(h, w, 3, 3, (2, 2))
        n_out = b * ny * nx * c
        nbytes = x.numel() * 4 + n_out * (4 + 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_out * 9 / F32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        iters = SMALL_TIMING_ITERS if bound < 0.01 else TIMING_ITERS
        row = {"bound_ms": bound,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

        def kernel():
            return cuda_pooling.max_pooling_offsets(x, 3, 3, (2, 2))
        for key, fn in (
                ("ms", kernel),
                ("plain_ms", lambda: pooling.max_pooling_plain(
                    x, 3, 3, (2, 2))),
                ("library_ms", lambda: F.max_pool2d(
                    x_nchw, 3, 2, ceil_mode=True, return_indices=True))):
            row[key], row[key[:-2] + "host_ms"] = _median_ms(
                torch, fn, flush, cycles_per_ms, iters)
        rows[label] = row
        plan = cuda_pooling.launch_plan(shape, 4, cuda_pooling.vector_width(x),
                                        3, 3, (2, 2))
        say("   %s %s f32: kernel %.4f ms (host enqueue %.4f ms), plain "
            "%.4f ms (host %.4f), max_pool2d %.4f ms (host %.4f), bound "
            "%.4f ms (%.1f MB moved), %.0f%% of bound; %d samples; %s; %s"
            % (label, shape, row["ms"], row["host_ms"], row["plain_ms"],
               row["plain_host_ms"], row["library_ms"],
               row["library_host_ms"], bound, nbytes / 1e6,
               100 * bound / row["ms"], iters, plan, card))
        say("   %s kernel ms by tile budget in KB: %s" % (label, json.dumps(
            _tile_sweep(torch, cuda_pooling, kernel, flush, cycles_per_ms,
                        iters))))
    return rows, max_err


def kernel_record(rows, max_err, in_model):
    """The pooling kernel's entry of the ``{"kernels": [...]}`` line:
    times per batch-64 dispatch, summed over the three AlexNet pools."""
    rec = {k: sum(r[k] for r in rows.values())
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    rec["host_enqueue_ms"] = sum(r["host_ms"] for r in rows.values())
    rec["in_model_ms"] = sum(in_model[k] for k in rows)
    rec["max_abs_err"] = max_err
    rec["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                      for r in rows.values())
                       else "operations")
    return rec


def _post(conn, body, ctype):
    conn.request("POST", "/predict", body=body,
                 headers={"Content-Type": ctype})
    resp = conn.getresponse()
    return resp.status, resp.read()


def _request(conn, x, as_json):
    """One /predict round trip; returns (status, outputs, argmax or
    None, seconds)."""
    import numpy
    t0 = time.perf_counter()
    if as_json:
        # integer pixels: a compact JSON body, parsed into float32
        status, raw = _post(conn, json.dumps(
            {"inputs": x.astype(int).tolist()}), "application/json")
        doc = json.loads(raw) if status == 200 else {}
        out = numpy.asarray(doc.get("outputs", []), numpy.float32)
        argmax = doc.get("argmax")
    else:
        buf = io.BytesIO()
        numpy.save(buf, x)
        status, raw = _post(conn, buf.getvalue(),
                            "application/octet-stream")
        out = numpy.load(io.BytesIO(raw)) if status == 200 else None
        argmax = None
    dt = time.perf_counter() - t0
    if status != 200:
        raise RuntimeError("/predict answered %d: %r" % (status, raw[:300]))
    return out, argmax, dt


def _prob_errors(pairs):
    """Max |a - b| and max |log a - log b| over ``(a, b)`` pairs of
    softmax rows (probabilities floored at 1e-30 before the log)."""
    import numpy

    def log(p):
        return numpy.log(numpy.maximum(p.astype(numpy.float64), 1e-30))
    return (max(float(numpy.abs(a - b).max()) for a, b in pairs),
            max(float(numpy.abs(log(a) - log(b)).max()) for a, b in pairs))


def phase_serve(torch, card, cycles_per_ms):
    import numpy
    from znicz_tpu_torch.core import telemetry
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.export import write_package
    from znicz_tpu_torch.ops import cuda_pooling
    from znicz_tpu_torch.samples import alexnet
    from znicz_tpu_torch.serving import engine as engine_mod
    from znicz_tpu_torch.serving.server import ServingServer

    t0 = time.perf_counter()
    manifest, arrays = alexnet.init_package(seed=0)
    out_dir = os.path.join(HERE, "build", "znicz_tpu_torch", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = write_package(manifest, arrays, os.path.join(out_dir,
                                                        "alexnet.zip"))
    n_params = sum(v.size for k, v in arrays.items() if "zero_filter" not in k)
    say("== serve: AlexNet package, %d parameters, %.1f MB zip, built in "
        "%.2f s" % (n_params, os.path.getsize(path) / 1e6,
                    time.perf_counter() - t0))
    del arrays
    # a batch of 64 227x227x3 float32 images is 39.6 MB of .npy
    root.common.serving.max_body_bytes = 256 << 20
    telemetry.enable()
    t0 = time.perf_counter()
    engine = engine_mod.InferenceEngine(path, max_batch=64, device="cuda")
    say("   engine loaded and warmed (buckets %s) in %.2f s"
        % (list(engine.buckets), time.perf_counter() - t0))
    rand = numpy.random.RandomState(1)
    images = rand.randint(-128, 128, (64,) + engine.sample_shape).astype(
        numpy.float32)
    server = ServingServer(engine, port=0).start()
    replies = []
    try:
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=300)
        # the main path: every count to 0 just before, read just after
        cuda_pooling.LAUNCHES = 0
        cuda_pooling.LAUNCHES_WIDE = cuda_pooling.LAUNCHES_NARROW = 0
        dispatches0 = engine.dispatches
        n_requests = 0
        for _ in range(2):
            for n in (1, 3, 17, 64):
                for as_json in (True, False):
                    out, argmax, _ = _request(conn, images[:n], as_json)
                    n_requests += 1
                    if out.shape != (n, 1000) or \
                            not numpy.isfinite(out).all():
                        raise RuntimeError("reply of shape %s for %d rows"
                                           % (out.shape, n))
                    if numpy.abs(out.sum(axis=1) - 1).max() > 1e-5:
                        raise RuntimeError("softmax rows do not sum to 1")
                    if argmax is not None and \
                            argmax != out.argmax(axis=1).tolist():
                        raise RuntimeError("argmax disagrees with outputs")
                    replies.append((n, out))
        launches = cuda_pooling.LAUNCHES
        by_width = {WIDE: cuda_pooling.LAUNCHES_WIDE,
                    NARROW: cuda_pooling.LAUNCHES_NARROW}
        dispatches = engine.dispatches - dispatches0
        say("   %d requests answered 200: %d dispatches, %d kernel launches "
            "(%s)" % (n_requests, dispatches, launches, by_width))
        if launches == 0 or launches != 3 * dispatches:
            raise RuntimeError("expected 3 max_pooling_offsets launches per "
                               "dispatch, got %d for %d dispatches"
                               % (launches, dispatches))
        if by_width[NARROW] or sum(by_width.values()) != launches:
            raise RuntimeError("AlexNet's pools must launch at 16-byte "
                               "vectors: %s" % by_width)
        lat = {}
        for n, count in ((1, 30), (64, 10)):
            lat[n] = sorted(_request(conn, images[:n], False)[2] * 1e3
                            for _ in range(count))
        conn.close()
    finally:
        server.stop()

    # reference: the port's plain forward on the CPU, same package, on
    # the first two rows and the last row of every reply size
    rows = (0, 1, 2, 16, 63)
    t0 = time.perf_counter()
    cpu = engine_mod.InferenceEngine(path, buckets=(len(rows),),
                                     warmup=False, device="cpu")
    ref = cpu.predict(images[list(rows)])
    del cpu
    got = [(out[[i for i in rows if i < n]], ref[[k for k, i in
                                                  enumerate(rows) if i < n]])
           for n, out in replies]
    err = _prob_errors(got)
    # the control: the same rows on the card with TF32 let in
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            tf32 = engine_mod.forward(
                engine.layers, engine.params,
                torch.from_numpy(images[list(rows)]).to("cuda")).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_err = _prob_errors([(tf32, ref)])
    say("   rows %s of every reply against the CPU plain forward (%.2f s "
        "on the CPU): max |diff| %.3g, max |diff log p| %.3g; TF32 "
        "control: max |diff| %.3g, max |diff log p| %.3g"
        % (list(rows), time.perf_counter() - t0, err[0], err[1],
           tf32_err[0], tf32_err[1]))
    # 1e-4 relative on every probability: on an H100 80GB HBM3 at
    # 700 W, f32 read 1.4e-6 and the TF32 control 1.0e-3
    if not err[1] <= LOG_P_TOL:
        raise RuntimeError("GPU rows differ from the CPU plain forward: "
                           "max |diff log p| %g > %g" % (err[1], LOG_P_TOL))

    # throughput: back-to-back batch-64 dispatches through the engine
    engine.predict(images)
    t0 = time.perf_counter()
    for _ in range(20):
        engine.predict(images)
    dt = time.perf_counter() - t0
    say("   throughput: %.1f images/s (20 batch-64 engine dispatches, "
        "host .npy in and out, %.2f ms each); %s"
        % (20 * 64 / dt, dt / 20 * 1e3, card))
    for n, ms in sorted(lat.items()):
        say("   HTTP .npy request latency, %d row(s), %d sequential "
            "requests: p50 %.2f ms, p99 %.2f ms; %s"
            % (n, len(ms), ms[len(ms) // 2],
               ms[min(len(ms) - 1, int(round(0.99 * (len(ms) - 1))))],
               card))
    return by_width, _layer_breakdown(torch, engine, images, card,
                                      cycles_per_ms)


def _layer_breakdown(torch, engine, images, card, cycles_per_ms):
    """Device time per layer of one batch-64 forward (CUDA events,
    median of 10), plus the host->device copy of the batch.

    After the copy the device spins for four times the host's enqueue
    of a warm forward, so the host has queued every layer before the
    device starts the first: no layer's window holds a wait on the
    host.  Raises if the host's enqueue ever reaches the spin."""
    from znicz_tpu_torch.serving.engine import apply_layer
    names = [e.get("name", e["type"]) for e in engine.layers]
    samples = {k: [] for k in ["h2d"] + names}
    host = []
    spin_ms = None
    gc.disable()  # no collection inside a forward
    with torch.inference_mode():
        for _ in range(11):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(names) + 3)]
            ev[0].record()
            y = torch.from_numpy(images).to("cuda")
            ev[1].record()
            if spin_ms is not None:
                torch.cuda._sleep(int(spin_ms * cycles_per_ms))
            t0 = time.perf_counter()
            ev[2].record()
            for i, (entry, p) in enumerate(zip(engine.layers,
                                               engine.params)):
                y = apply_layer(entry, p, y)
                ev[i + 3].record()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            if spin_ms is None:  # the first forward sets the spin
                spin_ms = 4 * host.pop()
                continue
            samples["h2d"].append(ev[0].elapsed_time(ev[1]))
            for i, k in enumerate(names):
                samples[k].append(ev[i + 2].elapsed_time(ev[i + 3]))
    gc.enable()
    if max(host) >= spin_ms:
        raise RuntimeError("the host took %.4f ms to enqueue a forward, the "
                           "device spin lasts %.4f ms" % (max(host), spin_ms))
    ms = {k: statistics.median(v) for k, v in samples.items()}
    say("   per-layer device ms, batch 64, host ahead by a %.2f ms spin "
        "(%s): %s" % (spin_ms, card, json.dumps(
            {k: round(v, 4) for k, v in ms.items()})))
    say("   one forward: the host enqueues it in %.4f ms (median), the "
        "device runs it in %.4f ms"
        % (statistics.median(host), sum(ms[k] for k in names)))
    say("   peak device memory: %.1f MB"
        % (torch.cuda.max_memory_allocated() / 1e6))
    return ms


def main():
    import torch
    name, smi = phase_device(torch)
    sys.path.insert(0, HERE)
    try:
        import znicz_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit("chip_smoke: the znicz_tpu_torch package is not "
                         "beside this script (%s)" % e)
    from znicz_tpu_torch.ops import cuda_pooling
    card = "[%s]" % smi
    phase_build()
    cycles_per_ms = _spin_cycles_per_ms(torch)
    rows, max_err = phase_kernels(torch, card, cycles_per_ms)
    by_width, layer_ms = phase_serve(torch, card, cycles_per_ms)
    for label in rows:
        say("   %s in the model: %.4f ms (warm L2), cold alone %.4f ms; %s"
            % (label, layer_ms[label], rows[label]["ms"], card))
    for mod in ("jax", "znicz_tpu"):
        if mod in sys.modules:
            raise RuntimeError("%s was imported" % mod)
    kernel = {"name": "max_pooling_offsets", "route": "cuda",
              "source": "znicz_tpu_torch/csrc/" + cuda_pooling.SOURCE,
              "replaces": cuda_pooling.REPLACES,
              "launches": sum(by_width.values()),
              "launches_by_width": by_width}
    kernel.update(kernel_record(rows, max_err, layer_ms))
    say(json.dumps({"kernels": [kernel]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
