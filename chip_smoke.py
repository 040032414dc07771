#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``znicz_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

It imports neither ``jax`` nor ``znicz_tpu``.  Phases, each fatal on
failure (the script then exits non-zero and prints no result line):

1. device — the card's name and power limit (``nvidia-smi``);
2. build — ``nvcc`` builds every kernel of the port from
   ``znicz_tpu_torch/csrc``;
3. kernels — each kernel against its plain PyTorch version on the card
   at the shapes the serving path gives it (AlexNet's three max pools
   at batch 64, f32 and bf16) and on small edge-overhanging
   geometries with forced ties, values and offsets BIT-equal; then
   kernel, plain version and ``F.max_pool2d`` (the library yardstick,
   never called by the port) timed with CUDA events, median of 50
   cold-L2 launches, beside the bound from bytes at 3.35 TB/s;
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
   latency p50/p99, and a per-layer device-time breakdown.

The line before the last is the ``{"kernels": [...]}`` JSON — for the
pooling kernel, ``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms``
are per batch-64 dispatch, summed over the three AlexNet pools, and
``launches`` counts the serve phase's HTTP requests only; the last
line is ``{"ok": true, "device": {...}}``.
"""

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
#: the serve phase's limit on |log p_card - log p_cpu|
LOG_P_TOL = 1e-4
ALEXNET_POOLS = (("max_pool1", (64, 55, 55, 96)),
                 ("max_pool2", (64, 27, 27, 256)),
                 ("max_pool5", (64, 13, 13, 256)))
#: (sy, sx, c, ky, kx, sliding) of tests/unit/test_pooling.py GEOMS —
#: the second and third overhang the edge
GEOMS = ((6, 6, 3, 2, 2, (2, 2)), (5, 7, 2, 3, 2, (2, 3)),
         (4, 4, 1, 3, 3, (3, 3)))


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
    from znicz_tpu_torch.ops import cuda_pooling
    t0 = time.perf_counter()
    cuda_pooling.load()
    say("== build: %.2f s (nvcc of %s, or its cached library)"
        % (time.perf_counter() - t0, cuda_pooling.SOURCE))


def _bits(t):
    import torch
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _check_pool(torch, x, ky, kx, sliding, use_abs, label):
    """Kernel vs plain version, bit for bit; returns max |diff|."""
    from znicz_tpu_torch.ops import cuda_pooling, pooling
    v, o = cuda_pooling.max_pooling_offsets(x, ky, kx, sliding, use_abs)
    pv, po = pooling.max_pooling_plain(x, ky, kx, sliding, use_abs)
    torch.cuda.synchronize()
    if v.shape != pv.shape or v.dtype != pv.dtype or \
            not torch.equal(_bits(v), _bits(pv)) or not torch.equal(o, po):
        bad = (o != po).sum().item() if o.shape == po.shape else -1
        raise RuntimeError("kernel disagrees with its plain version: %s "
                           "(%d offsets differ)" % (label, bad))
    return (v.float() - pv.float()).abs().max().item()


def _median_ms(torch, fn, flush, iters=50):
    """Median of ``iters`` CUDA-event timings of ``fn``, each after an
    L2 flush (the caller's input comes from device memory)."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_kernels(torch, card):
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import cuda_pooling, pooling
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    max_err = 0.0
    n_cases = 0
    for label, shape in ALEXNET_POOLS:
        x = torch.randn(shape, generator=gen, device=dev)
        for use_abs in (False, True):
            max_err = max(max_err, _check_pool(
                torch, x, 3, 3, (2, 2), use_abs,
                "%s f32 use_abs=%s" % (label, use_abs)))
            n_cases += 1
    x = torch.randn(ALEXNET_POOLS[0][1], generator=gen,
                    device=dev).to(torch.bfloat16)
    for use_abs in (False, True):
        max_err = max(max_err, _check_pool(
            torch, x, 3, 3, (2, 2), use_abs,
            "max_pool1 bf16 use_abs=%s" % use_abs))
        n_cases += 1
    for sy, sx, c, ky, kx, sliding in GEOMS:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            # small integers: exact ties everywhere, |x| ties for maxabs
            x = torch.randint(-3, 4, (3, sy, sx, c), generator=gen,
                              device=dev).to(dtype)
            x[:, 0, :2, :] = 2
            x[0, :, :, 0] = float("-inf")
            for use_abs in (False, True):
                max_err = max(max_err, _check_pool(
                    torch, x.contiguous(), ky, kx, sliding, use_abs,
                    "geom %s %s use_abs=%s" % ((sy, sx, c, ky, kx, sliding),
                                               dtype, use_abs)))
                n_cases += 1
    say("== kernels: max_pooling_offsets bit-equal to max_pooling_plain "
        "on %d cases (values and int32 offsets)" % n_cases)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "bound_ms": 0.0}
    bound_by = set()
    for label, shape in ALEXNET_POOLS:
        x = torch.randn(shape, generator=gen, device=dev)
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, no copy
        b, h, w, c = shape
        ny, nx = pooling.output_spatial(h, w, 3, 3, (2, 2))
        n_out = b * ny * nx * c
        nbytes = x.numel() * 4 + n_out * (4 + 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_out * 9 / F32_OPS_PER_S * 1e3
        row = {
            "ms": _median_ms(torch, lambda: cuda_pooling.
                             max_pooling_offsets(x, 3, 3, (2, 2)), flush),
            "plain_ms": _median_ms(torch, lambda: pooling.
                                   max_pooling_plain(x, 3, 3, (2, 2)),
                                   flush),
            "library_ms": _median_ms(torch, lambda: F.max_pool2d(
                x_nchw, 3, 2, ceil_mode=True, return_indices=True), flush),
            "bound_ms": max(t_bytes, t_ops),
        }
        bound_by.add("bytes" if t_bytes >= t_ops else "operations")
        for k in totals:
            totals[k] += row[k]
        say("   %s %s f32: kernel %.4f ms, plain %.4f ms, max_pool2d "
            "%.4f ms, bound %.4f ms (%.1f MB moved); %s"
            % (label, shape, row["ms"], row["plain_ms"], row["library_ms"],
               row["bound_ms"], nbytes / 1e6, card))
    return dict(totals, max_abs_err=max_err,
                bound_by="bytes" if bound_by == {"bytes"} else "operations")


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


def phase_serve(torch, card):
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
        dispatches = engine.dispatches - dispatches0
        say("   %d requests answered 200: %d dispatches, %d kernel launches"
            % (n_requests, dispatches, launches))
        if launches == 0 or launches != 3 * dispatches:
            raise RuntimeError("expected 3 max_pooling_offsets launches per "
                               "dispatch, got %d for %d dispatches"
                               % (launches, dispatches))
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
    _layer_breakdown(torch, engine, images, card)
    return launches


def _layer_breakdown(torch, engine, images, card):
    """Device time per layer of one batch-64 forward (CUDA events,
    median of 10), plus the host->device copy of the batch."""
    from znicz_tpu_torch.serving.engine import apply_layer
    names = ["h2d"] + [e.get("name", e["type"]) for e in engine.layers]
    samples = {k: [] for k in names}
    with torch.inference_mode():
        for _ in range(11):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(names) + 1)]
            ev[0].record()
            y = torch.from_numpy(images).to("cuda")
            ev[1].record()
            for i, (entry, p) in enumerate(zip(engine.layers,
                                               engine.params)):
                y = apply_layer(entry, p, y)
                ev[i + 2].record()
            torch.cuda.synchronize()
            for i, k in enumerate(names):
                samples[k].append(ev[i].elapsed_time(ev[i + 1]))
    ms = {k: round(statistics.median(v[1:]), 4) for k, v in samples.items()}
    say("   per-layer device ms, batch 64 (%s): %s" % (card, json.dumps(ms)))
    say("   peak device memory: %.1f MB"
        % (torch.cuda.max_memory_allocated() / 1e6))


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
    timing = phase_kernels(torch, card)
    launches = phase_serve(torch, card)
    for mod in ("jax", "znicz_tpu"):
        if mod in sys.modules:
            raise RuntimeError("%s was imported" % mod)
    kernel = {"name": "max_pooling_offsets", "route": "cuda",
              "source": "znicz_tpu_torch/csrc/" + cuda_pooling.SOURCE,
              "replaces": cuda_pooling.REPLACES, "launches": launches}
    kernel.update(timing)
    say(json.dumps({"kernels": [kernel]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
