"""Inference engine — a snapshot- or package-backed forward over shape
buckets, hot-reloadable, in four serving dtypes.

Counterpart of ``znicz_tpu/serving/engine.py`` (``_apply_quantized_layer``
:106, ``_apply_fast_layer`` :153, ``_apply_layer`` :191-251,
``_validate_layers`` :254, ``_Model`` :278, ``_build_forward`` :326-371,
``InferenceEngine`` :373 with ``load`` :571-728, ``_load_source`` :730,
``_from_manifest`` :745, ``_from_snapshot`` :761, ``_bucket_breaker``
:801, ``predict`` :838, ``warmup`` :1008, ``evict`` :1045, ``restore``
:1077, ``_fill_from_fused_state`` :1151).  The engine loads

* a **training snapshot** through the ``topology`` sidecar the
  snapshotter records (the arrays come from the units' snapshot state,
  or positionally from a fused trainer's state), or
* a **deployment package** (a zip path, or a ``(manifest, arrays)``
  pair as :func:`znicz_tpu_torch.export.import_package` returns it),

checks every layer at load time, uploads the parameters to the device
once and runs the layer chain eagerly.

**Generations.**  A load builds one :class:`_Model` and swaps it in
atomically; requests in flight finish on the generation they started
on.  A reload that keeps the topology and the dtype keeps the
warm-bucket set and runs no warmup; a reload whose warmup fails rolls
back to the old generation and its serving limits.  The source's
recorded warmup manifest (``serving``) picks the bucket ladder and the
dtype unless the constructor pinned them.

**Dtypes** (:mod:`znicz_tpu_torch.serving.quant`):

* ``f32`` — the training forward; on the card TF32 is off for the
  process (``core.backends.full_f32``): TF32 is not float32;
* ``f32-fast`` — the weights sit on the device in the f32 layout.
  Buckets up to ``root.common.serving.latency_bucket_max`` (read at
  load, part of :attr:`InferenceEngine.compile_key`) run the fast
  layer: a fully-connected layer's bias and product in one
  ``torch.addmm``, the activation after.  Larger buckets run the f32
  layer itself, so their replies are bit-equal to ``f32``'s (JAX
  :326-371);
* ``bf16`` — the parameters are cast once at load, the padded batch is
  cast to bfloat16 before the first layer, every layer runs in
  bfloat16 (the max-pool kernel's bf16 instantiation, LRN and the
  softmax among them) and the replies are cast to float32;
* ``int8`` — the product runs against the int8 weights converted to
  the activation dtype and the per-channel scale multiplies the
  product's output, in the JAX package's order; biases and activations
  stay float32.

The products are plain ``torch`` operations (``F.conv2d``,
``torch.matmul``), as the JAX package leaves them to XLA.

**Kernels.**  ``max_pooling`` layers run the hand-written Hopper kernel
(:mod:`znicz_tpu_torch.ops.cuda_pooling`) on the card, at every dtype,
and its plain PyTorch version on the CPU; the winner offsets are
dropped.

**Padding.**  ``predict(x, bucket=B)`` pads to at least bucket ``B``:
a release's shadow compare replays a live request at the bucket its
coalesced batch ran at, since a product's rounding follows the bucket.

**Journal.**  A load journals ``serving.reload``, an eviction
``serving.evict`` and a restore ``serving.restore`` (JAX :697, :1072,
:1101), with the JAX package's attributes.

**Residency.**  :meth:`InferenceEngine.evict` drops the device copies
of the parameters and keeps the host copies, in the serving dtype;
:meth:`~InferenceEngine.restore` (or the next request) uploads them
again.  :attr:`~InferenceEngine.device_bytes` is what the registry's
budget meters.  A per-bucket :class:`~znicz_tpu_torch.serving.breaker.
CircuitBreaker` turns a failing dispatch path into fast 503s.  Inside
its region a dispatch passes the ``serving.forward`` and
``serving.forward.<name>`` fault sites and retries transient faults
(``faults.retry_call``, JAX :895-915): only an exhausted retry counts
as the breaker's failure.

**Device threads.**  A thread's first product on the card takes a
cuBLAS handle, and PyTorch gives the handle a workspace (32 MiB on
Hopper) that lives as long as the process; a handle goes back to the
pool only when its thread exits.  So device work runs on long-lived
threads that take their handle when they start
(:func:`claim_blas_handle`): the batchers' slots, and the one warm-up
thread every engine's :meth:`~InferenceEngine.warmup` runs on
(:func:`on_warm_thread`), where the JAX package warms on the caller's
thread: warm-ups on the HTTP handler threads a deploy or a reload
arrives on would take a new handle, and a workspace, whenever no
returned handle is free.

**Profiling.**  While the profiler is armed, a bucket's first dispatch
of a generation is counted into its cost registry
(``serving.forward[.<name>].b<bucket>[.<dtype>]``, JAX :919-943), and a
load, reload, eviction or restore moves the resident parameters' bytes
in its memory ledger (``serving.model.<name>``, JAX :1033-1041).
"""

import concurrent.futures
import json
import os
import queue
import threading
import time
import warnings
import zipfile

import numpy
import torch

from znicz_tpu_torch.core import faults, profiler, pyprof, telemetry
from znicz_tpu_torch.core.backends import default_device, full_f32
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.ops import activations, dense
from znicz_tpu_torch.ops import conv as conv_ops
from znicz_tpu_torch.ops import normalization as norm_ops
from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.params import params_from_numpy
from znicz_tpu_torch.serving import quant, reqtrace
from znicz_tpu_torch.units.zerofilling import grouping_mask


#: forward dispatches of every engine of this process (warmups among
#: them): a replica's ``/statusz`` ``kernels`` block reports it beside
#: the kernels' launch counters, engines that were removed included
DISPATCHES = 0
_DISPATCHES_LOCK = threading.Lock()

#: the warm-up thread's job queue, made with the thread by the first
#: warm-up
_warm_jobs = []
_warm_lock = threading.Lock()
_warm_local = threading.local()


def claim_blas_handle():
    """Take the calling thread's cuBLAS handle, and the workspace
    PyTorch gives it, now, when this process uses the card: a
    long-lived device thread calls it as it starts, so its handle is
    not taken at whatever product it happens to run first."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_blas_handle()


def _warm_loop(jobs):
    _warm_local.inside = True
    claim_blas_handle()
    while True:
        fn, future = jobs.get()
        try:
            future.set_result(fn())
        except BaseException as e:  # noqa: BLE001 - the caller's
            future.set_exception(e)
        # a finished job keeps no engine (a removed candidate) alive
        del fn, future


def on_warm_thread(fn):
    """``fn()`` run on the process's warm-up thread (started by the
    first call), its result returned and its exception raised here;
    inline when called on that thread."""
    if getattr(_warm_local, "inside", False):
        return fn()
    with _warm_lock:
        if not _warm_jobs:
            _warm_jobs.append(queue.SimpleQueue())
            threading.Thread(target=_warm_loop, args=(_warm_jobs[0],),
                             daemon=True,
                             name=pyprof.thread_name("warmup")).start()
    future = concurrent.futures.Future()
    _warm_jobs[0].put((fn, future))
    return future.result()


def default_buckets(max_batch):
    """Powers of two up to (and always including) ``max_batch``."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1, got %d" % max_batch)
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


#: fused-layer activation epilogues by package type string
_FC_ACT = {"all2all": "linear", "all2all_tanh": "tanh",
           "all2all_relu": "relu", "all2all_str": "strict_relu",
           "all2all_sigmoid": "sigmoid"}
_CONV_ACT = {"conv": "linear", "conv_tanh": "tanh", "conv_relu": "relu",
             "conv_str": "strict_relu", "conv_sigmoid": "sigmoid"}
_STANDALONE_ACT = {"activation_tanh": "tanh",
                   "activation_sigmoid": "sigmoid",
                   "activation_relu": "relu",
                   "activation_str": "strict_relu"}
_EXT_ACT = ("log", "tanhlog", "sincos")


def _nhwc(y):
    """The implicit single-channel NHWC convention: 3-D (B, H, W)
    batches gain a channel axis; 4-D pass through."""
    return y.unsqueeze(3) if y.dim() == 3 else y


def _geometry(entry):
    return (int(entry["ky"]), int(entry["kx"]),
            tuple(int(v) for v in entry["sliding"]))


def _include_bias(entry, params):
    return bool(entry.get("include_bias", True)) and \
        params.get("bias") is not None


def apply_layer(entry, params, y):
    """One manifest layer on a device tensor.  ``params`` are in the
    canonical layout (FC weights ``(out, in)``, conv weights
    ``(K, ky*kx*C)``), as :func:`znicz_tpu_torch.params.
    params_from_numpy` gives them."""
    tpe = entry["type"]
    if tpe == "softmax" or tpe.startswith("all2all") or \
            tpe.startswith("conv"):
        b = params.get("bias")
        include_bias = _include_bias(entry, params)
        if tpe.startswith("conv"):
            ky, kx, sliding = _geometry(entry)
            return conv_ops.forward(
                _nhwc(y), params["weights"], b, ky, kx,
                tuple(int(v) for v in entry["padding"]), sliding,
                activation=_CONV_ACT[tpe], include_bias=include_bias)
        act = "linear" if tpe == "softmax" else _FC_ACT[tpe]
        y = dense.forward(y, params["weights"], b, activation=act,
                          include_bias=include_bias)
        if tpe == "softmax":
            y, _ = dense.softmax(y)
        return y
    if tpe == "max_pooling":
        values, _ = pool_ops.max_pooling(_nhwc(y), *_geometry(entry))
        return values
    if tpe == "avg_pooling":
        return pool_ops.avg_pooling(_nhwc(y), *_geometry(entry))
    if tpe == "norm":
        return norm_ops.lrn_forward(
            y, alpha=float(entry["alpha"]), beta=float(entry["beta"]),
            k=float(entry["k"]), n=int(entry["n"]))
    if tpe == "activation_mul":
        return y * float(entry["factor"])
    if tpe.startswith("activation_"):
        act = _STANDALONE_ACT.get(tpe)
        if act is not None:
            return activations.apply(act, y)
        return activations.ext_apply(tpe[len("activation_"):], y)
    if tpe == "dropout":
        return y  # inference identity
    raise ValueError("serving engine: unsupported layer type %r" % tpe)


def _apply_quantized_layer(entry, params, y):
    """One int8 FC or conv layer: the product against the int8 weights
    converted to the activation dtype, then the per-output-channel
    scale on the product's output, then the bias and the activation."""
    tpe = entry["type"]
    q = params["weights_q8"].to(y.dtype)
    scale = params["weights_scale"]
    include_bias = _include_bias(entry, params)
    if tpe == "softmax" or tpe.startswith("all2all"):
        z = dense.forward(y, q, None, include_bias=False)
        z = z * scale.reshape(1, -1)
        if include_bias:
            z = z + params["bias"]
        if tpe == "softmax":
            return dense.softmax(z)[0]
        return activations.apply(_FC_ACT[tpe], z)
    if tpe.startswith("conv"):
        ky, kx, sliding = _geometry(entry)
        z = conv_ops.forward(_nhwc(y), q, None, ky, kx,
                             tuple(int(v) for v in entry["padding"]),
                             sliding, include_bias=False)
        z = z * scale.reshape(1, 1, 1, -1)  # NHWC: kernels are last
        if include_bias:
            z = z + params["bias"]
        return activations.apply(_CONV_ACT[tpe], z)
    raise ValueError("quantized serving: unsupported layer type %r" % tpe)


def _apply_fast_layer(entry, params, y):
    """One ``f32-fast`` layer: an FC layer adds its bias inside the
    product (``torch.addmm`` over the ``(out, in)`` weights), then
    applies the activation; every other layer is
    :func:`apply_layer`'s."""
    tpe = entry["type"]
    if not (tpe == "softmax" or tpe.startswith("all2all")):
        return apply_layer(entry, params, y)
    x2, w = y.reshape(y.shape[0], -1), params["weights"]
    z = (torch.addmm(params["bias"], x2, w.t())
         if _include_bias(entry, params) else x2 @ w.t())
    if tpe == "softmax":
        return dense.softmax(z)[0]
    return activations.apply(_FC_ACT[tpe], z)


def forward(layers, params, x, serve_dtype="f32", fast_max=0):
    """The whole layer chain of a generation in ``serve_dtype`` on a
    device tensor; bf16 casts ``x`` to bfloat16 first and the reply
    back to float32; ``f32-fast`` runs the fast layer on batches of at
    most ``fast_max`` rows and the strict one on larger ones."""
    if serve_dtype == "bf16":
        x = x.to(torch.bfloat16)
    if serve_dtype == "f32_fast":
        apply_one = (_apply_fast_layer if x.shape[0] <= fast_max
                     else apply_layer)
    else:
        apply_one = apply_layer
    y = x
    for entry, p in zip(layers, params):
        y = (_apply_quantized_layer(entry, p, y) if "weights_q8" in p
             else apply_one(entry, p, y))
    return y.float() if serve_dtype == "bf16" else y


def _validate_layers(layers):
    """Fail at LOAD time for anything :func:`apply_layer` would reject:
    a bad model must never take the first request down."""
    for entry in layers:
        tpe = entry["type"]
        name = entry.get("name", tpe)
        if tpe == "activation_mul":
            if entry.get("factor") is None:
                raise ValueError("layer %r: activation_mul factor is unset"
                                 % name)
            continue
        if tpe == "softmax" or tpe in _FC_ACT or tpe in _CONV_ACT or \
                tpe in ("max_pooling", "avg_pooling", "norm", "dropout"):
            continue
        if tpe in _STANDALONE_ACT or (
                tpe.startswith("activation_") and
                tpe[len("activation_"):] in _EXT_ACT):
            continue
        raise ValueError("serving engine: unsupported layer type %r "
                         "(layer %r)" % (tpe, name))


def _upload(layers, host_params, serve_dtype, device):
    """The device copies of a generation's host parameters: f32 and
    f32-fast through :func:`~znicz_tpu_torch.params.params_from_numpy`
    (the canonical layout: f32-fast's host ``(in, out)`` FC weights, the
    JAX package's layout, go back to ``(out, in)`` once here), the other
    dtypes as they are stored (bf16 tensors, int8 weights), floating
    numpy arrays as float32."""
    if serve_dtype in ("f32", "f32_fast"):
        return params_from_numpy(layers, host_params, device)
    out = []
    for p in host_params:
        d = {}
        for attr, v in p.items():
            if not torch.is_tensor(v):
                v = numpy.asarray(v)
                if numpy.issubdtype(v.dtype, numpy.floating):
                    v = v.astype(numpy.float32, copy=False)
                v = torch.from_numpy(numpy.ascontiguousarray(v))
            d[attr] = v.to(device)
        out.append(d)
    return out


class _Model(object):
    """One loaded generation, swapped atomically on a reload.  ``warm``
    (the buckets dispatched once) lives here, so a dispatch in flight
    on the outgoing generation marks its own set; ``host_params`` are
    the converted host copies an evicted generation restores from."""

    __slots__ = ("layers", "params", "key", "dtype", "sample_shape",
                 "source", "version", "warm", "host_params", "dev_bytes",
                 "serve_dtype", "fast_max")

    def __init__(self, layers, params, key, dtype, sample_shape, source,
                 version, warm, host_params, serve_dtype, fast_max=0):
        self.layers = layers
        self.params = params
        self.key = key
        #: the torch dtype activations enter the first layer in
        self.dtype = dtype
        self.sample_shape = sample_shape
        self.source = source
        self.version = version
        self.warm = warm
        self.host_params = host_params
        self.serve_dtype = serve_dtype
        #: f32-fast only: the largest bucket the fast layer serves (the
        #: ``latency_bucket_max`` knob captured at load)
        self.fast_max = int(fast_max)
        #: the resident parameters' bytes, computed once
        self.dev_bytes = sum(v.numel() * v.element_size()
                             for p in params for v in p.values())


def matches_sample_shape(shape, sample):
    """True when ``shape`` is ONE sample of a model whose per-sample
    shape is ``sample``: exact, or the implicit single-channel NHWC
    equivalences ``(H, W)`` <-> ``(H, W, 1)``.  The one batch-axis
    rule, shared by the engine and the batchers."""
    shape, sample = tuple(shape), tuple(sample)
    return shape == sample or shape == sample + (1,) or \
        (sample[-1:] == (1,) and shape == sample[:-1])


def _derived_sample_shape(layers, host_params):
    """The per-sample input shape where the first layer pins it (an FC
    layer's weights); None for a spatial stack."""
    for entry, p in zip(layers, host_params):
        tpe = entry["type"]
        if tpe == "softmax" or tpe.startswith("all2all"):
            w = p.get("weights")
            if w is None:
                w = p.get("weights_q8")
            if w is None:
                return None
            return (int(w.shape[0] if entry.get("weights_transposed")
                        else w.shape[1]),)
        return None
    return None


def _fill_from_fused_state(state, topology, layers, arrays_list, label):
    """A snapshot whose forwards hold no weights but whose fused trainer
    does: its parameters mapped positionally onto the topology."""
    missing = [i for i, p in enumerate(arrays_list)
               if "weights" in topology["layers"][i].get("arrays", ())
               and "weights" not in p]
    if not missing:
        return
    fused = state.get("units", {}).get("fused_trainer", {}) \
        .get("fused_state")
    fused_params = list(fused.get("params", ())) if fused else None
    if not fused_params or len(fused_params) != len(layers):
        raise ValueError(
            "%s: layers %s have no weights in the snapshot (and no "
            "matching fused trainer state) — snapshot a trained workflow "
            "or export a package instead"
            % (label, [layers[i]["type"] for i in missing]))
    for i in missing:
        p = fused_params[i] or {}
        if p.get("w") is None:
            raise ValueError("%s: fused state carries no weights for layer "
                             "%d (%s)" % (label, i, layers[i]["type"]))
        arrays_list[i]["weights"] = numpy.asarray(p["w"])
        if p.get("b") is not None:
            arrays_list[i]["bias"] = numpy.asarray(p["b"])


class InferenceEngine(Logger):
    """Serves a trained forward stack on ``device`` (the card unless
    ``device="cpu"``).

    ``source`` is a snapshot pickle path, a package zip path or a
    ``(manifest, arrays)`` pair.  ``max_batch`` caps the largest bucket
    and ``buckets`` sets the ladder (either pins it against the source's
    manifest); ``sample_shape`` gives the per-sample input shape where
    the source records none.  ``dtype`` pins the serving dtype
    (``"f32"``, ``"f32-fast"``, ``"bf16"`` or ``"int8"``; an unknown
    spelling raises at once); None follows the source's manifest, else
    f32.  ``name`` is the registry's name for the model."""

    def __init__(self, source=None, max_batch=None, buckets=None,
                 sample_shape=None, warmup=None, device=None, dtype=None,
                 name=None):
        super().__init__(logger_name="InferenceEngine")
        self._dtype_pin = (quant.normalize_dtype(dtype)
                           if dtype is not None else None)
        self.name = name
        self.device = default_device(device)
        full_f32(self.device)
        cfg = root.common.serving
        self._buckets_explicit = bool(buckets) or max_batch is not None
        if buckets:
            self.buckets = tuple(sorted(int(b) for b in buckets))
            if max_batch is not None and int(max_batch) != self.buckets[-1]:
                raise ValueError("max_batch %r contradicts buckets %r"
                                 % (max_batch, buckets))
        else:
            self.buckets = default_buckets(
                max_batch if max_batch is not None
                else cfg.get("max_batch", 64))
        self.max_batch = self.buckets[-1]
        self._warmup_manifest = None
        self._warmup_wanted = (bool(cfg.get("warmup", True))
                               if warmup is None else bool(warmup))
        self._sample_shape_override = (tuple(sample_shape)
                                       if sample_shape is not None else None)
        self._model = None
        self._version = 0
        self._evictions = 0
        self._load_lock = threading.Lock()
        self._lock = threading.Lock()
        self._ready = threading.Event()
        #: per-bucket circuit breakers; they outlive reloads (a failing
        #: backend is not a property of one generation)
        self._breakers = {}
        #: forward dispatches since construction, and those of them
        #: that warmup ran
        self.dispatches = 0
        self.warmup_dispatches = 0
        if source is not None:
            self.load(source)

    # -- introspection ------------------------------------------------------
    @property
    def ready(self):
        """True once a model is loaded AND warmup (when wanted) ran."""
        return self._ready.is_set()

    @property
    def version(self):
        return self._version

    def _current(self, attr, default=None):
        m = self._model
        return getattr(m, attr) if m is not None else default

    @property
    def source(self):
        return self._current("source")

    @property
    def sample_shape(self):
        return self._current("sample_shape")

    @property
    def layers(self):
        return self._current("layers")

    @property
    def params(self):
        """The serving generation's device parameters (None when
        evicted)."""
        return self._current("params")

    @property
    def dtype(self):
        """The numpy dtype request bodies parse into: float32 at every
        serving dtype (numpy has no bfloat16 here; a bf16 engine casts
        the padded batch on the device)."""
        return numpy.float32

    @property
    def serve_dtype(self):
        """The serving dtype ("f32", "f32_fast", "bf16" or "int8")."""
        return self._current("serve_dtype", self._dtype_pin or "f32")

    @property
    def compile_key(self):
        """The loaded generation's key (None before a load): the serving
        dtype, the f32-fast threshold, the topology and the arrays'
        shapes and dtypes.  A reload under the same key keeps the warm
        set (JAX :484)."""
        return self._current("key")

    @property
    def warm_buckets(self):
        m = self._model
        return tuple(sorted(m.warm)) if m is not None else ()

    @property
    def resident(self):
        """True when the parameters are on the device."""
        return self._current("params") is not None

    @property
    def device_bytes(self):
        """Bytes of the resident parameters (0 when evicted)."""
        m = self._model
        return m.dev_bytes if m is not None and m.params is not None else 0

    def _label(self, series, **labels):
        """A series named for this engine: ``model_<name>`` and
        ``dtype_<mode>`` labels where they apply (an unnamed f32 engine
        keeps the plain names)."""
        if self.name is not None:
            labels["model"] = self.name
        if self.serve_dtype != "f32":
            labels["dtype"] = self.serve_dtype
        return telemetry.labeled(series, **labels)

    def stats(self):
        """healthz payload: what is loaded, where, how warm, how big."""
        m = self._model
        payload = {
            "ready": self.ready,
            "model_version": self._version,
            "source": m.source if m else None,
            "layers": [e["type"] for e in m.layers] if m else None,
            "sample_shape": (list(m.sample_shape)
                             if m and m.sample_shape else None),
            "dtype": "float32",
            "serve_dtype": self.serve_dtype,
            "device": str(self.device),
            "buckets": list(self.buckets),
            "warm_buckets": list(self.warm_buckets),
            "resident": self.resident,
            "device_bytes": self.device_bytes,
            "evictions": self._evictions,
            "dispatches": self.dispatches,
            "warmup_dispatches": self.warmup_dispatches,
        }
        if self.name is not None:
            payload["model"] = self.name
        if m is not None and m.serve_dtype == "f32_fast":
            # the fast layer's ceiling this generation loaded with
            payload["latency_bucket_max"] = m.fast_max
        if self._warmup_manifest is not None:
            payload["warmup_manifest"] = self._warmup_manifest
        with self._lock:
            breakers = sorted(self._breakers.items())
        if breakers:
            payload["breakers"] = {str(b): br.status() for b, br in breakers}
        return payload

    # -- loading ------------------------------------------------------------
    def load(self, source, sample_shape=None, version=None):
        """Load (or hot-reload) a model; returns the new version, the
        old one plus one unless ``version`` pins it (a fleet replica
        joining after a release's promote takes the fleet's).

        Requests go on being served by the old generation until the new
        one is swapped in.  With an unchanged topology and dtype the
        warm-bucket set carries over and no warmup runs; a warmup that
        fails rolls the swap back, limits included, and raises."""
        layers, arrays_list, label, src_shape, serving_mf = \
            self._load_source(source)
        _validate_layers(layers)
        host_params = [{attr: numpy.asarray(v) if not torch.is_tensor(v)
                        else v for attr, v in arrs.items()}
                       for arrs in arrays_list]
        serve_dtype = self._dtype_pin or quant.normalize_dtype(
            (serving_mf or {}).get("dtype"))
        # f32-fast: the fast layer's bucket ceiling, a live config read
        # at each load (a reload adopts a changed knob), in the key
        fast_max = (int(root.common.serving.get("latency_bucket_max", 8))
                    if serve_dtype == "f32_fast" else 0)
        host_params = quant.convert_host_params(layers, host_params,
                                                serve_dtype)
        dtype = quant.input_dtype(serve_dtype, torch.float32)
        params = _upload(layers, host_params, serve_dtype, self.device)
        if sample_shape is not None:
            shape = tuple(sample_shape)
        else:
            shape = src_shape or self._sample_shape_override or \
                _derived_sample_shape(layers, host_params)
        key = json.dumps(
            [serve_dtype, fast_max, layers,
             [{a: [str(v.dtype)] + list(v.shape) for a, v in p.items()}
              for p in host_params]], sort_keys=True, default=str)
        with self._load_lock:
            old_limits = (self.buckets, self.max_batch,
                          self._warmup_manifest)
            if serving_mf is not None:
                self._warmup_manifest = serving_mf
                if not self._buckets_explicit and \
                        serving_mf.get("buckets"):
                    ladder = tuple(sorted(int(b)
                                          for b in serving_mf["buckets"]))
                    if ladder[0] >= 1:
                        self.buckets = ladder
                        self.max_batch = ladder[-1]
            old = self._model
            reused = old is not None and old.key == key
            if reused:
                warm = old.warm
            else:
                warm = set()
                self._ready.clear()
            old_bytes = self.device_bytes
            self._version = (int(version) if version is not None
                             else self._version + 1)
            model = _Model(layers, params, key, dtype, shape, label,
                           self._version, warm, host_params, serve_dtype,
                           fast_max)
            self._model = model
        del params
        self._ledger_swap(old_bytes, self.device_bytes)
        event = {"version": model.version, "source": label,
                 "topology_changed": not reused,
                 "serve_dtype": serve_dtype}
        if self.name is not None:
            event["model"] = self.name
        telemetry.record_event("serving.reload", **event)
        if telemetry.enabled():
            telemetry.gauge(self._label("serving.model_version")).set(
                self._version)
            telemetry.gauge(self._label("serving.warm_buckets")).set(
                len(model.warm))
        self.info("model v%d <- %s (%d layers, serve %s, sample shape %s, "
                  "on %s, %s)", self._version, label, len(layers),
                  serve_dtype, shape, self.device,
                  "topology kept" if reused else "new topology")
        if not self._warmup_wanted:
            self._ready.set()
            return self._version
        try:
            self.warmup()
        except Exception:
            with self._load_lock:
                if self._model is model:
                    self._model = old
                    self._version = old.version if old else 0
                    (self.buckets, self.max_batch,
                     self._warmup_manifest) = old_limits
                    self._ledger_swap(model.dev_bytes, self.device_bytes)
            if old is not None:
                self._ready.set()
                self.warning("reload of %s failed at warmup; still serving "
                             "v%d", label, old.version)
            raise
        return self._version

    def _load_source(self, source):
        """Any source as ``(layers, per-layer arrays, label, sample
        shape, warmup manifest or None)``."""
        if isinstance(source, tuple) and len(source) == 2:
            manifest, arrays = source
            return self._from_manifest(manifest, arrays, "<in-memory>")
        path = os.fspath(source)
        if zipfile.is_zipfile(path):
            from znicz_tpu_torch.export import import_package
            manifest, arrays = import_package(path)
            return self._from_manifest(manifest, arrays, path)
        from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
        return self._from_snapshot(SnapshotterToFile.import_(path), path)

    @staticmethod
    def _from_manifest(manifest, arrays, label):
        layers, arrays_list = [], []
        for entry in manifest["layers"]:
            layers.append({k: v for k, v in entry.items() if k != "arrays"})
            arrays_list.append({
                attr: arrays[fname]
                for attr, fname in entry.get("arrays", {}).items()
                # provenance: the weights arrive with the mask folded in
                if not attr.startswith("zero_filter")})
        shape = manifest.get("input_sample_shape")
        shape = tuple(int(d) for d in shape) if shape else None
        return layers, arrays_list, label, shape, manifest.get("serving")

    @staticmethod
    def _from_snapshot(state, label):
        topology = state.get("topology")
        if not topology or not topology.get("layers"):
            raise ValueError(
                "%s: snapshot carries no serving topology (the workflow "
                "has no typed forwards — a fused workflow's are its "
                "trainer) — serve a deployment package "
                "(export.export_package) instead" % label)
        units = state.get("units", {})
        layers, arrays_list = [], []
        for entry in topology["layers"]:
            layers.append({k: v for k, v in entry.items()
                           if k not in ("arrays", "unit")})
            ustate = units.get(entry["unit"], {})
            arrays_list.append({
                attr: numpy.asarray(ustate[attr])
                for attr in entry.get("arrays", ())
                if ustate.get(attr) is not None})
        _fill_from_fused_state(state, topology, layers, arrays_list, label)
        for entry, arrays in zip(layers, arrays_list):
            grouping = entry.get("zero_filter_grouping")
            w = arrays.get("weights")
            if grouping is not None and w is not None:
                shape = (w.shape[0], w.size // w.shape[0])
                arrays["weights"] = w * grouping_mask(
                    shape, grouping, w.dtype).reshape(w.shape)
        shape = topology.get("input_sample_shape")
        shape = tuple(int(d) for d in shape) if shape else None
        return layers, arrays_list, label, shape, topology.get("serving")

    # -- prediction ---------------------------------------------------------
    def bucket_for(self, n):
        """Smallest bucket >= n rows; raises for n over max_batch."""
        n = int(n)
        if n < 1:
            raise ValueError("batch of %d rows" % n)
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError("batch of %d rows exceeds max_batch %d"
                         % (n, self.max_batch))

    def _bucket_breaker(self, bucket):
        """The bucket's circuit breaker, None when
        ``root.common.serving.breaker_threshold`` is 0.  The knobs are
        read at every call, so a change applies at the next dispatch."""
        cfg = root.common.serving
        threshold = int(cfg.get("breaker_threshold", 5) or 0)
        if threshold <= 0:
            return None
        cooldown_s = float(cfg.get("breaker_cooldown_ms", 1000.0)) / 1e3
        half_open_max = int(cfg.get("breaker_half_open_max", 1))
        with self._lock:
            breaker = self._breakers.get(bucket)
            if breaker is None:
                from znicz_tpu_torch.serving.breaker import CircuitBreaker
                breaker = self._breakers[bucket] = CircuitBreaker(
                    "serving.b%d" % bucket if self.name is None
                    else "serving.%s.b%d" % (self.name, bucket),
                    threshold=threshold, cooldown_s=cooldown_s,
                    half_open_max=half_open_max)
                return breaker
        if (breaker.threshold, breaker.cooldown_s, breaker.half_open_max) \
                != (max(threshold, 1), cooldown_s, max(half_open_max, 1)):
            breaker.reconfigure(threshold, cooldown_s, half_open_max)
        return breaker

    def _dispatch(self, m, params, x):
        """One padded batch through generation ``m``: host float32 in,
        host float32 out.  A read-only ``x`` (a request body's bytes
        parsed in place) is shared, not copied: the tensor over it is
        only read, by the copy to the device."""
        with torch.inference_mode():
            if x.flags.writeable:
                xt = torch.from_numpy(x)
            else:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    xt = torch.from_numpy(x)
            kw = ({"fast_max": m.fast_max} if m.serve_dtype == "f32_fast"
                  else {})
            y = forward(m.layers, params, xt.to(self.device), m.serve_dtype,
                        **kw)
            return y.cpu().numpy()

    def predict(self, x, request_ids=None, bucket=None):
        """Forward ``x`` (batch-first) through the serving generation:
        pad to the enclosing bucket (at least ``bucket`` where given),
        run on the device, strip the padding, return a float32 numpy
        array.  An evicted model is restored first.  Each sampled id
        of ``request_ids`` gets the ``device`` span (JAX :990-997):
        from before the copy to the device until the result is on the
        host — CUDA runs asynchronously, so the span ends at the
        readback, not when the forward's Python call returns."""
        m = self._model
        if m is None:
            raise RuntimeError("no model loaded")
        for _ in range(3):
            params = m.params
            if params is not None:
                break
            self.restore()
            m = self._model
        else:
            raise RuntimeError(
                "model%s evicted faster than it restores — the registry "
                "memory budget is thrashing"
                % (" %r" % self.name if self.name else ""))
        x = numpy.asarray(x, dtype=numpy.float32)
        if m.sample_shape is not None:
            sample = tuple(m.sample_shape)
            if matches_sample_shape(x.shape, sample):
                x = x[None]  # one sample: a shape match, never a rank match
            if not matches_sample_shape(x.shape[1:], sample):
                raise ValueError(
                    "per-sample shape %s does not match the model's "
                    "input shape %s" % (tuple(x.shape[1:]), sample))
            x = x.reshape((x.shape[0],) + sample)
        n = x.shape[0]
        bucket = self.bucket_for(max(n, int(bucket or 0)))
        if bucket > n:
            padded = numpy.zeros((bucket,) + x.shape[1:], numpy.float32)
            padded[:n] = x
            x = padded
        breaker = self._bucket_breaker(bucket)
        # the armed profiler counts a bucket's first dispatch of this
        # generation into its cost registry (JAX :919-943)
        cost = self._cost(m, bucket) \
            if profiler.enabled() and bucket not in m.warm else None
        probe = breaker.allow() if breaker is not None else False

        def dispatch():
            if faults.enabled():
                faults.check("serving.forward")
                if self.name:
                    # one model's site: a candidate generation can be
                    # sabotaged without touching its peers
                    faults.check("serving.forward.%s" % self.name)
            if cost is not None:
                with profiler.count_cost(cost[0], **cost[1]):
                    return self._dispatch(m, params, x)
            return self._dispatch(m, params, x)

        t_fwd0 = time.monotonic()
        try:
            # transient faults are retried inside the breaker's region:
            # only an exhausted retry counts as the breaker's failure
            y = faults.retry_call(dispatch, "serving.forward")[:n]
            t_fwd1 = time.monotonic()
        except (ValueError, TypeError):
            # the client's shapes: no evidence of the backend's health
            if breaker is not None:
                breaker.record_neutral(probe)
            raise
        except Exception:
            if breaker is not None:
                breaker.record_failure()
            raise
        except BaseException:
            if breaker is not None:
                breaker.record_neutral(probe)
            raise
        if breaker is not None:
            breaker.record_success()
        if request_ids and reqtrace.enabled():
            for r in request_ids:
                if reqtrace.sampled(r):
                    reqtrace.add_span(r, "device", t_fwd0, t_fwd1,
                                      bucket=bucket, rows=n)
        global DISPATCHES
        with _DISPATCHES_LOCK:
            DISPATCHES += 1
        with self._lock:
            self.dispatches += 1
            first = bucket not in m.warm
            m.warm.add(bucket)
        if telemetry.enabled():
            telemetry.counter(self._label("serving.predictions",
                                          bucket=bucket)).inc()
            if first:
                telemetry.gauge(self._label("serving.warm_buckets")).set(
                    len(m.warm))
        return y

    def _cost(self, m, bucket):
        """``(name, meta)`` of a bucket's cost-registry entry:
        ``serving.forward[.<model>].b<bucket>[.<dtype>]`` (f32 keeps the
        plain name), with the bucket, the generation, the dtype and the
        model as meta, as the JAX engine registers it."""
        name = ("serving.forward.b%d" % bucket if self.name is None
                else "serving.forward.%s.b%d" % (self.name, bucket))
        if m.serve_dtype != "f32":
            name += "." + m.serve_dtype
        meta = {"bucket": bucket, "model_version": m.version,
                "dtype": m.serve_dtype}
        if self.name is not None:
            meta["model"] = self.name
        return name, meta

    def _ledger_swap(self, old_bytes, new_bytes):
        """The resident parameters in the profiler's memory ledger, as
        ``serving.model.<name>`` (JAX :1033-1041)."""
        if not profiler.enabled() or old_bytes == new_bytes:
            return
        profiler.ledger_swap("serving.model.%s" % (self.name or "default"),
                             int(old_bytes), int(new_bytes))

    def warmup(self):
        """Dispatch every bucket not yet warm once, on the warm-up
        thread (:func:`on_warm_thread`); sets :attr:`ready`."""
        on_warm_thread(self._warmup)

    def _warmup(self):
        m = self._model
        if m is None:
            raise RuntimeError("no model loaded")
        if m.sample_shape is None:
            self.warning("cannot warm up: per-sample input shape unknown "
                         "— pass sample_shape=")
            self._ready.set()
            return
        t0 = time.perf_counter()
        for bucket in self.buckets:
            if bucket not in m.warm:
                self.predict(numpy.zeros((bucket,) + tuple(m.sample_shape),
                                         numpy.float32))
                with self._lock:
                    self.warmup_dispatches += 1
        self._ready.set()
        self.info("warm: buckets %s in %.2f s", list(self.buckets),
                  time.perf_counter() - t0)

    # -- residency (the registry's LRU) ---------------------------------------
    def evict(self):
        """Drop the device copies of the parameters, keeping the host
        copies for :meth:`restore`; readiness clears until then.
        Returns True when something was released."""
        with self._load_lock:
            m = self._model
            if m is None or m.params is None:
                return False
            released = m.dev_bytes
            m.params = None
            m.warm.clear()
            self._ready.clear()
            self._evictions += 1
        self._ledger_swap(released, 0)
        if telemetry.enabled():
            telemetry.counter(self._label("serving.evictions")).inc()
            telemetry.gauge(self._label("serving.warm_buckets")).set(0)
        event = {"version": self._version, "released_bytes": released}
        if self.name is not None:
            event["model"] = self.name
        telemetry.record_event("serving.evict", **event)
        self.info("evicted: released %d device bytes%s", released,
                  " (model %s)" % self.name if self.name else "")
        return True

    def restore(self):
        """Undo :meth:`evict`: upload the host copies (in the serving
        dtype) again, then warm up when warmup is wanted.  Returns True
        when a restore happened."""
        with self._load_lock:
            m = self._model
            if m is None:
                raise RuntimeError("no model loaded")
            if m.params is not None:
                return False
            m.params = _upload(m.layers, m.host_params, m.serve_dtype,
                               self.device)
            m.warm.clear()
        self._ledger_swap(0, m.dev_bytes)
        event = {"version": self._version, "device_bytes": m.dev_bytes}
        if self.name is not None:
            event["model"] = self.name
        telemetry.record_event("serving.restore", **event)
        if self._warmup_wanted and m.sample_shape is not None:
            self.warmup()
        else:
            self._ready.set()
        return True
