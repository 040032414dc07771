"""Inference engine — a package-backed forward over shape buckets.

Counterpart of ``znicz_tpu/serving/engine.py`` (``InferenceEngine``
:373, ``_apply_layer`` :191-251, ``_validate_layers`` :254,
``_build_forward`` :326-366, ``predict`` :838, ``warmup`` :1008).  The
engine loads a deployment package (a zip path, or a
``(manifest, arrays)`` pair as :func:`znicz_tpu_torch.export.
import_package` returns it), checks every layer at load time, uploads
the parameters to the device once, and runs the layer chain eagerly.

**Shape buckets.**  ``predict`` pads every batch up to the next bucket
(powers of two up to ``max_batch``) and strips the padding after, so
the device sees the same few shapes the JAX engine compiles for;
:meth:`warmup` runs every bucket once (cuDNN's algorithm choice, the
kernel library's build) before the engine reports ready.

**Precision.**  Only ``dtype="f32"`` is served.  On the card the
engine sets ``torch.backends.cudnn.allow_tf32 = False`` and
``torch.backends.cuda.matmul.allow_tf32 = False`` for the process:
cuDNN runs float32 convolutions in TF32 by default, and TF32 is not
float32.

**Kernels.**  ``max_pooling`` layers run the hand-written Hopper
kernel (:mod:`znicz_tpu_torch.ops.cuda_pooling`) on the card and its
plain PyTorch version on the CPU; the kernel's winner offsets are
dropped, the values are what the JAX engine's ``reduce_window``
computes.
"""

import os
import threading
import time
import zipfile

import numpy
import torch

from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.backends import default_device
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.ops import activations, dense
from znicz_tpu_torch.ops import conv as conv_ops
from znicz_tpu_torch.ops import normalization as norm_ops
from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.params import params_from_numpy


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


def apply_layer(entry, params, y):
    """One manifest layer on a device tensor.  ``params`` come from
    :func:`znicz_tpu_torch.params.params_from_numpy` (FC weights
    already ``(out, in)``)."""
    tpe = entry["type"]
    if tpe == "softmax" or tpe.startswith("all2all") or \
            tpe.startswith("conv"):
        b = params.get("bias")
        include_bias = bool(entry.get("include_bias", True)) and \
            b is not None
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


def forward(layers, params, x):
    """The whole layer chain on a device tensor."""
    y = x
    for entry, p in zip(layers, params):
        y = apply_layer(entry, p, y)
    return y


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


def matches_sample_shape(shape, sample):
    """True when ``shape`` is ONE sample of a model whose per-sample
    shape is ``sample``: exact, or the implicit single-channel NHWC
    equivalences ``(H, W)`` <-> ``(H, W, 1)``.  The one batch-axis
    rule, shared by the engine and the micro-batcher."""
    shape, sample = tuple(shape), tuple(sample)
    return shape == sample or shape == sample + (1,) or \
        (sample[-1:] == (1,) and shape == sample[:-1])


class InferenceEngine(Logger):
    """Serves a package's forward stack on ``device`` (the card unless
    ``device="cpu"``).

    ``source`` is a package zip path or a ``(manifest, arrays)`` pair,
    loaded once here.  ``max_batch`` caps the largest bucket;
    ``buckets`` overrides the power-of-two ladder; ``sample_shape``
    gives the per-sample input shape when the package records none.
    ``dtype`` must be ``None`` or ``"f32"``."""

    #: the one model generation an engine serves (no hot reload yet)
    version = 1

    def __init__(self, source, max_batch=None, buckets=None,
                 sample_shape=None, warmup=None, device=None, dtype=None):
        super().__init__(logger_name="InferenceEngine")
        if dtype not in (None, "f32"):
            raise ValueError("serving dtype %r is not served by this "
                             "port (f32 only)" % (dtype,))
        self.device = default_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        cfg = root.common.serving
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
        self._lock = threading.Lock()
        self._warm = set()
        #: forward dispatches since construction (warmup included)
        self.dispatches = 0
        #: True once the model is loaded AND warmup (when wanted) ran
        self.ready = False
        self._load(source, sample_shape)
        if cfg.get("warmup", True) if warmup is None else warmup:
            self.warmup()
        else:
            self.ready = True

    # -- introspection ------------------------------------------------------
    @property
    def dtype(self):
        """The input dtype request bodies parse into."""
        return numpy.float32

    @property
    def warm_buckets(self):
        return tuple(sorted(self._warm))

    def stats(self):
        """healthz payload: what is loaded, where, how warm."""
        return {
            "ready": self.ready,
            "model_version": self.version,
            "source": self.source,
            "layers": [e["type"] for e in self.layers],
            "sample_shape": (list(self.sample_shape)
                             if self.sample_shape else None),
            "dtype": "float32",
            "serve_dtype": "f32",
            "device": str(self.device),
            "buckets": list(self.buckets),
            "warm_buckets": list(self.warm_buckets),
            "dispatches": self.dispatches,
        }

    # -- loading ------------------------------------------------------------
    def _load(self, source, sample_shape):
        if isinstance(source, tuple) and len(source) == 2:
            manifest, arrays = source
            self.source = "<in-memory>"
        else:
            self.source = os.fspath(source)
            if not zipfile.is_zipfile(self.source):
                raise ValueError("%s: not a package zip (snapshot sources "
                                 "are not served by this port)"
                                 % self.source)
            from znicz_tpu_torch.export import import_package
            manifest, arrays = import_package(self.source)
        layers, host_params = [], []
        for entry in manifest["layers"]:
            layers.append({k: v for k, v in entry.items() if k != "arrays"})
            host_params.append({
                attr: arrays[fname]
                for attr, fname in entry.get("arrays", {}).items()
                # provenance: the weights arrive with the mask folded in
                if not attr.startswith("zero_filter")})
        _validate_layers(layers)
        shape = manifest.get("input_sample_shape")
        self.sample_shape = (
            tuple(int(d) for d in shape) if shape else
            tuple(sample_shape) if sample_shape is not None else None)
        self.layers = layers
        self.params = params_from_numpy(layers, host_params, self.device)
        if telemetry.enabled():
            telemetry.gauge("serving.model_version").set(self.version)
            telemetry.gauge("serving.warm_buckets").set(0)
        self.info("model <- %s (%d layers, sample shape %s, on %s)",
                  self.source, len(layers), self.sample_shape, self.device)

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

    def predict(self, x):
        """Forward ``x`` (batch-first) through the model: pad to the
        enclosing bucket, run on the device, strip the padding, return
        a float32 numpy array."""
        x = numpy.asarray(x, dtype=numpy.float32)
        if self.sample_shape is not None:
            sample = self.sample_shape
            if matches_sample_shape(x.shape, sample):
                x = x[None]  # one sample: a shape match, never a rank match
            if not matches_sample_shape(x.shape[1:], sample):
                raise ValueError(
                    "per-sample shape %s does not match the model's "
                    "input shape %s" % (tuple(x.shape[1:]), sample))
            x = x.reshape((x.shape[0],) + sample)
        n = x.shape[0]
        bucket = self.bucket_for(n)
        if bucket > n:
            padded = numpy.zeros((bucket,) + x.shape[1:], numpy.float32)
            padded[:n] = x
            x = padded
        with torch.inference_mode():
            y = forward(self.layers, self.params,
                        torch.from_numpy(x).to(self.device))
            y = y[:n].cpu().numpy()
        with self._lock:
            self.dispatches += 1
            first = bucket not in self._warm
            self._warm.add(bucket)
        if telemetry.enabled():
            telemetry.counter(telemetry.labeled(
                "serving.predictions", bucket=bucket)).inc()
            if first:
                telemetry.gauge("serving.warm_buckets").set(len(self._warm))
        return y

    def warmup(self):
        """Run every bucket once; sets :attr:`ready`."""
        if self.sample_shape is None:
            self.warning("cannot warm up: per-sample input shape unknown "
                         "— pass sample_shape=")
            self.ready = True
            return
        t0 = time.perf_counter()
        for bucket in self.buckets:
            if bucket not in self._warm:
                self.predict(numpy.zeros((bucket,) + self.sample_shape,
                                         numpy.float32))
        self.ready = True
        self.info("warm: buckets %s in %.2f s", list(self.buckets),
                  time.perf_counter() - t0)
