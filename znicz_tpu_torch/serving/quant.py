"""Serving dtypes: the storage of a loaded model's parameters.

Counterpart of ``znicz_tpu/serving/quant.py`` (``DTYPES`` and the
aliases, ``normalize_dtype`` :75, ``quantizable`` :90, ``quant_axis``
:96, ``quantize_weights`` :107, ``dequantize_weights`` :125,
``convert_host_params`` :138, ``input_dtype`` :250).  Four serving
dtypes (:data:`DTYPES`), chosen per engine (``InferenceEngine(dtype=)``,
``serve --dtype``, a registry spec's ``@DTYPE``, or the source's
recorded warmup manifest):

* ``f32`` — the training forward's numbers;
* ``f32-fast`` — the same f32 values with fully-connected weights
  stored once in the ``(in, out)`` layout, contracted as ``x @ W``
  with the bias and activation after it;
* ``bf16`` — every floating parameter cast once to bfloat16 (one
  round-to-nearest-even cast), activations in bfloat16, f32 replies;
* ``int8`` — per-output-channel symmetric int8 weights with one f32
  scale a channel; biases and activations stay f32.

Everything here runs once a load, on the host: the int8 quantization
is numpy and gives the JAX package's bytes and scales bit for bit.
numpy has no bfloat16 on the card's machine (the JAX package takes it
from ``ml_dtypes``), so the bf16 host copies are CPU
``torch.bfloat16`` tensors.
"""

import numpy
import torch

#: the serving dtype axis, in documentation order
DTYPES = ("f32", "f32_fast", "bf16", "int8")

#: accepted spellings (config files, CLI flags, manifests)
_ALIASES = {
    "f32": "f32", "float32": "f32", "float": "f32",
    "f32-fast": "f32_fast", "f32_fast": "f32_fast",
    "f32fast": "f32_fast", "fast32": "f32_fast",
    "bf16": "bf16", "bfloat16": "bf16",
    "int8": "int8", "i8": "int8",
}

#: the one weight-quantization scheme this package writes and reads
QUANT_SCHEME = "int8_per_channel_symmetric"

#: layer type prefixes whose ``weights`` quantize
_QUANTIZABLE = ("softmax", "all2all", "conv")


def normalize_dtype(dtype):
    """The canonical serving dtype of any accepted spelling; None means
    f32.  An unknown spelling raises ``ValueError``: a typo must never
    serve f32 silently."""
    if dtype is None:
        return "f32"
    key = str(dtype).strip().lower()
    try:
        return _ALIASES[key]
    except KeyError:
        raise ValueError(
            "unknown serving dtype %r (known: %s)"
            % (dtype, "/".join(sorted(set(_ALIASES)))))


def quantizable(entry):
    """True when the manifest layer's ``weights`` quantize."""
    tpe = entry.get("type", "")
    return any(tpe == p or tpe.startswith(p) for p in _QUANTIZABLE)


def quant_axis(entry):
    """The output-channel axis of the layer's stored weights: 0 for
    ``(out, in)``, 1 when the manifest flags ``weights_transposed``."""
    return 1 if entry.get("weights_transposed") else 0


def quantize_weights(w, axis=0):
    """Per-output-channel symmetric int8 quantization: ``(q, scale)``,
    ``q`` int8 in [-127, 127], ``scale`` float32 of ``w``'s rank with
    size 1 on every axis but ``axis``, so that ``q * scale ~= w``.  An
    all-zero channel gets scale 1."""
    w = numpy.asarray(w, dtype=numpy.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    amax = numpy.max(numpy.abs(w), axis=reduce_axes, keepdims=True)
    scale = amax / 127.0
    scale = numpy.where(scale > 0.0, scale, 1.0).astype(numpy.float32)
    q = numpy.clip(numpy.rint(w / scale), -127, 127).astype(numpy.int8)
    return q, scale


def dequantize_weights(q, scale):
    """The reference dequantization, ``q * scale`` in float32."""
    return q.astype(numpy.float32) * numpy.asarray(scale, numpy.float32)


def convert_host_params(layers, host_params, dtype):
    """A model's per-layer host parameters in the serving ``dtype``'s
    storage; returns a new list.  These are what the engine uploads and
    what an evicted model's restore uploads again.  ``layers`` entries
    may be updated in place (their ``weights_transposed`` flag): the
    engine passes its own copies.

    * ``f32`` — unchanged, less the int8 sidecar arrays;
    * ``f32-fast`` — fully-connected weights stored ``(out, in)`` are
      transposed once to ``(in, out)`` and flagged transposed; conv
      weights stored transposed go back to the direct layout, unflagged;
    * ``bf16`` — every floating array cast to bfloat16 (CPU tensors);
    * ``int8`` — every quantizable layer's ``weights`` become
      ``weights_q8`` (int8) and ``weights_scale`` (float32, broadcast
      shape): the package's sidecar where it has one, else quantized
      here.

    bf16 and int8 weights stored transposed are transposed once to the
    ``(out, in)`` layout and unflagged, so each output channel's bytes
    are one contiguous run."""
    dtype = normalize_dtype(dtype)
    out = []
    for entry, p in zip(layers, host_params):
        sidecar_q = p.get("quant_weights_q8")
        sidecar_s = p.get("quant_weights_scale")
        p = {k: v for k, v in p.items() if not k.startswith("quant_")}
        canonicalize = (dtype in ("bf16", "int8") and quantizable(entry)
                        and bool(entry.get("weights_transposed"))
                        and p.get("weights") is not None)
        if dtype == "bf16":
            if canonicalize:
                p = dict(p, weights=numpy.ascontiguousarray(
                    p["weights"].T))
                entry["weights_transposed"] = False
            # one round-to-nearest-even cast from the array's own dtype
            p = {k: (torch.from_numpy(numpy.ascontiguousarray(v)).to(
                torch.bfloat16)
                if numpy.issubdtype(v.dtype, numpy.floating) else v)
                for k, v in p.items()}
        elif dtype == "int8" and quantizable(entry) and \
                p.get("weights") is not None:
            if sidecar_q is not None and sidecar_s is not None:
                q = numpy.asarray(sidecar_q, numpy.int8)
                scale = numpy.asarray(sidecar_s, numpy.float32)
                if q.shape != p["weights"].shape:
                    raise ValueError(
                        "layer %r: quant sidecar shape %s does not match "
                        "weights %s" % (entry.get("name", entry.get("type")),
                                        q.shape, p["weights"].shape))
            else:
                q, scale = quantize_weights(p["weights"], quant_axis(entry))
            if canonicalize:
                q = numpy.ascontiguousarray(q.T)
                scale = numpy.ascontiguousarray(scale.T)
                entry["weights_transposed"] = False
            p = dict(p)
            del p["weights"]
            p["weights_q8"] = q
            p["weights_scale"] = scale
        elif dtype == "f32_fast" and quantizable(entry) and \
                p.get("weights") is not None:
            if entry.get("type", "").startswith("conv"):
                if entry.get("weights_transposed"):
                    p = dict(p, weights=numpy.ascontiguousarray(
                        p["weights"].T))
                    entry["weights_transposed"] = False
            elif not entry.get("weights_transposed"):
                p = dict(p, weights=numpy.ascontiguousarray(
                    p["weights"].T))
                entry["weights_transposed"] = True
        out.append(p)
    return out


def input_dtype(dtype, base_dtype):
    """The torch dtype activations enter the first layer in: bfloat16
    for ``bf16``, else ``base_dtype`` (the model's floating dtype —
    int8 quantizes weights only)."""
    if normalize_dtype(dtype) == "bf16":
        return torch.bfloat16
    return base_dtype
