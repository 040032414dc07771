"""Deployment packages: export, read, validate and write.

Counterpart of ``znicz_tpu/export.py`` (``_layer_type`` :31,
``input_sample_shape`` :44, ``forward_manifest`` :57,
``serving_manifest`` :142, ``forward_topology`` :169,
``quantize_manifest`` :207, ``export_package`` :239, ``load_package`` /
``import_package`` :294-335).  A package is an **uncompressed** zip:

* ``manifest.json`` — format version, workflow name, per-layer type
  string and attribute map (``arrays`` maps attribute -> ``.npy`` file
  name), the per-sample input shape and the warmup manifest
  (``serving``);
* ``manifest.txt`` — the same layers in the line form the C++ runtime
  parses;
* ``layerN_<attr>.npy`` — one NumPy file per array.

``zero_filter_*`` arrays are provenance: the grouping mask is already
folded into the next layer's weights.  ``quant_*`` arrays are the int8
sidecar of :func:`quantize_manifest`; the C++ runtime never sees them.
:func:`run_package_numpy` (JAX :336-415) runs a package's forward in
float64 numpy: the executable spec the C++ runtime (``cpp/``) must
match, through the numpy twins in the port's ``ops`` modules.
"""

import io
import json
import zipfile

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array

#: the one format version this package reads and writes
PACKAGE_FORMAT = 1


def _layer_type(fwd):
    mapping = getattr(type(fwd), "MAPPING", None)
    if not mapping:
        raise ValueError("%s has no MAPPING type string" % type(fwd))
    return sorted(mapping)[0]


def _plain_scalar(value):
    if isinstance(value, (tuple, set, frozenset)):
        return list(value)
    return value


def input_sample_shape(workflow):
    """Per-sample input shape of the forward stack (the first forward's
    allocated input less the batch axis); None before initialize or
    for an input-less stack."""
    forwards = list(getattr(workflow, "forwards", ()))
    if not forwards:
        return None
    inp = getattr(forwards[0], "input", None)
    if inp is None or not inp:
        return None
    return tuple(int(d) for d in inp.shape[1:])


def forward_manifest(workflow):
    """``workflow``'s forward stack as ``(manifest, {file name:
    ndarray})``: what :func:`export_package` writes.  A ``zero_filter``
    forward folds its grouping mask into the next layer's weights and
    leaves the mask beside them as provenance."""
    layers, files = [], {}
    pending_mask = pending_grouping = None
    for i, fwd in enumerate(workflow.forwards):
        tpe = _layer_type(fwd)
        if tpe == "zero_filter":
            fwd._ensure_mask()
            pending_mask = numpy.array(fwd.mask.mem)
            pending_grouping = int(fwd.grouping)
            continue
        entry = {"type": tpe, "name": fwd.name, "arrays": {}}
        data = fwd.package_export()
        if pending_mask is not None:
            w = data.get("weights")
            if w is None:
                raise ValueError(
                    "zero_filter precedes %r which exports no weights "
                    "to fold the grouping mask into" % entry["name"])
            if w.size != pending_mask.size:
                raise ValueError(
                    "zero_filter mask size %d does not match %r "
                    "weights size %d" % (pending_mask.size,
                                         entry["name"], w.size))
            data = dict(data, weights=(
                w.reshape(pending_mask.shape) *
                pending_mask.astype(w.dtype)).reshape(w.shape))
            fname = "layer%d_zero_filter_mask.npy" % i
            files[fname] = pending_mask
            entry["arrays"]["zero_filter_mask"] = fname
            entry["zero_filter_grouping"] = pending_grouping
            pending_mask = pending_grouping = None
        for attr, value in data.items():
            if isinstance(value, numpy.ndarray):
                fname = "layer%d_%s.npy" % (i, attr)
                files[fname] = value
                entry["arrays"][attr] = fname
            else:
                entry[attr] = _plain_scalar(value)
        if entry["type"] == "activation_mul" and \
                entry.get("factor") is None:
            raise ValueError(
                "%s: activation_mul factor is unset — run at least one "
                "minibatch (or pass factor=) before exporting"
                % entry["name"])
        layers.append(entry)
    if pending_mask is not None:
        raise ValueError("zero_filter is the last forward — no next layer "
                         "to fold its grouping mask into")
    manifest = {"format": PACKAGE_FORMAT,
                "workflow": type(workflow).__name__, "layers": layers}
    shape = input_sample_shape(workflow)
    if shape is not None:
        manifest["input_sample_shape"] = list(shape)
        manifest["serving"] = serving_manifest(shape)
    return manifest, files


def serving_manifest(sample_shape):
    """The warmup manifest recorded in a package or a snapshot: the
    bucket ladder a serving replica should warm, the per-sample input
    shape and the serving dtype (``root.common.serving.dtype``).  An
    engine whose constructor pins a ladder or a dtype keeps its pin."""
    from znicz_tpu_torch.serving.engine import default_buckets
    from znicz_tpu_torch.serving.quant import normalize_dtype
    max_batch = int(root.common.serving.get("max_batch", 64))
    return {"buckets": list(default_buckets(max_batch)),
            "max_batch": max_batch,
            "sample_shape": list(sample_shape),
            "dtype": normalize_dtype(root.common.serving.get("dtype"))}


def forward_topology(workflow):
    """The array-free manifest of the forward stack that a snapshot
    carries: each layer's type string, the unit whose snapshot state
    holds its arrays, the names of those arrays and the scalar
    hyperparameters.  A ``zero_filter`` unit has no entry: the next
    layer's carries its ``zero_filter_grouping``, and the serving engine
    folds the grouping mask into that layer's weights (the unit graph
    masks them before every forward, but a GD update after the last
    masking may have moved the masked entries).  Reads no array's
    contents."""
    layers = []
    grouping = None
    for fwd in getattr(workflow, "forwards", ()):
        tpe = _layer_type(fwd)
        if tpe == "zero_filter":
            grouping = int(fwd.grouping)
            continue
        entry = {"type": tpe, "unit": fwd.name, "arrays": []}
        if grouping is not None:
            entry["zero_filter_grouping"] = grouping
            grouping = None
        for attr in fwd.package_attrs:
            value = getattr(fwd, attr, None)
            if value is None:
                continue
            if isinstance(value, Array):
                if value:
                    entry["arrays"].append(attr)
            elif isinstance(value, numpy.ndarray):
                entry["arrays"].append(attr)
            else:
                entry[attr] = _plain_scalar(value)
        layers.append(entry)
    topology = {"layers": layers}
    shape = input_sample_shape(workflow)
    if shape is not None:
        topology["input_sample_shape"] = list(shape)
        topology["serving"] = serving_manifest(shape)
    return topology


def quantize_manifest(manifest, files):
    """Add the int8 sidecar to a package manifest in place: for every
    layer with quantizable weights, the per-output-channel int8 weights
    (``layerN_weights_q8.npy``) and their float32 scales
    (``layerN_weights_scale.npy``), referenced as ``quant_weights_q8`` /
    ``quant_weights_scale`` with the scheme tag.  The f32 weights stay,
    so the package serves at any dtype.  Returns the number of layers
    quantized."""
    from znicz_tpu_torch.serving import quant
    quantized = 0
    for entry in manifest["layers"]:
        fname = entry.get("arrays", {}).get("weights")
        if fname is None or not quant.quantizable(entry):
            continue
        q, scale = quant.quantize_weights(files[fname],
                                          quant.quant_axis(entry))
        base = fname[:-len(".npy")]
        files[base + "_q8.npy"] = q
        files[base + "_scale.npy"] = scale
        entry["arrays"]["quant_weights_q8"] = base + "_q8.npy"
        entry["arrays"]["quant_weights_scale"] = base + "_scale.npy"
        entry["quant_scheme"] = quant.QUANT_SCHEME
        quantized += 1
    if quantized:
        manifest["quant_scheme"] = quant.QUANT_SCHEME
    return quantized


def export_package(workflow, path, quantize=False):
    """Write ``workflow``'s forward stack (a unit-graph workflow's
    ``forwards``) as a deployment package at ``path``; ``quantize``
    adds the int8 sidecar.  Returns ``path``."""
    manifest, files = forward_manifest(workflow)
    if quantize:
        quantize_manifest(manifest, files)
    return write_package(manifest, files, path)


def load_package(path):
    """Read a package: ``(manifest dict, {file name: ndarray})``."""
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
        arrays = {}
        for info in zf.infolist():
            if info.filename.endswith(".npy"):
                arrays[info.filename] = numpy.load(
                    io.BytesIO(zf.read(info.filename)), allow_pickle=False)
    return manifest, arrays


def import_package(path):
    """:func:`load_package` plus validation: the format version, a
    layer list, a type on every layer and every referenced array file
    present."""
    manifest, arrays = load_package(path)
    version = manifest.get("format")
    if version != PACKAGE_FORMAT:
        raise ValueError(
            "%s: unknown package format version %r (this build reads "
            "format %d)" % (path, version, PACKAGE_FORMAT))
    if not isinstance(manifest.get("layers"), list):
        raise ValueError("%s: manifest.json has no layers list" % path)
    for entry in manifest["layers"]:
        if "type" not in entry:
            raise ValueError("%s: manifest layer without type: %r"
                             % (path, entry))
        for fname in entry.get("arrays", {}).values():
            if fname not in arrays:
                raise ValueError(
                    "%s: layer %r references missing array file %r"
                    % (path, entry.get("name", entry["type"]), fname))
    return manifest, arrays


def _manifest_txt(manifest):
    """The C++ runtime's line form: ``type=... attr=file key=value``;
    provenance and sidecar arrays are left out."""
    lines = []
    for entry in manifest["layers"]:
        parts = ["type=%s" % entry["type"]]
        for attr, fname in sorted(entry.get("arrays", {}).items()):
            if not attr.startswith(("zero_filter", "quant")):
                parts.append("%s=%s" % (attr, fname))
        for attr in sorted(entry):
            if attr in ("type", "name", "arrays") or \
                    attr.startswith(("zero_filter", "quant")):
                continue
            value = entry[attr]
            if isinstance(value, bool):
                parts.append("%s=%d" % (attr, int(value)))
            elif isinstance(value, (int, float)):
                parts.append("%s=%r" % (attr, value))
            elif isinstance(value, (tuple, list)) and value and \
                    all(isinstance(v, (int, float)) for v in value):
                parts.append("%s=%s" % (attr, ",".join(repr(v)
                                                       for v in value)))
        lines.append(" ".join(parts))
    return "\n".join(lines) + "\n"


def write_package(manifest, arrays, path):
    """Write ``(manifest, {file name: ndarray})`` as a package zip;
    returns ``path``."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest, indent=2,
                                                default=repr))
        zf.writestr("manifest.txt", _manifest_txt(manifest))
        for fname, value in arrays.items():
            buf = io.BytesIO()
            numpy.save(buf, numpy.ascontiguousarray(value))
            zf.writestr(fname, buf.getvalue())
    return path


#: the FC family's activations (``softmax`` is linear, then softmax)
_FC_ACTIVATIONS = {"all2all": "linear", "all2all_tanh": "tanh",
                   "all2all_relu": "relu", "all2all_str": "strict_relu",
                   "all2all_sigmoid": "sigmoid"}
_CONV_ACTIVATIONS = {"conv": "linear", "conv_tanh": "tanh",
                     "conv_relu": "relu", "conv_str": "strict_relu",
                     "conv_sigmoid": "sigmoid"}
_STANDALONE = {"activation_tanh": "tanh", "activation_sigmoid": "sigmoid",
               "activation_relu": "relu", "activation_str": "strict_relu"}


def _weights_bias(entry, arrays):
    w = arrays[entry["arrays"]["weights"]]
    if entry.get("weights_transposed"):
        w = w.T
    b = arrays.get(entry["arrays"].get("bias", ""), None)
    include_bias = bool(entry.get("include_bias", True)) and b is not None
    return w, b, include_bias


def run_package_numpy(path, x):
    """The package at ``path`` run forward on ``x`` in float64 numpy:
    the FC family, the conv family, max and average pooling (ceil
    mode), LRN, the standalone activations (``activation_mul`` and the
    log / tanhlog / sincos family) and dropout as the identity.  A
    spatial package takes NHWC input.  Returns the last layer's
    output."""
    from znicz_tpu_torch.ops import activations, dense
    from znicz_tpu_torch.ops import conv as conv_ops
    from znicz_tpu_torch.ops import normalization as norm_ops
    from znicz_tpu_torch.ops import pooling as pool_ops
    manifest, arrays = load_package(path)
    y = numpy.asarray(x, dtype=numpy.float64)
    for entry in manifest["layers"]:
        tpe = entry["type"]
        if tpe == "softmax" or tpe in _FC_ACTIVATIONS:
            w, b, include_bias = _weights_bias(entry, arrays)
            y = dense.forward_numpy(
                y.reshape(len(y), -1), w, b,
                activation=_FC_ACTIVATIONS.get(tpe, "linear"),
                include_bias=include_bias)
            if tpe == "softmax":
                y, _ = dense.softmax_numpy(y)
        elif tpe in _CONV_ACTIVATIONS:
            w, b, include_bias = _weights_bias(entry, arrays)
            y = conv_ops.forward_numpy(
                y, w, b, int(entry["ky"]), int(entry["kx"]),
                tuple(int(v) for v in entry["padding"]),
                tuple(int(v) for v in entry["sliding"]),
                activation=_CONV_ACTIVATIONS[tpe],
                include_bias=include_bias)
        elif tpe in ("max_pooling", "avg_pooling"):
            sliding = tuple(int(v) for v in entry["sliding"])
            if tpe == "max_pooling":
                y, _ = pool_ops.max_pooling_numpy(
                    y, int(entry["ky"]), int(entry["kx"]), sliding)
            else:
                y = pool_ops.avg_pooling_numpy(
                    y, int(entry["ky"]), int(entry["kx"]), sliding)
        elif tpe == "norm":
            y = norm_ops.lrn_forward_numpy(
                y, alpha=float(entry["alpha"]), beta=float(entry["beta"]),
                k=float(entry["k"]), n=int(entry["n"]))
        elif tpe == "activation_mul":
            y = y * float(entry["factor"])
        elif tpe in _STANDALONE:
            y = activations.apply_numpy(_STANDALONE[tpe], y)
        elif tpe.startswith("activation_"):
            y = activations.ext_apply_numpy(tpe[len("activation_"):], y)
        elif tpe == "dropout":
            pass  # the identity in inference
        else:
            raise ValueError("package runner: unsupported type %r" % tpe)
    return y
