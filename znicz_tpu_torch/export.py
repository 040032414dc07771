"""Deployment packages: read, validate and write.

Counterpart of ``znicz_tpu/export.py`` (``load_package`` /
``import_package`` :294-335, ``serving_manifest`` :142, the zip layout
of ``export_package``).  A package is an **uncompressed** zip:

* ``manifest.json`` — format version, per-layer type string and
  attribute map (``arrays`` maps attribute -> ``.npy`` file name);
* ``manifest.txt`` — the same layers in the line form the C++ runtime
  parses;
* ``layerN_<attr>.npy`` — one NumPy file per array.

``zero_filter_*`` arrays are provenance: the grouping mask is already
folded into the next layer's weights.
"""

import io
import json
import zipfile

import numpy

#: the one format version this package reads and writes
PACKAGE_FORMAT = 1


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
    provenance arrays are left out."""
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


def serving_manifest(sample_shape):
    """The warmup manifest recorded in a package: the bucket ladder a
    serving replica should warm, the per-sample input shape and the
    serving dtype."""
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.serving.engine import default_buckets
    max_batch = int(root.common.serving.get("max_batch", 64))
    return {"buckets": list(default_buckets(max_batch)),
            "max_batch": max_batch,
            "sample_shape": list(sample_shape),
            "dtype": "f32"}
