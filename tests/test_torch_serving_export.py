"""What the port writes for serving, against the JAX package's, on the
CPU.

* The CIFAR-10 caffe unit graph (small synthetic set, float32) with the
  JAX workflow's weights: the port's ``forward_topology``,
  ``forward_manifest`` and ``export_package`` (``manifest.json``,
  ``manifest.txt`` and every array) equal ``znicz_tpu.export``'s, with
  and without the int8 sidecar.
* The ``zero_filter`` fold, held by a hand-made mask on stand-in
  forwards that both packages' ``forward_manifest`` read: the masked
  weights, the mask kept as provenance, the grouping, and the refusals.
* ``quantize_weights`` gives the JAX package's int8 bytes and scales
  bit for bit; ``convert_host_params`` gives its bf16 parameters
  (``ml_dtypes``) bit for bit, its int8 arrays, its f32-fast layouts.
* A fused workflow's snapshot carries no topology in either package;
  a unit-graph snapshot carries the port's ``forward_topology``.
* ``serving_manifest`` records the configured dtype;
  ``snapshot_candidates`` / ``newest_snapshot`` list snapshots as the
  JAX launcher does.
"""

import json
import os
import time
import zipfile

import ml_dtypes
import numpy
import pytest
import torch

from test_torch_mnist import _one_torch_thread, _restored  # noqa: F401
from znicz_tpu import export as jax_export
from znicz_tpu import launcher as jax_launcher
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.samples import cifar as jax_cifar
from znicz_tpu.serving import quant as jax_quant
from znicz_tpu_torch import export, launcher
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
from znicz_tpu_torch.samples import cifar
from znicz_tpu_torch.serving import quant

LOADER = {"synthetic_train": 80, "synthetic_valid": 40,
          "minibatch_size": 40}


def _build(module, snapdir, **kwargs):
    return module.build(
        loader_config=dict(LOADER),
        decision_config={"max_epochs": 1, "fail_iterations": 100},
        snapshotter_config={"directory": str(snapdir)}, **kwargs)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The caffe unit graph in both packages, initialized (not run),
    the port's weights set to the JAX workflow's."""
    tmp = tmp_path_factory.mktemp("export")
    for p in (jax_prng, prng):
        p.get(1).seed(1234)
        p.get(2).seed(5678)
    jwf = _build(jax_cifar, tmp / "jax")
    jwf.initialize(device=JaxDevice())
    twf = _build(cifar, tmp / "torch")
    twf.initialize(device="cpu")
    for j, t in zip(jwf.forwards, twf.forwards):
        if j.weights:
            t.apply_params(numpy.array(j.weights.mem),
                           numpy.array(j.bias.mem))
    return jwf, twf, tmp


def _jsonable(doc):
    return json.loads(json.dumps(doc, default=repr))


def test_topology_and_manifest_equal_jax(pair):
    jwf, twf, _ = pair
    want = jax_export.forward_topology(jwf)
    got = export.forward_topology(twf)
    assert _jsonable(got) == _jsonable(want)
    assert [e["type"] for e in got["layers"]] == [
        "conv", "max_pooling", "activation_str", "norm", "conv",
        "activation_str", "avg_pooling", "norm", "conv", "activation_str",
        "avg_pooling", "softmax"]
    assert got["input_sample_shape"] == [32, 32, 3]
    assert got["serving"]["dtype"] == "f32"
    jm, jfiles = jax_export.forward_manifest(jwf)
    tm, tfiles = export.forward_manifest(twf)
    assert _jsonable(tm) == _jsonable(jm)
    assert sorted(tfiles) == sorted(jfiles)
    for k in jfiles:
        assert tfiles[k].dtype == jfiles[k].dtype == numpy.float32
        assert numpy.array_equal(tfiles[k], jfiles[k])


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_package_files_equal_jax(pair, quantize):
    jwf, twf, tmp = pair
    paths = [str(tmp / ("%s_%s.zip" % (who, quantize)))
             for who in ("jax", "torch")]
    jax_export.export_package(jwf, paths[0], quantize=quantize)
    assert export.export_package(twf, paths[1], quantize=quantize) == \
        paths[1]
    zips = [zipfile.ZipFile(p) for p in paths]
    names = [sorted(z.namelist()) for z in zips]
    assert names[0] == names[1]
    assert ("layer0_weights_q8.npy" in names[0]) == quantize
    for name in ("manifest.json", "manifest.txt"):
        assert zips[1].read(name) == zips[0].read(name)
    assert zips[1].read("manifest.txt").decode().splitlines()[0] == (
        "type=conv bias=layer0_bias.npy weights=layer0_weights.npy "
        "include_bias=1 kx=5 ky=5 n_kernels=32 padding=2,2,2,2 "
        "sliding=1,1 weights_transposed=0")
    (jm, ja), (tm, ta) = (jax_export.import_package(paths[0]),
                          export.import_package(paths[1]))
    assert tm == jm and sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and numpy.array_equal(ta[k],
                                                                ja[k])


class _Mem(object):
    def __init__(self, mem):
        self.mem = mem


class _ZeroFilter(object):
    """A stand-in ``zero_filter`` forward carrying a hand-made mask."""
    MAPPING = {"zero_filter"}

    def __init__(self, mask, grouping):
        self.name = "grouping"
        self.mask = _Mem(mask)
        self.grouping = grouping
        self.ensured = 0

    def _ensure_mask(self):
        self.ensured += 1


class _Layer(object):
    """A stand-in forward with a type string and exports."""

    def __init__(self, tpe, name, **data):
        self.MAPPING = {tpe}
        self.name = name
        self.data = data

    def package_export(self):
        return dict(self.data)


class _Workflow(object):
    def __init__(self, forwards):
        self.forwards = forwards


def _typed(fwd):
    """``fwd`` in a class whose ``MAPPING`` is its own (the writers read
    ``type(fwd).MAPPING``)."""
    cls = type("Fake", (type(fwd),), {"MAPPING": fwd.MAPPING})
    fwd.__class__ = cls
    return fwd


def test_zero_filter_mask_folds_into_next_weights():
    r = numpy.random.RandomState(3)
    w = r.randn(4, 6).astype(numpy.float32)
    mask = (numpy.arange(24).reshape(4, 6) % 3 != 0).astype(numpy.float32)
    zf = _typed(_ZeroFilter(mask, 3))
    conv = _typed(_Layer("conv", "conv2", weights=w,
                         bias=numpy.ones(4, numpy.float32),
                         include_bias=True, weights_transposed=False,
                         padding=(1, 1, 1, 1)))
    wf = _Workflow([zf, conv])
    tm, tfiles = export.forward_manifest(wf)
    jm, jfiles = jax_export.forward_manifest(wf)
    assert tm == jm and sorted(tfiles) == sorted(jfiles)
    for k in jfiles:
        assert numpy.array_equal(tfiles[k], jfiles[k])
    entry = tm["layers"][0]
    assert entry["zero_filter_grouping"] == 3 and entry["padding"] == \
        [1, 1, 1, 1]
    assert numpy.array_equal(tfiles[entry["arrays"]["weights"]], w * mask)
    assert numpy.array_equal(tfiles[entry["arrays"]["zero_filter_mask"]],
                             mask)
    assert zf.ensured == 2
    txt = export._manifest_txt(tm)
    assert "zero_filter" not in txt and "weights=layer1_weights.npy" in txt
    # a mask with nothing after it, or before a layer without weights
    with pytest.raises(ValueError, match="last forward"):
        export.forward_manifest(_Workflow([conv, zf]))
    relu = _typed(_Layer("activation_relu", "relu"))
    with pytest.raises(ValueError, match="exports no weights"):
        export.forward_manifest(_Workflow([zf, relu]))
    small = _typed(_Layer("conv", "c", weights=w[:2]))
    with pytest.raises(ValueError, match="mask size"):
        export.forward_manifest(_Workflow([zf, small]))


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_weights_bit_equal_jax(axis):
    r = numpy.random.RandomState(7 + axis)
    w = (r.randn(33, 47) * r.uniform(0.01, 3, (33, 1))).astype(
        numpy.float32)
    w[5] = 0.0  # an all-zero channel takes scale 1
    q, s = quant.quantize_weights(w, axis)
    jq, js = jax_quant.quantize_weights(w, axis)
    assert q.dtype == jq.dtype == numpy.int8
    assert s.dtype == js.dtype == numpy.float32
    assert numpy.array_equal(q, jq) and numpy.array_equal(
        s.view(numpy.uint32), js.view(numpy.uint32))
    assert numpy.abs(q).max() == 127
    assert numpy.array_equal(quant.dequantize_weights(q, s),
                             jax_quant.dequantize_weights(jq, js))


def _host_layers(r):
    """A conv, a transposed FC and a softmax layer with host arrays."""
    layers = [{"type": "conv_relu", "name": "c"},
              {"type": "all2all_tanh", "name": "f",
               "weights_transposed": True},
              {"type": "softmax", "name": "s"}]
    host = [{"weights": r.randn(8, 27).astype(numpy.float32),
             "bias": r.randn(8).astype(numpy.float32)},
            {"weights": r.randn(20, 6).astype(numpy.float32),
             "bias": r.randn(6).astype(numpy.float32)},
            {"weights": r.randn(3, 6).astype(numpy.float32),
             "bias": numpy.zeros(3, numpy.float32)}]
    return layers, host


@pytest.mark.parametrize("dtype", ["f32", "f32-fast", "bf16", "int8"])
def test_convert_host_params_equal_jax(dtype):
    r = numpy.random.RandomState(1)
    layers, host = _host_layers(r)
    # rounding cases of the bf16 cast: ties to even, up and down
    host[0]["weights"][0, :4] = numpy.array(
        [1.00390625, 1.01171875, -2.0078125, 3.1415927], numpy.float32)
    jl = [dict(e) for e in layers]
    tl = [dict(e) for e in layers]
    want = jax_quant.convert_host_params(jl, host, dtype)
    got = quant.convert_host_params(tl, host, dtype)
    assert tl == jl
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if dtype == "bf16" and w[k].dtype == ml_dtypes.bfloat16:
                assert g[k].dtype == torch.bfloat16
                assert numpy.array_equal(
                    g[k].view(torch.int16).numpy(), w[k].view(numpy.int16))
            else:
                assert g[k].dtype == w[k].dtype and \
                    numpy.array_equal(g[k], w[k])
    if dtype == "f32-fast":
        assert tl[2]["weights_transposed"] and got[2]["weights"].shape == \
            (6, 3)
    if dtype in ("bf16", "int8"):
        assert not tl[1]["weights_transposed"]
    assert quant.input_dtype(dtype, torch.float32) == (
        torch.bfloat16 if dtype == "bf16" else torch.float32)


def test_int8_sidecar_is_adopted_verbatim():
    r = numpy.random.RandomState(2)
    layers, host = _host_layers(r)
    q, s = quant.quantize_weights(host[2]["weights"] * 2, 0)
    host[2] = dict(host[2], quant_weights_q8=q, quant_weights_scale=s)
    got = quant.convert_host_params([dict(e) for e in layers], host, "int8")
    assert got[2]["weights_q8"] is q or numpy.array_equal(
        got[2]["weights_q8"], q)
    assert not any(k.startswith("quant_") for p in got for k in p)
    bad = dict(host[2], quant_weights_q8=q[:2])
    with pytest.raises(ValueError, match="sidecar shape"):
        quant.convert_host_params([dict(layers[2])], [bad], "int8")
    f32 = quant.convert_host_params([dict(e) for e in layers], host, "f32")
    assert "quant_weights_q8" not in f32[2]


@pytest.mark.parametrize("spelling,want", [
    (None, "f32"), ("float32", "f32"), ("F32-FAST", "f32_fast"),
    ("bfloat16", "bf16"), (" i8 ", "int8")])
def test_normalize_dtype(spelling, want):
    assert quant.normalize_dtype(spelling) == want == \
        jax_quant.normalize_dtype(spelling)


def test_normalize_dtype_refuses_unknown():
    with pytest.raises(ValueError, match="unknown serving dtype"):
        quant.normalize_dtype("fp4")


def test_serving_manifest_records_config_dtype(monkeypatch):
    assert export.serving_manifest((5,)) == {
        "buckets": [1, 2, 4, 8, 16, 32, 64], "max_batch": 64,
        "sample_shape": [5], "dtype": "f32"}
    monkeypatch.setattr(root.common.serving, "dtype", "bf16")
    assert export.serving_manifest((5,))["dtype"] == "bf16"


def test_unit_graph_snapshot_carries_the_topology(pair):
    jwf, twf, _ = pair
    path = twf.snapshotter.export()
    state = SnapshotterToFile.import_(path)
    assert state["topology"] == export.forward_topology(twf)
    conv1 = state["topology"]["layers"][0]
    assert conv1["unit"] == twf.forwards[0].name
    assert conv1["arrays"] == ["weights", "bias"]
    assert state["units"][conv1["unit"]]["weights"].shape == (32, 75)


def test_fused_snapshot_carries_no_topology(tmp_path):
    """Both packages: a fused workflow's forwards are its trainer, which
    no layer type describes, so its snapshot has no ``topology``."""
    for p in (jax_prng, prng):
        p.get(1).seed(1234)
        p.get(2).seed(5678)
    with _restored(root.cifar, jax_root.cifar):
        jwf = _build(jax_cifar, tmp_path / "jax", fused={"window": 2})
        jwf.initialize(device=JaxDevice())
        twf = _build(cifar, tmp_path / "torch",
                     fused={"pool_impl": "offsets", "window": 2})
        twf.initialize(device="cpu")
    with pytest.raises(ValueError, match="MAPPING"):
        export.forward_topology(twf)
    with pytest.raises(ValueError, match="MAPPING"):
        jax_export.forward_topology(jwf)
    for wf in (twf, jwf):
        state = wf.snapshotter.import_(wf.snapshotter.export())
        assert "units" in state and "topology" not in state


def test_snapshot_candidates_newest_first(tmp_path):
    names = ["cifar_caffe_1.7.pickle", "cifar_caffe_2.7.pickle",
             "cifar_caffe_3.7.pickle.part", "other_1.7.pickle",
             "cifar_caffex.7.pickle"]
    for i, name in enumerate(names):
        (tmp_path / name).write_bytes(b"x")
        os.utime(tmp_path / name, (time.time() + i, time.time() + i))
    got = launcher.snapshot_candidates(str(tmp_path), "cifar_caffe")
    assert got == jax_launcher.snapshot_candidates(str(tmp_path),
                                                   "cifar_caffe")
    assert [os.path.basename(p) for p in got] == [
        "cifar_caffe_2.7.pickle", "cifar_caffe_1.7.pickle"]
    assert launcher.newest_snapshot(str(tmp_path), "cifar_caffe") == got[0]
    assert launcher.newest_snapshot(str(tmp_path), "mnist") is None
    assert launcher.snapshot_candidates(str(tmp_path / "none"), "x") == []
