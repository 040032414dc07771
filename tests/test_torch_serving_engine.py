"""The port's serving engine on snapshots, packages and the four serving
dtypes, against ``znicz_tpu``'s engine, on the CPU.

A CIFAR-10 caffe unit graph (80 TRAIN / 40 VALID synthetic rows,
minibatch 40, float32, one epoch) is trained by each package and
snapshotted after its run, its weights then scaled (``_sharpened``) so
that the replies spread.

* Each snapshot is served by both engines: f32 replies agree within
  ``TOL`` (rtol 1e-4 / atol 1e-6, float32 — other summation orders, as
  ``tests/test_torch_engine.py``); int8 replies agree with the JAX int8
  engine's within ``TOL`` and its int8 weights and scales are bit-equal;
  the bf16 parameters are bit-equal to the JAX engine's ``ml_dtypes``
  cast and the bf16 replies lie within ``accuracy.TOLERANCES`` of both
  the port's f32 and the JAX bf16 replies; f32-fast lies within 1e-5 of
  f32.  The JAX engine pools through ``reduce_window``.
* A fused snapshot and a snapshot without topology are refused.
* ``tests/functional/test_serving.py`` case for case: hot reload over
  HTTP (no warmup dispatch), the rolled-back failed reload, the package
  and the snapshot engines bit-equal; ``tests/functional/
  test_serving_dtype.py``: evict and restore bit-identical, the warmup
  manifest selecting the dtype and the ladder with the pin winning, the
  dtype in the generation key.
* The CLI: ``cifar --device cpu`` then ``serve --latest cifar_caffe``
  in each dtype against the JAX engine on the same snapshot; ``serve
  --latest`` and ``serve a=..@int8 b=..`` in a subprocess, drained to
  exit 0 by SIGTERM.
"""

import http.client
import json
import os
import pickle
import re
import signal
import subprocess
import sys

import numpy
import pytest
import torch

from test_torch_mnist import _one_torch_thread, _restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.samples import cifar as jax_cifar
from znicz_tpu.serving.engine import InferenceEngine as JaxEngine
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch import export, launcher
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
from znicz_tpu_torch.samples import cifar
from znicz_tpu_torch.serving import accuracy, server as server_mod
from znicz_tpu_torch.serving.engine import InferenceEngine
from znicz_tpu_torch.serving.server import ServingServer

TOL = dict(rtol=1e-4, atol=1e-6)
LOADER = {"synthetic_train": 80, "synthetic_valid": 40,
          "minibatch_size": 40}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _train(module, snapdir, device, **kwargs):
    wf = module.build(
        loader_config=dict(LOADER),
        decision_config={"max_epochs": 1, "fail_iterations": 100},
        snapshotter_config={"directory": str(snapdir)}, **kwargs)
    wf.initialize(device=device)
    wf.run()
    wf.snapshotter.suffix = "final"
    return wf, wf.snapshotter.export()


def _sharpened(path):
    """The snapshot at ``path`` with conv1's weights scaled by 100 and
    the other layers' by 3, written beside it: one epoch on 80 rows
    leaves replies within 1e-4 of uniform, these spread over 0 .. 0.4,
    so that agreement within ``TOL`` says something."""
    state = SnapshotterToFile.import_(path)
    units = [e["unit"] for e in state["topology"]["layers"]
             if "weights" in e["arrays"]]
    for i, unit in enumerate(units):
        w = state["units"][unit]["weights"]
        state["units"][unit]["weights"] = w * (100 if i == 0 else 3)
    out = path.replace(".pickle", "_sharp.pickle")
    with open(out, "wb") as f:
        pickle.dump(state, f, protocol=4)
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving_engine")
    for p in (jax_prng, prng):
        p.get(1).seed(1234)
        p.get(2).seed(5678)
    _, jsnap = _train(jax_cifar, tmp / "jax", JaxDevice())
    twf, tsnap = _train(cifar, tmp / "torch", "cpu")
    return {"wf": twf, "dir": tmp, "raw": tsnap,
            "snapshots": {"jax": _sharpened(jsnap),
                          "torch": _sharpened(tsnap)}}


def _images(n, seed=3):
    return numpy.random.RandomState(seed).uniform(
        -60, 60, (n, 32, 32, 3)).astype(numpy.float32)


def _engines(snapshot, dtype):
    return (InferenceEngine(snapshot, max_batch=4, device="cpu",
                            dtype=dtype),
            JaxEngine(snapshot, max_batch=4, dtype=dtype))


@pytest.mark.parametrize("who", ["jax", "torch"])
def test_snapshot_served_by_both_engines(trained, who):
    """A snapshot JAX wrote is served by the port, and one the port
    wrote by JAX."""
    port, jax = _engines(trained["snapshots"][who], "f32")
    assert port.sample_shape == (32, 32, 3) and port.ready
    assert port.warm_buckets == (1, 2, 4)
    for n in (1, 3, 4):
        x = _images(n, seed=n)
        got, want = port.predict(x), jax.predict(x)
        assert got.shape == want.shape == (n, 10)
        numpy.testing.assert_allclose(got, want, **TOL)
    assert numpy.ptp(want) > 0.1


def _host_bits(value):
    if torch.is_tensor(value):
        return value.view(torch.int16).numpy() \
            if value.dtype == torch.bfloat16 else value.numpy()
    value = numpy.asarray(value)
    return value.view(numpy.int16) if value.dtype.itemsize == 2 else value


@pytest.mark.parametrize("who", ["jax", "torch"])
@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32-fast"])
def test_low_precision_against_jax(trained, who, dtype):
    snapshot = trained["snapshots"][who]
    port, jax = _engines(snapshot, dtype)
    f32 = InferenceEngine(snapshot, max_batch=4, device="cpu")
    assert port.serve_dtype == jax.serve_dtype
    # the stored parameters: int8 bytes and scales, bf16 bits
    for got, want in zip(port._model.host_params, jax._model.host_params):
        assert sorted(got) == sorted(want)
        for k in want:
            assert numpy.array_equal(_host_bits(got[k]),
                                     _host_bits(want[k])), k
    assert port._model.layers == jax._model.layers
    x = _images(4, seed=21)
    got, want, ref = port.predict(x), jax.predict(x), f32.predict(x)
    assert got.dtype == numpy.float32
    if dtype == "int8":
        numpy.testing.assert_allclose(got, want, **TOL)
        assert 0 < port.device_bytes < 0.3 * f32.device_bytes
    elif dtype == "bf16":
        pin = accuracy.TOLERANCES["bf16"]["max_delta"]
        assert numpy.abs(got - ref).max() <= pin
        assert numpy.abs(got - want).max() <= pin
        assert port.device_bytes * 2 == f32.device_bytes
    else:
        assert numpy.abs(got - ref).max() <= 1e-5


def test_accuracy_report_within_pins(trained):
    report = accuracy.dtype_delta_report(
        trained["snapshots"]["torch"], dtypes=("f32-fast", "bf16", "int8"),
        n_rows=6, seed=1, max_batch=4, device="cpu")
    ok, failures = accuracy.check(report)
    assert ok and report["ok"], failures
    assert report["buckets"] == [1, 2, 4]
    assert set(report["dtypes"]) == {"f32_fast", "bf16", "int8"}
    assert report["dtypes"]["bf16"]["max_delta"] > 0
    bad = dict(report, dtypes={"bf16": dict(report["dtypes"]["bf16"],
                                            within_tolerance=False)})
    assert not accuracy.check(bad)[0]
    with pytest.raises(ValueError, match="reference"):
        accuracy.dtype_delta_report(trained["snapshots"]["torch"],
                                    dtypes=("f32",), device="cpu")


def test_fused_snapshot_is_refused(tmp_path):
    for p in (jax_prng, prng):
        p.get(1).seed(1234)
        p.get(2).seed(5678)
    wf = cifar.build(loader_config=dict(LOADER),
                     decision_config={"max_epochs": 1},
                     snapshotter_config={"directory": str(tmp_path)},
                     fused={"pool_impl": "offsets", "window": 2})
    wf.initialize(device="cpu")
    path = wf.snapshotter.export()
    with pytest.raises(ValueError, match="topology"):
        InferenceEngine(path, device="cpu")
    with pytest.raises(ValueError, match="topology"):
        JaxEngine(path)


def test_snapshot_without_topology_is_rejected(tmp_path):
    path = str(tmp_path / "old.pickle")
    with open(path, "wb") as f:
        pickle.dump({"format": 1, "workflow": "X",
                     "units": {"fwd0": {"weights": numpy.eye(3)}}}, f)
    with pytest.raises(ValueError, match="topology"):
        InferenceEngine(path, device="cpu")


def test_package_and_snapshot_engines_agree(trained):
    pkg = export.export_package(trained["wf"],
                                str(trained["dir"] / "caffe.zip"))
    x = _images(3, seed=11)
    snap = InferenceEngine(trained["raw"], max_batch=4, device="cpu")
    assert numpy.array_equal(snap.predict(x), InferenceEngine(
        pkg, max_batch=4, device="cpu").predict(x))


def _scaled_snapshot(trained, name, factor=None, weights=None):
    """The port's snapshot with conv1's weights scaled (or replaced)."""
    state = SnapshotterToFile.import_(trained["snapshots"]["torch"])
    unit = trained["wf"].forwards[0].name
    w = numpy.asarray(state["units"][unit]["weights"])
    state["units"][unit]["weights"] = weights if weights is not None \
        else w * factor
    path = str(trained["dir"] / name)
    with open(path, "wb") as f:
        pickle.dump(state, f, protocol=4)
    return path


def _call(port, method, path, doc=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=None if doc is None
                     else json.dumps(doc),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def test_hot_reload_picks_up_new_snapshot(trained):
    engine = InferenceEngine(trained["snapshots"]["torch"], max_batch=4,
                             device="cpu")
    server = ServingServer(engine, port=0).start()
    try:
        x = _images(3, seed=5)
        _, doc0 = _call(server.port, "POST", "/predict",
                        {"inputs": x.tolist()})
        assert doc0["model_version"] == 1
        new = _scaled_snapshot(trained, "reloaded.pickle", factor=1.5)
        warm0 = engine.warmup_dispatches
        status, doc = _call(server.port, "POST", "/reload", {"path": new})
        assert status == 200 and doc["model_version"] == 2 and doc["ready"]
        _, doc1 = _call(server.port, "POST", "/predict",
                        {"inputs": x.tolist()})
        assert doc1["model_version"] == 2
        got = numpy.asarray(doc1["outputs"], numpy.float32)
        assert numpy.array_equal(got, engine.predict(x))
        assert numpy.array_equal(got, InferenceEngine(
            new, max_batch=4, device="cpu").predict(x))
        assert not numpy.allclose(got, doc0["outputs"])
        # same topology and dtype: the warm set carried over, no warmup
        assert engine.warmup_dispatches == warm0
        assert engine.warm_buckets == (1, 2, 4)
        status, health = _call(server.port, "GET", "/healthz")
        assert status == 200 and health["model_version"] == 2
        status, doc = _call(server.port, "POST", "/reload",
                            {"path": str(trained["dir"] / "missing")})
        assert status == 400 and engine.version == 2
        assert _call(server.port, "POST", "/reload", {"nope": 1})[0] == 400
    finally:
        server.stop()


def test_failed_reload_rolls_back_to_serving_model(trained):
    engine = InferenceEngine(trained["snapshots"]["torch"], max_batch=4,
                             device="cpu")
    x = _images(3, seed=6)
    want = engine.predict(x)
    # conv1 weights one column short: loads, fails at the first forward
    bad = _scaled_snapshot(trained, "bad.pickle",
                           weights=numpy.zeros((32, 74), numpy.float32))
    with pytest.raises(RuntimeError):
        engine.load(bad)
    assert engine.ready and engine.version == 1
    assert engine.buckets == (1, 2, 4)
    assert numpy.array_equal(engine.predict(x), want)


@pytest.mark.parametrize("dtype", ["f32", "f32-fast", "bf16", "int8"])
def test_evict_restore_bit_identical_replies(trained, dtype):
    f32 = InferenceEngine(trained["snapshots"]["torch"], max_batch=4,
                          device="cpu")
    engine = InferenceEngine(trained["snapshots"]["torch"], max_batch=4,
                             device="cpu", dtype=dtype)
    assert 0 < engine.device_bytes <= f32.device_bytes
    x = _images(3, seed=7)
    y1 = engine.predict(x)
    assert engine.evict() and not engine.evict()
    assert not engine.resident and engine.device_bytes == 0
    assert not engine.ready and engine.params is None
    y2 = engine.predict(x)  # restored on the predict path
    assert engine.resident and engine.ready
    assert numpy.array_equal(y1, y2)
    assert engine.stats()["evictions"] == 1


def _manifest_with_dtype(dtype):
    manifest = {"format": 1,
                "layers": [{"type": "all2all_tanh", "name": "fc",
                            "arrays": {"weights": "w.npy", "bias": "b.npy"},
                            "include_bias": True,
                            "weights_transposed": False}],
                "input_sample_shape": [4],
                "serving": {"buckets": [1, 2], "max_batch": 2,
                            "sample_shape": [4], "dtype": dtype}}
    r = numpy.random.RandomState(11)
    return manifest, {"w.npy": r.normal(0, 0.3, (3, 4)).astype("f4"),
                      "b.npy": numpy.zeros(3, "f4")}


def test_warmup_manifest_selects_dtype_and_pin_wins():
    adopted = InferenceEngine(_manifest_with_dtype("int8"), device="cpu")
    assert adopted.serve_dtype == "int8"
    assert adopted.params[0]["weights_q8"].dtype == torch.int8
    assert adopted.buckets == (1, 2) and adopted.max_batch == 2
    pinned = InferenceEngine(_manifest_with_dtype("int8"), dtype="f32",
                             max_batch=8, device="cpu")
    assert pinned.serve_dtype == "f32" and "weights" in pinned.params[0]
    assert pinned.buckets == (1, 2, 4, 8)
    with pytest.raises(ValueError, match="unknown serving dtype"):
        InferenceEngine(_manifest_with_dtype("fp4"), device="cpu")


def test_dtype_is_part_of_the_generation_key(trained):
    engine = InferenceEngine(trained["snapshots"]["torch"], max_batch=4,
                             device="cpu", dtype="int8")
    key = engine._model.key
    assert '"int8"' in key
    warm = engine.warmup_dispatches
    assert engine.load(trained["snapshots"]["torch"]) == 2
    assert engine._model.key == key and engine.warmup_dispatches == warm
    f32 = InferenceEngine(trained["snapshots"]["torch"], max_batch=4,
                          device="cpu", warmup=False)
    assert f32._model.key != key and f32.warm_buckets == ()


# -- the CLI ---------------------------------------------------------------

def _cifar_cli(snapdir):
    with _restored(root.cifar, root.cifar.loader, root.cifar.decision,
                   root.cifar.snapshotter):
        assert cli.main([
            "cifar", "--device", "cpu",
            "--config", "cifar.decision.max_epochs=1",
            "--config", "cifar.loader.synthetic_train=40",
            "--config", "cifar.loader.synthetic_valid=20",
            "--config", "cifar.loader.minibatch_size=20",
            "--config", "cifar.snapshotter.directory=%s" % snapdir]) == 0


@pytest.fixture(scope="module")
def cli_snapdir(tmp_path_factory):
    snapdir = tmp_path_factory.mktemp("cli_snaps")
    for p in (jax_prng, prng):
        p.get(1).seed(99)
        p.get(2).seed(100)
    _cifar_cli(str(snapdir))
    return str(snapdir)


@pytest.mark.parametrize("dtype", ["f32", "f32-fast", "bf16", "int8"])
def test_cli_serves_latest_cifar_in_each_dtype(cli_snapdir, dtype):
    """``python -m znicz_tpu_torch cifar --device cpu`` then ``serve
    --latest cifar_caffe --device cpu --dtype DTYPE``: the replies
    against the JAX engine on the same snapshot."""
    newest = launcher.newest_snapshot(cli_snapdir, "cifar_caffe")
    assert newest is not None
    srv, label = server_mod.serve([
        "cifar_caffe", "--latest", "--directory", cli_snapdir,
        "--device", "cpu", "--port", "0", "--max-batch", "4",
        "--dtype", dtype])
    try:
        assert label == newest
        x = _images(3, seed=8)
        status, doc = _call(srv.port, "POST", "/predict",
                            {"inputs": x.tolist()})
        assert status == 200 and len(doc["argmax"]) == 3
        got = numpy.asarray(doc["outputs"], numpy.float32)
        _, health = _call(srv.port, "GET", "/healthz")
        assert health["serve_dtype"] == dtype.replace("-", "_")
    finally:
        srv.drain()
    jax = JaxEngine(newest, max_batch=4, dtype=dtype)
    want = jax.predict(x)
    if dtype == "bf16":
        ref = JaxEngine(newest, max_batch=4).predict(x)
        pin = accuracy.TOLERANCES["bf16"]["max_delta"]
        assert numpy.abs(got - want).max() <= pin
        assert numpy.abs(got - ref).max() <= pin
    else:
        numpy.testing.assert_allclose(got, want, **TOL)


def test_cli_latest_needs_a_snapshot(tmp_path):
    with pytest.raises(SystemExit, match="no snapshot"):
        server_mod.serve(["cifar_caffe", "--latest", "--directory",
                          str(tmp_path), "--device", "cpu"])


def _serve_subprocess(args):
    """``python -m znicz_tpu_torch serve ARGS`` in a subprocess: its
    port, then SIGTERM drains it to exit 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "znicz_tpu_torch", "serve", "--port", "0",
         "--device", "cpu", "--max-batch", "4"] + args,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        banner = proc.stdout.readline()
        yield proc, int(re.search(r"http://[\d.]+:(\d+)/", banner).group(1))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_serve_latest_subprocess(cli_snapdir):
    for proc, port in _serve_subprocess(
            ["cifar_caffe", "--latest", "--directory", cli_snapdir]):
        status, doc = _call(port, "POST", "/predict",
                            {"inputs": _images(2).tolist()})
        assert status == 200 and len(doc["argmax"]) == 2


def test_serve_registry_subprocess(cli_snapdir, trained):
    snap = launcher.newest_snapshot(cli_snapdir, "cifar_caffe")
    pkg = export.export_package(trained["wf"],
                                str(trained["dir"] / "reg.zip"))
    for proc, port in _serve_subprocess(
            ["a=%s@int8" % snap, "b=%s" % pkg, "--max-inflight", "2"]):
        x = _images(2).tolist()
        for name, dtype in (("a", "int8"), ("b", "f32")):
            status, doc = _call(port, "POST", "/predict/" + name,
                                {"inputs": x})
            assert status == 200 and doc["model"] == name
            status, health = _call(port, "GET", "/healthz/" + name)
            assert status == 200 and health["serve_dtype"] == dtype
        status, models = _call(port, "GET", "/models")
        assert sorted(models["models"]) == ["a", "b"]
        assert models["default"] == "a"
