"""The port's real-data parity runs (``parity.py``, ``--parity``), after
``tests/functional/test_parity_cli.py``, on the CPU.

No test here reaches the network: ``parity._fetch`` is replaced by a
stub that raises (an unreachable mirror, at once), and the dataset a
run trains on is written into ``tmp_path``.

* With the files absent, provisioning fails fast with its "network
  required" message naming the dataset and the directory (MNIST's gz
  mirrors and CIFAR's archive), having tried every mirror.
* With the files present it fetches nothing.
* A parity run over small IDX files standing in for MNIST trains the
  MLP row through the fused graph (f32) after its cross-check against
  the unit graph, and returns its row.
* The default ("auto") config is bf16 with a float32 retry of a row
  that misses its bar, as in the JAX package.
* ``--parity`` reaches ``parity.run_parity`` through the CLI, and
  refuses the options a parity run does not take.
"""

import os
import struct
import time
import urllib.error

import numpy
import pytest

from test_torch_mnist import _one_torch_thread, _restored  # noqa: F401
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch import parity
from znicz_tpu_torch.core.config import root


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """Every fetch fails at once, as an unreachable mirror would; the
    URLs asked for are kept."""
    asked = []

    def unreachable(url, dest):
        asked.append(url)
        raise urllib.error.URLError("no network in the tests")
    monkeypatch.setattr(parity, "_fetch", unreachable)
    return asked


@pytest.mark.parametrize("name,subdir", [("mnist", "MNIST"),
                                         ("cifar", "CIFAR10")])
def test_ensure_dataset_offline_fails_fast_with_clear_message(
        tmp_path, offline, name, subdir):
    start = time.time()
    with pytest.raises(SystemExit) as e:
        parity.ensure_dataset(name, directory=str(tmp_path))
    msg = str(e.value)
    assert isinstance(e.value, parity.NetworkRequired)
    assert "network required" in msg
    assert name in msg
    assert str(tmp_path) in msg   # tells the user where to put the files
    assert time.time() - start < 4 * parity.TIMEOUT
    spec = parity.DATASETS[name]
    mirrors = len(spec.get("sources", ())) + ("tar" in spec)
    assert len(offline) == mirrors and all(u.startswith("https://")
                                           for u in offline)
    # the default directory is under the datasets root
    with pytest.raises(SystemExit, match=subdir):
        with _restored(root.common.dirs):
            root.common.dirs.datasets = str(tmp_path / "datasets")
            parity.ensure_dataset(name)


def test_ensure_dataset_skips_when_files_present(tmp_path, offline):
    for f in parity.DATASETS["mnist"]["files"]:
        open(os.path.join(str(tmp_path), f), "wb").close()
    assert parity.ensure_dataset("mnist", directory=str(tmp_path)) == \
        str(tmp_path)
    assert offline == []


def _write_idx(path, images, labels_path, labels):
    with open(path, "wb") as f:
        f.write(struct.pack(">2i", 2051, len(labels)))
        f.write(struct.pack(">2i", 28, 28))
        f.write(images.astype(numpy.uint8).tobytes())
    with open(labels_path, "wb") as f:
        f.write(struct.pack(">2i", 2049, len(labels)))
        f.write(labels.astype(numpy.uint8).tobytes())


def test_parity_run_trains_on_provisioned_files(tmp_path, monkeypatch,
                                                capsys):
    """With the dataset present (small IDX files standing in for the
    real ones) a parity run trains without the network and prints its
    row; the cross-check runs first."""
    r = numpy.random.RandomState(0)
    d = str(tmp_path)
    _write_idx(os.path.join(d, "train-images.idx3-ubyte"),
               r.randint(0, 255, (60000, 28, 28)),
               os.path.join(d, "train-labels.idx1-ubyte"),
               r.randint(0, 10, 60000))
    _write_idx(os.path.join(d, "t10k-images.idx3-ubyte"),
               r.randint(0, 255, (10000, 28, 28)),
               os.path.join(d, "t10k-labels.idx1-ubyte"),
               r.randint(0, 10, 10000))
    monkeypatch.setitem(parity.PARITY_RUNS, "mnist",
                        [("MNIST MLP", 1.92, {})])
    with _restored(root.mnistr.decision):
        root.mnistr.decision.max_epochs = 1
        rows = parity.run_parity("mnist", device="cpu", data_dir=d,
                                 fused={}, cross_check=4)
    (label, ref_err, ours), = rows
    assert label == "MNIST MLP" and ref_err == 1.92
    assert ours is not None and 0.0 <= ours <= 100.0
    out = capsys.readouterr().out
    assert "cross-check ok: first 4 minibatches" in out
    assert "| MNIST MLP" in out and "(fused f32)" in out


def test_cli_parity_flag_is_wired(monkeypatch):
    """--parity reaches parity.run_parity through the CLI parser, with
    the fused graph's default config unless --fused says otherwise."""
    called = []

    def fake(sample, device=None, fused="auto", **kwargs):
        called.append((sample, device, fused))
        return []
    monkeypatch.setattr(parity, "run_parity", fake)
    assert cli.main(["mnist", "--parity"]) == 0
    assert cli.main(["mnist", "--parity", "--device", "cpu", "--fused",
                     "window=1"]) == 0
    assert called == [("mnist", None, "auto"),
                      ("mnist", "cpu", {"window": 1})]
    for extra in (["--testing"], ["--dry-run"], ["--snapshot", "x.pickle"]):
        with pytest.raises(SystemExit):
            cli.main(["mnist", "--parity"] + extra)
    assert len(called) == 2


def test_auto_is_the_fused_graph_in_float32(tmp_path, monkeypatch, capsys):
    """``fused="auto"`` (bare ``--parity``) is JAX's default parity
    config: the fused graph with bfloat16 products over float32 master
    weights, and a row that misses its bar in bfloat16 is trained
    again in float32 on the same path, the better of the two kept
    (``znicz_tpu/parity.py:248-297``); a row that makes its bar in
    bfloat16 is not retrained."""
    for f in parity.DATASETS["mnist"]["files"]:
        open(os.path.join(str(tmp_path), f), "wb").close()
    seen = []

    class Stop(Exception):
        pass

    def cross_check(module, kwargs, loader_config, fused, device, **kw):
        seen.append((module.__name__, fused, loader_config, device.type))
        raise Stop()
    monkeypatch.setattr(parity, "_cross_check", cross_check)
    for fused in ("auto", True):
        with pytest.raises(Stop):
            parity.run_parity("mnist", device="cpu", data_dir=str(tmp_path),
                              fused=fused)
    assert seen == [("znicz_tpu_torch.samples.mnist",
                     {"compute_dtype": "bfloat16"},
                     {"synthetic": False, "data_path": str(tmp_path)},
                     "cpu")] * 2

    built = []

    class Decision(object):
        def __init__(self, err):
            self.best_n_err_pt = [None, err, None]

    class Run(object):
        def __init__(self, err):
            self.decision = Decision(err)

        def run(self):
            pass

    def seeded_build(module, kwargs, loader_config, fused, device):
        built.append(dict(fused))
        return Run({"bfloat16": errs[0], None: errs[1]}[
            fused.get("compute_dtype")])
    monkeypatch.setattr(parity, "_seeded_build", seeded_build)
    monkeypatch.setitem(parity.PARITY_RUNS, "mnist",
                        [("MNIST MLP", 1.92, {})])
    for errs, want, mode, tried in (
            ((5.0, 1.5), 1.5, "fused f32", 2),
            ((1.0, 0.5), 1.0, "fused bf16", 1),
            ((5.0, 6.0), 5.0, "fused bf16", 2)):
        del built[:]
        rows = parity.run_parity("mnist", device="cpu",
                                 data_dir=str(tmp_path), cross_check=0)
        assert rows == [("MNIST MLP", 1.92, want)]
        assert built == [{"compute_dtype": "bfloat16"},
                         {"compute_dtype": None}][:tried]
        out = capsys.readouterr().out
        assert ("retrying f32" in out) == (tried == 2)
        assert "(%s)" % mode in out


def test_unknown_sample_and_no_cuda(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="no parity baseline"):
        parity.run_parity("wine", device="cpu")
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity.run_parity("mnist", data_dir=str(tmp_path))
