"""The port's compile cache (``core/compile_cache.py``) on the CPU.

The JAX package points XLA's persistent compilation cache at a
directory; the port maps the flag to its kernels' build directory
(``ops/cuda_build.py``), since what a cold process compiles there is
the kernel libraries.  JAX ``tests/functional/test_compile_cache.py``'s
config-gate and enable/disable cases, then the mapping: with ``nvcc``
absent, a directory already holding the libraries under
``library_path``'s names builds nothing (``watch().fresh_compiles()``
0, both loaded); ``serve --compile-cache DIR`` parses, enables the
cache, reports it under ``/statusz`` beside the ``kernels`` block, and
the router's replica argv carries the flag.
"""

import json
import os
import urllib.request

import pytest

from test_torch_mnist import _restored
from znicz_tpu_torch import testing
from znicz_tpu_torch.core import compile_cache
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.ops import cuda_build
from znicz_tpu_torch.serving import server as server_mod
from znicz_tpu_torch.serving.router import FleetRouter


@pytest.fixture(autouse=True)
def cache_off():
    compile_cache.disable()
    yield
    compile_cache.disable()


def test_enable_disable_and_config_gate(tmp_path, monkeypatch):
    monkeypatch.setattr(root.common.dirs, "cache", str(tmp_path))
    assert not compile_cache.enabled()
    assert compile_cache.maybe_enable() is None  # the gate is off
    monkeypatch.setattr(root.common.compile_cache, "enabled", True)
    d = compile_cache.maybe_enable()
    assert d == os.path.join(str(tmp_path), "kernel_cache")
    assert compile_cache.enabled() and os.path.isdir(d)
    assert compile_cache.stats()["dir"] == d
    assert cuda_build.build_dir() == d
    explicit = tmp_path / "elsewhere"
    assert compile_cache.enable(str(explicit)) == str(explicit)
    assert compile_cache.active_dir() == str(explicit)
    monkeypatch.setattr(root.common.compile_cache, "dir",
                        str(tmp_path / "configured"))
    assert compile_cache.configured_dir() == str(tmp_path / "configured")
    compile_cache.disable()
    assert not compile_cache.enabled()
    assert compile_cache.stats()["enabled"] is False
    assert cuda_build.build_dir() == cuda_build.BUILD_DIR


def test_the_config_knobs_are_jax_s_but_the_xla_thresholds():
    from znicz_tpu.core.config import root as jax_root
    mine = root.common.compile_cache.as_dict()
    theirs = jax_root.common.compile_cache.as_dict()
    assert sorted(set(theirs) - set(mine)) == [
        "min_compile_time_secs", "min_entry_size_bytes"]
    assert {k: theirs[k] for k in mine} == mine == {"enabled": False,
                                                     "dir": None}


def test_watch_counts_nvcc_builds(monkeypatch):
    w = compile_cache.watch()
    monkeypatch.setattr(cuda_build, "BUILT", cuda_build.BUILT + 2)
    monkeypatch.setattr(cuda_build, "LOADED", cuda_build.LOADED + 5)
    assert w.delta() == {"libraries_built": 2, "libraries_loaded": 5}
    assert w.fresh_compiles() == 2


def _no_nvcc():
    raise AssertionError("nvcc was asked for: a library would be built")


def test_a_directory_holding_the_libraries_builds_nothing(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(cuda_build, "_nvcc", _no_nvcc)
    monkeypatch.setattr(cuda_build, "_found", set())
    d = compile_cache.enable(str(tmp_path / "cache"))
    sources = cuda_build.sources()
    assert len(sources) == 2
    for source in sources:
        path = cuda_build.library_path(source)
        assert os.path.dirname(path) == d
        with open(path, "wb") as f:
            f.write(b"\x7fELF" + bytes(60))
    w = compile_cache.watch()
    outs = cuda_build.build_all()
    assert sorted(outs) == sources
    assert all(os.path.dirname(p) == d for p in outs.values())
    assert w.fresh_compiles() == 0
    assert w.delta()["libraries_loaded"] == 2
    # a library asked for again is not counted again
    cuda_build.build(sources[0])
    assert w.delta() == {"libraries_built": 0, "libraries_loaded": 2}
    stats = compile_cache.stats()
    assert (stats["enabled"], stats["dir"], stats["entries"],
            stats["bytes"]) == (True, d, 2, 128)


def test_a_library_the_directory_lacks_asks_for_nvcc(tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(cuda_build, "_nvcc", _no_nvcc)
    compile_cache.enable(str(tmp_path / "empty"))
    with pytest.raises(AssertionError, match="nvcc was asked for"):
        cuda_build.build_all()
    # the flags are part of a library's name: the cache holds one
    # library a source and flag set
    assert cuda_build.library_path("max_pooling_offsets.cu").startswith(
        str(tmp_path / "empty") + os.sep + "libmax_pooling_offsets-")


def test_serve_compile_cache_parses():
    _, args = server_mod._parse(["m=x.zip", "--compile-cache", "/tmp/kc"])
    assert args.compile_cache == "/tmp/kc"
    _, args = server_mod._parse(["m=x.zip", "--compile-cache"])
    assert args.compile_cache == ""
    _, args = server_mod._parse(["m=x.zip"])
    assert args.compile_cache is None


def test_the_router_s_replica_argv_carries_the_flag(tmp_path):
    raw = ["m=x.zip", "--fleet", "2", "--port", "0", "--compile-cache",
           str(tmp_path / "kc"), "--device", "cpu"]
    argv = server_mod.replica_argv(raw)
    assert argv == ["m=x.zip", "--compile-cache", str(tmp_path / "kc"),
                    "--device", "cpu"]
    router = FleetRouter(argv, replicas=1)
    assert router._replica_argv.count("--compile-cache") == 1
    router = FleetRouter(["m=x.zip"], replicas=1,
                         compile_cache_dir=str(tmp_path / "kc2"))
    assert router._replica_argv == ["m=x.zip", "--compile-cache",
                                    str(tmp_path / "kc2")]
    assert FleetRouter(["m=x.zip"], replicas=1)._replica_argv == \
        ["m=x.zip"]


def _statusz(port):
    with urllib.request.urlopen("http://127.0.0.1:%d/statusz" % port,
                                timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("named", [False, True])
def test_serve_with_the_cache_reports_it_on_statusz(tmp_path, named):
    path = testing.build_fc_package_zip(str(tmp_path / "fc.zip"),
                                        [6, 4, 3], seed=2, scale=0.1)
    cache = str(tmp_path / "kernel_cache")
    built = cuda_build.BUILT
    with _restored(root.common):
        srv, _ = server_mod.serve([
            ("m=" + path) if named else path, "--device", "cpu",
            "--port", "0", "--max-batch", "2", "--compile-cache", cache])
        try:
            doc = _statusz(srv.port)
        finally:
            srv.drain()
    block = doc["registry"]["compile_cache"] if named else \
        doc["compile_cache"]
    assert block["enabled"] and block["dir"] == cache
    assert block["entries"] == 0      # nothing is built for the CPU
    assert doc["kernels"]["libraries_built"] == 0
    assert cuda_build.BUILT == built
