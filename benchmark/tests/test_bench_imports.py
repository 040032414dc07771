"""No module of the benchmark imports JAX or the JAX package, compared
by whole top-level names, and the reference imports nothing of the
program."""

import ast
import os

import pytest

import run

from conftest import BENCH_DIR

JAX_NAMES = {"jax", "jaxlib", "flax", "znicz_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("names,bad", [
    (["znicz_tpu_torch", "znicz_tpu_torch.parallel.fused"], []),
    (["znicz_tpu.core.config", "numpy"], ["znicz_tpu"]),
    (["jaxlib.xla_client", "jaxtyping", "flax"], ["flax", "jaxlib"]),
    (["jax"], ["jax"]), (["znicz_tpu_torchx", "jax_utils"], [])])
def test_forbidden_modules_by_whole_top_level_name(names, bad):
    assert run.forbidden_modules(names) == bad


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & JAX_NAMES, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"contextlib", "torch"}, (path, tops)
