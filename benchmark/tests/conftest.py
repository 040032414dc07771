"""The benchmark's tests: its arithmetic, its traffic, its discovery of
cells and its checks, on the CPU at tiny sizes; the tests marked
``card`` need a CUDA card and skip without one.

    python -m pytest benchmark/tests -q
"""

import json
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH_DIR)
for path in (CHECKOUT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skips the test where this host has no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


def tiny(workload, config_name, **traffic):
    """A cell resolved with a tiny configuration from ``tests/configs``
    and its traffic overridden: the same path and the same limits at a
    size the CPU holds."""
    from harness import cells
    r = cells.resolve(cells.benchmark(CHECKOUT), workload, CHECKOUT,
                      BENCH_DIR)
    with open(os.path.join(BENCH_DIR, "tests", "configs",
                           config_name + ".json")) as f:
        r["config"] = json.load(f)
    r["traffic"] = dict(r["traffic"], **traffic)
    return r


TINY = {
    "alexnet.train.b128": ("tiny_alexnet",
                           {"batch": 8, "window": 4, "rows": 48}),
}


@pytest.fixture
def tiny_cell():
    """``tiny_cell(workload)``: that cell at its tiny size."""
    def make(workload):
        name, traffic = TINY[workload]
        return tiny(workload, name, **traffic)
    return make


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run beside others."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
