#!/usr/bin/env python3
"""One run of one benchmark cell on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell, its configuration, its traffic
mix, its limits and its per-layer metrics are found by the names in
``BENCHMARK.json`` (``harness/cells.py``).  The run makes its inputs
from the seed, sets up the program (``znicz_tpu_torch``), warms up
every shape the cell uses, measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints one JSON
line as the last line of its standard output: the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``
(which traces a further segment with ``torch.profiler``).  The numbers
compared and their limits close both that line (``checks``) and the
standard error.

It exits non-zero with no result when there is no CUDA card, or fewer
than the cell asks for, when the trace holds no device event, or when
``jax``, ``jaxlib``, ``flax`` or ``znicz_tpu`` is loaded once the window
has closed.  Build and kernel caches live at fixed paths under
``build/`` in the checkout.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH_DIR)
#: modules that may not be loaded in the process that prints a result,
#: compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "znicz_tpu")


def cache_env(checkout):
    """Every build and kernel cache the run may fill, at fixed paths
    inside the checkout (the port's kernels build under ``build/``
    already), and no JAX through a library's optional backend."""
    cache = os.path.join(checkout, "build", "bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(names):
    """The forbidden top-level names among module ``names``."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class Context:
    """What a driver is given, and how it reports the end of set-up."""

    def __init__(self, torch, resolved, seed, seconds, trace, device, t0):
        self.torch = torch
        self.cell = resolved["cell"]
        self.config = resolved["config"]
        self.traffic = resolved["traffic"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t0 = t0
        self.setup_s = None
        self.log = log

    def phase(self, name):
        """Logs the seconds from process start to the end of a set-up
        phase, on standard error."""
        self.log("set-up %s: %.3f s" % (name, time.perf_counter() - self.t0))

    def mark_setup_done(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - self.t0

    def memory_peak(self):
        if self.device.type != "cuda":
            return 0
        return int(self.torch.cuda.max_memory_allocated(self.device))


class _Layer:
    """The per-layer readers' view of a run."""

    def __init__(self, layer, card):
        self.layer = layer
        self.card = card


def power_limit():
    """The card's power limit in watts, as ``nvidia-smi`` reads it, or
    None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(resolved, seed, seconds, trace, device="cuda", t0=None):
    """One run of a resolved cell (``harness.cells.resolve``): the
    result dict of the contract.  ``device`` "cpu" runs the same path
    on the CPU, for the tests."""
    import torch
    from harness import cells, compare
    ctx = Context(torch, resolved, seed, seconds, trace, device,
                  _T0 if t0 is None else t0)
    driver = importlib.import_module("harness." + ctx.traffic["driver"])
    ctx.phase("imports")
    out = driver.run(ctx)
    correct, checks = compare.judge(out["numbers"], resolved["limits"])
    if ctx.device.type == "cuda":
        dev = {"platform": "gpu",
               "kind": torch.cuda.get_device_name(ctx.device),
               "count": 1, "memory_peak_bytes": out["memory_peak"],
               "power_limit_w": power_limit(),
               "torch": torch.__version__}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": out["memory_peak"],
               "torch": torch.__version__}
    metrics = {}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if not trace:
        values = dict(out["end_to_end"], setup_s=ctx.setup_s)
        for m in resolved["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        view = _Layer(out["layer"], dev["kind"])
        for m in resolved["per_layer"]:
            value = cells.reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = out["layer"].get("trace")
        if tr is not None:
            dev["busy_s"] = tr.busy_s
            dev["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tr.device_ops(),
                                   "idle_gaps": tr.idle_gaps()}
    result["checks"] = {
        name: {"value": c["value"] if c["value"] is not None and
               math.isfinite(c["value"]) else None, "limit": c["limit"]}
        for name, c in checks.items()}
    return result


def main(argv=None):
    cache_env(CHECKOUT)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, CHECKOUT)
    from harness import cells
    resolved = cells.resolve(cells.benchmark(CHECKOUT), args.workload,
                             CHECKOUT, BENCH_DIR)
    import torch
    chips = int(resolved["cell"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log("no result: the cell needs %d CUDA card(s); this host has %s"
            % (chips, torch.cuda.device_count()
               if torch.cuda.is_available() else "none"))
        return 2
    result = run_cell(resolved, args.seed, args.seconds, args.trace)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        log("no result: loaded in this process: %s" % ", ".join(bad))
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        log("check %s: %r (limit %r)" % (name, c["value"], c["limit"]))
    log("correct: %s" % result["correct"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
