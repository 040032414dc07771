"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's file is the one its ``configs`` entry names;
the traffic mix is ``traffic/<traffic>.json``; the limits of the
numbers that decide ``correct`` are ``limits/<workload>.json``; each
per-layer metric is read by ``metrics/<metric>.py``.  Adding a cell,
a mix or a metric adds files and entries; no list of names lives in
code.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH_DIR)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(checkout=CHECKOUT):
    return load_json(os.path.join(checkout, "BENCHMARK.json"))


def resolve(bench, workload, checkout=CHECKOUT, bench_dir=BENCH_DIR):
    """Everything one run of ``workload`` needs, as a dict: the cell,
    its configuration and traffic, its limits, and the end-to-end and
    per-layer metric entries that this cell reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError("no workload %r in BENCHMARK.json" % workload)
    return resolve_cell(bench, cells[workload], checkout, bench_dir)


def resolve_cell(bench, cell, checkout=CHECKOUT, bench_dir=BENCH_DIR):
    """:func:`resolve` for a cell entry given whole (one that
    ``BENCHMARK.json`` may not list yet)."""
    workload = cell["name"]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = load_json(os.path.join(checkout, entry["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(bench_dir, "limits",
                                    workload + ".json"))

    def mine(metric):
        return workload in metric.get("workloads", [workload])
    end_to_end = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "end_to_end": end_to_end,
            "per_layer": per_layer}


def reader(name, bench_dir=BENCH_DIR):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
